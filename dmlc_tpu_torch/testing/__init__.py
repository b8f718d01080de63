"""Test doubles of the port: :mod:`~dmlc_tpu_torch.testing.fake_cloud`,
local fakes of the cloud object stores the filesystem members speak to."""
