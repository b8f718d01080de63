"""The benchmark of ``dmlc_tpu_torch`` on an NVIDIA GPU (README.md)."""
