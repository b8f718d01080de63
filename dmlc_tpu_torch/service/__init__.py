"""Disaggregated RowBlock data service (tf.data service, arXiv:2210.14826).

The port's copy of the JAX package's ``service/__init__.py``, with its wire,
JSON, journal records, counters and messages.

One shared **multi-tenant** preprocessing tier feeds many trainer jobs:
a :class:`~dmlc_tpu_torch.service.dispatcher.Dispatcher` owns a registry of N
jobs (``register_job``) and their split assignment (exactly-once per
epoch, round-robin grant rotation across jobs, re-issue on worker
death), tracker-launchable
:class:`~dmlc_tpu_torch.service.worker.ParseWorker` s multiplex every job
through the existing parser/block-cache stack — sharing published
artifacts cross-job by store signature, so one corpus parses once
fleet-wide — and stream parsed RowBlocks as length-prefixed CRC'd
frames in the block-cache v1 segment encoding
(:mod:`~dmlc_tpu_torch.service.frame`); the
:class:`~dmlc_tpu_torch.service.client.ServiceParser` is a job-bound drop-in
parser with classified retry + worker failover that feeds ``DeviceIter``
unchanged, and the
:class:`~dmlc_tpu_torch.service.autoscale.FleetAutoscaler` grows/drains the
worker fleet from the jobs' aggregated input-wait signal.
See docs/service.md.
"""

from dmlc_tpu_torch.service.autoscale import FleetAutoscaler
from dmlc_tpu_torch.service.client import ServiceParser
from dmlc_tpu_torch.service.dispatcher import (
    DEFAULT_JOB,
    Dispatcher,
    ServiceConfigError,
    register_job,
)
from dmlc_tpu_torch.service.fleet import LocalFleet
from dmlc_tpu_torch.service.worker import ParseWorker

__all__ = ["DEFAULT_JOB", "Dispatcher", "FleetAutoscaler", "LocalFleet",
           "ParseWorker", "ServiceConfigError", "ServiceParser",
           "register_job"]
