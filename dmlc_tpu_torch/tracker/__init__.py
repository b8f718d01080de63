"""Distributed launch + rank coordination (reference layer 7).

The port's copy of the JAX package's ``tracker/``: a wire-compatible
rebuild of the reference rabit tracker (tracker/dmlc_tracker/tracker.py):
TCP rendezvous, rank assignment with allreduce tree + ring topology
computation, peer brokering, heartbeats, recovery, pod telemetry — plus the
``dmlc-submit`` launcher backends (``python -m
dmlc_tpu_torch.tracker.submit``), with a ``tpu-pod`` backend whose workers
join a ``torch.distributed`` process group from the same env contract
(:func:`dmlc_tpu_torch.parallel.init_from_env`).
"""

from dmlc_tpu_torch.tracker.tracker import RabitTracker, PSTracker, submit
from dmlc_tpu_torch.tracker.client import WorkerClient

__all__ = ["RabitTracker", "PSTracker", "submit", "WorkerClient"]
