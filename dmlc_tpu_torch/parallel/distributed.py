"""``torch.distributed`` bootstrap from the DMLC_* env contract.

The port's copy of the JAX package's ``parallel/distributed.py``. The
tracker exports ``DMLC_TRACKER_URI/PORT``, ``DMLC_NUM_WORKER``,
``DMLC_TASK_ID`` and ``DMLC_ROLE`` to every worker; here they map onto
``torch.distributed.init_process_group`` (rank = ``DMLC_TASK_ID``, world =
``DMLC_NUM_WORKER``, rendezvous at the tracker's host, port + 1), so a
worker launched by any backend joins the job with no extra code.

The backend follows the device: NCCL for the card, gloo for
``device="cpu"``; a ``backend=`` the caller names is used as given. The
rendezvous and every collective carry a finite ``timeout``, so a rank
whose peers are gone raises instead of hanging.
"""

from __future__ import annotations

import os
import sys
from datetime import timedelta
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from dmlc_tpu_torch._device import resolve_device
from dmlc_tpu_torch.utils.check import DMLCError, get_logger

DEFAULT_TIMEOUT = timedelta(seconds=300)


class EnvContract(NamedTuple):
    """Parsed DMLC_* environment (the reference's wire API)."""

    tracker_uri: Optional[str]
    tracker_port: Optional[int]
    num_worker: int
    task_id: int
    role: str
    node_host: Optional[str]

    @staticmethod
    def from_env(env=None) -> "EnvContract":
        e = os.environ if env is None else env
        port = e.get("DMLC_TRACKER_PORT")
        return EnvContract(
            tracker_uri=e.get("DMLC_TRACKER_URI"),
            tracker_port=int(port) if port else None,
            num_worker=int(e.get("DMLC_NUM_WORKER", "1")),
            task_id=int(e.get("DMLC_TASK_ID", "0")),
            role=e.get("DMLC_ROLE", "worker"),
            node_host=e.get("DMLC_NODE_HOST"),
        )


def group_ready() -> bool:
    """Whether this process belongs to an initialized default process group."""
    return dist.is_available() and dist.is_initialized()


def nccl_device() -> Optional[torch.device]:
    """This rank's card when the default group is NCCL's, whose
    collectives take tensors on it alone; None for any other group (gloo
    takes host tensors, and CUDA ones too) or none."""
    if group_ready() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return None


def init_from_env(env=None, *, coordinator_port_offset: int = 1, force: bool = False,
                  device=None, backend: Optional[str] = None,
                  timeout: timedelta = DEFAULT_TIMEOUT) -> EnvContract:
    """Join the job's process group from the DMLC_* contract.

    ``tcp://DMLC_TRACKER_URI:(DMLC_TRACKER_PORT + coordinator_port_offset)``
    is the rendezvous (rank 0 listens there, next to the tracker), with
    ``world_size=DMLC_NUM_WORKER`` and ``rank=DMLC_TASK_ID``. A job of one
    worker needs no group and returns at once, as in the JAX package. An
    initialized group is kept unless ``force``, which replaces it.

    ``device=None`` means the card (and raises without one): the group is
    NCCL's, and this rank's card is ``task_id % device_count``, set before
    the rendezvous. ``device="cpu"`` gives gloo. ``backend`` overrides the
    choice and is never replaced.
    """
    contract = EnvContract.from_env(env)
    if contract.num_worker <= 1:
        return contract
    if group_ready():
        if not force:
            return contract
        dist.destroy_process_group()
    if contract.tracker_uri is None or contract.tracker_port is None:
        raise DMLCError(
            "init_from_env: DMLC_TRACKER_URI/DMLC_TRACKER_PORT not set; "
            "launch through dmlc-submit or set them explicitly")
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(contract.task_id % torch.cuda.device_count())
    init_method = (f"tcp://{contract.tracker_uri}:"
                   f"{contract.tracker_port + coordinator_port_offset}")
    get_logger().info("init_process_group(%s, init_method=%s, world_size=%d, rank=%d)",
                      backend, init_method, contract.num_worker, contract.task_id)
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=contract.num_worker, rank=contract.task_id,
                            timeout=timeout)
    return contract


def pod_identity(env=None) -> "tuple[int, int]":
    """``(host_id, num_hosts)`` of this process, resolved in the JAX
    package's order:

    1. the tracker env contract (``DMLC_TASK_ID`` / ``DMLC_NUM_WORKER``),
       available before, and without, a process group;
    2. an initialized process group of more than one rank
       (``get_rank()`` / ``get_world_size()``);
    3. ``(0, 1)``, a single host.
    """
    e = os.environ if env is None else env
    contract = EnvContract.from_env(env)
    if contract.num_worker > 1:
        if e.get("DMLC_TASK_ID") is None:
            # EnvContract defaults task_id to 0: every host would read
            # shard 0, and most of the corpus would never be read
            raise DMLCError(
                "pod_identity: DMLC_NUM_WORKER is set but DMLC_TASK_ID "
                "is not — every host would claim shard 0; launch through "
                "a dmlc-submit backend or export both")
        return contract.task_id, contract.num_worker
    if group_ready() and dist.get_world_size() > 1:
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def sync_min(value: int) -> int:
    """The minimum of a host integer over all ranks: one ``all_reduce(MIN)``
    of one int64 on the group's device.

    The guard for data-parallel epochs: byte-range shards rarely hold the
    same batch count, and a rank that runs one more collective step than
    its peers waits forever. Agreeing on ``min(local_steps)`` first keeps
    every rank running the same steps. Without a group, or in a group of
    one, it returns ``value``.
    """
    if not group_ready() or dist.get_world_size() == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=nccl_device() or "cpu")
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t.item())


def exit_rank(code: int = 0) -> None:
    """End a rank's process: destroy the process group (if one is up),
    flush the standard streams and leave with ``os._exit(code)``, which
    skips the interpreter's teardown. On a loaded host torch's teardown of
    a gloo group at interpreter exit now and then calls ``std::terminate``
    (SIGABRT with no Python frame) after the rank's work is done, and the
    launcher then reports the rank as failed. Close every file the rank
    writes before calling it."""
    if group_ready():
        dist.destroy_process_group()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
