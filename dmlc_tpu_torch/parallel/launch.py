"""Run one command as ``n`` ranks on this host, under the DMLC_* contract.

The single-host counterpart of the JAX package's ``tpu-pod`` launcher
(``dmlc_tpu/tracker/tpu_pod.py`` ``worker_env``), without the tracker:
each rank is a fresh interpreter with ``DMLC_TRACKER_URI/PORT``,
``DMLC_NUM_WORKER``, ``DMLC_TASK_ID`` and ``DMLC_ROLE`` set, so that
:func:`~dmlc_tpu_torch.parallel.init_from_env` joins them into one group.

The rendezvous port is a free one (:func:`free_port`: drawn below the
kernel's ephemeral range, so no automatically assigned port can take it),
with ``DMLC_TRACKER_PORT`` one below it so the group's coordinator lands
on it; a rank that finds it taken (``EADDRINUSE``, another job won the
race) fails the attempt, and the launch is retried once on a new port. Every
rank has the launch's deadline: when one fails or the deadline passes, the
rest are killed, so no rank is left waiting on a collective.
"""

from __future__ import annotations

import os
import random
import socket
import subprocess
import tempfile
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

from dmlc_tpu_torch.utils.check import DMLCError

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_PORT_TAKEN = ("eaddrinuse", "address already in use")


class RankResult(NamedTuple):
    rank: int
    returncode: int
    stdout: str
    stderr: str


def _ephemeral_range() -> "tuple[int, int]":
    """The kernel's range for automatically assigned ports."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            lo, hi = (int(v) for v in f.read().split())
        return lo, hi
    except (OSError, ValueError):
        return 32768, 60999  # Linux's default


def free_port(host: str = "127.0.0.1") -> int:
    """A TCP port that was free on ``host`` a moment ago, drawn at random
    below the kernel's ephemeral range and above 1025 (so the tracker port
    one below it is a user port too). A port in the ephemeral range could
    be handed to another process's ``bind(0)`` or outgoing connection
    between this check and the coordinator's bind, and a rank would then
    meet a stranger there; below it only an explicit bind can take it."""
    lo = min(_ephemeral_range()[0], 65536)
    rng = random.SystemRandom()
    for _ in range(200):
        port = rng.randrange(10000 if lo > 11000 else 1026, lo)
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            try:
                s.bind((host, port))
            except OSError:
                continue
        return port
    raise DMLCError(f"free_port: no free port below {lo} on {host}")


def worker_env(base: Dict[str, str], num_workers: int, task_id: int, port: int,
               host: str = "127.0.0.1") -> Dict[str, str]:
    """``base`` plus the DMLC_* contract of rank ``task_id``, whose group
    coordinator listens on ``port`` (the tracker's port + 1)."""
    env = dict(base)
    env.update(DMLC_TRACKER_URI=host, DMLC_TRACKER_PORT=str(port - 1),
               DMLC_NUM_WORKER=str(num_workers), DMLC_TASK_ID=str(task_id),
               DMLC_ROLE="worker", DMLC_JOB_CLUSTER="local")
    paths = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    if _REPO not in paths:
        env["PYTHONPATH"] = os.pathsep.join([_REPO] + paths)
    return env


def _stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def _launch(argv: Sequence[str], num_workers: int, timeout: float, env, host,
            cwd) -> List[RankResult]:
    port = free_port(host)
    outs = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
            for _ in range(num_workers)]
    procs = []
    try:
        for rank, (out, err) in enumerate(outs):
            procs.append(subprocess.Popen(
                list(argv), env=worker_env(env, num_workers, rank, port, host),
                stdout=out, stderr=err, cwd=cwd, stdin=subprocess.DEVNULL))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            if all(c == 0 for c in codes) or any(c not in (None, 0) for c in codes):
                break
            if time.monotonic() > deadline:
                _stop(procs)
                tails = "".join(_read(err)[-2000:] for _, err in outs)
                raise TimeoutError(f"{num_workers} ranks of {list(argv)} still running "
                                   f"after {timeout} s; stderr tails:\n{tails}")
            time.sleep(0.02)
        _stop(procs)  # a rank failed: the others would wait on it
        return [RankResult(r, p.returncode, _read(out), _read(err))
                for r, (p, (out, err)) in enumerate(zip(procs, outs))]
    finally:
        _stop(procs)
        for out, err in outs:
            out.close()
            err.close()


def _read(f) -> str:
    f.seek(0)
    return f.read()


def run_local(argv: Sequence[str], num_workers: int, *, timeout: float,
              env: Optional[Dict[str, str]] = None, host: str = "127.0.0.1",
              cwd: Optional[str] = None, check: bool = True) -> List[RankResult]:
    """Run ``argv`` as ``num_workers`` ranks and wait for all of them, at
    most ``timeout`` seconds (then every rank is killed and
    ``TimeoutError`` raised). Retried once on a new port when a rank found
    the rendezvous port taken. With ``check``, a rank that failed raises
    :class:`DMLCError` carrying every rank's stderr tail."""
    base = dict(os.environ if env is None else env)
    for attempt in range(2):
        results = _launch(argv, num_workers, timeout, base, host, cwd)
        failed = [r for r in results if r.returncode != 0]
        taken = any(s in r.stderr.lower() for r in failed for s in _PORT_TAKEN)
        if not (failed and taken and attempt == 0):
            break
    if check and failed:
        tails = "\n".join(f"--- rank {r.rank} (exit {r.returncode}) ---\n{r.stderr[-3000:]}"
                          for r in results)
        raise DMLCError(f"{len(failed)} of {num_workers} ranks of {list(argv)} failed:\n{tails}")
    return results

