"""tpu-pod backend: one process a host, joined through the tracker.

The port's copy of the JAX package's ``tracker/tpu_pod.py``; the cluster
keeps its name, and its env contract (``DMLC_JOB_CLUSTER="tpu-pod"``) is
the JAX package's. The reference's YARN/MPI backends place processes and
let rabit broker ranks over sockets. Here the placement is one process a
host and the job's group is a ``torch.distributed`` process group, so this
backend:

1. starts the rabit tracker (rank-stable coordination + the env contract),
2. launches one process per host — over ssh when a ``--host-file`` lists
   the hosts, or locally (ranks sharing this host) otherwise, each local
   one under the ``DMLC_NUM_ATTEMPT`` relaunch contract,
3. exports ``DMLC_TRACKER_URI/PORT``, ``DMLC_NUM_WORKER``,
   ``DMLC_TASK_ID``; workers call
   :func:`dmlc_tpu_torch.parallel.init_from_env`, which maps that contract
   onto ``torch.distributed.init_process_group`` (rank = task id,
   rendezvous at the tracker host, port + 1), and their InputSplit shard
   index is their task id. The same ``DMLC_TASK_ID``/``DMLC_NUM_WORKER``
   pair is the pod identity the epoch planner's ``pod_sharding`` resolves
   (:func:`dmlc_tpu_torch.parallel.distributed.pod_identity`): each
   launched worker reads its disjoint shard of one globally consistent
   shuffled epoch straight from the launcher env.

The job's data plane is the process group's collectives — no peer
sockets to broker, which is why this backend needs nothing beyond
placement + env. The local launch joins its threads with no deadline, as
the JAX package's does: a caller that needs one gives its workers a
finite ``init_from_env(timeout=)``.
"""

from __future__ import annotations

import os
import subprocess
import threading
from typing import Dict, List

from dmlc_tpu_torch.tracker.local import run_with_retry
from dmlc_tpu_torch.tracker.opts import read_host_file
from dmlc_tpu_torch.tracker.ssh import build_remote_command, build_ssh_argv, parse_host
from dmlc_tpu_torch.utils.check import get_logger


def worker_env(envs: Dict[str, str], task_id: int) -> Dict[str, str]:
    env = dict(envs)
    env["DMLC_ROLE"] = "worker"
    env["DMLC_TASK_ID"] = str(task_id)
    env["DMLC_JOB_CLUSTER"] = "tpu-pod"
    # init_process_group's rendezvous is derived from DMLC_TRACKER_URI/PORT
    # by dmlc_tpu_torch.parallel.init_from_env; nothing else to export.
    return env


def submit(args):
    hosts: List[str] = []
    if args.host_file:
        hosts = read_host_file(args.host_file)

    def run(nworker: int, nserver: int, envs: Dict[str, str]):
        assert nserver == 0, "tpu-pod jobs are allreduce-style (no PS role)"
        threads = []
        errors: List[BaseException] = []
        base = dict(envs)
        base.update(args.pass_envs)

        def guarded(fn, *fn_args) -> None:
            try:
                fn(*fn_args)
            except BaseException as exc:  # noqa: BLE001 - reported to launcher
                errors.append(exc)

        if hosts:
            assert len(hosts) >= nworker, (
                f"tpu-pod: host file lists {len(hosts)} hosts < {nworker} workers")
            for i in range(nworker):
                host, port = parse_host(hosts[i])
                env = worker_env(base, i)
                remote = build_remote_command(
                    args.command, env, host, args.sync_dst_dir or os.getcwd())
                argv = build_ssh_argv(host, port, remote)
                t = threading.Thread(
                    target=guarded, args=(subprocess.check_call, argv))
                t.daemon = True
                t.start()
                threads.append(t)
        else:
            get_logger().info(
                "tpu-pod: no --host-file, launching %d local processes", nworker)
            num_attempt = max(1, getattr(args, "local_num_attempt", 1))
            for i in range(nworker):
                env = os.environ.copy()
                env.update(worker_env(base, i))
                t = threading.Thread(
                    target=guarded,
                    args=(run_with_retry, args.command, env,
                          f"tpu-pod worker {i}", num_attempt))
                t.daemon = True
                t.start()
                threads.append(t)
        for t in threads:
            t.join()
        if errors:
            raise RuntimeError(
                f"tpu-pod job failed ({len(errors)} worker thread(s)): "
                f"{'; '.join(str(e) for e in errors)}") from errors[0]

    return run
