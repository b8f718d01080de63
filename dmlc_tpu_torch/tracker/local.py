"""Local multiprocess backend — analog of tracker/dmlc_tracker/local.py.

Spawns worker/server subprocesses on this machine with the DMLC_* env
contract; failed workers retry up to DMLC_NUM_ATTEMPT times
(local.py:12-49). The port's copy of the JAX package's
``tracker/local.py``.
"""

from __future__ import annotations

import os
import subprocess
import threading
from typing import Dict, List

from dmlc_tpu_torch.utils.check import get_logger


def run_with_retry(cmd: List[str], env: Dict[str, str], label: str,
                   num_attempt: int = 1) -> None:
    """THE DMLC_NUM_ATTEMPT retry contract (reference local.py:26-49),
    shared by every process-spawning backend: relaunch a failed worker with
    the same identity env up to ``num_attempt`` times, exporting the
    attempt counter in DMLC_NUM_ATTEMPT so a restarted worker can take its
    recovery path (e.g. rabit ``recover`` with its old rank)."""
    ntrial = 0
    while True:
        returncode = subprocess.call(cmd, env=env)
        if returncode == 0:
            return
        ntrial += 1
        if ntrial >= num_attempt:
            raise RuntimeError(
                f"{label} failed with code {returncode} "
                f"after {ntrial} attempt(s)")
        env["DMLC_NUM_ATTEMPT"] = str(ntrial)
        get_logger().warning(
            "%s failed (code %d), relaunching %d/%d",
            label, returncode, ntrial, num_attempt)


def exec_cmd(cmd: List[str], role: str, taskid: int, pass_env: Dict[str, str],
             num_attempt: int = 1) -> None:
    env = os.environ.copy()
    env.update(pass_env)
    env["DMLC_TASK_ID"] = str(taskid)
    env["DMLC_ROLE"] = role
    env["DMLC_JOB_CLUSTER"] = "local"
    run_with_retry(cmd, env, f"local worker {role}:{taskid}", num_attempt)


def submit(args):
    """Backend entry: returns the fun_submit callback for tracker.submit."""

    def run(nworker: int, nserver: int, envs: Dict[str, str]):
        pass_env = dict(envs)
        pass_env.update(args.pass_envs)
        threads = []
        errors: List[BaseException] = []

        def guarded(role: str, i: int) -> None:
            try:
                exec_cmd(args.command, role, i, pass_env, args.local_num_attempt)
            except BaseException as exc:  # noqa: BLE001 - reported to launcher
                errors.append(exc)

        for i in range(nworker):
            t = threading.Thread(target=guarded, args=("worker", i))
            t.daemon = True
            t.start()
            threads.append(t)
        for i in range(nserver):
            t = threading.Thread(target=guarded, args=("server", i))
            t.daemon = True
            t.start()
            threads.append(t)
        for t in threads:
            t.join()
        if errors:
            raise RuntimeError(
                f"local job failed ({len(errors)} worker thread(s)): "
                f"{'; '.join(str(e) for e in errors)}") from errors[0]

    return run
