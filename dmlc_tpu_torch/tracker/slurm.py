"""Slurm backend — analog of tracker/dmlc_tracker/slurm.py.

Launches workers and servers as ``srun`` job steps (slurm.py:38-60). The
reference registers slurm in opts but never dispatches it (submit.py bug);
here it is first-class. The port's copy of the JAX package's
``tracker/slurm.py``: the same command lines.
"""

from __future__ import annotations

import subprocess
import threading
from typing import Dict, List


def build_srun_argv(command: List[str], nnodes: int, ntasks: int,
                    jobname: str) -> List[str]:
    return ["srun", f"--job-name={jobname}", f"--nodes={nnodes}",
            f"--ntasks={ntasks}", "--kill-on-bad-exit=1"] + command


def submit(args):
    def run(nworker: int, nserver: int, envs: Dict[str, str]):
        import os

        threads = []
        for role, count in (("worker", nworker), ("server", nserver)):
            if count == 0:
                continue
            env = os.environ.copy()
            env.update(envs)
            env.update(args.pass_envs)
            env["DMLC_ROLE"] = role
            env["DMLC_JOB_CLUSTER"] = "slurm"
            argv = build_srun_argv(args.command, min(count, count), count,
                                   f"{args.jobname}-{role}")
            t = threading.Thread(
                target=subprocess.check_call, kwargs={"args": argv, "env": env})
            t.daemon = True
            t.start()
            threads.append(t)
        for t in threads:
            t.join()

    return run
