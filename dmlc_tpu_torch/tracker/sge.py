"""SGE backend — analog of tracker/dmlc_tracker/sge.py.

Generates a run script and submits a ``qsub -t 1-N`` array job; the task id
comes from ``$SGE_TASK_ID`` (sge.py:22-40). The port's copy of the JAX
package's ``tracker/sge.py``: the same script and command line.
"""

from __future__ import annotations

import os
import subprocess
from typing import Dict, List


def build_run_script(command: List[str], envs: Dict[str, str], role: str) -> str:
    lines = ["#!/bin/bash"]
    for key, value in envs.items():
        lines.append(f"export {key}={value}")
    lines.append(f"export DMLC_ROLE={role}")
    lines.append("export DMLC_TASK_ID=$((SGE_TASK_ID - 1))")
    lines.append("export DMLC_JOB_CLUSTER=sge")
    lines.append(" ".join(command))
    return "\n".join(lines) + "\n"


def build_qsub_argv(script_path: str, count: int, jobname: str, queue: str,
                    cores: int) -> List[str]:
    return ["qsub", "-cwd", "-t", f"1-{count}", "-S", "/bin/bash",
            "-N", jobname, "-q", queue, "-pe", "smp", str(cores),
            script_path]


def submit(args):
    def run(nworker: int, nserver: int, envs: Dict[str, str]):
        env = dict(envs)
        env.update(args.pass_envs)
        for role, count, cores in (
            ("worker", nworker, args.worker_cores),
            ("server", nserver, args.server_cores),
        ):
            if count == 0:
                continue
            script = build_run_script(args.command, env, role)
            path = f"rundmlc-{role}.sh"
            with open(path, "w") as f:
                f.write(script)
            os.chmod(path, 0o755)
            subprocess.check_call(
                build_qsub_argv(path, count, f"{args.jobname}-{role}",
                                args.queue, cores))

    return run
