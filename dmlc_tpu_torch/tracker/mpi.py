"""MPI backend — analog of tracker/dmlc_tracker/mpi.py.

MPI is used as a *process launcher* only (the reference has no MPI data
plane either): builds an ``mpirun`` line with env
forwarding in the dialect the installed MPI speaks — OpenMPI ``-x K=V`` vs
MPICH ``-env K V`` (mpi.py:12-36). The port's copy of the JAX package's
``tracker/mpi.py``: the same command lines.
"""

from __future__ import annotations

import subprocess
from typing import Dict, List, Optional


def detect_mpi_dialect(version_text: Optional[str] = None) -> str:
    """'openmpi' | 'mpich' from `mpirun --version` output."""
    if version_text is None:
        try:
            version_text = subprocess.run(
                ["mpirun", "--version"], capture_output=True, text=True,
                timeout=10).stdout
        except (OSError, subprocess.TimeoutExpired):
            return "openmpi"
    text = version_text.lower()
    if "open mpi" in text or "open-mpi" in text:
        return "openmpi"
    if "mpich" in text or "hydra" in text:
        return "mpich"
    return "openmpi"


def build_mpirun_argv(command: List[str], nprocs: int, envs: Dict[str, str],
                      dialect: str, host_file: Optional[str] = None) -> List[str]:
    argv = ["mpirun", "-n", str(nprocs)]
    if host_file:
        argv += ["--hostfile", host_file]
    for key, value in envs.items():
        if dialect == "openmpi":
            argv += ["-x", f"{key}={value}"]
        else:
            argv += ["-env", key, str(value)]
    return argv + command


def submit(args):
    def run(nworker: int, nserver: int, envs: Dict[str, str]):
        dialect = detect_mpi_dialect()
        for role, count in (("worker", nworker), ("server", nserver)):
            if count == 0:
                continue
            env = dict(envs)
            env.update(args.pass_envs)
            env["DMLC_ROLE"] = role
            env["DMLC_JOB_CLUSTER"] = "mpi"
            argv = build_mpirun_argv(args.command, count, env, dialect,
                                     args.host_file)
            subprocess.check_call(argv)

    return run
