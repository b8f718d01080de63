"""Inside-container bootstrap for launched workers.

The port's copy of the JAX package's ``tracker/launcher.py``, analog of
the reference tracker/dmlc_tracker/launcher.py (used by the YARN and
container backends): prepare the environment a worker binary expects, then
exec the user command —
- unpack job archives listed in ``DMLC_JOB_ARCHIVES`` (launcher.py:18-40);
- extend ``PYTHONPATH``/``LD_LIBRARY_PATH`` from ``DMLC_EXTRA_PYTHONPATH``/
  ``DMLC_EXTRA_LDPATH`` (the reference hardwires Hadoop CLASSPATH/libhdfs
  here, launcher.py:41-70; the generic hooks replace it);
- surface the ``DMLC_*`` contract as the coordinator variables the JAX
  package's launcher exports (``JAX_COORDINATOR_ADDRESS``,
  ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``), the same environment, so a
  job mixing the packages' workers sees one contract. A port worker reads
  ``DMLC_*`` itself (:func:`dmlc_tpu_torch.parallel.init_from_env`).

Run as ``python -m dmlc_tpu_torch.tracker.launcher <cmd> [args...]``.
"""

from __future__ import annotations

import os
import subprocess
import sys
import zipfile
from typing import Dict, List, Optional


def unpack_archives(spec: Optional[str], dest: str = ".") -> List[str]:
    """Unzip each archive in the '#'-aliased, ':'-separated spec.

    ``a.zip#alias`` extracts a.zip into ``dest/alias`` (the YARN convention
    the reference launcher follows); plain ``a.zip`` extracts in place.
    Returns the extraction directories.
    """
    out: List[str] = []
    for item in (spec or "").split(":"):
        if not item:
            continue
        if "#" in item:
            path, alias = item.split("#", 1)
        else:
            path, alias = item, ""
        target = os.path.join(dest, alias) if alias else dest
        if not os.path.exists(path):
            continue
        os.makedirs(target, exist_ok=True)
        with zipfile.ZipFile(path) as zf:
            zf.extractall(target)
        out.append(target)
    return out


def build_env(base: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Worker environment: pass DMLC_* through, extend search paths, and
    map the tracker contract onto the coordinator variables (the JAX
    package's names)."""
    env = dict(os.environ if base is None else base)

    def _extend(var: str, extra_var: str) -> None:
        extra = env.get(extra_var)
        if extra:
            env[var] = extra + os.pathsep + env[var] if env.get(var) else extra

    _extend("PYTHONPATH", "DMLC_EXTRA_PYTHONPATH")
    _extend("LD_LIBRARY_PATH", "DMLC_EXTRA_LDPATH")
    # DMLC_* -> the coordinator variables: set only when the tracker vars
    # exist and the coordinator ones are not already set
    tracker_uri = env.get("DMLC_TRACKER_URI")
    tracker_port = env.get("DMLC_TRACKER_PORT")
    if tracker_uri and tracker_port and "JAX_COORDINATOR_ADDRESS" not in env:
        env["JAX_COORDINATOR_ADDRESS"] = f"{tracker_uri}:{tracker_port}"
    if "DMLC_NUM_WORKER" in env and "JAX_NUM_PROCESSES" not in env:
        env["JAX_NUM_PROCESSES"] = env["DMLC_NUM_WORKER"]
    if "DMLC_TASK_ID" in env and "JAX_PROCESS_ID" not in env:
        env["JAX_PROCESS_ID"] = env["DMLC_TASK_ID"]
    return env


def main(argv: Optional[List[str]] = None, use_exec: bool = True) -> int:
    """Bootstrap then run the worker. With ``use_exec`` (the default, and
    what ``-m`` invocation does) the worker replaces this process via
    ``os.execvpe`` so cluster-manager signals reach it directly — the
    reference launcher does the same. ``use_exec=False`` runs it as a child
    and returns the exit code (for embedding/tests)."""
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m dmlc_tpu_torch.tracker.launcher <cmd> [args...]",
              file=sys.stderr)
        return 2
    unpack_archives(os.environ.get("DMLC_JOB_ARCHIVES"))
    env = build_env()
    if use_exec:
        os.execvpe(argv[0], argv, env)  # no return
    proc = subprocess.run(argv, env=env)
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
