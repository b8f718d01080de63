"""On-demand builds of the port's native code into ``dmlc_tpu_torch/_build/``.

Two libraries are built from the checkout's sources at first use and
rebuilt when a source is newer than the built library:

- ``libdmlc_torch_kernels.so``: the hand-written CUDA kernels under
  ``dmlc_tpu_torch/csrc/``, compiled by ``nvcc`` for ``sm_90a`` with a plain
  C interface and loaded with ctypes (no PyTorch headers, so a build takes
  seconds);
- ``libdmlc_torch_native.so``: the C++ parse core under ``native/src/``
  (built by :mod:`dmlc_tpu_torch.native`, never into ``native/build/``,
  which belongs to the JAX package).

Concurrent builds (test workers, threads) serialise on a lock file
(``flock`` locks each open of it, so threads exclude each other too), and a
library is moved into place only when complete.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import time
from typing import Callable, List, Optional, Sequence, Tuple

from dmlc_tpu_torch.utils.check import DMLCError

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
KERNEL_SOURCES = [os.path.join(CSRC_DIR, name)
                  for name in ("ell_matvec.cu", "ell_matvec_dw.cu", "widen_span.cu",
                               "row_scatter.cu")]
# included by the sources: a change rebuilds the library too
KERNEL_HEADERS = [os.path.join(CSRC_DIR, "k1_tiles.cuh")]
KERNEL_LIB = "libdmlc_torch_kernels.so"

_kernels: Optional[ctypes.CDLL] = None
# seconds the kernel build took in this process (0.0: library was fresh)
# and the compiler's resource report (-Xptxas -v), for chip_smoke.py
kernel_build_seconds: Optional[float] = None
kernel_build_log = ""

CommandMaker = Callable[[str, str], Tuple[List[List[str]], Optional[List[str]]]]


def _fresh(lib_path: str, inputs: Sequence[str]) -> bool:
    if not os.path.exists(lib_path):
        return False
    built = os.path.getmtime(lib_path)
    return all(os.path.getmtime(p) <= built for p in inputs if os.path.exists(p))


def ensure_built(lib_name: str, inputs: Sequence[str],
                 make_commands: CommandMaker) -> Tuple[str, float, str]:
    """Build ``lib_name`` unless it is newer than every input.

    ``make_commands(out_path, obj_dir)`` returns the compile commands, which
    run in parallel, and an optional link command run after them. Returns
    ``(library path, seconds spent building, compiler stderr)``; raises
    :class:`DMLCError` when a command fails.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, lib_name)
    with open(lib_path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _fresh(lib_path, inputs):
            return lib_path, 0.0, ""
        t0 = time.monotonic()
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        obj_dir = os.path.join(BUILD_DIR, f"obj-{lib_name}-{os.getpid()}")
        os.makedirs(obj_dir, exist_ok=True)
        try:
            compile_cmds, link_cmd = make_commands(tmp, obj_dir)
            logs = _run_parallel(compile_cmds)
            if link_cmd is not None:
                logs += _run_parallel([link_cmd])
            os.replace(tmp, lib_path)
        finally:
            shutil.rmtree(obj_dir, ignore_errors=True)
            if os.path.exists(tmp):
                os.unlink(tmp)
        return lib_path, time.monotonic() - t0, logs


def _run_parallel(cmds: List[List[str]]) -> str:
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for cmd in cmds]
    except OSError as exc:
        raise DMLCError(f"build tool failed to start: {exc}") from exc
    logs, failed = [], []
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate(timeout=600)
        logs.append(out + err)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{err[-4000:]}")
    if failed:
        raise DMLCError("build failed:\n" + "\n".join(failed))
    return "".join(logs)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def _kernel_commands(out_path: str, obj_dir: str):
    # one nvcc per source, all started together, then one link
    nvcc = nvcc_path()
    objs = [os.path.join(obj_dir, os.path.basename(s) + ".o") for s in KERNEL_SOURCES]
    compile_cmds = [
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c", src, "-o", obj]
        for src, obj in zip(KERNEL_SOURCES, objs)]
    link_cmd = [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                "-o", out_path] + objs
    return compile_cmds, link_cmd


def load_kernels() -> ctypes.CDLL:
    """The CUDA kernel library, built on first use; raises when the build
    or the load fails (a CUDA tensor never falls back to the plain version)."""
    global _kernels, kernel_build_seconds, kernel_build_log
    if _kernels is not None:
        return _kernels
    path, seconds, log = ensure_built(KERNEL_LIB, KERNEL_SOURCES + KERNEL_HEADERS,
                                      _kernel_commands)
    try:
        lib = ctypes.CDLL(path)
    except OSError as exc:
        raise DMLCError(f"loading {path} failed: {exc}") from exc
    # (w, idx, val, out, B, K, lo, W, stream): w holds words [lo, lo + W)
    lib.dmlc_ell_matvec_f32.restype = ctypes.c_int
    lib.dmlc_ell_matvec_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    # (idx, val, g, dw, scratch, B, K, lo, W, stream)
    lib.dmlc_ell_matvec_dw_f32.restype = ctypes.c_int
    lib.dmlc_ell_matvec_dw_f32.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 4 + [
        ctypes.c_void_p]
    lib.dmlc_ell_dw_scratch_floats.restype = ctypes.c_int64
    lib.dmlc_ell_dw_scratch_floats.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 3
    lib.dmlc_ell_dw_max_table.restype = ctypes.c_int64
    lib.dmlc_ell_dw_max_table.argtypes = []
    # (span, out, the plan's DmlcDecodeTable, stream), called with the GIL
    # held: the launch returns in microseconds, and a GIL given up around it
    # may go to the snapshot reader's thread for longer than that
    lib.dmlc_decode_span = ctypes.PYFUNCTYPE(ctypes.c_int, *[ctypes.c_void_p] * 4)(
        ("dmlc_decode_span", lib))
    lib.dmlc_row_sort_counts.restype = ctypes.c_int64
    lib.dmlc_row_sort_counts.argtypes = [ctypes.c_int64] * 2
    # (idx, N, rows, counts, sorted, perm, stream)
    lib.dmlc_row_sort.restype = ctypes.c_int
    lib.dmlc_row_sort.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64] + [
        ctypes.c_void_p] * 4
    lib.dmlc_row_scatter_chunks.restype = ctypes.c_int64
    lib.dmlc_row_scatter_chunks.argtypes = [ctypes.c_int64]
    # (sorted ids, perm, src, table, head, tail, N, R, D, accumulate, stream)
    lib.dmlc_row_scatter_f32.restype = ctypes.c_int
    lib.dmlc_row_scatter_f32.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 3 + [
        ctypes.c_int, ctypes.c_void_p]
    lib.dmlc_cuda_error_string.restype = ctypes.c_char_p
    lib.dmlc_cuda_error_string.argtypes = [ctypes.c_int]
    kernel_build_seconds, kernel_build_log = seconds, log
    _kernels = lib
    return lib
