#!/usr/bin/env python3
"""Drive the PyTorch port (``dmlc_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--parent DIR]

Phases, each printing one JSON line; any failure exits non-zero:

1. environment: the card, torch/CUDA versions, the build times of the CUDA
   kernel library and the native parser (both built here from the
   checkout's sources), and the parse engine in use;
2. kernel K1 (``csrc/ell_matvec.cu``) and its ``dw`` kernel
   (``csrc/ell_matvec_dw.cu``) against their plain PyTorch versions at the
   shapes the JAX package cares about and a large HIGGS-shaped batch —
   values with rtol 1e-5 / atol 1e-4, ``dw`` within 1e-4 + 1e-5 of each
   slot's absolute sum and bit-identical over two launches, gradients
   through autograd — with device times beside the plain versions',
   ``F.embedding_bag``'s and ``index_add_``'s (the one PyTorch call for
   each) and the bytes bounds; ``dw`` also from unaligned inputs, which
   take its warp-bin route, timed beside the tile route; values only at
   shapes that reach K1's other branches (its persistent route with a
   ragged last tile, rows wider than a stage, unaligned inputs); with
   ``--parent DIR`` also the parent commit's K1, built from ``DIR``, timed
   in turns with this one (P C C P);
3. the main path at full width: a HIGGS-shaped libsvm corpus (28 dense
   features; UCI dataset 280, 11,000,000 rows, cut to 2**20 rows for the
   time limit) -> create_parser -> DeviceIter(ell) -> LinearLearner ->
   fit(2 epochs) -> accuracy, with the K1 and ``dw`` launch counts of that
   run, the first 20 step losses held against the same batches on the CPU,
   and those 20 steps run twice on the card, bit-identical; the step's
   kernels hold no scatter-add;
4. one epoch of the dense layout on the same corpus;
5. kernel K2 (``csrc/widen_span.cu``), one launch a warm batch, against
   its plain PyTorch version (``decode_batch_plain``), bit for bit, on a
   batch of each kind a snapshot stores at the main path's widths (ELL
   8192x28; packed dense 8192x31 f32, bf16 with its widened label and
   weight, and int8 with its scale row; unpacked dense 8192x29 f32 and
   bf16), laid out as a snapshot lays them out (64-byte-aligned segments)
   and from an unaligned start, one launch counted a batch; with its device
   time beside the plain version's, the one PyTorch call computing the same
   decode where there is one (a slab's ``clone``, q8's promoting multiply),
   the bytes bound and the host's dispatch time; with ``--parent DIR`` also
   the parent commit's route (a launch of its K2 a float segment, then
   torch's cast and multiply or ``.to(float32)``), built from ``DIR`` and
   timed in turns with this one. Then K2 on one segment
   (``widen_span_cuda``) at the shapes of earlier slices (HIGGS packed
   dense 8192x30 and 8192x31, f32 and bf16; ELL values 8192x28; a
   lane-aligned 8192x1024; an odd 1000x7), from aligned and unaligned
   starts, beside ``seg.view(dtype).reshape(rows, cols).clone()``;
6. the warm main path: ``create_parser(snapshot=)`` -> ``DeviceIter(ell,
   device_decode=True)`` -> ``fit(3 epochs)`` -> ``accuracy``: epoch 1 is
   cold and writes the snapshot, epochs 2-3 and the accuracy pass decode
   each batch on the card in exactly one K2 launch (and step through K1),
   with per-epoch rows/s, stall share, decode dispatch a batch and the
   snapshot and decode counters, and a profiled window of steps fed by a
   warm device-decode epoch; then a cold plus a warm device-decode epoch of
   packed dense f32, bf16 and int8 (``snapshot_quant="int8"``), each with
   exactly one K2 launch a warm batch; the first 8 warm device-decode
   batches of each held against the host-decode warm path's, byte for byte
   (``x``, ``y`` and ``w`` too); one warm bf16 and one warm int8 batch's
   decode under ``torch.profiler``, where K2 must be the one kernel; and
   healing: a byte flipped in a warm batch of a small snapshot, the warm
   device-decode epoch equal to the cold one byte for byte after one
   pipeline restart;
7. checkpoints on the main path: a cold ELL epoch checkpointed after 37
   batches (the DeviceIter state through JSON, the parameters through
   numpy), closed and resumed in a fresh pipeline by a seek of the split
   (under 0.8 of the corpus read), to the uninterrupted epoch's weight and
   bias exactly (``torch.equal``); on phase 6's snapshot, a warm checkpoint
   and the cold one each resumed into a fresh warm device-decode pipeline:
   the remaining batches bit-equal to the uninterrupted warm epoch's, one
   K2 launch each, the same final weights; with the load time, the time to
   the first batch and the restored epoch's rows/s;
8. the bcoo layout: ``DeviceIter(layout="bcoo", batch_size=8192,
   max_nnz=28)`` -> ``LinearLearner(layout="bcoo")``, the first 20 steps
   under CUDA's sync debug mode "error" and within 1e-4 relative of the
   same batches on the CPU, the first batch's dense form equal to the CPU
   route's; a fresh epoch and an accuracy pass (above 0.9, one nnz shape
   crossed), rows/s and stall share, the step's device time on a resident
   batch beside the ELL step's, 20 of each step enqueued behind a device
   spin without waiting for it (no host sync, also none inside a library),
   and one epoch of natural blocks (``batch_size=None``) with a finite
   loss.

The ``torch.profiler`` windows run last, the decode's first: the steps'
windows of phases 3 and 6 (``step``, ``step_warm``) follow it, and a
bcoo step's (``bcoo_step_profile``, device time by kernel). Then the
run's total wall time, a ``{"kernels": [...]}`` line (launches counted on
the main paths of phases 3, 6 and 7), the card's name and power limit as
``nvidia-smi`` reports them, and as the last line
``{"ok": true, "device": {...}}``. Exits non-zero without a result when no
CUDA device is present.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores
HIGGS_ROWS, HIGGS_COLS = 1 << 20, 28
BATCH = 8192
K1_SHAPES = [  # (name, B, K, W)
    ("higgs", 8192, 28, 29),          # dense-in-sparse: the main path's shape
    ("tpu_band", 8192, 64, 2049),     # the old TPU kernel's band
    ("kdd_like", 8192, 16, (1 << 20) + 1),
    ("odd", 1000, 7, 101),
    ("higgs_large", 1 << 18, 28, 29),  # 58.7 MB of idx + val: bytes dominate
]
K1_RTOL, K1_ATOL = 1e-5, 1e-4
K2_SHAPES = [  # (name, rows, cols, dtype)
    ("higgs_dense_f32", 8192, 30, "float32"),     # 28 features + label + weight
    ("higgs_dense_bf16", 8192, 30, "bfloat16"),
    ("dense_path_f32", 8192, 31, "float32"),      # the dense learner's 29 + 2
    ("dense_path_bf16", 8192, 31, "bfloat16"),
    ("ell_values", 8192, 28, "float32"),          # the warm ELL path's segment
    ("lane_aligned", 8192, 1024, "float32"),      # a shape the TPU kernel took
    ("odd_f32", 1000, 7, "float32"),
    ("odd_bf16", 1000, 7, "bfloat16"),
]
K2_KINDS = [  # (name, batch kind): a warm batch of each kind a snapshot stores
    ("ell", "ell"),                              # the warm main path's
    ("dense_packed_f32", "dense_packed"),        # 29 + label + weight columns
    ("dense_packed_bf16", "dense_packed"),
    ("dense_packed_q8", "dense_packed_q8"),
    ("dense_f32", "dense"),
    ("dense_bf16", "dense"),
]
K2_MAIN = "ell"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# ---------------- phase 1: environment and builds ----------------

def build_all() -> dict:
    """Build the kernel library and the native parser concurrently."""
    from dmlc_tpu_torch import native
    from dmlc_tpu_torch.ops import _build

    t0 = time.monotonic()
    with ThreadPoolExecutor(2) as pool:
        kern = pool.submit(_build.load_kernels)
        nat = pool.submit(native.available)
        kern.result()
        native_ok = nat.result()
    ptxas = [line.strip() for line in _build.kernel_build_log.splitlines()
             if "registers" in line or "spill" in line]
    return {"build_wall_s": time.monotonic() - t0,
            "kernel_build_s": _build.kernel_build_seconds,
            "native_build_s": native.build_seconds,
            "parse_engine": "native" if native_ok else "numpy",
            "ptxas": ptxas}


# ---------------- phase 2: kernel K1 against its plain version ----------------

def k1_inputs(b, k, w, seed, device):
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    table = torch.randn(w, generator=gen, device=device)
    table[-1] = 0.0  # the pinned-zero sink
    idx = torch.randint(0, w - 1, (b, k), generator=gen, device=device,
                        dtype=torch.int32)
    val = torch.randn((b, k), generator=gen, device=device)
    pad = torch.rand((b, k), generator=gen, device=device) < 0.25
    idx[pad] = w - 1
    val[pad] = 0.0
    return table, idx, val


def device_ms(fn, iters: int = 50, repeats: int = 5, warmup: int = 10,
              spin_cycles: int = 100_000_000) -> float:
    """Device time of one call: CUDA events around ``iters`` calls, over the
    count; the median of ``repeats`` such runs. Each run is queued behind a
    device-side spin, so the events time the device's work back to back
    and not the host's launch cost."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return statistics.median(runs)


def bound(nbytes: int, ops: int) -> tuple:
    """The least time for the work, ``(ms, "bytes" or "operations")``: the
    bytes at the card's memory rate or the fp32 operations at its fp32
    rate, whichever takes longer."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_FLOPS * 1e3
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations")


def k1_bound_ms(idx, b: int, k: int) -> tuple:
    """K1: each input byte read once (idx, val, and the table words this
    batch touches), the output written once; 2*B*K fp32 operations."""
    import torch

    touched = int(torch.unique(idx).numel())
    return bound(b * k * 8 + b * 4 + touched * 4, 2 * b * k)


def dw_bound_ms(b: int, k: int, w: int) -> tuple:
    """K1's dw: idx, val and g read once, dw written once; 2*B*K fp32
    operations."""
    return bound(b * k * 8 + b * 4 + w * 4, 2 * b * k)


def load_parent_libs(parent: str, out_dir: str) -> dict:
    """The parent commit's K1 and K2, each built from ``parent``'s
    ``dmlc_tpu_torch/csrc/`` into a library of its own under ``out_dir``
    (two ``nvcc`` at once), for an A/B in one run. The C interfaces are the
    parent's: ``dmlc_ell_matvec_f32(w, idx, val, out, B, K, W, stream)``
    and ``dmlc_widen_span(seg, out, rows, cols, itemsize, stream)``, one
    launch a float segment."""
    import ctypes

    from dmlc_tpu_torch.ops import _build

    procs = {}
    for name in ("ell_matvec", "widen_span"):
        src = os.path.join(parent, "dmlc_tpu_torch", "csrc", name + ".cu")
        lib_path = os.path.join(out_dir, f"lib{name}_parent.so")
        procs[name] = (lib_path, subprocess.Popen(
            [_build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib_path, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib_path, proc) in procs.items():
        _, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"the parent's {name}.cu failed to build:\n{err[-4000:]}")
        libs[name] = ctypes.CDLL(lib_path)
    libs["ell_matvec"].dmlc_ell_matvec_f32.restype = ctypes.c_int
    libs["ell_matvec"].dmlc_ell_matvec_f32.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int64] * 3 + [ctypes.c_void_p]
    libs["widen_span"].dmlc_widen_span.restype = ctypes.c_int
    libs["widen_span"].dmlc_widen_span.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p]
    return libs


def parent_k1_fn(lib, table, idx, val):
    """``(run, out)`` for the parent's K1 on these inputs."""
    import torch

    (b, k), w = idx.shape, table.shape[0]
    out = torch.empty(b, device=idx.device)

    def run():
        rc = lib.dmlc_ell_matvec_f32(table.data_ptr(), idx.data_ptr(), val.data_ptr(),
                                     out.data_ptr(), b, k, w,
                                     torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise AssertionError(f"the parent's K1 failed to launch: {rc}")
    return run, out


def phase_k1(seed: int, parent=None) -> list:
    import torch
    import torch.nn.functional as F

    from dmlc_tpu_torch.ops import _build
    from dmlc_tpu_torch.ops import ell_matvec as k1
    from dmlc_tpu_torch.ops.sparse import EllBatch, ell_matvec

    if _build.load_kernels().dmlc_ell_dw_max_table() != k1.DW_MAX_TABLE:
        raise AssertionError("DW_MAX_TABLE differs from the dw kernel's own limit")
    dev = torch.device("cuda", torch.cuda.current_device())
    rows = []
    for i, (name, b, k, w) in enumerate(K1_SHAPES):
        table, idx, val = k1_inputs(b, k, w, seed + i, dev)
        batch = EllBatch(idx, val, None, None)
        out = k1.ell_matvec_cuda(table, idx, val)
        ref = ell_matvec(table, batch)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, rtol=K1_RTOL, atol=K1_ATOL)
        err = float((out - ref).abs().max())
        repeatable_fwd = torch.equal(out, k1.ell_matvec_cuda(table, idx, val))
        # idx and val 4 bytes past a 16-byte boundary: no vectors, no staging
        idx_u = torch.empty(b * k + 1, dtype=torch.int32, device=dev)[1:].view(b, k)
        val_u = torch.empty(b * k + 1, device=dev)[1:].view(b, k)
        idx_u.copy_(idx)
        val_u.copy_(val)
        torch.testing.assert_close(k1.ell_matvec_cuda(table, idx_u, val_u), ref,
                                   rtol=K1_RTOL, atol=K1_ATOL)
        g = torch.randn(b, generator=torch.Generator(device=dev).manual_seed(seed + 100 + i),
                        device=dev)
        # dw on its route against the plain version (index_add_), and twice
        route = k1.dw_route(w)
        if route == "cuda":
            def dw_fn():
                return k1.ell_matvec_dw_cuda(idx, val, g, w)
        else:
            def dw_fn():
                return k1.ell_matvec_grads(table, idx, val, g, need_dval=False)[0]
        dw, dw_again = dw_fn(), dw_fn()
        dw_plain = k1.ell_matvec_grads(table, idx, val, g, need_dval=False)[0]
        torch.cuda.synchronize()
        dw_repeatable = torch.equal(dw, dw_again)
        if route == "cuda" and not (dw_repeatable and repeatable_fwd):
            raise AssertionError(f"K1 {name}: two launches differ (forward repeatable "
                                 f"{repeatable_fwd}, dw repeatable {dw_repeatable})")
        # dw sums up to B*K products per table slot, the plain version in
        # atomic (run-to-run) order: allow 1e-5 of the slot's absolute sum
        scale = torch.zeros_like(table).index_add_(
            0, idx.long().flatten(), (val * g[:, None]).abs().flatten())
        tol = K1_ATOL + K1_RTOL * scale
        dw_kernel_err = (dw - dw_plain).abs()
        if bool((dw_kernel_err > tol).any()):
            raise AssertionError(f"K1 {name}: dw differs by up to {float(dw_kernel_err.max())}")
        # dw from the unaligned copies: the warp-bin route wherever the tile
        # route would take the aligned inputs (it needs 16-byte starts), so
        # its time here sits beside the tile route's at the same shape
        dw_unaligned_ms = None
        if route == "cuda":
            dw_u = k1.ell_matvec_dw_cuda(idx_u, val_u, g, w)
            dw_u_again = k1.ell_matvec_dw_cuda(idx_u, val_u, g, w)
            torch.cuda.synchronize()
            if not torch.equal(dw_u, dw_u_again) or bool(((dw_u - dw_plain).abs() > tol).any()):
                raise AssertionError(f"K1 {name}: dw from unaligned inputs differs from the plain "
                                     f"version or between two launches")
            dw_kernel_err = torch.maximum(dw_kernel_err, (dw_u - dw_plain).abs())
            dw_unaligned_ms = device_ms(lambda: k1.ell_matvec_dw_cuda(idx_u, val_u, g, w))
        # gradients through autograd: the kernels' backward against autograd
        # through the plain version
        tw, tv = table.clone().requires_grad_(), val.clone().requires_grad_()
        (k1.EllMatvec.apply(tw, idx, tv) * g).sum().backward()
        rw, rv = table.clone().requires_grad_(), val.clone().requires_grad_()
        (ell_matvec(rw, EllBatch(idx, rv, None, None)) * g).sum().backward()
        torch.testing.assert_close(tv.grad, rv.grad, rtol=K1_RTOL, atol=K1_ATOL)
        dw_err = (tw.grad - rw.grad).abs()
        if bool((dw_err > tol).any()):
            raise AssertionError(f"K1 {name}: autograd dw differs by up to {float(dw_err.max())}")
        # embedding_bag computes the same function in one PyTorch call
        lib_out = F.embedding_bag(idx, table[:, None], per_sample_weights=val,
                                  mode="sum")[:, 0]
        torch.testing.assert_close(lib_out, ref, rtol=K1_RTOL, atol=K1_ATOL)
        ms = device_ms(lambda: k1.ell_matvec_cuda(table, idx, val))
        plain_ms = device_ms(lambda: ell_matvec(table, batch))
        library_ms = device_ms(lambda: F.embedding_bag(
            idx, table[:, None], per_sample_weights=val, mode="sum"))
        ab = {}
        if parent is not None:
            # the parent's kernel and this one in turns: P C C P
            p_run, p_out = parent_k1_fn(parent, table, idx, val)
            p_run()
            torch.testing.assert_close(p_out, ref, rtol=K1_RTOL, atol=K1_ATOL)
            kernel = lambda: k1.ell_matvec_cuda(table, idx, val)  # noqa: E731
            order = [device_ms(f) for f in (p_run, kernel, kernel, p_run)]
            ab = {"parent_ms_runs": [order[0], order[3]], "change_ms_runs": order[1:3]}
        bound_ms, bound_by = k1_bound_ms(idx, b, k)
        # dw: the route's time, the plain version's, and index_add_ alone
        # on precomputed int64 indices and products (the one PyTorch call)
        dw_ms = device_ms(dw_fn)
        dw_plain_ms = device_ms(lambda: k1.ell_matvec_grads(table, idx, val, g,
                                                            need_dval=False))
        flat_idx, prod = idx.long().flatten(), (val * g[:, None]).flatten()
        acc = torch.zeros_like(table)
        dw_library_ms = device_ms(lambda: acc.index_add_(0, flat_idx, prod))
        dw_bound, dw_bound_by = dw_bound_ms(b, k, w)
        row = {"phase": "k1", "shape": name, "B": b, "K": k, "W": w,
               "max_abs_err": err, "dw_max_abs_err": float(dw_err.max()),
               "dw_kernel_max_abs_err": float(dw_kernel_err.max()),
               "repeatable": repeatable_fwd,
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_share": bound_ms / ms,
               "dw_route": route, "dw_repeatable": dw_repeatable,
               "dw_ms": dw_ms, "dw_plain_ms": dw_plain_ms,
               "dw_library_ms": dw_library_ms, "dw_unaligned_ms": dw_unaligned_ms,
               "dw_bound_ms": dw_bound, "dw_bound_by": dw_bound_by,
               "dw_bound_share": dw_bound / dw_ms, **ab}
        emit(row)
        rows.append(row)
    # values only: one pass with 32 lanes a row (K > 64), a table too wide
    # for shared memory, a part-filled warp; the persistent route (B >
    # 65,536) staged with a ragged last tile (17 rows of 7 words, no
    # multiple of 16 bytes) and a staged table, and unstaged (K > 64) with
    # the table in L2
    for b, k, w in ((300, 257, 29), (1001, 5, 5000), (77, 3, 7), (70_001, 7, 101),
                    (65_600, 72, 5000)):
        table, idx, val = k1_inputs(b, k, w, seed, dev)
        torch.testing.assert_close(k1.ell_matvec_cuda(table, idx, val),
                                   ell_matvec(table, EllBatch(idx, val, None, None)),
                                   rtol=K1_RTOL, atol=K1_ATOL)
    return rows


# ---------------- phase 3: the main path ----------------

def write_higgs_corpus(path: str, rows: int, seed: int,
                       cols: int = HIGGS_COLS) -> dict:
    """A HIGGS-shaped libsvm file: ``cols`` dense real features per row
    (0-based indices, fixed-width values ``+d.dddddd``) and a binary label
    from a fixed linear rule plus noise. Formatted with numpy in bulk."""
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=cols)
    # one row's bytes, with the offset of each value's sign byte
    template = bytearray(b"0")
    vpos = []
    for j in range(cols):
        template += f" {j}:".encode()
        vpos.append(len(template))
        template += b"+0.000000"
    template += b"\n"
    tmpl = np.frombuffer(bytes(template), np.uint8)
    row_len, pos = len(tmpl), np.array(vpos)
    chunk = 1 << 16
    with open(path, "wb") as f:
        for start in range(0, rows, chunk):
            n = min(chunk, rows - start)
            x = rng.normal(size=(n, cols))
            y = (x @ w_true + 0.1 * rng.normal(size=n) > 0).astype(np.uint8)
            q = np.minimum(np.rint(np.abs(x) * 1e6), 9_999_999).astype(np.int64)
            buf = np.empty((n, row_len), np.uint8)
            buf[:] = tmpl
            buf[:, 0] = ord("0") + y
            buf[:, pos] = np.where(x < 0, ord("-"), ord("+"))
            buf[:, pos + 1] = ord("0") + q // 1_000_000
            for d in range(6):
                buf[:, pos + 3 + d] = ord("0") + (q // 10 ** (5 - d)) % 10
            f.write(buf.tobytes())
    return {"rows": rows, "cols": cols, "bytes": os.path.getsize(path)}


def run_main_path(path: str, device, epochs: int = 2) -> dict:
    """create_parser -> DeviceIter(ell) -> LinearLearner -> fit -> accuracy,
    as a user would call them. Returns per-epoch records and the accuracy."""
    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser

    parser = create_parser(path, 0, 1, "libsvm")
    model = LinearLearner(num_col=HIGGS_COLS, layout="ell", learning_rate=0.3,
                          device=device)
    it = DeviceIter(parser, num_col=model.device_num_col(), batch_size=BATCH,
                    layout="ell", max_nnz=HIGGS_COLS, drop_remainder=True,
                    device=device)
    epochs_out = []
    keys = ("stall_seconds", "bytes_to_device", "source_wait_seconds",
            "convert_seconds")
    prev = {k: 0 for k in keys}

    def log(epoch, loss, nb, secs):
        now = it.stats()
        delta = {k: now[k] - prev[k] for k in keys}
        prev.update({k: now[k] for k in keys})
        rec = {"phase": "main_path", "epoch": epoch, "loss": loss, "batches": nb,
               "wall_s": secs, "rows_per_s": nb * BATCH / secs,
               "stall_s": delta["stall_seconds"],
               "stall_share": delta["stall_seconds"] / secs,
               "bytes_to_device": delta["bytes_to_device"],
               "producer_source_wait_s": delta["source_wait_seconds"],
               "producer_convert_s": delta["convert_seconds"]}
        emit(rec)
        epochs_out.append(rec)

    t0 = time.monotonic()
    model.fit(it, epochs=epochs, log_fn=log)
    t1 = time.monotonic()
    acc = model.accuracy(it)
    t2 = time.monotonic()
    engine = parser.engine
    it.close()
    return {"epochs": epochs_out, "accuracy": acc, "fit_s": t1 - t0,
            "accuracy_s": t2 - t1, "engine": engine,
            "steps": sum(e["batches"] for e in epochs_out),
            "accuracy_batches": HIGGS_ROWS // BATCH}


def compare_first_losses(path: str, device, steps: int = 20) -> dict:
    """The first ``steps`` step losses on ``device`` against the same
    batches stepped through the port on the CPU (plain route)."""
    import torch

    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser
    from dmlc_tpu_torch.ops.sparse import EllBatch

    dev_model = LinearLearner(HIGGS_COLS, layout="ell", learning_rate=0.3, device=device)
    cpu_model = LinearLearner(HIGGS_COLS, layout="ell", learning_rate=0.3, device="cpu")
    it = DeviceIter(create_parser(path, 0, 1, "libsvm"),
                    num_col=dev_model.device_num_col(), batch_size=BATCH,
                    layout="ell", max_nnz=HIGGS_COLS, drop_remainder=True,
                    device=device)
    pairs, dev_losses = [], []
    for _, batch in zip(range(steps), it):
        dev_loss = dev_model.step(batch)
        cpu_loss = cpu_model.step(EllBatch(*(t.cpu() for t in batch)))
        dev_losses.append(dev_loss)
        pairs.append((float(dev_loss), float(cpu_loss)))
    it.close()
    rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in pairs)
    return {"steps": len(pairs), "max_rel_diff": rel, "losses": pairs,
            "card_losses": torch.stack(dev_losses),
            "card_weight": dev_model.params.weight.detach().clone()}


def card_trajectory(path: str, device, steps: int = 20):
    """The first ``steps`` step losses and the final weight on ``device``
    alone, as :func:`compare_first_losses` steps them there."""
    import torch

    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser

    model = LinearLearner(HIGGS_COLS, layout="ell", learning_rate=0.3, device=device)
    it = DeviceIter(create_parser(path, 0, 1, "libsvm"), num_col=model.device_num_col(),
                    batch_size=BATCH, layout="ell", max_nnz=HIGGS_COLS,
                    drop_remainder=True, device=device)
    losses = [model.step(batch) for _, batch in zip(range(steps), it)]
    it.close()
    return torch.stack(losses), model.params.weight.detach().clone()


def step_times(path: str, device, window: int = 40, snapshot=None) -> dict:
    """Where an ELL step's time goes.

    On a batch already on the card: the step must not synchronise the host
    (checked with CUDA's sync debug mode set to raise), its device time
    (CUDA events, queued behind a spin) and its wall time per step in a
    loop of 50 that ends in a synchronise. Then ``window`` steps fed by a
    DeviceIter under ``torch.profiler``: device time by kernel per step and
    the share of the window's wall time in which the device was busy. With
    a published ``snapshot`` the feed is its warm device-decode epoch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser

    model = LinearLearner(HIGGS_COLS, layout="ell", learning_rate=0.3, device=device)
    it = DeviceIter(create_parser(path, 0, 1, "libsvm", snapshot=snapshot),
                    num_col=model.device_num_col(), batch_size=BATCH, layout="ell",
                    max_nnz=HIGGS_COLS, drop_remainder=True, device=device,
                    device_decode=snapshot is not None)
    batch = next(it)
    model.step(batch)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            model.step(batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # a step is some 15 launches: runs of 10 fit in the device's launch
    # queue behind the spin, so the host never feeds the device mid-run
    dev_ms = device_ms(lambda: model.step(batch), iters=10)
    t0 = time.monotonic()
    for _ in range(50):
        model.step(batch)
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) / 50 * 1e3

    it.reset()
    for _, b in zip(range(4), it):  # warm the producer before the window
        model.step(b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _, b in zip(range(window), it):
            model.step(b)
        torch.cuda.synchronize()
        window_s = time.monotonic() - t0
    state = it.stats()["snapshot_state"]
    it.close()
    if state != ("warm" if snapshot is not None else None):
        raise AssertionError(f"the profiled window's snapshot state is {state}")
    per_kernel: dict = {}
    spans = []
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[evt.name] = (per_kernel.get(evt.name, 0.0)
                                    + evt.time_range.elapsed_us() / window / 1e3)
            spans.append((evt.time_range.start, evt.time_range.end))
    busy_us, reach = 0.0, float("-inf")  # union of the device's busy intervals
    for start, end in sorted(spans):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    return {"phase": "step" if snapshot is None else "step_warm",
            "step_device_ms": dev_ms, "step_wall_ms": wall_ms,
            "fed_window_steps": window, "fed_window_s": window_s,
            "fed_device_busy_share": busy_us / 1e6 / window_s,
            "profiled_device_ms_per_step": busy_us / 1e3 / window,
            "top_kernels_ms_per_step": [[name[:80], ms] for name, ms in top]}


def run_dense_epoch(path: str, device) -> dict:
    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser

    model = LinearLearner(HIGGS_COLS, layout="dense", learning_rate=0.3, device=device)
    it = DeviceIter(create_parser(path, 0, 1, "libsvm"), num_col=model.device_num_col(),
                    batch_size=BATCH, layout="dense", drop_remainder=True, device=device)
    t0 = time.monotonic()
    loss, nb = model.fit_epoch(it)
    secs = time.monotonic() - t0
    out = {"phase": "dense", "loss": loss, "batches": nb, "wall_s": secs,
           "rows_per_s": nb * BATCH / secs, "stall_s": it.stall_seconds,
           "stall_share": it.stall_seconds / secs,
           "bytes_to_device": it.bytes_to_device}
    it.close()
    return out


# ---------------- phase 5: kernel K2 against its plain version ----------------

def k2_segments(seed: int) -> list:
    """K2 on one segment (a one-entry plan, :func:`widen_span_cuda`) at
    ``K2_SHAPES``, laid out as the snapshot spans lay them out (64 bytes
    into a u8 span) and from an unaligned start (1 byte in: loads from
    bytes), bit-exact against the plain version and the source values."""
    import torch

    from dmlc_tpu_torch.ops import device_decode as dd

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows_out = []
    for name, rows, cols, dtype_name in K2_SHAPES:
        dt = getattr(torch, dtype_name)
        iv = torch.int32 if dt == torch.float32 else torch.int16
        vals = (torch.randn(rows, cols, generator=gen, device=dev) * 1e3).to(dt)
        vals.view(-1)[:4] = torch.tensor([float("nan"), float("inf"), -0.0, -1e-30]).to(dt)
        raw = vals.view(torch.uint8).reshape(-1)
        nbytes = raw.numel()
        segs = {}
        for off in (64, 1):
            span = torch.zeros(nbytes + 128, dtype=torch.uint8, device=dev)
            span[off: off + nbytes] = raw
            segs[off] = span[off: off + nbytes]
        for off, seg in segs.items():
            out = dd.widen_span_cuda(seg, rows, cols, dt)
            plain = dd.widen_span_plain(seg, rows, cols, dt)
            torch.cuda.synchronize()
            if not (torch.equal(out.view(iv), plain.view(iv))
                    and torch.equal(out.view(iv), vals.view(iv))):
                raise AssertionError(f"K2 {name} (offset {off}) differs from its plain version")
        seg = segs[64]
        out, plain = dd.widen_span_cuda(seg, rows, cols, dt), dd.widen_span_plain(seg, rows, cols, dt)
        finite = torch.isfinite(plain.float())
        err = float((out.float() - plain.float())[finite].abs().max())
        ms = device_ms(lambda: dd.widen_span_cuda(seg, rows, cols, dt))
        unaligned_ms = device_ms(lambda: dd.widen_span_cuda(segs[1], rows, cols, dt))
        plain_ms = device_ms(lambda: dd.widen_span_plain(seg, rows, cols, dt))
        # a view alone costs the device nothing: the one PyTorch call that
        # makes the same fresh [rows, cols] tensor is the view's clone
        library_ms = device_ms(lambda: seg.view(dt).reshape(rows, cols).clone())
        bound_ms = 2 * nbytes / HBM_BYTES_PER_S * 1e3
        row = {"phase": "k2", "shape": name, "rows": rows, "cols": cols,
               "dtype": dtype_name, "bytes": nbytes, "bit_exact": True,
               "unaligned_bit_exact": True, "max_abs_err": err,
               "ms": ms, "unaligned_ms": unaligned_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": "bytes",
               "bound_share": bound_ms / ms}
        emit(row)
        rows_out.append(row)
    return rows_out


def k2_arrays(name: str, gen, dev) -> list:
    """A warm batch of kind ``name`` (``K2_KINDS``) at the main path's
    widths, on the card: float slabs with NaN, infinities and -0.0 in them
    (in the bf16 aux columns too), q8 with a scale row."""
    import torch

    b, nc = BATCH, HIGGS_COLS + 1

    def slab(cols):
        a = torch.randn(b, cols, generator=gen, device=dev) * 1e3
        a[:3, -2:] = torch.tensor([float("nan"), float("inf"), -0.0], device=dev)[:, None]
        a.view(-1)[:4] = torch.tensor([float("nan"), float("inf"), -0.0, -1e-30], device=dev)
        return a

    def col():
        return torch.randn(b, generator=gen, device=dev)

    if name == "ell":
        idx = torch.randint(0, nc, (b, HIGGS_COLS), generator=gen, device=dev, dtype=torch.int32)
        return [idx, slab(HIGGS_COLS), col(), torch.ones(b, device=dev)]
    if name == "dense_packed_q8":
        q = torch.randint(-127, 128, (b, nc + 2), generator=gen, device=dev, dtype=torch.int8)
        scale = torch.rand(nc + 2, generator=gen, device=dev) * 3
        scale[0] = 1.0
        return [q, scale]
    dt = torch.bfloat16 if name.endswith("bf16") else torch.float32
    if name.startswith("dense_packed"):
        return [slab(nc + 2).to(dt)]
    return [slab(nc).to(dt), col(), torch.ones(b, device=dev)]


def k2_span(arrays: list, shift: int):
    """``arrays`` laid out as a snapshot batch lays them out (each segment
    64-byte aligned within the span), in a u8 span that starts ``shift``
    bytes into its allocation; returns ``(span, layout)``."""
    import torch

    names = {torch.float32: "<f4", torch.bfloat16: "bfloat16", torch.int32: "<i4",
             torch.int8: "|i1"}
    layout, parts, end = [], [], 0
    for i, a in enumerate(arrays):
        raw = a.contiguous().view(torch.uint8).reshape(-1)
        off = -(-end // 64) * 64
        layout.append((f"a{i}", names[a.dtype], off, raw.numel(), tuple(a.shape)))
        parts.append((off, raw))
        end = off + raw.numel()
    base = torch.zeros(end + 64, dtype=torch.uint8, device=arrays[0].device)
    span = base[shift: shift + end]
    for off, raw in parts:
        span[off: off + raw.numel()] = raw
    return span, tuple(layout)


def batch_tensors(batch) -> list:
    """Every tensor a consumer can take from a decoded batch: a packed
    batch's slab and its ``x``, ``y`` and ``w``, or the tuple's members."""
    if hasattr(batch, "packed"):
        return [batch.packed, *batch]
    return list(batch)


def same_bits(a, b) -> bool:
    """Equal dtype, shape and bits (NaN payloads included)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    iv = {4: torch.int32, 2: torch.int16, 1: torch.uint8}[a.element_size()]
    return torch.equal(a.view(iv), b.view(iv))


def k2_moved_bytes(plan) -> int:
    """The bytes K2 must move for ``plan``: each input read once (a q8
    slab's scale row too), each output written once (a bf16 slab's aux
    columns too); views move nothing."""
    from dmlc_tpu_torch.ops import device_decode as dd

    total = 0
    for op in plan.table.ops[: plan.table.count]:
        n = op.rows * op.cols
        if op.op == dd.OP_DEQUANT_Q8:
            total += n + 4 * op.cols + 4 * n
        elif op.op == dd.OP_BF16_AUX:
            total += 2 * n * 2 + 2 * op.rows * 4
        else:
            total += 2 * n * (4 if op.op == dd.OP_COPY4 else 2)
    return total


def parent_k2_route(lib, span, layout, kind: str, num_col: int):
    """The parent's decode of one batch, as its ``DeviceIter`` issued it:
    a launch of its K2 for each 2-D float segment, views for the rest, then
    torch's ``q.to(float32) * scale`` for a q8 batch and ``.to(float32)``
    of a packed batch's label and weight. Returns the batch's tensors as
    :func:`batch_tensors` lists them."""
    import torch

    dtypes = {"<f4": torch.float32, "bfloat16": torch.bfloat16, "<i4": torch.int32,
              "|i1": torch.int8}
    stream = torch.cuda.current_stream().cuda_stream
    segs = []
    for _, dtype_str, off, nbytes, shape in layout:
        dt, seg = dtypes[dtype_str], span[off: off + nbytes]
        if len(shape) == 2 and dt in (torch.float32, torch.bfloat16):
            out = torch.empty(shape, dtype=dt, device=span.device)
            rc = lib.dmlc_widen_span(seg.data_ptr(), out.data_ptr(), shape[0], shape[1],
                                     seg.numel() // (shape[0] * shape[1]), stream)
            if rc != 0:
                raise AssertionError(f"the parent's K2 failed to launch: {rc}")
            segs.append(out)
        else:
            segs.append(seg.view(dt).view(shape))
    if kind == "dense_packed_q8":
        segs = [segs[0].to(torch.float32) * segs[1]]
    if kind.startswith("dense_packed"):
        p = segs[0]
        return [p, p[:, :num_col], p[:, num_col].to(torch.float32),
                p[:, num_col + 1].to(torch.float32)]
    return segs


def k2_kinds(seed: int, parent=None) -> list:
    """K2 on a warm batch of each kind (``K2_KINDS``), one launch for the
    whole span, against :func:`decode_batch_plain` bit for bit, from a
    64-byte-aligned and an unaligned start, with one launch counted per
    call. Device times: the kernel (aligned and not), the plain version
    (its lazy widening included), the one PyTorch call computing the same
    decode where there is one, and with ``parent`` the parent's route in
    turns with this one, P C C P; and the host's dispatch time of a
    decode."""
    import torch

    from dmlc_tpu_torch.ops import device_decode as dd

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    rows_out = []
    for name, kind in K2_KINDS:
        arrays = k2_arrays(name, gen, dev)
        nc = HIGGS_COLS + 1
        spans = {shift: k2_span(arrays, shift) for shift in (0, 1)}
        for shift, (span, layout) in spans.items():
            before = dd.launches
            got = batch_tensors(dd.decode_batch_cuda(span, layout, kind, nc))
            want = batch_tensors(dd.decode_batch_plain(span, layout, kind, nc))
            torch.cuda.synchronize()
            if dd.launches != before + 1:
                raise AssertionError(f"K2 {name}: {dd.launches - before} launches for one batch")
            if len(got) != len(want) or not all(same_bits(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"K2 {name} (start {shift}) differs from decode_batch_plain")
        span, layout = spans[0]
        plan = dd.plan_for(kind, layout, nc)
        got = batch_tensors(dd.decode_batch_cuda(span, layout, kind, nc))
        want = batch_tensors(dd.decode_batch_plain(span, layout, kind, nc))
        finite = [torch.isfinite(w.float()) for w in want]
        err = max(float((g.float() - w.float())[f].abs().max()) for g, w, f in zip(got, want, finite))

        def kernel():
            return dd.decode_batch_cuda(span, layout, kind, nc)

        ms = device_ms(kernel)
        unaligned_ms = device_ms(lambda: dd.decode_batch_cuda(*spans[1], kind, nc))
        plain_ms = device_ms(lambda: batch_tensors(dd.decode_batch_plain(span, layout, kind, nc)))
        # the one PyTorch call that computes the same decode: a slab's clone
        # (the views cost the device nothing), q8's promoting multiply; a
        # bf16 packed slab with its widened aux takes no single call
        library = None
        if kind == "dense_packed_q8":
            q, scale = arrays

            def library():
                return q * scale
        elif name != "dense_packed_bf16":
            _, dtype_str, off, nbytes, shape = layout[0 if kind != "ell" else 1]
            seg, dt = span[off: off + nbytes], arrays[0 if kind != "ell" else 1].dtype

            def library():
                return seg.view(dt).reshape(shape).clone()
        if library is not None and not same_bits(library(), got[0 if kind != "ell" else 1]):
            raise AssertionError(f"K2 {name}: the library call computes another function")
        library_ms = device_ms(library) if library is not None else None
        ab = {}
        if parent is not None:
            p_tensors = parent_k2_route(parent, span, layout, kind, nc)
            if not all(same_bits(a, b) for a, b in zip(p_tensors, got)):
                raise AssertionError(f"K2 {name}: the parent's route decodes other bits")
            p_run = lambda: parent_k2_route(parent, span, layout, kind, nc)  # noqa: E731
            order = [device_ms(f) for f in (p_run, kernel, kernel, p_run)]
            ab = {"parent_ms_runs": [order[0], order[3]], "change_ms_runs": order[1:3]}
        # the host's side of one decode: the dispatch DeviceIter counts
        host = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                kernel()
            host.append((time.perf_counter() - t0) / 200 * 1e3)
        torch.cuda.synchronize()
        nbytes = k2_moved_bytes(plan)
        bound_ms, bound_by = bound(nbytes, 0)
        row = {"phase": "k2_kind", "kind": name, "batch_kind": kind,
               "segments": [list(s[1:]) for s in layout], "entries": plan.table.count,
               "blocks": plan.table.blocks, "bytes": nbytes, "bit_exact": True,
               "unaligned_bit_exact": True, "max_abs_err": err, "ms": ms,
               "unaligned_ms": unaligned_ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / ms,
               "host_dispatch_ms": statistics.median(host), **ab}
        emit(row)
        rows_out.append(row)
    return rows_out


def phase_k2(seed: int, parent=None) -> dict:
    return {"kinds": k2_kinds(seed, parent), "segments": k2_segments(seed)}


# ---------------- phase 6: the warm main path ----------------

WARM_KEYS = ("stall_seconds", "bytes_to_device", "convert_seconds",
             "snapshot_write_seconds", "snapshot_read_seconds",
             "device_decode_seconds", "device_decode_bytes")


def _epoch_logger(it, phase: str, out: list):
    """A ``fit`` log_fn recording each epoch's deltas of ``WARM_KEYS``."""
    prev = {k: 0 for k in WARM_KEYS}

    def log(epoch, loss, nb, secs):
        now = it.stats()
        d = {k: now[k] - prev[k] for k in WARM_KEYS}
        prev.update({k: now[k] for k in WARM_KEYS})
        rec = {"phase": phase, "epoch": epoch, "loss": loss, "batches": nb,
               "warm": d["device_decode_bytes"] > 0, "wall_s": secs,
               "rows_per_s": nb * BATCH / secs,
               "stall_share": d["stall_seconds"] / secs,
               "decode_dispatch_ms_per_batch": d["device_decode_seconds"] / nb * 1e3,
               **{k: d[k] for k in WARM_KEYS}}
        emit(rec)
        out.append(rec)
    return log


def _check_warm_epochs(epochs: list, first_cold: bool = True) -> int:
    """Epoch 1 cold, the rest warm with a convert delta of exactly 0.
    Returns the warm batches."""
    for e in epochs:
        if not np.isfinite(e["loss"]):
            raise AssertionError(f"{e['phase']}: non-finite loss {e['loss']}")
        if e["warm"] != (e["epoch"] > 0 or not first_cold):
            raise AssertionError(f"{e['phase']} epoch {e['epoch']}: warm={e['warm']}")
        if e["warm"] and e["convert_seconds"] != 0.0:
            raise AssertionError(f"{e['phase']} epoch {e['epoch']}: a warm epoch "
                                 f"converted for {e['convert_seconds']} s")
    return sum(e["batches"] for e in epochs if e["warm"])


def run_warm_ell(path: str, snap: str, device) -> dict:
    """The warm main path: create_parser(snapshot=) -> DeviceIter(ell,
    device_decode=True) -> fit(3) -> accuracy, with both kernels' counts
    zeroed just before and read just after."""
    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser
    from dmlc_tpu_torch.ops import device_decode as dd
    from dmlc_tpu_torch.ops import ell_matvec as k1

    model = LinearLearner(num_col=HIGGS_COLS, layout="ell", learning_rate=0.3,
                          device=device)
    it = DeviceIter(create_parser(path, 0, 1, "libsvm", snapshot=snap),
                    num_col=model.device_num_col(), batch_size=BATCH, layout="ell",
                    max_nnz=HIGGS_COLS, drop_remainder=True, device=device,
                    device_decode=True)
    epochs: list = []
    k1.launches = k1.dw_launches = dd.launches = 0
    model.fit(it, epochs=3, log_fn=_epoch_logger(it, "warm_ell", epochs))
    dw_launches = k1.dw_launches
    before = it.stats()
    t0 = time.monotonic()
    acc = model.accuracy(it)
    acc_s = time.monotonic() - t0
    k1_launches, k2_launches = k1.launches, dd.launches
    after = it.stats()
    it.close()
    acc_warm = after["device_decode_bytes"] > before["device_decode_bytes"]
    warm_batches = _check_warm_epochs(epochs) + (HIGGS_ROWS // BATCH if acc_warm else 0)
    out = {"phase": "warm_ell", "accuracy": acc, "accuracy_s": acc_s,
           "accuracy_warm": acc_warm,
           "accuracy_convert_seconds": after["convert_seconds"] - before["convert_seconds"],
           "k2_launches": k2_launches, "k2_launches_needed": warm_batches,
           "k1_launches": k1_launches,
           "k1_launches_needed": sum(e["batches"] for e in epochs) + HIGGS_ROWS // BATCH,
           "dw_launches": dw_launches,
           "dw_launches_needed": sum(e["batches"] for e in epochs),
           "snapshot_bytes": os.path.getsize(snap)}
    emit(out)
    if not acc_warm or out["accuracy_convert_seconds"] != 0.0:
        raise AssertionError(f"the accuracy pass was not a warm device-decode pass: {out}")
    if k2_launches != warm_batches:
        raise AssertionError(f"K2 launched {k2_launches} times for {warm_batches} warm batches "
                             f"(one a batch)")
    if dw_launches < out["dw_launches_needed"]:
        raise AssertionError(f"the dw kernel launched {dw_launches} times for "
                             f"{out['dw_launches_needed']} warm ELL steps")
    if k1_launches < out["k1_launches_needed"]:
        raise AssertionError(f"K1 launched {k1_launches} times, "
                             f"the path needs {out['k1_launches_needed']}")
    if not acc > 0.9:
        raise AssertionError(f"warm ELL accuracy {acc} <= 0.9")
    return {**out, "epochs": epochs}


WARM_DENSE = {  # phase name: DeviceIter's packed dense options
    "warm_dense_float32": {"x_dtype": "float32"},
    "warm_dense_bfloat16": {"x_dtype": "bfloat16"},
    "warm_dense_q8": {"x_dtype": "float32", "snapshot_quant": "int8"},
}


def run_warm_dense(path: str, snap: str, device, phase: str) -> dict:
    """A cold and a warm device-decode epoch of packed dense batches, with
    K2's count zeroed just before and read just after."""
    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser
    from dmlc_tpu_torch.ops import device_decode as dd

    model = LinearLearner(HIGGS_COLS, layout="dense", learning_rate=0.3, device=device)
    it = DeviceIter(create_parser(path, 0, 1, "libsvm", snapshot=snap),
                    num_col=model.device_num_col(), batch_size=BATCH, layout="dense",
                    drop_remainder=True, device=device, pack_aux=True, device_decode=True,
                    **WARM_DENSE[phase])
    epochs: list = []
    dd.launches = 0
    model.fit(it, epochs=2, log_fn=_epoch_logger(it, phase, epochs))
    k2_launches = dd.launches
    it.close()
    warm_batches = _check_warm_epochs(epochs)
    out = {"phase": phase, "k2_launches": k2_launches,
           "k2_launches_needed": warm_batches, "snapshot_bytes": os.path.getsize(snap)}
    emit(out)
    if k2_launches != warm_batches:
        raise AssertionError(f"{phase}: K2 launched {k2_launches} times for "
                             f"{warm_batches} warm batches (one a batch)")
    if not epochs[-1]["loss"] < np.log(2):
        raise AssertionError(f"{phase}: warm epoch loss {epochs[-1]['loss']}")
    return {**out, "epochs": epochs}


def compare_warm_routes(path: str, snap: str, device, n: int = 8, **kw) -> dict:
    """The first ``n`` warm batches through device decode (K2) against the
    same batches through the host-decode warm path, byte for byte (a packed
    batch's slab and its ``x``, ``y`` and ``w``)."""
    from dmlc_tpu_torch import DeviceIter, create_parser

    iters = [DeviceIter(create_parser(path, 0, 1, "libsvm", snapshot=snap),
                        batch_size=BATCH, drop_remainder=True, device=device,
                        device_decode=dec, **kw) for dec in (True, False)]
    pairs = list(zip(range(n), *iters))
    states = [it.stats()["snapshot_state"] for it in iters]
    for it in iters:
        it.close()
    if states != ["warm", "warm"] or len(pairs) != n:
        raise AssertionError(f"warm route comparison ran {len(pairs)} batches, states {states}")
    for i, a, b in pairs:
        ta, tb = batch_tensors(a), batch_tensors(b)
        if len(ta) != len(tb) or not all(same_bits(x, y) for x, y in zip(ta, tb)):
            raise AssertionError(f"warm batch {i}: device decode differs from host decode")
    return {"phase": "warm_routes", "layout": kw.get("layout"),
            "x_dtype": kw.get("x_dtype", "float32"),
            "snapshot_quant": kw.get("snapshot_quant"), "batches_equal": n}


def profile_decodes(snaps: dict, device, num_col: int, attempts: int = 3) -> dict:
    """One warm batch's decode from each snapshot in ``snaps`` (``{name:
    path}``; the spans already on the card), in one ``torch.profiler``
    window, with ``x, y, w`` taken from each batch: between sentinel fills,
    exactly one kernel must run for each batch, K2's (no cast, multiply or
    widening kernel). The window starts with a pause, since kernels
    launched right after the profiler starts can go unrecorded; a window
    whose trace lacks a sentinel is taken again, at most ``attempts``
    times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dmlc_tpu_torch.io.snapshot import SnapshotReader
    from dmlc_tpu_torch.ops import device_decode as dd

    batches = {}
    for name, snap in snaps.items():
        reader = SnapshotReader(snap)
        kind, raw, layout = reader.batch_span(0)
        batches[name] = (torch.from_numpy(np.array(raw)).to(device), layout, kind)
        reader.close()
        tuple(dd.decode_batch(*batches[name], num_col))
    sentinel = torch.empty(1, device=device)
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.5)
            for batch in batches.values():
                sentinel.fill_(1.0)
                x, y, w = dd.decode_batch(*batch, num_col)
            sentinel.fill_(2.0)
            torch.cuda.synchronize()
        names = [e.name for e in sorted(prof.events(), key=lambda e: e.time_range.start)
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if sum("FillFunctor" in n for n in names) == len(batches) + 1:
            break
    else:
        raise AssertionError(f"the profiler recorded the sentinels in none of {attempts} windows")
    # the kernels between each pair of sentinels: one batch's decode
    runs, run = [], None
    for n in names:
        if "FillFunctor" in n:
            if run is not None:
                runs.append(run)
            run = []
        elif run is not None:
            run.append(n)
    out = {"phase": "decode_profile", "kernels": dict(zip(batches, runs))}
    if not all(len(r) == 1 and "decode_span" in r[0] for r in runs):
        raise AssertionError(f"a warm batch's decode ran other kernels than K2's: {out}")
    return out


SCATTER_KERNELS = ("indexFunc", "index_add", "scatter")


def check_no_scatter(step: dict) -> None:
    """No scatter-add kernel among a step's top kernels: dw is the hand
    kernel's (``index_add_`` shows as ``indexFuncLargeIndex``)."""
    names = [name for name, _ in step["top_kernels_ms_per_step"]]
    found = [n for n in names if any(s in n for s in SCATTER_KERNELS)]
    if found:
        raise AssertionError(f"{step['phase']}: scatter kernels in the step: {found}")


def run_healing(tmp: str, device, seed: int, rows: int = 8 * BATCH) -> dict:
    """A corrupt warm batch heals mid-epoch: a small HIGGS-shaped snapshot
    (8 batches) written by a cold device-decode ELL epoch, one byte flipped
    in batch 3's span, then a warm device-decode epoch that must equal the
    cold one byte for byte with one pipeline restart."""
    import torch

    from dmlc_tpu_torch import DeviceIter, create_parser
    from dmlc_tpu_torch.io.snapshot import SnapshotReader

    path = os.path.join(tmp, "healing.libsvm")
    snap = os.path.join(tmp, "healing.snapshot")
    write_higgs_corpus(path, rows, seed + 1)

    def epoch(it):
        return [[t.cpu().view(torch.uint8) for t in batch] for batch in it]

    it = DeviceIter(create_parser(path, 0, 1, "libsvm", snapshot=snap),
                    num_col=HIGGS_COLS, batch_size=BATCH, layout="ell",
                    max_nnz=HIGGS_COLS, drop_remainder=True, device=device,
                    device_decode=True)
    cold = epoch(it)
    it.reset()
    reader = SnapshotReader(snap)
    pos = reader._batches[3]["pos"] + 100
    reader.close()
    with open(snap, "r+b") as f:
        f.seek(pos)
        byte = f.read(1)
        f.seek(pos)
        f.write(bytes([byte[0] ^ 0x01]))
    healed = epoch(it)
    stats = it.stats()
    it.close()
    equal = len(healed) == len(cold) and all(
        len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
        for a, b in zip(healed, cold))
    out = {"phase": "healing", "batches": len(healed),
           "pipeline_restarts": stats["resilience"]["pipeline_restarts"],
           "snapshot_removed": not os.path.exists(snap), "bytes_equal_cold": equal}
    if not (equal and out["pipeline_restarts"] == 1 and out["snapshot_removed"]
            and len(cold) == rows // BATCH):
        raise AssertionError(f"a corrupt warm batch did not heal: {out}")
    return out


# ---------------- phase 7: checkpoint and resume ----------------

CKPT_AT = 37  # batches before the checkpoint


def _ell_pipeline(path: str, device, snapshot=None):
    """(parser, learner, DeviceIter) of the ELL main path, fresh; with a
    ``snapshot`` the warm device-decode feed."""
    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser

    parser = create_parser(path, 0, 1, "libsvm", snapshot=snapshot)
    model = LinearLearner(HIGGS_COLS, layout="ell", learning_rate=0.3, device=device)
    it = DeviceIter(parser, num_col=model.device_num_col(), batch_size=BATCH, layout="ell",
                    max_nnz=HIGGS_COLS, drop_remainder=True, device=device,
                    device_decode=snapshot is not None)
    return parser, model, it


def _checkpoint(path: str, device, snapshot=None):
    """Step the first ``CKPT_AT`` batches from a fresh learner and close:
    the DeviceIter state through ``json`` and the parameters through
    numpy, as a job would write them."""
    from dmlc_tpu_torch.convert import linear_params_to_jax

    _, model, it = _ell_pipeline(path, device, snapshot)
    for _, batch in zip(range(CKPT_AT), it):
        model.step(batch)
    state = json.loads(json.dumps(it.state_dict()))
    params = linear_params_to_jax(model.params)
    it.close()
    return state, params


def _resume(path: str, device, state, params, snapshot=None, want=None) -> dict:
    """A fresh parser, DeviceIter and learner: the parameters set, the
    state loaded, the epoch finished. With ``want`` (the uninterrupted
    epoch's batches from ``CKPT_AT`` on) each batch is held against it, bit
    for bit."""
    import torch

    from dmlc_tpu_torch.convert import linear_params_from_jax
    from dmlc_tpu_torch.ops import device_decode as dd

    parser, model, it = _ell_pipeline(path, device, snapshot)
    model.set_params(linear_params_from_jax(*params, device=device))
    torch.cuda.synchronize()
    k2_before = dd.launches
    t0 = time.monotonic()
    it.load_state(state)
    t1 = time.monotonic()
    n, first_s, equal = 0, None, want is not None
    for batch in it:
        if first_s is None:
            first_s = time.monotonic() - t1
        model.step(batch)
        if want is not None:
            equal = equal and n < len(want) and all(
                same_bits(a, b) for a, b in zip(batch, want[n]))
        n += 1
    torch.cuda.synchronize()
    t2 = time.monotonic()
    out = {"batches_after_restore": n, "load_state_s": t1 - t0, "first_batch_s": first_s,
           "restored_rows_per_s": n * BATCH / (t2 - t1), "parser_bytes_read": parser.bytes_read,
           "snapshot_state": it.stats()["snapshot_state"], "k2_launches": dd.launches - k2_before,
           "weight": model.params.weight.detach().clone(),
           "bias": model.params.bias.detach().clone()}
    if want is not None:
        out["batches_equal"] = equal and n == len(want)
    it.close()
    return out


def run_checkpoint(path: str, snap: str, device, corpus_bytes: int) -> dict:
    """Cold ELL: an uninterrupted epoch, then the same epoch checkpointed
    after ``CKPT_AT`` batches, closed, and resumed in a fresh pipeline
    (a seek); the final weight and bias must be ``torch.equal``. Warm
    device decode on phase 6's snapshot: a warm checkpoint and the cold
    one, each resumed into a fresh warm pipeline; the remaining batches
    bit-equal to the uninterrupted warm epoch's, one K2 launch each, and
    the final weights ``torch.equal`` to it (and to the cold epoch's: the
    same batches)."""
    import torch

    _, model, it = _ell_pipeline(path, device)
    t0 = time.monotonic()
    batches = 0
    for batch in it:
        model.step(batch)
        batches += 1
    torch.cuda.synchronize()
    cold_s = time.monotonic() - t0
    it.close()
    ref_w, ref_b = model.params.weight.detach().clone(), model.params.bias.detach().clone()

    cold_state, cold_params = _checkpoint(path, device)
    cold = _resume(path, device, cold_state, cold_params)
    cold_out = {k: v for k, v in cold.items() if k not in ("weight", "bias")}
    cold_out.update(
        state_kind=cold_state["kind"], state_batches=cold_state["batches"],
        uninterrupted_epoch_s=cold_s, uninterrupted_rows_per_s=batches * BATCH / cold_s,
        bytes_read_share=cold["parser_bytes_read"] / corpus_bytes,
        weights_equal=bool(torch.equal(cold["weight"], ref_w)
                           and torch.equal(cold["bias"], ref_b)))
    emit({"phase": "checkpoint_cold_ell", **cold_out})

    # the uninterrupted warm epoch, its batches kept on the card
    _, model, it = _ell_pipeline(path, device, snap)
    want = []
    for i, batch in enumerate(it):
        model.step(batch)
        if i >= CKPT_AT:
            want.append([t.clone() for t in batch])
    warm_state_ok = it.stats()["snapshot_state"] == "warm"
    it.close()
    warm_w, warm_b = model.params.weight.detach().clone(), model.params.bias.detach().clone()
    warm_state, warm_params = _checkpoint(path, device, snap)
    warm_out = []
    for name, state, params in (("warm_to_warm", warm_state, warm_params),
                                ("cold_to_warm", cold_state, cold_params)):
        r = _resume(path, device, state, params, snap, want)
        rec = {k: v for k, v in r.items() if k not in ("weight", "bias")}
        rec.update(phase="checkpoint_warm_ell", restore=name, state_kind=state["kind"],
                   weights_equal=bool(torch.equal(r["weight"], warm_w)
                                      and torch.equal(r["bias"], warm_b)))
        emit(rec)
        warm_out.append(rec)
    cold_equals_warm = bool(torch.equal(ref_w, warm_w) and torch.equal(ref_b, warm_b))
    out = {"cold": cold_out, "warm": warm_out, "warm_epoch_served_warm": warm_state_ok,
           "cold_epoch_equals_warm_epoch": cold_equals_warm,
           "k2_launches": sum(r["k2_launches"] for r in warm_out)}
    rest = HIGGS_ROWS // BATCH - CKPT_AT
    problems = []
    if not (cold_out["weights_equal"] and cold_out["batches_after_restore"] == rest):
        problems.append("the cold ELL restore did not finish the epoch to the same weights")
    if cold_state["kind"] != "source" or not cold_out["bytes_read_share"] < 0.8:
        problems.append("the cold ELL restore did not seek")
    for r in warm_out:
        if not (r["weights_equal"] and r["batches_equal"] and r["k2_launches"] == rest
                and r["snapshot_state"] == "warm"):
            problems.append(f"the {r['restore']} restore differs")
    if not (warm_state_ok and cold_equals_warm):
        problems.append("the warm epoch was not warm, or trained other weights than the cold")
    if problems:
        raise AssertionError(f"checkpoint: {problems}: {out}")
    return out


# ---------------- phase 8: the bcoo layout ----------------

def _bcoo_pipeline(path: str, device, natural: bool = False):
    """(learner, DeviceIter) of the bcoo path, fresh; ``natural`` ships the
    parsed blocks as they come (``batch_size=None``)."""
    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser

    model = LinearLearner(HIGGS_COLS, layout="bcoo", learning_rate=0.3, device=device)
    it = DeviceIter(create_parser(path, 0, 1, "libsvm"), num_col=model.device_num_col(),
                    batch_size=None if natural else BATCH, layout="bcoo",
                    max_nnz=HIGGS_COLS, device=device)
    return model, it


def enqueue_behind_spin(step, calls: int = 20, spin_cycles: int = 1_000_000_000) -> dict:
    """Whether ``step`` waits for the device: ``calls`` calls enqueued
    behind a device-side spin of about half a second. A call that
    synchronises the host (also inside a library, where CUDA's sync debug
    mode cannot see it) waits for the spin, so its enqueue time is then at
    least the spin's; without one the host is done long before, and the
    stream is still busy."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(spin_cycles)
    end.record()
    torch.cuda.synchronize()
    spin_s = start.elapsed_time(end) / 1e3
    torch.cuda._sleep(spin_cycles)
    t0 = time.monotonic()
    for _ in range(calls):
        step()
    host_s = time.monotonic() - t0
    busy = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    return {"calls": calls, "host_s": host_s, "spin_s": spin_s, "stream_busy_after": busy,
            "no_host_sync": busy and host_s < 0.5 * spin_s}


def run_bcoo(path: str, device, steps: int = 20) -> dict:
    """DeviceIter(bcoo) -> LinearLearner(bcoo): the first ``steps`` steps
    on the card under CUDA's sync debug mode "error" and against the same
    batches on the CPU, the first batch's dense form against the CPU
    route's; then a fresh epoch and an accuracy pass (rows/s, stall
    share, the nnz shapes crossed), the step's device time on a resident
    batch beside the ELL step's on the same rows, both steps enqueued
    behind a device spin (:func:`enqueue_behind_spin`: no host sync, also
    none the debug mode cannot see), and one epoch of natural blocks
    (``batch_size=None``)."""
    import torch

    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser

    model, it = _bcoo_pipeline(path, device)
    batches = [b for _, b in zip(range(steps), it)]
    it.close()
    torch.cuda.synchronize()
    time.sleep(0.5)  # the producer idle: only the steps run in the window
    torch.cuda.set_sync_debug_mode("error")
    try:
        card = [model.step(b) for b in batches]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    cpu_model = LinearLearner(HIGGS_COLS, layout="bcoo", learning_rate=0.3, device="cpu")
    pairs = [(float(c), float(cpu_model.step(tuple(t.cpu() for t in b))))
             for c, b in zip(card, batches)]
    rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in pairs)
    cpu_it = DeviceIter(create_parser(path, 0, 1, "libsvm"), num_col=HIGGS_COLS,
                        batch_size=BATCH, layout="bcoo", max_nnz=HIGGS_COLS, device="cpu")
    cpu_first = next(cpu_it)
    cpu_it.close()
    x0, y0, w0 = batches[0]
    dense_equal = bool(torch.equal(x0.to_dense().cpu(), cpu_first[0].to_dense())
                       and torch.equal(y0.cpu(), cpu_first[1])
                       and torch.equal(w0.cpu(), cpu_first[2]))
    del batches, card

    model, it = _bcoo_pipeline(path, device)
    t0 = time.monotonic()
    loss, nb = model.fit_epoch(it)
    epoch_s = time.monotonic() - t0
    stall = it.stall_seconds
    acc = model.accuracy(it)
    shapes = sorted(it.nnz_shapes)
    # the step's device time on a resident batch, bcoo and ELL, same rows
    bcoo_batch = next(it)
    it.close()
    _, ell_model, ell_it = _ell_pipeline(path, device)
    ell_batch = next(ell_it)
    ell_it.close()
    for m, b in ((model, bcoo_batch), (ell_model, ell_batch)):
        m.step(b)
    torch.cuda.synchronize()
    bcoo_ms = device_ms(lambda: model.step(bcoo_batch), iters=10)
    ell_ms = device_ms(lambda: ell_model.step(ell_batch), iters=10)
    bcoo_spin = enqueue_behind_spin(lambda: model.step(bcoo_batch))
    ell_spin = enqueue_behind_spin(lambda: ell_model.step(ell_batch))
    nat_model, nat_it = _bcoo_pipeline(path, device, natural=True)
    t0 = time.monotonic()
    nat_loss, nat_nb = nat_model.fit_epoch(nat_it)
    nat_s = time.monotonic() - t0
    nat_it.close()
    out = {"phase": "bcoo", "first_steps": len(pairs), "max_rel_diff": rel,
           "steps_under_sync_error": len(pairs), "first_batch_dense_equal_cpu": dense_equal,
           "loss": loss, "batches": nb, "wall_s": epoch_s, "rows_per_s": nb * BATCH / epoch_s,
           "stall_s": stall, "stall_share": stall / epoch_s, "accuracy": acc,
           "nnz_shapes": shapes, "step_device_ms": bcoo_ms, "ell_step_device_ms": ell_ms,
           "step_enqueue_behind_spin": bcoo_spin, "ell_step_enqueue_behind_spin": ell_spin,
           "natural_loss": nat_loss, "natural_batches": nat_nb, "natural_wall_s": nat_s,
           "natural_rows_per_s": HIGGS_ROWS / nat_s}
    emit(out)
    if not (len(pairs) == steps and rel <= 1e-4 and dense_equal):
        raise AssertionError(f"bcoo: the first {steps} steps or batch differ from the CPU: {pairs}")
    if not (bcoo_spin["no_host_sync"] and ell_spin["no_host_sync"]):
        raise AssertionError(f"a step waited for the device: bcoo {bcoo_spin}, ELL {ell_spin}")
    if not (acc > 0.9 and np.isfinite(loss) and len(shapes) == 1 and np.isfinite(nat_loss)
            and nat_nb > 0):
        raise AssertionError(f"bcoo epoch failed its checks: {out}")
    return out


def bcoo_step_profile(path: str, device, steps: int = 10) -> dict:
    """Where a bcoo step's device time goes: ``steps`` steps on one
    resident batch under ``torch.profiler``, device time by kernel a step.
    A measurement, not a check: an empty trace is reported as such."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    model, it = _bcoo_pipeline(path, device)
    batch = next(it)
    it.close()
    model.step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.5)
        for _ in range(steps):
            model.step(batch)
        torch.cuda.synchronize()
    per_kernel: dict = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[evt.name] = (per_kernel.get(evt.name, 0.0)
                                    + evt.time_range.elapsed_us() / steps / 1e3)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {"phase": "bcoo_step_profile", "steps": steps,
            "device_ms_per_step": sum(per_kernel.values()),
            "top_kernels_ms_per_step": [[name[:80], ms] for name, ms in top]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", default=None,
                    help="a checkout of the parent commit: phases 2 and 5 also time its "
                         "K1 and its K2 route beside this one's, in turns")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dmlc_tpu_torch.ops import device_decode as dd
    from dmlc_tpu_torch.ops import ell_matvec as k1

    t_start = time.monotonic()
    torch.backends.cuda.matmul.allow_tf32 = False  # the dense margin in full fp32
    dev = torch.device("cuda", torch.cuda.current_device())
    smi = smi_line()

    # phase 1
    env = build_all()
    env.update(phase="environment", gpu=smi, torch=torch.__version__,
               cuda=torch.version.cuda, device_name=torch.cuda.get_device_name(0))
    emit(env)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # phases 2 and 5 (these launches are comparisons, not the main path's)
        parent = load_parent_libs(args.parent, tmp) if args.parent else {}
        k1_rows = phase_k1(args.seed, parent.get("ell_matvec"))
        k2_rows = phase_k2(args.seed, parent.get("widen_span"))

        path = os.path.join(tmp, "higgs_shaped.libsvm")
        t0 = time.monotonic()
        corpus = write_higgs_corpus(path, HIGGS_ROWS, args.seed)
        emit({"phase": "corpus", **corpus, "write_s": time.monotonic() - t0,
              "reduced": "HIGGS (UCI 280) 11,000,000 rows cut to 1,048,576 "
                         "for the time limit; 28 features as published"})

        # phase 3: the counts are zeroed just before the main path
        k1.launches = k1.dw_launches = 0
        main_path = run_main_path(path, dev)
        launches, dw_launches = k1.launches, k1.dw_launches
        need = main_path["steps"] + main_path["accuracy_batches"]
        emit({"phase": "main_path", "accuracy": main_path["accuracy"],
              "fit_s": main_path["fit_s"], "accuracy_s": main_path["accuracy_s"],
              "parse_engine": main_path["engine"], "k1_launches": launches,
              "k1_launches_needed": need, "dw_launches": dw_launches,
              "dw_launches_needed": main_path["steps"]})
        if launches < need:
            raise AssertionError(f"K1 launched {launches} times, main path needs {need}")
        if dw_launches < main_path["steps"]:
            raise AssertionError(f"the dw kernel launched {dw_launches} times for "
                                 f"{main_path['steps']} steps")
        if not main_path["accuracy"] > 0.9:
            raise AssertionError(f"accuracy {main_path['accuracy']} <= 0.9")
        if not all(np.isfinite(e["loss"]) for e in main_path["epochs"]):
            raise AssertionError("non-finite epoch loss")

        first = compare_first_losses(path, dev)
        again_losses, again_weight = card_trajectory(path, dev)
        repeatable = (torch.equal(first["card_losses"], again_losses)
                      and torch.equal(first["card_weight"], again_weight))
        emit({"phase": "first_losses_vs_cpu", "steps": first["steps"],
              "max_rel_diff": first["max_rel_diff"], "card_bit_identical_twice": repeatable})
        if first["steps"] != 20 or not first["max_rel_diff"] <= 1e-4:
            raise AssertionError(f"first 20 losses differ from the CPU route: {first['losses']}")
        if not repeatable:
            raise AssertionError("two 20-step runs on the card differ")

        # phase 4
        dense = run_dense_epoch(path, dev)
        emit(dense)
        if not (np.isfinite(dense["loss"]) and dense["loss"] < np.log(2)):
            raise AssertionError(f"dense epoch loss {dense['loss']}")

        # phase 6: the warm paths, each with its counts zeroed just before
        ell_snap = os.path.join(tmp, "ell.snapshot")
        warm_ell = run_warm_ell(path, ell_snap, dev)
        emit(compare_warm_routes(path, ell_snap, dev, num_col=HIGGS_COLS,
                                 layout="ell", max_nnz=HIGGS_COLS))
        emit(run_healing(tmp, dev, args.seed))
        warm_dense, snaps = [], {}
        for phase, opts in WARM_DENSE.items():
            snaps[phase] = os.path.join(tmp, f"{phase}.snapshot")
            warm_dense.append(run_warm_dense(path, snaps[phase], dev, phase))
            emit(compare_warm_routes(path, snaps[phase], dev, num_col=HIGGS_COLS + 1,
                                     layout="dense", pack_aux=True, **opts))
        # phase 7, its launches counted from 0
        k1.launches = k1.dw_launches = dd.launches = 0
        run_checkpoint(path, ell_snap, dev, corpus["bytes"])
        ckpt_k1, ckpt_dw, ckpt_k2 = k1.launches, k1.dw_launches, dd.launches
        # phase 8
        run_bcoo(path, dev)
        # the profiler's windows: the decode's first (a window opened after
        # others has recorded nothing now and then), then the steps'
        emit(profile_decodes({p: snaps[p] for p in ("warm_dense_bfloat16", "warm_dense_q8")},
                             dev, HIGGS_COLS + 1))
        step = step_times(path, dev)
        check_no_scatter(step)
        step["device_busy_share_est"] = (
            step["step_device_ms"] * main_path["steps"] / 1e3 / main_path["fit_s"])
        emit(step)
        warm_step = step_times(path, dev, snapshot=ell_snap)
        warm_epoch = warm_ell["epochs"][-1]
        warm_step["device_busy_share_est"] = (
            warm_step["step_device_ms"] * warm_epoch["batches"] / 1e3 / warm_epoch["wall_s"])
        emit(warm_step)
        check_no_scatter(warm_step)
        emit(bcoo_step_profile(path, dev))

    emit({"phase": "total", "wall_s": time.monotonic() - t_start})
    k1_main = k1_rows[0]
    k2_main = next(r for r in k2_rows["kinds"] if r["kind"] == K2_MAIN)
    emit({"kernels": [{
        "name": "ell_matvec", "route": "cuda",
        "source": "dmlc_tpu_torch/csrc/ell_matvec.cu",
        "replaces": "dmlc_tpu/ops/pallas_sparse.py:122",
        "launches": launches + warm_ell["k1_launches"] + ckpt_k1,
        "max_abs_err": max(r["max_abs_err"] for r in k1_rows),
        "ms": k1_main["ms"], "plain_ms": k1_main["plain_ms"],
        "bound_ms": k1_main["bound_ms"], "bound_by": k1_main["bound_by"],
        "library_ms": k1_main["library_ms"]}, {
        "name": "ell_matvec_dw", "route": "cuda",
        "source": "dmlc_tpu_torch/csrc/ell_matvec_dw.cu",
        "replaces": "dmlc_tpu/ops/pallas_sparse.py:191",
        "launches": dw_launches + warm_ell["dw_launches"] + ckpt_dw,
        "max_abs_err": max(r["dw_kernel_max_abs_err"] for r in k1_rows
                           if r["dw_route"] == "cuda"),
        "ms": k1_main["dw_ms"], "plain_ms": k1_main["dw_plain_ms"],
        "bound_ms": k1_main["dw_bound_ms"], "bound_by": k1_main["dw_bound_by"],
        "library_ms": k1_main["dw_library_ms"]}, {
        "name": "widen_span", "route": "cuda",
        "source": "dmlc_tpu_torch/csrc/widen_span.cu",
        "replaces": "dmlc_tpu/ops/device_decode.py:168",
        "launches": (warm_ell["k2_launches"] + sum(d["k2_launches"] for d in warm_dense)
                     + ckpt_k2),
        "max_abs_err": max(r["max_abs_err"] for r in k2_rows["kinds"] + k2_rows["segments"]),
        "ms": k2_main["ms"], "plain_ms": k2_main["plain_ms"],
        "bound_ms": k2_main["bound_ms"], "bound_by": k2_main["bound_by"],
        "library_ms": k2_main["library_ms"]}]})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
