#!/usr/bin/env python3
"""Drive the PyTorch port (``dmlc_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

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
   in turns with this one;
3. the main path at full width: a HIGGS-shaped libsvm corpus (28 dense
   features; UCI dataset 280, 11,000,000 rows, cut to 2**20 rows for the
   time limit) -> create_parser -> DeviceIter(ell) -> LinearLearner ->
   fit(2 epochs) -> accuracy, with the K1 and ``dw`` launch counts of that
   run, the first 20 step losses held against the same batches on the CPU,
   and those 20 steps run twice on the card, bit-identical; the step's
   kernels hold no scatter-add;
4. one epoch of the dense layout on the same corpus;
5. kernel K2 (``csrc/widen_span.cu``) against its plain PyTorch version,
   bit for bit, at the shapes the warm epochs give it (HIGGS packed dense
   8192x30 and the dense path's 8192x31, f32 and bf16; ELL values 8192x28;
   a lane-aligned 8192x1024; an odd 1000x7 whose bytes are no multiple of
   16), each from a 64-byte-aligned and from an unaligned start, with its
   device time beside the plain version's, the one PyTorch call computing
   the same function (``seg.view(dtype).reshape(rows, cols).clone()``) and
   the bytes bound;
6. the warm main path: ``create_parser(snapshot=)`` -> ``DeviceIter(ell,
   device_decode=True)`` -> ``fit(3 epochs)`` -> ``accuracy``: epoch 1 is
   cold and writes the snapshot, epochs 2-3 and the accuracy pass decode
   each batch on the card through K2 (and step through K1), with per-epoch
   rows/s, stall share and the snapshot and decode counters, and a
   profiled window of steps fed by a warm device-decode epoch; then a cold
   plus a warm device-decode epoch of packed dense f32, and of packed dense
   bf16; the first 8 warm device-decode batches of each are held against
   the host-decode warm path's, byte for byte; and healing: a byte flipped
   in a warm batch of a small snapshot, the warm device-decode epoch equal
   to the cold one byte for byte after one pipeline restart.

Then a ``{"kernels": [...]}`` line, the card's name and power limit as
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
K2_MAIN = "ell_values"


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


def load_parent_k1(parent: str, out_dir: str):
    """The parent commit's K1, built from ``parent``'s
    ``dmlc_tpu_torch/csrc/ell_matvec.cu`` into a library of its own under
    ``out_dir``, for an A/B in one run: ``lib.dmlc_ell_matvec_f32(w, idx,
    val, out, B, K, W, stream)``, the C interface both commits share."""
    import ctypes

    from dmlc_tpu_torch.ops import _build

    src = os.path.join(parent, "dmlc_tpu_torch", "csrc", "ell_matvec.cu")
    lib_path = os.path.join(out_dir, "libk1_parent.so")
    subprocess.run([_build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib_path,
                    src], check=True, capture_output=True, timeout=600)
    lib = ctypes.CDLL(lib_path)
    lib.dmlc_ell_matvec_f32.restype = ctypes.c_int
    lib.dmlc_ell_matvec_f32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + [
        ctypes.c_void_p]
    return lib


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

def phase_k2(seed: int) -> list:
    """K2 on segments laid out as the snapshot spans lay them out (64 bytes
    into a u8 span) and from an unaligned start (1 byte in: the scalar
    loop), bit-exact against the plain version and the source values."""
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
    if k2_launches < warm_batches:
        raise AssertionError(f"K2 launched {k2_launches} times for {warm_batches} warm batches")
    if dw_launches < out["dw_launches_needed"]:
        raise AssertionError(f"the dw kernel launched {dw_launches} times for "
                             f"{out['dw_launches_needed']} warm ELL steps")
    if k1_launches < out["k1_launches_needed"]:
        raise AssertionError(f"K1 launched {k1_launches} times, "
                             f"the path needs {out['k1_launches_needed']}")
    if not acc > 0.9:
        raise AssertionError(f"warm ELL accuracy {acc} <= 0.9")
    return {**out, "epochs": epochs}


def run_warm_dense(path: str, snap: str, device, x_dtype: str) -> dict:
    """A cold and a warm device-decode epoch of packed dense batches."""
    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser
    from dmlc_tpu_torch.ops import device_decode as dd

    phase = f"warm_dense_{x_dtype}"
    model = LinearLearner(HIGGS_COLS, layout="dense", learning_rate=0.3, device=device)
    it = DeviceIter(create_parser(path, 0, 1, "libsvm", snapshot=snap),
                    num_col=model.device_num_col(), batch_size=BATCH, layout="dense",
                    drop_remainder=True, device=device, x_dtype=x_dtype,
                    pack_aux=True, device_decode=True)
    epochs: list = []
    dd.launches = 0
    model.fit(it, epochs=2, log_fn=_epoch_logger(it, phase, epochs))
    k2_launches = dd.launches
    it.close()
    warm_batches = _check_warm_epochs(epochs)
    out = {"phase": phase, "k2_launches": k2_launches,
           "k2_launches_needed": warm_batches, "snapshot_bytes": os.path.getsize(snap)}
    emit(out)
    if k2_launches < warm_batches:
        raise AssertionError(f"{phase}: K2 launched {k2_launches} times for "
                             f"{warm_batches} warm batches")
    if not epochs[-1]["loss"] < np.log(2):
        raise AssertionError(f"{phase}: warm epoch loss {epochs[-1]['loss']}")
    return {**out, "epochs": epochs}


def compare_warm_routes(path: str, snap: str, device, n: int = 8, **kw) -> dict:
    """The first ``n`` warm batches through device decode (K2) against the
    same batches through the host-decode warm path, byte for byte."""
    import torch

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
        ta = [a.packed] if hasattr(a, "packed") else list(a)
        tb = [b.packed] if hasattr(b, "packed") else list(b)
        for x, y in zip(ta, tb):
            if not (x.dtype == y.dtype and x.shape == y.shape
                    and torch.equal(x.view(torch.uint8), y.view(torch.uint8))):
                raise AssertionError(f"warm batch {i}: device decode differs from host decode")
    return {"phase": "warm_routes", "layout": kw.get("layout"),
            "x_dtype": kw.get("x_dtype", "float32"), "batches_equal": n}


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", default=None,
                    help="a checkout of the parent commit: phase 2 also times its K1 "
                         "beside this one's, in turns")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dmlc_tpu_torch.ops import ell_matvec as k1

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
        parent = load_parent_k1(args.parent, tmp) if args.parent else None
        k1_rows = phase_k1(args.seed, parent)
        k2_rows = phase_k2(args.seed)

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

        step = step_times(path, dev)
        check_no_scatter(step)
        step["device_busy_share_est"] = (
            step["step_device_ms"] * main_path["steps"] / 1e3 / main_path["fit_s"])
        emit(step)

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
        warm_step = step_times(path, dev, snapshot=ell_snap)
        warm_epoch = warm_ell["epochs"][-1]
        warm_step["device_busy_share_est"] = (
            warm_step["step_device_ms"] * warm_epoch["batches"] / 1e3 / warm_epoch["wall_s"])
        emit(warm_step)
        check_no_scatter(warm_step)
        emit(run_healing(tmp, dev, args.seed))
        warm_dense = []
        for x_dtype in ("float32", "bfloat16"):
            snap = os.path.join(tmp, f"dense_{x_dtype}.snapshot")
            warm_dense.append(run_warm_dense(path, snap, dev, x_dtype))
            emit(compare_warm_routes(path, snap, dev, num_col=HIGGS_COLS + 1,
                                     layout="dense", x_dtype=x_dtype, pack_aux=True))

    k1_main = k1_rows[0]
    k2_main = next(r for r in k2_rows if r["shape"] == K2_MAIN)
    emit({"kernels": [{
        "name": "ell_matvec", "route": "cuda",
        "source": "dmlc_tpu_torch/csrc/ell_matvec.cu",
        "replaces": "dmlc_tpu/ops/pallas_sparse.py:122",
        "launches": launches + warm_ell["k1_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in k1_rows),
        "ms": k1_main["ms"], "plain_ms": k1_main["plain_ms"],
        "bound_ms": k1_main["bound_ms"], "bound_by": k1_main["bound_by"],
        "library_ms": k1_main["library_ms"]}, {
        "name": "ell_matvec_dw", "route": "cuda",
        "source": "dmlc_tpu_torch/csrc/ell_matvec_dw.cu",
        "replaces": "dmlc_tpu/ops/pallas_sparse.py:191",
        "launches": dw_launches + warm_ell["dw_launches"],
        "max_abs_err": max(r["dw_kernel_max_abs_err"] for r in k1_rows
                           if r["dw_route"] == "cuda"),
        "ms": k1_main["dw_ms"], "plain_ms": k1_main["dw_plain_ms"],
        "bound_ms": k1_main["dw_bound_ms"], "bound_by": k1_main["dw_bound_by"],
        "library_ms": k1_main["dw_library_ms"]}, {
        "name": "widen_span", "route": "cuda",
        "source": "dmlc_tpu_torch/csrc/widen_span.cu",
        "replaces": "dmlc_tpu/ops/device_decode.py:168",
        "launches": warm_ell["k2_launches"] + sum(d["k2_launches"] for d in warm_dense),
        "max_abs_err": max(r["max_abs_err"] for r in k2_rows),
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
