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
   the first 20 steps run twice and bit-identical (the gradient's row
   scatter has no atomics), and one epoch of natural blocks
   (``batch_size=None``) with a finite loss;
9. ALS at ``examples/train_als.py``'s full size (4096 users, 512 items, 16
   factors, 32 ratings a row, batch 512, reg 0.05): create_parser ->
   DeviceIter(ell) -> AlsLearner -> fit(4 epochs) -> eval_loss, the epoch
   losses finite and falling, the row scatter (``csrc/row_scatter.cu``)
   launched for each step's gram and rhs (one buffer); 20 card steps and
   ``finalize_items`` run twice, bit-identical, and within 1e-4 relative
   of the same steps on the CPU; a checkpoint at batch 2 of epoch 2
   resumed in fresh objects, the loss tail byte for byte; 20 steps
   enqueued behind device spins (two groups of 10, inside the card's
   launch queue); the step's device time and host wall.
   Then the A/B of the routes for a row scatter (``index_add_``,
   ``index_put_(accumulate=True)``, the kernel) at the ALS shapes, a
   larger ALS shape, a 1-D table above ``DW_MAX_TABLE`` and phase 10's
   shapes: bits over two runs, device time, enqueue behind a spin, the
   kernel within 1e-4 + 1e-5 of each word's absolute sum of its plain
   version;
10. FM on phase 3's corpus (8 factors, Adam 0.05, batch 8192): 2 epochs on
   ell and dense, 1 on bcoo, accuracy above 0.9, the row scatter's
   launches counted; 20 card steps run twice and bit-identical and within
   1e-4 relative of the CPU; 20 steps enqueued behind device spins (four
   groups of 5); the step's device time beside the linear ELL step's.
11. data parallelism through ``dmlc_tpu_torch.parallel``: (a) in a child
   process, a process group of one NCCL rank (``init_process_group`` is
   called here, as ``init_from_env`` skips a one-worker job) ->
   ``make_mesh()`` -> the ELL main path with ``mesh=``: one epoch and an
   accuracy pass (above 0.9; K1 launched once a margin, ``dw`` once a
   step), the first 20 steps bit-equal to the non-mesh learner's on the
   same batches, 20 mesh steps enqueued behind device spins (groups of
   10), the mesh step's device time beside the plain step's; (b) two NCCL
   ranks tried on the one card with a 60 s timeout (the refusal or the
   hang recorded), then two gloo ranks on it
   (``init_from_env(backend="gloo")``), twice: 20 ELL ``LinearLearner`` and
   ``FMLearner`` steps at 8192 rows a rank and one ALS epoch at phase 9's
   size with the item solve, against the card's one-process run on the
   same global batches (losses and parameters within 1e-5, items within
   rtol 1e-4 / atol 1e-5), the parameters bit-identical across the ranks
   and the two runs, and ``sync_min`` capping an epoch over uneven
   shards. gloo stages CUDA collectives through the host, so its rows/s
   is a gloo-on-one-card figure, and the spin check is (a)'s; (c) the
   port's dry run ``dmlc_tpu_torch.entry.dryrun_multichip(2)`` on the card,
   its default (gloo, as the two ranks share one card): the one-step legs
   and a 20-step trajectory within 1e-4 of the one-process run, falling.
12. the block cache and the epoch planner: (a) ``examples/train_als.py``'s
   local leg at its full size through the port's example
   (``dmlc_tpu_torch.examples.train_als``): its ``main()`` as a user runs
   it (the row scatter launched once a step, its restore line and
   ``OK``), then its pieces: epoch 0 cold and publishing the cache, epochs
   1-3 warm with ``cache_read`` time and no source byte read, the plan's
   seed 0 and epoch in ``stats()``, each warm epoch's blocks in
   ``EpochPlan(0, epoch, n).order``, falling losses, ``restore_check``'s
   loss tail byte for byte from an ``epoch_plan`` source state, 20 warm
   steps twice bit-identical, the spin check in groups of 10; (b) phase
   3's corpus and ELL main path over the block cache with
   ``shuffle_seed=1``, ``shuffle_window=4096``: a cold and two warm epochs
   and an accuracy pass (above 0.9; K1 launched once a step and an
   accuracy batch, ``dw`` once a step), rows/s, stall share, ``cache_read``
   and convert seconds an epoch, no source byte read warm, the first 20
   warm steps twice bit-identical, a checkpoint after 37 batches of warm
   epoch 1 resumed in a fresh pipeline to ``torch.equal`` weights, a byte
   flipped in a block healed by one rebuild with the stream unchanged, and
   two ``pod_sharding`` hosts' blocks disjoint with the epoch as union; (c)
   phase 6's ELL snapshot served with ``device_decode=True`` and
   ``snapshot_shuffle_seed=2`` for two warm epochs: one K2 launch a warm
   batch, each batch bit-equal to the stored batch at
   ``block_permutation(2, epoch, n)[pos]``, and a ``unit="batch"`` state
   resumed in a fresh pipeline to bit-equal batches and equal weights.

The ``torch.profiler`` windows run last, the decode's first: the steps'
windows of phases 3 and 6 (``step``, ``step_warm``) follow it, and a
bcoo step's (``bcoo_step_profile``, device time by kernel), the ALS and
FM steps' (``step_profile``: device events and time by kernel a step), and
how many launches the card queues behind a spin (``launch_queue``). Then the
run's total wall time, a ``{"kernels": [...]}`` line (launches counted on
the main paths of phases 3, 6, 7, 11 and 12; the row scatter's on phases
9, 10, 11 and 12), the card's name and power limit as
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


def enqueue_behind_spin(step, calls: int = 20, spin_cycles: int = 1_000_000_000,
                        group: int = None) -> dict:
    """Whether ``step`` waits for the device: ``calls`` calls enqueued
    behind a device-side spin of about half a second. A call that
    synchronises the host (also inside a library, where CUDA's sync debug
    mode cannot see it) waits for the spin, so its enqueue time is then at
    least the spin's; without one the host is done long before, and the
    stream is still busy.

    The card queues about a thousand launches (``launch_queue_depth``: 1,000
    enqueue behind a spin, 1,023 wait for it), so calls whose launches fill
    that queue wait too, sync or not. With ``group`` the calls go in groups
    of that many, each group behind a spin of its own, and the slowest
    group counts."""
    import torch

    group = group or calls
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(spin_cycles)
    end.record()
    torch.cuda.synchronize()
    spin_s = start.elapsed_time(end) / 1e3
    host_s, busy = 0.0, True
    for first in range(0, calls, group):
        torch.cuda._sleep(spin_cycles)
        t0 = time.monotonic()
        for _ in range(min(group, calls - first)):
            step()
        host_s = max(host_s, time.monotonic() - t0)
        busy = busy and not torch.cuda.current_stream().query()
        torch.cuda.synchronize()
    return {"calls": calls, "group": group, "host_s": host_s, "spin_s": spin_s,
            "stream_busy_after": busy, "no_host_sync": busy and host_s < 0.5 * spin_s}


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
    # the same steps from a fresh learner: the same bits (the gradient's
    # row scatter has no atomics)
    again = LinearLearner(HIGGS_COLS, layout="bcoo", learning_rate=0.3, device=device)
    card_again = [again.step(b) for b in batches]
    repeatable = bool(torch.equal(torch.stack(card), torch.stack(card_again))
                      and torch.equal(model.params.weight, again.params.weight)
                      and torch.equal(model.params.bias, again.params.bias))
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
           "steps_under_sync_error": len(pairs), "card_bit_identical_twice": repeatable,
           "first_batch_dense_equal_cpu": dense_equal,
           "loss": loss, "batches": nb, "wall_s": epoch_s, "rows_per_s": nb * BATCH / epoch_s,
           "stall_s": stall, "stall_share": stall / epoch_s, "accuracy": acc,
           "nnz_shapes": shapes, "step_device_ms": bcoo_ms, "ell_step_device_ms": ell_ms,
           "step_enqueue_behind_spin": bcoo_spin, "ell_step_enqueue_behind_spin": ell_spin,
           "natural_loss": nat_loss, "natural_batches": nat_nb, "natural_wall_s": nat_s,
           "natural_rows_per_s": HIGGS_ROWS / nat_s}
    emit(out)
    if not (len(pairs) == steps and rel <= 1e-4 and dense_equal):
        raise AssertionError(f"bcoo: the first {steps} steps or batch differ from the CPU: {pairs}")
    if not repeatable:
        raise AssertionError("bcoo: two card runs of the first steps differ")
    if not (bcoo_spin["no_host_sync"] and ell_spin["no_host_sync"]):
        raise AssertionError(f"a step waited for the device: bcoo {bcoo_spin}, ELL {ell_spin}")
    if not (acc > 0.9 and np.isfinite(loss) and len(shapes) == 1 and np.isfinite(nat_loss)
            and nat_nb > 0):
        raise AssertionError(f"bcoo epoch failed its checks: {out}")
    return out


def launch_queue_depth(counts=(500, 1000, 1023, 1024, 1100)) -> dict:
    """How many launches the card queues behind a device spin before the
    host waits: ``n`` one-element adds enqueued behind a half-second spin,
    for each ``n`` in ``counts``."""
    import torch

    x = torch.zeros(1, device="cuda")
    fits = {}
    for n in counts:
        x.add_(1)
        fits[n] = enqueue_behind_spin(lambda: x.add_(1), calls=n)["no_host_sync"]
    return {"phase": "launch_queue", "enqueued_without_waiting": fits}


def step_profile(name: str, step, steps: int = 5) -> dict:
    """Device events (kernels, copies, fills) a ``step`` issues and their
    time, from ``steps`` steps under ``torch.profiler``. A measurement,
    not a check: an empty trace is reported as such."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.5)
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    per_kernel: dict = {}
    events = 0
    for evt in prof.events():
        # the optimizer's own range shows on the device too: not an event
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            events += 1
            per_kernel[evt.name] = (per_kernel.get(evt.name, 0.0)
                                    + evt.time_range.elapsed_us() / steps / 1e3)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {"phase": "step_profile", "step": name, "device_events_per_step": events / steps,
            "device_ms_per_step": sum(per_kernel.values()),
            "top_kernels_ms_per_step": [[k[:80], ms] for k, ms in top]}


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


# ---------------- phase 9: the route for row scatters ----------------

ROW_SCATTER_SHAPES = [  # (name, B, K, D, row): B*K rows scattered into a [D, *row] table
    ("als_gram", 512, 32, 513, (16, 16)),             # train_als.py's full size, [D+1, F, F]
    ("als_rhs", 512, 32, 513, (16,)),                 # its [D+1, F] rhs
    ("als_large_gram", 8192, 32, 65_537, (16, 16)),   # a 67 MB gram
    ("als_large_rhs", 8192, 32, 65_537, (16,)),
    ("wide_1d", 8192, 16, (1 << 20) + 1, ()),         # a 1-D table above DW_MAX_TABLE
    ("fm_v", BATCH, HIGGS_COLS, HIGGS_COLS + 1, (8,)),  # phase 10's factor gradient
    ("fm_w", BATCH, HIGGS_COLS, HIGGS_COLS + 1, ()),    # and its linear weights'
]
ROW_SCATTER_MAIN = "als_gram"


def row_scatter_candidates() -> dict:
    """The routes the A/B times: ``index_add_`` (float atomics),
    ``index_put_(accumulate=True)`` (torch's sort-based kernel) and the
    port's route (a stable sort and ``csrc/row_scatter.cu``)."""
    import torch

    from dmlc_tpu_torch.ops import row_scatter as rs

    def index_add(shape, idx, src):
        return torch.zeros(shape, dtype=src.dtype, device=src.device).index_add_(0, idx, src)

    def index_put(shape, idx, src):
        return torch.zeros(shape, dtype=src.dtype, device=src.device).index_put_(
            (idx,), src, accumulate=True)

    def kernel(shape, idx, src):
        return rs.row_scatter_add(shape, idx, src)

    return {"index_add": index_add, "index_put": index_put, "row_scatter": kernel}


def row_scatter_inputs(b: int, k: int, d: int, row: tuple, seed: int, device):
    """``B*K`` int64 row ids in ``[0, D)``, a quarter of them the sink
    ``D - 1`` with zero rows (an ELL batch's pad slots), and the rows."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    idx = torch.randint(0, d - 1, (b * k,), generator=gen, device=device)
    src = torch.randn((b * k, *row), generator=gen, device=device)
    pad = torch.rand(b * k, generator=gen, device=device) < 0.25
    idx[pad] = d - 1
    src[pad] = 0.0
    return idx, src


def row_scatter_ab(seed: int) -> list:
    """Each candidate route for a row scatter at ``ROW_SCATTER_SHAPES``:
    its bits over two runs, its distance from ``index_add_``, its device
    time (CUDA events behind a spin, median of 5), whether 20 calls enqueue
    behind a half-second spin, and the bytes bound (``src`` and ``idx``
    read once, the table written once). The kernel must agree with the
    plain version (``index_add_``) within 1e-4 + 1e-5 of each word's
    absolute sum and give the same bits twice, and its stable order by row
    id (the counting sort up to 4,095 rows) must equal
    ``torch.sort(stable=True)``'s, bit for bit."""
    import torch

    from dmlc_tpu_torch.ops import _build
    from dmlc_tpu_torch.ops import row_scatter as rs

    dev = torch.device("cuda", torch.cuda.current_device())
    rows = []
    for i, (name, b, k, d, row) in enumerate(ROW_SCATTER_SHAPES):
        idx, src = row_scatter_inputs(b, k, d, row, seed + i, dev)
        shape = (d, *row)
        n_row = int(np.prod(row)) if row else 1
        bound_ms, bound_by = bound(b * k * (8 + 4 * n_row) + d * n_row * 4, b * k * n_row)
        plain = rs.row_scatter_add_plain(shape, idx, src)
        tol = 1e-4 + 1e-5 * rs.row_scatter_add_plain(shape, idx, src.abs())
        rec = {"phase": "row_scatter_ab", "shape": name, "B": b, "K": k, "D": d,
               "row": list(row), "bound_ms": bound_ms, "bound_by": bound_by}
        for cand, fn in row_scatter_candidates().items():
            first, second = fn(shape, idx, src), fn(shape, idx, src)
            torch.cuda.synchronize()
            err = (first - plain).abs()
            spin = enqueue_behind_spin(lambda: fn(shape, idx, src))
            rec[cand] = {"bit_identical_twice": same_bits(first, second),
                         "max_abs_diff_vs_plain": float(err.max()),
                         "within_tol": bool((err <= tol).all()),
                         "ms": device_ms(lambda: fn(shape, idx, src)),
                         "no_host_sync": spin["no_host_sync"], "spin_host_s": spin["host_s"]}
            del first, second
        # the stable order by row id against torch's stable sort, bit for
        # bit (the counting sort's route up to 4,095 rows)
        counting = _build.load_kernels().dmlc_row_sort_counts(b * k, d) > 0
        order, want = rs.stable_order(idx, d), torch.sort(idx.to(torch.int32), stable=True)
        rec["sort"] = {"route": "counting" if counting else "torch.sort",
                       "equal_to_torch_sort": all(torch.equal(x, y) for x, y in zip(order, want)),
                       "ms": device_ms(lambda: rs.stable_order(idx, d)),
                       "torch_sort_ms": device_ms(
                           lambda: torch.sort(idx.to(torch.int32), stable=True))}
        # the plain version (zeros and index_add_) and the one PyTorch call,
        # index_add_ into a table already there
        acc = torch.zeros(shape, device=dev)
        rec["plain_ms"] = device_ms(lambda: rs.row_scatter_add_plain(shape, idx, src))
        rec["library_ms"] = device_ms(lambda: acc.index_add_(0, idx, src))
        emit(rec)
        rows.append(rec)
        kern = rec["row_scatter"]
        if not (kern["bit_identical_twice"] and kern["within_tol"] and kern["no_host_sync"]
                and rec["sort"]["equal_to_torch_sort"]):
            raise AssertionError(f"row_scatter {name}: the kernel differs from its plain "
                                 f"version, between two runs, or waited for the device: {kern}")
    return rows


# ---------------- phase 9: ALS ----------------

ALS = {"users": 4096, "items": 512, "factors": 16, "per_row": 32, "batch": 512,
       "reg": 0.05, "epochs": 4, "restore_epoch": 1, "restore_at": 2,
       "chunk_bytes": 64 << 10}  # examples/train_als.py's full run


def write_ratings_corpus(path: str, seed: int, rank: int = 4) -> dict:
    """``examples/train_als.py``'s ``synthesize`` at its full size: one
    libsvm row per user (label = user id, features = item:rating) from a
    rank-4 model, written from ``seed`` with numpy."""
    rng = np.random.default_rng(seed)
    users, items, per_row = ALS["users"], ALS["items"], ALS["per_row"]
    gt_u = rng.normal(size=(users, rank)).astype(np.float32)
    gt_v = rng.normal(size=(items, rank)).astype(np.float32)
    with open(path, "w") as f:
        for uid in range(users):
            cols = rng.choice(items, size=per_row, replace=False)
            ratings = gt_u[uid] @ gt_v[cols].T
            f.write(f"{uid} " + " ".join(f"{j}:{r:.6f}" for j, r in zip(cols, ratings)) + "\n")
    return {"rows": users, "bytes": os.path.getsize(path)}


def _als_pipeline(path: str, device):
    """(learner, DeviceIter) of the ALS path, fresh, as a user builds them."""
    from dmlc_tpu_torch import AlsLearner, DeviceIter, create_parser

    model = AlsLearner(ALS["users"], ALS["items"], num_factors=ALS["factors"], reg=ALS["reg"],
                       seed=0, device=device)
    it = DeviceIter(create_parser(path, 0, 1, "libsvm", chunk_bytes=ALS["chunk_bytes"]),
                    num_col=model.device_num_col(), batch_size=ALS["batch"], layout="ell",
                    max_nnz=ALS["per_row"], drop_remainder=True, device=device)
    return model, it


def _state_bits(state: dict) -> bytes:
    return b"".join(np.ascontiguousarray(state[k]).tobytes() for k in sorted(state))


def run_als(path: str, device, steps: int = 20) -> dict:
    """create_parser -> DeviceIter(ell) -> AlsLearner -> fit(4 epochs) ->
    eval_loss, with the row scatter's launches zeroed just before and read
    just after; then ``steps`` card steps (cycling over one epoch's
    batches) and ``finalize_items`` run twice from the same seed, bit for
    bit, and against the same steps on the CPU: the losses, the normal
    equations before the item solve and the items after it; each step's
    scatter into the ``[D+1, F*F+F]`` normal equations against its plain
    version on the same rows; a checkpoint at batch ``restore_at`` of epoch
    ``restore_epoch + 1`` resumed in fresh objects, its loss tail, item
    solve and the next epoch byte for byte; 20 steps enqueued behind a
    device spin; the step's device time and host wall."""
    import torch

    from dmlc_tpu_torch import AlsLearner
    from dmlc_tpu_torch.ops import row_scatter as rs
    from dmlc_tpu_torch.ops.sparse import EllBatch

    model, it = _als_pipeline(path, device)
    epochs = []

    def log(epoch, loss, nb, secs):
        epochs.append({"epoch": epoch, "loss": loss, "batches": nb, "wall_s": secs,
                       "rows_per_s": nb * ALS["batch"] / secs})

    rs.launches = 0
    t0 = time.monotonic()
    model.fit(it, epochs=ALS["epochs"], log_fn=log)
    fit_s = time.monotonic() - t0
    mse = model.eval_loss(it)
    launches = rs.launches
    batches = [EllBatch(*(t.clone() for t in b)) for b in it]  # one epoch, resident
    it.close()
    steps_run = sum(e["batches"] for e in epochs)
    scatter = {"max_abs_err": 0.0, "within_tol": True, "same_bits_as_step": True}

    def trajectory(init_state=None, dev=device):
        """The losses, the normal equations before the item solve, the
        state after it and, on the CPU, each normal-equation word's absolute
        sum. On the card each step's scatter is also held against its plain
        version (launches that compare do not count)."""
        m = AlsLearner(ALS["users"], ALS["items"], num_factors=ALS["factors"], reg=ALS["reg"],
                       seed=0, device=dev)
        if init_state is not None:
            m.load_state_dict(init_state)
        losses, abs_eq = [], torch.zeros_like(m._normal_eq)
        for i in range(steps):
            b = EllBatch(*(t.to(dev) for t in batches[i % len(batches)]))
            before = m._normal_eq.clone()
            losses.append(m.step(b))
            ids, rows = m.normal_eq_rows(b, m.params.users[b.label.long()])
            if dev == "cpu":
                rs.row_scatter_add_plain_(abs_eq, ids, rows.abs())
            else:
                kern = rs.row_scatter_add_(before.clone(), ids, rows)
                plain = rs.row_scatter_add_plain_(before.clone(), ids, rows)
                tol = 1e-4 + 1e-5 * rs.row_scatter_add_plain_(before.abs(), ids, rows.abs())
                err = (kern - plain).abs()
                scatter["max_abs_err"] = max(scatter["max_abs_err"], float(err.max()))
                scatter["within_tol"] &= bool((err <= tol).all())
                scatter["same_bits_as_step"] &= same_bits(kern, m._normal_eq)
        eq = m._normal_eq.clone()
        m.finalize_items()
        return (torch.stack(losses).cpu().numpy(), eq.cpu().numpy(), abs_eq.cpu().numpy(),
                m.state_dict())

    init = AlsLearner(ALS["users"], ALS["items"], num_factors=ALS["factors"], reg=ALS["reg"],
                      seed=0, device=device).state_dict()
    card_a, eq_a, _, state_a = trajectory()
    card_b, eq_b, _, state_b = trajectory()
    cpu, eq_cpu, abs_cpu, state_cpu = trajectory(init, "cpu")
    repeatable = (card_a.tobytes() == card_b.tobytes() and eq_a.tobytes() == eq_b.tobytes()
                  and _state_bits(state_a) == _state_bits(state_b))
    rel = float(np.max(np.abs(card_a - cpu) / np.maximum(np.abs(cpu), 1e-12)))
    # the normal equations within 1e-4 of each word's absolute sum (a
    # dropped or doubled entry is some 1/640 of it), the items within
    # rtol 1e-4 / atol 1e-5 of the CPU's, as the CPU parity tests hold them
    eq_rel = float(np.max(np.abs(eq_a - eq_cpu) / (abs_cpu + 1e-5)))
    items_diff = np.abs(state_a["items"] - state_cpu["items"])
    items_ok = bool(np.all(items_diff <= 1e-5 + 1e-4 * np.abs(state_cpu["items"])))

    # a checkpoint mid-epoch, resumed in fresh objects; both runs go on
    # through the item solve and the next epoch
    def rest_and_next_epoch(model, it, losses):
        losses += [model.step(b) for b in it]
        model.finalize_items()
        it.reset()
        losses += [model.step(b) for b in it]
        it.close()
        return torch.stack(losses).cpu().numpy(), model.state_dict()

    model, it = _als_pipeline(path, device)
    for _ in range(ALS["restore_epoch"]):
        model.fit_epoch(it)
    losses_a, ckpt = [], None
    for batch in it:
        losses_a.append(model.step(batch))
        if len(losses_a) == ALS["restore_at"]:
            ckpt = (model.state_dict(), json.loads(json.dumps(it.state_dict())))
            break
    losses_a, ckpt_state_a = rest_and_next_epoch(model, it, losses_a)
    model, it = _als_pipeline(path, device)
    model.load_state_dict(ckpt[0])
    it.load_state(ckpt[1])
    replay, ckpt_state_b = rest_and_next_epoch(model, it, [])
    tail = losses_a[ALS["restore_at"]:]
    epoch_len = ALS["users"] // ALS["batch"]

    batch = batches[0]
    model.step(batch)
    torch.cuda.synchronize()
    # some 50 launches a step: two groups of 10 stay well inside the queue
    spin = enqueue_behind_spin(lambda: model.step(batch), group=10)
    dev_ms = device_ms(lambda: model.step(batch), iters=10)
    t0 = time.monotonic()
    for _ in range(50):
        model.step(batch)
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) / 50 * 1e3
    out = {"phase": "als", "epochs": epochs, "fit_s": fit_s, "eval_mse": mse,
           "steps": steps_run, "row_scatter_launches": launches,
           "row_scatter_launches_needed": steps_run,
           "card_bit_identical_twice": repeatable, "first_steps": steps,
           "max_rel_diff_vs_cpu": rel, "normal_eq_max_diff_over_abs_sum_vs_cpu": eq_rel,
           "items_max_abs_diff_vs_cpu": float(items_diff.max()),
           "items_within_tol_of_cpu": items_ok, "main_path_scatter_vs_plain": scatter,
           "checkpoint_state_kind": ckpt[1]["kind"], "checkpoint_tail_steps": len(tail),
           "checkpoint_tail_bytes_equal": tail.tobytes() == replay.tobytes(),
           "checkpoint_final_state_bytes_equal":
               _state_bits(ckpt_state_a) == _state_bits(ckpt_state_b),
           "step_device_ms": dev_ms, "step_wall_ms": wall_ms, "step_enqueue_behind_spin": spin}
    emit(out)
    losses = [e["loss"] for e in epochs]
    problems = []
    if not (all(np.isfinite(losses)) and all(b < a for a, b in zip(losses, losses[1:]))
            and np.isfinite(mse)):
        problems.append("the epoch losses are not finite and falling")
    if launches < steps_run:
        problems.append("the main path's scatters did not all take the kernel")
    if not repeatable:
        problems.append("two card runs differ")
    if not rel <= 1e-4:
        problems.append("the card's losses differ from the CPU's")
    if not (eq_rel <= 1e-4 and items_ok):
        problems.append("the card's normal equations or items differ from the CPU's")
    if not (scatter["within_tol"] and scatter["same_bits_as_step"]):
        problems.append("a step's scatter differs from its plain version or from itself")
    if not (out["checkpoint_tail_bytes_equal"] and out["checkpoint_final_state_bytes_equal"]
            and len(tail) == 2 * epoch_len - ALS["restore_at"] and ckpt[1]["kind"] == "source"):
        problems.append("the checkpoint did not replay the loss tail, item solve and next epoch")
    if not spin["no_host_sync"]:
        problems.append("a step waited for the device")
    if problems:
        raise AssertionError(f"als: {problems}: {out}")
    return {**out, "step_fn": lambda: model.step(batch)}


# ---------------- phase 10: FM ----------------

FM_EPOCHS = {"ell": 2, "dense": 2, "bcoo": 1}


def _fm_pipeline(path: str, device, layout: str, seed: int = 0):
    """(learner, DeviceIter) of the FM path on the HIGGS-shaped corpus."""
    from dmlc_tpu_torch import DeviceIter, FMLearner, create_parser

    model = FMLearner(HIGGS_COLS, num_factors=8, layout=layout, learning_rate=0.05, seed=seed,
                      device=device)
    it = DeviceIter(create_parser(path, 0, 1, "libsvm"), num_col=model.device_num_col(),
                    batch_size=BATCH, layout=layout, max_nnz=HIGGS_COLS, drop_remainder=True,
                    device=device)
    return model, it


def _fm_params_bits(model) -> bytes:
    return b"".join(p.detach().cpu().numpy().tobytes() for p in model.params)


def run_fm(path: str, device, layout: str, steps: int = 20) -> dict:
    """FMLearner on ``layout``: fit(``FM_EPOCHS``) -> accuracy with the row
    scatter's launches zeroed just before and read just after; ``steps``
    card steps run twice from the same seed, bit for bit, and against the
    same batches on the CPU; 20 steps enqueued behind a device spin; the
    step's device time."""
    import torch

    from dmlc_tpu_torch import FMLearner
    from dmlc_tpu_torch.convert import fm_params_from_jax, fm_params_to_jax
    from dmlc_tpu_torch.ops import row_scatter as rs

    model, it = _fm_pipeline(path, device, layout)
    rs.launches = 0
    t0 = time.monotonic()
    losses = []
    model.fit(it, epochs=FM_EPOCHS[layout], log_fn=lambda e, loss, nb, s: losses.append(loss))
    fit_s = time.monotonic() - t0
    acc = model.accuracy(it)
    launches = rs.launches
    nb = HIGGS_ROWS // BATCH * FM_EPOCHS[layout]
    batches = [b for _, b in zip(range(steps), it)]
    it.close()

    def trajectory(dev=device, init=None):
        m = FMLearner(HIGGS_COLS, num_factors=8, layout=layout, learning_rate=0.05, seed=0,
                      device=dev)
        if init is not None:
            m.set_params(fm_params_from_jax(*init, device=dev))
        out = [m.step(tuple(t.to(dev) for t in b) if layout != "ell"
                      else type(b)(*(t.to(dev) for t in b))) for b in batches]
        return torch.stack(out).cpu().numpy(), m

    card_a, m_a = trajectory()
    card_b, m_b = trajectory()
    init = fm_params_to_jax(FMLearner(HIGGS_COLS, num_factors=8, layout=layout, seed=0,
                                      device=device).params)
    cpu, _ = trajectory("cpu", init)
    repeatable = (card_a.tobytes() == card_b.tobytes()
                  and _fm_params_bits(m_a) == _fm_params_bits(m_b))
    rel = float(np.max(np.abs(card_a - cpu) / np.maximum(np.abs(cpu), 1e-12)))
    batch = batches[0]
    m_a.step(batch)
    torch.cuda.synchronize()
    # 50-130 launches a step: groups of 5 stay well inside the launch queue
    spin = enqueue_behind_spin(lambda: m_a.step(batch), group=5)
    dev_ms = device_ms(lambda: m_a.step(batch), iters=10)
    out = {"phase": "fm", "layout": layout, "epoch_losses": losses, "fit_s": fit_s,
           "rows_per_s": nb * BATCH / fit_s, "accuracy": acc, "steps": nb,
           "row_scatter_launches": launches, "card_bit_identical_twice": repeatable,
           "first_steps": len(batches), "max_rel_diff_vs_cpu": rel, "step_device_ms": dev_ms,
           "step_enqueue_behind_spin": spin}
    emit(out)
    problems = []
    if not (acc > 0.9 and all(np.isfinite(losses))):
        problems.append("accuracy <= 0.9 or a non-finite loss")
    if not repeatable:
        problems.append("two card runs differ")
    if not (len(batches) == steps and rel <= 1e-4):
        problems.append("the card's losses differ from the CPU's")
    if not spin["no_host_sync"]:
        problems.append("a step waited for the device")
    # the ell gathers' gradients (w and V) and bcoo's three products' each
    # scatter once a step; the dense path has none
    need = {"ell": 2, "bcoo": 3, "dense": 0}[layout] * nb
    if launches < need:
        problems.append(f"the row scatter launched {launches} times, the path needs {need}")
    if problems:
        raise AssertionError(f"fm {layout}: {problems}: {out}")
    return {**out, "row_scatter_launches_needed": need, "step_fn": lambda: m_a.step(batch)}


# ---------------- phase 11: data parallelism ----------------

PAR = {"steps": 20, "ranks": 2, "child_timeout": 300, "nccl_timeout": 60,
       "uneven_rows": 4096}


def _par_ell(path: str, mesh, part: int, parts: int, device=None):
    """(learner, DeviceIter) of the ELL path on one rank's part (a mesh's
    device), or on ``device`` without a mesh."""
    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser

    model = LinearLearner(HIGGS_COLS, layout="ell", learning_rate=0.3, mesh=mesh, device=device)
    it = DeviceIter(create_parser(path, part, parts, "libsvm"), num_col=model.device_num_col(),
                    batch_size=BATCH, layout="ell", max_nnz=HIGGS_COLS, drop_remainder=True,
                    mesh=mesh, shardings=model.batch_shardings(), device=device)
    return model, it


def _first_batches(it, n: int) -> list:
    """The iterator's first ``n`` batches, copied, so a timed loop steps
    and does not parse; the iterator is closed."""
    from dmlc_tpu_torch.ops.sparse import EllBatch

    out = [EllBatch(*(t.clone() for t in b)) for _, b in zip(range(n), it)]
    it.close()
    return out


def _bits(tensors) -> str:
    import hashlib

    return hashlib.sha256(b"".join(t.detach().cpu().numpy().tobytes()
                                   for t in tensors)).hexdigest()


def parallel_world1_child(path: str, out: str) -> None:
    """Leg (a), in a process of its own: a process group of one rank.
    ``init_from_env`` skips a one-worker job, as the JAX package does, so
    this calls ``init_process_group`` itself; the learner's collectives are
    issued all the same. The HIGGS-shaped main path with ``mesh=``: one
    epoch and an accuracy pass with K1's and ``dw``'s launches counted; the
    first 20 steps against the non-mesh learner on the same batches, bit
    for bit; 20 mesh steps enqueued behind a device spin; the mesh step's
    and the plain step's device time."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from dmlc_tpu_torch import LinearLearner
    from dmlc_tpu_torch.ops import ell_matvec as k1
    from dmlc_tpu_torch.parallel import make_mesh
    from dmlc_tpu_torch.parallel.launch import free_port

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0, timeout=timedelta(seconds=60))
    mesh = make_mesh()
    model, it = _par_ell(path, mesh, 0, 1)
    k1.launches = k1.dw_launches = 0
    t0 = time.monotonic()
    loss, nb = model.fit_epoch(it)
    fit_s = time.monotonic() - t0
    acc = model.accuracy(it)
    launches, dw_launches = k1.launches, k1.dw_launches
    it.close()
    batches = _first_batches(_par_ell(path, None, 0, 1, device=mesh.device)[1], PAR["steps"])
    plain = LinearLearner(HIGGS_COLS, layout="ell", learning_rate=0.3, device=mesh.device)
    meshed = LinearLearner(HIGGS_COLS, layout="ell", learning_rate=0.3, mesh=mesh)
    plain_losses = torch.stack([plain.step(b) for b in batches])
    mesh_losses = torch.stack([meshed.step(b) for b in batches])
    rec = {"phase": "parallel_world1", "backend": dist.get_backend(), "loss": loss,
           "batches": nb, "fit_s": fit_s, "rows_per_s": nb * BATCH / fit_s, "accuracy": acc,
           "k1_launches": launches, "k1_launches_needed": 2 * nb, "dw_launches": dw_launches,
           "dw_launches_needed": nb,
           "first_losses_bit_equal_to_plain": torch.equal(plain_losses, mesh_losses),
           "params_bit_equal_to_plain": all(torch.equal(p, q) for p, q in
                                            zip(plain.params, meshed.params))}
    batch = batches[0]
    torch.cuda.synchronize()
    # a step's launches and its two all-reduces: groups of 10 stay well
    # inside the card's launch queue
    rec["step_enqueue_behind_spin"] = enqueue_behind_spin(lambda: meshed.step(batch), group=10)
    rec["mesh_step_device_ms"] = device_ms(lambda: meshed.step(batch), iters=10)
    rec["plain_step_device_ms"] = device_ms(lambda: plain.step(batch), iters=10)
    dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(rec, f)


def parallel_nccl_pair_child(out_dir: str) -> None:
    """Two NCCL ranks on one card: the job's rendezvous and one
    all-reduce. NCCL is expected to refuse two ranks on one device."""
    from datetime import timedelta

    import torch

    from dmlc_tpu_torch.parallel import init_from_env, make_mesh

    contract = init_from_env(timeout=timedelta(seconds=PAR["nccl_timeout"]))
    t = make_mesh().all_reduce_(torch.ones(4, device="cuda"))
    torch.cuda.synchronize()
    with open(os.path.join(out_dir, f"nccl_{contract.task_id}.json"), "w") as f:
        json.dump({"sum": t.tolist()}, f)
    torch.distributed.destroy_process_group()


def parallel_pair_child(cfg_path: str) -> None:
    """Leg (b), one of two ranks sharing the card through gloo (named: the
    card's default, NCCL, refuses two ranks on one device). On this rank's
    parts: 20 ELL ``LinearLearner`` and ``FMLearner`` steps, one ALS epoch
    with the item solve, and ``sync_min`` over uneven shards, with K1's,
    ``dw``'s and the row scatter's launches counted."""
    from datetime import timedelta

    import torch

    from dmlc_tpu_torch import AlsLearner, DeviceIter, FMLearner, LinearLearner, create_parser
    from dmlc_tpu_torch.ops import ell_matvec as k1
    from dmlc_tpu_torch.ops import row_scatter as rs
    from dmlc_tpu_torch.parallel import host_shard_info, init_from_env, make_mesh, sync_min

    cfg = json.load(open(cfg_path))
    init_from_env(backend="gloo", device=cfg["device"], timeout=timedelta(seconds=120))
    mesh = make_mesh(devices=cfg["device"])
    rank, world = host_shard_info()
    sync = torch.cuda.synchronize if mesh.device.type == "cuda" else (lambda: None)
    out = {"rank": rank, "backend": torch.distributed.get_backend()}
    k1.launches = k1.dw_launches = rs.launches = 0

    model, it = _par_ell(cfg["higgs"], mesh, rank, world)
    batches = _first_batches(it, PAR["steps"])
    # every rank steps as often (a shorter shard would leave its peer waiting)
    if len(batches) != PAR["steps"]:
        raise AssertionError(f"rank {rank}: {len(batches)} batches, {PAR['steps']} needed")
    sync()
    t0 = time.monotonic()
    losses = torch.stack([model.step(b) for b in batches])
    sync()
    secs = time.monotonic() - t0
    out["linear"] = {"losses": losses.tolist(), "bits": _bits(model.params),
                     "global_rows_per_s": len(batches) * BATCH * world / secs}
    fm = FMLearner(HIGGS_COLS, num_factors=8, layout="ell", learning_rate=0.05, seed=0,
                   mesh=mesh)
    fm_losses = torch.stack([fm.step(b) for b in batches])
    out["fm"] = {"losses": fm_losses.tolist(), "bits": _bits(fm.params)}

    als = AlsLearner(ALS["users"], ALS["items"], num_factors=ALS["factors"], reg=ALS["reg"],
                     seed=0, mesh=mesh)
    parser = create_parser(cfg["ratings"], rank, world, "libsvm", threaded=False,
                           chunk_bytes=ALS["chunk_bytes"])
    per_epoch = sync_min(sum(len(b) for b in parser) // ALS["batch"])
    parser.close()
    it = DeviceIter(create_parser(cfg["ratings"], rank, world, "libsvm",
                                  chunk_bytes=ALS["chunk_bytes"]),
                    num_col=als.device_num_col(), batch_size=ALS["batch"], layout="ell",
                    max_nnz=ALS["per_row"], drop_remainder=True, mesh=mesh,
                    shardings=als.batch_shardings())
    als_loss, als_nb = als.fit_epoch(it, max_steps=per_epoch)
    it.close()
    out["als"] = {"loss": als_loss, "batches": als_nb, "bits": _bits(als.params)}
    out["launches"] = {"k1": k1.launches, "dw": k1.dw_launches, "row_scatter": rs.launches}

    parser = create_parser(cfg["uneven"], rank, world, "libsvm", threaded=False)
    local = sum(len(b) for b in parser) // 64
    parser.close()
    cap = sync_min(local)
    dense = LinearLearner(HIGGS_COLS, layout="dense", learning_rate=0.3, mesh=mesh)
    it = DeviceIter(create_parser(cfg["uneven"], rank, world, "libsvm"),
                    num_col=dense.device_num_col(), batch_size=64, drop_remainder=True,
                    mesh=mesh, shardings=dense.batch_shardings())
    _, nb = dense.fit_epoch(it, max_steps=cap)
    it.close()
    out["uneven"] = {"local": local, "cap": cap, "steps": nb}
    if rank == 0:
        torch.save({"linear": [p.detach().cpu() for p in model.params],
                    "fm": [p.detach().cpu() for p in fm.params],
                    "items": als.params.items.cpu()},
                   os.path.join(cfg["out"], "params.pt"))
    with open(os.path.join(cfg["out"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def write_uneven_corpus(path: str, rows: int, seed: int) -> None:
    """Long rows first (28 features), short ones after (2): byte-range
    shards hold unequal row counts."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(rows):
            x = rng.normal(size=HIGGS_COLS)
            cols = range(HIGGS_COLS) if i < rows // 2 else (0, 1)
            f.write(f"{int(x[0] + x[1] > 0)} "
                    + " ".join(f"{j}:{x[j]:.6f}" for j in cols) + "\n")


def _world1_reference(cfg: dict, device) -> dict:
    """The card's one-process run on the pair's global batches (each the
    two ranks' batches concatenated in rank order): the linear and FM
    losses and parameters after 20 steps, and the ALS items after one
    epoch and its item solve."""
    import torch

    from dmlc_tpu_torch import AlsLearner, DeviceIter, FMLearner, LinearLearner, create_parser
    from dmlc_tpu_torch.ops.sparse import EllBatch

    def cat(parts):
        return [EllBatch(*(torch.cat(ts) for ts in zip(*group))) for group in zip(*parts)]

    world = PAR["ranks"]
    batches = cat([_first_batches(_par_ell(cfg["higgs"], None, r, world, device)[1],
                                  PAR["steps"]) for r in range(world)])
    model = LinearLearner(HIGGS_COLS, layout="ell", learning_rate=0.3, device=device)
    losses = torch.stack([model.step(b) for b in batches])
    fm = FMLearner(HIGGS_COLS, num_factors=8, layout="ell", learning_rate=0.05, seed=0,
                   device=device)
    fm_losses = torch.stack([fm.step(b) for b in batches])
    parts = []
    for r in range(world):
        it = DeviceIter(create_parser(cfg["ratings"], r, world, "libsvm",
                                      chunk_bytes=ALS["chunk_bytes"]),
                        num_col=ALS["items"], batch_size=ALS["batch"], layout="ell",
                        max_nnz=ALS["per_row"], drop_remainder=True, device=device)
        parts.append([EllBatch(*(t.clone() for t in b)) for b in it])
        it.close()
    als = AlsLearner(ALS["users"], ALS["items"], num_factors=ALS["factors"], reg=ALS["reg"],
                     seed=0, device=device)
    als_batches = cat(parts)
    for b in als_batches:
        als.step(b)
    als.finalize_items()
    return {"linear": (losses.cpu(), [p.detach().cpu() for p in model.params]),
            "fm": (fm_losses.cpu(), [p.detach().cpu() for p in fm.params]),
            "items": als.params.items.cpu(), "als_batches": len(als_batches)}


def _run_pair(cfg: dict, tmp: str, name: str):
    """Leg (b)'s two gloo ranks, once: their JSON records and their
    output directory."""
    from dmlc_tpu_torch.parallel.launch import run_local

    out = os.path.join(tmp, name)
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "cfg.json")
    with open(path, "w") as f:
        json.dump({**cfg, "out": out}, f)
    run_local([sys.executable, os.path.abspath(__file__), "--parallel-child", "pair", path],
              PAR["ranks"], timeout=PAR["child_timeout"])
    return ([json.load(open(os.path.join(out, f"rank{r}.json"))) for r in range(PAR["ranks"])],
            out)


def run_parallel(path: str, ratings: str, tmp: str, device, seed: int) -> dict:
    """Phase 11: data parallelism through ``dmlc_tpu_torch.parallel``.
    (a) a process group of one NCCL rank in a child process; (b) two
    NCCL ranks tried on the one card (refusal or hang recorded), then two
    gloo ranks on it, twice, against the card's one-process run on the
    same global batches; (c) the dry-run entry point on the card. gloo
    stages its collectives through the host, so the spin check is leg
    (a)'s alone."""
    import torch

    from dmlc_tpu_torch.parallel.launch import run_local

    res = {}
    out = os.path.join(tmp, "world1.json")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--parallel-child",
                           "world1", path, out], capture_output=True, text=True,
                          timeout=PAR["child_timeout"])
    if proc.returncode != 0:
        raise AssertionError(f"parallel leg (a) failed: {proc.stderr[-3000:]}")
    a = json.load(open(out))
    emit(a)
    check_world1(a)
    res["world1"] = a


    nccl_dir = os.path.join(tmp, "nccl_pair")
    os.makedirs(nccl_dir, exist_ok=True)
    t0 = time.monotonic()
    try:
        runs = run_local([sys.executable, os.path.abspath(__file__), "--parallel-child",
                          "nccl_pair", nccl_dir], PAR["ranks"], timeout=PAR["nccl_timeout"],
                         check=False)
        failed = [r for r in runs if r.returncode != 0]
        nccl = {"outcome": "refused" if failed else "ran",
                "message": "" if not failed else failed[0].stderr.strip()[-600:]}
    except TimeoutError as exc:
        nccl = {"outcome": "hung", "message": str(exc)[-600:]}
    nccl["seconds"] = time.monotonic() - t0
    emit({"phase": "parallel_nccl_pair", **nccl})
    res["nccl_pair"] = nccl

    cfg = {"higgs": path, "ratings": ratings, "uneven": os.path.join(tmp, "uneven.libsvm"),
           "device": str(device)}
    write_uneven_corpus(cfg["uneven"], PAR["uneven_rows"], seed)
    t0 = time.monotonic()
    run1, out1 = _run_pair(cfg, tmp, "pair1")
    pair_s = time.monotonic() - t0
    run2, out2 = _run_pair(cfg, tmp, "pair2")
    rec = check_pair(run1, run2, _world1_reference(cfg, device), out1)
    rec["pair_run_s"] = pair_s
    emit(rec)
    res["pair"] = rec

    # (c) the port's dry-run entry point as a user calls it: on the card by
    # default; two ranks share this one card, so it names gloo
    from dmlc_tpu_torch.entry import dryrun_multichip

    t0 = time.monotonic()
    dry = dryrun_multichip(PAR["ranks"], timeout=PAR["child_timeout"])
    dry = {"phase": "parallel_dryrun", "ranks": PAR["ranks"], "backend": dry["backend"],
           "legs": dry["legs"], "first_loss": dry["trajectory"][0],
           "last_loss": dry["trajectory"][-1],
           "max_abs_diff_vs_single_process": float(np.max(np.abs(
               np.array(dry["trajectory"]) - np.array(dry["single_process"])))),
           "seconds": time.monotonic() - t0}
    emit(dry)
    if dry["backend"] != ("nccl" if torch.cuda.device_count() >= PAR["ranks"] else "gloo"):
        raise AssertionError(f"parallel leg (c): unexpected backend: {dry}")
    res["dryrun"] = dry
    return res


def check_world1(a: dict) -> None:
    """Leg (a)'s gates."""
    problems = []
    if not a["accuracy"] > 0.9:
        problems.append("accuracy <= 0.9")
    if (a["k1_launches"], a["dw_launches"]) != (a["k1_launches_needed"], a["dw_launches_needed"]):
        problems.append("K1 or dw launched other than once a margin / a step")
    if not (a["first_losses_bit_equal_to_plain"] and a["params_bit_equal_to_plain"]):
        problems.append("the world-1 mesh steps differ from the plain steps' bits")
    if not a["step_enqueue_behind_spin"]["no_host_sync"]:
        problems.append("a mesh step waited for the device")
    if problems:
        raise AssertionError(f"parallel leg (a): {problems}: {a}")


def check_pair(run1: list, run2: list, ref: dict, out1: str) -> dict:
    """Leg (b)'s record and gates: the pair's two runs against each other
    and against the one-process run ``ref``."""
    import torch

    got = torch.load(os.path.join(out1, "params.pt"))
    rec = {"phase": "parallel_pair", "backend": run1[0]["backend"], "ranks": PAR["ranks"],
           "gloo_one_card_global_rows_per_s": run1[0]["linear"]["global_rows_per_s"],
           "note": "gloo stages CUDA collectives through the host: rows/s is a gloo-on-"
                   "one-card figure, not a scaling number; no spin check here"}
    for leg in ("linear", "fm"):
        losses = np.array(run1[0][leg]["losses"])
        want, want_params = ref[leg]
        rec[f"{leg}_max_rel_diff_vs_world1"] = float(np.max(
            np.abs(losses - want.numpy()) / np.maximum(np.abs(want.numpy()), 1e-12)))
        rec[f"{leg}_params_max_abs_diff_vs_world1"] = max(
            float((g - w).abs().max()) for g, w in zip(got[leg], want_params))
        rec[f"{leg}_bits_equal_across_ranks"] = len({r[leg]["bits"] for r in run1}) == 1
        rec[f"{leg}_bits_equal_across_runs"] = (
            [r[leg]["bits"] for r in run1] == [r[leg]["bits"] for r in run2]
            and run1[0][leg]["losses"] == run2[0][leg]["losses"])
    items_diff = (got["items"] - ref["items"]).abs()
    rec["als_items_max_abs_diff_vs_world1"] = float(items_diff.max())
    rec["als_items_within_tol"] = bool((items_diff <= 1e-5 + 1e-4 * ref["items"].abs()).all())
    rec["als_batches"] = [r["als"]["batches"] for r in run1]
    rec["als_bits_equal_across_ranks_and_runs"] = len(
        {r["als"]["bits"] for r in run1 + run2}) == 1
    rec["uneven"] = [r["uneven"] for r in run1]
    rec["launches"] = {k: sum(r["launches"][k] for r in run1) for k in run1[0]["launches"]}
    problems = []
    for leg in ("linear", "fm"):
        if not (rec[f"{leg}_max_rel_diff_vs_world1"] <= 1e-5
                and rec[f"{leg}_params_max_abs_diff_vs_world1"] <= 1e-5):
            problems.append(f"{leg}: the pair differs from the one-process run")
        if not (rec[f"{leg}_bits_equal_across_ranks"] and rec[f"{leg}_bits_equal_across_runs"]):
            problems.append(f"{leg}: bits differ across ranks or runs")
    if not (rec["als_items_within_tol"] and rec["als_bits_equal_across_ranks_and_runs"]
            and rec["als_batches"] == [ref["als_batches"]] * PAR["ranks"]):
        problems.append("als: the pair's items differ from the one-process run's")
    locals_ = [u["local"] for u in rec["uneven"]]
    if not (len(set(locals_)) > 1
            and all(u["cap"] == u["steps"] == min(locals_) for u in rec["uneven"])):
        problems.append("sync_min did not cap the uneven shards' epochs")
    steps = PAR["steps"] * PAR["ranks"]
    if (rec["launches"]["k1"], rec["launches"]["dw"]) != (steps, steps):
        problems.append("K1 or dw launched other than once a step on each rank")
    if problems:
        emit(rec)
        raise AssertionError(f"parallel leg (b): {problems}: {rec}")
    return rec


def parallel_child(argv: list) -> int:
    """``chip_smoke.py --parallel-child KIND ARGS...``: one process of
    phase 11."""
    kind = argv[0]
    if kind == "world1":
        parallel_world1_child(*argv[1:])
    elif kind == "nccl_pair":
        parallel_nccl_pair_child(*argv[1:])
    else:
        parallel_pair_child(*argv[1:])
    return 0


# ---------------- phase 12: the block cache and the epoch planner ----------------

BC = {"batch": BATCH, "seed": 1, "window": 4096, "ckpt_at": CKPT_AT, "snap_seed": 2}


def _plan_recorder(src, out: list):
    """Wrap ``src.next_block`` (the DeviceIter's producer calls it) to
    record ``(plan epoch, the block's first label)`` of each served block."""
    inner = src.next_block

    def next_block():
        block = inner()
        if block is not None:
            out.append((src.plan_state["epoch"], float(block.label[0])))
        return block

    src.next_block = next_block


def _base_bytes(src) -> int:
    """The source bytes the block cache's parser chain has read (0 before
    a cold pass built it)."""
    return src._base.bytes_read if src._base is not None else 0


def run_block_cache_als(tmp: str, device) -> dict:
    """Phase 12 (a): ``dmlc_tpu_torch.examples.train_als``'s local leg at
    its full size. First ``main([])`` as a user runs it (the row scatter's
    launches counted from 0 around it, its lines checked); then the same
    pieces (``synthesize``, ``_build``, ``restore_check``) with each epoch's
    cache state, plan epoch, ``cache_read`` delta and source bytes, and
    each warm epoch's block order held against ``EpochPlan(0, epoch, n)``;
    20 warm steps run twice, bit for bit; the spin check in groups of 10."""
    import contextlib
    import io

    import torch

    from dmlc_tpu_torch.data.epoch import EpochPlan
    from dmlc_tpu_torch.examples import train_als
    from dmlc_tpu_torch.io.block_cache import BlockCacheReader
    from dmlc_tpu_torch.ops import row_scatter as rs
    from dmlc_tpu_torch.ops.sparse import EllBatch
    from dmlc_tpu_torch.parallel import make_mesh

    cfg = train_als.config(dryrun=False, world=1)
    out_buf = io.StringIO()
    rs.launches = 0
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out_buf):
        train_als.main([])
    main_s = time.monotonic() - t0
    launches = rs.launches
    lines = out_buf.getvalue().splitlines()
    epoch_len = cfg["users"] // cfg["batch"]
    # steps of the main run: its fit, its eval pass (no scatter), and
    # restore_check's two pipelines (an epoch, the warm epoch, its replay)
    need = (cfg["epochs"] + 2) * epoch_len + (epoch_len - cfg["restore_at"])

    path = os.path.join(tmp, "als_bc.libsvm")
    cache = os.path.join(tmp, "als.blockcache")
    train_als.synthesize(path, cfg["users"], cfg["items"], cfg["per_row"])
    mesh = make_mesh()
    model, it = train_als._build(path, cache, cfg, mesh)
    src = it.source
    served: list = []
    _plan_recorder(src, served)
    epochs = []
    prev = {"cache_read": 0.0, "base_bytes": 0}

    def log(epoch, loss, nb, secs):
        st = it.stats()
        now = {"cache_read": src.stage_seconds()["cache_read"], "base_bytes": _base_bytes(src)}
        epochs.append({"epoch": epoch, "loss": loss, "batches": nb, "wall_s": secs,
                       "rows_per_s": nb * cfg["batch"] / secs,
                       "cache_state": st["cache_state"], "plan_epoch": st["epoch"],
                       "shuffle_seed": st["shuffle_seed"],
                       "input_wait_s": st["input_wait_seconds"],
                       "cache_read_s": now["cache_read"] - prev["cache_read"],
                       "source_bytes": now["base_bytes"] - prev["base_bytes"]})
        prev.update(now)

    model.fit(it, epochs=cfg["epochs"], log_fn=log)
    mse = model.eval_loss(it)
    it.close()
    reader = BlockCacheReader(cache)
    first_labels = [float(reader.load_segments(i)["label"][0]) for i in range(reader.num_blocks)]
    num_blocks = reader.num_blocks
    reader.close()
    orders_ok = True
    for e in epochs[1:]:
        got = [lab for ep, lab in served if ep == e["epoch"]]
        want = [first_labels[i] for i in EpochPlan(0, e["epoch"], num_blocks).order]
        orders_ok &= got == want
    restore_steps = train_als.restore_check(path, cache, cfg, mesh)

    def warm_steps(n: int = 20):
        m, feed = train_als._build(path, cache, cfg, mesh)
        losses = []
        while len(losses) < n:
            for batch in feed:
                losses.append(m.step(batch))
                if len(losses) == n:
                    break
            else:
                m.finalize_items()
                feed.reset()
        feed.close()
        return torch.stack(losses).cpu().numpy(), m.state_dict()

    la, sa = warm_steps()
    lb, sb = warm_steps()
    repeatable = la.tobytes() == lb.tobytes() and _state_bits(sa) == _state_bits(sb)
    m, feed = train_als._build(path, cache, cfg, mesh)
    batch = EllBatch(*(t.clone() for t in next(iter(feed))))
    feed.close()
    m.step(batch)
    torch.cuda.synchronize()
    spin = enqueue_behind_spin(lambda: m.step(batch), group=10)
    out = {"phase": "block_cache_als", "main_s": main_s, "main_lines": lines,
           "row_scatter_launches": launches, "row_scatter_launches_needed": need,
           "epochs": epochs, "eval_mse": mse, "num_blocks": num_blocks,
           "warm_orders_equal_plan": orders_ok, "restore_steps": restore_steps,
           "warm_steps_bit_identical_twice": repeatable, "step_enqueue_behind_spin": spin,
           "reduced": "none: examples/train_als.py's full run"}
    emit(out)
    losses = [e["loss"] for e in epochs]
    problems = []
    if not (lines[-1] == "OK" and f"checkpoint/restore byte-identical over "
            f"{epoch_len - cfg['restore_at']} steps" in lines):
        problems.append("the example's main() did not print its restore line and OK")
    if launches != need:
        problems.append("the row scatter did not launch once a step")
    if not (all(np.isfinite(losses)) and all(b < a for a, b in zip(losses, losses[1:]))):
        problems.append("the epoch losses are not finite and falling")
    for e in epochs:
        warm = e["epoch"] > 0
        if (e["cache_state"] != ("warm" if warm else "cold") or e["plan_epoch"] != e["epoch"]
                or e["shuffle_seed"] != 0
                or (warm and not (e["cache_read_s"] > 0 and e["source_bytes"] == 0))):
            problems.append(f"epoch {e['epoch']}: cache state, plan or reads wrong")
    if not orders_ok:
        problems.append("a warm epoch's block order is not EpochPlan(0, epoch, n).order")
    if restore_steps != epoch_len - cfg["restore_at"]:
        problems.append("restore_check compared the wrong number of steps")
    if not repeatable:
        problems.append("20 warm steps run twice differ")
    if not spin["no_host_sync"]:
        problems.append("a step waited for the device")
    if problems:
        raise AssertionError(f"block_cache_als: {problems}: {out}")
    return out


def _bc_pipeline(path: str, cache: str, device, **kw):
    """(parser, learner, DeviceIter) of the HIGGS main path over the planned
    block cache, fresh."""
    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser

    opts = dict(shuffle_seed=BC["seed"], shuffle_window=BC["window"])
    opts.update(kw)
    parser = create_parser(path, 0, 1, "libsvm", block_cache=cache, **opts)
    model = LinearLearner(HIGGS_COLS, layout="ell", learning_rate=0.3, device=device)
    it = DeviceIter(parser, num_col=model.device_num_col(), batch_size=BATCH, layout="ell",
                    max_nnz=HIGGS_COLS, drop_remainder=True, device=device)
    return parser, model, it


def _values_key(values) -> bytes:
    """A block's identity whatever its row order: its sorted values."""
    return np.sort(np.asarray(values)).tobytes()


def run_block_cache_higgs(path: str, tmp: str, device) -> dict:
    """Phase 12 (b): the HIGGS main path over the planned block cache
    (``shuffle_seed=1``, ``shuffle_window=4096``): a cold and two warm
    epochs and an accuracy pass with K1's and ``dw``'s launches counted
    from 0, each epoch's rows/s, stall share, ``cache_read`` and convert
    seconds and source bytes; the first 20 warm steps run twice; a
    checkpoint after 37 batches of warm epoch 1 resumed in a fresh
    pipeline; a byte flipped in a block healed once with the stream
    unchanged; two hosts' shards disjoint with the epoch as their union."""
    import torch

    from dmlc_tpu_torch import create_parser
    from dmlc_tpu_torch.convert import linear_params_from_jax, linear_params_to_jax
    from dmlc_tpu_torch.io import resilience
    from dmlc_tpu_torch.io.block_cache import BlockCacheReader
    from dmlc_tpu_torch.ops import ell_matvec as k1

    cache = os.path.join(tmp, "higgs.blockcache")
    parser, model, it = _bc_pipeline(path, cache, device)
    epochs = []
    keys = ("stall_seconds", "convert_seconds")
    prev = {"stall_seconds": 0.0, "convert_seconds": 0.0, "cache_read": 0.0, "base_bytes": 0}

    def log(epoch, loss, nb, secs):
        st = it.stats()
        now = {k: st[k] for k in keys}
        now.update(cache_read=parser.stage_seconds()["cache_read"], base_bytes=_base_bytes(parser))
        d = {k: now[k] - prev[k] for k in now}
        prev.update(now)
        rec = {"phase": "block_cache_higgs", "epoch": epoch, "loss": loss, "batches": nb,
               "wall_s": secs, "rows_per_s": nb * BATCH / secs,
               "stall_share": d["stall_seconds"] / secs, "cache_state": st["cache_state"],
               "plan_epoch": st["epoch"], "cache_read_s": d["cache_read"],
               "convert_s": d["convert_seconds"], "source_bytes": d["base_bytes"],
               "input_wait_s": st["input_wait_seconds"]}
        emit(rec)
        epochs.append(rec)

    k1.launches = k1.dw_launches = 0
    model.fit(it, epochs=3, log_fn=log)
    acc = model.accuracy(it)
    launches, dw_launches = k1.launches, k1.dw_launches
    it.close()
    steps = sum(e["batches"] for e in epochs)
    acc_batches = HIGGS_ROWS // BATCH
    cache_bytes = os.path.getsize(cache)

    def first_steps(n: int = 20):
        _, m, feed = _bc_pipeline(path, cache, device)
        losses = [m.step(b) for _, b in zip(range(n), feed)]
        feed.close()
        return torch.stack(losses), m.params.weight.detach().clone()

    la, wa = first_steps()
    lb, wb = first_steps()
    repeatable = same_bits(la, lb) and same_bits(wa, wb)

    # a checkpoint after CKPT_AT batches of warm epoch 1, resumed fresh
    _, m, feed = _bc_pipeline(path, cache, device)
    for b in feed:
        m.step(b)
    feed.reset()
    state = params = None
    for i, b in enumerate(feed):
        m.step(b)
        if i + 1 == BC["ckpt_at"]:
            state = json.loads(json.dumps(feed.state_dict()))
            params = linear_params_to_jax(m.params)
    feed.close()
    _, m2, feed = _bc_pipeline(path, cache, device, shuffle_seed=None, shuffle_window=0)
    m2.set_params(linear_params_from_jax(*params, device=device))
    feed.load_state(state)
    rest = 0
    for b in feed:
        m2.step(b)
        rest += 1
    feed.close()
    resumed = bool(torch.equal(m.params.weight, m2.params.weight)
                   and torch.equal(m.params.bias, m2.params.bias))

    # a flipped byte heals once, the stream unchanged
    def epoch_batches():
        _, _, feed = _bc_pipeline(path, cache, device)
        out = [[t.clone() for t in b] for b in feed]
        feed.close()
        return out

    clean = epoch_batches()
    reader = BlockCacheReader(cache)
    pos = int(reader._blocks[reader.num_blocks // 2]["pos"]) + 100
    reader.close()
    with open(cache, "r+b") as f:
        f.seek(pos)
        byte = f.read(1)
        f.seek(pos)
        f.write(bytes([byte[0] ^ 0x01]))
    base = resilience.counters_snapshot()
    healed = epoch_batches()
    events = resilience.counters_delta(base)
    heal_equal = len(healed) == len(clean) and all(
        all(same_bits(x, y) for x, y in zip(a, b)) for a, b in zip(healed, clean))
    del clean, healed

    # two hosts' shards of the warm epoch
    reader = BlockCacheReader(cache)
    whole = sorted(_values_key(reader.load_segments(i)["value"])
                   for i in range(reader.num_blocks))
    reader.close()
    shards = []
    for host in range(2):
        p = create_parser(path, 0, 1, "libsvm", block_cache=cache, shuffle_seed=BC["seed"],
                          shuffle_window=BC["window"], pod_sharding=(host, 2))
        shards.append([_values_key(b.value) for b in p])
        p.close()
    flat = shards[0] + shards[1]
    shards_ok = len(set(flat)) == len(flat) and sorted(flat) == whole

    out = {"phase": "block_cache_higgs", "accuracy": acc, "steps": steps,
           "k1_launches": launches, "k1_launches_needed": steps + acc_batches,
           "dw_launches": dw_launches, "dw_launches_needed": steps,
           "cache_bytes": cache_bytes, "first_warm_steps_bit_identical_twice": repeatable,
           "checkpoint_batches_after_restore": rest, "checkpoint_weights_equal": resumed,
           "checkpoint_state_source": state["source"], "heal_events": events,
           "heal_stream_equal": heal_equal, "shard_blocks": [len(s) for s in shards],
           "shards_disjoint_union_is_epoch": shards_ok,
           "reduced": "HIGGS (UCI 280) 11,000,000 rows cut to 1,048,576 for the time limit"}
    emit(out)
    problems = []
    if not acc > 0.9:
        problems.append(f"accuracy {acc} <= 0.9")
    if launches != steps + acc_batches or dw_launches != steps:
        problems.append("K1 or dw launch counts differ from the steps")
    for e in epochs:
        warm = e["epoch"] > 0
        if (e["cache_state"] != ("warm" if warm else "cold") or e["plan_epoch"] != e["epoch"]
                or (warm and not (e["source_bytes"] == 0 and e["cache_read_s"] > 0
                                  and e["convert_s"] > 0))):
            problems.append(f"epoch {e['epoch']}: cache state, plan or reads wrong")
    if not repeatable:
        problems.append("the first 20 warm steps run twice differ")
    if not (resumed and rest == HIGGS_ROWS // BATCH - BC["ckpt_at"]
            and state["kind"] == "source" and state["source"]["kind"] == "epoch_plan"
            and state["source"]["epoch"] == 1):
        problems.append("the warm checkpoint did not resume to the same weights")
    if not (heal_equal and events.get("cache_rebuilds") == 1
            and events.get("cache_corruptions") == 1):
        problems.append("the flipped byte did not heal once with the stream unchanged")
    if not shards_ok:
        problems.append("the two hosts' shards are not disjoint with the epoch as union")
    if problems:
        raise AssertionError(f"block_cache_higgs: {problems}: {out}")
    return {**out, "epochs": epochs}


def run_shuffled_snapshot(path: str, snap: str, device) -> dict:
    """Phase 12 (c): phase 6's ELL snapshot served warm with
    ``device_decode=True`` and ``snapshot_shuffle_seed=2``: two warm epochs
    stepped through LinearLearner, K1, ``dw`` and K2 counted from 0 around
    them, each batch held bit for bit against the stored-order warm batch
    at ``block_permutation(2, epoch, n)[pos]`` (read first, not counted);
    a ``unit="batch"`` state taken after 37 batches of epoch 1 resumed in
    a fresh pipeline: the remaining batches bit-equal and the final
    weights ``torch.equal``."""
    import torch

    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser
    from dmlc_tpu_torch.convert import linear_params_from_jax, linear_params_to_jax
    from dmlc_tpu_torch.data.epoch import block_permutation
    from dmlc_tpu_torch.ops import device_decode as dd
    from dmlc_tpu_torch.ops import ell_matvec as k1

    def pipeline(seed):
        model = LinearLearner(HIGGS_COLS, layout="ell", learning_rate=0.3, device=device)
        it = DeviceIter(create_parser(path, 0, 1, "libsvm", snapshot=snap),
                        num_col=model.device_num_col(), batch_size=BATCH, layout="ell",
                        max_nnz=HIGGS_COLS, drop_remainder=True, device=device,
                        device_decode=True, snapshot_shuffle_seed=seed)
        return model, it

    _, it = pipeline(None)
    stored = [[t.clone() for t in b] for b in it]
    it.close()
    n = len(stored)
    model, it = pipeline(BC["snap_seed"])
    k1.launches = k1.dw_launches = dd.launches = 0
    equal, warm, state, params, tail, walls = True, True, None, None, [], []
    for ep in range(2):
        order = block_permutation(BC["snap_seed"], ep, n)
        t0 = time.monotonic()
        for pos, batch in enumerate(it):
            equal &= all(same_bits(a, b) for a, b in zip(batch, stored[order[pos]]))
            model.step(batch)
            if ep == 1 and pos + 1 == BC["ckpt_at"]:
                state = json.loads(json.dumps(it.state_dict()))
                params = linear_params_to_jax(model.params)
            elif state is not None:
                tail.append([t.clone() for t in batch])
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
        warm &= it.stats()["snapshot_state"] == "warm"
        it.reset()
    k1_launches, dw_launches, k2_launches = k1.launches, k1.dw_launches, dd.launches
    it.close()
    model2, it = pipeline(None)
    model2.set_params(linear_params_from_jax(*params, device=device))
    it.load_state(state)
    resumed = []
    for b in it:
        model2.step(b)
        resumed.append([t.clone() for t in b])
    it.close()
    tail_equal = len(resumed) == len(tail) and all(
        all(same_bits(x, y) for x, y in zip(a, b)) for a, b in zip(resumed, tail))
    weights_equal = bool(torch.equal(model.params.weight, model2.params.weight)
                         and torch.equal(model.params.bias, model2.params.bias))
    out = {"phase": "shuffled_snapshot", "batches": 2 * n, "warm": warm,
           "rows_per_s": [n * BATCH / w for w in walls],
           "k2_launches": k2_launches, "k2_launches_needed": 2 * n,
           "k1_launches": k1_launches, "dw_launches": dw_launches,
           "batches_equal_stored_at_plan": equal, "state_source": state["source"],
           "resumed_batches": len(resumed), "resumed_batches_equal": tail_equal,
           "resumed_weights_equal": weights_equal}
    emit(out)
    problems = []
    if not (warm and equal):
        problems.append("a shuffled warm batch differs from the stored batch at its plan index")
    if k2_launches != 2 * n or k1_launches != 2 * n or dw_launches != 2 * n:
        problems.append("K2, K1 or dw did not launch once a warm batch")
    if not (state["source"].get("unit") == "batch" and tail_equal and weights_equal
            and len(resumed) == n - BC["ckpt_at"]):
        problems.append("the unit='batch' state did not resume bit for bit")
    if problems:
        raise AssertionError(f"shuffled_snapshot: {problems}: {out}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", default=None,
                    help="a checkout of the parent commit: phases 2 and 5 also time its "
                         "K1 and its K2 route beside this one's, in turns")
    ap.add_argument("--parallel-child", nargs="+", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.parallel_child:
        return parallel_child(args.parallel_child)
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
        # phase 9: ALS at examples/train_als.py's full size, then the A/B of
        # the row scatter's routes; phase 10: FM on the HIGGS-shaped corpus.
        # Each path's row-scatter launches are counted from 0
        ratings = os.path.join(tmp, "ratings.libsvm")
        emit({"phase": "ratings_corpus", **write_ratings_corpus(ratings, args.seed),
              "reduced": "none: examples/train_als.py's full run (4096 users, 512 items, "
                         "16 factors, 32 ratings a row, batch 512)"})
        als = run_als(ratings, dev)
        rs_rows = row_scatter_ab(args.seed)
        fm = {layout: run_fm(path, dev, layout) for layout in FM_EPOCHS}
        emit({"phase": "fm_vs_linear", "fm_step_device_ms": {
            k: v["step_device_ms"] for k, v in fm.items()}})
        # phase 11: data parallelism, its launches counted in its children
        par = run_parallel(path, ratings, tmp, dev, args.seed)
        par_k1 = par["world1"]["k1_launches"] + par["pair"]["launches"]["k1"]
        par_dw = par["world1"]["dw_launches"] + par["pair"]["launches"]["dw"]
        # phase 12: the block cache and the epoch planner, each leg with
        # its launches counted from 0 around its main path
        t12 = time.monotonic()
        bc_als = run_block_cache_als(tmp, dev)
        bc_higgs = run_block_cache_higgs(path, tmp, dev)
        bc_snap = run_shuffled_snapshot(path, ell_snap, dev)
        emit({"phase": "block_cache_total", "wall_s": time.monotonic() - t12})
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
        emit(step_profile("als", als.pop("step_fn")))
        for layout, r in fm.items():
            emit(step_profile(f"fm_{layout}", r.pop("step_fn")))
        emit(launch_queue_depth())
        step_ms = {"linear_ell": step["step_device_ms"],
                   **{f"fm_{k}": v["step_device_ms"] for k, v in fm.items()},
                   "als": als["step_device_ms"]}
        emit({"phase": "step_device_ms", "steps": step_ms})

    emit({"phase": "total", "wall_s": time.monotonic() - t_start})
    k1_main = k1_rows[0]
    k2_main = next(r for r in k2_rows["kinds"] if r["kind"] == K2_MAIN)
    rs_main = next(r for r in rs_rows if r["shape"] == ROW_SCATTER_MAIN)
    emit({"kernels": [{
        "name": "ell_matvec", "route": "cuda",
        "source": "dmlc_tpu_torch/csrc/ell_matvec.cu",
        "replaces": "dmlc_tpu/ops/pallas_sparse.py:122",
        "launches": (launches + warm_ell["k1_launches"] + ckpt_k1 + par_k1
                     + bc_higgs["k1_launches"] + bc_snap["k1_launches"]),
        "max_abs_err": max(r["max_abs_err"] for r in k1_rows),
        "ms": k1_main["ms"], "plain_ms": k1_main["plain_ms"],
        "bound_ms": k1_main["bound_ms"], "bound_by": k1_main["bound_by"],
        "library_ms": k1_main["library_ms"]}, {
        "name": "ell_matvec_dw", "route": "cuda",
        "source": "dmlc_tpu_torch/csrc/ell_matvec_dw.cu",
        "replaces": "dmlc_tpu/ops/pallas_sparse.py:191",
        "launches": (dw_launches + warm_ell["dw_launches"] + ckpt_dw + par_dw
                     + bc_higgs["dw_launches"] + bc_snap["dw_launches"]),
        "max_abs_err": max(r["dw_kernel_max_abs_err"] for r in k1_rows
                           if r["dw_route"] == "cuda"),
        "ms": k1_main["dw_ms"], "plain_ms": k1_main["dw_plain_ms"],
        "bound_ms": k1_main["dw_bound_ms"], "bound_by": k1_main["dw_bound_by"],
        "library_ms": k1_main["dw_library_ms"]}, {
        "name": "widen_span", "route": "cuda",
        "source": "dmlc_tpu_torch/csrc/widen_span.cu",
        "replaces": "dmlc_tpu/ops/device_decode.py:168",
        "launches": (warm_ell["k2_launches"] + sum(d["k2_launches"] for d in warm_dense)
                     + ckpt_k2 + bc_snap["k2_launches"]),
        "max_abs_err": max(r["max_abs_err"] for r in k2_rows["kinds"] + k2_rows["segments"]),
        "ms": k2_main["ms"], "plain_ms": k2_main["plain_ms"],
        "bound_ms": k2_main["bound_ms"], "bound_by": k2_main["bound_by"],
        "library_ms": k2_main["library_ms"]}, {
        "name": "row_scatter", "route": "cuda",
        "source": "dmlc_tpu_torch/csrc/row_scatter.cu",
        "replaces": "dmlc_tpu/models/als.py:169",
        "launches": als["row_scatter_launches"] + sum(
            v["row_scatter_launches"] for v in fm.values())
        + par["pair"]["launches"]["row_scatter"] + bc_als["row_scatter_launches"],
        "max_abs_err": max([r["row_scatter"]["max_abs_diff_vs_plain"] for r in rs_rows]
                           + [als["main_path_scatter_vs_plain"]["max_abs_err"]]),
        "ms": rs_main["row_scatter"]["ms"], "plain_ms": rs_main["plain_ms"],
        "bound_ms": rs_main["bound_ms"], "bound_by": rs_main["bound_by"],
        "library_ms": rs_main["library_ms"]}]})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
