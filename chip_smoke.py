#!/usr/bin/env python3
"""Drive the PyTorch port (``dmlc_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line; any failure exits non-zero:

1. environment: the card, torch/CUDA versions, the build times of the CUDA
   kernel library and the native parser (both built here from the
   checkout's sources), and the parse engine in use;
2. kernel K1 (``csrc/ell_matvec.cu``) against its plain PyTorch version at
   the shapes the JAX package cares about — values with rtol 1e-5 / atol
   1e-4, gradients through autograd — with its device time beside the plain
   version's, ``F.embedding_bag``'s (the one PyTorch call computing the same
   function) and the bytes bound;
3. the main path at full width: a HIGGS-shaped libsvm corpus (28 dense
   features; UCI dataset 280, 11,000,000 rows, cut to 2**20 rows for the
   time limit) -> create_parser -> DeviceIter(ell) -> LinearLearner ->
   fit(2 epochs) -> accuracy, with the K1 launch count of that run, and the
   first 20 step losses held against the same batches on the CPU;
4. one epoch of the dense layout on the same corpus.

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
]
K1_RTOL, K1_ATOL = 1e-5, 1e-4


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


def k1_bound_ms(idx, b: int, k: int) -> tuple:
    """Least time for the work: each input byte read once (idx, val, and
    the table words this batch touches), the output written once; or the
    2*B*K fp32 operations at the card's fp32 rate."""
    import torch

    touched = int(torch.unique(idx).numel())
    nbytes = b * k * 8 + b * 4 + touched * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * b * k / FP32_FLOPS * 1e3
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations")


def phase_k1(seed: int) -> list:
    import torch
    import torch.nn.functional as F

    from dmlc_tpu_torch.ops import ell_matvec as k1
    from dmlc_tpu_torch.ops.sparse import EllBatch, ell_matvec

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
        # gradients: kernel forward + hand-written backward against autograd
        # through the plain version, for the cotangent g
        g = torch.randn(b, generator=torch.Generator(device=dev).manual_seed(seed + 100 + i),
                        device=dev)
        tw, tv = table.clone().requires_grad_(), val.clone().requires_grad_()
        (k1.EllMatvec.apply(tw, idx, tv) * g).sum().backward()
        rw, rv = table.clone().requires_grad_(), val.clone().requires_grad_()
        (ell_matvec(rw, EllBatch(idx, rv, None, None)) * g).sum().backward()
        torch.testing.assert_close(tv.grad, rv.grad, rtol=K1_RTOL, atol=K1_ATOL)
        # dw sums up to B*K products per table slot in atomic (run-to-run)
        # order on both sides: allow 1e-5 of the slot's absolute sum
        scale = torch.zeros_like(table).index_add_(
            0, idx.long().flatten(), (val * g[:, None]).abs().flatten())
        dw_err = (tw.grad - rw.grad).abs()
        if bool((dw_err > K1_ATOL + K1_RTOL * scale).any()):
            raise AssertionError(f"K1 {name}: dw differs by up to {float(dw_err.max())}")
        # embedding_bag computes the same function in one PyTorch call
        lib_out = F.embedding_bag(idx, table[:, None], per_sample_weights=val,
                                  mode="sum")[:, 0]
        torch.testing.assert_close(lib_out, ref, rtol=K1_RTOL, atol=K1_ATOL)
        ms = device_ms(lambda: k1.ell_matvec_cuda(table, idx, val))
        plain_ms = device_ms(lambda: ell_matvec(table, batch))
        library_ms = device_ms(lambda: F.embedding_bag(
            idx, table[:, None], per_sample_weights=val, mode="sum"))
        bound_ms, bound_by = k1_bound_ms(idx, b, k)
        row = {"phase": "k1", "shape": name, "B": b, "K": k, "W": w,
               "max_abs_err": err, "dw_max_abs_err": float(dw_err.max()),
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_share": bound_ms / ms}
        emit(row)
        rows.append(row)
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
    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser
    from dmlc_tpu_torch.ops.sparse import EllBatch

    dev_model = LinearLearner(HIGGS_COLS, layout="ell", learning_rate=0.3, device=device)
    cpu_model = LinearLearner(HIGGS_COLS, layout="ell", learning_rate=0.3, device="cpu")
    it = DeviceIter(create_parser(path, 0, 1, "libsvm"),
                    num_col=dev_model.device_num_col(), batch_size=BATCH,
                    layout="ell", max_nnz=HIGGS_COLS, drop_remainder=True,
                    device=device)
    pairs = []
    for _, batch in zip(range(steps), it):
        dev_loss = dev_model.step(batch)
        cpu_loss = cpu_model.step(EllBatch(*(t.cpu() for t in batch)))
        pairs.append((float(dev_loss), float(cpu_loss)))
    it.close()
    rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in pairs)
    return {"steps": len(pairs), "max_rel_diff": rel, "losses": pairs}


def step_times(path: str, device, window: int = 40) -> dict:
    """Where an ELL step's time goes.

    On a batch already on the card: the step must not synchronise the host
    (checked with CUDA's sync debug mode set to raise), its device time
    (CUDA events, queued behind a spin) and its wall time per step in a
    loop of 50 that ends in a synchronise. Then ``window`` steps fed by a
    DeviceIter under ``torch.profiler``: device time by kernel per step and
    the share of the window's wall time in which the device was busy."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser

    model = LinearLearner(HIGGS_COLS, layout="ell", learning_rate=0.3, device=device)
    it = DeviceIter(create_parser(path, 0, 1, "libsvm"), num_col=model.device_num_col(),
                    batch_size=BATCH, layout="ell", max_nnz=HIGGS_COLS, device=device)
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
    it.close()
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
    return {"phase": "step", "step_device_ms": dev_ms, "step_wall_ms": wall_ms,
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
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

    # phase 2 (these launches are comparisons, not the main path's)
    k1_rows = phase_k1(args.seed)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        path = os.path.join(tmp, "higgs_shaped.libsvm")
        t0 = time.monotonic()
        corpus = write_higgs_corpus(path, HIGGS_ROWS, args.seed)
        emit({"phase": "corpus", **corpus, "write_s": time.monotonic() - t0,
              "reduced": "HIGGS (UCI 280) 11,000,000 rows cut to 1,048,576 "
                         "for the time limit; 28 features as published"})

        # phase 3: the counts are zeroed just before the main path
        k1.launches = 0
        main_path = run_main_path(path, dev)
        launches = k1.launches
        need = main_path["steps"] + main_path["accuracy_batches"]
        emit({"phase": "main_path", "accuracy": main_path["accuracy"],
              "fit_s": main_path["fit_s"], "accuracy_s": main_path["accuracy_s"],
              "parse_engine": main_path["engine"], "k1_launches": launches,
              "k1_launches_needed": need})
        if launches < need:
            raise AssertionError(f"K1 launched {launches} times, main path needs {need}")
        if not main_path["accuracy"] > 0.9:
            raise AssertionError(f"accuracy {main_path['accuracy']} <= 0.9")
        if not all(np.isfinite(e["loss"]) for e in main_path["epochs"]):
            raise AssertionError("non-finite epoch loss")

        first = compare_first_losses(path, dev)
        emit({"phase": "first_losses_vs_cpu", "steps": first["steps"],
              "max_rel_diff": first["max_rel_diff"]})
        if first["steps"] != 20 or not first["max_rel_diff"] <= 1e-4:
            raise AssertionError(f"first 20 losses differ from the CPU route: {first}")

        step = step_times(path, dev)
        step["device_busy_share_est"] = (
            step["step_device_ms"] * main_path["steps"] / 1e3 / main_path["fit_s"])
        emit(step)

        # phase 4
        dense = run_dense_epoch(path, dev)
        emit(dense)
        if not (np.isfinite(dense["loss"]) and dense["loss"] < np.log(2)):
            raise AssertionError(f"dense epoch loss {dense['loss']}")

    main_shape = k1_rows[0]
    emit({"kernels": [{
        "name": "ell_matvec", "route": "cuda",
        "source": "dmlc_tpu_torch/csrc/ell_matvec.cu",
        "replaces": "dmlc_tpu/ops/pallas_sparse.py:122",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in k1_rows),
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"]}]})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
