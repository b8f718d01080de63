"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``dmlc_tpu_torch``. The last line
of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` last); the last lines of standard error give each number
compared beside its limit. A machine without the CUDA cards the cell asks
for, or a run that loads JAX or the JAX package, exits non-zero and
prints no result."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.getcwd()
# every cache the run's libraries keep stays inside the checkout, at a
# fixed path
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".portbench_cache", "triton")
os.environ["USE_FLAX"] = "0"


def _err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def power_limit_w() -> str:
    """The card's power limit as ``nvidia-smi`` reads it ("" where it cannot)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else ""


def result_line(bench: dict, name: str, rec, readings: dict, limits: dict, traced: bool,
                device_info: dict) -> dict:
    """The contract's result object, ``checks`` last."""
    from portbench import registry
    from portbench.reference import check as ref_check

    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in registry.metrics_for(bench, name, kind):
        value = registry.metric_reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": ref_check.verdict(readings, limits), "attempted": rec.steps,
           "failed": rec.failed, "metrics": metrics, "device": device_info}
    if traced and rec.trace is not None:
        out["breakdown"] = {"device_ops": rec.trace["device_ops"],
                            "idle_gaps": rec.trace["idle_gaps"]}
    out["checks"] = {k: {"value": readings[k], "limit": limits[k]}
                     for k in ref_check.compared(limits)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import registry

    bench = registry.benchmark(ROOT)
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        _err(f"no cell {args.workload!r} in BENCHMARK.json")
        return 2
    cell = registry.workload(args.workload)
    config = registry.config(entry["config"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        _err(f"the cell needs {entry['chips']} CUDA card(s); this machine has "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.zeros(1, device=device)
    torch.cuda.synchronize(device)
    _err(f"set-up: {time.perf_counter() - T_START:.3f} s to a running CUDA context")
    # load the port's kernels and native library (built at first use into
    # its _build/ directory) before the window
    from dmlc_tpu_torch import native
    from dmlc_tpu_torch.ops import _build
    _build.load_kernels()
    if not native.available():
        _err("the port's native parse library did not build")
        return 5

    from portbench import harness

    try:
        rec, readings, limits = harness.run(config, cell, args.seed, args.seconds,
                                            bool(args.trace), device, ROOT, T_START, log=_err)
    except ImportError as exc:
        _err(str(exc))
        return 4
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                   "count": entry["chips"], "memory_peak_bytes": rec.peak_bytes,
                   "power_limit_w": power_limit_w()}
    if rec.trace is not None:
        device_info.update(busy_s=rec.trace["busy_s"], window_s=rec.trace["window_s"])
    return emit(result_line(bench, args.workload, rec, readings, limits, bool(args.trace),
                            device_info))


def emit(out: dict) -> int:
    """Print the result: each number compared beside its limit on standard
    error, then the line. The trace's reduction, the reference and the
    metric readers load after the window's own look for modules the run may
    not hold, so look again first: where one is found, print no result."""
    from portbench import harness

    found = harness.forbidden_modules()
    if found:
        _err(f"the run holds modules it may not: {found}")
        return 4
    for k, v in out["checks"].items():
        _err(f"check {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
