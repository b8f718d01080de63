"""Readings that the limits of ``correct`` are set from (PERF.md, section 2).

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--seconds 1]

For each of ``--seeds``: one run of the cell (``harness.run``, a short
window) and the numbers it compares. For each of ``--control-seeds``, at
the cell's own sizes and without the program: the control, the reference
computed in bfloat16 (its batches' values rounded to bfloat16 too), and
two faults planted in the reference put in the program's place: half of
each batch left out (weight 0, the mean over the rest) and one id of the
first batch altered. A state left unchanged reads 1 by the norms'
measure and needs no run. One JSON line a reading on standard output.

Needs a CUDA card, as ``run.py`` does."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from portbench import harness, registry
from portbench.reference import check as ref_check
from portbench.reference import fm as ref_fm


def _emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def _half(batch):
    ids, vals, label, weight = batch
    weight = weight.copy()
    weight[len(weight) // 2:] = 0.0
    return ids, vals, label, weight


def _altered(batch, rng):
    ids = batch[0].copy()
    r, k = rng.integers(0, ids.shape[0]), rng.integers(0, ids.shape[1])
    ids[r, k] = (ids[r, k] + 1) % ids.max()
    return (ids,) + tuple(batch[1:])


def _bf16_values(batch):
    ids, vals, label, weight = batch
    return ids, torch.from_numpy(vals).to(torch.bfloat16).float().numpy(), label, weight


def control_readings(config: dict, seed: int, device, root: str) -> dict:
    """``{side: readings}`` for the control and the planted faults."""
    corpus = harness.corpus_path(root, config, seed)
    registry.corpus_writer(config["format"]).write(corpus, config, seed)
    try:
        ref_batches = harness.reference_batches(config, corpus, list(range(harness.FOLLOWED)))
    finally:
        os.remove(corpus)
    ref = ref_fm.follow(config, seed, ref_batches, device)
    rng = np.random.default_rng([seed, 13])
    sides = {
        "control_bf16": ([_bf16_values(b) for b in ref_batches], torch.bfloat16),
        "fault_half_batch": ([_half(b) for b in ref_batches], torch.float32),
        "fault_altered_id": ([_altered(ref_batches[0], rng)] + ref_batches[1:], torch.float32),
    }
    out = {}
    for side, (batches, dtype) in sides.items():
        fed = ref_check.feed_gaps(batches, ref_batches)
        fed.update(ref_check.step_gaps(ref_fm.follow(config, seed, batches, device, dtype), ref))
        out[side] = fed
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    root = os.getcwd()
    bench = registry.benchmark(root)
    entry = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cell, config = registry.workload(args.workload), registry.config(entry["config"])
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t0 = time.perf_counter()
        rec, readings, _ = harness.run(config, cell, seed, args.seconds, False, device, root, t0)
        _emit(cell=args.workload, seed=seed, side="program", steps=rec.steps,
              seconds=time.perf_counter() - t0, **readings)
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        for side, readings in control_readings(config, seed, device, root).items():
            _emit(cell=args.workload, seed=seed, side=side, **readings)
    return 0


if __name__ == "__main__":
    sys.exit(main())
