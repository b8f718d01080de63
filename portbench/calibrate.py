"""Readings that the limits of ``correct`` are set from (PERF.md, section 2).

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--seconds 1]

For each of ``--seeds``: one run of the cell (``harness.run``, a short
window) and the numbers it compares. For each of ``--control-seeds``, at
the cell's own sizes and without the program: the control and the faults
planted in the reference put in the program's place, as the
configuration's learner defines them (``control_readings`` in
``learners/<model>.py``). One JSON line a reading on standard output.

Needs a CUDA card, as ``run.py`` does."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from portbench import harness, registry


def _emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def control_readings(config: dict, seed: int, device, root: str) -> dict:
    """``{side: readings}`` for the control and the planted faults, over
    the followed batches of the seed's corpus as the reference parses them."""
    corpus = harness.corpus_path(root, config, seed)
    registry.corpus_writer(harness.corpus_name(config)).write(corpus, config, seed)
    try:
        ref_batches = harness.reference_batches(config, corpus, list(range(harness.FOLLOWED)))
    finally:
        os.remove(corpus)
    return registry.learner(config["model"]).control_readings(config, seed, ref_batches, device)


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
