"""Time the ELL main path's epochs, cold and warm, with the consumer's time
split between the pipeline and the step.

    python dmlc_tpu_torch/examples/epoch_timing.py CORPUS NUM_COL [--root DIR]
        [--tag T] [--cold-epochs 2] [--warm-epochs 3] [--device cpu]

``CORPUS`` is a libsvm file (``chip_smoke.py``'s ``write_higgs_corpus``
writes the HIGGS-shaped one, 28 features). The script runs
``create_parser`` -> ``DeviceIter(ell, max_nnz=NUM_COL)`` ->
``LinearLearner(ell)``: ``--cold-epochs`` epochs with no snapshot, then a
cold epoch that writes a snapshot and ``--warm-epochs`` warm epochs that
decode each batch on the device. Each epoch reports rows/s and the mean
milliseconds a batch spent in ``next()`` (the pipeline) and in
``model.step`` (the learner), the host clock around an epoch that ends in
a device synchronise. It prints one JSON line.

``--root DIR`` imports ``dmlc_tpu_torch`` from the checkout in ``DIR``
(default: the one holding this file), so one call can time two
checkouts in turns (A B B A) on one card; only the keywords both take are
passed. Without ``--device`` it runs on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def _epoch(model, it, sync) -> dict:
    t_next = t_step = 0.0
    n = 0
    sync()
    t0 = time.monotonic()
    while True:
        a = time.monotonic()
        try:
            batch = next(it)
        except StopIteration:
            break
        b = time.monotonic()
        model.step(batch)
        t_next += b - a
        t_step += time.monotonic() - b
        n += 1
    sync()
    wall = time.monotonic() - t0
    it.reset()
    return {"batches": n, "wall_s": wall, "rows_per_s": n * it.batch_size / wall,
            "next_ms": t_next / max(n, 1) * 1e3, "step_ms": t_step / max(n, 1) * 1e3}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("corpus")
    ap.add_argument("num_col", type=int)
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    ap.add_argument("--tag", default="")
    ap.add_argument("--cold-epochs", type=int, default=2)
    ap.add_argument("--warm-epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=8192)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser

    cuda = args.device is None or str(args.device).startswith("cuda")
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def pipeline(snapshot=None):
        model = LinearLearner(num_col=args.num_col, layout="ell", learning_rate=0.3,
                              device=args.device)
        it = DeviceIter(create_parser(args.corpus, 0, 1, "libsvm", snapshot=snapshot),
                        num_col=model.device_num_col(), batch_size=args.batch_size,
                        layout="ell", max_nnz=args.num_col, drop_remainder=True,
                        device=args.device, device_decode=snapshot is not None)
        return model, it

    out = {"tag": args.tag, "root": args.root, "cold": [], "warm": []}
    model, it = pipeline()
    out["cold"] = [_epoch(model, it, sync) for _ in range(args.cold_epochs)]
    it.close()
    with tempfile.TemporaryDirectory(prefix="epoch_timing_") as tmp:
        model, it = pipeline(os.path.join(tmp, "ell.snapshot"))
        out["snapshot_write_epoch"] = _epoch(model, it, sync)
        out["warm"] = [_epoch(model, it, sync) for _ in range(args.warm_epochs)]
        it.close()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
