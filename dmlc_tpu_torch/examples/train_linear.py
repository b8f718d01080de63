"""End-to-end example: a libsvm file -> data-parallel logistic regression.

The port of the repository's ``examples/train_linear.py``: InputSplit
shard -> parse -> RowBlocks -> async host->device batches -> SGD steps,
data-parallel over the ranks of the job.

    python -m dmlc_tpu_torch.examples.train_linear [path.libsvm] [num_col] [--device cpu]

Without a path it writes a separable synthetic corpus (4096 rows a rank,
28 features) into the temporary directory. ``DMLC_EXAMPLE_LAYOUT`` picks
the device layout: ``dense`` (default) or ``ell``, data-parallel over the
ranks, or single-device ``bcoo``.

Multi-rank: launch under the DMLC_* contract (a ``dmlc-submit`` backend,
or ``dmlc_tpu_torch.parallel.launch.run_local``); ``init_from_env`` joins
the ranks (NCCL on the card, gloo with ``--device cpu``), each rank reads
its own partition (``host_shard_info``), and the ranks agree on the steps
an epoch with ``sync_min``: byte-range shards rarely hold the same batch
count, and a rank that stepped once more would wait forever.
"""

from __future__ import annotations

import argparse
import os
import tempfile


def synthesize(path: str, n: int = 4096, d: int = 28) -> None:
    import numpy as np

    rng = np.random.default_rng(0)
    w = rng.normal(size=d)
    with open(path, "w") as f:
        for _ in range(n):
            x = rng.normal(size=d)
            y = int(x @ w + rng.normal() * 0.1 > 0)
            feats = " ".join(f"{j}:{x[j]:.6f}" for j in range(d))
            f.write(f"{y} {feats}\n")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path", nargs="?", default=None)
    ap.add_argument("num_col", nargs="?", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="the device of every rank (default: the card)")
    ap.add_argument("--epochs", type=int, default=5)
    args = ap.parse_args(argv)

    from dmlc_tpu_torch import DeviceIter, LinearLearner, create_parser
    from dmlc_tpu_torch.parallel import host_shard_info, init_from_env, make_mesh, sync_min

    init_from_env(device=args.device)  # no-op for one worker
    part, nparts = host_shard_info()
    path, num_col = args.path, args.num_col
    if path is None:
        # one copy a rank (the same bytes), so no rank reads a file another
        # is still writing
        path = os.path.join(tempfile.gettempdir(), f"dmlc_tpu_torch_example.{part}.libsvm")
        num_col = 28
        synthesize(path, n=4096 * nparts, d=num_col)
    elif num_col is None:
        # one host-only pass to discover the feature count
        scan = create_parser(path, 0, 1, "libsvm", threaded=False)
        num_col = max((int(b.index.max()) + 1 for b in scan if len(b.index)), default=1)
        scan.close()
        print(f"inferred num_col={num_col}")

    layout = os.environ.get("DMLC_EXAMPLE_LAYOUT", "dense")
    mesh = make_mesh(devices=args.device) if layout != "bcoo" else None
    batch = 1024  # rows a rank
    model = LinearLearner(num_col=num_col, objective="logistic", layout=layout,
                          learning_rate=0.3, mesh=mesh, device=args.device)
    # one host-only pass over this rank's part counts its batches; the
    # ranks step min(counts) times an epoch
    count = create_parser(path, part, nparts, "libsvm", threaded=False)
    steps = sync_min(sum(len(b) for b in count) // batch) if mesh is not None else None
    count.close()
    it = DeviceIter(create_parser(path, part, nparts, "libsvm"),
                    num_col=model.device_num_col(), batch_size=batch, layout=layout,
                    mesh=mesh, shardings=model.batch_shardings(), drop_remainder=True,
                    max_nnz=num_col, device=args.device)

    def log(epoch, loss, nb, secs):
        print(f"epoch {epoch}: loss={loss:.4f} batches={nb} {secs:.2f}s "
              f"stall={it.stall_seconds:.2f}s", flush=True)

    model.fit(it, epochs=args.epochs, log_fn=log, steps_per_epoch=steps)
    print(f"train accuracy: {model.accuracy(it):.3f}", flush=True)
    it.close()


if __name__ == "__main__":
    main()
