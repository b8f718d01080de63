"""libsvm rows of uneven length: ``label id:value ...``, every batch
holding a row of one entry and a row of ``row_length["longest"]``, the
others between 1 and ``2 * row_length["median"] - 1`` entries. A row's ids
are distinct and in drawn order, its values in ``(0, 2)`` to six decimals,
its label 1 with probability 0.3; all from the seed. It gives ragged
(``bcoo``) batches rows far longer than the rest, as ratings or clicks per
user are."""

from __future__ import annotations

import copy
import os

import numpy as np


def lengths(config: dict, rng: np.random.Generator) -> np.ndarray:
    """Each row's entry count (module docstring)."""
    n, b = config["corpus_rows"], config["batch_size"]
    median, longest = config["row_length"]["median"], config["row_length"]["longest"]
    out = rng.integers(1, 2 * median, size=n)
    for start in range(0, n, b):
        short, long_ = rng.choice(min(b, n - start), size=2, replace=False) + start
        out[short], out[long_] = 1, longest
    return out


def write(path: str, config: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    lines = []
    for count in lengths(config, rng):
        ids = rng.choice(config["num_col"], size=count, replace=False)
        vals = rng.uniform(1e-6, 2.0, size=count)
        label = int(rng.random() < 0.3)
        lines.append(f"{label} " + " ".join(f"{i}:{v:.6f}" for i, v in zip(ids, vals)) + "\n")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.writelines(lines)
    return {"rows": len(lines), "format": "libsvm"}


def tiny(config: dict, rows: int, batch: int) -> dict:
    """A ragged configuration is CPU-sized already: only its corpus and
    batch change."""
    return dict(copy.deepcopy(config), corpus_rows=rows, batch_size=batch)
