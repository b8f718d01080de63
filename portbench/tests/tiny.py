"""Tiny copies of the benchmark's configurations, for the CPU."""

import copy

from portbench import registry

NUM_COL = 600


def config(name: str, rows: int = 640, batch: int = 64) -> dict:
    """``name``'s configuration with its widths kept (factors, fields,
    entries a row) and its table, corpus and batch cut down: each field's
    values in proportion, at least one each."""
    c = copy.deepcopy(registry.config(name))
    total = sum(f["cardinality"] for f in c["fields"])
    off = len(c["dense"])
    for f in c["fields"]:
        f["cardinality"] = max(1, f["cardinality"] * NUM_COL // total)
        f["offset"] = off
        off += f["cardinality"]
    c.update(num_col=off, corpus_rows=rows, batch_size=batch)
    return c


def cell(name: str) -> dict:
    return registry.workload(name)
