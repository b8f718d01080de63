"""Tiny copies of the benchmark's configurations, for the CPU: each cut by
its corpus writer's ``tiny`` (``corpora/<corpus>.py``)."""

from portbench import harness, registry


def config(name: str, rows: int = 640, batch: int = 64) -> dict:
    """``name``'s configuration cut to CPU size by its corpus writer."""
    c = registry.config(name)
    return registry.corpus_writer(harness.corpus_name(c)).tiny(c, rows, batch)


def cell(name: str) -> dict:
    return registry.workload(name)
