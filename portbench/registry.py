"""Find the benchmark's pieces by name.

Every configuration, cell, corpus writer and metric is a file of its own:
``configs/<name>.json``, ``workloads/<name>.json``, ``corpora/<format>.py``
and ``metrics/<name>.py``. A later change adds a file and an entry in
``BENCHMARK.json``; nothing here changes."""

from __future__ import annotations

import importlib
import json
import os
import re
from types import ModuleType

HERE = os.path.dirname(os.path.abspath(__file__))
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str) -> str:
    if not _NAME.match(name or ""):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_json(kind: str, name: str) -> dict:
    """``portbench/<kind>/<name>.json`` as a dict."""
    with open(os.path.join(HERE, kind, _checked(name) + ".json")) as f:
        return json.load(f)


def config(name: str) -> dict:
    return load_json("configs", name)


def workload(name: str) -> dict:
    return load_json("workloads", name)


def _module(package: str, name: str) -> ModuleType:
    return importlib.import_module(f"portbench.{package}.{_checked(name)}")


def corpus_writer(fmt: str) -> ModuleType:
    """The writer of one text format: a module with ``write(path, config,
    seed) -> dict``."""
    return _module("corpora", fmt)


def metric_reader(name: str) -> ModuleType:
    """The reader of one metric: a module with ``read(ctx) -> float | None``
    (None: nothing to read in this run, and the metric is left out)."""
    return _module("metrics", name.replace(".", "_"))


def benchmark(root: str) -> dict:
    """``BENCHMARK.json`` at the checkout's root."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def metrics_for(bench: dict, cell: str, kind: str) -> list:
    """The entries of ``bench[kind]`` (``end_to_end`` or ``per_layer``) that
    this cell reports: those without a ``workloads`` key, and those that
    list it."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]
