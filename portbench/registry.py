"""Find the benchmark's pieces by name.

Every configuration, cell, learner, input route, corpus writer and metric
is a file of its own: ``configs/<name>.json``, ``workloads/<name>.json``,
``learners/<model>.py`` (a configuration's ``model``),
``routes/<route>.py`` (a cell's ``route``), ``corpora/<corpus>.py`` (a
configuration's ``corpus``, else its ``format``) and
``metrics/<name>.py`` (a split ``<name>.<kind>`` falls back to
``<name>``'s reader). A later change adds a file and an entry in
``BENCHMARK.json``; nothing here changes. A name with no file fails with
the name in the message."""

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
    path = f"portbench.{package}.{_checked(name)}"
    try:
        return importlib.import_module(path)
    except ModuleNotFoundError as exc:
        if exc.name != path:
            raise
        raise LookupError(f"nothing named {name!r} in portbench/{package}/ "
                          f"({name}.py is not there)") from None


def learner(model: str) -> ModuleType:
    """The learner a configuration's ``model`` names (``learners/__init__.py``
    gives its functions)."""
    return _module("learners", model)


def route(name: str) -> ModuleType:
    """The input route a cell's ``route`` names: a module with
    ``open_pipeline(...) -> (iterator, cleanup)`` (``routes/__init__.py``)."""
    return _module("routes", name)


def corpus_writer(name: str) -> ModuleType:
    """The writer of one corpus: a module with ``write(path, config, seed)
    -> dict``."""
    return _module("corpora", name)


def metric_reader(name: str) -> ModuleType:
    """The reader of one metric: a module with ``read(ctx) -> float | None``
    (None: nothing to read in this run, and the metric is left out). A
    split of a quantity, ``<metric>.<kind>`` (the same reading in cells
    that report other end-to-end metrics), is read by its own file where
    there is one, else by ``<metric>``'s."""
    try:
        return _module("metrics", name.replace(".", "_"))
    except LookupError:
        if "." not in name:
            raise
        try:
            return _module("metrics", name.split(".", 1)[0])
        except LookupError:
            raise LookupError(f"no reader for the metric {name!r} in portbench/metrics/ "
                              f"(neither {name.replace('.', '_')}.py nor "
                              f"{name.split('.', 1)[0]}.py)") from None


def benchmark(root: str) -> dict:
    """``BENCHMARK.json`` at the checkout's root."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def metrics_for(bench: dict, cell: str, kind: str) -> list:
    """The entries of ``bench[kind]`` (``end_to_end`` or ``per_layer``) that
    this cell reports: those without a ``workloads`` key, and those that
    list it."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]
