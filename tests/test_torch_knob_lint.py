"""The port's knob discipline: every read of a tunable ``DMLC_TPU_*``
environment variable lives in ``dmlc_tpu_torch/utils/knobs.py``.

The counterpart of the JAX package's lint gate (``bin/lint_metrics.py``,
tested in ``tests/test_autotune.py``): an AST scan of every module of
``dmlc_tpu_torch/`` for ``os.environ.get(NAME)``, ``os.environ[NAME]``,
``os.getenv(NAME)`` and ``os.environ.setdefault(NAME)`` where ``NAME`` is a
tunable name (the JAX gate's pattern: ``*_WORKERS``, ``PREFETCH``,
``CONVERT_AHEAD``, ``AUTOTUNE*``, ``STORE*``, ...), given as a string or as
a module constant holding one. A new knob must be a row of ``KNOB_TABLE``,
never a read of its own. The scanner itself is checked on the JAX gate's
own cases.
"""

import ast
import os
import re

import dmlc_tpu_torch

PKG = os.path.dirname(dmlc_tpu_torch.__file__)
KNOB_MODULE = os.path.join("utils", "knobs.py")
TUNABLE = re.compile(
    r"^DMLC_TPU_(?:[A-Z0-9_]*_WORKERS|PREFETCH|CONVERT_AHEAD|AUTOTUNE[A-Z0-9_]*|"
    r"STORE[A-Z0-9_]*|HEDGE_FACTOR|DRAIN_DEADLINE|PARSE_ENGINE|FLEET[A-Z0-9_]*|"
    r"SERVICE_PIPELINE_DEPTH|WIRE_COMPRESSION|QOS[A-Z0-9_]*|CLAIM_WAIT_DEADLINE|"
    r"DEVICE_DECODE[A-Z0-9_]*|METRICS[A-Z0-9_]*)$")


def _environ(node) -> bool:
    """``os.environ`` or a bare ``environ``."""
    return ((isinstance(node, ast.Attribute) and node.attr == "environ")
            or (isinstance(node, ast.Name) and node.id == "environ"))


def scan_source(text: str) -> list:
    """(line, name) of each read of a tunable variable in ``text``."""
    tree = ast.parse(text)
    consts = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    consts[target.id] = node.value.value

    def name_of(arg):
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            return arg.value
        if isinstance(arg, ast.Name):
            return consts.get(arg.id)
        return None

    out = []
    for node in ast.walk(tree):
        key = None
        if isinstance(node, ast.Call) and node.args:
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr in ("get", "setdefault", "pop") \
                    and _environ(fn.value):
                key = name_of(node.args[0])
            elif (isinstance(fn, ast.Attribute) and fn.attr == "getenv") or (
                    isinstance(fn, ast.Name) and fn.id == "getenv"):
                key = name_of(node.args[0])
        elif isinstance(node, ast.Subscript) and _environ(node.value):
            key = name_of(node.slice)
        if key is not None and TUNABLE.match(key):
            out.append((node.lineno, key))
    return sorted(out)


def test_scanner_flags_the_reference_gates_cases():
    bad = (
        'w = int(os.environ.get("DMLC_TPU_PARSE_WORKERS", "2") or 2)\n'
        'p = os.environ.get("DMLC_TPU_PREFETCH", "2")\n'
        'c = os.environ["DMLC_TPU_CONVERT_AHEAD"]\n'
        'a = os.environ.get("DMLC_TPU_AUTOTUNE_MAX_PREFETCH")\n'
        'g = int(os.getenv("DMLC_TPU_SNAPSHOT_READ_WORKERS", "2"))\n'
        '# os.environ.get("DMLC_TPU_PARSE_WORKERS") in comment: ok\n'
        's = os.environ.get("DMLC_TPU_TRANSFER_SAMPLE", "32")\n'
        'ENV = "DMLC_TPU_METRICS_HISTORY"\n'
        'h = os.environ.get(ENV)\n'
        'x = "DMLC_TPU_PARSE_WORKERS"  # a name alone is no read\n'
    )
    assert [ln for ln, _ in scan_source(bad)] == [1, 2, 3, 4, 5, 9]


def test_no_tunable_env_read_outside_the_knob_table():
    offenders, scanned = [], 0
    for root, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            rel = os.path.relpath(path, PKG)
            with open(path) as fh:
                found = scan_source(fh.read())
            scanned += 1
            if rel == KNOB_MODULE:
                assert found, "the knob table reads its variables"
                continue
            offenders += [(rel, ln, name) for ln, name in found]
    assert scanned >= 30 and offenders == []
