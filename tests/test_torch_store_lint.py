"""The port's publish gate: every on-disk artifact of ``dmlc_tpu_torch``
publishes through ``dmlc_tpu_torch/store/``.

The scan mirrors ``bin/lint_store.py``'s two patterns over the port's
package outside ``dmlc_tpu_torch/store/``: ``os.replace(`` (a direct
atomic-publish rename; artifacts publish via
``ArtifactStore.publish_file``) and ``+ ".tmp"`` (a hand-allocated staging
name; staging names come from ``ArtifactStore.stage_path``). Comment lines
are skipped. Two modules write files that are not store artifacts and
are allowed: ``utils/telemetry.py`` (the Chrome and pod trace exports, as
the JAX gate allows its own) and ``ops/_build.py`` (the compiled kernel
library, renamed into place under the build's file lock).
"""

import os
import re
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "dmlc_tpu_torch"
STORE_PACKAGE = PACKAGE / "store"
ALLOWED = {
    PACKAGE / "utils" / "telemetry.py",  # trace exports, not artifacts
    PACKAGE / "ops" / "_build.py",       # the compiled kernel library
}
PATTERNS = (re.compile(r"\bos\.replace\s*\("), re.compile(r"\+\s*[\"']\.tmp[\"']"))


def scan_source(text: str):
    """``(1-based line, pattern index)`` for each direct-publish site."""
    out = []
    for i, line in enumerate(text.splitlines()):
        if line.lstrip().startswith("#"):
            continue
        for k, pattern in enumerate(PATTERNS):
            if pattern.search(line):
                out.append((i + 1, k))
    return out


def _modules():
    return sorted(PACKAGE.rglob("*.py"))


@pytest.mark.parametrize("text,hits", [
    ("os.replace(tmp, final)\n", [(1, 0)]),
    ("tmp = path + '.tmp'\n", [(1, 1)]),
    ('tmp = path + ".tmp"\n', [(1, 1)]),
    ("os.replace(a, b); c = d + '.tmp'\n", [(1, 0), (1, 1)]),
    ("    # os.replace(tmp, final)\n", []),
    ("x = os.replace\n", []),
    ("name = f'{path}.{pid}.tmp'\n", []),
])
def test_scan_flags_what_the_reference_gate_flags(text, hits):
    assert scan_source(text) == hits
    sys.path.insert(0, str(REPO / "bin"))
    try:
        import lint_store
    finally:
        sys.path.pop(0)
    assert [line for line, _ in lint_store.scan_source(text)] == [line for line, _ in hits]


def test_the_port_publishes_only_through_its_store():
    offenders = []
    for path in _modules():
        if path in ALLOWED or STORE_PACKAGE in path.parents:
            continue
        for line, k in scan_source(path.read_text(encoding="utf-8")):
            offenders.append(f"{path.relative_to(REPO)}:{line}: pattern {k}")
    assert offenders == []


@pytest.mark.parametrize("module", ["io/block_cache.py", "io/snapshot.py",
                                    "io/cached_split.py", "data/parsers.py",
                                    "data/device.py"])
def test_the_artifact_writers_are_scanned_and_use_the_store(module):
    path = PACKAGE / module
    assert path in _modules() and path not in ALLOWED
    text = path.read_text(encoding="utf-8")
    assert "_artifact_store(" in text or "store_for(" in text
    assert scan_source(text) == []


def test_the_allowed_modules_exist_and_the_store_holds_the_rename():
    for path in ALLOWED:
        assert path.exists()
    store_sites = [p.name for p in STORE_PACKAGE.glob("*.py")
                   if any(k == 0 for _, k in scan_source(p.read_text(encoding="utf-8")))]
    assert sorted(store_sites) == ["journal.py", "manager.py"]
    assert os.path.isdir(STORE_PACKAGE)
