"""The port's tiered artifact store against the JAX package's.

- the same publish / pin / drop / discard / claim / release / budget /
  compaction / missing-probe sequences run through both packages' stores
  (``dmlc_tpu_torch.store`` and ``dmlc_tpu.store``), each in a directory
  of its own: the manifests are equal line for line once the pids are
  normalised, and so are ``entries()``, ``total_bytes()`` and the files
  left on disk;
- a manifest written by either package replays in the other to the same
  entries, pins and tombstones, and a directory published by one and
  opened by the other under a budget is evicted in the JAX package's
  order (snapshots first, then block caches, then chunk caches, LRU within
  a tier; pinned files and the file just published exempt);
- pins and claims of a process that has exited are dropped on both sides;
- ``signature_hash``, ``tier_for_magic`` and the constants are the JAX
  package's;
- orphan GC and stray adoption at open, and three threads publishing into
  one store at once;
- the port pipeline over an evicted block cache, snapshot and chunk cache
  rebuilds each byte-identical with ``store_rebuilds_after_eviction``
  counted, while an invalidation is not counted as an eviction (the cases
  of ``tests/test_store.py``); a warm block-cache epoch and a warm snapshot
  epoch read by two workers keep their file through a squeeze published
  from another thread in their middle.

Everything runs on the CPU at a small size.
"""

import json
import os
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest

from dmlc_tpu.io import block_cache as jax_bc
from dmlc_tpu.io import snapshot as jax_snapshot
from dmlc_tpu.store import manager as jax_mgr
from dmlc_tpu_torch.data import DeviceIter, create_parser
from dmlc_tpu_torch.io import block_cache as port_bc
from dmlc_tpu_torch.io import create_input_split
from dmlc_tpu_torch.io import resilience
from dmlc_tpu_torch.io import snapshot as port_snapshot
from dmlc_tpu_torch.store import manager as port_mgr
from dmlc_tpu_torch.utils import telemetry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MGR = {"jax": jax_mgr, "port": port_mgr}
OTHER = {"jax": "port", "port": "jax"}
MAGIC = {"snapshot": b"DMLCSN01", "block_cache": b"DMLCBC01", "chunk_cache": b"DMLCCHK1"}


@pytest.fixture(autouse=True)
def _fresh_stores(monkeypatch):
    """Every test opens fresh stores (open-time GC, adoption and budget
    run again) with no budget set."""
    for name in ("DMLC_TPU_STORE_BUDGET_BYTES", "DMLC_TPU_STORE_JOB_BUDGET_BYTES",
                 "DMLC_TPU_STORE_GC_AGE_SECONDS"):
        monkeypatch.delenv(name, raising=False)
    jax_mgr.reset_stores()
    port_mgr.reset_stores()
    yield
    jax_mgr.reset_stores()
    port_mgr.reset_stores()


def _manifest(root):
    """The manifest's events, pids normalised."""
    path = os.path.join(str(root), port_mgr.STORE_DIRNAME, port_mgr.MANIFEST_NAME)
    out = []
    with open(path) as f:
        for line in f.read().splitlines():
            ev = json.loads(line)
            if "pid" in ev:
                ev["pid"] = 0
            out.append(ev)
    return out


def _files(root):
    return sorted(n for n in os.listdir(root) if n != port_mgr.STORE_DIRNAME)


def _publish(mgr, root, name, tier, size, sig=None, job=None):
    final = os.path.join(str(root), name)
    st = mgr.store_for(final)
    tmp = st.stage_path(final)
    with open(tmp, "wb") as f:
        f.write(MAGIC[tier] + bytes(size - 8))
    st.publish_file(tmp, final, tier=tier, signature=sig, job=job)
    return final


def _run(mgr, root, ops, monkeypatch):
    """Apply an op sequence through ``mgr``'s store of ``root``; returns
    the claimant answers and claim results along the way; it starts with
    no budget set."""
    for name in ("DMLC_TPU_STORE_BUDGET_BYTES", "DMLC_TPU_STORE_JOB_BUDGET_BYTES"):
        monkeypatch.delenv(name, raising=False)
    answers = []
    for op, *a in ops:
        path = os.path.join(str(root), a[0]) if a and isinstance(a[0], str) else None
        if op == "publish":
            _publish(mgr, root, *a)
        elif op == "pin":
            mgr.store_for(path).pin(path)
        elif op == "drop":
            mgr.store_for(path).drop(path)
        elif op == "discard":
            mgr.store_for(path).discard(path)
        elif op == "claim":
            answers.append(mgr.store_for(path).claim(path, a[1]))
        elif op == "release":
            mgr.store_for(path).release(path, a[1])
        elif op == "claimant":
            answers.append(mgr.store_for(path).claimant(path))
        elif op == "missing":
            mgr.note_missing(path)
        elif op == "rm":
            os.remove(path)
        elif op == "budget":
            monkeypatch.setenv("DMLC_TPU_STORE_BUDGET_BYTES", str(a[0]))
        elif op == "job_budget":
            monkeypatch.setenv("DMLC_TPU_STORE_JOB_BUDGET_BYTES", str(a[0]))
        elif op == "reopen":
            mgr.reset_stores()
            mgr.store_for(os.path.join(str(root), "x"))
        elif op == "unbudget":
            monkeypatch.delenv("DMLC_TPU_STORE_BUDGET_BYTES", raising=False)
            monkeypatch.delenv("DMLC_TPU_STORE_JOB_BUDGET_BYTES", raising=False)
        else:
            raise AssertionError(op)
    return answers


SEQUENCES = {
    "publish_pin_drop": [
        ("publish", "a.snap", "snapshot", 256, {"s": 1}),
        ("publish", "b.bc", "block_cache", 512, {"b": [1, 2]}),
        ("pin", "a.snap"), ("pin", "a.snap"), ("drop", "a.snap"),
        ("publish", "c.cache", "chunk_cache", 1024),
        ("pin", "unknown.bin"), ("drop", "b.bc"),
    ],
    "republish_discard": [
        ("publish", "a.bc", "block_cache", 256, {"v": 1}),
        ("pin", "a.bc"),
        ("publish", "a.bc", "block_cache", 320, {"v": 2}),
        ("discard", "a.bc"), ("missing", "a.bc"),
        ("publish", "b.snap", "snapshot", 128),
        ("rm", "b.snap"), ("reopen",),
    ],
    "evict_rebuild": [
        ("publish", "s1.snap", "snapshot", 200),
        ("publish", "b1.bc", "block_cache", 300),
        ("publish", "s2.snap", "snapshot", 200),
        ("publish", "c1.cache", "chunk_cache", 400),
        ("pin", "s1.snap"), ("drop", "s1.snap"),
        ("budget", 900),
        ("publish", "b2.bc", "block_cache", 100),
        ("missing", "s2.snap"), ("missing", "s2.snap"), ("unbudget",),
        ("publish", "s2.snap", "snapshot", 200),
    ],
    "pinned_exempt": [
        ("publish", "s1.snap", "snapshot", 400),
        ("publish", "s2.snap", "snapshot", 400),
        ("publish", "b1.bc", "block_cache", 400),
        ("pin", "s1.snap"),
        ("budget", 1),
        ("publish", "c1.cache", "chunk_cache", 100),
        ("drop", "s1.snap"), ("reopen",),
    ],
    "job_budget": [
        ("publish", "j1a.bc", "block_cache", 300, None, "j1"),
        ("publish", "j2a.bc", "block_cache", 300, None, "j2"),
        ("publish", "j1b.snap", "snapshot", 300, None, "j1"),
        ("job_budget", 400),
        ("publish", "j1c.bc", "block_cache", 200, None, "j1"),
        ("unbudget",),
    ],
    "claims": [
        ("claim", "c.bc", "w1"), ("claim", "c.bc", "w1"), ("claim", "c.bc", "w2"),
        ("claimant", "c.bc"), ("release", "c.bc", "w2"), ("claimant", "c.bc"),
        ("release", "c.bc", "w1"), ("claim", "c.bc", "w2"),
        ("publish", "c.bc", "block_cache", 256), ("claimant", "c.bc"),
        ("claim", "d.bc", "w3"), ("reopen",), ("claimant", "d.bc"),
    ],
}


@pytest.mark.parametrize("seq", sorted(SEQUENCES))
def test_sequences_write_equal_manifests(tmp_path, monkeypatch, seq):
    out = {}
    for pkg, mgr in MGR.items():
        root = tmp_path / pkg
        root.mkdir()
        answers = _run(mgr, root, SEQUENCES[seq], monkeypatch)
        mgr.reset_stores()
        st = mgr.store_for(str(root / "x"))
        out[pkg] = (answers, _manifest(root), st.entries(), st.total_bytes(), _files(root))
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("seq", sorted(SEQUENCES))
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_manifest_replays_in_the_other_package(tmp_path, monkeypatch, seq, writer):
    _run(MGR[writer], tmp_path, SEQUENCES[seq], monkeypatch)
    monkeypatch.delenv("DMLC_TPU_STORE_BUDGET_BYTES", raising=False)
    MGR[writer].reset_stores()
    want = MGR[writer].store_for(str(tmp_path / "x"))
    got = MGR[OTHER[writer]].store_for(str(tmp_path / "x"))
    assert got.entries() == want.entries()
    assert got.total_bytes() == want.total_bytes()
    for name in [e["path"] for e in want.entries()] + ["c.bc", "d.bc"]:
        assert got.claimant(str(tmp_path / name)) == want.claimant(str(tmp_path / name))


def _layout(mgr, root):
    """Six artifacts of three tiers, one pinned, one touched since."""
    _publish(mgr, root, "s_old.snap", "snapshot", 300)
    _publish(mgr, root, "b_old.bc", "block_cache", 500)
    _publish(mgr, root, "s_new.snap", "snapshot", 300)
    _publish(mgr, root, "c.cache", "chunk_cache", 700)
    _publish(mgr, root, "b_new.bc", "block_cache", 500)
    _publish(mgr, root, "s_pin.snap", "snapshot", 300)
    st = mgr.store_for(str(root / "x"))
    st.pin(str(root / "s_old.snap"))  # a pin is a use: the LRU clock moves
    st.drop(str(root / "s_old.snap"))
    st.pin(str(root / "s_pin.snap"))
    return st


@pytest.mark.parametrize("budget", [2600, 2000, 1500, 900, 1])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_eviction_order_across_packages(tmp_path, monkeypatch, writer, budget):
    """One directory published by ``writer``, copied twice, squeezed by a
    publish of each package under the same budget: the same files go, in
    the same order, with the same manifest."""
    src = tmp_path / "src"
    src.mkdir()
    _layout(MGR[writer], src)
    out = {}
    monkeypatch.setenv("DMLC_TPU_STORE_BUDGET_BYTES", str(budget))
    for pkg, mgr in MGR.items():
        root = tmp_path / pkg
        shutil.copytree(src, root)
        base = resilience.counters_snapshot() if pkg == "port" else None
        _publish(mgr, root, "t.bc", "block_cache", 100)
        evicted = [e["path"] for e in _manifest(root) if e["op"] == "evict"]
        out[pkg] = (evicted, _files(root), _manifest(root))
        if pkg == "port":
            assert resilience.counters_delta(base).get("store_evictions", 0) == len(evicted)
    assert out["port"] == out["jax"]
    evicted = out["port"][0]
    assert "s_pin.snap" not in evicted and "t.bc" not in evicted
    tiers = [port_mgr.TIER_COST[("snapshot" if n.endswith(".snap") else "block_cache"
                                 if n.endswith(".bc") else "chunk_cache")] for n in evicted]
    assert tiers == sorted(tiers)  # cheapest to rebuild first
    if "s_old.snap" in evicted:
        assert evicted.index("s_new.snap") < evicted.index("s_old.snap")  # LRU


def test_eviction_reaches_the_decision_ledger(tmp_path, monkeypatch):
    telemetry.reset_decisions()
    _publish(port_mgr, tmp_path, "s.snap", "snapshot", 256)
    _publish(port_mgr, tmp_path, "a.bc", "block_cache", 512)
    total = port_mgr.store_for(str(tmp_path / "x")).total_bytes()
    monkeypatch.setenv("DMLC_TPU_STORE_BUDGET_BYTES", str(total - 1))
    port_mgr.reset_stores()
    port_mgr.store_for(str(tmp_path / "x"))  # open-time enforcement
    events = telemetry.decisions_snapshot("store")
    assert [e["action"] for e in events] == ["evict"]
    trig = events[0]["trigger"]
    assert trig == {"over_bytes": 1, "budget_bytes": total - 1, "tier": "snapshot", "bytes": 256}
    assert "s.snap" in events[0]["outcome"] and events[0]["root"] == str(tmp_path)
    assert telemetry.decision_counts()["store.evict"] == 1
    telemetry.reset_decisions()


@pytest.mark.parametrize("pinner", ["jax", "port"])
def test_dead_pid_pins_and_claims_are_dropped(tmp_path, monkeypatch, pinner):
    snap = _publish(port_mgr, tmp_path, "s.snap", "snapshot", 256)
    pkg = "dmlc_tpu" if pinner == "jax" else "dmlc_tpu_torch"
    code = ("import os, sys\n"
            "sys.path.insert(0, os.environ['REPO'])\n"
            f"from {pkg}.store import store_for\n"
            "st = store_for(os.environ['ART'])\n"
            "st.pin(os.environ['ART'])\n"
            "assert st.claim(os.environ['ART'] + '.next', 'gone')\n")
    env = dict(os.environ, REPO=REPO, ART=snap, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-c", code], env=env, check=True, timeout=120)
    for judge in ("jax", "port"):
        MGR[judge].reset_stores()
        st = MGR[judge].store_for(snap)
        assert st.entries()[0]["pinned"] is False
        assert st.claimant(snap + ".next") is None
        assert st.claim(snap + ".next", judge) is True
        st.release(snap + ".next", judge)
    # the pin of the dead pid cannot wedge the budget
    monkeypatch.setenv("DMLC_TPU_STORE_BUDGET_BYTES", "1")
    _publish(port_mgr, tmp_path, "t.bc", "block_cache", 64)
    assert not os.path.exists(snap)


SIGNATURES = [
    None,
    {"a": 1},
    {"b": [1, 2.5, None], "a": "x"},
    {"nested": {"z": [True, False], "y": {"k": 3}}},
    ["list", 1, 2],
    "plain-string",
]


@pytest.mark.parametrize("sig", range(len(SIGNATURES)))
def test_signature_hash_matches_reference(sig):
    s = SIGNATURES[sig]
    assert port_mgr.signature_hash(s) == jax_mgr.signature_hash(s)


def test_source_signature_hash_matches_reference(tmp_path):
    corpus = tmp_path / "c.libsvm"
    corpus.write_text("1 0:1\n0 1:2\n")
    kw = dict(format="libsvm", args={}, index_dtype="<u8", chunk_bytes=4096, split={})
    port = port_bc.source_signature(str(corpus), 0, 1, **kw)
    jax = jax_bc.source_signature(str(corpus), 0, 1, **kw)
    assert port_mgr.signature_hash(port) == jax_mgr.signature_hash(jax)


def test_constants_and_magics_match_reference():
    for name in ("TIERS", "TIER_COST", "MAGIC_TIERS", "COMPACT_LINES", "COMPACT_BYTES",
                 "STORE_DIRNAME", "MANIFEST_NAME", "LOCK_NAME"):
        assert getattr(port_mgr, name) == getattr(jax_mgr, name), name
    for magic, tier in jax_mgr.MAGIC_TIERS.items():
        assert port_mgr.tier_for_magic(magic) == jax_mgr.tier_for_magic(magic) == tier
    with pytest.raises(Exception, match="unknown container magic"):
        port_mgr.tier_for_magic(b"NOTMAGIC")
    from dmlc_tpu_torch import store

    import dmlc_tpu.store as jax_store
    assert store.__all__ == jax_store.__all__


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_compaction_replays_in_the_other_package(tmp_path, monkeypatch, pkg):
    """Past COMPACT_LINES the journal is rewritten as its live state; the
    compacted file is the same from either package and replays in both."""
    mgr = MGR[pkg]
    for m in MGR.values():
        monkeypatch.setattr(m, "COMPACT_LINES", 12)
    _publish(mgr, tmp_path, "a.bc", "block_cache", 256, {"a": 1}, "j1")
    _publish(mgr, tmp_path, "b.snap", "snapshot", 128)
    st = mgr.store_for(str(tmp_path / "a.bc"))
    for _ in range(6):
        st.pin(str(tmp_path / "a.bc"))
        st.drop(str(tmp_path / "a.bc"))
    st.pin(str(tmp_path / "b.snap"))
    st.claim(str(tmp_path / "c.cache"), "builder")
    monkeypatch.setenv("DMLC_TPU_STORE_BUDGET_BYTES", "200")
    _publish(mgr, tmp_path, "d.cache", "chunk_cache", 64)  # evicts a.bc
    monkeypatch.delenv("DMLC_TPU_STORE_BUDGET_BYTES")
    want = st.entries()
    lines = _manifest(tmp_path)
    assert len(lines) <= 12 or lines[0]["op"] == "publish"
    other = MGR[OTHER[pkg]]
    other.reset_stores()
    got = other.store_for(str(tmp_path / "x"))
    assert got.entries() == want
    assert got.claimant(str(tmp_path / "c.cache")) == "builder"
    assert [e for e in want if e["path"] == "a.bc"][0]["evicted"] is True


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_orphan_gc_and_stray_adoption_match(tmp_path, monkeypatch, pkg):
    """At open: a dead writer's old staging file goes, a live pid's and a
    fresh one stay, and a store-format file with no manifest is adopted;
    the other package's open of a copy does the same."""
    root = tmp_path / pkg
    root.mkdir()
    old = root / "a.bc.999999999.1.tmp"
    old.write_bytes(b"x")
    os.utime(old, (1, 1))
    live = root / f"b.bc.{os.getpid()}.3.tmp"
    live.write_bytes(b"x")
    os.utime(live, (1, 1))
    (root / "fresh.tmp").write_bytes(b"x")
    (root / "stray.snap").write_bytes(b"DMLCSN01" + bytes(56))
    (root / "other.txt").write_bytes(b"not an artifact")
    twin = tmp_path / "twin"
    shutil.copytree(root, twin)
    os.utime(twin / old.name, (1, 1))
    os.utime(twin / live.name, (1, 1))
    monkeypatch.setenv("DMLC_TPU_STORE_GC_AGE_SECONDS", "60")
    st = MGR[pkg].store_for(str(root / "x"))
    other = MGR[OTHER[pkg]].store_for(str(twin / "x"))
    assert _files(root) == _files(twin) == sorted(
        ["fresh.tmp", live.name, "other.txt", "stray.snap"])
    assert st.entries() == other.entries() == [
        {"path": "stray.snap", "tier": "snapshot", "bytes": 64, "sig": None,
         "pinned": False, "evicted": False, "job": None}]
    assert _manifest(root) == _manifest(twin)


def test_torn_tail_and_other_directories(tmp_path):
    _publish(port_mgr, tmp_path, "a.bc", "block_cache", 128)
    manifest = os.path.join(str(tmp_path), port_mgr.STORE_DIRNAME, port_mgr.MANIFEST_NAME)
    with open(manifest, "a") as f:
        f.write('{"op": "publish", "path": "torn')
    for mgr in MGR.values():
        mgr.reset_stores()
        assert [e["path"] for e in mgr.store_for(str(tmp_path / "x")).entries()] == ["a.bc"]
    sub = tmp_path / "sub"
    sub.mkdir()
    with pytest.raises(Exception, match="different directory"):
        port_mgr.store_for(str(tmp_path / "x")).pin(str(sub / "a.bc"))
    # the probe of an unmanaged directory creates nothing
    port_mgr.note_missing(str(sub / "gone.bc"))
    assert os.listdir(sub) == []


def test_three_threads_publish_and_pin_at_once(tmp_path):
    """The store's lock and the flock hold under publishes, pins and drops
    from three threads (the snapshot writer, the convert pool's block
    cache and the chunk cache's producer publish from three threads)."""
    errors = []

    def worker(k):
        try:
            for i in range(15):
                name = f"t{k}_{i}.bc"
                _publish(port_mgr, tmp_path, name, "block_cache", 64 + i)
                st = port_mgr.store_for(str(tmp_path / name))
                st.pin(str(tmp_path / name))
                st.drop(str(tmp_path / name))
        except BaseException as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors and not any(t.is_alive() for t in threads)
    lines = _manifest(tmp_path)
    assert len(lines) == 3 * 15 * 3
    want = sorted(f"t{k}_{i}.bc" for k in range(3) for i in range(15))
    for mgr in MGR.values():
        mgr.reset_stores()
        st = mgr.store_for(str(tmp_path / "x"))
        assert sorted(e["path"] for e in st.entries()) == want
        assert st.total_bytes() == 3 * sum(64 + i for i in range(15))


# ---------------- eviction heals through the port pipeline ----------------

N_ROWS = 600


def _corpus(tmp_path):
    path = tmp_path / "c.libsvm"
    with open(path, "w") as f:
        for i in range(N_ROWS):
            f.write(f"{i % 2} 0:{i}.0 1:{i}.5 3:1\n")
    return str(path)


def _rows(parser):
    out = []
    while (b := parser.next_block()) is not None:
        for i in range(len(b)):
            s, e = int(b.offset[i]), int(b.offset[i + 1])
            out.append((float(b.label[i]), tuple(b.index[s:e].tolist()),
                        tuple(np.asarray(b.value[s:e]).tolist())))
    return out


def _squeeze(tmp_path, monkeypatch, budget="1"):
    """Publish a small block cache under ``budget``: the squeeze."""
    monkeypatch.setenv("DMLC_TPU_STORE_BUDGET_BYTES", budget)
    w = port_bc.BlockCacheWriter(str(tmp_path / "squeeze.bc"), signature={"t": 1})
    w.add_block({"offset": np.arange(3, dtype=np.int64),
                 "label": np.zeros(2, np.float32)}, rows=2)
    w.finish()
    monkeypatch.delenv("DMLC_TPU_STORE_BUDGET_BYTES")


@pytest.mark.parametrize("evictor", ["jax", "port"])
def test_evicted_block_cache_rebuilds_byte_identical(tmp_path, monkeypatch, evictor):
    corpus, cache = _corpus(tmp_path), str(tmp_path / "c.bc")
    p = create_parser(corpus, 0, 1, "libsvm", threaded=False, chunk_bytes=4096,
                      block_cache=cache)
    reference = _rows(p)
    p.close()  # the reader's pin goes: the cache may be evicted
    with open(cache, "rb") as f:
        first = f.read()
    base = resilience.counters_snapshot()
    monkeypatch.setenv("DMLC_TPU_STORE_BUDGET_BYTES", "1")
    MGR[evictor].reset_stores()
    MGR[evictor].store_for(cache)  # open-time enforcement evicts it
    monkeypatch.delenv("DMLC_TPU_STORE_BUDGET_BYTES")
    assert not os.path.exists(cache)
    port_mgr.reset_stores()
    p2 = create_parser(corpus, 0, 1, "libsvm", threaded=False, chunk_bytes=4096,
                       block_cache=cache)
    assert p2.cache_state == "cold" and _rows(p2) == reference
    p2.close()
    with open(cache, "rb") as f:
        assert f.read() == first
    d = resilience.counters_delta(base)
    assert d.get("store_rebuilds_after_eviction", 0) == 1 and d.get("cache_invalidations", 0) == 0
    p3 = create_parser(corpus, 0, 1, "libsvm", threaded=False, chunk_bytes=4096,
                       block_cache=cache)
    assert _rows(p3) == reference and p3.cache_state == "warm"
    p3.close()


def test_warm_block_cache_pinned_through_a_squeeze(tmp_path, monkeypatch):
    corpus, cache = _corpus(tmp_path), str(tmp_path / "c.bc")
    p = create_parser(corpus, 0, 1, "libsvm", threaded=False, chunk_bytes=4096,
                      block_cache=cache)
    reference = _rows(p)
    p.close()
    p2 = create_parser(corpus, 0, 1, "libsvm", threaded=False, chunk_bytes=4096,
                       block_cache=cache)
    assert p2.cache_state == "warm"
    first = p2.next_block()  # mid-epoch: the reader's pin is live
    base = resilience.counters_snapshot()
    t = threading.Thread(target=_squeeze, args=(tmp_path, monkeypatch))
    t.start()
    t.join(60)
    assert os.path.exists(cache)
    rows = []
    for b in [first]:
        for i in range(len(b)):
            s, e = int(b.offset[i]), int(b.offset[i + 1])
            rows.append((float(b.label[i]), tuple(b.index[s:e].tolist()),
                         tuple(np.asarray(b.value[s:e]).tolist())))
    assert rows + _rows(p2) == reference
    p2.close()
    assert resilience.counters_delta(base).get("store_evictions", 0) == 0


def _snap_iter(corpus, snap, workers=2):
    return DeviceIter(create_parser(corpus, 0, 1, "libsvm", threaded=False, chunk_bytes=4096,
                                    snapshot=snap),
                      num_col=4, batch_size=64, layout="ell", max_nnz=4, device="cpu",
                      snapshot_read_workers=workers)


def _epoch(it, state=None):
    """One epoch's batches; ``state`` collects the snapshot state it ran in."""
    out = [tuple(t.clone() for t in (b.indices, b.values, b.label, b.weight)) for b in it]
    if state is not None:
        state.append(it.stats()["snapshot_state"])
    it.reset()
    return out


def _same(a, b):
    return len(a) == len(b) and all(all(bool((x == y).all()) for x, y in zip(p, q))
                                    for p, q in zip(a, b))


def test_evicted_snapshot_rebuilds_cold_byte_identical(tmp_path, monkeypatch):
    corpus, snap = _corpus(tmp_path), str(tmp_path / "c.snapshot")
    it = _snap_iter(corpus, snap)
    states = []
    cold = _epoch(it, states)
    warm = _epoch(it, states)
    assert states == ["cold", "warm"] and _same(cold, warm)
    it.close()  # the reader's pin goes
    with open(snap, "rb") as f:
        first = f.read()
    base = resilience.counters_snapshot()
    _squeeze(tmp_path, monkeypatch)
    assert not os.path.exists(snap)
    it2 = _snap_iter(corpus, snap)
    states = []
    assert _same(_epoch(it2, states), cold)
    with open(snap, "rb") as f:
        assert f.read() == first
    assert _same(_epoch(it2, states), cold) and states == ["cold", "warm"]
    stats = it2.stats()["store"]
    it2.close()
    d = resilience.counters_delta(base)
    assert d.get("store_evictions", 0) == 1 and d.get("store_rebuilds_after_eviction", 0) == 1
    assert d.get("snapshot_invalidations", 0) == 0
    assert stats["store_evictions"] >= 1 and stats["store_rebuilds_after_eviction"] >= 1
    assert stats["store_bytes"] >= os.path.getsize(snap)


def test_warm_snapshot_epoch_pinned_through_a_squeeze(tmp_path, monkeypatch):
    """Two read workers mmap the snapshot; a squeeze published from another
    thread after the first warm batch evicts nothing it pins, and the
    epoch's batches equal an unsqueezed warm epoch's."""
    corpus, snap = _corpus(tmp_path), str(tmp_path / "c.snapshot")
    it = _snap_iter(corpus, snap)
    cold = _epoch(it)
    base = resilience.counters_snapshot()
    got = []
    for i, b in enumerate(it):
        got.append(tuple(t.clone() for t in (b.indices, b.values, b.label, b.weight)))
        if i == 1:
            t = threading.Thread(target=_squeeze, args=(tmp_path, monkeypatch))
            t.start()
            t.join(60)
            assert os.path.exists(snap)
    it.reset()
    assert _same(got, cold)
    assert resilience.counters_delta(base).get("store_evictions", 0) == 0
    it.close()
    # after the pool's teardown the pin is gone: the next squeeze may evict
    _squeeze(tmp_path, monkeypatch)
    assert not os.path.exists(snap)


def test_evicted_chunk_cache_rebuilds_byte_identical(tmp_path, monkeypatch):
    lines = [f"row-{i}".encode() for i in range(400)]
    src = tmp_path / "data.txt"
    src.write_bytes(b"\n".join(lines) + b"\n")
    cache = tmp_path / "chunks.cache"
    uri = f"{src}#{cache}"
    split = create_input_split(uri, 0, 1, "text", chunk_bytes=4096)
    assert [bytes(r) for r in split.iter_records()] == lines
    split.close()
    first = cache.read_bytes()
    st = port_mgr.store_for(str(cache))
    assert [e["tier"] for e in st.entries() if e["path"] == cache.name] == ["chunk_cache"]
    base = resilience.counters_snapshot()
    _squeeze(tmp_path, monkeypatch)
    assert not cache.exists()
    split2 = create_input_split(uri, 0, 1, "text", chunk_bytes=4096)
    assert [bytes(r) for r in split2.iter_records()] == lines
    split2.close()
    assert cache.read_bytes() == first
    d = resilience.counters_delta(base)
    assert d.get("store_evictions", 0) == 1 and d.get("store_rebuilds_after_eviction", 0) == 1


@pytest.mark.parametrize("what", ["block_cache", "snapshot"])
def test_invalidation_is_not_an_eviction(tmp_path, what):
    base = resilience.counters_snapshot()
    if what == "block_cache":
        path = str(tmp_path / "c.bc")
        w = port_bc.BlockCacheWriter(path, signature={"tag": "old"})
        w.add_block({"offset": np.arange(3, dtype=np.int64),
                     "label": np.zeros(2, np.float32)}, rows=2)
        w.finish()
        assert port_bc.open_block_cache(path, signature={"tag": "new"}) is None
        assert port_bc.open_block_cache(path, signature={"tag": "new"}) is None
        event = "cache_invalidations"
    else:
        path = str(tmp_path / "c.snap")
        w = port_snapshot.SnapshotWriter(path, signature={"tag": "old"}, geometry={"b": 4})
        w.add_batch("dense_packed", (np.zeros((4, 5), np.float32),), rows=4)
        w.finish()
        assert port_snapshot.open_snapshot(path, geometry={"b": 8}) is None
        assert port_snapshot.open_snapshot(path, geometry={"b": 8}) is None
        event = "snapshot_invalidations"
    assert not os.path.exists(path)
    d = resilience.counters_delta(base)
    assert d.get(event, 0) == 1 and d.get("store_rebuilds_after_eviction", 0) == 0
    assert d.get("store_evictions", 0) == 0
    st = port_mgr.store_for(path)
    assert st.entries() == [] and _manifest(tmp_path)[-1] == {"op": "remove",
                                                              "path": os.path.basename(path)}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cross_package_publish_is_evicted_by_the_other(tmp_path, monkeypatch, writer):
    """A block cache and a snapshot published by one package's writers
    under one directory; the other package's publish under a budget evicts
    the snapshot first, as its own would."""
    bc_mod = jax_bc if writer == "jax" else port_bc
    snap_mod = jax_snapshot if writer == "jax" else port_snapshot
    w = bc_mod.BlockCacheWriter(str(tmp_path / "a.bc"), signature={"t": 1})
    w.add_block({"offset": np.arange(65, dtype=np.int64),
                 "label": np.zeros(64, np.float32)}, rows=64)
    w.finish()
    s = snap_mod.SnapshotWriter(str(tmp_path / "s.snap"), signature={"t": 1},
                                geometry={"b": 64})
    s.add_batch("dense_packed", (np.zeros((64, 4), np.float32),), rows=64)
    s.finish()
    total = MGR[writer].store_for(str(tmp_path / "x")).total_bytes()
    assert total == os.path.getsize(tmp_path / "a.bc") + os.path.getsize(tmp_path / "s.snap")
    monkeypatch.setenv("DMLC_TPU_STORE_BUDGET_BYTES", str(total))
    _publish(MGR[OTHER[writer]], tmp_path, "t.cache", "chunk_cache", 64)
    assert not (tmp_path / "s.snap").exists() and (tmp_path / "a.bc").exists()
