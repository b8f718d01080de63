"""The port's fault-injection seam (``dmlc_tpu_torch/io/faults.py``) against
the JAX package's ``io/faults.py``.

- the clause grammar ``op[~substr]@N[..M|+][=error]``: a single
  occurrence, a range, ``N+``, ``~substr`` and the default ``http-503``;
- every error class, its type and message equal to JAX's; ``corrupt``
  builds the port's ``CacheCorruptionError``, which the port's
  ``classify`` names retryable; bad clauses raise JAX's messages;
- ``inject`` nests and restores; the ``DMLC_FAULT_PLAN`` hook re-parses
  when the value changes; one package's plan never fires in the other;
- seeded call sequences through both packages' plans give the same firing
  schedule;
- one case per seam: each of the JAX package's nine ``maybe_fail`` calls
  (``RetryPolicy.call``'s ``connect`` and its op, the block cache's and
  the chunk cache's ``cache_read``, the snapshot's ``snapshot_read`` in
  ``load_batch`` and ``batch_span``, ``dispatch_rpc``, ``worker_rpc``,
  ``preempt``) reached through the public entry point under a plan whose
  ``~substr`` names the subject: the op labels and subjects the seam saw,
  ``fired()`` and the counter deltas equal the JAX package's;
- the warm span route (``device_decode=True``) under ``snapshot_read``
  faults at 1 and 2 read workers, and the convert pool under ``read``
  faults on an ``http://`` source: every staging slot back after a heal
  and after a give-up, and the next epoch runs (``data/device.py``);
- fault C17: ``create_parser`` over a remote source without a cache makes
  no metadata request of its own, so ``open@1=http-403`` fails the epoch
  as in the JAX package.
"""

import http.server
import threading
import time
import types
import urllib.error

import numpy as np
import pytest
import torch

from dmlc_tpu.data import create_parser as jax_create_parser
from dmlc_tpu.data.device import DeviceIter as JaxDeviceIter
from dmlc_tpu.io import create_input_split as jax_create_input_split
from dmlc_tpu.io import faults as jax_faults
from dmlc_tpu.io import http_filesys as jax_http
from dmlc_tpu.io import read_all as jax_read_all
from dmlc_tpu.io import resilience as jax_res
from dmlc_tpu.service import client as jax_client
from dmlc_tpu.service import fleet as jax_fleet
from dmlc_tpu.store import manager as jax_mgr
from dmlc_tpu.utils import telemetry as jax_telemetry
from dmlc_tpu.utils.check import CacheCorruptionError as JaxCacheCorruptionError
from dmlc_tpu.utils.check import DMLCError as JaxDMLCError
from dmlc_tpu_torch.data import DeviceIter, create_parser
from dmlc_tpu_torch.io import create_input_split
from dmlc_tpu_torch.io import faults as port_faults
from dmlc_tpu_torch.io import http_filesys as port_http
from dmlc_tpu_torch.io import read_all as port_read_all
from dmlc_tpu_torch.io import resilience as port_res
from dmlc_tpu_torch.service import client as port_client
from dmlc_tpu_torch.service import fleet as port_fleet
from dmlc_tpu_torch.store import manager as port_mgr
from dmlc_tpu_torch.utils import telemetry as port_telemetry
from dmlc_tpu_torch.utils.check import CacheCorruptionError, DMLCError

from test_resilience import _HttpFilesHandler, _make_libsvm  # noqa: E402


def _port_iter(parser, **kw):
    return DeviceIter(parser, device="cpu", **kw)


PKGS = {
    "ref": types.SimpleNamespace(
        faults=jax_faults, res=jax_res, http=jax_http, read_all=jax_read_all,
        create_parser=jax_create_parser, device_iter=JaxDeviceIter,
        create_input_split=jax_create_input_split, LocalFleet=jax_fleet.LocalFleet,
        ServiceParser=jax_client.ServiceParser, err=JaxDMLCError,
        corrupt=JaxCacheCorruptionError, mgr=jax_mgr, telemetry=jax_telemetry),
    "port": types.SimpleNamespace(
        faults=port_faults, res=port_res, http=port_http, read_all=port_read_all,
        create_parser=create_parser, device_iter=_port_iter,
        create_input_split=create_input_split, LocalFleet=port_fleet.LocalFleet,
        ServiceParser=port_client.ServiceParser, err=DMLCError,
        corrupt=CacheCorruptionError, mgr=port_mgr, telemetry=port_telemetry),
}

ERROR_CLASSES = ["http-503", "http-429", "http-403", "reset", "timeout", "unreachable",
                 "corrupt", "conn", "torn"]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Fast retries, no plan and fresh counters and stores in both packages;
    the fused native reader stays on, as in the JAX package's suites."""
    monkeypatch.setenv("DMLC_RETRY_BASE_MS", "1")
    monkeypatch.setenv("DMLC_RETRY_MAX_MS", "5")
    for var in ("DMLC_RETRY_MAX_ATTEMPTS", "DMLC_FAULT_PLAN", "DMLC_TPU_PREEMPTION_NOTICE",
                "DMLC_TPU_PARSE_WORKERS", "DMLC_TPU_DEVICE_DECODE", "DMLC_TPU_BLOCK_CACHE"):
        monkeypatch.delenv(var, raising=False)
    for p in PKGS.values():
        p.faults.reset()
        p.res.reset_counters()
        p.mgr.reset_stores()
    yield
    for p in PKGS.values():
        p.faults.reset()
        p.mgr.reset_stores()


# ---------------- the plan ----------------

@pytest.mark.parametrize("pkg", list(PKGS))
def test_grammar_single_range_open_ended_substr_default(pkg):
    f = PKGS[pkg].faults
    plan = f.FaultPlan("read@2; open@1..3=reset ;connect@5+=timeout;write~part-1@1")
    assert [plan.check("read") is not None for _ in range(4)] == [False, True, False, False]
    assert [type(plan.check("open")) for _ in range(4)] == [ConnectionResetError] * 3 + [type(None)]
    assert [plan.check("connect") is not None for _ in range(7)] == [False] * 4 + [True] * 3
    assert plan.check("write", "http://h/part-0") is None
    exc = plan.check("write", "http://h/part-1")
    assert isinstance(exc, urllib.error.HTTPError) and exc.code == 503  # the default class
    assert plan.check("write", "http://h/part-1") is None
    assert plan.fired() == 1 + 3 + 3 + 1
    assert f.FaultPlan("").fired() == 0 and f.FaultPlan(" ; ;").check("read") is None


def _describe(exc) -> tuple:
    if isinstance(exc, urllib.error.HTTPError):
        return ("HTTPError", exc.code, exc.filename, exc.msg, str(exc))
    return (type(exc).__name__, getattr(exc, "errno", None), str(exc))


@pytest.mark.parametrize("err", ERROR_CLASSES)
def test_error_classes_equal_the_reference(err):
    got = {}
    for name, p in PKGS.items():
        exc = p.faults.FaultPlan(f"op@1={err}").check("op", "s3://b/k")
        kind = p.res.classify(exc)
        got[name] = (_describe(exc), kind)
        if err == "corrupt":
            # each package's own class, so its own classify and heal paths see it
            assert isinstance(exc, p.corrupt)
            assert not isinstance(exc, PKGS["port" if name == "ref" else "ref"].corrupt)
    assert got["port"] == got["ref"]
    want = "fatal" if err == "http-403" else "retryable"
    assert got["port"][1] == want


def test_corrupt_is_the_ports_cache_corruption_and_retryable():
    exc = port_faults.FaultPlan("cache_read@1=corrupt").check("cache_read", "/c.bc")
    assert isinstance(exc, CacheCorruptionError) and isinstance(exc, DMLCError)
    assert str(exc) == "injected cache corruption: /c.bc"
    assert port_res.classify(exc) == port_res.RETRYABLE
    # an empty subject names the fault URI, as in the JAX package
    assert str(port_faults.FaultPlan("x@1=corrupt").check("x")) == \
        "injected cache corruption: fault://injected"


@pytest.mark.parametrize("spec", ["read@@2", "read", "@1", "read@x", "read@1..", "read@1=",
                                  "read@1=kaboom", "read@1=http-", "read@1..2=nope;open@1",
                                  "r ead@1"])
def test_bad_clauses_raise_the_reference_messages(spec):
    msgs = {}
    for name, p in PKGS.items():
        with pytest.raises(Exception) as ei:
            p.faults.FaultPlan(spec)
        # a bad code after "http-" is int()'s ValueError in both packages
        assert isinstance(ei.value, ValueError if spec == "read@1=http-" else p.err)
        msgs[name] = (type(ei.value).__name__, str(ei.value))
    assert msgs["port"] == msgs["ref"]


def test_inject_nests_restores_and_takes_a_plan_or_a_spec():
    f = port_faults
    assert f.active_plan() is None
    given = f.FaultPlan("read@1")
    with f.inject(given) as outer:
        assert outer is given and f.active_plan() is given
        with f.inject("open@1=timeout") as inner:
            assert isinstance(inner, f.FaultPlan) and f.active_plan() is inner
            with pytest.raises(TimeoutError):
                f.maybe_fail("open", "u")
        assert f.active_plan() is given
        with pytest.raises(RuntimeError):
            with f.inject("write@1"):
                raise RuntimeError("the block failed")
        assert f.active_plan() is given  # restored on an exception too
    assert f.active_plan() is None
    f.maybe_fail("read", "u")  # no plan: a no-op


def test_env_hook_reparses_when_the_value_changes(monkeypatch):
    f = port_faults
    monkeypatch.setenv("DMLC_FAULT_PLAN", "read@1=reset")
    first = f.active_plan()
    assert first is f.active_plan()  # cached while the value stands
    with pytest.raises(ConnectionResetError):
        f.maybe_fail("read", "x")
    f.maybe_fail("read", "x")
    monkeypatch.setenv("DMLC_FAULT_PLAN", "read@1=reset")  # same value: same counts
    f.maybe_fail("read", "x")
    monkeypatch.setenv("DMLC_FAULT_PLAN", "open@1=timeout")
    assert f.active_plan() is not first
    with pytest.raises(TimeoutError):
        f.maybe_fail("open", "y")
    with f.inject("open@1=reset"):  # an inject plan shadows the env plan
        with pytest.raises(ConnectionResetError):
            f.maybe_fail("open", "y")
    monkeypatch.delenv("DMLC_FAULT_PLAN")
    assert f.active_plan() is None
    f.maybe_fail("open", "y")
    f.reset()
    assert f.active_plan() is None


def test_one_packages_plan_never_fires_in_the_other():
    with jax_faults.inject("read@1+=reset"):
        port_faults.maybe_fail("read", "u")
        assert port_faults.active_plan() is None
    with port_faults.inject("read@1+=reset") as plan:
        jax_faults.maybe_fail("read", "u")
        with pytest.raises(ConnectionResetError):
            port_faults.maybe_fail("read", "u")
    assert plan.fired() == 1


@pytest.mark.parametrize("seed", range(6))
def test_seeded_call_sequences_fire_on_the_same_schedule(seed):
    rng = np.random.default_rng(seed)
    ops, subjects = ["read", "open", "connect", "cache_read"], ["a/part-0", "a/part-1", "b/x"]
    clauses = []
    for _ in range(int(rng.integers(1, 5))):
        op = ops[rng.integers(len(ops))]
        sub = f"~part-{rng.integers(2)}" if rng.random() < 0.4 else ""
        lo = int(rng.integers(1, 6))
        occ = [f"{lo}", f"{lo}..{lo + int(rng.integers(0, 4))}", f"{lo}+"][rng.integers(3)]
        err = "" if rng.random() < 0.3 else "=" + ERROR_CLASSES[rng.integers(len(ERROR_CLASSES))]
        clauses.append(f"{op}{sub}@{occ}{err}")
    spec = ";".join(clauses)
    calls = [(ops[rng.integers(len(ops))], subjects[rng.integers(len(subjects))])
             for _ in range(200)]
    schedules = {}
    for name, p in PKGS.items():
        plan = p.faults.FaultPlan(spec)
        schedules[name] = ([None if (e := plan.check(op, what)) is None else _describe(e)
                            for op, what in calls], plan.fired())
    assert schedules["port"] == schedules["ref"], spec
    assert schedules["port"][1] == sum(e is not None for e in schedules["port"][0])


def test_thread_safe_counts():
    plan = port_faults.FaultPlan("read@1+=reset;open@101..200")
    n = {"fired": 0}
    lock = threading.Lock()

    def hammer():
        for _ in range(100):
            if plan.check("read") is not None:
                with lock:
                    n["fired"] += 1
            plan.check("open")

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert n["fired"] == 400 and plan.fired() == 400 + 100


# ---------------- one case per seam ----------------

def _recording(p, spec):
    """The package's plan for ``spec`` that also logs every ``(op, subject)``
    the seam saw."""
    class Recording(p.faults.FaultPlan):
        def __init__(self, s):
            super().__init__(s)
            self.seen = []

        def check(self, op, what=""):
            self.seen.append((op, what))
            return super().check(op, what)

    return Recording(spec)


def _subjects(plan, op, *replace) -> set:
    out = set()
    for o, what in plan.seen:
        if o == op:
            for a, b in replace:
                what = what.replace(a, b)
            out.add(what)
    return out


def _delta(p, base, scope=None) -> dict:
    return {k: v for k, v in p.res.counters_delta(base, scope).items() if v}


# the test thread's own events: process-wide counters also pick up other
# tests' lingering fleet threads under load
SCOPE = "faults-test"


@pytest.fixture()
def http_files():
    _HttpFilesHandler.files = {}
    _HttpFilesHandler.flaky_503 = 0
    _HttpFilesHandler.flaky_429 = 0
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _HttpFilesHandler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield _HttpFilesHandler, f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()


@pytest.mark.parametrize("op,err,want", [
    ("connect", "reset", {"attempts": 3, "retries": 1}),
    ("open", "http-503", {"attempts": 3, "retries": 1}),
    ("read", "timeout", {"attempts": 3, "retries": 1}),
])
def test_seam_retry_policy_call(http_files, op, err, want):
    """Seams 1 and 2, ``RetryPolicy.call``: ``connect`` on every attempt and
    the call's own op, subject the URL, through ``read_all``."""
    handler, base = http_files
    payload = bytes(range(256)) * 40
    handler.files["/seam.bin"] = payload
    url = f"{base}/seam.bin"
    got = {}
    for name, p in PKGS.items():
        plan = _recording(p, f"{op}~/seam.bin@1={err}")
        b = p.res.counters_snapshot(SCOPE)
        with p.faults.inject(plan), p.telemetry.scope(SCOPE):
            assert p.read_all(url) == payload
        got[name] = (plan.fired(), _delta(p, b, SCOPE), _subjects(plan, op),
                     _subjects(plan, "connect"))
    assert got["port"] == got["ref"]
    assert got["port"][:3] == (1, want, {url})


def _libsvm(path, n=600, d=5, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as fh:
        for i in range(n):
            fh.write(f"{i % 2} " + " ".join(f"{j}:{rng.normal():.5f}" for j in range(d)) + "\n")
    return str(path)


def _block_arrays(parser) -> list:
    out = []
    while (blk := parser.next_block()) is not None:
        out.append(tuple(None if a is None else np.asarray(a).tobytes()
                         for a in (blk.offset, blk.label, blk.index, blk.value)))
    return out


def test_seam_block_cache_read(tmp_path, monkeypatch):
    """Seam 3, ``BlockCacheReader.load_segments``: ``cache_read`` with the
    cache's path, healed by a rebuild with the stream unchanged."""
    monkeypatch.setenv("DMLC_TPU_NO_NATIVE_READER", "1")
    got = {}
    for name, p in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        path, cache = _libsvm(d / "c.libsvm"), str(d / "c.bc")
        parser = p.create_parser(path, 0, 1, "libsvm", chunk_bytes=2048, block_cache=cache)
        want = _block_arrays(parser)
        parser.before_first()
        plan = _recording(p, "cache_read~c.bc@2=corrupt")
        b = p.res.counters_snapshot()
        with p.faults.inject(plan):
            healed = _block_arrays(parser)
        parser.close()
        assert healed == want
        got[name] = (healed, plan.fired(), _delta(p, b),
                     _subjects(plan, "cache_read", (str(d), "D")))
    assert got["port"] == got["ref"]
    assert got["port"][1:] == (1, {"cache_corruptions": 1, "cache_rebuilds": 1}, {"D/c.bc"})


def test_seam_chunk_cache_read(tmp_path):
    """Seam 4, the chunk cache's warm frame loop: ``cache_read`` once a
    frame with the cache file's path, healed from the source."""
    got = {}
    for name, p in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        path = d / "c.txt"
        path.write_bytes(b"".join(b"line %d\n" % i for i in range(1500)))
        cache = str(d / "chunks.cache")
        uri, kw = f"{path}#{cache}", {"chunk_bytes": 2048}
        split = p.create_input_split(uri, 0, 1, "text", **kw)
        want = _records(split)
        split.close()
        plan = _recording(p, "cache_read~chunks.cache@3=corrupt")
        b = p.res.counters_snapshot()
        with p.faults.inject(plan):
            split = p.create_input_split(uri, 0, 1, "text", **kw)
            healed = _records(split)
            split.close()
        assert healed == want
        frames = sum(1 for o, _ in plan.seen if o == "cache_read")
        got[name] = (healed, plan.fired(), _delta(p, b),
                     _subjects(plan, "cache_read", (str(d), "D")), frames)
    assert got["port"] == got["ref"]
    assert got["port"][1:4] == (1, {"cache_corruptions": 1, "cache_rebuilds": 1},
                                {"D/chunks.cache"})
    assert got["port"][4] == 3  # the third frame's read met the fault


def _records(split) -> list:
    out = []
    while (rec := split.next_record()) is not None:
        out.append(bytes(rec))
    return out


NUM_COL, BATCH, ROWS = 6, 64, 640


def _snap_iter(p, corpus, snap, **kw):
    return p.device_iter(p.create_parser(corpus, 0, 1, "libsvm", snapshot=snap),
                         num_col=NUM_COL, batch_size=BATCH, **kw)


def _tensor_bytes(a) -> bytes:
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        return a.contiguous().numpy().tobytes()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.view(np.int16)
    return a.tobytes()


def _batch_bytes(batch):
    arrays = [batch.packed, *batch] if hasattr(batch, "packed") else list(batch)
    return [_tensor_bytes(a) for a in arrays]


def _events(stats) -> dict:
    return {k: v for k, v in stats["resilience"].items() if v}


def _slots_back(it) -> bool:
    """Every staging slot of every ring free, each once."""
    return all(sorted(map(id, r._free)) == sorted(map(id, r._slots))
               for r in it._rings.values())


def _warm_epochs(p, tmp_path, name, plan_spec, workers, layout_kw, device_decode):
    d = tmp_path / name
    d.mkdir()
    corpus = _libsvm(d / "c.libsvm", n=ROWS, d=NUM_COL, seed=3)
    snap = str(d / "c.snapshot")
    it = _snap_iter(p, corpus, snap, snapshot_read_workers=workers,
                    device_decode=device_decode, **layout_kw)
    cold = [_batch_bytes(b) for b in it]
    it.reset()
    clean = [_batch_bytes(b) for b in it]  # the clean warm epoch
    it.reset()
    plan = _recording(p, plan_spec)
    b = p.res.counters_snapshot()
    with p.faults.inject(plan):
        try:
            healed = [_batch_bytes(b) for b in it]
            raised = None
        except Exception as exc:  # noqa: BLE001 - compared below
            healed, raised = None, type(exc).__name__
    return it, corpus, cold, clean, healed, raised, plan, _events(it.stats()), _delta(p, b), d


@pytest.mark.parametrize("device_decode", [False, True], ids=["load_batch", "batch_span"])
def test_seam_snapshot_read(tmp_path, device_decode):
    """Seams 5 and 6, ``SnapshotReader.load_batch`` and ``batch_span``:
    ``snapshot_read`` with the snapshot's path, healed cold with JAX's
    events."""
    got = {}
    for name, p in PKGS.items():
        it, _, cold, clean, healed, raised, plan, events, _, d = _warm_epochs(
            p, tmp_path, name, "snapshot_read~c.snapshot@3=corrupt", 1,
            dict(layout="ell", max_nnz=NUM_COL), device_decode)
        it.close()
        assert raised is None and healed == clean == cold
        got[name] = (healed, plan.fired(), events,
                     _subjects(plan, "snapshot_read", (str(d), "D")))
    assert got["port"] == got["ref"]
    assert got["port"][1:] == (1, {"pipeline_restarts": 1, "snapshot_corruptions": 1},
                               {"D/c.snapshot"})


SERVICE_PARSER = {"format": "libsvm", "threaded": False, "chunk_bytes": 16384}
FLEET_KW = dict(num_workers=2, parser=SERVICE_PARSER, poll_interval=0.02,
                heartbeat_interval=0.1, liveness_timeout=5.0)


def _service_drain(p, address) -> list:
    sp = p.ServiceParser(address)
    try:
        return _block_arrays(sp)
    finally:
        sp.close()


@pytest.mark.parametrize("spec,op,counter", [
    ("dispatch_rpc~locate@1=conn", "dispatch_rpc", "control_plane_retries"),
    ("worker_rpc~stream part 1@1=torn", "worker_rpc", "service_retries"),
])
def test_seam_service_client(tmp_path, spec, op, counter):
    """Seams 7 and 8, ``service.dispatcher.request`` (``dispatch_rpc``,
    subject ``"<address> <cmd>"``) and the client's part-stream locate
    (``worker_rpc``, subject ``"<worker> stream part <n>"``), each healed
    with one retry."""
    corpus = _libsvm(tmp_path / "c.libsvm", n=3000, d=6)
    got = {}
    for name, p in PKGS.items():
        fleet = p.LocalFleet(corpus, 3, **FLEET_KW)
        try:
            wids = {w.worker_id: f"W{i}" for i, w in enumerate(fleet.workers)}
            plan = _recording(p, spec)
            b = p.res.counters_snapshot(SCOPE)
            with p.faults.inject(plan), p.telemetry.scope(SCOPE):
                blocks = _service_drain(p, fleet.address)
            subjects = {s for s in _subjects(plan, op, (fleet.address, "A"))
                        if spec.split("~")[1].split("@")[0] in s}
            for wid, tag in wids.items():
                subjects = {s.replace(wid, "W") for s in subjects}
            got[name] = (blocks, plan.fired(), p.res.counters_delta(b, SCOPE)[counter],
                         subjects)
        finally:
            fleet.close()
    assert got["port"] == got["ref"]
    want = {"A locate"} if op == "dispatch_rpc" else {"W stream part 1"}
    assert got["port"][1:] == (1, 1, want)


def test_seam_worker_preempt(tmp_path):
    """Seam 9, ``ParseWorker._check_preemption``: ``preempt`` with the
    worker's id, whatever the error class consumed as a notice; the
    named worker drains and the other serves the epoch."""
    corpus = _libsvm(tmp_path / "c.libsvm", n=3000, d=6)
    got = {}
    for name, p in PKGS.items():
        fleet = p.LocalFleet(corpus, 3, num_workers=2, parser=SERVICE_PARSER,
                             poll_interval=0.02, heartbeat_interval=0.05,
                             liveness_timeout=5.0)
        try:
            target = fleet.workers[1].worker_id
            plan = _recording(p, f"preempt~{target}@1=torn")
            b = p.res.counters_snapshot()
            with p.faults.inject(plan):
                deadline = time.monotonic() + 8.0
                while p.res.counters_delta(b)["worker_drains"] < 1:
                    assert time.monotonic() < deadline, "no injected preemption drain"
                    time.sleep(0.02)
            d = p.res.counters_delta(b)
            blocks = _service_drain(p, fleet.address)
            seen = {w for o, w in plan.seen if o == "preempt"}
            # a drain that completes while its worker re-announces it counts
            # twice now and then, in both packages (ROADMAP "Records")
            assert d["worker_drains"] >= 1
            got[name] = (blocks, plan.fired(), d["preemption_notices"],
                         [w.draining for w in fleet.workers],
                         seen <= {w.worker_id for w in fleet.workers} and target in seen)
        finally:
            fleet.close()
    assert got["port"] == got["ref"]
    assert got["port"][1:] == (1, 1, [False, True], True)


# ---------------- the staging ring under faults (data/device.py) ----------------

@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("case", ["ell", "dense_bf16"])
def test_span_route_fault_heals_and_every_slot_comes_back(tmp_path, workers, case):
    """K2's warm span route under ``snapshot_read@5=corrupt``: the batches
    equal the clean warm epoch and the JAX package's, the events equal
    JAX's, every staging slot is free once the epoch ends, and a further
    epoch on the same iterator completes (cold, then warm again)."""
    layout_kw = (dict(layout="ell", max_nnz=NUM_COL) if case == "ell"
                 else dict(layout="dense", x_dtype="bfloat16", pack_aux=True))
    got = {}
    for name, p in PKGS.items():
        it, _, cold, clean, healed, raised, plan, events, _, _ = _warm_epochs(
            p, tmp_path, name, "snapshot_read@5=corrupt", workers, layout_kw, True)
        try:
            assert raised is None and healed == clean
            if name == "port":
                assert _slots_back(it)
            it.reset()
            assert [_batch_bytes(b) for b in it] == cold  # cold: the file was dropped
            it.reset()
            assert [_batch_bytes(b) for b in it] == cold  # warm again
            if name == "port":
                assert _slots_back(it)
            got[name] = (healed, plan.fired(), events)
        finally:
            it.close()
    assert got["port"] == got["ref"]
    assert got["port"][1:] == (1, {"pipeline_restarts": 1, "snapshot_corruptions": 1})


@pytest.mark.parametrize("workers", [1, 2])
def test_span_route_give_up_returns_every_slot(tmp_path, monkeypatch, workers):
    """With ``DMLC_RETRY_MAX_ATTEMPTS=1`` the same plan raises in both
    packages; every slot is back after ``reset`` and the next epoch runs."""
    monkeypatch.setenv("DMLC_RETRY_MAX_ATTEMPTS", "1")
    got = {}
    for name, p in PKGS.items():
        it, _, cold, clean, healed, raised, plan, events, _, _ = _warm_epochs(
            p, tmp_path, name, "snapshot_read@5=corrupt", workers,
            dict(layout="ell", max_nnz=NUM_COL), True)
        try:
            it.reset()
            if name == "port":
                assert _slots_back(it)
            assert [_batch_bytes(b) for b in it] == cold
            got[name] = (raised, plan.fired(), events)
        finally:
            it.close()
    assert got["port"] == got["ref"]
    assert got["port"] == ("CacheCorruptionError", 1,
                           {"pipeline_giveups": 1, "snapshot_corruptions": 1})


@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("spec,attempts", [("read@2..3=http-503", None),
                                           ("read@2..7=http-503", "3"),
                                           ("read@2..9=http-503", "2")])
def test_convert_pool_read_fault_returns_every_slot(http_files, monkeypatch, workers, spec,
                                                    attempts):
    """The convert pool over an ``http://`` source under ``read`` faults: a
    heal below the pool, a heal by pipeline restarts, and a give-up. The
    batches and events equal the JAX package's; every slot is back and the
    next epoch runs."""
    if attempts is not None:
        monkeypatch.setenv("DMLC_RETRY_MAX_ATTEMPTS", attempts)
    for p in PKGS.values():
        monkeypatch.setattr(p.http, "_BLOCK", 2048)
    handler, base = http_files
    handler.files["/corpus.libsvm"] = _make_libsvm()
    url = f"{base}/corpus.libsvm"
    got = {}
    for name, p in PKGS.items():
        def epoch(it):
            return [_batch_bytes(b) for b in it]

        it = p.device_iter(p.create_parser(url, 0, 1, "libsvm", chunk_bytes=2048),
                           num_col=4, batch_size=64, layout="ell", max_nnz=4,
                           convert_workers=workers)
        try:
            clean = epoch(it)
            it.reset()
            with p.faults.inject(spec) as plan:
                try:
                    faulted, raised = epoch(it), None
                except Exception as exc:  # noqa: BLE001 - compared below
                    faulted, raised = None, type(exc).__name__
            events = _events(it.stats())
            it.reset()
            if name == "port":
                assert _slots_back(it)
            assert epoch(it) == clean
            if raised is None:
                assert faulted == clean
            got[name] = (faulted, raised, plan.fired(), events)
        finally:
            it.close()
    assert got["port"] == got["ref"]


# ---------------- fault C17 ----------------

def test_c17_no_metadata_request_without_a_cache(http_files):
    """``create_parser`` over a remote source without a block cache or a
    snapshot asks the source nothing (its signature is taken only for a
    cache, as in the JAX package), so the ops the seam sees equal JAX's
    and ``open@1=http-403`` fails the epoch in one attempt."""
    handler, base = http_files
    handler.files["/corpus.libsvm"] = _make_libsvm()
    url = f"{base}/corpus.libsvm"
    got = {}
    for name, p in PKGS.items():
        plan = _recording(p, "none@1")
        with p.faults.inject(plan):
            parser = p.create_parser(url, 0, 1, "libsvm", chunk_bytes=2048)
            at_create = list(plan.seen)
            it = p.device_iter(parser, num_col=4, batch_size=64, layout="dense")
            n = sum(1 for _ in it)
            it.close()
        got[name] = (at_create, sorted(o for o, _ in plan.seen), n)
        p.res.reset_counters()
        with p.faults.inject("open@1=http-403") as fatal:
            with pytest.raises(p.err):
                it = p.device_iter(p.create_parser(url, 0, 1, "libsvm", chunk_bytes=2048),
                                   num_col=4, batch_size=64, layout="dense")
                try:
                    for _ in it:
                        pass
                finally:
                    it.close()
        snap = p.res.counters_snapshot()
        got[name] += (fatal.fired(), snap["fatal"], snap["retries"])
    assert got["port"] == got["ref"]
    assert got["port"][0] == [] and got["port"][3:] == (1, 1, 0)


# ---------------- the plans of chip_smoke.py's phase 22 ----------------

def test_phase22_service_plan_counts_equal_the_reference(tmp_path):
    """Phase 22 (d)'s plan, drained by a client of each package on a fleet
    of its own: the stream of local parsing and the client's counters
    (its telemetry scope's), equal between the packages; the phase's gates
    (``FAULT_SERVICE_WANT``) are these counts. The port's ``DeviceIter``
    over the same plan carries them in its pipeline's
    ``stats()["resilience"]``, which the phase reads."""
    import chip_smoke

    spec = chip_smoke.FAULT_PLANS["service"]
    want = chip_smoke.FAULT_SERVICE_WANT
    corpus = _libsvm(tmp_path / "c.libsvm", n=3000, d=6)
    got = {}
    for name, p in PKGS.items():
        fleet = p.LocalFleet(corpus, 4, **FLEET_KW)
        try:
            base = p.res.counters_snapshot(SCOPE)
            with p.faults.inject(spec) as plan, p.telemetry.scope(SCOPE):
                blocks = _service_drain(p, fleet.address)
            d = p.res.counters_delta(base, SCOPE)
            got[name] = (blocks, plan.fired(), {k: d.get(k, 0) for k in want})
        finally:
            fleet.close()
    assert got["port"] == got["ref"]
    assert got["port"][1:] == (4, want)
    fleet = port_fleet.LocalFleet(corpus, 4, **FLEET_KW)
    try:
        it = DeviceIter(port_client.ServiceParser(fleet.address), num_col=6, batch_size=64,
                        layout="ell", max_nnz=6, device="cpu")
        with port_faults.inject(spec) as plan:
            n = sum(1 for _ in it)
        res = it.stats()["resilience"]
        it.close()
    finally:
        fleet.close()
    assert n == 3000 // 64 + 1 and plan.fired() == 4
    assert {k: res[k] for k in want} == want


@pytest.mark.parametrize("leg", ["http", "http_fatal", "span", "block_cache", "env"])
def test_phase22_plans_parse_alike(leg):
    """Every plan phase 22 runs parses in both packages alike."""
    import chip_smoke

    spec = chip_smoke.FAULT_PLANS[leg]
    for p in PKGS.values():
        plan = p.faults.FaultPlan(spec)
        assert plan.spec == spec and plan.fired() == 0
