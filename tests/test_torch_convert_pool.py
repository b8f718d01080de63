"""``DeviceIter``'s convert pool and snapshot read pool, against the JAX
package's.

The same seeded libsvm corpus goes through the JAX package's Python parser
chain, ``create_parser(uri + "?engine=python", threaded=True,
parse_workers=1, chunk_bytes=4096)``, and the port's registry stack,
``create_parser(uri, chunk_bytes=4096, parse_workers=1)`` on
``device="cpu"``, as the checkpoint suite runs them. Checked:

- ``ell``, ``dense`` and fixed-batch ``bcoo`` batches are byte-equal
  across ``convert_workers`` in {1, 2, 3} x ``convert_ahead`` in {1, 4},
  and equal to the JAX package's batches with the same knobs;
- a mid-epoch ``state_dict`` under 3 workers equals the JAX state as JSON
  and restores in both packages to byte-equal remaining batches;
- a snapshot written under 3 workers is byte-identical to the 1-worker
  snapshot and to the JAX package's;
- warm epochs at ``snapshot_read_workers`` 1 and 2 serve the stored bytes
  in stored and in plan order, as the JAX package's do;
- ``transfer_samples`` equals the JAX count over the same batches;
- the knobs resolve as ``dmlc_tpu.utils.knobs`` (and, for the transfer
  sample, the JAX ``DeviceIter``) for explicit, environment and bad
  environment values;
- ``reset``, ``close`` and ``load_state`` mid-epoch return within a join
  timeout with the workers parked on a full staging ring, and the stream
  goes on correctly after them.
"""

import itertools
import json
import threading

import numpy as np
import pytest
import torch

from dmlc_tpu.data import create_parser as jax_create_parser
from dmlc_tpu.data.device import DeviceIter as JaxDeviceIter
from dmlc_tpu.io.snapshot import SnapshotReader as JaxSnapshotReader
from dmlc_tpu.utils import knobs as jax_knobs
from dmlc_tpu.utils import telemetry as jax_telemetry
from dmlc_tpu.utils.check import DMLCError as JaxDMLCError
from dmlc_tpu_torch.data import DeviceIter, create_parser
from dmlc_tpu_torch.data import epoch as port_epoch
from dmlc_tpu_torch.data.device import _Slot, _StagingRing
from dmlc_tpu_torch.io.snapshot import SnapshotReader
from dmlc_tpu_torch.utils import knobs, telemetry
from dmlc_tpu_torch.utils.check import DMLCError

NUM_COL, BATCH, CHUNK, ROWS = 6, 64, 4096, 600
JOIN_TIMEOUT = 20.0
LAYOUTS = {"dense": {}, "ell": {"layout": "ell", "max_nnz": NUM_COL},
           "bcoo": {"layout": "bcoo"}}
KNOB_ENVS = {"convert_workers": "DMLC_TPU_CONVERT_WORKERS",
             "convert_ahead": "DMLC_TPU_CONVERT_AHEAD",
             "snapshot_read_workers": "DMLC_TPU_SNAPSHOT_READ_WORKERS"}


@pytest.fixture(autouse=True)
def _registry_stack(monkeypatch):
    """The registry stack against the JAX package's Python chain (as the
    checkpoint suite), and the knobs at their defaults unless a case sets
    them."""
    monkeypatch.setenv("DMLC_TPU_NO_NATIVE_READER", "1")
    for env in (*KNOB_ENVS.values(), "DMLC_TPU_TRANSFER_SAMPLE", "DMLC_TPU_TRACE"):
        monkeypatch.delenv(env, raising=False)


def _corpus(tmp_path, n=ROWS):
    rng = np.random.default_rng(12)
    path = tmp_path / "pool.libsvm"
    with open(path, "w") as f:
        for i in range(n):
            cols = np.flatnonzero(rng.random(NUM_COL) < 0.7)
            feats = " ".join(f"{j}:{rng.normal():.5f}" for j in cols)
            f.write(f"{i % 2} {feats}\n")
    return str(path)


def _jax_iter(uri, layout="dense", snapshot=None, **kw):
    parser = jax_create_parser(uri + "?engine=python", 0, 1, "libsvm", threaded=True,
                               parse_workers=1, chunk_bytes=CHUNK, snapshot=snapshot)
    return JaxDeviceIter(parser, num_col=NUM_COL, batch_size=BATCH, **LAYOUTS[layout], **kw)


def _port_iter(uri, layout="dense", snapshot=None, **kw):
    parser = create_parser(uri, 0, 1, "libsvm", chunk_bytes=CHUNK, parse_workers=1,
                           snapshot=snapshot)
    return DeviceIter(parser, num_col=NUM_COL, batch_size=BATCH, device="cpu",
                      **LAYOUTS[layout], **kw)


def _js(state) -> str:
    return json.dumps(state, sort_keys=True)


def _port_bytes(batch, layout) -> list:
    """A port batch's bytes: every array; bcoo's sparse ``x`` as its
    coordinates and values (its shape is part of the pad scheme)."""
    if layout == "bcoo":
        x, y, w = batch
        return [x.shape, x._indices().numpy().tobytes(), x._values().numpy().tobytes(),
                y.numpy().tobytes(), w.numpy().tobytes()]
    arrays = [batch.packed] if hasattr(batch, "packed") else list(batch)
    return [a.contiguous().numpy().tobytes() for a in arrays]


def _port_dense(batch, layout) -> list:
    """A port batch as the arrays a JAX batch of the layout holds."""
    if layout == "bcoo":
        x, y, w = batch
        return [x.to_dense().numpy(), y.numpy(), w.numpy()]
    if hasattr(batch, "packed"):
        return [batch.packed.numpy()]
    return [t.numpy() for t in batch]


def _jax_dense(batch, layout) -> list:
    if layout == "bcoo":
        m, y, w = batch
        return [np.asarray(m.todense()), np.asarray(y), np.asarray(w)]
    if hasattr(batch, "packed"):
        return [np.asarray(batch.packed)]
    return [np.asarray(a) for a in batch]


def _drain(it, layout="dense", n=None) -> list:
    out = []
    for batch in it:
        out.append(_port_bytes(batch, layout))
        if n is not None and len(out) == n:
            break
    return out


# ---------------- batches across widths ----------------

@pytest.mark.parametrize("workers,ahead", list(itertools.product((1, 2, 3), (1, 4))))
@pytest.mark.parametrize("layout", ["ell", "dense", "bcoo"])
def test_batches_equal_across_widths_and_reference(tmp_path, layout, workers, ahead):
    uri = _corpus(tmp_path)
    base = _port_iter(uri, layout, convert_workers=1, convert_ahead=1)
    want = _drain(base, layout)
    base.close()
    it = _port_iter(uri, layout, convert_workers=workers, convert_ahead=ahead)
    got, port_arrays = [], []
    for batch in it:
        got.append(_port_bytes(batch, layout))
        port_arrays.append(_port_dense(batch, layout))
    s = it.stats()
    it.close()
    assert len(got) == -(-ROWS // BATCH) and got == want
    assert s["convert_workers"] == workers and s["batches"] == len(got)
    jax_it = _jax_iter(uri, layout, convert_workers=workers, convert_ahead=ahead)
    jax_arrays = [_jax_dense(b, layout) for b in jax_it]
    jax_it.close()
    assert len(jax_arrays) == len(port_arrays)
    for mine, ref in zip(port_arrays, jax_arrays):
        assert len(mine) == len(ref)
        for a, b in zip(mine, ref):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# ---------------- checkpoints under the pool ----------------

@pytest.mark.parametrize("k", [1, 3, 7])
@pytest.mark.parametrize("layout", ["ell", "dense"])
def test_state_under_three_workers_matches_reference_both_ways(tmp_path, layout, k):
    uri = _corpus(tmp_path)
    full_it = _port_iter(uri, layout, convert_workers=3)
    full = _drain(full_it, layout)
    full_it.close()
    port = _port_iter(uri, layout, convert_workers=3)
    jax_it = _jax_iter(uri, layout, convert_workers=3)
    for _ in range(k):
        next(port)
        next(jax_it)
    state, jax_state = port.state_dict(), jax_it.state_dict()
    port.close()
    jax_it.close()
    # a count before the first block boundary, a seek after it
    assert state["kind"] == ("batches" if k == 1 else "source")
    assert _js(state) == _js(jax_state)
    # the JAX state into a port pipeline, the port state into a JAX one
    resumed = _port_iter(uri, layout, convert_workers=3)
    resumed.load_state(json.loads(_js(jax_state)))
    assert _drain(resumed, layout) == full[k:]
    resumed.close()
    jax_resumed = _jax_iter(uri, layout, convert_workers=3)
    jax_resumed.load_state(json.loads(_js(state)))
    rest = [_jax_dense(b, layout) for b in jax_resumed]
    jax_resumed.close()
    assert [[a.tobytes() for a in arrays] for arrays in rest] == full[k:]


def test_count_restore_under_the_pool_replays_to_a_seek(tmp_path):
    """A ``batches`` state replays its count through the pool's serial
    stage (no convert) and the next state is the seek the JAX package
    gives."""
    uri = _corpus(tmp_path)
    full_it = _port_iter(uri, "ell", convert_workers=3)
    full = _drain(full_it, "ell")
    full_it.close()
    port = _port_iter(uri, "ell", convert_workers=3, convert_ahead=4)
    port.load_state({"kind": "batches", "batches": 4})
    jax_it = _jax_iter(uri, "ell", convert_workers=3, convert_ahead=4)
    jax_it.load_state({"kind": "batches", "batches": 4})
    assert _js(port.state_dict()) == _js(jax_it.state_dict())
    assert _drain(port, "ell") == full[4:]
    port.close()
    jax_it.close()


# ---------------- the snapshot under the pools ----------------

@pytest.mark.parametrize("layout", ["ell", "dense"])
def test_snapshot_under_three_workers_is_byte_identical(tmp_path, layout):
    uri = _corpus(tmp_path)
    files = {}
    for name, make, workers in (("port1", _port_iter, 1), ("port3", _port_iter, 3),
                                ("jax3", _jax_iter, 3)):
        snap = str(tmp_path / f"{name}.snapshot")
        it = make(uri, layout, snapshot=snap, convert_workers=workers)
        for _ in it:
            pass
        it.close()
        with open(snap, "rb") as f:
            files[name] = f.read()
    assert files["port3"] == files["port1"] == files["jax3"]


@pytest.mark.parametrize("seed", [None, 5])
@pytest.mark.parametrize("device_decode", [False, True])
def test_warm_read_workers_serve_in_plan_order(tmp_path, device_decode, seed):
    uri = _corpus(tmp_path)
    snap = str(tmp_path / "warm.snapshot")
    cold_it = _port_iter(uri, "ell", snapshot=snap)
    cold = _drain(cold_it, "ell")
    cold_it.close()
    n = len(cold)
    order = (list(range(n)) if seed is None
             else [int(i) for i in port_epoch.block_permutation(seed, 0, n)])
    served = {}
    for workers in (1, 2):
        it = _port_iter(uri, "ell", snapshot=snap, snapshot_read_workers=workers,
                        device_decode=device_decode, snapshot_shuffle_seed=seed)
        served[workers] = _drain(it, "ell")
        s = it.stats()
        it.close()
        assert s["snapshot_state"] == "warm" and s["stage_busy"]["convert"] == 0.0
        assert s["stage_busy"]["snapshot_read"] > 0.0
    assert served[1] == served[2] == [cold[i] for i in order]
    # the JAX package's warm epoch over the same file, at the same widths
    for workers in (1, 2):
        jax_it = _jax_iter(uri, "ell", snapshot=snap, snapshot_read_workers=workers,
                           snapshot_shuffle_seed=seed)
        got = [[a.tobytes() for a in _jax_dense(b, "ell")] for b in jax_it]
        jax_it.close()
        assert got == served[1]
    assert JaxSnapshotReader(snap).num_batches == SnapshotReader(snap).num_batches == n


# ---------------- the transfer sample ----------------

@pytest.mark.parametrize("sample", [1, 3, 0, None])
def test_transfer_samples_match_reference(tmp_path, sample):
    uri = _corpus(tmp_path)
    counts = []
    for make in (_port_iter, _jax_iter):
        it = make(uri, "ell", transfer_sample=sample)
        for _ in range(7):
            next(it)
        mid = it.stats()["transfer_samples"]
        for _ in it:
            pass
        counts.append((mid, it.stats()["transfer_samples"], it.transfer_sample))
        it.close()
    assert counts[0] == counts[1]


# ---------------- the knobs ----------------

@pytest.mark.parametrize("raw", [None, "5", "1", "0", "-2", "two", " 3 "])
@pytest.mark.parametrize("name", sorted(KNOB_ENVS))
def test_pool_knobs_resolve_as_reference(monkeypatch, name, raw):
    if raw is None:
        monkeypatch.delenv(KNOB_ENVS[name], raising=False)
    else:
        monkeypatch.setenv(KNOB_ENVS[name], raw)
    try:
        want = jax_knobs.resolve(name)
    except JaxDMLCError as exc:
        with pytest.raises(DMLCError) as got:
            knobs.resolve(name)
        assert str(got.value).split(":")[0] == str(exc).split(":")[0]
    else:
        assert knobs.resolve(name) == want
    for explicit in (0, 3):  # an explicit value wins, clamped up to the floor
        assert knobs.resolve(name, explicit) == jax_knobs.resolve(name, explicit)


@pytest.mark.parametrize("raw", [None, "7", "0", "-3", "", "x"])
def test_transfer_sample_knob_resolves_as_reference(tmp_path, monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("DMLC_TPU_TRANSFER_SAMPLE", raising=False)
    else:
        monkeypatch.setenv("DMLC_TPU_TRANSFER_SAMPLE", raw)
    uri = _corpus(tmp_path, n=BATCH)
    if raw == "x":
        with pytest.raises(ValueError):
            _jax_iter(uri)
        with pytest.raises(ValueError):
            _port_iter(uri)
        return
    jax_it, it = _jax_iter(uri), _port_iter(uri)
    assert it.transfer_sample == jax_it.transfer_sample == knobs.transfer_sample()
    assert _port_iter(uri, transfer_sample=-4).transfer_sample == 0
    # the pool knobs' defaults, as the JAX DeviceIter resolves them
    assert (it.convert_workers, it._convert_ahead) == (jax_it.convert_workers,
                                                       jax_it._convert_ahead) == (2, 4)
    assert it.snapshot_read_workers == jax_knobs.resolve("snapshot_read_workers") == 2
    jax_it.close()
    it.close()


@pytest.mark.parametrize("raw", ["", "1", "0", "annotate", "chrome:/tmp/t.json",
                                 " chrome:rel.json "])
def test_trace_mode_reads_as_reference(monkeypatch, raw):
    monkeypatch.setenv("DMLC_TPU_TRACE", raw)
    assert telemetry.trace_mode() == jax_telemetry.trace_mode()


def test_env_knobs_reach_the_pools(tmp_path, monkeypatch):
    monkeypatch.setenv("DMLC_TPU_CONVERT_WORKERS", "3")
    monkeypatch.setenv("DMLC_TPU_CONVERT_AHEAD", "1")
    monkeypatch.setenv("DMLC_TPU_SNAPSHOT_READ_WORKERS", "4")
    uri = _corpus(tmp_path)
    it = _port_iter(uri, "ell", snapshot=str(tmp_path / "env.snapshot"))
    for _ in it:
        pass
    assert (it.convert_workers, it._convert_ahead, it.snapshot_read_workers) == (3, 1, 4)
    assert it._host is None or it._host.num_workers == 3
    cold_depth = it.stats()["staging_ring"]["depth"]
    assert cold_depth == 1 + it.prefetch + 3 + 2
    it.reset()
    next(it)
    # the warm read pool: 4 workers, 8 reads ahead, the same spec's ring grown
    assert it._host._pool.num_workers == 4
    assert it.stats()["staging_ring"]["depth"] == 8 + it.prefetch + 4 + 2
    it.close()
    monkeypatch.setenv("DMLC_TPU_CONVERT_WORKERS", "0")
    with pytest.raises(DMLCError, match="DMLC_TPU_CONVERT_WORKERS"):
        _port_iter(uri)


# ---------------- teardown ----------------

def _slot():
    return _Slot([torch.empty(4)])


def test_ring_close_wakes_every_waiter():
    ring = _StagingRing([_slot()])
    assert ring.acquire() is not None
    got = []
    threads = [threading.Thread(target=lambda: got.append(ring.acquire()), daemon=True)
               for _ in range(4)]
    for t in threads:
        t.start()
    deadline = threading.Event()
    for _ in range(200):
        if ring.stats()["misses"] == 4:
            break
        deadline.wait(0.01)
    assert ring.stats() == {"depth": 1, "hits": 1, "misses": 4}
    ring.close()
    for t in threads:
        t.join(JOIN_TIMEOUT)
    assert not any(t.is_alive() for t in threads) and got == [None] * 4
    ring.reopen()
    assert ring.acquire() is not None


def _parked_pipeline(uri, ahead):
    """A pipeline with 4 convert workers and ``prefetch=1`` whose every
    staging slot is held outside it (as slots whose copies are still in
    flight would be) when its pool starts: the workers pull the window's
    ``ahead`` batches and park on the full ring, the rest on the pool's
    window."""
    it = _port_iter(uri, "ell", convert_workers=4, convert_ahead=ahead, prefetch=1)
    ring = it._ring_for(it._cold_spec(), it._convert_ahead, it.convert_workers)
    held = [ring.acquire() for _ in range(ring.stats()["depth"])]
    it._host_iter()  # the pool starts
    for _ in range(1000):
        if ring.stats()["misses"] == ahead:
            break
        threading.Event().wait(0.01)
    assert ring.stats()["misses"] == ahead and it._host._seq == ahead
    return it, held


def _within_timeout(fn) -> None:
    errors = []

    def run():
        try:
            fn()
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(JOIN_TIMEOUT)
    assert not t.is_alive(), f"did not return within {JOIN_TIMEOUT} s"
    if errors:
        raise errors[0]


@pytest.mark.parametrize("ahead", [1, 4])
@pytest.mark.parametrize("op", ["reset", "close", "load_state"])
def test_teardown_with_workers_parked_returns(tmp_path, op, ahead):
    uri = _corpus(tmp_path)
    full_it = _port_iter(uri, "ell", convert_workers=1)
    full = _drain(full_it, "ell", n=3)
    state = full_it.state_dict()
    full += _drain(full_it, "ell")
    full_it.close()
    it, held = _parked_pipeline(uri, ahead)
    if op == "reset":
        _within_timeout(it.reset)
        assert _drain(it, "ell") == full
    elif op == "load_state":
        _within_timeout(lambda: it.load_state(state))
        assert _drain(it, "ell") == full[3:]
    else:
        _within_timeout(it.close)
        return
    assert len(held) == it.stats()["staging_ring"]["depth"]
    it.close()
