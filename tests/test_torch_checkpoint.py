"""Mid-epoch checkpoints of the port, against the JAX package's.

The same seeded corpora go through the JAX package's Python parser chain,
``create_parser(uri + "?engine=python", threaded=True, parse_workers=1,
chunk_bytes=4096)`` (ThreadedParser -> LibSVMParser -> ThreadedInputSplit
-> LineSplitter), and the port's ``create_parser(uri, chunk_bytes=4096)``
on ``device="cpu"``; 4096-byte chunks give a corpus of several blocks.
Checked:

- split, parser and ``DeviceIter`` (dense and ell) states are equal as
  JSON after the same number of chunks, blocks or batches (at the epoch's
  start and after a reset too);
- a state taken in either package restores in the other, and the
  remaining blocks or batches are byte-equal; a seek reads under 0.8 of
  the corpus; a state carries its partition;
- the JAX package's own resume cases on the port: a count restore followed
  by a byte-exact re-checkpoint, a checkpoint in the second epoch, a state
  taken right after ``reset()``;
- snapshots: the two packages' files are byte-identical with the resume
  annotations written; a cold state restores warm and a warm state cold, a
  state beyond the stored batches restores cold, a warm restore decodes
  each remaining batch in one call; a corrupt warm batch heals by a seek.
"""

import json
import os

import numpy as np
import pytest
import torch

from dmlc_tpu.data import create_parser as jax_create_parser
from dmlc_tpu.data.device import DeviceIter as JaxDeviceIter
from dmlc_tpu.io.input_split import create_input_split as jax_create_input_split
from dmlc_tpu_torch.data import DeviceIter, create_parser
from dmlc_tpu_torch.io.input_split import LineSplitter
from dmlc_tpu_torch.io.snapshot import SnapshotReader

NUM_COL, BATCH, CHUNK = 6, 64, 4096


@pytest.fixture(autouse=True)
def _registry_stack(monkeypatch):
    """These cases hold the registry stack of ``create_parser`` (the split,
    the text parsers and their threaded wrappers) against the JAX package's
    Python chain. A plain local file now goes to the fused native reader,
    as in the JAX package, whose own tests reach the registry stack the
    same way; the reader has its own suite (test_torch_native_reader.py)."""
    monkeypatch.setenv("DMLC_TPU_NO_NATIVE_READER", "1")


LAYOUTS = {"dense": {}, "ell": {"layout": "ell", "max_nnz": NUM_COL}}


def _corpus(tmp_path, n=600, name="resume.libsvm"):
    rng = np.random.default_rng(4)
    path = tmp_path / name
    with open(path, "w") as f:
        for i in range(n):
            feats = " ".join(f"{j}:{rng.normal():.5f}" for j in range(NUM_COL))
            f.write(f"{i % 2} {feats}\n")
    return str(path)


def _jax_parser(uri, part=0, nparts=1, chunk_bytes=CHUNK, snapshot=None):
    return jax_create_parser(uri + "?engine=python", part, nparts, "libsvm", threaded=True,
                             parse_workers=1, chunk_bytes=chunk_bytes, snapshot=snapshot)


def _port_parser(uri, part=0, nparts=1, chunk_bytes=CHUNK, snapshot=None):
    return create_parser(uri, part, nparts, "libsvm", chunk_bytes=chunk_bytes,
                         parse_workers=1, snapshot=snapshot)


def _jax_iter(uri, layout="dense", chunk_bytes=CHUNK, snapshot=None, **kw):
    return JaxDeviceIter(_jax_parser(uri, chunk_bytes=chunk_bytes, snapshot=snapshot),
                         num_col=NUM_COL, batch_size=BATCH, **LAYOUTS[layout], **kw)


def _port_iter(uri, layout="dense", chunk_bytes=CHUNK, snapshot=None, **kw):
    return DeviceIter(_port_parser(uri, chunk_bytes=chunk_bytes, snapshot=snapshot),
                      num_col=NUM_COL, batch_size=BATCH, device="cpu",
                      **LAYOUTS[layout], **kw)


def _js(state) -> str:
    return json.dumps(state, sort_keys=True)


def _batch_bytes(batch) -> list:
    arrays = [batch.packed, *batch] if hasattr(batch, "packed") else list(batch)
    out = []
    for a in arrays:
        if isinstance(a, torch.Tensor):
            a = a.contiguous().numpy()
        out.append(np.asarray(a).tobytes())
    return out


def _block_bytes(block) -> bytes:
    return b"".join(np.asarray(a).tobytes() for a in (
        block.offset, block.label, block.index.astype(np.uint64), block.value))


def _drain(it, n=None) -> list:
    out = []
    for batch in it:
        out.append(_batch_bytes(batch))
        if n is not None and len(out) == n:
            break
    return out


# ---------------- split and parser ----------------

@pytest.mark.parametrize("k", [0, 3, "last"])
def test_split_states_equal_as_json(tmp_path, k):
    uri = _corpus(tmp_path)
    jax_split = jax_create_input_split(uri, 0, 1, "text", threaded=False, chunk_bytes=CHUNK)
    jax_threaded = jax_create_input_split(uri, 0, 1, "text", threaded=True, chunk_bytes=CHUNK)
    port = LineSplitter(uri, 0, 1, chunk_bytes=CHUNK)
    n = 10 ** 9 if k == "last" else k
    pulled = 0
    while pulled < n:
        chunks = [s.next_chunk() for s in (jax_split, jax_threaded, port)]
        if chunks[0] is None:
            assert chunks[1] is None and chunks[2] is None
            break
        assert bytes(chunks[0]) == bytes(chunks[1]) == chunks[2]
        pulled += 1
    assert _js(jax_split.state_dict()) == _js(port.state_dict())
    if pulled:
        # the prefetching split's position as of the chunk it handed out
        assert _js(jax_threaded.chunk_resume_state) == _js(port.chunk_resume_state)
    assert port.state_dict()["kind"] == "byte" and port.state_dict()["chunk"] == ""
    # the epoch's start again, after a reset
    for s in (jax_split, port):
        s.before_first()
    assert _js(jax_split.state_dict()) == _js(port.state_dict())
    for s in (jax_split, jax_threaded, port):
        s.close()


def test_split_serves_a_pending_chunk_tail_first(tmp_path):
    """A JAX state taken mid-chunk (record reads) carries the chunk's
    undelivered tail; the port serves it before reading on."""
    uri = _corpus(tmp_path)
    jax_split = jax_create_input_split(uri, 0, 1, "text", threaded=False, chunk_bytes=CHUNK)
    for _ in range(5):
        jax_split.next_record()
    state = jax_split.state_dict()
    assert state["chunk"] != ""
    rest = []
    while (c := jax_split.next_chunk()) is not None:
        rest.append(bytes(c))
    port = LineSplitter(uri, 0, 1, chunk_bytes=CHUNK)
    port.load_state(state)
    got = []
    while (c := port.next_chunk()) is not None:
        got.append(c)
    assert got == rest
    jax_split.close()
    port.close()


@pytest.mark.parametrize("k", [0, 3, "last"])
def test_parser_states_equal_as_json(tmp_path, k):
    uri = _corpus(tmp_path)
    jax_p, port_p = _jax_parser(uri), _port_parser(uri)
    n = 10 ** 9 if k == "last" else k
    pulled = 0
    while pulled < n:
        a, b = jax_p.next_block(), port_p.next_block()
        if a is None:
            assert b is None
            break
        assert _block_bytes(a) == _block_bytes(b)
        assert _js(a.resume_state) == _js(b.resume_state)
        pulled += 1
    assert pulled >= (6 if k == "last" else k)
    assert _js(jax_p.state_dict()) == _js(port_p.state_dict())
    want = "blocks" if k == 0 else "split"
    assert port_p.state_dict()["kind"] == want
    jax_p.before_first()
    port_p.before_first()
    assert _js(jax_p.state_dict()) == _js(port_p.state_dict())
    assert port_p.state_dict() == {"kind": "blocks", "blocks": 0}
    jax_p.close()
    port_p.close()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax", "port_to_port"])
@pytest.mark.parametrize("k", [0, 3])
def test_parser_state_restores_across_packages(tmp_path, direction, k):
    uri = _corpus(tmp_path)
    size = os.path.getsize(uri)
    make_src = _jax_parser if direction == "jax_to_port" else _port_parser
    make_dst = _jax_parser if direction == "port_to_jax" else _port_parser
    full = []
    p = make_src(uri)
    while (b := p.next_block()) is not None:
        full.append(_block_bytes(b))
    p.close()
    p = make_src(uri)
    for _ in range(k):
        p.next_block()
    state = json.loads(json.dumps(p.state_dict()))
    p.close()
    q = make_dst(uri)
    q.load_state(state)
    rest = []
    while (b := q.next_block()) is not None:
        rest.append(_block_bytes(b))
    assert rest == full[k:]
    if k:
        assert state["kind"] == "split"
        assert q.bytes_read < 0.8 * size  # sought, not re-read
    q.close()


def test_parser_state_right_after_reset_is_the_epoch_start(tmp_path):
    """A state taken right after ``before_first`` restores the whole epoch,
    not the stale end of the previous one."""
    uri = _corpus(tmp_path, n=200)
    p = _port_parser(uri)
    full = 0
    while p.next_block() is not None:
        full += 1
    p.before_first()
    state = p.state_dict()
    p.close()
    p2 = _port_parser(uri)
    p2.load_state(state)
    again = 0
    while p2.next_block() is not None:
        again += 1
    p2.close()
    assert again == full > 1


@pytest.mark.parametrize("src,dst", [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_state_carries_its_partition(tmp_path, src, dst):
    """A state taken on shard 2 of 4 restores onto a parser made for shard
    0: the split re-applies the recorded partition."""
    path = tmp_path / "pid.libsvm"
    path.write_text("".join(f"{i % 2} 0:{i}.5\n" for i in range(4000)))
    make = {"port": _port_parser, "jax": _jax_parser}
    p = make[src](str(path), 2, 4, chunk_bytes=512)
    assert p.next_block() is not None
    state = p.state_dict()
    want = []
    while (b := p.next_block()) is not None:
        want.append(np.asarray(b.label))
    p.close()
    assert want and state["split"]["part_index"] == 2
    q = make[dst](str(path), 0, 4, chunk_bytes=512)
    q.load_state(state)
    got = []
    while (b := q.next_block()) is not None:
        got.append(np.asarray(b.label))
    q.close()
    assert len(got) == len(want)
    for a, b_ in zip(got, want):
        np.testing.assert_array_equal(a, b_)


# ---------------- DeviceIter ----------------

@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("k", [0, 2, 5, "all"])
def test_device_iter_states_equal_as_json(tmp_path, layout, k):
    uri = _corpus(tmp_path)
    jax_it, port_it = _jax_iter(uri, layout), _port_iter(uri, layout)
    n = 10 ** 9 if k == "all" else k
    for _, a, b in zip(range(n), jax_it, port_it):
        assert _batch_bytes(a) == _batch_bytes(b)
        assert _js(jax_it.state_dict()) == _js(port_it.state_dict())
    state = port_it.state_dict()
    assert _js(jax_it.state_dict()) == _js(state)
    assert state["kind"] == ("batches" if k == 0 else "source")
    jax_it.reset()
    port_it.reset()
    assert _js(jax_it.state_dict()) == _js(port_it.state_dict())
    assert port_it.state_dict() == {"kind": "batches", "batches": 0}
    jax_it.close()
    port_it.close()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_device_iter_byte_exact_resume(tmp_path, layout):
    """A mid-epoch restore seeks the split instead of replaying the
    epoch's prefix."""
    uri = _corpus(tmp_path)
    size = os.path.getsize(uri)
    full = _drain(_port_iter(uri, layout))
    assert len(full) >= 6
    it = _port_iter(uri, layout)
    _drain(it, 4)
    state = json.loads(json.dumps(it.state_dict()))
    it.close()
    assert state["kind"] == "source"
    parser = _port_parser(uri)
    it3 = DeviceIter(parser, num_col=NUM_COL, batch_size=BATCH, device="cpu", **LAYOUTS[layout])
    it3.load_state(state)
    assert _drain(it3) == full[4:]
    assert parser.bytes_read < 0.8 * size
    it3.close()


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("kind", ["source", "batches"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_device_iter_state_restores_across_packages(tmp_path, layout, kind, direction):
    """A state of either kind taken in one package restores in the other;
    the remaining batches are byte-equal. One chunk of 1 MiB gives the
    early batches no block boundary, so their state is a count."""
    uri = _corpus(tmp_path)
    chunk = CHUNK if kind == "source" else 1 << 20
    make_src, make_dst = ((_jax_iter, _port_iter) if direction == "jax_to_port"
                          else (_port_iter, _jax_iter))
    full = _drain(make_src(uri, layout, chunk_bytes=chunk))
    it = make_src(uri, layout, chunk_bytes=chunk)
    _drain(it, 3)
    state = json.loads(json.dumps(it.state_dict()))
    it.close()
    assert state["kind"] == kind
    it2 = make_dst(uri, layout, chunk_bytes=chunk)
    it2.load_state(state)
    rest = _drain(it2)
    it2.close()
    assert len(rest) == len(full) - 3 and rest == full[3:]


# 16 KiB chunks: the first block ends in the 4th batch of 64 rows
BIG_CHUNK = 16384


def test_count_resume_then_byte_exact_recheckpoint(tmp_path):
    """A count restore keeps each batch paired with its annotation, so a
    later checkpoint of the restored iterator is a seek again, and equal
    to the JAX package's at the same point."""
    uri = _corpus(tmp_path)
    full = _drain(_port_iter(uri, chunk_bytes=BIG_CHUNK))
    it = _port_iter(uri, chunk_bytes=BIG_CHUNK)
    _drain(it, 2)
    st1 = it.state_dict()
    it.close()
    assert st1 == {"kind": "batches", "batches": 2}  # no block boundary crossed yet
    it3 = _port_iter(uri, chunk_bytes=BIG_CHUNK)
    it3.load_state(st1)
    assert _drain(it3) == full[2:]
    it4, jax4 = _port_iter(uri, chunk_bytes=BIG_CHUNK), _jax_iter(uri, chunk_bytes=BIG_CHUNK)
    it4.load_state(st1)
    jax4.load_state(st1)
    for _ in range(len(full) - 3):
        next(it4)
        next(jax4)
    st2 = it4.state_dict()
    assert st2["kind"] == "source" and _js(st2) == _js(jax4.state_dict())
    jax4.close()
    want_tail = _batch_bytes(next(it4))
    it4.close()
    it5 = _port_iter(uri, chunk_bytes=BIG_CHUNK)
    it5.load_state(st2)
    assert _drain(it5) == [want_tail]


def test_count_replay_converts_and_copies_nothing(tmp_path, monkeypatch):
    """A count restore skips its batches on the producer: no conversion,
    no staging slot, no bytes to the device."""
    uri = _corpus(tmp_path)
    full = _drain(_port_iter(uri, chunk_bytes=BIG_CHUNK))
    converted = []
    convert = DeviceIter._convert

    def counting(self, block, pad_nnz):
        converted.append(len(block))
        return convert(self, block, pad_nnz)

    monkeypatch.setattr(DeviceIter, "_convert", counting)
    it = _port_iter(uri, chunk_bytes=BIG_CHUNK)
    it.load_state({"kind": "batches", "batches": 7})
    assert it.stats()["bytes_to_device"] == 0
    assert it.state_dict()["kind"] == "source"  # the 7th batch crossed the block's end
    assert _drain(it) == full[7:]
    it.close()
    assert len(converted) == len(full) - 7


def test_checkpoint_in_second_epoch_after_reset(tmp_path):
    """A reset mid-epoch leaks no annotation into the next epoch's
    checkpoints."""
    uri = _corpus(tmp_path, n=400)
    it = _port_iter(uri)
    full = _drain(it)
    it.reset()
    _drain(it, 2)
    it.reset()
    _drain(it, 3)
    state = it.state_dict()
    jax_it = _jax_iter(uri)
    _drain(jax_it)
    jax_it.reset()
    _drain(jax_it, 2)
    jax_it.reset()
    _drain(jax_it, 3)
    assert _js(state) == _js(jax_it.state_dict())
    jax_it.close()
    it.close()
    it2 = _port_iter(uri)
    it2.load_state(state)
    assert _drain(it2) == full[3:]
    it2.close()


def test_state_right_after_reset_restores_the_whole_epoch(tmp_path):
    uri = _corpus(tmp_path)
    it = _port_iter(uri)
    full = _drain(it)
    _drain(it, 4)
    it.reset()
    state = it.state_dict()
    it.close()
    it2 = _port_iter(uri)
    it2.load_state(state)
    assert _drain(it2) == full
    it2.close()


# ---------------- snapshots ----------------

@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_snapshot_files_identical_with_annotations(tmp_path, layout):
    uri = _corpus(tmp_path)
    snaps = {}
    for name, make in (("jax", _jax_iter), ("port", _port_iter)):
        snaps[name] = str(tmp_path / f"{name}.snapshot")
        it = make(uri, layout, snapshot=snaps[name])
        _drain(it)
        it.close()
    with open(snaps["jax"], "rb") as a, open(snaps["port"], "rb") as b:
        assert a.read() == b.read()
    reader = SnapshotReader(snaps["port"])
    resumes = [reader.resume(i) for i in range(reader.num_batches)]
    reader.close()
    # every batch crosses a 4 KiB block's end, and the epoch ends on one
    assert all(r is not None for r in resumes) and resumes[-1]["skip_rows"] == 0


def _snapshot_case(tmp_path, layout):
    """(corpus, snapshot path, the cold epoch's batches): the snapshot
    published by one complete cold epoch of the port."""
    uri = _corpus(tmp_path)
    snap = str(tmp_path / "c.snapshot")
    it = _port_iter(uri, layout, snapshot=snap)
    full = _drain(it)
    it.close()
    assert os.path.exists(snap)
    return uri, snap, full


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("src", ["port", "jax"])
@pytest.mark.parametrize("k", [3, 5])
def test_cold_state_restores_warm(tmp_path, layout, src, k):
    uri, snap, full = _snapshot_case(tmp_path, layout)
    make = _port_iter if src == "port" else _jax_iter
    cold = make(uri, layout)
    _drain(cold, k)
    state = json.loads(json.dumps(cold.state_dict()))
    cold.close()
    warm = _port_iter(uri, layout, snapshot=snap, device_decode=True)
    warm.load_state(state)
    assert _drain(warm) == full[k:]
    s = warm.stats()
    assert s["snapshot_state"] == "warm" and s["convert_seconds"] == 0.0
    warm.close()


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("dst", ["port", "jax"])
def test_warm_state_restores_cold(tmp_path, layout, dst):
    uri, snap, full = _snapshot_case(tmp_path, layout)
    warm = _port_iter(uri, layout, snapshot=snap)
    _drain(warm, 4)
    assert warm.stats()["snapshot_state"] == "warm"
    state = json.loads(json.dumps(warm.state_dict()))
    warm.close()
    assert state["kind"] == "source"
    make = _port_iter if dst == "port" else _jax_iter
    cold = make(uri, layout)
    cold.load_state(state)
    assert _drain(cold) == full[4:]
    cold.close()


def test_warm_restore_decodes_each_batch_in_one_call(tmp_path, monkeypatch):
    from dmlc_tpu_torch.ops import device_decode as dd

    uri, snap, full = _snapshot_case(tmp_path, "ell")
    calls = []
    decode_batch = dd.decode_batch

    def counting(span, layout, kind, num_col):
        calls.append(kind)
        return decode_batch(span, layout, kind, num_col)

    monkeypatch.setattr(dd, "decode_batch", counting)
    it = _port_iter(uri, "ell", snapshot=snap, device_decode=True)
    it.load_state({"kind": "batches", "batches": 2})
    assert it.state_dict()["kind"] == "source"  # the stored annotation of batch 2
    assert _drain(it) == full[2:]
    it.close()
    assert len(calls) == len(full) - 2


def test_state_beyond_the_stored_batches_restores_cold(tmp_path):
    """A snapshot of 4 batches (a shorter corpus under one signature): a
    state at batch 6 goes to the cold machinery, which aborts the shadow
    writer and serves cold until the next reset."""
    uri = _corpus(tmp_path)
    short = _corpus(tmp_path, n=256, name="short.libsvm")
    snap, sig = str(tmp_path / "c.snapshot"), {"corpus": "one signature"}

    def make(path):
        return DeviceIter(_port_parser(path), num_col=NUM_COL, batch_size=BATCH,
                          device="cpu", snapshot=snap, snapshot_signature=sig)

    it = make(short)
    _drain(it)
    it.close()
    full = _drain(_port_iter(uri))
    cold = _port_iter(uri)
    _drain(cold, 6)
    state = cold.state_dict()
    cold.close()
    it = make(uri)
    it.load_state(state)
    assert _drain(it) == full[6:]
    assert it.stats()["snapshot_state"] == "cold"
    stored = os.path.getsize(snap)
    it.reset()  # the restored epoch published nothing: the short file stays
    assert os.path.getsize(snap) == stored
    next(it)
    assert it.stats()["snapshot_state"] == "warm"
    it.close()


def test_corrupt_warm_batch_heals_by_seek(tmp_path, monkeypatch):
    """The stored annotations make healing a seek: the epoch equals the
    cold one, with one restart, and the JAX package heals the same file to
    the same bytes."""
    monkeypatch.delenv("DMLC_RETRY_MAX_ATTEMPTS", raising=False)
    uri, snap, full = _snapshot_case(tmp_path, "ell")
    jax_snap = str(tmp_path / "jax.snapshot")
    reader = SnapshotReader(snap)
    pos = reader._batches[6]["pos"] + 100
    reader.close()
    with open(snap, "r+b") as f:
        f.seek(pos)
        byte = f.read(1)
        f.seek(pos)
        f.write(bytes([byte[0] ^ 0x01]))
    with open(snap, "rb") as src, open(jax_snap, "wb") as dst:
        dst.write(src.read())
    parser = _port_parser(uri, snapshot=snap)
    it = DeviceIter(parser, num_col=NUM_COL, batch_size=BATCH, device="cpu",
                    device_decode=True, **LAYOUTS["ell"])
    healed = _drain(it)
    assert healed == full
    assert it.stats()["resilience"]["pipeline_restarts"] == 1
    assert 0 < parser.bytes_read < 0.8 * os.path.getsize(uri)  # sought
    it.close()
    jax_it = _jax_iter(uri, "ell", snapshot=jax_snap, device_decode=True)
    assert _drain(jax_it) == full
    assert jax_it.stats()["resilience"]["pipeline_restarts"] == 1
    jax_it.close()
