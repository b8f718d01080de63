"""The port's service wire (``dmlc_tpu_torch/service/frame.py``) and the
worker's snapshot packing against the JAX package's.

- both goldens (``tests/data/service_frame_v1.golden``, ``_v2.golden``)
  rewritten byte for byte by the port;
- BLOCK frames (every optional array present or absent, v1 and zlib v2),
  END / ERROR / HELLO frames and ``reframe_v2`` encoded by each package
  byte-identical to the other's and decoded by the other; a
  ``native-batch`` block's frame reusing its encoded bytes;
- SNAPSHOT frames of packed f32 and bf16 slabs (the port's bf16 a
  ``torch.bfloat16`` tensor stored under ``"bfloat16"``, JAX's an
  ``ml_dtypes`` array) byte-identical both ways, decoded across;
- ``pack_dense_batches`` (a copy in ``dmlc_tpu_torch/data/device.py``):
  f32 and bf16 slabs (rounded to nearest even) and resume annotations
  equal to JAX's, its bf16 refusal with JAX's message;
- the worker's snap container (``DMLCSN01``) both ways, a corrupt one
  refused by both;
- decode errors (truncated, magic, version, length, crc, codec) with
  JAX's messages, classified retryable by both packages' ``classify``;
- frames over a socket pair, sent by one package and received by the
  other (``send_frame``, ``send_frame_vectored``, ``recv_frame``);
- ``negotiate_codec``, the per-dtype break-even decisions and the trace
  helpers against JAX's.

The shared corpus and fleet helpers of the ``test_torch_service_*`` files
live here.
"""

from __future__ import annotations

import json
import os
import socket
import threading
from types import SimpleNamespace

import ml_dtypes
import numpy as np
import pytest
import torch

from dmlc_tpu.data import device as jax_device
from dmlc_tpu.data.parsers import create_parser as jax_create_parser
from dmlc_tpu.data.row_block import RowBlock as JaxRowBlock
from dmlc_tpu.io import resilience as jax_resilience
from dmlc_tpu.service import autoscale as jax_autoscale
from dmlc_tpu.service import client as jax_client
from dmlc_tpu.service import dispatcher as jax_dispatcher
from dmlc_tpu.service import fleet as jax_fleet
from dmlc_tpu.service import frame as jax_frame
from dmlc_tpu.service import worker as jax_worker
from dmlc_tpu.store import journal as jax_journal
from dmlc_tpu.store import manager as jax_mgr
from dmlc_tpu.utils.check import DMLCError as JaxDMLCError
from dmlc_tpu_torch import native
from dmlc_tpu_torch.data import device as port_device
from dmlc_tpu_torch.data.parsers import create_parser
from dmlc_tpu_torch.data.row_block import RowBlock
from dmlc_tpu_torch.io import resilience
from dmlc_tpu_torch.service import autoscale as port_autoscale
from dmlc_tpu_torch.service import client as port_client
from dmlc_tpu_torch.service import dispatcher as port_dispatcher
from dmlc_tpu_torch.service import fleet as port_fleet
from dmlc_tpu_torch.service import frame as port_frame
from dmlc_tpu_torch.service import worker as port_worker
from dmlc_tpu_torch.store import journal as port_journal
from dmlc_tpu_torch.store import manager as port_mgr
from dmlc_tpu_torch.utils.check import DMLCError

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")
CHUNK = 16384
NUM_PARTS = 3
PARSER_CFG = {"format": "libsvm", "threaded": False, "chunk_bytes": CHUNK}

PKGS = {
    "port": SimpleNamespace(
        name="port", frame=port_frame, dispatcher=port_dispatcher, worker=port_worker,
        client=port_client, fleet=port_fleet, autoscale=port_autoscale,
        resilience=resilience, journal=port_journal, mgr=port_mgr, device=port_device,
        create_parser=create_parser, RowBlock=RowBlock, DMLCError=DMLCError,
        LocalFleet=port_fleet.LocalFleet, ServiceParser=port_client.ServiceParser),
    "jax": SimpleNamespace(
        name="jax", frame=jax_frame, dispatcher=jax_dispatcher, worker=jax_worker,
        client=jax_client, fleet=jax_fleet, autoscale=jax_autoscale,
        resilience=jax_resilience, journal=jax_journal, mgr=jax_mgr, device=jax_device,
        create_parser=jax_create_parser, RowBlock=JaxRowBlock, DMLCError=JaxDMLCError,
        LocalFleet=jax_fleet.LocalFleet, ServiceParser=jax_client.ServiceParser),
}
BOTH = pytest.mark.parametrize("pkg", list(PKGS))
PAIRS = pytest.mark.parametrize("enc,dec", [(a, b) for a in PKGS for b in PKGS])


@pytest.fixture(autouse=True)
def _service_env(monkeypatch):
    """Fast retries, the registry stack's knobs unset, both packages'
    counters and stores fresh."""
    monkeypatch.setenv("DMLC_RETRY_BASE_MS", "1")
    monkeypatch.setenv("DMLC_RETRY_MAX_MS", "5")
    for var in ("DMLC_TPU_PARSE_WORKERS", "DMLC_TPU_PARSE_ENGINE", "DMLC_TPU_WIRE_COMPRESSION",
                "DMLC_TPU_PREEMPTION_NOTICE", "DMLC_TPU_AUTOTUNE", "DMLC_TPU_BLOCK_CACHE",
                "DMLC_TPU_DEVICE_DECODE"):
        monkeypatch.delenv(var, raising=False)
    for pkg in PKGS.values():
        pkg.resilience.reset_counters()
        pkg.mgr.reset_stores()
    yield
    for pkg in PKGS.values():
        pkg.mgr.reset_stores()


# ---------------- shared helpers of the test_torch_service_* files ----------------

def write_corpus(path, rows: int = 6000, cols: int = 6, seed: int = 0) -> str:
    """tests/test_service.py's corpus: libsvm, ``rows`` rows of ``cols``
    normal features, labels alternating."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(rows):
            feats = " ".join(f"{j}:{rng.normal():.4f}" for j in range(cols))
            f.write(f"{i % 2} {feats}\n")
    return str(path)


def block_key(blk) -> tuple:
    """A block's arrays as bytes, and its resume annotation as JSON."""
    arrs = tuple(None if a is None else np.ascontiguousarray(a).tobytes()
                 for a in (blk.offset, blk.label, blk.index, blk.value, blk.weight,
                           blk.qid, blk.field))
    return arrs + (json.dumps(getattr(blk, "resume_state", None), sort_keys=True),)


def drain_keys(parser, close: bool = True) -> list:
    out = []
    while (blk := parser.next_block()) is not None:
        out.append(block_key(blk))
    if close:
        parser.close()
    return out


def local_keys(path: str, num_parts: int = NUM_PARTS, cfg=None) -> list:
    """The single-host reference stream, parts in order, with the config the
    dispatcher ships."""
    kw = dict(cfg or PARSER_CFG)
    kw.pop("format", None)
    out = []
    for p in range(num_parts):
        out.extend(drain_keys(create_parser(path, p, num_parts, "libsvm", **kw)))
    return out


@pytest.fixture
def corpus(tmp_path):
    return write_corpus(tmp_path / "c.libsvm")


# ---------------- goldens ----------------

def _golden_block(R=RowBlock) -> tuple:
    block = R(offset=np.array([0, 2, 3, 5], np.int64),
              label=np.array([1.0, 0.0, 1.0], np.float32),
              index=np.array([1, 5, 7, 0, 3], np.uint64),
              value=np.array([0.5, 1.5, 2.5, -1.0, 4.25], np.float32),
              weight=np.array([1.0, 2.0, 0.5], np.float32),
              qid=np.array([4, 4, 9], np.int64))
    resume = {"kind": "split", "split": {"kind": "byte", "file": 0, "offset": 4242},
              "chunks": 3}
    return block, resume


def _golden_v2_block(R=RowBlock) -> tuple:
    rows, nnz = 32, 256
    off = np.linspace(0, nnz, rows + 1).astype(np.int64)
    off[-1] = nnz
    block = R(offset=off, label=(np.arange(rows, dtype=np.float32) % 2),
              index=(np.arange(nnz, dtype=np.uint64) * 7) % 997,
              value=(np.arange(nnz, dtype=np.float32) * 0.25 - 8.0))
    resume = {"kind": "split", "split": {"kind": "byte", "file": 0, "offset": 123},
              "chunks": 7}
    return block, resume


def test_golden_v1_rewritten_byte_for_byte():
    with open(os.path.join(DATA_DIR, "service_frame_v1.golden"), "rb") as f:
        want = f.read()
    block, resume = _golden_block()
    assert port_frame.encode_block_frame(block, resume) == want
    kind, meta, payload = port_frame.decode_frame(want)
    got = port_frame.block_from_frame(meta, payload)
    assert kind == port_frame.KIND_BLOCK
    assert block_key(got)[:-1] == block_key(block)[:-1]
    assert got.resume_state == resume


def test_golden_v2_rewritten_byte_for_byte():
    with open(os.path.join(DATA_DIR, "service_frame_v2.golden"), "rb") as f:
        want = f.read()
    block, resume = _golden_v2_block()
    v1 = port_frame.encode_block_frame(block, resume)
    _, meta, payload = port_frame.decode_frame(v1)
    assert port_frame.encode_block_frame_v2(meta, payload, "zlib") == want
    _, meta2, payload2 = port_frame.decode_frame(want)
    assert bytes(payload2) == bytes(payload)
    assert {k: bool(e) for k, (_, _, e) in meta2["wire"].items()} == {
        "offset": True, "index": True, "label": False, "value": False}


# ---------------- BLOCK frames across the packages ----------------

def _random_block(pkg, seed: int, optional: frozenset):
    rng = np.random.default_rng(seed)
    rows = int(rng.integers(1, 60))
    lens = rng.integers(0, 9, rows)
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    nnz = int(off[-1])
    kw = dict(offset=off, label=rng.normal(size=rows).astype(np.float32),
              index=rng.integers(0, 1 << 40, nnz).astype(np.uint64))
    if "value" in optional:
        kw["value"] = rng.normal(size=nnz).astype(np.float32)
    if "weight" in optional:
        kw["weight"] = rng.random(rows).astype(np.float32)
    if "qid" in optional:
        kw["qid"] = rng.integers(0, 9, rows).astype(np.int64)
    if "field" in optional:
        kw["field"] = rng.integers(0, 5, nnz).astype(np.int64)
    resume = {"kind": "split", "split": {"kind": "byte", "file": seed, "offset": 7 * seed},
              "chunks": (seed, "tuple")}
    return PKGS[pkg].RowBlock(**kw), resume


OPTIONALS = [frozenset(), frozenset({"value"}), frozenset({"value", "weight"}),
             frozenset({"value", "weight", "qid"}), frozenset({"qid", "field"}),
             frozenset({"value", "weight", "qid", "field"})]


@PAIRS
@pytest.mark.parametrize("opt", range(len(OPTIONALS)))
def test_block_frames_cross_decode(enc, dec, opt):
    frames = []
    for seed in range(4):
        block, resume = _random_block(enc, 100 * opt + seed, OPTIONALS[opt])
        frame = PKGS[enc].frame.encode_block_frame(block, resume)
        other = PKGS["jax" if enc == "port" else "port"]
        twin, _ = _random_block(other.name, 100 * opt + seed, OPTIONALS[opt])
        assert frame == other.frame.encode_block_frame(twin, resume)
        kind, meta, payload = PKGS[dec].frame.decode_frame(frame)
        got = PKGS[dec].frame.block_from_frame(meta, payload)
        assert kind == PKGS[dec].frame.KIND_BLOCK
        assert block_key(got)[:-1] == block_key(block)[:-1]
        assert got.resume_state == json.loads(json.dumps(resume))
        frames.append(frame)
    # v2: the same compressed bytes from both, inflating to the v1 payload
    for frame in frames:
        _, meta, payload = PKGS[enc].frame.decode_frame(frame)
        for codec in ("zlib",):
            a = PKGS[enc].frame.encode_block_frame_v2(meta, payload, codec)
            b = PKGS[dec].frame.encode_block_frame_v2(meta, payload, codec)
            assert a == b
            if a is not None:
                _, meta2, p2 = PKGS[dec].frame.decode_frame(a)
                assert bytes(p2) == bytes(payload)
                assert meta2["codec"] == codec


@pytest.mark.skipif(not native.available(), reason="native core unavailable")
def test_batch_engine_block_frames_reuse_its_bytes(tmp_path):
    """A ``native-batch`` block (``encoded`` attached) frames as its
    re-encoded copy does, and as the JAX package frames its own."""
    path = tmp_path / "f.libsvm"
    rng = np.random.default_rng(0)
    path.write_text("".join(f"{i % 2} " + " ".join(f"{j}:{rng.normal():.5f}" for j in range(4))
                            + "\n" for i in range(150)))
    frames = {}
    for pkg in PKGS:
        p = PKGS[pkg].create_parser(str(path), 0, 1, "libsvm", threaded=False,
                                    engine="native-batch", chunk_bytes=4096)
        block = p.next_block()
        p.close()
        assert block.encoded is not None
        resume = {"kind": "blocks", "blocks": 1}
        fast = PKGS[pkg].frame.encode_block_frame(block, resume=resume)
        plain_block = PKGS[pkg].RowBlock.from_segments(block.to_segments())
        assert getattr(plain_block, "encoded", None) is None
        assert bytes(fast) == bytes(PKGS[pkg].frame.encode_block_frame(plain_block, resume))
        frames[pkg] = bytes(fast)
    assert frames["port"] == frames["jax"]


@PAIRS
def test_control_frames_and_reframe(enc, dec):
    E, D = PKGS[enc].frame, PKGS[dec].frame
    other = PKGS["jax" if enc == "port" else "port"].frame
    cases = [E.encode_end_frame(3, 17), E.encode_end_frame(0, 0, draining=True),
             E.encode_error_frame("worker w1 does not serve job j part 4"),
             E.encode_error_frame("draining", draining=True),
             E.encode_hello_frame({"wire": 2, "codec": "zlib", "blocks": 9}),
             E.encode_hello_frame({"wire": 2, "codec": None,
                                   "fastpath": {"path": "/x.bc", "blocks": 3}})]
    twins = [other.encode_end_frame(3, 17), other.encode_end_frame(0, 0, draining=True),
             other.encode_error_frame("worker w1 does not serve job j part 4"),
             other.encode_error_frame("draining", draining=True),
             other.encode_hello_frame({"wire": 2, "codec": "zlib", "blocks": 9}),
             other.encode_hello_frame({"wire": 2, "codec": None,
                                       "fastpath": {"path": "/x.bc", "blocks": 3}})]
    assert cases == twins
    for frame in cases:
        a, b = D.decode_frame(frame), E.decode_frame(frame)
        assert (a[0], a[1], bytes(a[2])) == (b[0], b[1], bytes(b[2]))
    block, resume = _golden_v2_block(PKGS[enc].RowBlock)
    v1 = E.encode_block_frame(block, resume)
    h1, body1 = E.reframe_v2(v1)
    h2, body2 = D.reframe_v2(v1)
    assert bytes(h1) == bytes(h2) and bytes(body1) == bytes(body2)
    k, meta, payload = D.decode_frame(bytes(h1) + bytes(body1))
    assert k == D.KIND_BLOCK and meta == E.decode_frame(v1)[1]


# ---------------- SNAPSHOT frames and the worker's packing ----------------

def _dense_blocks(pkg, seed: int, rows: int, nc: int, weights: bool):
    """RowBlocks of a dense-in-sparse corpus (label and weight bf16-exact)."""
    rng = np.random.default_rng(seed)
    out, pos = [], 0
    while pos < rows:
        n = int(min(rng.integers(5, 40), rows - pos))
        k = nc - 1
        kw = dict(offset=np.arange(n + 1, dtype=np.int64) * k,
                  label=(np.arange(pos, pos + n) % 2).astype(np.float32),
                  index=np.tile(np.arange(k, dtype=np.uint64), n),
                  value=rng.normal(size=n * k).astype(np.float32))
        if weights:
            kw["weight"] = rng.choice([0.5, 1.0, 2.0], n).astype(np.float32)
        blk = PKGS[pkg].RowBlock(**kw)
        blk.resume_state = {"kind": "split", "at": pos + n}
        out.append(blk)
        pos += n
    return out


def _bits(arr) -> bytes:
    """The bytes of a slab, a torch.bfloat16 tensor's as its words."""
    if isinstance(arr, torch.Tensor):
        if arr.dtype == torch.bfloat16:
            return arr.contiguous().view(torch.int16).numpy().tobytes()
        return arr.contiguous().numpy().tobytes()
    return np.ascontiguousarray(arr).tobytes()


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("weights", [False, True])
def test_pack_dense_batches_matches_reference(x_dtype, drop, weights):
    B, nc = 16, 6
    port_dt = "bfloat16" if x_dtype == "bfloat16" else None
    jax_dt = ml_dtypes.bfloat16 if x_dtype == "bfloat16" else None
    got = list(port_device.pack_dense_batches(
        _dense_blocks("port", 3, 101, nc, weights), B, nc, dtype=port_dt,
        drop_remainder=drop))
    want = list(jax_device.pack_dense_batches(
        _dense_blocks("jax", 3, 101, nc, weights), B, nc, dtype=jax_dt,
        drop_remainder=drop))
    assert len(got) == len(want) == (6 if drop else 7)
    for (p, pr), (j, jr) in zip(got, want):
        assert tuple(p.shape) == j.shape == (B, nc + 2)
        assert _bits(p) == _bits(j)
        assert pr == jr
    # also from a torch.bfloat16 dtype argument
    if x_dtype == "bfloat16":
        again = list(port_device.pack_dense_batches(
            _dense_blocks("port", 3, 101, nc, weights), B, nc, dtype=torch.bfloat16,
            drop_remainder=drop))
        assert [_bits(p) for p, _ in again] == [_bits(p) for p, _ in got]


def test_pack_dense_batches_bf16_refusal_matches_reference():
    def blocks(pkg):
        blk = PKGS[pkg].RowBlock(offset=np.array([0, 1, 2], np.int64),
                                 label=np.array([0.1, 1.0], np.float32),
                                 index=np.array([0, 1], np.uint64),
                                 value=np.array([1.0, 2.0], np.float32))
        return [blk]
    with pytest.raises(JaxDMLCError) as want:
        list(jax_device.pack_dense_batches(blocks("jax"), 2, 3, dtype=ml_dtypes.bfloat16))
    with pytest.raises(DMLCError) as got:
        list(port_device.pack_dense_batches(blocks("port"), 2, 3, dtype="bfloat16"))
    assert str(got.value) == str(want.value)
    with pytest.raises(DMLCError, match="not float32 or bfloat16"):
        list(port_device.pack_dense_batches(blocks("port"), 2, 3, dtype=np.float16))


@PAIRS
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_snapshot_frames_cross_decode(enc, dec, x_dtype):
    B, nc = 16, 6
    bf16 = x_dtype == "bfloat16"
    frames = {}
    for pkg in PKGS:
        dt = ((ml_dtypes.bfloat16 if pkg == "jax" else "bfloat16") if bf16 else None)
        frames[pkg] = [PKGS[pkg].frame.encode_snapshot_frame("dense_packed", (p,), rows=B,
                                                             resume=r)
                       for p, r in PKGS[pkg].device.pack_dense_batches(
                           _dense_blocks(pkg, 5, 70, nc, True), B, nc, dtype=dt)]
    assert frames["port"] == frames["jax"]
    for frame in frames[enc]:
        kind, meta, payload = PKGS[dec].frame.decode_frame(frame)
        assert kind == PKGS[dec].frame.KIND_SNAPSHOT
        assert meta["arrays"]["a0"][0] == ("bfloat16" if bf16 else "<f4")
        skind, arr = PKGS[dec].frame.snapshot_from_frame(meta, payload)
        assert skind == "dense_packed" and tuple(arr.shape) == (B, nc + 2)
        if dec == "port" and bf16:
            assert arr.dtype == np.uint16  # bfloat16 words on the host
        assert np.ascontiguousarray(arr).tobytes() == bytes(payload)[: B * (nc + 2) *
                                                                      (2 if bf16 else 4)]


@PAIRS
def test_snap_container_both_ways(enc, dec):
    frames = [PKGS[enc].frame.encode_end_frame(i, i + 1) for i in range(3)] + [b"x" * 17]
    blob = PKGS[enc].worker._encode_snap_container(frames)
    assert blob == PKGS[dec].worker._encode_snap_container(frames)
    assert [bytes(f) for f in PKGS[dec].worker._decode_snap_container(blob)] == frames
    for bad in (blob[:-1], blob + b"\0", b"DMLCSN02" + blob[8:], blob[:10]):
        assert PKGS[dec].worker._decode_snap_container(bad) is None
        assert PKGS[enc].worker._decode_snap_container(bad) is None


# ---------------- decode errors ----------------

def _bad_frames():
    block, resume = _golden_v2_block(RowBlock)
    v1 = port_frame.encode_block_frame(block, resume)
    _, meta, payload = port_frame.decode_frame(v1)
    v2 = port_frame.encode_block_frame_v2(meta, payload, "zlib")
    magic = b"XSRV" + v1[4:]
    version = v1[:4] + bytes([7]) + v1[5:]
    flipped = bytearray(v1)
    flipped[port_frame.HEADER_LEN + 30] ^= 0xFF
    # a v2 frame naming a codec no one has (a valid crc over a valid meta)
    m2 = dict(meta, codec="snappy", wire={"offset": [0, 8, 1]}, raw_len=len(payload))
    unknown = port_frame._pack(port_frame.KIND_BLOCK, m2, bytes(payload), version=2)
    return {"truncated": v1[:10], "torn": v2[: len(v2) // 2], "magic": magic,
            "version": version, "length": v1 + b"\0", "crc": bytes(flipped),
            "codec": unknown}


@pytest.mark.parametrize("case", ["truncated", "torn", "magic", "version", "length", "crc",
                                  "codec"])
def test_decode_errors_match_reference(case):
    frame = _bad_frames()[case]
    with pytest.raises(jax_frame.ServiceFrameError) as want:
        jax_frame.decode_frame(frame)
    with pytest.raises(port_frame.ServiceFrameError) as got:
        port_frame.decode_frame(frame)
    assert str(got.value) == str(want.value)
    assert resilience.classify(got.value) == resilience.RETRYABLE
    assert jax_resilience.classify(want.value) == jax_resilience.RETRYABLE
    assert isinstance(got.value, DMLCError) and isinstance(got.value.__cause__, ConnectionError)


# ---------------- frames over a socket ----------------

@PAIRS
def test_frames_over_a_socket_pair(enc, dec):
    block, resume = _golden_v2_block(PKGS[enc].RowBlock)
    E, D = PKGS[enc].frame, PKGS[dec].frame
    v1 = E.encode_block_frame(block, resume)
    header, body = E.reframe_v2(v1)
    _, meta, payload = E.decode_frame(v1)
    v2 = E.encode_block_frame_v2(meta, payload, "zlib")
    a, b = socket.socketpair()
    got = []

    def reader():
        for _ in range(4):
            got.append(D.recv_frame(b))

    t = threading.Thread(target=reader)
    t.start()
    try:
        E.send_frame(a, v1)
        assert E.send_frame_vectored(a, (header, body)) == len(v1)
        E.send_frame(a, v2)
        E.send_frame(a, E.encode_end_frame(2, 1))
    finally:
        t.join(10)
        a.close()
    assert not t.is_alive()
    b.close()
    assert [g[0] for g in got] == [D.KIND_BLOCK] * 3 + [D.KIND_END]
    assert all(bytes(g[2]) == bytes(payload) for g in got[:3])
    assert got[3][1] == {"part": 2, "blocks": 1}
    # a peer hangup mid-frame is a ConnectionError in both
    a, b = socket.socketpair()
    a.sendall(v1[: len(v1) // 2])
    a.close()
    with pytest.raises(ConnectionError):
        D.recv_frame(b)
    b.close()


# ---------------- negotiation, break-even and trace helpers ----------------

@pytest.mark.parametrize("accept", [[], ["zlib"], ["snappy"], ["lz4", "zlib"],
                                    ["zstd", "lz4", "zlib"], None, ("zlib", "zlib")])
def test_negotiate_codec_matches_reference(accept):
    assert port_frame.negotiate_codec(accept) == jax_frame.negotiate_codec(accept)
    assert sorted(port_frame.WIRE_CODECS) == sorted(jax_frame.WIRE_CODECS)
    assert port_frame.WIRE_CODEC_PREFERENCE == jax_frame.WIRE_CODEC_PREFERENCE


def test_break_even_decisions_and_constants_match_reference():
    for dt in ("<i8", "<u8", "<f4", "|u1", "<i4", "bfloat16", ">f8", "=u2"):
        assert port_frame._dtype_compressible(dt) == jax_frame._dtype_compressible(dt)
    for name in ("FRAME_MAGIC", "FRAME_VERSION", "FRAME_VERSION_2", "KIND_BLOCK", "KIND_END",
                 "KIND_ERROR", "KIND_SNAPSHOT", "KIND_HELLO", "HEADER_LEN", "MAX_FRAME_BYTES",
                 "TRACE_KEY", "_KEEP_RATIO", "_MIN_COMPRESS_BYTES"):
        assert getattr(port_frame, name) == getattr(jax_frame, name), name
    assert port_worker._SNAP_SHARE_MAGIC == jax_worker._SNAP_SHARE_MAGIC


@pytest.mark.parametrize("wire", [None, {}, {"tid": "t1", "sid": "s1"}, {"tid": "t1"},
                                  "garbage", {"tid": 3, "sid": 4}])
def test_extract_trace_matches_reference(wire):
    req = {"cmd": "stream"} if wire is None else {"cmd": "stream", "trace": wire}
    assert port_frame.extract_trace(req) == jax_frame.extract_trace(req)
    assert port_frame.extract_trace("not a dict") == jax_frame.extract_trace("not a dict")
    assert port_frame.attach_trace({"cmd": "x"}) == jax_frame.attach_trace({"cmd": "x"})
