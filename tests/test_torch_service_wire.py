"""The wire between the packages: a port ``ServiceParser`` against a JAX
``LocalFleet`` and a JAX client against a port fleet, each stream equal
byte for byte to local parsing and to the same-package pair's.

- every fleet x client pair on wire v2 (the preferred codec both ends
  have: zstd where ``zstandard`` is installed, else zlib), with
  compression off, and
  on the v1 push plane (``_offer_wire = 1``; a v1 worker through the v2
  offer's fallback), two epochs each, the stream's blocks and resume
  annotations equal to the local loop over ``create_parser(path, p, n)``;
- the wire ledger (``service_wire_bytes_raw`` / ``_sent``) a fleet of each
  package records for the same epoch, equal;
- a mid-epoch ``state_dict`` of one package's client restored into the
  other's, the rest of the epoch equal;
- ``resize_pipeline_depth`` and ``pipeline_depth`` as JAX's;
- the co-located fast path over a ``share_dir`` fleet: the second epoch
  served off the published caches (``fastpath_blocks``) by either client
  from either fleet, equal to the wire's, and a fast-path checkpoint
  restored fresh;
- snapshot frames (``Dispatcher(snapshot=...)``) streamed across the
  packages, the packed slabs equal;
- the factories: ``create_parser(service=)``, the ``#service=`` fragment
  with ``?job=``, ``create_row_block_iter(service=)``, ``URISpec``, and
  the refusals, with JAX's messages.
"""

from __future__ import annotations

import numpy as np
import pytest

from dmlc_tpu.data import create_parser as jax_create_parser
from dmlc_tpu.data import iterators as jax_iters
from dmlc_tpu.io.uri import URISpec as JaxURISpec
from dmlc_tpu.utils import telemetry as jax_telemetry
from dmlc_tpu_torch.data import create_parser, iterators
from dmlc_tpu_torch.io.uri import URISpec
from dmlc_tpu_torch.utils import telemetry as port_telemetry
from dmlc_tpu_torch.utils.check import DMLCError
from test_torch_service_frame import (  # noqa: F401
    NUM_PARTS, PARSER_CFG, PKGS, block_key, corpus, drain_keys, local_keys)

PAIRS = pytest.mark.parametrize("fleet_pkg,client_pkg",
                                [(f, c) for f in PKGS for c in PKGS])
TELEMETRY = {"port": port_telemetry, "jax": jax_telemetry}


def _fleet(pkg, path, parts=NUM_PARTS, **kw):
    return PKGS[pkg].LocalFleet(path, parts, num_workers=kw.pop("num_workers", 2),
                                parser=kw.pop("parser", PARSER_CFG), **kw)


@PAIRS
@pytest.mark.parametrize("mode", ["v2", "v2_off", "v1"])
def test_streams_equal_across_packages(corpus, monkeypatch, fleet_pkg, client_pkg, mode):
    if mode == "v2_off":
        monkeypatch.setenv("DMLC_TPU_WIRE_COMPRESSION", "off")
    want = local_keys(corpus)
    fleet = _fleet(fleet_pkg, corpus)
    try:
        sp = PKGS[client_pkg].ServiceParser(fleet.address)
        if mode == "v1":
            sp._offer_wire = 1
        first = block_key(sp.next_block())
        # the stream's negotiated wire and codec
        assert sp._wire == (1 if mode == "v1" else 2)
        best = PKGS[fleet_pkg].frame.negotiate_codec(sorted(PKGS[client_pkg].frame.WIRE_CODECS))
        assert sp._codec == (best if mode == "v2" else None)
        assert [first] + drain_keys(sp, close=False) == want
        sp.before_first()
        assert drain_keys(sp) == want
    finally:
        fleet.close()


@PAIRS
def test_v1_worker_fallback_across_packages(corpus, monkeypatch, fleet_pkg, client_pkg):
    """A worker that ignores the v2 offer pushes v1 frames: the client's
    handshake peek keeps the frame and the epoch is local parsing's."""
    W = PKGS[fleet_pkg].worker.ParseWorker
    monkeypatch.setattr(W, "_serve_stream_v2",
                        lambda self, conn, rfile, job, part, accept, host:
                        self._serve_stream(conn, job, part, 0))
    fleet = _fleet(fleet_pkg, corpus)
    try:
        sp = PKGS[client_pkg].ServiceParser(fleet.address)
        assert drain_keys(sp, close=False) == local_keys(corpus)
        assert sp._wire == 1 and sp.fastpath_blocks == 0
        sp.close()
    finally:
        fleet.close()


def test_wire_ledgers_equal(corpus):
    out = {}
    for pkg in PKGS:
        tel = TELEMETRY[pkg]
        raw0 = tel.REGISTRY.counter(tel.SERVICE_WIRE_RAW_METRIC, job="default").value
        sent0 = tel.REGISTRY.counter(tel.SERVICE_WIRE_SENT_METRIC, job="default").value
        fleet = _fleet(pkg, corpus)
        try:
            drain_keys(PKGS[pkg].ServiceParser(fleet.address))
        finally:
            fleet.close()
        out[pkg] = (tel.REGISTRY.counter(tel.SERVICE_WIRE_RAW_METRIC, job="default").value
                    - raw0,
                    tel.REGISTRY.counter(tel.SERVICE_WIRE_SENT_METRIC, job="default").value
                    - sent0)
    assert out["port"] == out["jax"]
    raw, sent = out["port"]
    assert 0 < sent < raw


@PAIRS
@pytest.mark.parametrize("at", [1, 5, 11])
def test_state_restored_across_packages(corpus, fleet_pkg, client_pkg, at):
    want = local_keys(corpus)
    other = "jax" if client_pkg == "port" else "port"
    fleet = _fleet(fleet_pkg, corpus)
    try:
        sp = PKGS[client_pkg].ServiceParser(fleet.address)
        first = [block_key(sp.next_block()) for _ in range(at)]
        state = sp.state_dict()
        sp.close()
        sp2 = PKGS[other].ServiceParser(fleet.address)
        sp2.load_state(state)
        assert sp2.state_dict() == state
        assert first + drain_keys(sp2) == want
    finally:
        fleet.close()


def test_pipeline_depth_contract_matches_reference(corpus, monkeypatch):
    out = {}
    for pkg in PKGS:
        monkeypatch.setenv("DMLC_TPU_SERVICE_PIPELINE_DEPTH", "3")
        fleet = _fleet(pkg, corpus, num_workers=1)
        try:
            sp = PKGS[pkg].ServiceParser(fleet.address)
            out[pkg] = [sp.pipeline_depth, sp.resize_pipeline_depth(8), sp.pipeline_depth,
                        sp.resize_pipeline_depth(8), sp.resize_pipeline_depth(0),
                        sp.pipeline_depth, len(drain_keys(sp))]
        finally:
            fleet.close()
    assert out["port"] == out["jax"]
    assert out["port"][:6] == [3, True, 8, False, False, 8]


@PAIRS
def test_fastpath_across_packages(corpus, tmp_path, fleet_pkg, client_pkg):
    """A co-located client maps the fleet's published caches (written by
    either package's workers) for the second epoch: no TCP, the same
    blocks; a checkpoint off the fast path restores fresh."""
    share = str(tmp_path / "share")
    want = local_keys(corpus)
    fleet = _fleet(fleet_pkg, corpus, share_dir=share)
    try:
        sp = PKGS[client_pkg].ServiceParser(fleet.address)
        assert drain_keys(sp, close=False) == want
        sp.before_first()
        fp0 = sp.fastpath_blocks
        first = [block_key(sp.next_block()) for _ in range(7)]
        state = sp.state_dict()
        rest = drain_keys(sp)
        assert first + rest == want
        assert sp.fastpath_blocks - fp0 == len(want)
        sp2 = PKGS[client_pkg].ServiceParser(fleet.address)
        sp2.load_state(state)
        assert drain_keys(sp2) == rest
    finally:
        fleet.close()


@PAIRS
def test_snapshot_frames_across_packages(corpus, fleet_pkg, client_pkg):
    geo = {"batch_size": 256, "num_col": 7, "x_dtype": "bfloat16"}
    fleet = _fleet(fleet_pkg, corpus, snapshot=geo)
    try:
        out = {}
        for pkg in PKGS:
            sp = PKGS[pkg].ServiceParser(fleet.address)
            got = []
            while (blk := sp.next_block()) is not None:
                assert blk.packed and len(blk) == 256
                raw, layout, kind = blk.device_span
                assert kind == "dense_packed" and raw.dtype == np.uint8
                got.append((np.ascontiguousarray(blk.x).view(np.uint16).tobytes(),
                            raw.tobytes(), sp.state_dict()))
            sp.close()
            out[pkg] = got
        assert out["port"] == out["jax"]
        assert len(out[client_pkg]) == 24  # 2000 rows a part: 8 batches of 256, the last padded
    finally:
        fleet.close()


# ---------------- the factories ----------------

def test_factories_route_to_the_service(corpus):
    fleet = _fleet("port", corpus)
    try:
        want = local_keys(corpus)
        addr = fleet.address
        for uri, kw in ((corpus, {"service": addr}), (f"{corpus}#service={addr}", {}),
                        (f"{corpus}?job=default#service={addr}", {}),
                        ("ignored.libsvm", {"service": addr, "service_job": "default"})):
            p = create_parser(uri, **kw)
            assert type(p).__name__ == "ServiceParser" and p.job == "default"
            assert drain_keys(p) == want
        blocks = list(iterators.create_row_block_iter(corpus, service=addr, silent=True))
        jblocks = list(jax_iters.create_row_block_iter(corpus, service=addr, silent=True))
        ref = [block_key(b)[:-1] for b in jblocks]
        assert [block_key(b)[:-1] for b in blocks] == ref
        assert sum(len(b) for b in blocks) == 6000
        rows = iterators.create_row_block_iter(f"{corpus}#service={addr}", silent=True)
        assert [block_key(b)[:-1] for b in rows] == ref
    finally:
        fleet.close()


def test_factory_refusals_match_reference(corpus):
    cases = [dict(part_index=1, num_parts=2), dict(shuffle_seed=3), dict(shuffle_window=8),
             dict(pod_sharding=True), dict(snapshot="/s")]
    for kw in cases:
        kw = dict(kw)
        part, nparts = kw.pop("part_index", 0), kw.pop("num_parts", 1)
        with pytest.raises(Exception) as want:
            jax_create_parser(corpus, part, nparts, service="127.0.0.1:1", **kw)
        with pytest.raises(DMLCError) as got:
            create_parser(corpus, part, nparts, service="127.0.0.1:1", **kw)
        assert str(got.value) == str(want.value)
    for kw in (dict(shuffle_seed=3), dict(pod_sharding=(0, 2))):
        with pytest.raises(Exception) as want:
            jax_iters.create_row_block_iter(corpus, service="127.0.0.1:1", silent=True, **kw)
        with pytest.raises(DMLCError) as got:
            iterators.create_row_block_iter(corpus, service="127.0.0.1:1", silent=True, **kw)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("uri", ["d#service=h:1", "d?job=b#service=10.0.0.1:9",
                                 "d?format=csv&job=x#service=host:80", "d#service=",
                                 "d#service=nohost", "d#blockcache=/b", "d#snapshot=/s",
                                 "d#cache"])
@pytest.mark.parametrize("part,nparts", [(0, 1), (1, 3)])
def test_uri_service_fragment_matches_reference(uri, part, nparts):
    try:
        want = JaxURISpec(uri, part, nparts)
    except Exception as exc:  # noqa: BLE001 - the refusal is compared
        with pytest.raises(DMLCError) as got:
            URISpec(uri, part, nparts)
        assert str(got.value) == str(exc)
        return
    got = URISpec(uri, part, nparts)
    assert (got.uri, got.args, got.cache_file, got.block_cache, got.snapshot, got.service) == (
        want.uri, want.args, want.cache_file, want.block_cache, want.snapshot, want.service)
