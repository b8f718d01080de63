"""Many jobs on one fleet, and the service feeding the learners, through
both packages.

- three jobs on one ``share_dir`` fleet (two over the same corpus): the
  shared corpus parsed once fleet-wide, the second job served warm, each
  stream local parsing's, the parse ledger (``parts_cold`` /
  ``parts_warm``) and the counters equal to the JAX fleet's;
- the cold-build claim: a job registered while a sibling's only part is
  mid-cold-pass waits for the publish (``service_parse_claim_waits`` 1)
  and one part is parsed, on fleets mixing the packages;
- a job-bound checkpoint restored, and refused for another job with JAX's
  message; a worker multiplexing two jobs with a store each;
- the dispatcher killed mid-epoch with two jobs registered: both recover;
- ``DeviceIter(ell, device="cpu")`` fed by the port's service into
  ``LinearLearner``: 20 steps within 1e-5 of the JAX learner fed by the
  JAX service, from the JAX learner's initial table;
- snapshot frames (``Dispatcher(snapshot=...)``, bf16 and f32) through
  ``DeviceIter(dense, pack_aux=True, device_decode=True, device="cpu")``
  with no snapshot: each batch decoded by K2's plain version from the
  frame's span (``device_decode_bytes``), bit-equal to the host route and
  to the JAX ``DeviceIter``'s decode of the same frames;
- fault C16: ``DeviceIter(device_decode=True)`` without a snapshot is
  accepted, as in JAX, and gives the batches of the flag off (dense and
  ell, local parsing), in both packages.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import pytest
import torch

from dmlc_tpu.data.device import DeviceIter as JaxDeviceIter
from dmlc_tpu.models.linear import LinearLearner as JaxLinearLearner
from dmlc_tpu_torch import convert
from dmlc_tpu_torch.data import DeviceIter
from dmlc_tpu_torch.models import LinearLearner
from test_torch_service_frame import (  # noqa: F401
    NUM_PARTS, PARSER_CFG, PKGS, block_key, corpus, drain_keys, local_keys, write_corpus)

TOL = 1e-5
OTHER_PARTS = 2
MIXED = pytest.mark.parametrize("disp_pkg,worker_pkg",
                                [(d, w) for d in PKGS for w in PKGS])


@pytest.fixture
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def _other(tmp_path):
    return write_corpus(tmp_path / "other.libsvm", rows=900, cols=4, seed=3)


def _drain_job(pkg, address, job):
    return drain_keys(PKGS[pkg].ServiceParser(address, job=job))


def test_jobs_share_a_corpus_parsed_once(corpus, tmp_path):
    other = _other(tmp_path)
    keys = ("service_parts_parsed", "service_parts_shared", "service_giveups")
    out = {}
    for pkg in PKGS:
        P = PKGS[pkg]
        share = str(tmp_path / f"share_{pkg}")
        base = P.resilience.counters_snapshot()
        fleet = P.LocalFleet(corpus, NUM_PARTS, num_workers=2, parser=PARSER_CFG,
                             share_dir=share)
        try:
            a = _drain_job(pkg, fleet.address, "default")
            resp = fleet.register_job("b", corpus, NUM_PARTS, parser=PARSER_CFG)
            assert resp["share_sig"] and resp["parser"]["block_cache"].startswith(share)
            b = _drain_job(pkg, fleet.address, "b")
            fleet.register_job("c", other, OTHER_PARTS, parser=PARSER_CFG)
            c = _drain_job(pkg, fleet.address, "c")
            assert a == b == local_keys(corpus) and c == local_keys(other, OTHER_PARTS)
            cold = sorted(jp for w in fleet.workers for jp in w.parts_cold)
            warm = sorted(jp for w in fleet.workers for jp in w.parts_warm)
            d = P.resilience.counters_delta(base)
            out[pkg] = (cold, warm, {k: d.get(k, 0) for k in keys},
                        sorted(n.split(".", 1)[1] for n in os.listdir(share)
                               if n.startswith("svc-") and ".part" in n))
        finally:
            fleet.close()
    assert out["port"] == out["jax"]
    cold, warm, counts, _ = out["port"]
    assert warm == [("b", p) for p in range(NUM_PARTS)]
    assert counts == {"service_parts_parsed": NUM_PARTS + OTHER_PARTS,
                      "service_parts_shared": NUM_PARTS, "service_giveups": 0}


@MIXED
def test_cold_build_claim_wait_serves_warm(tmp_path, disp_pkg, worker_pkg):
    D, W = PKGS[disp_pkg], PKGS[worker_pkg]
    share = str(tmp_path / "share")
    # a corpus of a few blocks: each costs the straggler 0.3 s
    corpus = write_corpus(tmp_path / "small.libsvm", rows=1500)
    want = local_keys(corpus, 1)
    base = W.resilience.counters_snapshot()
    disp = D.dispatcher.Dispatcher(corpus, 1, parser=PARSER_CFG, share_dir=share)
    workers = [W.worker.ParseWorker(disp.address, poll_interval=0.02, heartbeat_interval=0.1,
                                    straggle_seconds=0.3) for _ in range(2)]
    try:
        sp_a = W.ServiceParser(disp.address)
        first = block_key(sp_a.next_block())
        D.dispatcher.register_job(disp.address, "b", corpus, 1, parser=PARSER_CFG)
        got_b = _drain_job(worker_pkg, disp.address, "b")
        got_a = [first] + drain_keys(sp_a)
        assert got_a == got_b == want
        d = W.resilience.counters_delta(base)
        assert (d["service_parts_parsed"], d["service_parts_shared"],
                d["service_parse_claim_waits"], d["service_giveups"]) == (1, 1, 1, 0)
    finally:
        for w in workers:
            w.close()
        disp.close()


def test_job_bound_checkpoint(corpus, tmp_path):
    other = _other(tmp_path)
    out = {}
    for pkg in PKGS:
        P = PKGS[pkg]
        fleet = P.LocalFleet(corpus, NUM_PARTS, num_workers=2, parser=PARSER_CFG)
        try:
            fleet.register_job("o", other, OTHER_PARTS, parser=PARSER_CFG)
            sp = P.ServiceParser(fleet.address, job="o")
            first = [block_key(sp.next_block()) for _ in range(2)]
            state = sp.state_dict()
            sp.close()
            sp2 = P.ServiceParser(fleet.address, job="o")
            sp2.load_state(state)
            assert first + drain_keys(sp2) == local_keys(other, OTHER_PARTS)
            sp3 = P.ServiceParser(fleet.address)
            with pytest.raises(P.DMLCError) as e:
                sp3.load_state(state)
            sp3.close()
            out[pkg] = (state, str(e.value).replace(fleet.address, "ADDR"))
        finally:
            fleet.close()
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("pkg", list(PKGS))
def test_worker_multiplexes_jobs(corpus, tmp_path, pkg):
    P = PKGS[pkg]
    other = _other(tmp_path)
    fleet = P.LocalFleet(corpus, NUM_PARTS, num_workers=1, parser=PARSER_CFG)
    try:
        fleet.register_job("o", other, OTHER_PARTS, parser=PARSER_CFG)
        out = {}

        def drain(job):
            out[job] = _drain_job(pkg, fleet.address, job)

        ts = [threading.Thread(target=drain, args=(j,)) for j in ("default", "o")]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert out["default"] == local_keys(corpus)
        assert out["o"] == local_keys(other, OTHER_PARTS)
        w = fleet.workers[0]
        assert sorted(w.parts_by_job) == ["default", "o"]
        assert sorted(w.parts_by_job["o"]) == [0, 1]
    finally:
        fleet.close()


@pytest.mark.parametrize("pkg", list(PKGS))
def test_dispatcher_killed_with_two_jobs(corpus, tmp_path, pkg):
    P = PKGS[pkg]
    other = _other(tmp_path)
    fleet = P.LocalFleet(corpus, NUM_PARTS, num_workers=2, parser=PARSER_CFG,
                         poll_interval=0.02, heartbeat_interval=0.1,
                         journal_path=str(tmp_path / "j.jsonl"))
    try:
        fleet.register_job("o", other, OTHER_PARTS, parser=PARSER_CFG)
        sp = P.ServiceParser(fleet.address, job="o")
        first = [block_key(sp.next_block())]
        fleet.kill_dispatcher()
        fleet.restart_dispatcher()
        assert first + drain_keys(sp) == local_keys(other, OTHER_PARTS)
        assert _drain_job(pkg, fleet.address, "default") == local_keys(corpus)
        assert sorted(fleet.dispatcher.jobs) == ["default", "o"]
    finally:
        fleet.close()


# ---------------- the service feeding the learners ----------------

def test_service_fed_learner_matches_reference(corpus, deterministic):
    """20 ELL steps fed by the port's fleet within 1e-5 of the JAX
    learner fed by the JAX fleet."""
    jax_l = JaxLinearLearner(7, layout="ell", learning_rate=0.3)
    port_l = LinearLearner(7, layout="ell", learning_rate=0.3, device="cpu")
    port_l.set_params(convert.linear_params_from_jax(*(np.asarray(p) for p in jax_l.params),
                                                     device="cpu"))
    pf = PKGS["port"].LocalFleet(corpus, NUM_PARTS, num_workers=2, parser=PARSER_CFG)
    jf = PKGS["jax"].LocalFleet(corpus, NUM_PARTS, num_workers=2, parser=PARSER_CFG)
    try:
        pit = DeviceIter(PKGS["port"].ServiceParser(pf.address),
                         num_col=port_l.device_num_col(), batch_size=512, layout="ell",
                         max_nnz=6, device="cpu")
        jit = JaxDeviceIter(PKGS["jax"].ServiceParser(jf.address),
                            num_col=port_l.device_num_col(), batch_size=512, layout="ell",
                            max_nnz=6)
        got, want = [], []
        while len(got) < 20:
            for pb, jb in zip(pit, jit):
                want.append(float(jax_l.step(jb)))
                got.append(float(port_l.step(pb)))
                if len(got) == 20:
                    break
            pit.reset()
            jit.reset()
        assert pit.stats()["batches"] == jit.stats()["batches"]
        pit.close()
        jit.close()
    finally:
        pf.close()
        jf.close()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    for p, j in zip(convert.linear_params_to_jax(port_l.params), jax_l.params):
        np.testing.assert_allclose(p, np.asarray(j), rtol=TOL, atol=TOL)


def _packed_bits(batch) -> bytes:
    x = batch.packed
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy().tobytes()
    x = np.asarray(x)
    return (x.view(np.int16) if x.dtype.itemsize == 2 else x).tobytes()


@pytest.mark.parametrize("fleet_pkg", list(PKGS))
@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
def test_snapshot_frames_decoded_from_their_span(corpus, fleet_pkg, x_dtype):
    geo = {"batch_size": 256, "num_col": 7, "x_dtype": x_dtype}
    fleet = PKGS[fleet_pkg].LocalFleet(corpus, NUM_PARTS, num_workers=2, parser=PARSER_CFG,
                                       snapshot=geo)
    try:
        def port_epoch(decode):
            it = DeviceIter(PKGS["port"].ServiceParser(fleet.address), num_col=7,
                            batch_size=256, layout="dense", pack_aux=True, x_dtype=x_dtype,
                            device_decode=decode, device="cpu")
            out = [_packed_bits(b) for b in it]
            st = it.stats()
            it.close()
            return out, st
        span, span_stats = port_epoch(True)
        host, host_stats = port_epoch(False)
        jit = JaxDeviceIter(PKGS["jax"].ServiceParser(fleet.address), num_col=7,
                            batch_size=256, layout="dense", pack_aux=True, x_dtype=x_dtype,
                            device_decode=True)
        ref = [_packed_bits(b) for b in jit]
        jit.close()
    finally:
        fleet.close()
    itemsize = 2 if x_dtype == "bfloat16" else 4
    assert len(span) == 24 and span == host == ref
    assert span_stats["device_decode_bytes"] == 24 * 256 * 9 * itemsize
    assert host_stats["device_decode_bytes"] == 0


@pytest.mark.parametrize("layout", ["dense", "ell"])
def test_c16_device_decode_without_snapshot(corpus, layout):
    """``device_decode=True`` with no snapshot is accepted, as in JAX, and
    acts on nothing: the batches are the flag-off batches, and the JAX
    package's."""
    kw = dict(num_col=7, batch_size=500, layout=layout)
    if layout == "ell":
        kw["max_nnz"] = 6

    def port_batches(decode):
        it = DeviceIter(PKGS["port"].create_parser(corpus, 0, 1, "libsvm"), device="cpu",
                        device_decode=decode, **kw)
        out = [[t.numpy().tobytes() for t in _tensors(b)] for b in it]
        assert it.stats()["device_decode_bytes"] == 0
        it.close()
        return out

    jit = JaxDeviceIter(PKGS["jax"].create_parser(corpus, 0, 1, "libsvm"),
                        device_decode=True, **kw)
    ref = [[np.asarray(t).tobytes() for t in _tensors(b)] for b in jit]
    jit.close()
    on, off = port_batches(True), port_batches(False)
    assert on == off == ref and len(on) == 12


def _tensors(batch):
    if hasattr(batch, "packed"):
        return [batch.packed]
    if hasattr(batch, "indices"):
        return [batch.indices, batch.values, batch.label, batch.weight]
    return list(batch)
