"""The port's DeviceIter over the snapshot store, against dmlc_tpu's.

On a 512-row, 6-column corpus at batch 64, for ELL, packed dense float32,
packed dense bfloat16, int8-quantized packed dense and unpacked dense
float32 and bfloat16 (``device="cpu"``, where K2's route takes its plain
version; a packed batch is compared as its slab and its ``x``, ``y`` and
``w``):

- a complete cold epoch publishes the snapshot, and the next epoch serves
  it (``snapshot_state == "warm"``);
- a warm ``device_decode=True`` epoch adds exactly 0 to
  ``convert_seconds`` and counts its raw span bytes; it decodes each batch
  with one ``decode_batch`` call, on one plan built for the whole epoch;
- its batches are byte-identical to the cold epoch's (the int8 path
  excepted: it stores a quantized copy) and to a host-decode warm epoch's;
- a snapshot written by the JAX package, served by the port with
  ``device_decode=True``, gives the bytes of JAX's own warm device-decode
  batches, and the reverse; the port's cold epoch and the snapshot it
  writes hold the same bytes as JAX's (bf16 cast and int8 quantization
  included).

Also: a reset mid-epoch publishes nothing, a non-bf16-exact label refuses
to pack, a crc mismatch removes the file and heals the epoch cold, byte for
byte as the JAX package heals it (or raises with no restart budget), a
geometry change makes the next epoch cold, and ``device_decode=True``
without a snapshot is accepted as in JAX (fault C16) and gives the
batches of the flag off.
"""

import os

import numpy as np
import pytest
import torch

from dmlc_tpu.data import create_parser as jax_create_parser
from dmlc_tpu.data.device import DeviceIter as JaxDeviceIter
from dmlc_tpu_torch.data import DeviceIter, PackedDenseBatch, create_parser
from dmlc_tpu_torch.io import resilience
from dmlc_tpu_torch.io.snapshot import SnapshotReader
from dmlc_tpu_torch.store import STORE_DIRNAME
from dmlc_tpu_torch.utils.check import CacheCorruptionError, DMLCError

NUM_COL, BATCH, ROWS = 6, 64, 512
CASES = {
    "ell": dict(layout="ell", max_nnz=NUM_COL),
    "dense_f32": dict(layout="dense"),
    "dense_bf16": dict(layout="dense", x_dtype="bfloat16", pack_aux=True),
    "q8": dict(layout="dense", snapshot_quant="int8"),
    "dense_unpacked_f32": dict(layout="dense", pack_aux=False),
    "dense_unpacked_bf16": dict(layout="dense", x_dtype="bfloat16"),
}


def _corpus(tmp_path, bf16_exact=True):
    rng = np.random.default_rng(7)
    path = tmp_path / "c.libsvm"
    with open(path, "w") as f:
        for i in range(ROWS):
            label = i % 2 if bf16_exact else 0.1 + 0.01 * i
            feats = " ".join(f"{j}:{rng.standard_normal():.6f}" for j in range(NUM_COL))
            f.write(f"{label} {feats}\n")
    return str(path)


def _port_iter(corpus, snap, **kw):
    return DeviceIter(create_parser(corpus, 0, 1, "libsvm", snapshot=snap),
                      num_col=NUM_COL, batch_size=BATCH, device="cpu", **kw)


def _jax_iter(corpus, snap, **kw):
    return JaxDeviceIter(jax_create_parser(corpus, 0, 1, "libsvm", snapshot=snap),
                         num_col=NUM_COL, batch_size=BATCH, **kw)


def _tensor_bytes(a) -> bytes:
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        return a.contiguous().numpy().tobytes()
    return np.asarray(a).tobytes()


def _batch_bytes(batch):
    arrays = [batch.packed, *batch] if hasattr(batch, "packed") else list(batch)
    return [_tensor_bytes(a) for a in arrays]


def _drain(it):
    out = [_batch_bytes(b) for b in it]
    it.reset()
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_cold_then_warm_device_decode_epochs(tmp_path, case):
    kw = CASES[case]
    corpus, snap = _corpus(tmp_path), str(tmp_path / "c.snapshot")
    dev = _port_iter(corpus, snap, device_decode=True, **kw)
    assert dev.stats()["snapshot_state"] == "cold"
    cold = _drain(dev)
    assert os.path.exists(snap) and len(cold) == ROWS // BATCH
    before = dev.stats()
    assert before["convert_seconds"] > 0 and before["device_decode_bytes"] == 0
    assert before["snapshot_write_seconds"] > 0
    warm_dev = [_batch_bytes(b) for b in dev]
    after = dev.stats()
    assert after["snapshot_state"] == "warm" and after["device_decode"] is True
    assert after["convert_seconds"] - before["convert_seconds"] == 0.0
    reader = SnapshotReader(snap)
    span_bytes = sum(reader.batch_nbytes(i) for i in range(reader.num_batches))
    reader.close()
    assert after["device_decode_bytes"] == span_bytes > 0
    assert after["bytes_to_device"] - before["bytes_to_device"] == span_bytes
    assert after["snapshot_read_seconds"] > 0 and after["device_decode_seconds"] > 0
    dev.close()
    host = _port_iter(corpus, snap, **kw)
    warm_host = [_batch_bytes(b) for b in host]
    s = host.stats()
    host.close()
    assert s["snapshot_state"] == "warm" and s["convert_seconds"] == 0.0
    assert s["device_decode_bytes"] == 0
    assert warm_dev == warm_host
    if case != "q8":  # the int8 snapshot holds a quantized copy
        assert warm_dev == cold


@pytest.mark.parametrize("case", list(CASES))
def test_warm_epoch_decodes_each_batch_once_on_one_plan(tmp_path, monkeypatch, case):
    from dmlc_tpu_torch.ops import device_decode as dd

    kw = CASES[case]
    corpus, snap = _corpus(tmp_path), str(tmp_path / "c.snapshot")
    it = _port_iter(corpus, snap, device_decode=True, **kw)
    _drain(it)  # cold: writes the snapshot, decodes nothing
    calls, built = [], []
    decode_batch, plan_init = dd.decode_batch, dd.DecodePlan.__init__

    def counting_decode(span, layout, kind, num_col):
        calls.append(kind)
        return decode_batch(span, layout, kind, num_col)

    def counting_init(self, *args):
        built.append(args[0])
        plan_init(self, *args)

    monkeypatch.setattr(dd, "_PLANS", {})
    monkeypatch.setattr(dd, "decode_batch", counting_decode)
    monkeypatch.setattr(dd.DecodePlan, "__init__", counting_init)
    warm = [_batch_bytes(b) for b in it]
    it.close()
    assert len(warm) == len(calls) == ROWS // BATCH and len(set(calls)) == 1
    assert built == calls[:1]  # one plan, for the first batch


@pytest.mark.parametrize("case", list(CASES))
def test_warm_batches_types(tmp_path, case):
    kw = CASES[case]
    corpus, snap = _corpus(tmp_path), str(tmp_path / "c.snapshot")
    it = _port_iter(corpus, snap, device_decode=True, **kw)
    _drain(it)
    batch = next(it)
    it.close()
    if case == "ell":
        assert batch.indices.dtype == torch.int32 and batch.values.dtype == torch.float32
        assert tuple(batch.values.shape) == (BATCH, NUM_COL)
        return
    if case.startswith("dense_unpacked"):
        assert isinstance(batch, tuple)
    else:
        assert isinstance(batch, PackedDenseBatch)
    x, y, w = batch
    want = torch.bfloat16 if case.endswith("bf16") else torch.float32
    assert x.dtype == want and tuple(x.shape) == (BATCH, NUM_COL)
    assert y.dtype == w.dtype == torch.float32
    assert set(y.tolist()) <= {0.0, 1.0} and bool((w == 1.0).all())


@pytest.mark.parametrize("case", list(CASES))
def test_snapshots_cross_between_packages(tmp_path, case):
    kw = CASES[case]
    corpus = _corpus(tmp_path)
    # written by JAX, served by both with device decode
    snap = str(tmp_path / "jax.snapshot")
    jax_cold = _drain(_jax_iter(corpus, snap, **kw))
    jax_warm = _jax_iter(corpus, snap, device_decode=True, **kw)
    want = [_batch_bytes(b) for b in jax_warm]
    assert jax_warm.stats()["snapshot_state"] == "warm"
    jax_warm.close()
    jax_written = want
    port = _port_iter(corpus, snap, device_decode=True, **kw)
    got = [_batch_bytes(b) for b in port]
    assert port.stats()["snapshot_state"] == "warm"
    assert port.stats()["convert_seconds"] == 0.0
    port.close()
    assert len(got) == ROWS // BATCH and got == want
    # written by the port, served by both with device decode
    snap = str(tmp_path / "port.snapshot")
    assert _drain(_port_iter(corpus, snap, **kw)) == jax_cold
    port = _port_iter(corpus, snap, device_decode=True, **kw)
    want = [_batch_bytes(b) for b in port]
    assert port.stats()["snapshot_state"] == "warm"
    port.close()
    # the port's own cast and quantization store what JAX's store
    assert want == jax_written
    jax_warm = _jax_iter(corpus, snap, device_decode=True, **kw)
    got = [_batch_bytes(b) for b in jax_warm]
    s = jax_warm.stats()
    jax_warm.close()
    assert s["snapshot_state"] == "warm" and s["stage_busy"]["convert"] == 0.0
    assert got == want


def test_reset_mid_epoch_publishes_nothing(tmp_path):
    corpus, snap = _corpus(tmp_path), str(tmp_path / "c.snapshot")
    it = _port_iter(corpus, snap)
    next(it)
    next(it)
    it.reset()
    # no snapshot, no staging file: the corpus and the store's sidecar
    assert sorted(os.listdir(tmp_path)) == [STORE_DIRNAME, "c.libsvm"]
    assert len(_drain(it)) == ROWS // BATCH
    assert os.path.exists(snap)
    next(it)
    assert it.stats()["snapshot_state"] == "warm"
    it.close()


def test_bf16_aux_must_be_exact(tmp_path):
    corpus = _corpus(tmp_path, bf16_exact=False)
    it = _port_iter(corpus, None, layout="dense", x_dtype="bfloat16", pack_aux=True)
    with pytest.raises(DMLCError, match="bf16-exact"):
        next(it)
    it.close()
    # unpacked, the labels stay float32 and nothing is lost
    it = _port_iter(corpus, None, layout="dense", x_dtype="bfloat16")
    x, y, _ = next(it)
    assert x.dtype == torch.bfloat16 and y.dtype == torch.float32
    it.close()


def _flip_byte_in_batch(snap: str, batch: int) -> None:
    reader = SnapshotReader(snap)
    pos = reader._batches[batch]["pos"] + 100
    reader.close()
    with open(snap, "r+b") as f:
        f.seek(pos)
        byte = f.read(1)
        f.seek(pos)
        f.write(bytes([byte[0] ^ 0x01]))


@pytest.mark.parametrize("device_decode,max_attempts", [
    pytest.param(False, None, id="False"),
    pytest.param(True, None, id="True"),
    pytest.param(False, "1", id="False-no_restart"),
    pytest.param(True, "1", id="True-no_restart"),
])
def test_crc_mismatch_drops_the_snapshot(tmp_path, monkeypatch, device_decode, max_attempts):
    corpus, snap = _corpus(tmp_path), str(tmp_path / "c.snapshot")
    first = _port_iter(corpus, snap)
    cold = _drain(first)
    first.close()
    _flip_byte_in_batch(snap, 3)
    if max_attempts is None:
        monkeypatch.delenv("DMLC_RETRY_MAX_ATTEMPTS", raising=False)
    else:
        monkeypatch.setenv("DMLC_RETRY_MAX_ATTEMPTS", max_attempts)
    it = _port_iter(corpus, snap, device_decode=device_decode)
    if max_attempts == "1":
        # no restart allowed: the error propagates as it always did
        with pytest.raises(CacheCorruptionError, match="crc mismatch on batch 3"):
            for _ in it:
                pass
        assert _events(it.stats()["resilience"]) == {"pipeline_giveups": 1,
                                                     "snapshot_corruptions": 1}
    else:
        jax_snap = str(tmp_path / "jax.snapshot")
        with open(snap, "rb") as src, open(jax_snap, "wb") as dst:
            dst.write(src.read())
        # the epoch heals: cold from the batch after the last one delivered
        healed = [_batch_bytes(b) for b in it]
        s = it.stats()
        assert len(healed) == ROWS // BATCH and healed == cold
        assert _events(s["resilience"]) == {"pipeline_restarts": 1, "snapshot_corruptions": 1}
        # the JAX package heals the same corrupted file to the same bytes,
        # with the same events
        jax_it = _jax_iter(corpus, jax_snap, device_decode=device_decode)
        jax_healed = [_batch_bytes(b) for b in jax_it]
        jax_events = _events(jax_it.stats()["resilience"])
        jax_it.close()
        assert jax_events == _events(s["resilience"]) and jax_healed == healed
    assert not os.path.exists(snap)
    it.reset()
    assert _drain(it) == cold  # a cold epoch writes it anew
    assert os.path.exists(snap)
    assert it.stats()["resilience"]["pipeline_restarts"] == 0
    it.close()


def _events(resilience: dict) -> dict:
    """A ``stats()["resilience"]`` dict's nonzero counts."""
    return {k: v for k, v in resilience.items() if v}


@pytest.mark.parametrize("batch", [0, 1, ROWS // BATCH - 1])
def test_crc_mismatch_heals_at_any_batch(tmp_path, monkeypatch, batch):
    """The first, an early and the last batch corrupt: the healed epoch
    equals the cold one, with one restart, on the host-decode route."""
    monkeypatch.delenv("DMLC_RETRY_MAX_ATTEMPTS", raising=False)
    corpus, snap = _corpus(tmp_path), str(tmp_path / "c.snapshot")
    first = _port_iter(corpus, snap, layout="ell", max_nnz=NUM_COL)
    cold = _drain(first)
    first.close()
    _flip_byte_in_batch(snap, batch)
    it = _port_iter(corpus, snap, layout="ell", max_nnz=NUM_COL)
    assert [_batch_bytes(b) for b in it] == cold
    assert it.stats()["resilience"]["pipeline_restarts"] == 1
    it.close()


@pytest.mark.parametrize("env,restarts", [(None, 3), ("", 3), ("4", 3), ("2", 1),
                                          ("1", 0), ("0", 0)])
def test_restart_budget_follows_the_jax_rule(monkeypatch, env, restarts):
    """``DMLC_RETRY_MAX_ATTEMPTS`` allows ``max_attempts - 1`` restarts, as
    the JAX package's ``RetryPolicy.from_env`` and ``restart_verdict`` do."""
    from dmlc_tpu.io.resilience import RetryPolicy, restart_verdict
    from dmlc_tpu.utils.check import CacheCorruptionError as JaxCacheCorruptionError

    if env is None:
        monkeypatch.delenv("DMLC_RETRY_MAX_ATTEMPTS", raising=False)
    else:
        monkeypatch.setenv("DMLC_RETRY_MAX_ATTEMPTS", env)
    from dmlc_tpu_torch.utils.check import CacheCorruptionError

    port_policy = resilience.RetryPolicy.from_env()
    assert port_policy.max_attempts == RetryPolicy.from_env().max_attempts
    allowed = [used for used in range(6) if resilience.restart_verdict(
        port_policy, used, CacheCorruptionError("crc mismatch")) == "restart"]
    assert allowed == list(range(restarts))
    policy = RetryPolicy.from_env()
    exc = JaxCacheCorruptionError("crc mismatch")
    jax_allowed = [used for used in range(6)
                   if restart_verdict(policy, used, exc) == "restart"]
    assert jax_allowed == allowed


def test_geometry_change_runs_cold(tmp_path):
    corpus, snap = _corpus(tmp_path), str(tmp_path / "c.snapshot")
    _drain(_port_iter(corpus, snap))
    it = DeviceIter(create_parser(corpus, 0, 1, "libsvm", snapshot=snap),
                    num_col=NUM_COL, batch_size=32, device="cpu")
    next(it)
    assert it.stats()["snapshot_state"] == "cold"
    it.close()


def test_argument_checks(tmp_path):
    corpus = _corpus(tmp_path)
    # C16: no snapshot, the flag is accepted (as in JAX) and moves nothing
    on = _port_iter(corpus, None, device_decode=True)
    assert _drain(on) == _drain(_port_iter(corpus, None)) == _drain(
        _jax_iter(corpus, None, device_decode=True))
    assert on.stats()["device_decode_bytes"] == 0
    with pytest.raises(DMLCError, match="snapshot_quant"):
        _port_iter(corpus, str(tmp_path / "s"), layout="ell", max_nnz=3,
                   snapshot_quant="int8")
    with pytest.raises(DMLCError, match="dense layout only"):
        _port_iter(corpus, None, layout="ell", max_nnz=3, x_dtype="bfloat16")
