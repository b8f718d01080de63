"""The port's public surface against the JAX package's, one test per fault
the port had (each on the CPU, ``device="cpu"``):

- C1: ``DeviceIter.stats()`` reports ``batches`` (first) beside
  ``batches_fed``, and every key it shares with the JAX ``stats()`` holds a
  value of the same type after the same epoch;
- C2: ``fit_epoch(max_steps)``, ``fit(steps_per_epoch)`` and
  ``accuracy(max_steps)`` stop after that many batches, reset the iterator
  and give the JAX loop's ``(loss, n)`` and accuracy on the same batches;
- C3: ``LinearLearner(optimizer=)`` takes a factory; Adam follows the JAX
  learner's ``optax.adam`` over 20 steps within 1e-5;
- C4: ``DMLC_TPU_PREFETCH`` and ``DMLC_TPU_DEVICE_DECODE`` resolve as the
  JAX package's knobs do (unset, valid, bad; an explicit argument wins);
- C5: ``create_parser``'s positions are the JAX package's:
  ``create_parser(path, 0, 1, "libsvm", threaded=False)`` gives the bare
  parser, whose blocks equal the threaded one's; another ``index_dtype``
  raises.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dmlc_tpu.data import create_parser as jax_create_parser
from dmlc_tpu.data.device import DeviceIter as JaxDeviceIter
from dmlc_tpu.models import LinearLearner as JaxLinearLearner
from dmlc_tpu.models.linear import LinearParams as JaxLinearParams
from dmlc_tpu.ops.sparse import EllBatch as JaxEllBatch
from dmlc_tpu.utils import knobs as jax_knobs
from dmlc_tpu.utils.check import DMLCError as JaxDMLCError
from dmlc_tpu_torch import convert
from dmlc_tpu_torch.data import DeviceIter, create_parser
from dmlc_tpu_torch.data.parsers import LibSVMParser, ThreadedParser
from dmlc_tpu_torch.models import LinearLearner
from dmlc_tpu_torch.ops.sparse import EllBatch
from dmlc_tpu_torch.utils import knobs
from dmlc_tpu_torch.utils.check import DMLCError

NUM_COL, TOL = 12, 1e-5


def _corpus(tmp_path, n=640, d=NUM_COL):
    rng = np.random.default_rng(5)
    w_true = rng.normal(size=d)
    lines = []
    for _ in range(n):
        x = rng.normal(size=d)
        feats = " ".join(f"{j}:{x[j]:.5f}" for j in range(d) if abs(x[j]) > 0.3)
        lines.append(f"{int(x @ w_true > 0)} {feats}")
    path = tmp_path / "surface.libsvm"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _pipelines(uri):
    jax_model = JaxLinearLearner(NUM_COL, layout="ell", learning_rate=0.3)
    jax_it = JaxDeviceIter(jax_create_parser(uri, 0, 1, "libsvm", threaded=False),
                           num_col=NUM_COL, batch_size=64, layout="ell", max_nnz=NUM_COL)
    model = LinearLearner(NUM_COL, layout="ell", learning_rate=0.3, device="cpu")
    it = DeviceIter(create_parser(uri, 0, 1, "libsvm", threaded=False), num_col=NUM_COL,
                    batch_size=64, layout="ell", max_nnz=NUM_COL, device="cpu")
    return (jax_model, jax_it), (model, it)


def test_c1_stats_keys_match_reference_types(tmp_path):
    uri = _corpus(tmp_path)
    (jax_model, jax_it), (model, it) = _pipelines(uri)
    for m, i in ((jax_model, jax_it), (model, it)):
        for batch in i:
            m.step(batch)
    want, got = jax_it.stats(), it.stats()
    assert list(got)[0] == "batches" and got["batches"] == got["batches_fed"] == 10
    shared = sorted(set(got) & set(want))
    assert {"batches", "bytes_to_device", "stall_seconds", "snapshot_state", "cache_state",
            "device_decode", "device_decode_bytes", "resilience"} <= set(shared)
    for key in shared:
        assert type(got[key]) is type(want[key]), (key, got[key], want[key])
    assert got["batches"] == want["batches"]
    for key in ("pipeline_restarts", "pipeline_giveups"):
        assert type(got["resilience"][key]) is type(want["resilience"][key])
    jax_it.close()
    it.close()


def test_c2_step_caps_match_reference(tmp_path):
    uri = _corpus(tmp_path)
    (jax_model, jax_it), (model, it) = _pipelines(uri)
    for _ in range(2):  # the cap resets the iterator: each pass starts over
        jax_loss, jax_n = jax_model.fit_epoch(jax_it, max_steps=3)
        loss, n = model.fit_epoch(it, max_steps=3)
        assert n == jax_n == 3 and it.stats()["batches"] == 0
        np.testing.assert_allclose(loss, jax_loss, rtol=TOL, atol=TOL)
    logs = []
    model.fit(it, epochs=2, steps_per_epoch=4, log_fn=lambda e, l, nb, s: logs.append(nb))
    jax_model.fit(jax_it, epochs=2, steps_per_epoch=4)
    assert logs == [4, 4]
    np.testing.assert_allclose(model.accuracy(it, max_steps=2),
                               jax_model.accuracy(jax_it, max_steps=2), atol=TOL)
    np.testing.assert_allclose(convert.linear_params_to_jax(model.params)[0],
                               np.asarray(jax_model.params.weight), rtol=TOL, atol=TOL)
    # uncapped, a pass runs to the end
    assert model.fit_epoch(it)[1] == 10
    jax_it.close()
    it.close()


def test_c3_adam_trajectory_matches_optax():
    rng = np.random.default_rng(2)
    w0 = (0.1 * rng.normal(size=NUM_COL + 1)).astype(np.float32)
    w0[-1] = 0.0
    b0 = np.float32(0.05)
    ref = JaxLinearLearner(NUM_COL, layout="ell", optimizer=optax.adam(0.05))
    ref.params = JaxLinearParams(jnp.asarray(w0), jnp.asarray(b0))
    ref.opt_state = ref.opt.init(ref.params)
    port = LinearLearner(NUM_COL, layout="ell", device="cpu",
                         optimizer=lambda params: torch.optim.Adam(params, lr=0.05))
    assert isinstance(port.opt, torch.optim.Adam)
    assert isinstance(LinearLearner(NUM_COL, device="cpu").opt, torch.optim.SGD)
    port.set_params(convert.linear_params_from_jax(w0, b0, "cpu"))
    got, want = [], []
    for _ in range(20):
        idx = rng.integers(0, NUM_COL, size=(32, 6)).astype(np.int32)
        val = rng.normal(size=(32, 6)).astype(np.float32)
        idx[rng.random(size=(32, 6)) < 0.3] = NUM_COL
        val[idx == NUM_COL] = 0.0
        label = rng.integers(0, 2, size=32).astype(np.float32)
        weight = np.ones(32, np.float32)
        arrays = (idx, val, label, weight)
        want.append(float(ref.step(JaxEllBatch(*(jnp.asarray(a) for a in arrays)))))
        got.append(float(port.step(EllBatch(*(torch.from_numpy(a) for a in arrays)))))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    w, b = convert.linear_params_to_jax(port.params)
    np.testing.assert_allclose(w, np.asarray(ref.params.weight), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(b, np.asarray(ref.params.bias), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("raw", [None, "5", "1", "0", "-2", "two", " 3 "])
def test_c4_prefetch_knob_resolves_as_reference(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv(knobs.PREFETCH_ENV, raising=False)
    else:
        monkeypatch.setenv(knobs.PREFETCH_ENV, raw)
    try:
        want = jax_knobs.resolve("prefetch")
    except JaxDMLCError:
        with pytest.raises(DMLCError, match=knobs.PREFETCH_ENV):
            knobs.prefetch()
        with pytest.raises(DMLCError):
            DeviceIter(iter(()), num_col=3, batch_size=4, device="cpu")
    else:
        assert knobs.prefetch() == want
        assert DeviceIter(iter(()), num_col=3, batch_size=4, device="cpu").prefetch == want
    # an explicit argument wins, clamped up to the floor of 1
    for explicit in (0, 1, 4):
        assert knobs.prefetch(explicit) == jax_knobs.resolve("prefetch", explicit)
    assert DeviceIter(iter(()), num_col=3, batch_size=4, prefetch=0, device="cpu").prefetch == 1


@pytest.mark.parametrize("raw", [None, "1", "0", "true", " 1 "])
def test_c4_device_decode_knob_resolves_as_reference(tmp_path, monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv(knobs.DEVICE_DECODE_ENV, raising=False)
    else:
        monkeypatch.setenv(knobs.DEVICE_DECODE_ENV, raw)
    assert knobs.device_decode() == jax_knobs.device_decode()
    for explicit in (True, False):
        assert knobs.device_decode(explicit) == jax_knobs.device_decode(explicit)
    it = DeviceIter(iter(()), num_col=3, batch_size=4, device="cpu",
                    snapshot=str(tmp_path / "s.snapshot"), snapshot_signature={})
    assert it.device_decode == jax_knobs.device_decode() == it.stats()["device_decode"]
    # the environment's switch needs no snapshot; an explicit True does
    assert DeviceIter(iter(()), num_col=3, batch_size=4, device="cpu").device_decode == \
        jax_knobs.device_decode()
    with pytest.raises(DMLCError, match="snapshot"):
        DeviceIter(iter(()), num_col=3, batch_size=4, device="cpu", device_decode=True)


def _blocks(parser):
    out = [(b.offset.copy(), b.label.copy(), b.index.copy(), b.value.copy()) for b in parser]
    parser.close()
    return out


def test_c5_create_parser_positions_match_reference(tmp_path):
    uri = _corpus(tmp_path, n=300)
    # the exact call of examples/train_linear.py
    bare = create_parser(uri, 0, 1, "libsvm", threaded=False)
    assert isinstance(bare, LibSVMParser)
    threaded = create_parser(uri, 0, 1, "libsvm", np.uint64, True)
    assert isinstance(threaded, ThreadedParser)
    got, want = _blocks(bare), _blocks(threaded)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    jax_rows = sum(len(b) for b in jax_create_parser(uri, 0, 1, "libsvm", threaded=False))
    assert sum(len(b[1]) for b in got) == jax_rows == 300
    with pytest.raises(DMLCError, match="uint64"):
        create_parser(uri, 0, 1, "libsvm", np.uint32)
    with pytest.raises(TypeError):
        create_parser(uri, 0, 1, "libsvm", np.uint64, True, "python")  # engine is keyword-only
