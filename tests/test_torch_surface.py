"""The port's public surface against the JAX package's, one test per fault
the port had (each on the CPU, ``device="cpu"``):

- C1: ``DeviceIter.stats()`` reports ``batches`` (first) beside
  ``batches_fed``, and every key of the JAX ``stats()``, ``store``
  included, with a value of the same type after the same epoch,
  ``resilience``, ``stages``, ``stage_busy`` and ``staging_ring`` key for
  key (on ``ell`` the JAX package has no staging ring, a difference
  ROADMAP C records); ``autotune`` is None when the autotuner is not
  armed and, armed, a dict with the JAX snapshot's keys and value types;
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


def _pipelines(uri, layout="ell", **kw):
    jax_model = JaxLinearLearner(NUM_COL, layout=layout, learning_rate=0.3)
    jax_it = JaxDeviceIter(jax_create_parser(uri, 0, 1, "libsvm", threaded=False),
                           num_col=NUM_COL, batch_size=64, layout=layout, max_nnz=NUM_COL, **kw)
    model = LinearLearner(NUM_COL, layout=layout, learning_rate=0.3, device="cpu")
    it = DeviceIter(create_parser(uri, 0, 1, "libsvm", threaded=False), num_col=NUM_COL,
                    batch_size=64, layout=layout, max_nnz=NUM_COL, device="cpu", **kw)
    return (jax_model, jax_it), (model, it)


def _armed_autotune_stats(uri, layout):
    """Both packages' ``stats()["autotune"]`` after two epochs with the
    autotuner armed (the second reset takes its first step)."""
    out = []
    for _, it in _pipelines(uri, layout, autotune=True):
        for _ in range(2):
            for _ in it:
                pass
            it.reset()
        out.append(it.stats()["autotune"])
        it.close()
    return out


def _c1_stats(tmp_path, layout):
    """Both packages' ``stats()`` after the same epoch, checked key for
    key against each other (module docstring)."""
    uri = _corpus(tmp_path)
    (jax_model, jax_it), (model, it) = _pipelines(uri, layout)
    for m, i in ((jax_model, jax_it), (model, it)):
        for batch in i:
            if layout == "ell":
                m.step(batch)
    want, got = jax_it.stats(), it.stats()
    jax_it.close()
    it.close()
    assert list(got)[0] == "batches" and got["batches"] == got["batches_fed"] == 10
    # every JAX key, and beside them only the port's own counters
    assert set(want) <= set(got) and set(got) - set(want) == {
        "batches_fed", "convert_seconds", "device_decode_seconds", "snapshot_read_seconds",
        "snapshot_write_seconds", "source_wait_seconds"}
    assert {k: type(v) for k, v in got["store"].items()} == {
        k: type(v) for k, v in want["store"].items()}
    assert set(got["store"]) == {"store_bytes", "store_evictions",
                                 "store_rebuilds_after_eviction"}
    assert got["autotune"] is None and want["autotune"] is None
    jax_tune, tune = _armed_autotune_stats(uri, layout)
    assert type(tune) is dict and type(jax_tune) is dict
    assert {k: type(v) for k, v in tune.items()} == {k: type(v) for k, v in jax_tune.items()}
    assert tune["steps"] == jax_tune["steps"] == 1
    assert set(tune["knobs"]) == set(jax_tune["knobs"])
    for key in sorted(set(got) & set(want)):
        if key == "staging_ring" and want[key] is None:
            continue  # checked by the caller
        assert type(got[key]) is type(want[key]), (key, got[key], want[key])
    assert got["batches"] == want["batches"]
    assert got["transfer_samples"] == want["transfer_samples"]
    assert got["convert_workers"] == want["convert_workers"] == 2
    for key in ("resilience", "stages", "stage_busy"):
        assert set(got[key]) == set(want[key]), key
        for k in got[key]:
            assert type(got[key][k]) is type(want[key][k]), (key, k)
    assert sum(got["stages"].values()) <= got["wall_seconds"]
    return want, got


def test_c1_stats_keys_match_reference_types(tmp_path):
    want, got = _c1_stats(tmp_path, "ell")
    # the port stages every layout in its pinned ring, the JAX package
    # only dense batches (ROADMAP C)
    assert want["staging_ring"] is None
    assert set(got["staging_ring"]) == {"depth", "hits", "misses"}


def test_c1_dense_stats_keys_match_reference_types(tmp_path):
    want, got = _c1_stats(tmp_path, "dense")
    assert set(got["staging_ring"]) == set(want["staging_ring"])
    assert all(type(v) is int for v in got["staging_ring"].values())


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
    # no snapshot is needed, by the environment's switch or an explicit
    # True (C16: as in JAX, the flag then acts on blocks with a device_span)
    assert DeviceIter(iter(()), num_col=3, batch_size=4, device="cpu").device_decode == \
        jax_knobs.device_decode()
    assert DeviceIter(iter(()), num_col=3, batch_size=4, device="cpu",
                      device_decode=True).device_decode is True


def _blocks(parser):
    out = [(b.offset.copy(), b.label.copy(), b.index.copy(), b.value.copy()) for b in parser]
    parser.close()
    return out


def test_c5_create_parser_positions_match_reference(tmp_path, monkeypatch):
    # the registry stack, as the JAX package's tests reach it: a plain
    # local file otherwise goes to the fused native reader
    monkeypatch.setenv("DMLC_TPU_NO_NATIVE_READER", "1")
    uri = _corpus(tmp_path, n=300)
    # the exact call of examples/train_linear.py
    bare = create_parser(uri, 0, 1, "libsvm", threaded=False)
    assert isinstance(bare, LibSVMParser)
    threaded = create_parser(uri, 0, 1, "libsvm", np.uint64, True, parse_workers=1)
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
