"""The port's bcoo layout, against the JAX package's.

On the CPU (``device="cpu"``), with the JAX package's Python parser chain
(``?engine=python``) beside the port's on the same seeded corpora:

- ``block_to_bcoo_host``: the first ``nnz`` coordinates and values, the
  label, weight and shape equal JAX's, and the dense form equals
  ``BCOO.todense()``; only the pad slots differ (value 0 at an in-bounds
  coordinate, where JAX's lie out of bounds);
- ``DeviceIter(layout="bcoo")``: batches equal JAX's in dense form, label
  and weight; nnz and rows quantized to their buckets, a fixed-batch tail
  that pads into the shapes already emitted, the derived bucket's 512 Ki
  cap; a natural-block restore that skips blocks without converting or
  copying them; ``x`` marked coalesced exactly when its coordinates are in
  row-major order;
- ``LinearLearner(layout="bcoo")``, logistic and softmax, fixed and
  natural batches: 20 steps' losses and weights within 1e-5 relative of
  the JAX learner's on the same batches, and accuracy above 0.9.
"""

import numpy as np
import pytest
import torch

from dmlc_tpu.data import create_parser as jax_create_parser
from dmlc_tpu.data.device import DeviceIter as JaxDeviceIter
from dmlc_tpu.models.linear import LinearLearner as JaxLinearLearner
from dmlc_tpu.ops.sparse import block_to_bcoo_host as jax_block_to_bcoo_host
from dmlc_tpu_torch.data import DeviceIter, create_parser
from dmlc_tpu_torch.models import LinearLearner
from dmlc_tpu_torch.ops.sparse import block_to_bcoo_host
from dmlc_tpu_torch.utils.check import DMLCError

RTOL = 1e-5


def _write(tmp_path, name, lines):
    path = tmp_path / name
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _sparse_corpus(tmp_path, n=64, d=6):
    """Rows of 1..d-1 nonzeros at sorted random columns."""
    rng = np.random.default_rng(0)
    lines = []
    for i in range(n):
        idx = sorted(rng.choice(d, size=rng.integers(1, d), replace=False))
        lines.append(f"{i % 2} " + " ".join(f"{j}:{rng.normal():.4f}" for j in idx))
    return _write(tmp_path, "train.libsvm", lines)


def _binary_corpus(tmp_path, n=400):
    """Four unit features a row, at columns that wrap around 50 (some rows
    out of column order)."""
    lines = [f"{i % 2} " + " ".join(f"{(i * 7 + j) % 50}:1" for j in range(4))
             for i in range(n)]
    return _write(tmp_path, "bin.libsvm", lines)


def _separable_corpus(tmp_path, n=640, d=8):
    rng = np.random.default_rng(1)
    w_true = rng.normal(size=d)
    lines = []
    for _ in range(n):
        x = rng.normal(size=d)
        lines.append(f"{int(x @ w_true > 0)} " + " ".join(f"{j}:{x[j]:.5f}" for j in range(d)))
    return _write(tmp_path, "sep.libsvm", lines)


def _multiclass_corpus(tmp_path, n=640, d=6, classes=3):
    rng = np.random.default_rng(5)
    centers = rng.normal(size=(classes, d)) * 2
    lines = []
    for _ in range(n):
        c = int(rng.integers(0, classes))
        x = centers[c] + rng.normal(size=d) * 0.3
        lines.append(f"{c} " + " ".join(f"{j}:{x[j]:.5f}" for j in range(d)))
    return _write(tmp_path, "multi.libsvm", lines)


def _port_iter(uri, num_col, batch_size, chunk_bytes=1 << 20, **kw):
    parser = create_parser(uri, 0, 1, "libsvm", chunk_bytes=chunk_bytes, parse_workers=1)
    return DeviceIter(parser, num_col=num_col, batch_size=batch_size, layout="bcoo",
                      device="cpu", **kw)


def _jax_iter(uri, num_col, batch_size, chunk_bytes=1 << 20, **kw):
    parser = jax_create_parser(uri + "?engine=python", 0, 1, "libsvm", threaded=False,
                               chunk_bytes=chunk_bytes)
    return JaxDeviceIter(parser, num_col=num_col, batch_size=batch_size, layout="bcoo", **kw)


def _port_dense(batches):
    return [(x.to_dense().numpy(), y.numpy(), w.numpy(), x.shape[0]) for x, y, w in batches]


def _jax_dense(batches):
    return [(np.asarray(m.todense()), np.asarray(y), np.asarray(w), m.shape[0])
            for m, y, w in batches]


# ---------------- block_to_bcoo_host ----------------

@pytest.mark.parametrize("pad_rows,pad_nnz", [(None, None), (80, None), (None, 512),
                                              (80, 512), (64, 3)])
@pytest.mark.parametrize("binary", [False, True])
def test_block_to_bcoo_host_matches_jax(tmp_path, pad_rows, pad_nnz, binary):
    uri = _binary_corpus(tmp_path, n=64) if binary else _sparse_corpus(tmp_path)
    block = create_parser(uri, 0, 1, "libsvm").next_block()
    jblock = jax_create_parser(uri + "?engine=python", 0, 1, "libsvm",
                               threaded=False).next_block()
    num_col = 50 if binary else 6
    coords, vals, label, weight, shape = block_to_bcoo_host(
        block, num_col, pad_rows_to=pad_rows, pad_nnz_to=pad_nnz)
    jc, jv, jl, jw, jshape = jax_block_to_bcoo_host(
        jblock, num_col, pad_rows_to=pad_rows, pad_nnz_to=pad_nnz)
    nnz = len(block.index)
    assert shape == jshape and coords.dtype == jc.dtype == np.int32
    assert coords.shape == jc.shape and vals.shape == jv.shape
    np.testing.assert_array_equal(coords[:nnz], jc[:nnz])
    np.testing.assert_array_equal(vals[:nnz], jv[:nnz])
    np.testing.assert_array_equal(label, jl)
    np.testing.assert_array_equal(weight, jw)
    # the pad slots: value 0 at the last in-bounds coordinate
    assert (vals[nnz:] == 0).all()
    assert (coords[nnz:] == [shape[0] - 1, num_col - 1]).all()
    from jax.experimental import sparse as jsparse

    # invariant checks on: every pad coordinate is in bounds
    dense = torch.sparse_coo_tensor(torch.from_numpy(coords.T.astype(np.int64)),
                                    torch.from_numpy(vals), shape,
                                    check_invariants=True).to_dense()
    np.testing.assert_array_equal(dense.numpy(),
                                  np.asarray(jsparse.BCOO((jv, jc), shape=jshape).todense()))


# ---------------- DeviceIter ----------------

def test_shape_buckets_quantize_and_preserve_the_batches(tmp_path):
    """Natural blocks, nnz to 256 and rows to 64, against exact shapes and
    against the JAX package's batches; the tensors hold the real entries,
    their spans the bucketed nnz."""
    uri = _binary_corpus(tmp_path)
    kw = dict(num_col=50, batch_size=None, chunk_bytes=4096)
    it = _port_iter(uri, nnz_bucket=256, row_bucket=64, **kw)
    bucketed = _port_dense(it)
    exact_it = _port_iter(uri, nnz_bucket=0, row_bucket=0, **kw)
    exact = _port_dense(exact_it)
    jax_batches = list(_jax_iter(uri, nnz_bucket=256, row_bucket=64, **kw))
    jax = _jax_dense(jax_batches)
    assert len(bucketed) == len(exact) == len(jax) >= 3
    assert it.nnz_shapes == {m.nse for m, _, _ in jax_batches}
    assert all(n % 256 == 0 for n in it.nnz_shapes) and len(it.nnz_shapes) < len(bucketed)
    # exact shapes: each span holds its block's nnz (unit values: the sum)
    assert exact_it.nnz_shapes == {int(xe.sum()) for xe, *_ in exact}
    for (xb, yb, wb, rb), (xe, ye, we, re), (xj, yj, wj, rj) in zip(bucketed, exact, jax):
        assert rb == rj and rb % 64 == 0
        np.testing.assert_array_equal(xb, xj)
        np.testing.assert_array_equal(yb, yj)
        np.testing.assert_array_equal(wb, wj)
        np.testing.assert_array_equal(xb[:re], xe)
        assert xb[re:].sum() == 0 and (wb[re:] == 0).all()
        np.testing.assert_array_equal(yb[:re], ye)
        v = np.arange(50, dtype=np.float32)
        np.testing.assert_allclose(xb @ v, np.concatenate([xe @ v, np.zeros(rb - re, np.float32)]),
                                   rtol=1e-6)


def test_fixed_batch_tail_closes_the_shape_set(tmp_path):
    uri = _sparse_corpus(tmp_path, n=72)  # 4 full batches of 16 and a tail of 8
    it = _port_iter(uri, num_col=6, batch_size=16, nnz_bucket=16)
    ep1 = [(x._nnz(), x.shape[0]) for x, _, _ in it]
    shapes = set(it.nnz_shapes)
    it.reset()
    ep2 = [(x._nnz(), x.shape[0]) for x, _, _ in it]
    it.close()
    jax = [(m.nse, m.shape[0]) for m, _, _ in _jax_iter(uri, num_col=6, batch_size=16,
                                                        nnz_bucket=16)]
    assert ep1 == ep2 and len(ep1) == len(jax) == 5
    assert all(r == 16 for _, r in ep1)
    # the tail's shape is one a full batch already used, as in JAX
    full = {-(-n // 16) * 16 for n, _ in ep1[:-1]}
    assert shapes == full == {n for n, _ in jax} and it.nnz_shapes == shapes
    assert jax[-1] in jax[:-1]


def test_derived_nnz_bucket_is_capped(tmp_path):
    uri = _sparse_corpus(tmp_path, n=8)
    assert _port_iter(uri, num_col=6, batch_size=8192, max_nnz=1000).nnz_bucket == 512 * 1024
    assert _port_iter(uri, num_col=6, batch_size=16, max_nnz=6).nnz_bucket == 96
    assert _port_iter(uri, num_col=6, batch_size=16).nnz_bucket == 4096
    assert _port_iter(uri, num_col=6, batch_size=None).nnz_bucket == 16384


def test_natural_block_restore_skips_without_converting(tmp_path, monkeypatch):
    uri = _binary_corpus(tmp_path)
    converted = []
    convert = DeviceIter._convert

    def counting(self, block, pad_nnz):
        converted.append(len(block))
        return convert(self, block, pad_nnz)

    monkeypatch.setattr(DeviceIter, "_convert", counting)
    kw = dict(num_col=50, batch_size=None, chunk_bytes=4096)
    it = _port_iter(uri, **kw)
    full = _port_dense(it)
    full_bytes = it.stats()["bytes_to_device"]
    it.close()
    assert len(full) >= 3 and len(converted) == len(full)
    it2 = _port_iter(uri, **kw)
    next(it2)
    next(it2)
    state = it2.state_dict()
    it2.close()
    assert state == {"kind": "batches", "batches": 2}  # as JAX's: natural blocks count
    jax = _jax_iter(uri, **kw)
    next(jax)
    next(jax)
    assert jax.state_dict() == state
    jax.close()
    it3 = _port_iter(uri, **kw)
    del converted[:]
    it3.load_state(state)
    assert it3.stats()["bytes_to_device"] == 0
    rest = _port_dense(it3)
    assert it3.stats()["bytes_to_device"] < full_bytes
    it3.close()
    # the two skipped blocks were never converted
    assert len(rest) == len(converted) == len(full) - 2
    for a, b in zip(rest, full[2:]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_fixed_batch_restore_by_seek(tmp_path, monkeypatch):
    # a seek is the registry stack's state (the fused native reader's is a
    # block count), reached as the JAX package's tests reach it
    monkeypatch.setenv("DMLC_TPU_NO_NATIVE_READER", "1")
    uri = _separable_corpus(tmp_path)
    kw = dict(num_col=8, batch_size=32, chunk_bytes=4096)
    full = _port_dense(_port_iter(uri, **kw))
    it = _port_iter(uri, **kw)
    for _ in range(5):
        next(it)
    state = it.state_dict()
    it.close()
    assert state["kind"] == "source"
    jax = _jax_iter(uri, **kw)
    for _ in range(5):
        next(jax)
    assert jax.state_dict() == state
    jax.close()
    it2 = _port_iter(uri, **kw)
    it2.load_state(state)
    rest = _port_dense(it2)
    it2.close()
    assert len(rest) == len(full) - 5
    for a, b in zip(rest, full[5:]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_coalesced_exactly_when_row_major(tmp_path):
    sorted_uri = _sparse_corpus(tmp_path)
    for x, _, _ in _port_iter(sorted_uri, num_col=6, batch_size=16):
        assert x.is_coalesced()
    # (i * 7 + j) % 50 wraps inside row 7: 49, 0, 1, 2
    flags = [x.is_coalesced() for x, _, _ in _port_iter(_binary_corpus(tmp_path), num_col=50,
                                                         batch_size=4)]
    assert not flags[1] and flags[0]


def test_argument_checks(tmp_path):
    uri = _sparse_corpus(tmp_path)
    with pytest.raises(DMLCError, match="requires layout='bcoo'"):
        DeviceIter(create_parser(uri), num_col=6, batch_size=None, device="cpu")
    with pytest.raises(DMLCError, match="not 'bcoo'"):
        DeviceIter(create_parser(uri, snapshot=str(tmp_path / "s")), num_col=6,
                   batch_size=16, layout="bcoo", device="cpu")
    # fault C9: an id >= num_col is refused on ell (JAX's ell path reads
    # past its table), and dropped on bcoo, as JAX's BCOO masks it
    ell = DeviceIter(create_parser(uri), num_col=4, batch_size=16, layout="ell",
                     max_nnz=6, device="cpu")
    with pytest.raises(DMLCError, match="feature index 5 >= num_col 4"):
        next(ell)
    ell.close()
    it = _port_iter(uri, num_col=4, batch_size=16)
    x, _, _ = next(it)
    it.close()
    block = create_parser(uri, 0, 1, "libsvm", threaded=False).next_block()
    keep = block.index < 4
    want = np.zeros((16, 4), np.float32)
    rows = np.repeat(np.arange(len(block)), np.diff(block.offset))
    sel = keep & (rows < 16)
    want[rows[sel], block.index[sel].astype(np.int64)] = block.value[sel]
    np.testing.assert_array_equal(x.to_dense().numpy(), want)


@pytest.mark.parametrize("classes", [None, 3])
@pytest.mark.parametrize("coalesced", [True, False])
def test_coo_matmul_matches_the_dense_product(classes, coalesced):
    """``coo_matmul`` and its weight gradient against autograd through the
    dense product, for a ``[D]`` and a ``[D, C]`` table, on entries in
    row-major order and out of it."""
    from dmlc_tpu_torch.ops.sparse import coo_matmul

    rng = np.random.default_rng(3)
    rows, cols = np.nonzero(rng.random((40, 9)) < 0.4)
    order = np.arange(len(rows)) if coalesced else rng.permutation(len(rows))
    idx = torch.from_numpy(np.stack([rows[order], cols[order]]).astype(np.int64))
    x = torch.sparse_coo_tensor(idx, torch.from_numpy(rng.normal(size=len(rows)).astype(np.float32)),
                                (40, 9), is_coalesced=coalesced, check_invariants=True)
    shape = (9,) if classes is None else (9, classes)
    w = torch.tensor(rng.normal(size=shape).astype(np.float32), requires_grad=True)
    w_ref = w.detach().clone().requires_grad_()
    g = torch.from_numpy(rng.normal(size=(40,) + shape[1:]).astype(np.float32))
    out = coo_matmul(x, w)
    (out * g).sum().backward()
    ref = x.to_dense() @ w_ref
    (ref * g).sum().backward()
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(w.grad, w_ref.grad, rtol=1e-6, atol=1e-6)


# ---------------- LinearLearner ----------------

@pytest.mark.parametrize("objective", ["logistic", "softmax"])
@pytest.mark.parametrize("batch_size", [32, None])
def test_learner_trajectory_matches_jax(tmp_path, objective, batch_size):
    """20 steps on the same batches: losses and weights within 1e-5
    relative of the JAX learner's."""
    import jax.numpy as jnp

    if objective == "softmax":
        uri, num_col, kw = _multiclass_corpus(tmp_path), 6, dict(num_class=3)
    else:
        uri, num_col, kw = _separable_corpus(tmp_path), 8, {}
    port = LinearLearner(num_col, objective=objective, layout="bcoo", learning_rate=0.5,
                         device="cpu", **kw)
    jax = JaxLinearLearner(num_col, objective=objective, layout="bcoo", learning_rate=0.5, **kw)
    assert port.weight_dim == jax.weight_dim == port.device_num_col() == num_col
    it_kw = dict(num_col=num_col, batch_size=batch_size, chunk_bytes=4096, nnz_bucket=256,
                 row_bucket=32)
    port_it, jax_it = _port_iter(uri, **it_kw), _jax_iter(uri, **it_kw)
    steps = 0
    while steps < 20:
        for pb, jb in zip(port_it, jax_it):
            loss = float(port.step(pb))
            jax_loss = float(jax.step(jb))
            np.testing.assert_allclose(loss, jax_loss, rtol=RTOL)
            np.testing.assert_allclose(port.params.weight.detach().numpy(),
                                       np.asarray(jax.params.weight), rtol=RTOL, atol=1e-7)
            np.testing.assert_allclose(port.params.bias.detach().numpy(),
                                       np.asarray(jax.params.bias), rtol=RTOL, atol=1e-7)
            steps += 1
            if steps == 20:
                break
        port_it.reset()
        jax_it.reset()
    # no sink: the last feature's weight trains like the others
    assert float(jnp.abs(jax.params.weight[-1]).max()) > 0
    assert float(port.params.weight.detach()[-1].abs().max()) > 0
    port_it.close()
    jax_it.close()


@pytest.mark.parametrize("batch_size", [64, None])
def test_learner_fits_bcoo_batches(tmp_path, batch_size):
    uri = _separable_corpus(tmp_path, n=256)
    model = LinearLearner(num_col=8, layout="bcoo", learning_rate=0.5, device="cpu")
    it = _port_iter(uri, num_col=model.device_num_col(), batch_size=batch_size,
                    chunk_bytes=4096, nnz_bucket=256, row_bucket=32)
    model.fit(it, epochs=12)
    acc = model.accuracy(it)
    it.close()
    assert acc > 0.9, f"batch_size={batch_size} acc={acc}"


@pytest.mark.parametrize("route", ["rowblock_fixed", "rowblock_natural", "cooblock_pair",
                                   "cooblock_csr"])
def test_c9_ids_past_num_col_dropped_as_reference(tmp_path, monkeypatch, route):
    """Fault C9: a feature id >= ``num_col`` is dropped on bcoo, as JAX's
    BCOO masks it, on the RowBlock route (the registry stack, fixed or
    natural batches) and on the native ``CooBlock`` route (pair and CSR
    wire): 20 steps within 1e-5 of the JAX learner's. ``ell`` refuses it
    (test_argument_checks)."""
    rng = np.random.default_rng(9)
    lines = []
    for i in range(96):
        ids = sorted(rng.choice(4, size=int(rng.integers(1, 4)), replace=False))
        feats = [f"{j}:{rng.normal():.4f}" for j in ids]
        if i % 3 == 0:
            feats.insert(1, f"9:{rng.normal():.4f}")
        lines.append(f"{i % 2} " + " ".join(feats))
    uri = _write(tmp_path, "c9.libsvm", lines)
    natural = route != "rowblock_fixed"
    kw = dict(num_col=4, batch_size=None if natural else 16, nnz_bucket=64, row_bucket=32)
    if route.startswith("rowblock"):
        monkeypatch.setenv("DMLC_TPU_NO_NATIVE_READER", "1")
    port_it = DeviceIter(create_parser(uri, chunk_bytes=4096), layout="bcoo", device="cpu",
                         csr_wire=route == "cooblock_csr", **kw)
    monkeypatch.delenv("DMLC_TPU_NO_NATIVE_READER", raising=False)
    jax_it = JaxDeviceIter(jax_create_parser(uri + "?engine=python", chunk_bytes=4096),
                           layout="bcoo", **kw)
    jax = JaxLinearLearner(4, layout="bcoo", learning_rate=0.3)
    port = LinearLearner(4, layout="bcoo", learning_rate=0.3, device="cpu")
    got, want = [], []
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        while len(got) < 20:
            for (x, y, w), jb in zip(port_it, jax_it):
                if route.startswith("cooblock"):
                    assert x.shape[0] % 32 == 0
                want.append(float(jax.step(jb)))
                got.append(float(port.step((x, y, w))))
                if len(got) == 20:
                    break
            port_it.reset()
            jax_it.reset()
    finally:
        torch.use_deterministic_algorithms(prev)
    port_it.close()
    jax_it.close()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(port.params.weight.detach().numpy(),
                               np.asarray(jax.params[0]), rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("batch_size", [32, None])
def test_rowblock_route_elides_unit_values(tmp_path, monkeypatch, batch_size):
    """``elide_unit_values`` on the RowBlock route (the registry stack): an
    all-ones batch ships no values, the card makes them, and the batches
    equal JAX's with elision on in dense form, label and weight."""
    monkeypatch.setenv("DMLC_TPU_NO_NATIVE_READER", "1")
    uri = _binary_corpus(tmp_path, n=600)
    kw = dict(num_col=50, batch_size=batch_size, nnz_bucket=128, row_bucket=64,
              chunk_bytes=4096)
    sizes = {}
    for elide in (False, True):
        it = _port_iter(uri, elide_unit_values=elide, **kw)
        got = _port_dense(it)
        sizes[elide] = it.bytes_to_device
        it.close()
        jax = _jax_iter(uri, elide_unit_values=elide, **kw)
        want = _jax_dense(jax)
        jax.close()
        assert len(got) == len(want) > 1
        for a, b in zip(got, want):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    assert sizes[True] < sizes[False]
