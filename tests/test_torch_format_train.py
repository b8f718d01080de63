"""The csv and libfm formats fed to the port's learners, against dmlc_tpu.

On the CPU (``device="cpu"``), each package's ``create_parser`` ->
``DeviceIter`` -> learner over the same corpus, the JAX side on its numpy
chain (``?engine=python``, ``parse_workers=1``), the port on its default
chain (the native engine, the dense emit on ``layout="dense"``, the parse
fan-out):

- a Criteo-shaped csv (label, 13 integer and 26 categorical columns, the
  values scaled down) on ``dense`` and ``ell`` through ``LinearLearner``;
  a KDD2012-shaped libfm on ``bcoo`` through ``LinearLearner`` and on
  ``ell`` through ``FMLearner`` (its ``field`` riding along unused): 20
  steps within 1e-5 of the JAX learner, losses and parameters (FM under
  Adam: the losses), from its initial parameters carried across by
  ``dmlc_tpu_torch.convert``;
- ``tests/test_device.py``'s libfm XOR case (``FMLearner`` on ``ell``)
  above 0.9 accuracy;
- a libfm block-cache file and a csv dense snapshot, each byte-identical
  to the JAX package's and served warm by the other package.
"""

import numpy as np
import pytest
import torch

from dmlc_tpu.data import create_parser as jax_create_parser
from dmlc_tpu.data.device import DeviceIter as JaxDeviceIter
from dmlc_tpu.models.fm import FMLearner as JaxFMLearner
from dmlc_tpu.models.linear import LinearLearner as JaxLinearLearner
from dmlc_tpu_torch import convert
from dmlc_tpu_torch.data import DenseBlock, DeviceIter, create_parser
from dmlc_tpu_torch.models import FMLearner, LinearLearner


@pytest.fixture(autouse=True)
def _registry_stack(monkeypatch):
    """These cases hold the registry stack of ``create_parser`` (the split,
    the text parsers and their threaded wrappers) against the JAX package's
    Python chain. A plain local file now goes to the fused native reader,
    as in the JAX package, whose own tests reach the registry stack the
    same way; the reader has its own suite (test_torch_native_reader.py)."""
    monkeypatch.setenv("DMLC_TPU_NO_NATIVE_READER", "1")


TOL = 1e-5
CSV_QUERY = "?format=csv&label_column=0"
CSV_COLS = 39          # 13 integer + 26 categorical features
FM_NUM_COL = 50_000    # the libfm corpus's index range, cut for the CPU
ROWS = 1344            # 21 batches of 64: the 20 compared steps see each row once
FM_FIELDS = 10


def _criteo_csv(tmp_path, n=ROWS, seed=0):
    """Criteo day-0's column layout (benchmarks/bench_csv_prefetch.py):
    label, 13 integer columns, 26 categorical ids, scaled into [0, 1)."""
    rng = np.random.default_rng(seed)
    ints = rng.integers(0, 1000, size=(n, 13)) / 1000.0
    cats = rng.integers(0, 100_000, size=(n, 26)) / 100_000.0
    x = np.concatenate([ints, cats], axis=1)
    y = (x[:, 0] + x[:, 20] > 1.0).astype(int)
    lines = [f"{y[i]}," + ",".join(f"{v:.5f}" for v in x[i]) for i in range(n)]
    path = tmp_path / "criteo.csv"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _kdd_libfm(tmp_path, n=ROWS, seed=1):
    """KDD2012 track 2's line shape (benchmarks/bench_libfm_bcoo.py): ten
    ``field:index:1`` tokens a row, fields 0-9, the label from a seeded
    rule on the ids."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, FM_NUM_COL, size=(n, FM_FIELDS))
    y = ((idx[:, 0] + idx[:, 1]) % 3 == 0).astype(int)
    lines = [f"{y[i]} " + " ".join(f"{f}:{idx[i, f]}:1" for f in range(FM_FIELDS))
             for i in range(n)]
    path = tmp_path / "kdd.libfm"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _pair(path, query, num_col, layout, **kw):
    port = DeviceIter(create_parser(path + query, chunk_bytes=4096), num_col=num_col,
                      layout=layout, device="cpu", **kw)
    jax = JaxDeviceIter(jax_create_parser(path + query + "&engine=python", threaded=True,
                                          parse_workers=1, chunk_bytes=4096),
                        num_col=num_col, layout=layout, **kw)
    return port, jax


def _twenty_steps(port, jax, port_it, jax_it, params=None):
    got, want = [], []
    while len(got) < 20:
        for pb, jb in zip(port_it, jax_it):
            want.append(float(jax.step(jb)))
            got.append(float(port.step(pb)))
            if len(got) == 20:
                break
        port_it.reset()
        jax_it.reset()
    port_it.close()
    jax_it.close()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    for p, j in zip(params(port) if params else (), jax.params):
        np.testing.assert_allclose(p, np.asarray(j), rtol=TOL, atol=TOL)
    return got


@pytest.mark.parametrize("layout", ["dense", "ell"])
def test_csv_linear_matches_reference(tmp_path, layout):
    path = _criteo_csv(tmp_path)
    jax = JaxLinearLearner(CSV_COLS, layout=layout, learning_rate=0.2)
    port = LinearLearner(CSV_COLS, layout=layout, learning_rate=0.2, device="cpu")
    port.set_params(convert.linear_params_from_jax(*(np.asarray(p) for p in jax.params),
                                                   device="cpu"))
    port_it, jax_it = _pair(path, CSV_QUERY, port.device_num_col(), layout, batch_size=64,
                            max_nnz=CSV_COLS)
    if layout == "dense":
        # the port's dense pipeline took the dense emit, the JAX one the CSR route
        block = port_it.source.next_block()
        assert isinstance(block, DenseBlock) and block.x.shape[1] == CSV_COLS + 1
        port_it.source.before_first()
    losses = _twenty_steps(port, jax, port_it, jax_it,
                           lambda m: convert.linear_params_to_jax(m.params))
    assert losses[-1] < losses[0]


def test_libfm_linear_bcoo_matches_reference(tmp_path):
    path = _kdd_libfm(tmp_path)
    jax = JaxLinearLearner(FM_NUM_COL, layout="bcoo", learning_rate=0.5)
    port = LinearLearner(FM_NUM_COL, layout="bcoo", learning_rate=0.5, device="cpu")
    port.set_params(convert.linear_params_from_jax(*(np.asarray(p) for p in jax.params),
                                                   device="cpu"))
    port_it, jax_it = _pair(path, "?format=libfm", FM_NUM_COL, "bcoo", batch_size=64,
                            nnz_bucket=256)
    _twenty_steps(port, jax, port_it, jax_it,
                  lambda m: convert.linear_params_to_jax(m.params))


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_libfm_fm_ell_matches_reference(tmp_path, optimizer):
    """FM's default Adam and plain SGD. Adam's first step on a coordinate
    moves it by about the rate whatever its gradient's size, so a gradient
    within rounding of zero (a one-hot id's, now and then) moves a factor
    by a different step in each package: under Adam the losses are held,
    under SGD the parameters too."""
    import optax

    path = _kdd_libfm(tmp_path)
    kw = dict(num_factors=8, layout="ell", learning_rate=0.05, init_scale=0.1)
    jax_kw, port_kw = {}, {}
    if optimizer == "sgd":
        jax_kw["optimizer"] = optax.sgd(0.5)
        port_kw["optimizer"] = lambda params: torch.optim.SGD(params, lr=0.5)
    jax = JaxFMLearner(FM_NUM_COL, seed=3, **kw, **jax_kw)
    port = FMLearner(FM_NUM_COL, device="cpu", **kw, **port_kw)
    port.set_params(convert.fm_params_from_jax(*(np.asarray(p) for p in jax.params), "cpu"))
    port_it, jax_it = _pair(path, "?format=libfm", port.device_num_col(), "ell",
                            batch_size=64, max_nnz=FM_FIELDS)
    block = port_it.source.next_block()
    assert block.field is not None and int(block.field.max()) == FM_FIELDS - 1
    port_it.source.before_first()
    _twenty_steps(port, jax, port_it, jax_it,
                  (lambda m: convert.fm_params_to_jax(m.params)) if optimizer == "sgd" else None)


def test_fm_libfm_format_end_to_end(tmp_path):
    """``tests/test_device.py``'s libfm case: the libfm format feeding the
    FM model (the pairing the reference's libfm parser exists for)."""
    rng = np.random.default_rng(5)
    lines = []
    for _ in range(400):
        a, b = int(rng.integers(0, 2)), int(rng.integers(0, 2))
        lines.append(f"{a ^ b} 0:{a}:1 1:{2 + b}:1")
    p = tmp_path / "fm.libfm"
    p.write_text("\n".join(lines) + "\n")
    model = FMLearner(num_col=4, num_factors=4, layout="ell", learning_rate=0.15, seed=3,
                      device="cpu")
    parser = create_parser(str(p) + "?format=libfm", 0, 1, "auto", threaded=False)
    it = DeviceIter(parser, num_col=model.device_num_col(), batch_size=50, layout="ell",
                    max_nnz=2, drop_remainder=True, device="cpu")
    model.fit(it, epochs=60)
    acc = model.accuracy(it)
    it.close()
    assert acc > 0.9, acc


# ---------------- files the two packages share ----------------

def _drain_blocks(parser) -> list:
    out = []
    for b in parser:
        out.append([None if getattr(b, k) is None else np.asarray(getattr(b, k)).tobytes()
                    for k in ("offset", "label", "weight", "field", "index", "value")]
                   + [b.resume_state])
    return out


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_libfm_block_cache_shared(tmp_path, writer, workers):
    path = _kdd_libfm(tmp_path)

    def port(cache):
        return create_parser(path + "?format=libfm", parse_workers=workers, chunk_bytes=4096,
                             block_cache=cache)

    def jax(cache):
        return jax_create_parser(path + "?format=libfm&engine=python", parse_workers=workers,
                                 chunk_bytes=4096, block_cache=cache)

    first, second = (jax, port) if writer == "jax" else (port, jax)
    cache = str(tmp_path / "c.bc")
    cold = first(cache)
    want = _drain_blocks(cold)
    cold.close()
    assert len(want) > 4 and want[0][3] is not None  # the field segment
    warm = second(cache)
    assert warm.cache_state == "warm"
    assert _drain_blocks(warm) == want
    warm.close()
    other = str(tmp_path / "other.bc")
    p = second(other)
    _drain_blocks(p)
    p.close()
    with open(cache, "rb") as f, open(other, "rb") as g:
        assert f.read() == g.read()


def _batches(it) -> list:
    out = []
    for batch in it:
        arrays = [batch.packed, *batch] if hasattr(batch, "packed") else list(batch)
        out.append([(a.contiguous().numpy() if isinstance(a, torch.Tensor)
                     else np.asarray(a)).tobytes() for a in arrays])
    return out


@pytest.mark.parametrize("reader", ["jax", "port"])
def test_csv_dense_snapshot_shared(tmp_path, reader):
    """The port's snapshot from dense-emit batches is byte-identical to the
    JAX package's from its CSR route, and each serves warm in the other."""
    path = _criteo_csv(tmp_path, n=700)
    kw = dict(num_col=CSV_COLS, batch_size=64, layout="dense")
    snaps = {"jax": str(tmp_path / "jax.snapshot"), "port": str(tmp_path / "port.snapshot")}
    it = DeviceIter(create_parser(path + CSV_QUERY, chunk_bytes=4096, snapshot=snaps["port"]),
                    device="cpu", **kw)
    assert isinstance(it.source.base.parse_chunk(b"1,2,3\n"), DenseBlock)
    cold = _batches(it)
    it.close()
    jit = JaxDeviceIter(jax_create_parser(path + CSV_QUERY + "&engine=python", parse_workers=4,
                                          chunk_bytes=4096, snapshot=snaps["jax"]), **kw)
    _batches(jit)
    jit.close()
    with open(snaps["jax"], "rb") as a, open(snaps["port"], "rb") as b:
        assert a.read() == b.read()
    # the other package's file, served warm
    writer = "port" if reader == "jax" else "jax"
    if reader == "port":
        warm = DeviceIter(create_parser(path + CSV_QUERY, chunk_bytes=4096,
                                        snapshot=snaps[writer]), device="cpu", **kw)
    else:
        warm = JaxDeviceIter(jax_create_parser(path + CSV_QUERY + "&engine=python",
                                               chunk_bytes=4096, snapshot=snaps[writer]), **kw)
    got = _batches(warm)
    assert warm.stats()["snapshot_state"] == "warm"
    warm.close()
    assert got == cold and len(cold) == 11
