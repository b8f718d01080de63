"""``index_dtype=np.uint32`` end to end, against the JAX package (fault C18).

The same seeded libsvm, csv and libfm corpora, with ``index_dtype=
np.uint32``, through every engine the JAX package's selection picks: the
fused native reader (a local file), the bare registry parser on its native
scanner (``threaded=False``), the numpy engine (``engine="python"``),
``engine="native-batch"`` (which serves only ``uint64`` and warns, as JAX
does, before the registry stack takes over), the registry stack under
``DMLC_TPU_NO_NATIVE_READER`` and the chunk feeder (``mem://``). Each builds
the JAX package's class and gives its blocks, array for array and dtype for
dtype: the numpy engine and csv's synthetic ids are ``uint32``, and the
native libsvm and libfm scanners keep their ``uint64`` ids, as JAX's do.

Downstream:

- a ``uint32`` block cache written by either package serves warm in the
  other, and a ``uint64`` parser does not take it (its signature differs);
- a data-service frame keeps ``uint32`` across the packages both ways;
- ``DeviceIter`` ``ell``, ``dense`` and ``bcoo`` batches of a ``uint32``
  parse equal a ``uint64`` parse's bit for bit, and the JAX package's;
- ``LinearLearner`` on those batches follows the JAX learner within 1e-5
  (``tests/test_torch_linear.py``'s tolerance) and its own ``uint64`` run
  bit for bit.

All on the CPU (``device="cpu"``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_tpu.data import create_parser as jax_create_parser
from dmlc_tpu.data.device import DeviceIter as JaxDeviceIter
from dmlc_tpu.data.row_block import RowBlock as JaxRowBlock
from dmlc_tpu.io import filesystem as jax_fs
from dmlc_tpu.models import LinearLearner as JaxLinearLearner
from dmlc_tpu.models.linear import LinearParams as JaxLinearParams
from dmlc_tpu.service import frame as jax_frame
from dmlc_tpu.store import manager as jax_mgr
from dmlc_tpu_torch import convert
from dmlc_tpu_torch.data import DeviceIter, create_parser
from dmlc_tpu_torch.data.row_block import RowBlock
from dmlc_tpu_torch.io import filesystem as port_fs
from dmlc_tpu_torch.models import LinearLearner
from dmlc_tpu_torch.service import frame as port_frame
from dmlc_tpu_torch.store import manager as port_mgr

TOL = 1e-5
NUM_COL = 24


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("DMLC_TPU_NO_NATIVE_READER", raising=False)
    monkeypatch.delenv("DMLC_TPU_PARSE_ENGINE", raising=False)
    for mod in (port_fs, jax_fs):
        mod.MemoryFileSystem.reset()
    jax_mgr.reset_stores()
    port_mgr.reset_stores()
    yield
    for mod in (port_fs, jax_fs):
        mod.MemoryFileSystem.reset()
    jax_mgr.reset_stores()
    port_mgr.reset_stores()


def _libsvm(n=900, seed=0):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        feats = " ".join(f"{j}:{rng.normal():.4f}" for j in sorted(
            rng.choice(NUM_COL, size=int(rng.integers(1, 8)), replace=False)))
        rows.append(f"{i % 2} {feats}")
    return ("\n".join(rows) + "\n").encode()


def _csv(n=900, seed=1):
    rng = np.random.default_rng(seed)
    return "".join(f"{i % 2}," + ",".join(f"{v:.4f}" for v in rng.normal(size=6)) + "\n"
                   for i in range(n)).encode()


def _libfm(n=900, seed=2):
    rng = np.random.default_rng(seed)
    return "".join(f"{i % 2} " + " ".join(f"{j % 3}:{j}:{rng.random():.3f}" for j in
                                           sorted(rng.choice(NUM_COL, 4, replace=False))) + "\n"
                   for i in range(n)).encode()


CORPORA = {"libsvm": (_libsvm, ""), "csv": (_csv, "?label_column=0"), "libfm": (_libfm, "")}

# route -> (where the corpus lives: "" a local file, "mem" mem://; create_parser
# keywords; environment)
ROUTES = {
    "fused_reader": ("", {}, {}),
    "bare_registry": ("", {"threaded": False}, {}),
    "numpy": ("", {"engine": "python"}, {}),
    "numpy_bare": ("", {"engine": "python", "threaded": False}, {}),
    "native_batch": ("", {"engine": "native-batch"}, {}),
    "registry_stack": ("", {"parse_workers": 2}, {"DMLC_TPU_NO_NATIVE_READER": "1"}),
    "chunk_feeder": ("mem", {}, {}),
}


def _uri(tmp_path, fmt, where=""):
    gen, args = CORPORA[fmt]
    data = gen()
    if where == "mem":
        for mod in (port_fs, jax_fs):
            mod.MemoryFileSystem.instance().store[f"b/c.{fmt}"] = data
        return f"mem://b/c.{fmt}{args}"
    path = tmp_path / f"c.{fmt}"
    path.write_bytes(data)
    return str(path) + args


def _arrays(block) -> dict:
    out = {"kind": type(block).__name__}
    for name in ("offset", "label", "index", "value", "weight", "qid", "field"):
        a = getattr(block, name, None)
        out[name] = None if a is None else (np.asarray(a).dtype.str, np.asarray(a).tobytes())
    return out


def _drain(parser) -> list:
    out = [_arrays(b) for b in iter(parser.next_block, None)]
    parser.close()
    return out


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("fmt", list(CORPORA))
def test_every_engine_gives_the_reference_blocks(tmp_path, monkeypatch, caplog, fmt, route):
    where, kw, env = ROUTES[route]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    uri = _uri(tmp_path, fmt, where)
    with caplog.at_level("WARNING"):
        port = create_parser(uri, 0, 1, fmt, np.uint32, chunk_bytes=4096, **kw)
        jax = jax_create_parser(uri, 0, 1, fmt, np.uint32, chunk_bytes=4096, **kw)
    assert type(port).__name__ == type(jax).__name__
    if route == "native_batch":
        warned = [r for r in caplog.records if "native-batch unavailable" in r.getMessage()]
        assert {r.name for r in warned} == {"dmlc_tpu_torch", "dmlc_tpu"}
        assert all("index_dtype=<u4" in r.getMessage() for r in warned)
    got, want = _drain(port), _drain(jax)
    assert len(got) == len(want) > 0
    assert got == want
    # the numpy engine and csv's skeleton take the dtype; the native
    # libsvm and libfm scanners keep their uint64 ids, as JAX's do
    numpy_engine = route.startswith("numpy") or fmt == "csv"
    assert {b["index"][0] for b in got} == ({"<u4"} if numpy_engine else {"<u8"})
    if numpy_engine and fmt == "libfm":
        assert {b["field"][0] for b in got} == {"<u4"}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_uint32_block_cache_crosses_the_packages(tmp_path, writer):
    uri = _uri(tmp_path, "libsvm")
    cache = str(tmp_path / "u32.bc")
    makers = {"port": create_parser, "jax": jax_create_parser}
    reader = "jax" if writer == "port" else "port"

    def make(pkg, dtype=np.uint32):
        return makers[pkg](uri + "?engine=python", 0, 1, "libsvm", dtype, threaded=True,
                           parse_workers=1, chunk_bytes=4096, block_cache=cache)

    cold = make(writer)
    assert cold.cache_state == "cold"
    want = _drain(cold)
    warm = make(reader)
    assert warm.cache_state == "warm"
    got = _drain(warm)
    assert got == want and {b["index"][0] for b in got} == {"<u4"}
    # a uint64 parser's signature differs: it runs cold, in either package
    other = make(reader, np.uint64)
    assert other.cache_state == "cold"
    assert {b["index"][0] for b in _drain(other)} == {"<u8"}


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_uint32_service_frame_crosses_the_packages(direction):
    arrays = dict(offset=np.array([0, 1, 3], np.int64), label=np.array([0.0, 1.0], np.float32),
                  index=np.array([2, 0, 9], np.uint32))
    if direction == "port_to_jax":
        data, decode = port_frame.encode_block_frame(RowBlock(**arrays), None), jax_frame
    else:
        data, decode = jax_frame.encode_block_frame(JaxRowBlock(**arrays), None), port_frame
    _, meta, payload = decode.decode_frame(data)
    got = decode.block_from_frame(meta, payload)
    assert got.index.dtype == np.uint32
    np.testing.assert_array_equal(got.index, arrays["index"])
    assert got.value is None and got.weight is None
    assert (port_frame.encode_block_frame(RowBlock(**arrays), None)
            == jax_frame.encode_block_frame(JaxRowBlock(**arrays), None))


ITER_KW = {"ell": dict(max_nnz=8), "dense": {}, "bcoo": dict(nnz_bucket=256)}


def _batch_bytes(batch) -> list:
    out = []
    for t in batch:
        if isinstance(t, torch.Tensor) and t.is_sparse:
            t = t.coalesce()
            out += [t.indices().numpy().tobytes(), t.values().numpy().tobytes()]
        else:
            out.append(np.asarray(t).tobytes())
    return out


def _port_iter(uri, layout, dtype):
    parser = create_parser(uri + "?engine=python", 0, 1, "libsvm", dtype, threaded=False,
                           chunk_bytes=4096)
    return DeviceIter(parser, num_col=NUM_COL, batch_size=64, layout=layout, device="cpu",
                      **ITER_KW[layout])


@pytest.mark.parametrize("layout", ["ell", "dense", "bcoo"])
def test_device_batches_equal_the_uint64_run(tmp_path, layout):
    uri = _uri(tmp_path, "libsvm")
    runs = []
    for dtype in (np.uint32, np.uint64):
        it = _port_iter(uri, layout, dtype)
        runs.append([_batch_bytes(b) for b in it])
        it.close()
    assert runs[0] == runs[1] and len(runs[0]) > 5
    if layout == "ell":  # and the JAX package's uint32 batches
        jit = JaxDeviceIter(jax_create_parser(uri + "?engine=python", 0, 1, "libsvm", np.uint32,
                                              threaded=False, chunk_bytes=4096),
                            num_col=NUM_COL, batch_size=64, layout=layout, **ITER_KW[layout])
        assert [[np.asarray(t).tobytes() for t in b] for b in jit] == runs[0]
        jit.close()


def test_linear_learner_on_uint32_batches_follows_the_reference(tmp_path):
    uri = _uri(tmp_path, "libsvm")
    rng = np.random.default_rng(3)
    w0 = (0.1 * rng.normal(size=NUM_COL + 1)).astype(np.float32)
    w0[-1] = 0.0
    b0 = np.float32(0.05)
    losses = {}
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)  # the CPU gradient's sum order
    try:
        for dtype in (np.uint32, np.uint64):
            learner = LinearLearner(NUM_COL, layout="ell", learning_rate=0.3, device="cpu")
            learner.set_params(convert.linear_params_from_jax(w0, b0, "cpu"))
            it = _port_iter(uri, "ell", dtype)
            losses[dtype] = [float(learner.step(b)) for b in it]
            it.close()
    finally:
        torch.use_deterministic_algorithms(prev)
    ref = JaxLinearLearner(NUM_COL, layout="ell", learning_rate=0.3)
    ref.params = JaxLinearParams(jnp.asarray(w0), jnp.asarray(b0))
    ref.opt_state = ref.opt.init(ref.params)
    jit = JaxDeviceIter(jax_create_parser(uri + "?engine=python", 0, 1, "libsvm", np.uint32,
                                          threaded=False, chunk_bytes=4096),
                        num_col=NUM_COL, batch_size=64, layout="ell", **ITER_KW["ell"])
    want = [float(ref.step(b)) for b in jit]
    jit.close()
    assert losses[np.uint32] == losses[np.uint64]
    np.testing.assert_allclose(losses[np.uint32], want, rtol=TOL, atol=TOL)
