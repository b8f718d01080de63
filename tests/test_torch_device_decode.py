"""The port's device-side decode against dmlc_tpu.ops.device_decode.

- ``decode_span`` gives, for every segment dtype a container stores
  (2-D float32 and bfloat16, int8, int32, uint8, 1-D float32), the bytes of
  JAX's ``decode_span(use_pallas=False)`` and of the host ``np.frombuffer``
  view; its 2-D float32/bfloat16 segments match JAX's Pallas kernel
  ``widen_span_pallas`` run in interpret mode.
- ``widen_span_plain``, K2's plain version, rebuilds 24x10, 1000x7 and
  64x30 slabs bit for bit, with NaN, infinities, -0.0 and sign bits in them.
- ``quantize_int8`` and ``dequant_q8`` give JAX's exact values.
- ``decode_batch`` gives, for a span of each batch kind a snapshot stores
  (``ell``; packed dense float32, bfloat16 and int8; unpacked dense float32
  and bfloat16), the bytes of JAX's ``decode_span(use_pallas=False)``
  followed by its ``dequant_q8`` / ``widen_f32`` (a packed batch's slab and
  its ``x``, ``y`` and ``w``), and of JAX's Pallas kernel in interpret mode
  for the float slabs.
- The plan is built once per ``(kind, layout, num_col)`` and reused; its
  descriptor table has the kernel's layout, one entry a slab to work on,
  16-byte-aligned outputs and a block prefix; it refuses layouts it does
  not take.
- ``PackedDenseBatch`` with a pre-widened ``aux`` equals the lazy one, and
  ``batch[0]`` widens nothing.
- A CPU span takes the plain version; the kernel routes refuse it.

Every comparison is on bytes, never a tolerance.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dmlc_tpu.ops import device_decode as jdd
from dmlc_tpu_torch.ops import device_decode as dd
from dmlc_tpu_torch.utils.check import DMLCError

TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _bytes(t: torch.Tensor) -> bytes:
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.contiguous().numpy().tobytes()


def _span_of(arrays):
    """Named numpy arrays packed into one u8 span (segments 64-byte
    aligned, as a container stores them) plus its layout tuple."""
    buf, layout, off = bytearray(), [], 0
    for name, a in arrays.items():
        raw = np.ascontiguousarray(a).tobytes()
        off = -(-len(buf) // 64) * 64
        buf += b"\0" * (off - len(buf))
        layout.append((name, a.dtype.name, off, len(raw), a.shape))
        buf += raw
    return np.frombuffer(bytes(buf), dtype=np.uint8), tuple(layout)


def _special(a: np.ndarray) -> np.ndarray:
    flat = a.reshape(-1)
    flat[:5] = [np.nan, np.inf, -np.inf, -0.0, -1e-38]
    return a


def _slab(rng, rows, cols, dtype):
    a = _special(rng.normal(size=(rows, cols)).astype(np.float32) * 1e3)
    return a.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else a


def test_decode_span_matches_reference_for_every_dtype():
    rng = np.random.default_rng(0)
    arrays = {
        "x32": _slab(rng, 16, 6, "float32"),
        "x16": _slab(rng, 8, 4, "bfloat16"),
        "q": rng.integers(-127, 127, size=(16, 6)).astype(np.int8),
        "idx": rng.integers(0, 99, size=(4, 3)).astype(np.int32),
        "raw": rng.integers(0, 255, size=32).astype(np.uint8),
        "y": rng.normal(size=16).astype(np.float32),
    }
    span, layout = _span_of(arrays)
    want = jdd.decode_span(jnp.asarray(span), layout, use_pallas=False)
    got = dd.decode_span(torch.from_numpy(span.copy()), layout)
    assert set(got) == set(arrays)
    for name, a in arrays.items():
        g, w = got[name], np.asarray(want[name])
        assert tuple(g.shape) == a.shape == w.shape
        assert str(g.dtype).split(".")[-1] == w.dtype.name == a.dtype.name
        assert _bytes(g) == w.tobytes() == a.tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_span_matches_pallas_kernel_interpret(dtype):
    rng = np.random.default_rng(1)
    arrays = {"a": _slab(rng, 32, 12, dtype), "b": _slab(rng, 16, 8, dtype)}
    span, layout = _span_of(arrays)
    pal = jdd.decode_span(jnp.asarray(span), layout, use_pallas=True, interpret=True)
    got = dd.decode_span(torch.from_numpy(span.copy()), layout)
    for name in arrays:
        assert _bytes(got[name]) == np.asarray(pal[name]).tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,cols", [(24, 10), (1000, 7), (64, 30)])
def test_widen_span_plain_is_bit_exact(dtype, rows, cols):
    rng = np.random.default_rng(rows * cols)
    want = _slab(rng, rows, cols, dtype)
    seg = torch.from_numpy(np.frombuffer(want.tobytes(), np.uint8).copy())
    got = dd.widen_span_plain(seg, rows, cols, TORCH[dtype])
    assert got.dtype == TORCH[dtype] and tuple(got.shape) == (rows, cols)
    assert _bytes(got) == want.tobytes()
    # the route takes the plain version for a CPU segment
    assert _bytes(dd.widen_span(seg, rows, cols, TORCH[dtype])) == want.tobytes()
    if rows % 8 == 0:  # JAX's Pallas kernel in interpret mode, same bytes
        pal = jdd.widen_span_pallas(jnp.asarray(seg.numpy()), rows, cols, dtype,
                                    interpret=True)
        assert np.asarray(pal).tobytes() == want.tobytes()


def test_widen_span_checks_its_segment():
    seg = torch.zeros(24 * 10 * 4, dtype=torch.uint8)
    with pytest.raises(DMLCError, match="not 24x11x4"):
        dd.widen_span_plain(seg, 24, 11, torch.float32)
    with pytest.raises(DMLCError, match="float32 or bfloat16"):
        dd.widen_span_plain(seg, 24, 10, torch.int32)
    with pytest.raises(DMLCError, match="uint8"):
        dd.widen_span_plain(seg.view(torch.float32), 24, 10, torch.float32)


def test_kernel_route_refuses_cpu_segments():
    seg = torch.zeros(16, dtype=torch.uint8)
    with pytest.raises(DMLCError, match="CUDA"):
        dd.widen_span_cuda(seg, 2, 2, torch.float32)
    launches = dd.launches
    dd.decode_span(seg, (("a0", "<f4", 0, 16, (2, 2)),))
    assert dd.launches == launches  # the plain version counts no launch


def test_quantize_and_dequant_match_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(64, 5)).astype(np.float32)
    x[:, 2] = 0.0  # a zero column: scale 1.0, dequantizes to exact zeros
    q, scale = dd.quantize_int8(x)
    jq, jscale = jdd.quantize_int8(x)
    assert q.dtype == np.int8 and scale.dtype == np.float32
    assert q.tobytes() == jq.tobytes() and scale.tobytes() == jscale.tobytes()
    got = dd.dequant_q8(torch.from_numpy(q), torch.from_numpy(scale))
    want = np.asarray(jdd.dequant_q8(jnp.asarray(q), jnp.asarray(scale)))
    assert got.dtype == torch.float32 and got.numpy().tobytes() == want.tobytes()
    assert not got[:, 2].any()


def test_widen_f32_matches_reference():
    col = _slab(np.random.default_rng(4), 1, 64, "bfloat16")[0]
    t = torch.from_numpy(col.view(np.int16).copy()).view(torch.bfloat16)
    want = np.asarray(jdd.widen_f32(jnp.asarray(col)))
    assert dd.widen_f32(t).numpy().tobytes() == want.tobytes()
    f = torch.ones(4)
    assert dd.widen_f32(f) is f


# ---------------- decode_batch and its plan ----------------

NC, ROWS = 5, 32  # num_col and rows of the batches below


def _kind_arrays(case: str, rng):
    """(batch kind, arrays in stored order) of a seeded warm batch."""
    col = rng.normal(size=ROWS).astype(np.float32)
    ones = np.ones(ROWS, np.float32)
    if case == "ell":
        idx = rng.integers(0, NC + 1, size=(ROWS, NC)).astype(np.int32)
        return "ell", [idx, _slab(rng, ROWS, NC, "float32"), col, ones]
    if case == "dense_packed_q8":
        q = rng.integers(-127, 128, size=(ROWS, NC + 2)).astype(np.int8)
        scale = (rng.random(NC + 2) * 3).astype(np.float32)
        scale[1] = 1.0
        return "dense_packed_q8", [q, scale]
    dtype = "bfloat16" if case.endswith("bf16") else "float32"
    if case.startswith("dense_packed"):
        return "dense_packed", [_slab(rng, ROWS, NC + 2, dtype)]
    return "dense", [_slab(rng, ROWS, NC, dtype), col, ones]


KIND_CASES = ["ell", "dense_packed_f32", "dense_packed_bf16", "dense_packed_q8",
              "dense_f32", "dense_bf16"]


def _jax_batch(kind, segs):
    """The JAX package's batch tensors for decoded segments ``segs``: a
    packed batch as its slab, x, y and w."""
    arrays = [segs[f"a{i}"] for i in range(len(segs))]
    if kind == "dense_packed_q8":
        arrays = [jdd.dequant_q8(arrays[0], arrays[1])]
    if kind.startswith("dense_packed"):
        p = arrays[0]
        return [p, p[:, :NC], jdd.widen_f32(p[:, NC]), jdd.widen_f32(p[:, NC + 1])]
    return arrays


def _port_batch(batch):
    if isinstance(batch, dd.PackedDenseBatch):
        return [batch.packed, *batch]
    return list(batch)


@pytest.mark.parametrize("case", KIND_CASES)
def test_decode_batch_matches_reference(case):
    kind, arrays = _kind_arrays(case, np.random.default_rng(KIND_CASES.index(case)))
    span, layout = _span_of({f"a{i}": a for i, a in enumerate(arrays)})
    segs = jdd.decode_span(jnp.asarray(span), layout, use_pallas=False)
    want = _jax_batch(kind, segs)
    got = _port_batch(dd.decode_batch(torch.from_numpy(span.copy()), layout, kind, NC))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == w.dtype.name
        assert _bytes(g) == w.tobytes()


@pytest.mark.parametrize("case", [c for c in KIND_CASES if c != "dense_packed_q8"])
def test_decode_batch_matches_pallas_kernel_interpret(case):
    kind, arrays = _kind_arrays(case, np.random.default_rng(10 + KIND_CASES.index(case)))
    span, layout = _span_of({f"a{i}": a for i, a in enumerate(arrays)})
    segs = jdd.decode_span(jnp.asarray(span), layout, use_pallas=True, interpret=True)
    want = _jax_batch(kind, segs)
    got = _port_batch(dd.decode_batch(torch.from_numpy(span.copy()), layout, kind, NC))
    assert [_bytes(g) for g in got] == [np.asarray(w).tobytes() for w in want]


def test_plan_is_built_once_per_kind_layout_and_num_col(monkeypatch):
    built = []

    class Counting(dd.DecodePlan):
        __slots__ = ()

        def __init__(self, *args):
            built.append(args)
            super().__init__(*args)

    monkeypatch.setattr(dd, "_PLANS", {})
    monkeypatch.setattr(dd, "DecodePlan", Counting)
    kind, arrays = _kind_arrays("dense_packed_bf16", np.random.default_rng(5))
    span, layout = _span_of({"a0": arrays[0]})
    t = torch.from_numpy(span.copy())
    first = dd.decode_batch(t, layout, kind, NC)
    for _ in range(3):
        again = dd.decode_batch(t, tuple(tuple(e) for e in layout), kind, NC)
        assert [_bytes(a) for a in _port_batch(again)] == [_bytes(a) for a in _port_batch(first)]
    assert len(built) == 1
    assert dd.plan_for(kind, layout, NC) is dd.plan_for(kind, layout, NC)
    dd.decode_span(t, layout)  # decode_span's own plan
    with pytest.raises(DMLCError, match="num_col"):
        dd.decode_batch(t, layout, kind, NC + 1)  # another key: built, and refused
    assert [b[0] for b in built] == [kind, dd.SEGMENTS, kind]


def test_plan_tables():
    import ctypes

    assert ctypes.sizeof(dd._Op) == 56 and ctypes.sizeof(dd.DecodeTable) == 464
    rows, k = 8192, 28
    ell = (("a0", "<i4", 0, rows * k * 4, (rows, k)),
           ("a1", "<f4", rows * k * 4, rows * k * 4, (rows, k)),
           ("a2", "<f4", 2 * rows * k * 4, rows * 4, (rows,)),
           ("a3", "<f4", 2 * rows * k * 4 + rows * 4, rows * 4, (rows,)))
    plan = dd.plan_for("ell", ell, 29)
    t = plan.table
    assert t.count == 1 and t.ops[0].op == dd.OP_COPY4 and t.ops[0].src == rows * k * 4
    assert t.blocks == -(-rows * k * 4 // (16 * 256)) == 224
    # the indices, label and weight are views of the span: only the values
    # have an entry, and the one output is allocated typed
    assert [o[0] for o in plan.outputs] == [False, True, False, False]
    assert plan.direct == (torch.float32, (rows, k)) and plan.aux is None
    assert plan.span_bytes == ell[-1][2] + ell[-1][3]
    c = 31
    bf16 = dd.plan_for("dense_packed", (("a0", "bfloat16", 0, rows * c * 2, (rows, c)),), c - 2)
    op = bf16.table.ops[0]
    assert bf16.table.count == 1 and op.op == dd.OP_BF16_AUX and op.dst == 0
    assert op.extra == bf16.aux[0] == rows * c * 2 and op.extra % 16 == 0
    assert bf16.out_bytes == rows * c * 2 + 2 * rows * 4 and bf16.direct is None
    q8 = dd.plan_for("dense_packed_q8", (("a0", "|i1", 0, rows * c, (rows, c)),
                                         ("a1", "<f4", rows * c, c * 4, (c,))), c - 2)
    op = q8.table.ops[0]
    assert (op.op, op.src, op.extra, op.rows, op.cols) == (dd.OP_DEQUANT_Q8, 0, rows * c, rows, c)
    assert q8.table.blocks == -(-rows * c * 4 // (16 * 256))
    assert q8.direct == (torch.float32, (rows, c))
    # several slabs: 16-byte-aligned outputs in one allocation, and each
    # entry's first block the sum of the blocks before it
    arrays = {"a": np.zeros((300, 17), np.float32), "b": np.zeros((129, 33), ml_dtypes.bfloat16),
              "c": np.zeros((5, 3), np.float32), "d": np.zeros((4, 4), np.int32),
              "e": np.zeros((0, 3), np.float32)}
    _, layout = _span_of(arrays)
    seg = dd.plan_for(dd.SEGMENTS, layout)
    ops = seg.table.ops[: seg.table.count]
    assert [o.op for o in ops] == [dd.OP_COPY4, dd.OP_COPY2, dd.OP_COPY4]  # none for 0 rows
    assert all(o.dst % 16 == 0 for o in ops) and seg.out_bytes % 16 == 0
    assert [o.first_block for o in ops] == [0, 5, 8]  # 20,400 and 8,514 output bytes
    assert seg.table.blocks == 9


@pytest.mark.parametrize("kind,layout,num_col,match", [
    ("csr", (("a0", "<f4", 0, 16, (2, 2)),), 0, "unknown batch kind"),
    ("ell", (("a0", "<f4", 0, 16, (2, 2)),), 0, "holds 4 arrays"),
    ("dense_packed", (("a0", "<f4", 0, 16, (2, 2)),), 3, "num_col"),
    ("dense_packed_q8", (("a0", "<f4", 0, 16, (2, 2)), ("a1", "<f4", 16, 8, (2,))), 0,
     "int8"),
    ("dense_packed", (("a0", "<f4", 0, 12, (2, 2)),), 0, "no <f4"),
    (dd.SEGMENTS, tuple((f"a{i}", "<f4", 16 * i, 16, (2, 2)) for i in range(9)), 0,
     "at most 8"),
])
def test_plan_refuses_layouts_it_does_not_take(kind, layout, num_col, match):
    with pytest.raises(DMLCError, match=match):
        dd.plan_for(kind, layout, num_col)


def test_packed_batch_with_aux_equals_the_lazy_one(monkeypatch):
    kind, arrays = _kind_arrays("dense_packed_bf16", np.random.default_rng(6))
    packed = torch.from_numpy(arrays[0].view(np.int16).copy()).view(torch.bfloat16)
    aux = torch.stack([packed[:, NC].to(torch.float32), packed[:, NC + 1].to(torch.float32)])
    eager = dd.PackedDenseBatch(packed, NC, aux)
    lazy = dd.PackedDenseBatch(packed, NC)
    assert [_bytes(t) for t in eager] == [_bytes(t) for t in lazy]
    assert all(a.dtype == b.dtype for a, b in zip(eager, lazy))
    assert [_bytes(eager[i]) for i in (0, 1, 2, -1, -2, -3)] == \
        [_bytes(lazy[i]) for i in (0, 1, 2, -1, -2, -3)]
    assert [_bytes(t) for t in eager[1:]] == [_bytes(t) for t in lazy[1:]]
    with pytest.raises(IndexError):
        eager[3]

    def no_widening(col):
        raise AssertionError("widened")

    monkeypatch.setattr(dd, "widen_f32", no_widening)
    assert lazy[0].dtype == torch.bfloat16 and lazy[-3].shape == (ROWS, NC)  # no widening
    assert eager[1].dtype == eager[2].dtype == torch.float32  # the aux rows
    x, y, w = eager
    with pytest.raises(AssertionError, match="widened"):
        lazy[1]


def test_kernel_routes_refuse_cpu_spans():
    kind, arrays = _kind_arrays("ell", np.random.default_rng(7))
    span, layout = _span_of({f"a{i}": a for i, a in enumerate(arrays)})
    t = torch.from_numpy(span.copy())
    launches = dd.launches
    with pytest.raises(DMLCError, match="CUDA"):
        dd.decode_batch_cuda(t, layout, kind, NC)
    dd.decode_batch(t, layout, kind, NC)
    assert dd.launches == launches  # the plain version counts no launch


def test_unaligned_span_views_are_copies():
    """A span that starts 1 byte into its buffer: its int32 and float32
    views cannot be torch views, so they are copies with the same bytes."""
    kind, arrays = _kind_arrays("ell", np.random.default_rng(8))
    span, layout = _span_of({f"a{i}": a for i, a in enumerate(arrays)})
    buf = torch.zeros(span.size + 1, dtype=torch.uint8)
    buf[1:] = torch.from_numpy(span.copy())
    got = _port_batch(dd.decode_batch(buf[1:], layout, kind, NC))
    assert [_bytes(g) for g in got] == [a.tobytes() for a in arrays]
