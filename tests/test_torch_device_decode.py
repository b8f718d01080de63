"""The port's device-side decode against dmlc_tpu.ops.device_decode.

- ``decode_span`` gives, for every segment dtype a container stores
  (2-D float32 and bfloat16, int8, int32, uint8, 1-D float32), the bytes of
  JAX's ``decode_span(use_pallas=False)`` and of the host ``np.frombuffer``
  view; its 2-D float32/bfloat16 segments match JAX's Pallas kernel
  ``widen_span_pallas`` run in interpret mode.
- ``widen_span_plain``, K2's plain version, rebuilds 24x10, 1000x7 and
  64x30 slabs bit for bit, with NaN, infinities, -0.0 and sign bits in them.
- ``quantize_int8`` and ``dequant_q8`` give JAX's exact values.
- A CPU span takes the plain version; the kernel route refuses it.

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
