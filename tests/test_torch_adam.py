"""The single-pass Adam update (``dmlc_tpu_torch/ops/adam.py``) and
``FusedAdam``, the FM learner's default optimizer.

On the CPU: the ordered plain version bit for bit against a float32 numpy
transcription of the kernel's arithmetic, and within float32 rounding of a
float64 transcription and of ``torch.optim.Adam`` over 20 steps of sparse
gradients; ``FusedAdam``'s face as a ``torch.optim.Adam`` (state layout,
state dicts both ways, refused options, parameters without a gradient,
the profiler range); the row marks (``step(rows=...)``: the same bits as
``step()`` on the CPU, also with one id tensor serving two leaves, the
refused arguments, the plain mark's words). On a card (marker ``cuda``;
skipped without one): the kernel bit for bit against the ordered plain
version, the masked launch against the full one and the plain version, the
mark kernel against its plain version, ``FMLearner(ell)`` with and without
its row marks (its bitmap against the plain mark's), and one Adam launch a
step. Run those on a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_adam.py -m cuda
"""

import copy
import ctypes

import numpy as np
import pytest
import torch

from dmlc_tpu_torch import FMLearner
from dmlc_tpu_torch.ops import _build
from dmlc_tpu_torch.ops import adam
from dmlc_tpu_torch.ops.adam import FusedAdam
from dmlc_tpu_torch.ops.sparse import EllBatch
from dmlc_tpu_torch.utils.check import DMLCError

LR, BETAS, EPS = 0.05, (0.9, 0.999), 1e-8
STEPS = 20
W = 1001  # odd: a tail after the last float4
SHAPES = [(), (1,), (W,), (W, 8)]


def _sparse_grads(shape, steps: int, seed: int) -> list:
    """``steps`` float32 gradients, most rows zero (as an FM table's)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        g = rng.normal(size=shape).astype(np.float32)
        rows = rng.random(shape[:1]) < 0.1 if shape else np.array(True)
        g *= rows.reshape(shape[:1] + (1,) * (len(shape) - 1)) if shape else rows
        out.append(g)
    return out


def _start(shape, seed: int) -> np.ndarray:
    return np.random.default_rng([seed, 1]).normal(size=shape).astype(np.float32)


def _numpy_step(p, g, m, v, t: int, dtype):
    """One update in ``dtype``, every operation rounded on its own; the
    constants computed in double and rounded once, as the kernel gets them."""
    f = dtype.type
    b1, b2 = BETAS
    m = m * f(b1) + g * f(1.0 - b1)
    v = v * f(b2) + (g * g) * f(1.0 - b2)
    d = np.sqrt(v) / f((1.0 - b2 ** t) ** 0.5) + f(EPS)
    p = p - (m / d) * f(LR / (1.0 - b1 ** t))
    return p, m, v


def _plain_run(shape, seed: int):
    p = torch.from_numpy(_start(shape, seed))
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    for t, g in enumerate(_sparse_grads(shape, STEPS, seed), 1):
        adam.adam_step_ordered_plain_([p], [torch.from_numpy(g)], [m], [v], [float(t)],
                                      lr=LR, betas=BETAS, eps=EPS)
        yield t, g, p, m, v


@pytest.mark.parametrize("shape", SHAPES)
def test_ordered_plain_matches_float32_transcription_bit_for_bit(shape):
    want = [_start(shape, 3), np.zeros(shape, np.float32), np.zeros(shape, np.float32)]
    for t, g, p, m, v in _plain_run(shape, 3):
        want = _numpy_step(*want[:1], g, *want[1:], t, np.dtype(np.float32))
        for got, exp in zip((p, m, v), want):
            assert got.numpy().tobytes() == np.asarray(exp, np.float32).tobytes(), t


@pytest.mark.parametrize("shape", SHAPES)
def test_ordered_plain_within_rounding_of_float64(shape):
    want = [_start(shape, 4).astype(np.float64), np.zeros(shape), np.zeros(shape)]
    for t, g, p, m, v in _plain_run(shape, 4):
        want = _numpy_step(want[0], g.astype(np.float64), want[1], want[2], t,
                           np.dtype(np.float64))
    np.testing.assert_allclose(p.numpy(), want[0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(m.numpy(), want[1], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(v.numpy(), want[2], rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_adam_tracks_torch_adam(shape):
    ours = torch.from_numpy(_start(shape, 5)).requires_grad_(True)
    theirs = ours.detach().clone().requires_grad_(True)
    opt_ours = FusedAdam([ours], lr=LR, betas=BETAS, eps=EPS)
    opt_theirs = torch.optim.Adam([theirs], lr=LR, betas=BETAS, eps=EPS)
    for g in _sparse_grads(shape, STEPS, 5):
        for p, opt in ((ours, opt_ours), (theirs, opt_theirs)):
            p.grad = torch.from_numpy(g)
            opt.step()
    torch.testing.assert_close(ours, theirs, rtol=1e-6, atol=1e-6)
    # torch's m is a lerp, rounded otherwise: a few ulps of |g| (about 1)
    # where m has decayed towards 0
    state_ours, state_theirs = opt_ours.state[ours], opt_theirs.state[theirs]
    torch.testing.assert_close(state_ours["exp_avg"], state_theirs["exp_avg"],
                               rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(state_ours["exp_avg_sq"], state_theirs["exp_avg_sq"],
                               rtol=1e-5, atol=1e-9)


def test_fused_adam_is_an_adam_with_torch_state_layout():
    p = torch.zeros(5, requires_grad=True)
    opt = FusedAdam([p], lr=LR)
    assert isinstance(opt, torch.optim.Adam)
    p.grad = torch.ones(5)
    opt.step()
    ref_p = torch.zeros(5, requires_grad=True)
    ref = torch.optim.Adam([ref_p], lr=LR)
    ref_p.grad = torch.ones(5)
    ref.step()
    ours, theirs = opt.state_dict(), ref.state_dict()
    assert list(ours["state"][0]) == list(theirs["state"][0]) == ["step", "exp_avg",
                                                                  "exp_avg_sq"]
    for key, t in ours["state"][0].items():
        want = theirs["state"][0][key]
        assert t.dtype == want.dtype and t.device == want.device and t.shape == want.shape
    assert ours["state"][0]["step"].device.type == "cpu"
    assert ours["state"][0]["step"].dtype == torch.float32
    assert float(ours["state"][0]["step"]) == 1.0
    assert set(ours["param_groups"][0]) == set(theirs["param_groups"][0])
    assert ours["param_groups"][0]["betas"] == (0.9, 0.999)


@pytest.mark.parametrize("direction", ["torch_to_fused", "fused_to_torch"])
def test_state_dict_round_trip(direction):
    grads = _sparse_grads((W,), 6, 7)
    start = torch.from_numpy(_start((W,), 7))
    kinds = {"torch": torch.optim.Adam, "fused": FusedAdam}
    first, second = direction.split("_to_")
    a = start.clone().requires_grad_(True)
    opt_a = kinds[first]([a], lr=LR)
    for g in grads[:3]:
        a.grad = torch.from_numpy(g)
        opt_a.step()
    b = a.detach().clone().requires_grad_(True)
    opt_b = kinds[second]([b], lr=1.0)
    # a copy: a loaded state keeps the tensors it is given
    opt_b.load_state_dict(copy.deepcopy(opt_a.state_dict()))
    assert opt_b.param_groups[0]["lr"] == LR
    assert float(opt_b.state[b]["step"]) == 3.0
    assert opt_b.state[b]["step"].device.type == "cpu"
    for g in grads[3:]:
        for p, opt in ((a, opt_a), (b, opt_b)):
            p.grad = torch.from_numpy(g)
            opt.step()
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert float(opt_b.state[b]["step"]) == 6.0


@pytest.mark.parametrize("option", [{"amsgrad": True}, {"maximize": True},
                                    {"weight_decay": 0.01}, {"capturable": True},
                                    {"differentiable": True}, {"fused": True}])
def test_refused_options_raise(option):
    p = torch.zeros(3, requires_grad=True)
    with pytest.raises(DMLCError, match=next(iter(option))):
        FusedAdam([p], lr=LR, **option)


def test_refused_option_in_a_later_group_raises_at_step():
    p, q = torch.zeros(3, requires_grad=True), torch.zeros(3, requires_grad=True)
    opt = FusedAdam([p], lr=LR)
    opt.add_param_group({"params": [q], "weight_decay": 0.1})
    p.grad = q.grad = torch.ones(3)
    with pytest.raises(DMLCError, match="weight_decay"):
        opt.step()


def test_parameter_without_grad_is_skipped():
    p, q = torch.ones(4, requires_grad=True), torch.ones(4, requires_grad=True)
    opt = FusedAdam([p, q], lr=LR)
    p.grad = torch.full((4,), 0.5)
    opt.step()
    assert q not in opt.state
    assert torch.equal(q.detach(), torch.ones(4))
    assert not torch.equal(p.detach(), torch.ones(4))
    assert float(opt.state[p]["step"]) == 1.0


def test_closure_is_called_with_grad_enabled():
    p = torch.ones(2, requires_grad=True)
    opt = FusedAdam([p], lr=LR)

    def closure():
        opt.zero_grad()
        loss = (p * p).sum()
        loss.backward()
        return loss

    assert float(opt.step(closure).detach()) == 2.0
    assert float(opt.state[p]["step"]) == 1.0


def test_step_is_recorded_under_the_optimizer_range():
    p = torch.ones(3, requires_grad=True)
    opt = FusedAdam([p], lr=LR)
    p.grad = torch.ones(3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        opt.step()
    assert "Optimizer.step#FusedAdam.step" in {e.key for e in prof.key_averages()}


def test_fm_learner_default_is_fused_adam():
    model = FMLearner(6, num_factors=4, layout="ell", learning_rate=0.05, device="cpu")
    assert type(model.opt) is FusedAdam and model.opt.defaults["lr"] == 0.05
    sgd = FMLearner(6, device="cpu", optimizer=lambda ps: torch.optim.SGD(ps, lr=0.1))
    assert type(sgd.opt) is torch.optim.SGD


def test_the_plain_version_refuses_what_the_kernel_refuses():
    p = torch.zeros(3, dtype=torch.float64)
    with pytest.raises(DMLCError, match="float32"):
        adam.adam_step_([p], [p.clone()], [p.clone()], [p.clone()], [1.0], lr=LR)
    q = torch.zeros(3)
    with pytest.raises(DMLCError, match="shape"):
        adam.adam_step_([q], [torch.zeros(4)], [q.clone()], [q.clone()], [1.0], lr=LR)


def test_leaf_struct_mirrors_the_kernel_interface():
    assert ctypes.sizeof(_build.AdamLeaf) == 64
    assert [name for name, _ in _build.AdamLeaf._fields_] == [
        "p", "g", "m", "v", "n", "bias2_sqrt", "step_size", "mask", "width"]
    assert _build.AdamLeaf.mask.offset == 48 and _build.AdamLeaf.width.offset == 56
    assert any(src.endswith("adam_step.cu") for src in _build.KERNEL_SOURCES)


# ---- row marks ----

def _marked_grads(shape, steps: int, seed: int, dev="cpu") -> list:
    """``steps`` pairs ``(ids, g)``: int32 ids (duplicates, the last row,
    ids outside the rows) and a gradient that is +0.0 on every row no id
    in range names."""
    rng = np.random.default_rng(seed)
    rows = shape[0]
    out = []
    for _ in range(steps):
        ids = rng.integers(0, rows, size=max(rows // 8, 1))
        ids = np.concatenate([ids, ids[:3], [rows - 1, -1, rows, rows + 7]]).astype(np.int32)
        hit = np.zeros(rows, bool)
        hit[ids[(ids >= 0) & (ids < rows)]] = True
        g = rng.normal(size=shape).astype(np.float32)
        g[~hit] = 0.0
        out.append((torch.from_numpy(ids).to(dev), torch.from_numpy(g).to(dev)))
    return out


@pytest.mark.parametrize("shape", [(W,), (W, 3), (W, 8), ((W,), (W, 8))])
def test_step_with_rows_equals_step_on_the_cpu(shape):
    """One leaf, or two (a pair of shapes) that share one id tensor, as
    FM's ``w`` and ``V`` share the batch's ids."""
    shapes = [shape] if isinstance(shape[0], int) else list(shape)
    widths = [int(np.prod(shape[1:])) for shape in shapes]
    drawn = shapes[0] if len(shapes) == 1 else (W, sum(widths))
    runs = [[torch.from_numpy(_start(shape, 8)).requires_grad_(True) for shape in shapes]
            for _ in range(2)]
    opts = [FusedAdam(ps, lr=LR) for ps in runs]
    for ids, g in _marked_grads(drawn, 3, 8):
        parts = g.reshape(W, -1).split(widths, dim=1)
        for ps in runs:
            for p, part in zip(ps, parts):
                p.grad = part.reshape(p.shape).clone()
        opts[0].step(rows={p: ids for p in runs[0]})
        opts[1].step()
    for a, b in zip(*runs):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opts[0].state[a][key], opts[1].state[b][key])


@pytest.mark.parametrize("bad", ["0-d leaf", "float ids", "bool ids", "another device",
                                 "not a parameter"])
def test_bad_rows_raise(bad):
    w0, w = torch.zeros((), requires_grad=True), torch.zeros(6, requires_grad=True)
    opt = FusedAdam([w0, w], lr=LR)
    w0.grad, w.grad = torch.ones(()), torch.ones(6)
    ids = torch.tensor([1, 2])
    rows = {"0-d leaf": {w0: ids},
            "float ids": {w: ids.float()},
            "bool ids": {w: ids > 1},
            "another device": {w: ids.to("meta")},
            "not a parameter": {torch.zeros(6): ids}}[bad]
    with pytest.raises(DMLCError, match="rows|ids"):
        opt.step(rows=rows)
    assert not opt.state  # nothing stepped


@pytest.mark.parametrize("ids,rows", [
    ([], 5), ([0], 1), ([3, 3, 3], 4), ([31, 32, 33, 63, 64], 65), ([-1, 7, 8, 100], 8),
    ([5, 0, 5, 1], 40)])
def test_plain_mark_sets_one_bit_a_named_row(ids, rows):
    words, marked = adam.mark_rows_plain(torch.tensor(ids, dtype=torch.int32), rows)
    assert words.dtype == torch.int32 and words.numel() == (rows + 31) // 32
    want = sorted({i for i in ids if 0 <= i < rows})
    bits = words.numpy().view(np.uint32)
    got = [r for r in range(rows) if (int(bits[r // 32]) >> (r % 32)) & 1]
    assert got == want and marked == len(want)


# ---- on a card ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU route")
    return torch.device("cuda", torch.cuda.current_device())


def _leaf(shape, offset: int, seed: int, dev):
    """A float32 leaf of ``shape`` starting ``offset`` floats into its
    storage (an offset not a multiple of 4 takes the kernel's unaligned
    route)."""
    n = int(np.prod(shape)) if shape else 1
    base = torch.from_numpy(np.random.default_rng(seed).normal(
        size=n + offset).astype(np.float32)).to(dev)
    return base[offset:].view(shape)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,offset", [
    ((), 0), ((1,), 0), ((7,), 0), ((W,), 0), ((W, 8), 0), ((W,), 1), ((W, 8), 3),
    (((1 << 20) + 3,), 0), (((1 << 20) + 3,), 2)])
def test_kernel_equals_ordered_plain_bit_for_bit(card, shape, offset):
    p = _leaf(shape, offset, 1, card)
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    state = [p.clone(), m.clone(), v.clone()]
    for t, g in enumerate(_sparse_grads(shape, 5, 2), 1):
        g = _leaf(shape, offset, 0, card).copy_(torch.from_numpy(g))
        before = adam.launches
        adam.adam_step_([p], [g], [m], [v], [float(t)], lr=LR, betas=BETAS, eps=EPS)
        assert adam.launches == before + 1
        adam.adam_step_ordered_plain_([state[0]], [g], [state[1]], [state[2]], [float(t)],
                                      lr=LR, betas=BETAS, eps=EPS)
        torch.cuda.synchronize()
        for got, want in zip((p, m, v), state):
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), t


@pytest.mark.cuda
def test_fused_adam_launches_once_a_step(card):
    leaves = [_leaf((), 0, 1, card), _leaf((W,), 0, 2, card), _leaf((W, 8), 0, 3, card)]
    for p in leaves:
        p.requires_grad_(True)
    opt = FusedAdam(leaves, lr=LR)
    adam.launches = adam.mark_launches = 0
    for step in range(3):
        for p in leaves:
            p.grad = torch.ones_like(p)
        opt.step()
        assert adam.launches == step + 1
    assert opt.state[leaves[1]]["step"].device.type == "cpu"
    # with rows: still one Adam launch a step, and one mark a shared id tensor
    ids = torch.arange(0, W, 7, device=card)
    for step in range(3):
        for p in leaves:
            p.grad = torch.zeros_like(p)
        opt.step(rows={leaves[1]: ids, leaves[2]: ids})
        assert adam.launches == 3 + step + 1
        assert adam.mark_launches == step + 1


@pytest.mark.cuda
@pytest.mark.parametrize("ids", [[], [0], [3, 3, 3], [31, 32, 33, 63, 64, W - 1],
                                 [-1, 7, W, W + 100, 2 ** 31 - 1], list(range(0, W, 3))])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_mark_kernel_equals_plain(card, ids, dtype):
    ids = torch.tensor(ids, dtype=dtype, device=card)
    mask = torch.full((W // 32 + 2,), -1, dtype=torch.int32, device=card)  # stale words
    adam.mark_rows_cuda_(mask, ids, W)
    want, _ = adam.mark_rows_plain(ids, W)
    words = (W + 31) // 32
    assert torch.equal(mask[:words], want)
    assert torch.equal(mask[words:], torch.full_like(mask[words:], -1))  # past its words


@pytest.mark.cuda
@pytest.mark.parametrize("shape,offset", [
    ((W,), 0), ((W,), 1), ((W, 3), 0), ((W, 3), 2), ((W, 8), 0), ((W, 8), 3),
    ((1, 1), 0), ((2, 3), 0), (((1 << 20) + 3, 8), 0)])
def test_masked_kernel_equals_full_and_plain_bit_for_bit(card, shape, offset):
    """Widths 1, 3 and 8; n % 4 != 0; leaves one float off 16 bytes; ids
    with duplicates, the last row (the padding sink), ids outside the rows
    and none at all; three steps with other ids, so a row marked in one
    step and not in the next takes +0.0 there."""
    masked = _leaf(shape, offset, 1, card)
    full, plain = masked.clone(), masked.clone()
    moments = [[torch.zeros_like(masked), torch.zeros_like(masked)] for _ in range(3)]
    mask = torch.empty((shape[0] + 31) // 32, dtype=torch.int32, device=card)
    steps = _marked_grads(shape, 3, 6, card) + [(torch.zeros(0, dtype=torch.int32, device=card),
                                                 torch.zeros(shape, device=card))]
    for t, (ids, g) in enumerate(steps, 1):
        g = _leaf(shape, offset, 0, card).copy_(g)
        adam.mark_rows_cuda_(mask, ids, shape[0])
        adam.adam_step_([masked], [g], *([x] for x in moments[0]), [float(t)], lr=LR,
                        masks=[mask])
        adam.adam_step_([full], [g], *([x] for x in moments[1]), [float(t)], lr=LR)
        adam.adam_step_ordered_plain_([plain], [g], *([x] for x in moments[2]), [float(t)],
                                      lr=LR)
        torch.cuda.synchronize()
        for got, want in ((masked, full), (masked, plain)):
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), t
        for i in range(2):
            assert torch.equal(moments[0][i].view(torch.int32), moments[1][i].view(torch.int32))
            assert torch.equal(moments[0][i].view(torch.int32), moments[2][i].view(torch.int32))


@pytest.mark.cuda
def test_masked_kernel_does_not_read_an_unmarked_row(card):
    """Width 8, two float4s a row: NaN on every unmarked row of g reaches
    nothing, as the +0.0 the kernel takes there."""
    shape = (W, 8)
    p = _leaf(shape, 0, 1, card)
    want = p.clone()
    m, v, m2, v2 = (torch.zeros_like(p) for _ in range(4))
    ids, g = _marked_grads(shape, 1, 9, card)[0]
    words, _ = adam.mark_rows_plain(ids, W)
    poisoned = torch.where(g == 0, torch.full_like(g, float("nan")), g)
    adam.adam_step_([p], [poisoned], [m], [v], [1.0], lr=LR, masks=[words])
    adam.adam_step_([want], [g], [m2], [v2], [1.0], lr=LR)
    torch.cuda.synchronize()
    assert torch.equal(p.view(torch.int32), want.view(torch.int32))
    assert torch.equal(m.view(torch.int32), m2.view(torch.int32))


def _ell_batches(num_col: int, steps: int, seed: int, dev) -> list:
    """``steps`` ELL batches of 64 rows of up to 6 ids in ``[0, num_col)``,
    padded with the sink ``num_col``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        idx = rng.integers(0, num_col, size=(64, 6)).astype(np.int32)
        val = rng.normal(size=(64, 6)).astype(np.float32)
        pad = rng.random((64, 6)) < 0.3
        idx[pad], val[pad] = num_col, 0.0
        label = (rng.random(64) < 0.5).astype(np.float32)
        out.append(EllBatch(*(torch.from_numpy(a).to(dev)
                              for a in (idx, val, label, np.ones(64, np.float32)))))
    return out


@pytest.mark.cuda
def test_fm_ell_with_row_marks_equals_the_full_read(card):
    kw = dict(num_factors=8, layout="ell", learning_rate=0.05, seed=3, device=card)
    marked, full = FMLearner(W, **kw), FMLearner(W, **kw)
    # the same learner, its optimizer stepped without the rows
    full.opt.register_step_pre_hook(lambda opt, args, kwargs: (args, {}))
    marks = adam.mark_launches
    for batch in _ell_batches(W, 3, 4, card):
        marked.step(batch)
        full.step(batch)
    torch.cuda.synchronize()
    # one mark a step for w and V together, none without the rows
    assert adam.mark_launches - marks == 3
    # the bitmap of the last step: the rows its batch names, the sink's too
    words, _ = adam.mark_rows_plain(batch.indices, W + 1)
    assert torch.equal(marked.opt._bitmaps[0][:words.numel()], words)
    for a, b in zip(marked.params, full.params):
        assert torch.equal(a.detach().view(torch.int32), b.detach().view(torch.int32))
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(marked.opt.state[a][key].view(torch.int32),
                               full.opt.state[b][key].view(torch.int32))
