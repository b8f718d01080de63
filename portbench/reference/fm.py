"""The reference FM step: forward, backward by hand, and Adam, over the
rows that the given batches touch.

    margin = w0 + Σ_k w[i_k] x_k + 0.5 Σ_f ((Σ_k V[i_k, f] x_k)² - Σ_k V[i_k, f]² x_k²)
    loss   = Σ_b weight_b · BCE(margin_b, label_b) / max(Σ_b weight_b, 1)

A batch is the reference's own parse in either of its forms
(``reference/parse.py``): padded ``(ids, values, label, weight)`` or
ragged CSR ``(offsets, ids, values, label, weight)``, whose rows are laid
into a block as long as the longest row (:func:`_padded`), so that both
forms take one forward and sum each row in a fixed order.

Adam is ``torch.optim.Adam``'s update written out (β 0.9 / 0.999, ε 1e-8,
bias-corrected; no weight decay). A row that no batch touched has a zero
gradient at every step, so Adam leaves it exactly where it started:
following only the touched rows gives the whole table's result."""

from __future__ import annotations

import torch

from portbench.reference import params as ref_params

BETAS = (0.9, 0.999)
EPS = 1e-8


def _forward_backward(w0, w, v, loc, x, y, wt):
    """The loss and the gradients of ``w0``, ``w`` and ``V`` (each the
    shape of its table)."""
    w_g, v_g = w[loc], v[loc]                      # [B, K], [B, K, F]
    xx = x * x
    s = torch.einsum("bkf,bk->bf", v_g, x)
    s2 = torch.einsum("bkf,bk->bf", v_g * v_g, xx)
    margin = w0 + (w_g * x).sum(1) + 0.5 * (s * s - s2).sum(1)
    den = torch.clamp(wt.sum(), min=1.0)
    per = torch.clamp(margin, min=0) - margin * y + torch.log1p(torch.exp(-margin.abs()))
    loss = (per * wt).sum() / den
    dm = (torch.sigmoid(margin) - y) * wt / den    # d loss / d margin
    g_w0 = dm.sum()
    g_w = torch.zeros_like(w).index_add_(0, loc.reshape(-1), (dm[:, None] * x).reshape(-1))
    g_vg = dm[:, None, None] * (x[..., None] * s[:, None, :] - v_g * xx[..., None])
    g_v = torch.zeros_like(v).index_add_(0, loc.reshape(-1), g_vg.reshape(-1, v.shape[1]))
    return loss, (g_w0, g_w, g_v)


def _padded(offsets, loc, x):
    """Ragged rows (``loc``, ``x`` flat, row ``b`` at ``[offsets[b],
    offsets[b + 1])``) as a ``[B, longest row]`` block: each row's entries
    in file order, then slots of value 0 at the first touched row, which a
    value of 0 leaves as it is. :func:`_forward_backward` then sums every
    row in one fixed order."""
    n = len(offsets) - 1
    lens = offsets[1:] - offsets[:-1]
    row = torch.repeat_interleave(torch.arange(n, device=loc.device), lens)
    pos = torch.arange(len(loc), device=loc.device) - offsets[row]
    longest = int(lens.max()) if n else 0
    loc_b, x_b = loc.new_zeros((n, longest)), x.new_zeros((n, longest))
    loc_b[row, pos] = loc
    x_b[row, pos] = x
    return loc_b, x_b


def follow(config: dict, seed: int, batches: list, device, dtype=torch.float32) -> dict:
    """Run the configuration's first ``len(batches)`` steps from the
    seed's initial parameters, in ``dtype``. ``batches`` are the
    reference's own numpy batches, padded or CSR (module docstring).

    Returns ``losses`` (one a step), ``grad_norms`` (each leaf's first
    gradient) and ``change_norms`` (each leaf's distance from its start
    after the last step), leaves in the order ``w0``, ``w``, ``V``."""
    # float32 products stay float32 on the card (TF32 off, torch's default)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lr = config["learning_rate"]
    ids = [torch.as_tensor(b[-4], device=device) for b in batches]
    uniq = torch.unique(torch.cat([i.reshape(-1) for i in ids]))
    start = ref_params.rows_of(config, seed, uniq, dtype)
    leaves = [t.clone() for t in start]
    m = [torch.zeros_like(t) for t in leaves]
    sq = [torch.zeros_like(t) for t in leaves]
    losses, grad_norms = [], None
    for t, (b, i) in enumerate(zip(batches, ids), 1):
        loc = torch.searchsorted(uniq, i)
        x, y, wt = (torch.as_tensor(a, device=device, dtype=dtype) for a in b[-3:])
        if len(b) == 5:
            loc, x = _padded(torch.as_tensor(b[0], device=device), loc, x)
        loss, grads = _forward_backward(*leaves, loc, x, y, wt)
        losses.append(float(loss))
        if grad_norms is None:
            grad_norms = [float(torch.linalg.vector_norm(g.double())) for g in grads]
        bc1, bc2 = 1 - BETAS[0] ** t, 1 - BETAS[1] ** t
        for p, g, ma, va in zip(leaves, grads, m, sq):
            ma.mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
            va.mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
            denom = (va.sqrt() / bc2 ** 0.5).add_(EPS)
            p.addcdiv_(ma, denom, value=-lr / bc1)
    change = [float(torch.linalg.vector_norm((p - p0).double())) for p, p0 in zip(leaves, start)]
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
