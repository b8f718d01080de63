"""The FM learner: ``FMLearner`` with its default Adam on the layout the
configuration names (``layout``: ``ell``, padded rows of ``max_nnz``, by
default; ``bcoo``, ragged rows), its initial parameters drawn from the seed
(``reference/params.py``), and what the check reads of it: each leaf's
first gradient as Adam holds it, each leaf's move after the followed
steps, and the reference FM (``reference/fm.py``) that follows the same
steps. Also the faults planted in its timed path for the tests and
``calibrate.py`` (:func:`faults`) and the per-layer metrics a CPU run of
its cells reports (:data:`cpu_metrics`)."""

from __future__ import annotations

import numpy as np
import torch

from portbench import harness
from portbench.reference import check as ref_check
from portbench.reference import fm as ref_fm
from portbench.reference import params as ref_params


# the base names of the per-layer metrics that a CPU run of an FM cell reports
cpu_metrics = ("stall_share", "step_mfu")


def _layout(config: dict) -> str:
    return config.get("layout", "ell")


def build(config: dict, seed: int, device, log=lambda what: None):
    """``FMLearner`` holding the seed's ``(w0, w, V)``: on ``bcoo`` the
    table's rows without the padding sink, which ragged rows never name."""
    from dmlc_tpu_torch import FMLearner
    from dmlc_tpu_torch.models.fm import FMParams

    log("the learner's imports")
    model = FMLearner(config["num_col"], num_factors=config["num_factors"],
                      objective=config["objective"], layout=_layout(config),
                      learning_rate=config["learning_rate"],
                      init_scale=config["init_scale"], device=device)
    log("the learner")
    params = ref_params.full(config, seed, device)
    if _layout(config) == "bcoo":
        params = tuple(p[:config["num_col"]] if p.dim() else p for p in params)
    model.set_params(FMParams(*params))
    del params
    log("the parameters")
    return model


def pipeline_kwargs(model, config: dict) -> dict:
    if _layout(config) == "bcoo":
        return {"layout": "bcoo", "num_col": model.device_num_col()}
    return {"layout": "ell", "num_col": model.device_num_col(), "max_nnz": config["max_nnz"]}


def _chunked_sq_norm(t: torch.Tensor, rows: int = 1 << 22) -> float:
    flat = t.detach().reshape(t.shape[0], -1) if t.dim() else t.detach().reshape(1, 1)
    return sum(float(flat[i:i + rows].double().pow(2).sum()) for i in range(0, len(flat), rows))


def _grad_norms(model) -> list:
    """Each leaf's first gradient, as the optimizer holds it after one
    Adam step: ``exp_avg / (1 - beta1)`` (0 where it holds none)."""
    out = []
    for p, group in ((p, g) for g in model.opt.param_groups for p in g["params"]):
        state = model.opt.state.get(p, {})
        if "exp_avg" not in state:
            out.append(0.0)
            continue
        out.append(_chunked_sq_norm(state["exp_avg"]) ** 0.5 / (1 - group["betas"][0]))
    return out


def _change_norms(model, config: dict, seed: int, device) -> list:
    """Each leaf's distance from the seed's initial parameters, ``V``'s
    drawn again a chunk at a time (over the learner's rows: ``bcoo``'s
    table has no padding sink)."""
    w0, w, v = model.params
    sq_v = 0.0
    for start, block in ref_params.v_chunks(config, seed, device):
        part = v[start:start + len(block)]
        sq_v += _chunked_sq_norm(part - block[:len(part)])
        del block, part
    return [abs(float(w0.detach())), _chunked_sq_norm(w) ** 0.5, sq_v ** 0.5]


def after_step(model, step: int, program: dict) -> None:
    if step == 0:
        program["grad_norms"] = _grad_norms(model)


def after_followed(model, config: dict, seed: int, device, program: dict) -> None:
    program["change_norms"] = _change_norms(model, config, seed, device)


def epoch_end(model) -> None:
    """FM has nothing to finish at an epoch's end."""


def reference_readings(config: dict, seed: int, ref_batches: list, program: dict,
                       device) -> dict:
    """``loss_gap``, ``grad_norm_gap`` and ``change_norm_gap``."""
    return ref_check.step_gaps(program, ref_fm.follow(config, seed, ref_batches, device))


# faults planted in the program's timed path: each takes and returns
# ``(model, it)`` after set-up builds them


def _unchanged(model, it):
    """A step that leaves the state unchanged."""
    model.opt.step = lambda *a, **k: None
    return model, it


def _half_batch(model, it):
    """Half of each batch left out: its weights zeroed, the mean taken over
    the rest."""
    step = model.step

    def half(batch):
        weight = batch[-1].clone()
        weight[len(weight) // 2:] = 0.0
        if hasattr(batch, "_replace"):  # ell
            return step(batch._replace(weight=weight))
        return step((*batch[:-1], weight))
    model.step = half
    return model, it


class _AlteredFeed:
    """One id of each batch altered where the feed makes it."""

    def __init__(self, it):
        self.it = it

    def __next__(self):
        batch = next(self.it)
        if hasattr(batch, "indices"):  # ell
            idx = batch.indices.clone()
            idx[0, 0] = (idx[0, 0] + 1) % idx.max()
            return batch._replace(indices=idx)
        x = batch[0]  # bcoo: the column of x's first entry
        idx = x._indices().clone()
        idx[1, 0] = (idx[1, 0] + 1) % x.shape[1]
        x = torch.sparse_coo_tensor(idx, x._values(), x.shape, check_invariants=False)
        return (x,) + tuple(batch[1:])

    def __getattr__(self, name):
        return getattr(self.it, name)


def faults() -> dict:
    """``{name: fn(model, it) -> (model, it)}``."""
    return {"unchanged_state": _unchanged, "half_batch": _half_batch,
            "altered_id": lambda model, it: (model, _AlteredFeed(it))}


# the same faults planted in the reference's batches, padded or CSR (the
# last four arrays are ids, values, label and weight in both)


def _half(batch):
    weight = batch[-1].copy()
    weight[len(weight) // 2:] = 0.0
    return tuple(batch[:-1]) + (weight,)


def _altered(batch, rng):
    ids = batch[-4].copy()
    if ids.ndim == 2:
        r, k = rng.integers(0, ids.shape[0]), rng.integers(0, ids.shape[1])
        ids[r, k] = (ids[r, k] + 1) % ids.max()
    else:
        j = rng.integers(0, len(ids))
        ids[j] = (ids[j] + 1) % ids.max()
    return tuple(batch[:-4]) + (ids,) + tuple(batch[-3:])


def _bf16_values(batch):
    vals = torch.from_numpy(batch[-3]).to(torch.bfloat16).float().numpy()
    return tuple(batch[:-3]) + (vals,) + tuple(batch[-2:])


def control_readings(config: dict, seed: int, ref_batches: list, device) -> dict:
    """The control, the reference computed in bfloat16 (its batches'
    values rounded to bfloat16 too), and two faults planted in the
    reference put in the program's place: half of each batch left out
    (weight 0, the mean over the rest) and one id of the first batch
    altered. A state left unchanged reads 1 by the norms' measure and
    needs no run."""
    ref = ref_fm.follow(config, seed, ref_batches, device)
    rng = np.random.default_rng([seed, 13])
    sides = {
        "control_bf16": ([_bf16_values(b) for b in ref_batches], torch.bfloat16),
        "fault_half_batch": ([_half(b) for b in ref_batches], torch.float32),
        "fault_altered_id": ([_altered(ref_batches[0], rng)] + ref_batches[1:], torch.float32),
    }
    out = {}
    feed_gaps = harness.layout(config).feed_gaps
    for side, (batches, dtype) in sides.items():
        fed = feed_gaps(batches, ref_batches)
        fed.update(ref_check.step_gaps(ref_fm.follow(config, seed, batches, device, dtype), ref))
        out[side] = fed
    return out
