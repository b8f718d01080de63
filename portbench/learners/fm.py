"""The FM learner: ``FMLearner`` on the ELL layout with its default Adam,
its initial parameters drawn from the seed (``reference/params.py``), and
what the check reads of it: each leaf's first gradient as Adam holds it,
each leaf's move after the followed steps, and the reference FM
(``reference/fm.py``) that follows the same steps."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import check as ref_check
from portbench.reference import fm as ref_fm
from portbench.reference import params as ref_params


def build(config: dict, seed: int, device, log=lambda what: None):
    """``FMLearner`` holding the seed's ``(w0, w, V)``."""
    from dmlc_tpu_torch import FMLearner
    from dmlc_tpu_torch.models.fm import FMParams

    log("the learner's imports")
    model = FMLearner(config["num_col"], num_factors=config["num_factors"],
                      objective=config["objective"], layout="ell",
                      learning_rate=config["learning_rate"],
                      init_scale=config["init_scale"], device=device)
    log("the learner")
    params = ref_params.full(config, seed, device)
    model.set_params(FMParams(*params))
    del params
    log("the parameters")
    return model


def pipeline_kwargs(model, config: dict) -> dict:
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
    drawn again a chunk at a time."""
    w0, w, v = model.params
    sq_v = 0.0
    for start, block in ref_params.v_chunks(config, seed, device):
        sq_v += _chunked_sq_norm(v[start:start + len(block)] - block)
        del block
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


def _half(batch):
    ids, vals, label, weight = batch
    weight = weight.copy()
    weight[len(weight) // 2:] = 0.0
    return ids, vals, label, weight


def _altered(batch, rng):
    ids = batch[0].copy()
    r, k = rng.integers(0, ids.shape[0]), rng.integers(0, ids.shape[1])
    ids[r, k] = (ids[r, k] + 1) % ids.max()
    return (ids,) + tuple(batch[1:])


def _bf16_values(batch):
    ids, vals, label, weight = batch
    return ids, torch.from_numpy(vals).to(torch.bfloat16).float().numpy(), label, weight


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
    for side, (batches, dtype) in sides.items():
        fed = ref_check.feed_gaps(batches, ref_batches)
        fed.update(ref_check.step_gaps(ref_fm.follow(config, seed, batches, device, dtype), ref))
        out[side] = fed
    return out
