"""One run of one cell: set-up, the measured window, the check against
the reference, and the result.

The system under test is ``dmlc_tpu_torch``'s training path:
``create_parser(corpus)`` -> ``DeviceIter(layout="ell")`` ->
``FMLearner.step``. The window is the loop of ``TrainLoopMixin.fit_epoch``
driven from here: ``batch = next(it)``, ``loss = model.step(batch)``,
``it.reset()`` at each epoch's end, a CUDA event recorded after each step,
and no host sync between the synchronise that opens the window and the
one after the last step enqueued before ``seconds`` have passed.

:func:`run` takes the device it is given; ``run.py`` refuses a machine
without the cards a cell asks for, and the CPU serves the tests alone."""

from __future__ import annotations

import contextlib
import gc
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from portbench import registry
from portbench import trace as trace_mod
from portbench.reference import check as ref_check
from portbench.reference import fm as ref_fm
from portbench.reference import params as ref_params
from portbench.reference import parse as ref_parse

FOLLOWED = 3       # steps the reference follows, run before the window
SAMPLE_SPAN = 32   # the window batch compared is drawn from its first steps
FORBIDDEN = ("jax", "jaxlib", "flax", "dmlc_tpu")


@dataclass
class Run:
    """What one run read, for the metric readers (``ctx`` of ``read``)."""

    config: dict
    cell: dict
    setup_s: float = 0.0
    window_s: float = 0.0
    steps: int = 0
    rows: int = 0
    epochs: int = 0
    intervals_ms: list = field(default_factory=list)
    peak_bytes: int = 0
    stats0: dict = field(default_factory=dict)
    stats1: dict = field(default_factory=dict)
    trace: Optional[dict] = None
    failed: int = 0


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark's process
    may not hold."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


class _EventClock:
    """Step ends as CUDA events on the current stream."""

    def __init__(self):
        self.marks = []

    def mark(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append(ev)

    def intervals_ms(self):
        return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]


class _HostClock:
    """Step ends on the host's clock: a CPU step is done when it returns."""

    def __init__(self):
        self.marks = []

    def mark(self):
        self.marks.append(time.perf_counter())

    def intervals_ms(self):
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host_batch(batch) -> tuple:
    return tuple(t.detach().cpu().numpy() for t in batch)


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


def corpus_path(root: str, config: dict, seed: int) -> str:
    return os.path.join(root, ".portbench_cache", "corpus",
                        f"{config['name']}.{seed}.{config['format']}")


def build(config: dict, seed: int, device, corpus: str,
          log: Callable[[str], None] = lambda what: None):
    """The corpus, the learner with the seed's parameters, and the
    pipeline over the corpus."""
    from dmlc_tpu_torch import DeviceIter, FMLearner, create_parser
    from dmlc_tpu_torch.models.fm import FMParams

    registry.corpus_writer(config["format"]).write(corpus, config, seed)
    log("the corpus")
    log("the pipeline's imports")
    model = FMLearner(config["num_col"], num_factors=config["num_factors"],
                      objective=config["objective"], layout="ell",
                      learning_rate=config["learning_rate"],
                      init_scale=config["init_scale"], device=device)
    log("the learner")
    params = ref_params.full(config, seed, device)
    model.set_params(FMParams(*params))
    del params
    log("the parameters")
    it = DeviceIter(create_parser(f"{corpus}?format={config['format']}"),
                    num_col=model.device_num_col(), batch_size=config["batch_size"],
                    layout="ell", max_nnz=config["max_nnz"], device=device)
    return model, it


def run(config: dict, cell: dict, seed: int, seconds: float, traced: bool, device,
        root: str, t_start: float, log: Callable[[str], None] = lambda s: None,
        fault: Optional[Callable] = None) -> tuple:
    """One run. Returns ``(Run, readings, limits)``. ``fault`` (tests) is
    called with ``(model, it)`` after set-up builds them and may wrap
    either, to break the timed path."""
    device = torch.device(device)
    corpus = corpus_path(root, config, seed)
    try:
        return _run(config, cell, seed, seconds, traced, device, corpus, t_start, log, fault)
    finally:
        with contextlib.suppress(FileNotFoundError):
            os.remove(corpus)


def _run(config, cell, seed, seconds, traced, device, corpus, t_start, log, fault):
    rec = Run(config=config, cell=cell)
    log(f"set-up: {time.perf_counter() - t_start:.3f} s before the corpus")
    model, it = build(config, seed, device, corpus, log=lambda what: log(
        f"set-up: {time.perf_counter() - t_start:.3f} s after {what}"))
    if fault is not None:
        model, it = fault(model, it)
    batch_rows = config["batch_size"]
    # the followed steps, through the window's own calls; they warm up
    # every shape the window uses and allocate Adam's state
    program = {"losses": []}
    fed = []
    for step in range(FOLLOWED):
        batch = next(it)
        fed.append(_host_batch(batch))
        program["losses"].append(float(model.step(batch)))
        if step == 0:
            program["grad_norms"] = _grad_norms(model)
    program["change_norms"] = _change_norms(model, config, seed, device)
    log(f"set-up: {time.perf_counter() - t_start:.3f} s after the followed steps")
    pos = FOLLOWED
    sample_at = int(np.random.default_rng([seed, 11]).integers(0, SAMPLE_SPAN))
    clock = _EventClock() if device.type == "cuda" else _HostClock()
    rec.stats0 = it.stats()
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
    span = (torch.profiler.record_function if traced
            else lambda name: contextlib.nullcontext())
    held, losses = [], []
    _sync(device)
    rec.setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    with span(trace_mod.WINDOW):
        clock.mark()
        while True:
            with span("portbench.next"):
                try:
                    batch = next(it)
                    ended = False
                except StopIteration:
                    ended = True
            if ended:
                with span("portbench.reset"):
                    it.reset()
                rec.epochs += 1
                pos = 0
                continue
            if rec.steps == sample_at or (pos == 0 and rec.epochs == 1):
                held.append((pos, tuple(t.clone() for t in batch)))
            with span("portbench.step"):
                losses.append(model.step(batch))
            clock.mark()
            rec.steps += 1
            pos += 1
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(device)
    rec.window_s = time.perf_counter() - t0
    rec.rows = rec.steps * batch_rows
    rec.stats1 = it.stats()
    rec.intervals_ms = clock.intervals_ms()
    rec.failed = int((~torch.isfinite(torch.stack(losses))).sum()) if losses else 0
    rec.peak_bytes = (torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0)
    found = forbidden_modules()
    if found:
        raise ImportError(f"the run holds modules it may not: {found}")
    if prof is not None:
        prof.__exit__(None, None, None)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            rec.trace = trace_mod.summarize(path)
    iv = np.array(rec.intervals_ms) if rec.intervals_ms else np.zeros(1)
    log(f"window {rec.window_s:.3f} s, {rec.steps} steps, {rec.epochs} epoch ends; step ms "
        + " ".join(f"p{q} {np.percentile(iv, q):.3f}" for q in (50, 90, 95, 97, 99))
        + f" max {iv.max():.3f}, {int((iv > 1.2 * np.median(iv)).sum())} over 1.2x median")
    fed += [_host_batch(b) for _, b in held]
    positions = list(range(FOLLOWED)) + [p for p, _ in held]
    # the program's state goes before the reference runs
    it.close()
    del model, it, batch, held, losses
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = reference_readings(config, seed, corpus, fed, positions, program, device)
    return rec, readings, cell["limits"]


def reference_batches(config: dict, corpus: str, positions: list) -> list:
    b, k = config["batch_size"], config["max_nnz"]
    return [ref_parse.rows(corpus, config["format"], p * b, (p + 1) * b, config["num_col"], k)
            for p in positions]


def reference_readings(config, seed, corpus, fed, positions, program, device) -> dict:
    """The gaps between the program's readings and the reference's."""
    ref_batches = reference_batches(config, corpus, positions)
    ref = ref_fm.follow(config, seed, ref_batches[:FOLLOWED], device)
    out = ref_check.feed_gaps(fed, ref_batches)
    out.update(ref_check.step_gaps(program, ref))
    return out
