"""One run of one cell: set-up, the measured window, the check against
the reference, and the result.

The system under test is ``dmlc_tpu_torch``'s training path: a pipeline
over a corpus written from the seed, opened by the cell's input route
(``routes/<route>.py``, ``cold`` by default), feeding the learner that the
configuration's ``model`` names (``learners/<model>.py``). The harness
knows neither: it writes the corpus (``corpora/<corpus>.py``), has the
learner built and the route open its pipeline, runs the followed steps
and the window, and hands the check to the learner. The window is the loop
of ``TrainLoopMixin.fit_epoch`` driven from here: ``batch = next(it)``,
``loss = model.step(batch)``, the learner's ``epoch_end`` and
``it.reset()`` at each epoch's end, a CUDA event recorded after each step,
and no host sync between the synchronise that opens the window and the
one after the last step enqueued before ``seconds`` have passed.

The configuration's ``layout`` (``ell`` by default, or ``bcoo``) says what
form the fed batches take, and so how the harness reads them back to the
host, which of the reference's parses it compares them with, and which
feed comparison it uses (:data:`LAYOUTS`).

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
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from portbench import registry
from portbench import trace as trace_mod
from portbench.reference import check as ref_check
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
    hit_rows: Optional[float] = None  # :func:`hit_rows` of the checked batches


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


class _HostLoad:
    """What the host did in the window, for the log: the main thread's and
    the process's CPU seconds, the cyclic collector's pauses, and how far
    the launches ran ahead of the card when the window closed (the final
    synchronise's wait: tens of milliseconds where the card sets the pace,
    a few where the host does)."""

    def __init__(self):
        self.gc_s, self.gc_max, self.gc_n, self._gc_t = 0.0, 0.0, 0, None
        self.thread0, self.process0 = time.thread_time(), time.process_time()
        gc.callbacks.append(self._on_gc)

    def _on_gc(self, phase, info):
        if phase == "start":
            self._gc_t = time.perf_counter()
        elif self._gc_t is not None:
            dt = time.perf_counter() - self._gc_t
            self.gc_s, self.gc_max, self.gc_n = self.gc_s + dt, max(self.gc_max, dt), self.gc_n + 1

    def close(self, t0: float, t_sent: float, t_end: float) -> str:
        gc.callbacks.remove(self._on_gc)
        span = max(t_end - t0, 1e-9)
        return (f"main thread CPU {100 * (time.thread_time() - self.thread0) / span:.1f}%, "
                     f"process CPU {100 * (time.process_time() - self.process0) / span:.1f}% "
                     f"of one core; {self.gc_n} collections, {1e3 * self.gc_s:.1f} ms, longest "
                     f"{1e3 * self.gc_max:.1f} ms; last launch {1e3 * (t_end - t_sent):.1f} ms "
                     f"before the card finished")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host_ell(batch) -> tuple:
    return tuple(t.detach().cpu().numpy() for t in batch)


def _host_csr(batch) -> tuple:
    """A ``bcoo`` batch ``(x, label, weight)`` as ragged CSR arrays
    ``(offsets, ids, values, label, weight)``: ``x``'s entries (the program
    builds it on its real entries alone) grouped by row, in their order
    within each row."""
    x, label, weight = batch
    coords = x.detach()._indices().cpu().numpy()
    vals = x.detach()._values().cpu().numpy()
    order = np.argsort(coords[0], kind="stable")
    offsets = np.zeros(x.shape[0] + 1, dtype=np.int64)
    np.cumsum(np.bincount(coords[0], minlength=x.shape[0]), out=offsets[1:])
    return (offsets, coords[1][order], vals[order], label.detach().cpu().numpy(),
            weight.detach().cpu().numpy())


def _parse_ell(config: dict, corpus: str, r0: int, r1: int) -> tuple:
    return ref_parse.rows(corpus, config["format"], r0, r1, config["num_col"],
                          config["max_nnz"])


def _parse_csr(config: dict, corpus: str, r0: int, r1: int) -> tuple:
    return ref_parse.csr_rows(corpus, config["format"], r0, r1)


class Layout(NamedTuple):
    """What the harness does with one batch layout: the fed batch's host
    form, the reference's parse in the same form, and their comparison."""

    host: Callable
    parse: Callable
    feed_gaps: Callable


LAYOUTS = {"ell": Layout(_host_ell, _parse_ell, ref_check.feed_gaps),
           "bcoo": Layout(_host_csr, _parse_csr, ref_check.feed_gaps_csr)}


def layout(config: dict) -> Layout:
    """The configuration's ``layout`` (``ell`` where it names none)."""
    return LAYOUTS[config.get("layout", "ell")]


def corpus_path(root: str, config: dict, seed: int) -> str:
    return os.path.join(root, ".portbench_cache", "corpus",
                        f"{config['name']}.{seed}.{config['format']}")


def corpus_name(config: dict) -> str:
    """The corpus writer a configuration names: ``corpus``, else ``format``."""
    return config.get("corpus", config["format"])


def build(learner, route, writer, config: dict, seed: int, device, corpus: str,
          cleanups: contextlib.ExitStack, log: Callable[[str], None] = lambda what: None):
    """The corpus, the learner with the seed's parameters, and the
    pipeline over the corpus; the route's cleanup joins ``cleanups``."""
    writer.write(corpus, config, seed)
    log("the corpus")
    model = learner.build(config, seed, device, log=log)
    it, cleanup = route.open_pipeline(config, corpus, learner, model, device)
    cleanups.callback(cleanup)
    log("the pipeline")
    return model, it


def run(config: dict, cell: dict, seed: int, seconds: float, traced: bool, device,
        root: str, t_start: float, log: Callable[[str], None] = lambda s: None,
        fault: Optional[Callable] = None) -> tuple:
    """One run. Returns ``(Run, readings, limits)``. ``fault`` (tests) is
    called with ``(model, it)`` after set-up builds them and may wrap
    either, to break the timed path. The learner, the route and the corpus
    writer are looked up first: a name with no file fails before any work."""
    device = torch.device(device)
    learner = registry.learner(config["model"])
    route = registry.route(cell.get("route", "cold"))
    writer = registry.corpus_writer(corpus_name(config))
    corpus = corpus_path(root, config, seed)
    with contextlib.ExitStack() as cleanups:
        # each runs, the route's first, whether or not the run ended well
        cleanups.callback(_remove, corpus)
        return _run(learner, route, writer, config, cell, seed, seconds, traced, device,
                    corpus, cleanups, t_start, log, fault)


def _remove(path: str) -> None:
    with contextlib.suppress(FileNotFoundError):
        os.remove(path)


def _run(learner, route, writer, config, cell, seed, seconds, traced, device, corpus,
         cleanups, t_start, log, fault):
    rec = Run(config=config, cell=cell)
    log(f"set-up: {time.perf_counter() - t_start:.3f} s before the corpus")
    model, it = build(learner, route, writer, config, seed, device, corpus, cleanups,
                      log=lambda what: log(f"set-up: {time.perf_counter() - t_start:.3f} s "
                                           f"after {what}"))
    if fault is not None:
        model, it = fault(model, it)
    batch_rows = config["batch_size"]
    host_batch = layout(config).host
    # the followed steps, through the window's own calls; they warm up
    # every shape the window uses and allocate the optimizer's state
    program = {"losses": []}
    fed = []
    for step in range(FOLLOWED):
        batch = next(it)
        fed.append(host_batch(batch))
        program["losses"].append(float(model.step(batch)))
        learner.after_step(model, step, program)
    learner.after_followed(model, config, seed, device, program)
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
    host = _HostLoad()
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
                    learner.epoch_end(model)
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
        t_sent = time.perf_counter()
        _sync(device)
    rec.window_s = time.perf_counter() - t0
    host_line = host.close(t0, t_sent, t0 + rec.window_s)
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
    in_next = rec.stats1.get("stall_seconds", 0) - rec.stats0.get("stall_seconds", 0)
    log(f"window host: {host_line}; in next() {100 * in_next / rec.window_s:.1f}%")
    fed += [host_batch(b) for _, b in held]
    positions = list(range(FOLLOWED)) + [p for p, _ in held]
    # the program's state goes before the reference runs
    it.close()
    del model, it, batch, held, losses
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref_batches = reference_batches(config, corpus, positions)
    rec.hit_rows = hit_rows(ref_batches, config["num_col"])
    log(f"hit rows {rec.hit_rows} a batch, the mean over {len(ref_batches)} checked batches")
    readings = reference_readings(learner, config, seed, ref_batches, fed, program, device)
    return rec, readings, cell["limits"]


def reference_batches(config: dict, corpus: str, positions: list) -> list:
    """The reference's parse of the batches at ``positions``, in the form
    of the configuration's layout."""
    b, parse = config["batch_size"], layout(config).parse
    return [parse(config, corpus, p * b, (p + 1) * b) for p in positions]


def hit_rows(ref_batches: list, num_col: int) -> float:
    """The rows a step's row scatter has to write, from the traffic alone:
    the mean over ``ref_batches`` (the reference's parse, padded or CSR;
    the ids are the fourth array from the end in both) of the number of
    distinct ids in ``[0, num_col]``. The padding sink ``num_col`` counts
    where a padded batch names it, since the scatter writes it too."""
    counts = []
    for batch in ref_batches:
        ids = batch[-4].ravel()
        counts.append(len(np.unique(ids[(ids >= 0) & (ids <= num_col)])))
    return float(np.mean(counts))


def reference_readings(learner, config, seed, ref_batches, fed, program, device) -> dict:
    """The gaps between the program's readings and the reference's: the
    feed's over every compared batch (``ref_batches``, the reference's
    parse of the batches ``fed`` holds), then the learner's over the
    followed ones."""
    out = layout(config).feed_gaps(fed, ref_batches)
    out.update(learner.reference_readings(config, seed, ref_batches[:FOLLOWED], program,
                                          device))
    return out
