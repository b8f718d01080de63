"""Reduce a ``torch.profiler`` trace of the measured window to what the
metric readers use.

The trace is the profiler's Chrome-format export. A device operation
(``kernel``, ``gpu_memset``, ``gpu_memcpy``) is tied by its correlation id
to the runtime call that launched it, and that call to the host ranges
open around it on its thread (torch's op ranges, the optimizer's
``Optimizer.step#...`` range, autograd's ``evaluate_function: ...``
ranges, and the benchmark's own ``portbench.*`` spans)."""

from __future__ import annotations

import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")
STEP_CATS = ("kernel", "gpu_memset")  # a step's own work; copies are the feed's
RANGE_CATS = ("cpu_op", "user_annotation")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "portbench.window"
SPANS = ("portbench.next", "portbench.step", "portbench.reset")


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(path: str, top: int = 10) -> dict:
    """The window's device time: ``window_s``, ``busy_s`` (the union of
    every device operation), ``step_s`` (kernels and fills, summed),
    ``copy_s``, ``by_ranges`` (``{(enclosing range names...): seconds of
    kernels and fills}``), ``by_name`` (``{device operation name: [seconds,
    count]}``), ``device_ops`` (the ``top`` names by time) and
    ``idle_gaps`` (the ``top`` longest, each named by the benchmark span
    the host was in at its middle). Seconds throughout."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    window = next((e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"), None)
    if window is None:
        raise ValueError(f"the trace holds no {WINDOW} range")
    w0, w1 = window["ts"], window["ts"] + window["dur"]
    main = (window["pid"], window["tid"])
    device, threads, spans = [], defaultdict(list), []
    for e in events:
        cat, ph = e.get("cat"), e.get("ph")
        if ph != "X":
            continue
        if cat in DEVICE_CATS:
            a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
            if b > a:
                device.append((a, b, e["name"], cat, e.get("args", {}).get("correlation")))
        elif cat in RANGE_CATS:
            threads[(e["pid"], e["tid"])].append((e["ts"], 0, -e["dur"], e["name"]))
            if e["name"] in SPANS and (e["pid"], e["tid"]) == main:
                spans.append((e["ts"], e["ts"] + e["dur"], e["name"]))
        elif cat in RUNTIME_CATS and "correlation" in e.get("args", {}):
            threads[(e["pid"], e["tid"])].append((e["ts"], 1, 0, e["args"]["correlation"]))
    # the host ranges open around each launch
    stack_of = {}
    for items in threads.values():
        stack = []
        for ts, kind, neg_dur, what in sorted(items, key=lambda x: x[:3]):
            while stack and stack[-1][0] <= ts:
                stack.pop()
            if kind == 0:
                stack.append((ts - neg_dur, what))
            else:
                stack_of[what] = tuple(name for _, name in stack)
    by_ranges, by_name, count = defaultdict(float), defaultdict(float), defaultdict(int)
    step_s = copy_s = 0.0
    for a, b, name, cat, corr in device:
        dt = (b - a) / 1e6
        by_name[name] += dt
        count[name] += 1
        if cat in STEP_CATS:
            step_s += dt
            by_ranges[stack_of.get(corr, ())] += dt
        else:
            copy_s += dt
    busy = _merge((a, b) for a, b, *_ in device)
    gaps, prev = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    spans.sort()

    def host_was_in(t):
        inside = [name for a, b, name in spans if a <= t <= b]
        return inside[-1] if inside else "portbench.loop"

    gaps.sort(key=lambda g: g[0] - g[1])
    return {"window_s": (w1 - w0) / 1e6,
            "busy_s": sum(b - a for a, b in busy) / 1e6,
            "step_s": step_s, "copy_s": copy_s,
            "by_ranges": dict(by_ranges),
            "by_name": {n: [s, count[n]] for n, s in by_name.items()},
            "device_ops": [[n, s] for n, s in sorted(by_name.items(), key=lambda x: -x[1])[:top]],
            "idle_gaps": [[host_was_in((a + b) / 2), (b - a) / 1e6] for a, b in gaps[:top]]}


def kernels_named(summary: dict, fragment: str) -> tuple:
    """``(seconds, launches)`` of the device operations whose name holds
    ``fragment``."""
    hits = [v for n, v in summary["by_name"].items() if fragment in n]
    return sum(s for s, _ in hits), sum(c for _, c in hits)


def seconds_under(summary: dict, fragment: str) -> float:
    """Kernel and fill seconds launched inside a host range whose name holds
    ``fragment``."""
    return sum(s for names, s in summary["by_ranges"].items()
               if any(fragment in n for n in names))
