"""The program's own ranges in a ``torch.profiler`` trace of the window.

``dmlc_tpu_torch`` opens ``dmlc_tpu.*`` ranges whenever a torch profiler
is recording: ``dmlc_tpu.step`` with its children ``.forward``,
``.backward`` and ``.optimizer`` around each learner step,
``dmlc_tpu.input_wait`` around the consumer's wait on the pipeline,
``dmlc_tpu.dispatch`` and ``dmlc_tpu.transfer`` around the copies.
:func:`reduce` reads them off the window's thread and splits the device's
idle time over them. :func:`trace.summarize` does not call it yet, so no
metric of the benchmark reads it.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

from portbench import trace

PREFIX = "dmlc_tpu."
NONE = "none"


def _covered(merged):
    """``F(t)``, the length of ``merged`` (sorted, disjoint) before ``t``."""
    starts = [a for a, _ in merged]
    before = [0.0]
    for a, b in merged:
        before.append(before[-1] + (b - a))

    def upto(t):
        i = bisect.bisect_right(starts, t)
        if i == 0:
            return 0.0
        a, b = merged[i - 1]
        return before[i - 1] + min(t, b) - a

    return upto


def _innermost(ranges, w0, w1):
    """The window cut into ``(a, b, name)`` pieces, each named by the
    innermost range open there (``none`` outside every range); ``ranges``
    are ``(start, end, name)``, nested as one thread's ranges are."""
    pieces, stack, t = [], [], w0
    for a, b, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][0] <= a:
            end, inner = stack.pop()
            if end > t:
                pieces.append((t, end, inner))
                t = end
        if a > t:
            pieces.append((t, a, stack[-1][1] if stack else NONE))
            t = a
        stack.append((b, name))
    while stack:
        end, inner = stack.pop()
        if end > t:
            pieces.append((t, end, inner))
            t = end
    if w1 > t:
        pieces.append((t, w1, NONE))
    return pieces


def reduce(path: str) -> dict:
    """``ranges``: ``{name: {"count", "wall_s", "runtime_s"}}`` for every
    ``dmlc_tpu.*`` range on the window's thread, clipped to the window,
    ``runtime_s`` the union of the CUDA runtime and driver calls (any
    thread) inside it; ``idle_by_range``: the device's idle seconds in the
    window, interval by interval, by the innermost ``dmlc_tpu.*`` range open
    on the window's thread then (``none`` outside them), summing to
    ``window_s - busy_s``. Seconds throughout."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    window = next((e for e in events if e.get("name") == trace.WINDOW and e.get("ph") == "X"),
                  None)
    if window is None:
        raise ValueError(f"the trace holds no {trace.WINDOW} range")
    w0, w1 = window["ts"], window["ts"] + window["dur"]
    main = (window["pid"], window["tid"])
    ranges, device, runtime = [], [], []
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X":
            continue
        a, b = e["ts"], e["ts"] + e["dur"]
        if cat in trace.DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                device.append((a, b))
        elif cat in trace.RUNTIME_CATS:
            runtime.append((a, b))
        elif (cat in trace.RANGE_CATS and e["name"].startswith(PREFIX)
              and (e["pid"], e["tid"]) == main):
            a, b = max(a, w0), min(b, w1)
            if b > a:
                ranges.append((a, b, e["name"]))
    in_runtime = _covered(trace._merge(runtime))
    table = defaultdict(lambda: {"count": 0, "wall_s": 0.0, "runtime_s": 0.0})
    for a, b, name in ranges:
        row = table[name]
        row["count"] += 1
        row["wall_s"] += (b - a) / 1e6
        row["runtime_s"] += (in_runtime(b) - in_runtime(a)) / 1e6
    idle, prev = [], w0
    for a, b in trace._merge(device) + [[w1, w1]]:
        if a > prev:
            idle.append((prev, a))
        prev = max(prev, b)
    by_range = defaultdict(float)
    pieces = _innermost(ranges, w0, w1)
    i = 0
    for a, b in idle:
        while i < len(pieces) and pieces[i][1] <= a:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < b:
            pa, pb, name = pieces[j]
            by_range[name] += (min(b, pb) - max(a, pa)) / 1e6
            j += 1
    return {"ranges": dict(table), "idle_by_range": dict(by_range)}
