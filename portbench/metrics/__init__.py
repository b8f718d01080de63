"""Metric readers, one module a metric, found by the metric's name (dots
read as underscores). Each has ``read(run) -> float | None`` over a
:class:`portbench.harness.Run`; None means this run holds nothing to read,
and the metric is left out of the result line."""
