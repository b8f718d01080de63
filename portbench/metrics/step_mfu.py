"""The step's least time over the window's seconds a step, in percent: the
larger of its float32 operations at the card's peak and its bytes at the
memory rate (``yardstick.step_bytes``, ``yardstick.step_ops``)."""

from portbench import yardstick


def read(run):
    if run.steps == 0 or run.window_s <= 0:
        return None
    c = run.config
    args = (c["num_col"], c["num_factors"], c["batch_size"], c["max_nnz"])
    least = yardstick.least_seconds(yardstick.step_bytes(*args), yardstick.step_ops(*args))
    return 100.0 * least / (run.window_s / run.steps)
