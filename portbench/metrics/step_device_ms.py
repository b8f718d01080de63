"""Kernel and fill time on the device in the traced window, over its
steps, in ms (the feed's copies left out)."""


def read(run):
    if run.trace is None or run.trace["step_s"] <= 0 or run.steps == 0:
        return None
    return 1e3 * run.trace["step_s"] / run.steps
