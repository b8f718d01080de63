"""Device time of the kernels launched inside torch's own
``Optimizer.step#...`` range, over the step's device time, in percent."""

from portbench import trace


def read(run):
    if run.trace is None or run.trace["step_s"] <= 0:
        return None
    opt = trace.seconds_under(run.trace, "Optimizer.step#")
    return 100.0 * opt / run.trace["step_s"] if opt > 0 else None
