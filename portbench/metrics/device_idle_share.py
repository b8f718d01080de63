"""1 - the union of the device's kernel, fill and copy intervals over the
traced window, in percent."""


def read(run):
    t = run.trace
    if t is None or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
