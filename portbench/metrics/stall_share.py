"""The consumer's time inside ``DeviceIter.__next__`` (``stats()
["stall_seconds"]``) over the window, in percent."""


def read(run):
    d = run.stats1["stall_seconds"] - run.stats0["stall_seconds"]
    return 100.0 * d / run.window_s if run.window_s > 0 else None
