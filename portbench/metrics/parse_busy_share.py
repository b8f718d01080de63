"""The fused reader's parse busy thread-seconds (``stats()
["parse_parallel"]["parse_busy_seconds"]``: each chunk's parse time times
the threads it fanned out to) over the window times its parse workers, in
percent. None where the reader reports no busy time."""


def _busy(stats):
    return (stats.get("parse_parallel") or {}).get("parse_busy_seconds")


def read(run):
    b0, b1 = _busy(run.stats0), _busy(run.stats1)
    workers = (run.stats1.get("parse_parallel") or {}).get("parse_workers")
    if b0 is None or b1 is None or not workers or run.window_s <= 0:
        return None
    return 100.0 * (b1 - b0) / (run.window_s * workers)
