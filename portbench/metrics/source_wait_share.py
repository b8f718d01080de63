"""The pipeline's serial stage blocked on the fused reader (``stats()
["source_wait_seconds"]``) over the window, in percent."""


def read(run):
    d = run.stats1["source_wait_seconds"] - run.stats0["source_wait_seconds"]
    return 100.0 * d / run.window_s if run.window_s > 0 else None
