"""Rows stepped in the window over the window's seconds (host clock,
between the two synchronises that bound it)."""


def read(run):
    return run.rows / run.window_s if run.window_s > 0 else None
