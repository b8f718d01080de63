"""The convert pool's busy seconds (``stats()["convert_seconds"]``) over the
window times its workers, in percent."""


def read(run):
    d = run.stats1["convert_seconds"] - run.stats0["convert_seconds"]
    workers = run.stats1["convert_workers"]
    if run.window_s <= 0 or not workers:
        return None
    return 100.0 * d / (run.window_s * workers)
