"""The convert pool's seconds off the CPU inside its busy intervals
(``stats()["convert_seconds"] - stats()["convert_cpu_seconds"]``: the wait
for the interpreter lock, and preemption) over the window times its
workers, in percent. None where the program keeps no CPU seconds."""


def read(run):
    if "convert_cpu_seconds" not in run.stats1 or "convert_cpu_seconds" not in run.stats0:
        return None
    off = [s["convert_seconds"] - s["convert_cpu_seconds"] for s in (run.stats0, run.stats1)]
    workers = run.stats1["convert_workers"]
    if run.window_s <= 0 or not workers:
        return None
    return 100.0 * (off[1] - off[0]) / (run.window_s * workers)
