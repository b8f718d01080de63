"""The row scatters' least time over their device time, in percent. Their
device time is every kernel and fill launched inside autograd's range for
the gather's backward (``_GatherRowsBackward``: the sort, the table's
zeroing, the chunk and long-run kernels); their least time is
``yardstick.step_row_scatter_bytes`` a step at the card's memory rate."""

from portbench import trace, yardstick


def read(run):
    if run.trace is None or run.steps == 0:
        return None
    spent = trace.seconds_under(run.trace, "_GatherRowsBackward")
    if spent <= 0:
        return None
    c = run.config
    need = yardstick.step_row_scatter_bytes(c["num_col"], c["num_factors"],
                                            c["batch_size"], c["max_nnz"])
    return 100.0 * run.steps * need / yardstick.HBM_BYTES_PER_S / spent
