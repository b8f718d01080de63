"""The row scatters' least time over their device time, in percent. Their
device time is every kernel and fill launched inside autograd's range for
the gather's backward (``_GatherRowsBackward``: the sort, the table's
zeroing, the chunk and long-run kernels); their least time is
``yardstick.step_row_scatter_bytes`` a step at the card's memory rate: the
entries read once and the rows the batch hits written once, ``hit_rows``
counted by the harness from the reference's parse of the checked batches."""

from portbench import trace, yardstick


def read(run):
    if run.trace is None or run.steps == 0 or run.hit_rows is None:
        return None
    spent = trace.seconds_under(run.trace, "_GatherRowsBackward")
    if spent <= 0:
        return None
    c = run.config
    need = yardstick.step_row_scatter_bytes(c["num_factors"], c["batch_size"], c["max_nnz"],
                                            run.hit_rows)
    return 100.0 * run.steps * need / yardstick.HBM_BYTES_PER_S / spent
