"""Kernel K2's least time over its device time, in percent: each launch's
bytes (``yardstick.widen_span_bytes``: one warm ELL batch's values slab read
and written) at the card's memory rate, over the device time of its
launches in the traced window. K2 is ``decode_span_kernel`` in
``csrc/widen_span.cu``; None where the window launched it not at all (a
cold epoch, the CPU)."""

from portbench import trace, yardstick

KERNEL = "decode_span_kernel"


def read(run):
    if run.trace is None:
        return None
    spent, launches = trace.kernels_named(run.trace, KERNEL)
    if spent <= 0 or launches == 0:
        return None
    c = run.config
    need = yardstick.widen_span_bytes(c["batch_size"], c["max_nnz"])
    return 100.0 * launches * need / yardstick.HBM_BYTES_PER_S / spent
