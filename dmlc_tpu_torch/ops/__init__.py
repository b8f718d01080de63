"""Sparse layouts and their plain products (``ops.sparse``), and the
hand-written kernels with their routes (``ops.ell_matvec``)."""
