"""Seconds from the benchmark's first statement to the window's start:
imports, CUDA start, kernel and native builds (first run only), the
corpus, the parameters, the pipeline and the followed steps."""


def read(run):
    return run.setup_s
