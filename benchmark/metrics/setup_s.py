"""Seconds from the process's start to the window's start: imports, the
kernels' build or load, the inputs and weights, and the warm-up."""


def read(run):
    return run.setup_s
