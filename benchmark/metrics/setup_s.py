"""Seconds from the process's start to the window's: imports, the
kernels' build where none is cached, the pool and the weights from the
seed, the program's model and evaluator, the warm-up sequence."""


def read(run):
    return run.setup_s
