"""Seconds from the process's start to the window's first call: imports, the
kernels' libraries, the model, the seeded weights and inputs, the warm-up."""


def read(run):
    return run.setup_s
