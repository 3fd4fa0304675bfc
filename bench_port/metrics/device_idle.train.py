"""Share of the profiled sub-window with no kernel, copy or set running on
the card, in %, in training."""

from bench_port import readers as R


def read(run):
    return R.idle(run, "train")
