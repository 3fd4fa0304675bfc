"""K1's least time over its profiled device time, in %, over a train step's
forward launches."""

from bench_port import readers as R


def read(run):
    return R.roofline(run, "train", R.K1_KERNELS, "k1")
