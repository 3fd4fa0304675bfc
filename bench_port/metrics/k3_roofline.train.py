"""K3's least time (16 bytes a value for the sums, 20 for the backward, at
HBM's peak) over the profiled device time of its two kernels, in %."""

from bench_port import readers as R


def read(run):
    return R.roofline(run, "train", R.K3_KERNELS, "k3")
