"""K1's least time (its launches' ops at the bf16 peak or bytes at HBM's)
over its profiled device time, in %, in serving."""

from bench_port import readers as R


def read(run):
    return R.roofline(run, "serve", R.K1_KERNELS, "k1")
