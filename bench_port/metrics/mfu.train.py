"""A step's conv and matmul FLOPs, forward and backward (the reference under
FlopCounterMode), at the window's step rate, over the bf16 dense peak, in %."""

from bench_port import readers as R


def read(run):
    return R.mfu(run, "train")
