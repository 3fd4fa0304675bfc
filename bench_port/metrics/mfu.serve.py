"""A request's conv and matmul FLOPs (the reference under FlopCounterMode)
at the window's request rate, over the bf16 dense peak, in %."""

from bench_port import readers as R


def read(run):
    return R.mfu(run, "serve")
