"""Enhanced frames a second: every frame completed in the window over the
window's seconds."""

from bench_port import readers as R


def read(run):
    return R.rate(run, "serve")
