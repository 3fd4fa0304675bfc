"""RGB-D pairs trained a second: every pair of every step in the window over
the window's seconds (the card synchronised at its end)."""

from bench_port import readers as R


def read(run):
    return R.rate(run, "train")
