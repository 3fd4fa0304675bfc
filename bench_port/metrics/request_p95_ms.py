"""95th percentile of the window's request latencies (host arrays in, depth
maps back on the host), in ms."""

from bench_port import readers as R


def read(run):
    return R.p95_ms(run.latencies_s) if run.kind == "serve" else None
