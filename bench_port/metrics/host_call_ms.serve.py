"""Mean host milliseconds of serve_forward, up to its return, over the
window's requests."""

from bench_port import readers as R


def read(run):
    return R.host_call_ms(run, "serve")
