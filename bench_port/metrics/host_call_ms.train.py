"""Mean host milliseconds of set_input + optimize_parameters, up to their
return, over the window's steps."""

from bench_port import readers as R


def read(run):
    return R.host_call_ms(run, "train")
