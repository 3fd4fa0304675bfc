"""Arithmetic the metric readers share (``metrics/<name>.py``). Each reader
returns None where its cell has nothing for it to read, and the harness then
leaves the metric out of the line."""

from __future__ import annotations

import numpy as np

from bench_port import trace as T
from bench_port.reference.work import PEAK_BF16_FLOPS

K1_KERNELS = ("conv3x3_wgmma_kernel", "conv3x3_f32_kernel")
K3_KERNELS = ("masked_loss_sums_kernel", "masked_loss_grads_kernel")


def rate(run, kind):
    """Units (frames, pairs) completed a second over the whole window."""
    return run.units / run.window_s if run.kind == kind else None


def p95_ms(values_s):
    return float(np.percentile(np.asarray(values_s), 95)) * 1e3 if values_s else None


def host_call_ms(run, kind):
    """Mean host time of the program's call, up to its return, in the window."""
    if run.kind != kind or not run.host_call_s:
        return None
    return float(np.mean(run.host_call_s)) * 1e3


def mfu(run, kind):
    """The reference's FLOPs of a call at the window's call rate, as a share
    of the bf16 dense peak (%)."""
    if run.kind != kind or run.work is None or not run.work["flops_per_call"]:
        return None
    return run.work["flops_per_call"] * run.calls_per_s / PEAK_BF16_FLOPS * 100.0


def roofline(run, kind, kernels, prefix):
    """The kernels' least time (``<prefix>_bound_s_per_call`` a call) over
    their profiled device time (%); None where the trace has none of them or
    not ``<prefix>_launches_per_call`` a call (then the counted work is not
    the work that ran)."""
    if run.kind != kind or run.trace is None or run.work is None:
        return None
    launches, seconds = T.kernel_time(run.trace, kernels)
    calls = run.trace["calls"]
    if not launches or launches != run.work[f"{prefix}_launches_per_call"] * calls:
        return None
    return run.work[f"{prefix}_bound_s_per_call"] * calls / seconds * 100.0


def idle(run, kind):
    """Share of the profiled window with no device operation running (%)."""
    if run.kind != kind or run.trace is None or run.trace["window_s"] <= 0:
        return None
    return (1.0 - run.trace["busy_s"] / run.trace["window_s"]) * 100.0
