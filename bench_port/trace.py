"""The traced sub-window: ``torch.profiler`` with CUDA activity alone (host
events would stretch the window they are meant to measure), its chrome trace
read back for the device's kernels, copies and sets.

``profile(call, n)`` runs ``call(i)`` n times under the profiler and returns
the window's wall (host clock, the card synchronised at both ends) with the
device's intervals; ``summarize`` reduces them to busy time (the union of the
intervals), time a kernel name, and the idle gaps between them.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profile(call, n, sync):
    """{"window_s", "calls", "events": [(name, start_us, dur_us), ...]}."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    sync()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            call(i)
        sync()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    events = [(e["name"], float(e["ts"]), float(e["dur"])) for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    return summarize(events, window_s, n)


def summarize(events, window_s, calls):
    """Busy seconds (the union of the device intervals), seconds and count a
    name, and the gaps between busy spans, each named by the operation that
    ends it."""
    events = sorted(events, key=lambda e: e[1])
    by_name = {}
    for name, _, dur in events:
        n, s = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, s + dur * 1e-6)
    busy, gaps = 0.0, []
    end = None
    span_start = None
    for name, ts, dur in events:
        if end is None or ts > end:
            if end is not None:
                busy += end - span_start
                gaps.append((f"before {name}", (ts - end) * 1e-6))
            span_start, end = ts, ts + dur
        else:
            end = max(end, ts + dur)
    if end is not None:
        busy += end - span_start
    return {"window_s": window_s, "calls": calls, "busy_s": busy * 1e-6,
            "by_name": by_name, "gaps": gaps}


def kernel_time(trace, patterns):
    """(launches, seconds) of the kernels whose names hold one of ``patterns``."""
    n, s = 0, 0.0
    for name, (count, secs) in trace["by_name"].items():
        if any(p in name for p in patterns):
            n, s = n + count, s + secs
    return n, s


def breakdown(trace, top=10, width=160):
    """The device operations that took most time and the longest idle gaps."""
    ops = sorted(trace["by_name"].items(), key=lambda kv: -kv[1][1])[:top]
    gaps = {}
    for name, secs in trace["gaps"]:
        gaps[name] = gaps.get(name, 0.0) + secs
    longest = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[name[:width], secs] for name, (_, secs) in ops],
            "idle_gaps": [[name[:width], secs] for name, secs in longest]}
