"""Device time and idle time by the program's own spans
(``desr_tpu_torch/tracing.py``): which layer launched each kernel, copy and
set of a profiled sub-window, and what the host was doing while the card
sat idle.

``profile_spanned(call, n, sync)`` runs ``call(i)`` n times under
``torch.profiler`` (CUDA activity, which also records the CUDA runtime's
and driver's launch calls on the host) with the program's spans on, and
keeps the device operations, the launches, the spans and the clocks'
offset. ``attribute`` then joins each device operation to its launch
(``args.correlation``) and maps the launch's host time onto the spans'
timeline (``perf_counter_ns + offset_ns = ts * 1000 + baseTimeNanoseconds``):
the operation goes to the innermost span open then on the thread of the
root spans. Autograd issues the backward from a thread of its own while the
caller's thread waits inside its span, so a launch from another thread goes
by its time to that thread's open span too. Each idle gap between the
device's busy intervals is cut at span boundaries, and each piece goes to
the span open then, or to ``caller`` where the host was outside every span
of the program (the benchmark's own copies back and cropping). A span's
numbers include its children's; ``self_*`` leave them out.

``read(attr, kind, name)`` gives the per-layer metrics of ``METRICS`` from
an attribution, None where it has none of their spans, so a program
without spans reads nothing.

    python3 -m bench_port.spans --workload <cell> --seed <n> [--out <file>]

runs a cell's set-up as its driver does (model, seeded weights and inputs,
warm-up), then the driver's unspanned profiled sub-window
(``trace.profile``), the spanned one, a short one with host activity too
(to read the clocks' mapping against the spans' ``record_function``
events), blocks of calls with spans off and on, and the host cost of one
span;
prints one JSON object and writes it, with the spanned sub-window's raw
records, to ``--out``. It needs a card.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import os
import statistics
import sys
import tempfile
import time

from bench_port import trace as T

CALLER = "caller"
UNMATCHED = "no launch"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

# metric: (kind, the spans whose numbers it sums, the number read)
METRICS = {
    "upload_ms.serve": ("serve", ("serve.upload",), "host_ms"),
    "upload_idle_ms.serve": ("serve", ("serve.upload",), "idle_ms"),
    "guidance_ms.serve": ("serve", ("net.I2D_features", "net.Image2Depth"), "device_ms"),
    "depth_f_ms.serve": ("serve", ("net.Depth_f",), "device_ms"),
    "task_ms.serve": ("serve", ("net.Task",), "device_ms"),
    "forward_ms.train": ("train", ("step.forward",), "device_ms"),
    "loss_tail_ms.train": ("train", ("step.losses",), "device_ms"),
    "backward_ms.train": ("train", ("step.backward",), "device_ms"),
    "adam_ms.train": ("train", ("step.optimizer",), "device_ms"),
    "forward_host_ms.train": ("train", ("step.forward",), "host_ms"),
    "backward_host_ms.train": ("train", ("step.backward",), "host_ms"),
    "launches.train": ("train", ("step",), "ops"),
}


def read(attr, kind, name):
    """The metric ``name`` of an attribution of a ``kind`` ("serve",
    "train") cell; None where the attribution lacks its spans."""
    m_kind, names, key = METRICS[name]
    if attr is None or kind != m_kind:
        return None
    found = [attr["spans"][n][key] for n in names if n in attr["spans"]]
    return float(sum(found)) if found else None


# ---------------------------------------------------------------- recording

def export(prof):
    """The exported chrome trace of a finished ``torch.profiler`` run."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.remove(path)


def records(trace):
    """(device ops [(name, ts, dur, correlation)], launches {correlation:
    [ts, tid]}, annotations [(name, ts, dur)]) of an exported trace, in us."""
    ops, launches, notes = [], {}, []
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in T.DEVICE_CATS:
            ops.append((e["name"], float(e["ts"]), float(e["dur"]),
                        (e.get("args") or {}).get("correlation")))
        elif cat in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = [float(e["ts"]), e.get("tid")]
        elif cat == "user_annotation":
            notes.append((e["name"], float(e["ts"]), float(e["dur"])))
    return ops, launches, notes


def profile_spanned(call, n, sync, cpu=False):
    """The raw records of ``call(i)`` for i < n under the profiler with the
    program's spans on: {"window_s", "calls", "ops", "launches", "notes",
    "spans", "offset_ns", "base_ns"}; ``cpu`` adds host activity."""
    from torch.profiler import ProfilerActivity, profile

    from desr_tpu_torch import tracing

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    sync()
    tracing.drain()
    tracing.enable()
    try:
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for i in range(n):
                call(i)
            sync()
            window_s = time.perf_counter() - t0
    finally:
        tracing.disable()
    spans = [list(s) for s in tracing.drain()]
    trace = export(prof)
    ops, launches, notes = records(trace)
    return {"window_s": window_s, "calls": n, "ops": ops, "launches": launches,
            "notes": notes, "spans": spans, "offset_ns": tracing.offset_ns(),
            "base_ns": int(trace.get("baseTimeNanoseconds", 0))}


# ---------------------------------------------------------------- attribution

def span_intervals(rec):
    """[(name, start_us, end_us, thread, parent)] of the record's spans on the
    trace's timeline, and the thread that holds the most root spans."""
    shift = rec["offset_ns"] - rec["base_ns"]
    out = [(s[0], (s[5] + shift) / 1000.0, (s[6] + shift) / 1000.0, s[4], s[3])
           for s in rec["spans"]]
    roots = {}
    for name, _, _, thread, parent in out:
        if parent is None:
            roots[thread] = roots.get(thread, 0) + 1
    main = max(roots, key=roots.get) if roots else None
    return out, main


def segments(intervals):
    """(starts, paths): from ``starts[i]`` to the next start, ``paths[i]``
    is the tuple of the names of the spans open, outermost first (nested
    intervals ``(name, start, end)``); () after the last."""
    bounds = sorted({t for _, a, b in intervals for t in (a, b)})
    paths = []
    for t0, t1 in zip(bounds, bounds[1:]):
        mid = (t0 + t1) / 2
        inside = sorted((a, -b, name) for name, a, b in intervals if a <= mid < b)
        paths.append(tuple(name for _, _, name in inside))
    return bounds, paths + [()]


def path_at(starts, paths, t):
    i = bisect.bisect_right(starts, t) - 1
    return paths[i] if i >= 0 else ()


def pieces(starts, paths, a, b):
    """(t0, t1, path) covering [a, b), cut where the open spans change."""
    i = bisect.bisect_right(starts, a) - 1
    while a < b:
        stop = min(b, starts[i + 1]) if i + 1 < len(starts) else b
        yield a, stop, paths[i] if i >= 0 else ()
        a, i = stop, i + 1


def op_class(name):
    """"HtoD", "DtoH", "DtoD" of a copy, "set" of a memset, else "kernel"."""
    for kind in ("HtoD", "DtoH", "DtoD"):
        if kind in name:
            return kind
    return "set" if name.startswith("Memset") else "kernel"


def attribute(rec, top=10, width=160):
    """Device ops, device time and idle time of a spanned sub-window by span.

    {"calls", "spans": {name: {"host_ms", "device_ms", "self_device_ms",
    "ops", "self_ops", "idle_ms", "self_idle_ms"} a call}, "span_ops" and
    "idle_gaps" ([name, seconds], the ``top`` largest: "<span>| <op>" and
    "<span>| before <op>"), "placement" ({"<op class>| <innermost span>|
    <root span>": ops}), "launch_threads" (ops by the thread id of their
    launch: "spans' thread" where it is the root spans', ``UNMATCHED``
    where no launch was found)}."""
    calls = rec["calls"]
    spans, main = span_intervals(rec)
    on_main = [(n, a, b) for n, a, b, thread, _ in spans if thread == main]
    main_tid = None if main is None else main & 0xFFFFFFFF  # CUPTI's 32-bit thread id
    starts, paths = segments(on_main)

    stats = {}

    def add(name, key, value):
        s = stats.setdefault(name, {"host_ms": 0.0, "device_ms": 0.0, "self_device_ms": 0.0,
                                    "ops": 0.0, "self_ops": 0.0, "idle_ms": 0.0,
                                    "self_idle_ms": 0.0})
        s[key] += value

    for name, a, b in on_main:
        add(name, "host_ms", (b - a) / 1e3)
    root_us = sum(b - a for n, a, b, thread, parent in spans
                  if thread == main and parent is None)
    add(CALLER, "host_ms", rec["window_s"] * 1e3 - root_us / 1e3)

    threads = {}
    pairs, placement = {}, {}
    ops = sorted(rec["ops"], key=lambda o: o[1])
    for op, ts, dur, corr in ops:
        launch = rec["launches"].get(corr)
        if launch is None:
            path, tid = (UNMATCHED,), UNMATCHED
        else:
            path = path_at(starts, paths, launch[0]) or (CALLER,)
            tid = "spans' thread" if launch[1] == main_tid else str(launch[1])
        threads[tid] = threads.get(tid, 0) + 1
        for name in set(path):
            add(name, "device_ms", dur / 1e3)
            add(name, "ops", 1)
        add(path[-1], "self_device_ms", dur / 1e3)
        add(path[-1], "self_ops", 1)
        key = f"{path[-1]}| {op}"
        pairs[key] = pairs.get(key, 0.0) + dur * 1e-6
        key = f"{op_class(op)}| {path[-1]}| {path[0]}"
        placement[key] = placement.get(key, 0) + 1

    gaps = {}
    end = None
    for op, ts, dur, _ in ops:
        if end is not None and ts > end:
            for a, b, path in pieces(starts, paths, end, ts):
                name = path[-1] if path else CALLER
                for n in set(path or (CALLER,)):
                    add(n, "idle_ms", (b - a) / 1e3)
                add(name, "self_idle_ms", (b - a) / 1e3)
                key = f"{name}| before {op}"
                gaps[key] = gaps.get(key, 0.0) + (b - a) * 1e-6
        end = ts + dur if end is None else max(end, ts + dur)

    per_call = {name: {k: v / calls for k, v in s.items()} for name, s in stats.items()}
    largest = lambda d: [[k[:width], v] for k, v in  # noqa: E731
                         sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"calls": calls, "spans": per_call, "span_ops": largest(pairs),
            "idle_gaps": largest(gaps), "placement": placement, "launch_threads": threads}


def breakdown(attr):
    """What an attribution adds to a traced run's ``breakdown``: span-named
    ``idle_gaps``, ``spans`` and ``span_ops``."""
    return {"idle_gaps": attr["idle_gaps"], "spans": attr["spans"],
            "span_ops": attr["span_ops"]}


# ---------------------------------------------------------------- checks

def launch_margin_us(rec, op_kind, name):
    """(ops of class ``op_kind``, how many were launched inside a span
    ``name``, the least distance in us from such a launch to its span's
    nearer edge): how far the clocks' mapping could be off before the
    check fails."""
    edges = sorted((a, b) for n, a, b, _, _ in span_intervals(rec)[0] if n == name)
    starts = [a for a, _ in edges]
    n = inside = 0
    margin = float("inf")
    for op, _, _, corr in rec["ops"]:
        if op_class(op) != op_kind:
            continue
        n += 1
        launch = rec["launches"].get(corr)
        if launch is None:
            continue
        i = bisect.bisect_right(starts, launch[0]) - 1
        if i >= 0 and launch[0] <= edges[i][1]:
            inside += 1
            margin = min(margin, launch[0] - edges[i][0], edges[i][1] - launch[0])
    return n, inside, margin


def mapping(rec):
    """How the spans' mapped times sit against the ``record_function``
    events they entered (a sub-window with host activity): the signed gaps
    in us between each span's mapped start and its event's (each name's
    spans and events in order; median, least, largest), and the launches
    whose innermost span differs when the events' own intervals place
    them. None without such events."""
    names = {s[0] for s in rec["spans"]}
    events = {}
    for name, ts, dur in sorted(rec["notes"], key=lambda e: e[1]):
        if name in names:
            events.setdefault(name, []).append((name, ts, ts + dur))
    spans, main = span_intervals(rec)
    on_main = [(n, a, b) for n, a, b, thread, _ in spans if thread == main]
    seen, gaps, noted = {}, [], []
    for name, a, b in sorted(on_main, key=lambda s: s[1]):
        k = seen[name] = seen.get(name, -1) + 1
        if k < len(events.get(name, ())):
            noted.append(events[name][k])
            gaps.append(events[name][k][1] - a)
    if not gaps:
        return None
    by_spans, by_events = segments(on_main), segments(noted)
    launches = [ts for ts, _ in rec["launches"].values()]
    differ = sum(path_at(*by_spans, t)[-1:] != path_at(*by_events, t)[-1:] for t in launches)
    return {"start_gap_us": [statistics.median(gaps), min(gaps), max(gaps)],
            "spans": len(gaps), "launches": len(launches), "launches_placed_otherwise": differ}


def checks(rec, attr, kind):
    """The clock check and the coverage of the cell's spans."""
    place = attr["placement"]
    total = lambda pred: sum(v for k, v in place.items() if pred(*k.split("| ")))  # noqa: E731
    s = attr["spans"]
    dev = lambda n: s.get(n, {}).get("device_ms", 0.0)  # noqa: E731
    out = {"launch_threads": attr["launch_threads"]}
    if kind == "serve":
        n, inside, margin = launch_margin_us(rec, "HtoD", "serve.upload")
        out.update({
            "htod_ops": n, "htod_in_upload": inside, "htod_margin_us": margin,
            "ops_outside_serve_not_caller": total(lambda c, inner, root: root not in
                                                  ("serve", CALLER)),
            "caller_ops": {k: v for k, v in place.items() if k.split("| ")[2] == CALLER},
            "nets_share": sum(dev(n) for n in s if n.startswith("net.")) / dev("serve"),
            "nets_and_serve_self_share": (sum(dev(n) for n in s if n.startswith("net."))
                                          + s["serve"]["self_device_ms"]) / dev("serve"),
            "upload_share": dev("serve.upload") / dev("serve"),
        })
    else:
        phases = ("step.forward", "step.losses", "step.backward", "step.optimizer")
        out.update({
            "ops_outside_step": total(lambda c, inner, root: root != "step"),
            "ops_outside_step_by_root": {k: v for k, v in place.items()
                                         if k.split("| ")[2] != "step"},
            "phases_share": sum(dev(p) for p in phases) / dev("step") if dev("step") else None,
        })
    return out


# ---------------------------------------------------------------- the tool

def serve_call(cell, seed, dev):
    """(call(i), host seconds of each call's ``serve_forward``) as the serve
    driver builds them."""
    import torch

    from bench_port import data as D
    from bench_port.drivers import serve as SV

    t = cell.traffic
    (h, w), padded, _ = SV.grids(cell)
    depth, image = D.frames(seed, t["pool"], (h, w), dev)
    pool_d, pool_i = depth.cpu().numpy(), image.cpu().numpy()
    model = SV.build_model(cell, dev, seed, torch)
    request = SV.Requester(model, pool_d, pool_i, padded, t["batch"], seed,
                           lambda m, batch: m.serve_forward(batch), t["batches"])
    host = []
    return lambda i: request(host), host


def train_call(cell, seed, dev):
    """(call(i), host seconds of each step's ``set_input`` +
    ``optimize_parameters``) as the train driver builds them."""
    import torch

    from bench_port import data as D
    from bench_port.drivers import train as TR

    t = cell.traffic
    model, _ = TR.build_model(cell, seed, dev, TR.hole_generator(seed, dev), torch)
    pool = [D.train_batch(seed, i, t["batch"], TR.lr_hw_of(cell), dev) for i in range(t["pool"])]
    host, count = [], [0]

    def call(i):
        k = count[0]
        count[0] += 1
        t1 = time.perf_counter()
        model.set_input(pool[k % len(pool)])
        model.optimize_parameters(k + 1)
        host.append(time.perf_counter() - t1)

    return call, host


def span_cost_us(n=20000):
    """Host us of one span entered and left, no profiler: {"off", "on"}."""
    from desr_tpu_torch import tracing

    out = {}
    for side in ("off", "on"):
        if side == "on":
            tracing.enable()
        try:
            t0 = time.perf_counter()
            for _ in range(n):
                with tracing.span("cost"):
                    pass
            out[side] = (time.perf_counter() - t0) / n * 1e6
        finally:
            tracing.disable()
    tracing.drain()
    return out


def on_cost(call, host, n, sync, rounds=8):
    """Mean host ms of a call in each block of ``n`` calls with spans off
    and on, alternating which goes first: {"off": [...], "on": [...]}."""
    from desr_tpu_torch import tracing

    got = {"off": [], "on": []}
    for r in range(rounds):
        for side in (("off", "on") if r % 2 == 0 else ("on", "off")):
            if side == "on":
                tracing.enable()
            host.clear()
            try:
                for i in range(n):
                    call(i)
                sync()
            finally:
                tracing.disable()
            tracing.drain()
            got[side].append(statistics.mean(host) * 1e3)
    return got


def measure(cell, seed, dev, warmup):
    """The tool's report on one cell (see the module's docstring), and the
    spanned sub-window's raw records."""
    import torch

    kind = cell.traffic["driver"]
    call, host = (serve_call if kind == "serve" else train_call)(cell, seed, dev)
    n = cell.traffic["profile_calls"]

    def sync():
        torch.cuda.synchronize()

    for i in range(warmup):
        call(i)
    sync()
    host.clear()
    plain = T.profile(call, n, sync)
    plain_host = list(host)
    host.clear()
    rec = profile_spanned(call, n, sync)
    spanned_host = list(host)
    attr = attribute(rec)
    mapped = profile_spanned(call, 2, sync, cpu=True)
    report = {
        "workload": cell.name, "seed": seed, "calls": n,
        "metrics": {name: read(attr, kind, name) for name, m in METRICS.items() if m[0] == kind},
        "breakdown": breakdown(attr),
        "checks": checks(rec, attr, kind),
        "clock": {"mapping": mapping(mapped), "offset_ns": rec["offset_ns"],
                  "base_ns": rec["base_ns"],
                  "launch_tids": sorted({t for _, t in rec["launches"].values()}),
                  "span_threads": sorted({s[4] & 0xFFFFFFFF for s in rec["spans"]})},
        "unspanned": {"window_s": plain["window_s"], "busy_s": plain["busy_s"],
                      "host_call_ms": statistics.mean(plain_host) * 1e3,
                      "device_ms_per_call": plain["busy_s"] * 1e3 / n},
        "spanned": {"window_s": rec["window_s"],
                    "host_call_ms": statistics.mean(spanned_host) * 1e3,
                    "device_ms_per_call": sum(o[2] for o in rec["ops"]) / 1e3 / n,
                    "placement": attr["placement"]},
        "on_cost_host_call_ms": on_cost(call, host, n, sync),
        "span_cost_us": span_cost_us(),
    }
    return report, rec


def main(argv=None):
    from bench_port import harness as H
    from bench_port.run import cache_dirs, card

    p = argparse.ArgumentParser(prog="python3 -m bench_port.spans")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--warmup", type=int, default=8)
    p.add_argument("--out")
    args = p.parse_args(argv)
    cache_dirs(H.ROOT)
    cell = H.find_cell(H.benchmark(), args.workload)
    import torch

    if not torch.cuda.is_available():
        print("bench_port.spans: no CUDA device", file=sys.stderr)
        return 2
    with contextlib.redirect_stdout(sys.stderr):
        report, rec = measure(cell, args.seed, torch.device("cuda"), args.warmup)
    report["card"] = card()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"report": report, "spanned": rec}, f)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
