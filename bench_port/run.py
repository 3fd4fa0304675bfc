"""Run one cell of the benchmark on the card this process is started on.

    python3 -m bench_port.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up builds the program's model, loads the
seeded weights and inputs and warms up the cell's own shapes; then the
window measures for ``--seconds``; then the program's state is freed and the
plain reference checks what the timed path produced. The last stdout line is
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``); the
numbers compared and their limits are also the last lines of stderr.

Exits 2, and prints no result, without a card (or fewer than the cell asks
for), and 3 if a module of ``jax``, ``jaxlib``, ``flax`` or ``desr_tpu`` is
loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

T_IMPORT = time.perf_counter()


def process_start():
    """The perf_counter reading of this process's start (from /proc; the
    import of this module where /proc has no answer)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def cache_dirs(root):
    """Build and kernel caches inside the checkout, at fixed paths (the
    program's own nvcc libraries already live in ``desr_tpu_torch/_build``)."""
    base = os.path.join(root, ".bench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(base, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(base, "triton"))


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m bench_port.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    t0 = process_start()
    args = parse(argv)
    from bench_port import harness as H

    cache_dirs(H.ROOT)
    bench = H.benchmark()
    cell = H.find_cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench_port: the cell asks for {cell.chips} CUDA device(s), {n} available",
              file=sys.stderr)
        return 2
    with contextlib.redirect_stdout(sys.stderr):
        run = H.driver(cell).run(cell, args.seed, args.seconds, bool(args.trace), "cuda", t0)
    found = H.forbidden_modules()
    if found:
        print(f"bench_port: modules of jax or desr_tpu are loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    metrics = H.read_metrics(H.cell_metrics(bench, cell.name, bool(args.trace)), run)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": run.peak_bytes}
    breakdown = None
    if args.trace:
        from bench_port import trace as T

        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
        breakdown = T.breakdown(run.trace)
    print(H.window_summary(run), file=sys.stderr)
    line = H.result_line(run, metrics, device, breakdown)
    line["card"] = card()
    print(f"card: {line['card']}", file=sys.stderr)
    for text in H.check_lines(run):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    # ``checks`` stays the last key of the line
    line["checks"] = line.pop("checks")
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
