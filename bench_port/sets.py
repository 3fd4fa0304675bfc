"""Sets of runs of one cell, and the spreads that its bounds are set from.

    python3 -m bench_port.sets --workload <cell> --seeds 1,2,3,4,5,6 --sets 2 \\
        --seconds <s> [--traced-seeds 7,8,9] [--out file.json]

Runs ``python3 -m bench_port.run`` once a seed in each of ``--sets`` sets
(every set the same seeds in the same order), one process after another,
then once with ``--trace 1`` for each of ``--traced-seeds``. For each
end-to-end metric and set it gives the median and the spread: the distance
between the first and the third quartile (``statistics.quantiles(n=4)``)
over the median; then the widest spread over the sets and five times it
(never under 0.01), the bound that this spread supports. ``setup_s`` leaves
out each set's first run, which may build the kernels. Each run's result
line, exit code and wall seconds go into ``--out``; a summary goes to stderr.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

from bench_port import harness as H


def one_run(workload, seed, seconds, trace):
    """(exit code, result line or None, wall seconds, the last stderr lines)."""
    cmd = [sys.executable, "-m", "bench_port.run", "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(int(trace))]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=H.ROOT, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    lines = p.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if p.returncode == 0 and lines else None
    return p.returncode, result, wall, p.stderr.strip().splitlines()[-12:]


def spread(values):
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def summarize(sets):
    """{metric: {"medians", "spreads", "widest", "five_times"}} of the sets'
    result lines (a list of lists)."""
    out = {}
    names = sorted({n for runs in sets for r in runs if r for n in r["metrics"]})
    for name in names:
        per_set = []
        for runs in sets:
            vals = [r["metrics"][name]["value"] for r in runs if r and name in r["metrics"]]
            if name == "setup_s":
                vals = vals[1:]
            if len(vals) >= 2:
                per_set.append(vals)
        if not per_set:
            continue
        spreads = [spread(v) for v in per_set]
        out[name] = {"medians": [statistics.median(v) for v in per_set], "spreads": spreads,
                     "widest": max(spreads), "five_times": max(0.01, 5 * max(spreads))}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m bench_port.sets")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--seconds", type=float, default=None,
                   help="the window; BENCHMARK.json's run_seconds by default")
    p.add_argument("--traced-seeds", default="")
    p.add_argument("--out")
    args = p.parse_args(argv)
    seconds = args.seconds or H.benchmark()["run_seconds"]
    seeds = [int(x) for x in args.seeds.split(",") if x]
    record = {"workload": args.workload, "seconds": seconds, "seeds": seeds, "runs": []}
    sets = []
    for k in range(args.sets):
        sets.append([])
        for seed in seeds:
            rc, result, wall, tail = one_run(args.workload, seed, seconds, False)
            sets[-1].append(result)
            record["runs"].append({"set": k, "seed": seed, "trace": 0, "rc": rc, "wall_s": wall,
                                   "result": result, "stderr_tail": tail})
            print(f"set {k} seed {seed}: rc {rc} wall {wall:.1f} s "
                  f"{json.dumps(result) if result else tail}", file=sys.stderr, flush=True)
    for seed in [int(x) for x in args.traced_seeds.split(",") if x]:
        rc, result, wall, tail = one_run(args.workload, seed, seconds, True)
        record["runs"].append({"set": None, "seed": seed, "trace": 1, "rc": rc, "wall_s": wall,
                               "result": result, "stderr_tail": tail})
        print(f"traced seed {seed}: rc {rc} wall {wall:.1f} s "
              f"{json.dumps(result) if result else tail}", file=sys.stderr, flush=True)
    record["summary"] = summarize(sets)
    record["all_correct"] = all(r["result"] and r["result"]["correct"] for r in record["runs"])
    for name, s in record["summary"].items():
        print(f"{name}: medians {s['medians']} spreads {s['spreads']} five times "
              f"{s['five_times']:.4f}", file=sys.stderr)
    print(f"all correct: {record['all_correct']}", file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0 if record["all_correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
