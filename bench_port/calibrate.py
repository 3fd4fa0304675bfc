"""Readings that the limits of a cell's output check are set from, on the card.

    python3 -m bench_port.calibrate --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 [--controls fp8,fp8_operands] \\
        [--fault-seeds 1,2,3 --faults half_left_out,swapped] [--out file.json]

For each seed of ``--seeds`` the program's readings against the float32
reference at the cell's own sizes (serving: the seed's assembled requests,
each once; training: the checked steps); for each of ``--control-seeds`` and
each precision of ``--controls`` the control's: the reference computed in
that precision (``reference/nets.py``), put in the program's place; for each
of ``--fault-seeds`` and each fault of ``--faults`` (``faults.py``) the
program's with that fault planted in its timed path. One JSON line a seed on
stdout (keys ``program``, ``control.<precision>``, ``fault.<name>``), and all
of them in ``--out`` when given. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time

import numpy as np

from bench_port import faults as F
from bench_port import harness as H
from bench_port.reference import stage3 as R


def serve_readings(cell, seeds, control_seeds, controls, fault_seeds, faults, dev):
    import torch

    from bench_port import data as D
    from bench_port.drivers import serve as S

    (h, w), padded, lr_hw = S.grids(cell)
    t = cell.traffic
    model = None

    def program(seed, pool_d, pool_i, serve):
        nonlocal model
        if model is None:
            model = S.build_model(cell, dev, seed, torch)
        else:
            weights = D.weights(R.param_shapes(cell.cfg, R.SERVING_NETS), seed, dev)
            for name, sd in weights.items():
                model.nets[name].load_state_dict(sd)
        request = S.Requester(model, pool_d, pool_i, padded, t["batch"], seed, serve,
                              t["batches"])
        return [request(copy=True) for _ in range(t["batches"])]

    for seed in sorted(set(seeds) | set(control_seeds) | set(fault_seeds)):
        t0 = time.perf_counter()
        depth, image = D.frames(seed, t["pool"], (h, w), dev)
        pool_d, pool_i = depth.cpu().numpy(), image.cpu().numpy()
        row = {"seed": seed, "names": ["frame_mean_gap", "pixel_max_gap"]}
        frames = set(range(t["pool"]))
        ref = S.reference_outputs(cell, seed, dev, pool_d, pool_i, frames, padded, lr_hw)
        if seed in seeds:
            row["program"] = S.gaps(program(seed, pool_d, pool_i,
                                            lambda m, b: m.serve_forward(b)), ref)
        if seed in fault_seeds:
            for name in faults:
                row[f"fault.{name}"] = S.gaps(program(seed, pool_d, pool_i, F.SERVE[name]), ref)
        if seed in control_seeds:
            for precision in controls:
                ctrl = S.reference_outputs(cell, seed, dev, pool_d, pool_i, frames, padded,
                                           lr_hw, precision=precision)
                kept = [(idx, [ctrl[int(k)] for k in idx])
                        for idx in S.request_order(seed, t["pool"], t["batch"], t["batches"])]
                row[f"control.{precision}"] = S.gaps(kept, ref)
        row["seconds"] = time.perf_counter() - t0
        yield row


def train_readings(cell, seeds, control_seeds, controls, fault_seeds, faults, dev):
    import torch

    from bench_port.drivers import train as T

    for seed in sorted(set(seeds) | set(control_seeds) | set(fault_seeds)):
        t0 = time.perf_counter()
        row = {"seed": seed, "names": list(T.NAMES)}
        got = {}
        if seed in seeds:
            got["program"] = program_steps(cell, seed, dev, torch, T)
        if seed in fault_seeds:
            for name in faults:
                got[f"fault.{name}"] = program_steps(cell, seed, dev, torch, T, F.TRAIN[name])
        ref = T.reference_steps(cell, seed, dev, cell.traffic["checked_steps"])
        if seed in control_seeds:
            for precision in controls:
                got[f"control.{precision}"] = T.reference_steps(
                    cell, seed, dev, cell.traffic["checked_steps"], precision)
        for key, readings in got.items():
            row[key] = list(T.readings(readings, ref))
        row["seconds"] = time.perf_counter() - t0
        del got, ref
        gc.collect()
        torch.cuda.empty_cache() if dev.type == "cuda" else None
        yield row


def program_steps(cell, seed, dev, torch, T, step_fn=None):
    """The program's checked steps, as a run's set-up takes them;
    ``step_fn(model, batch, i)`` replaces the step (a fault)."""
    from bench_port import data as D

    t = cell.traffic
    model, w0 = T.build_model(cell, seed, dev, T.hole_generator(seed, dev), torch)

    def step(m, i):
        batch = D.train_batch(seed, i, t["batch"], T.lr_hw_of(cell), dev)
        if step_fn is not None:
            return step_fn(m, batch, i)
        m.set_input(batch)
        m.optimize_parameters(i + 1)

    out = T.checked_steps(model, step, t["checked_steps"], w0, cell.cfg["adam"]["betas"][0])
    del model, w0
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m bench_port.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--controls", default="fp8")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--out")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch

    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    words = lambda s: [x for x in s.split(",") if x]  # noqa: E731
    cell = H.find_cell(H.benchmark(), args.workload)
    dev = torch.device(args.device)
    readings = serve_readings if cell.traffic["driver"] == "serve" else train_readings
    out = []
    with contextlib.redirect_stdout(sys.stderr):
        for row in readings(cell, ints(args.seeds), ints(args.control_seeds),
                            words(args.controls), ints(args.fault_seeds), words(args.faults), dev):
            out.append(row)
            print(json.dumps(row), file=sys.__stdout__, flush=True)
    keys = sorted({k for r in out for k in r if k == "program" or "." in k})
    for key in keys:
        vals = np.array([r[key] for r in out if key in r], dtype=float)
        print(f"{key} ({len(vals)} seeds) {out[0]['names']}: max {vals.max(0).tolist()} "
              f"median {np.median(vals, 0).tolist()} min {vals.min(0).tolist()}",
              file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
