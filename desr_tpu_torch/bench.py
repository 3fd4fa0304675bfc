"""Benchmark of the port: RGB-D pairs/s on the SR fine-tune train step
(counterpart of the repository's ``bench.py``).

    python -m desr_tpu_torch.bench [--device cpu]

Times ``MainSRModel``'s full train step (forward, every loss, backward and
Adam on Depth_f and Task) in ``bench.py``'s configuration: the flags of
bench.py:62-70 (batch 1, LR crop 512x640 -> HR 1024x1280, ``--lr 2e-5``, the
default bf16 ``--compute_dtype``), seeded random weights (the seed
``chip_smoke.py``'s phase (g) uses), and ``make_batch(1, 512, 640)``, a bit
for bit copy of bench.py:31-45. 12 warm-up steps, then 10 steps timed by the
host clock with the card synchronised at the end (bench.py:89-108); pairs/s
= batch / seconds a step.

Prints exactly one line on stdout:
``{"metric": "sr_train_pairs_per_sec_per_chip", "value": N, "unit": ..., "vs_baseline": N}``,
``vs_baseline`` being ``value`` over the ``value`` of
``desr_tpu_torch/bench_baseline.json`` (1.0 without the file, which the bench
reads and never writes). The options block and the diagnostics go to
stderr: the card's name and power limit, the step's ms by CUDA events, the
peak memory and the TF32 settings, which the bench leaves as the train CLI
does.

It differs from ``bench.py`` on purpose:
- no ``--remat`` retry on an error (bench.py:94-102): the step peaks near
  10 of the card's 80 GB, and a retry would change the measured
  configuration without saying so; any error propagates;
- no ``hbm_util_pct`` and no ``vs_reference_modeled``: the first comes from
  XLA's cost analysis (bench.py:129-138), which the port has no counterpart
  of, the second divides by a byte count XLA took for the TPU program
  (bench.py:112-124);
- one card at batch 1: scale-out is not ported.

Without a card it raises unless ``--device cpu`` is passed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

BASELINE_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bench_baseline.json")
METRIC = "sr_train_pairs_per_sec_per_chip"
UNIT = "RGB-D pairs/sec/chip (512x640 LR -> 1024x1280 HR train step)"
LR_HW = (512, 640)
WARMUP, STEPS = 12, 10
BATCH = 1
WEIGHT_SEED = 9  # chip_smoke.py phase (g)'s


def make_batch(b, ch, cw):
    rng = np.random.default_rng(0)
    h, w = ch * 2, cw * 2
    depth_a = rng.uniform(-0.5, 1, (b, h, w, 1)).astype(np.float32)
    depth_b = rng.uniform(-0.5, 1, (b, h, w, 1)).astype(np.float32)
    depth_b[depth_b < -0.3] = -1.0
    K = np.tile(np.array([[[1154.0, 0, 640], [0, 1154, 480], [0, 0, 1]]], np.float32), (b, 1, 1))
    crop_a = np.tile(np.array([[0, h, 0, w]], np.float32), (b, 1))
    crop_b = np.tile(np.array([[0, ch, 0, cw]], np.float32), (b, 1))
    return {
        "A_i": rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32),
        "B_i": rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32),
        "A_d": depth_a, "B_d": depth_b,
        "K_A": K, "K_B": K.copy(), "crop_A": crop_a, "crop_B": crop_b,
    }


def bench_argv(checkpoints_dir, lr_hw=LR_HW, device="cuda"):
    """bench.py:62-70's flags, with the port's ``--device``."""
    return ["--model_type", "main", "--SR", "--name", "bench_sr",
            "--checkpoints_dir", checkpoints_dir, "--batch_size", str(BATCH),
            "--use_image_for_trans", "--use_masked", "--norm_loss", "--use_smooth_loss",
            "--w_syn_norm", "0.05", "--crop_size_h", str(lr_hw[0]),
            "--crop_size_w", str(lr_hw[1]), "--lr", "2e-5", "--device", str(device)]


def card_and_power_limit():
    """The card as ``nvidia-smi --query-gpu=name,power.limit`` prints it."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]


def run(device="cuda", lr_hw=LR_HW, warmup=WARMUP, steps=STEPS, extra_argv=()):
    """Build the SR model (as ``chip_smoke.py``'s phase (g) does), take
    ``warmup`` steps, then time ``steps``; returns ``pairs_per_sec`` and
    ``step_ms`` (host clock, card synchronised), and on a card ``event_ms``
    (CUDA events over the same steps) and ``peak_gib``. Writes nothing to
    stdout."""
    import torch

    from desr_tpu_torch import resolve_device
    from desr_tpu_torch.models.main_sr_model import MainSRModel
    from desr_tpu_torch.options import train_options

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    with tempfile.TemporaryDirectory(prefix="desr_bench_") as ckpt, \
            contextlib.redirect_stdout(sys.stderr):
        opt = train_options.parse(bench_argv(ckpt, lr_hw, dev.type) + list(extra_argv))
    dtype = torch.float32 if opt.compute_dtype in ("float32", "f32") else torch.bfloat16
    model = MainSRModel(opt, device=dev, compute_dtype=dtype, is_train=True,
                        generator=torch.Generator().manual_seed(WEIGHT_SEED))
    model.set_input(make_batch(BATCH, *lr_hw))

    def sync():
        if cuda:
            torch.cuda.synchronize()

    for i in range(warmup):
        model.optimize_parameters(i + 1)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for i in range(steps):
        model.optimize_parameters(i + 20)
    if cuda:
        end.record()
    sync()
    dt = (time.perf_counter() - t0) / steps
    out = {"pairs_per_sec": BATCH / dt, "step_ms": dt * 1e3, "event_ms": None,
           "peak_gib": None, "losses": {k: float(v) for k, v in model.metrics.items()}}
    if cuda:
        out["event_ms"] = start.elapsed_time(end) / steps
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def result_line(res):
    """The one stdout line: bench.py's four keys."""
    vs_baseline = 1.0
    if os.path.exists(BASELINE_FILE):
        with open(BASELINE_FILE) as f:
            vs_baseline = res["pairs_per_sec"] / json.load(f)["value"]
    return {"metric": METRIC, "value": round(res["pairs_per_sec"], 4), "unit": UNIT,
            "vs_baseline": round(vs_baseline, 4)}


def main(argv=None):
    import torch

    p = argparse.ArgumentParser(prog="python -m desr_tpu_torch.bench")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; without a GPU, cpu must be asked for")
    args = p.parse_args(argv)
    res = run(args.device)
    if res["event_ms"] is not None:
        print(f"# card: {card_and_power_limit()}", file=sys.stderr)
        print(f"# step {res['step_ms']:.2f} ms by the host clock, {res['event_ms']:.2f} ms by "
              f"CUDA events, over {STEPS} steps after {WARMUP}; peak "
              f"{res['peak_gib']:.2f} GiB", file=sys.stderr)
        print(f"# TF32: torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}, "
              f"torch.backends.cuda.matmul.allow_tf32 = "
              f"{torch.backends.cuda.matmul.allow_tf32}", file=sys.stderr)
    else:
        print(f"# device {args.device}: step {res['step_ms']:.2f} ms by the host clock",
              file=sys.stderr)
    print(json.dumps(result_line(res)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
