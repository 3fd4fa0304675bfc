#!/usr/bin/env python3
"""Smoke run of the PyTorch port (desr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit when it fails:

(a) card and build: prints the card's name and power limit as nvidia-smi gives
    them, builds the CUDA kernels from desr_tpu_torch/csrc with nvcc (sm_90a),
    one nvcc per source, all started together.
(b) kernels: the conv3x3 kernel in each variant of the serving path (K1 =
    conv3x3_fused: stats only, normalise+ReLU+stats, normalise only; K2 =
    conv3x3), for reflect, replicate and zeros borders, in float32 and bf16, at
    the serving shape (B=8, 128x160x128 NHWC), and K1 in the translator's two
    variants (stats only, normalise+ReLU+stats; replicate borders) at its train
    step shape (B=6, 128x160x256), held against the plain PyTorch version on
    the card with TF32 off (torch.backends.cudnn.allow_tf32 and
    torch.backends.cuda.matmul.allow_tf32 are set False for the whole run);
    then the bf16 body at the edges of its tiling (C_in and C_out off its
    64-channel chunk and N tile, 16 -> 16, W off its 16-pixel tile, H = W = 2
    with reflect, C_out = 300 over two N tiles), every K1 variant and K2 in
    all three borders; two launches of K1 must give the same bits.
(c) serving: 16 synthetic 480x640 RGB-D frames and seeded random .pth files at
    the default full widths; ``desr_tpu_torch.predict.main`` serves them in
    bf16 as two requests of 8 frames, then once more with the ResnetBlock
    convs routed through K2 (``--net_args --pallas_conv``). Checks the PNGs,
    the launch counters (24 per batch), and one batch's ``serve_forward``
    against the same model with the kernel swapped for its plain version.
(b') K3 = masked_loss_sums, at the train step's shape (6, 512, 640) and a
    ragged (3, 37, 41), float32 and bf16 pred/target, binary masks, against
    its plain version; two launches must give the same bits.
(e) training: 12 synthetic 480x640 RGB-D frames per domain with their
    intrinsics and seeded random .pth files for all five nets at full width;
    ``desr_tpu_torch.train.main`` trains on them with the README stage-3 flags
    (--no_aug --continue_train --batch_size 6, bf16) for one epoch of 2 steps.
    Checks the launch counters (K1 42 and K3 2 per step), finite losses, the
    frozen nets' weights unchanged and the trained ones moved; at model level
    G falls over 4 steps on one batch; at float32 (batch 2, 256x384) one step
    through the kernels against the same step through their plain versions
    (loss terms, and gradients against the plain route's own sensitivity);
    then times the bf16 step (CUDA events) and profiles it.
(d) prints one {"kernels": [...]} line with each kernel's launches on the
    serving and train paths, error, time, the plain version's and the library
    call's times, its bound on this card and the share of it reached
    (bound_share), and for K1/K2 the rate (tflops); K1 has a row at the
    serving shape and one at the translator's.

The last line is {"ok": true, "device": {"platform": "gpu", ...}}. Without a
CUDA device, or without the rest of the repository beside it, the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16 = 989e12   # dense bf16 tensor-core FLOP/s, H100 SXM data sheet
PEAK_HBM = 3.35e12   # bytes/s, H100 SXM data sheet
SERVE_SHAPE = (8, 128, 160, 128)  # the ResnetBlocks' NHWC input at 480x640 (padded 512x640), batch 8
LAUNCHES_PER_BATCH = 24           # 12 ResnetBlocks x 2 convs (I2D_features + Depth_f)
LOSS_SHAPE = (6, 512, 640)        # K3's input at the train step: batch 6, 480x640 padded
TRANS_SHAPE = (6, 128, 160, 256)  # G_A_d's ResnetBlockT input at the train step (NHWC)
K1_PER_STEP = 42                  # I2D_features 12 + Depth_f 12 (batch 2B) + G_A_d 18 (9 blocks)
K1_TRANS_PER_STEP = 18            # of those, G_A_d's: at TRANS_SHAPE, replicate borders
K3_PER_STEP = 2                   # the syn and real (task, holes, holes_l2) triplets
PEAK_F32 = 67e12                  # f32 FLOP/s outside the tensor cores, H100 SXM data sheet


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() in ms, over ``iters`` calls after ``warmup``."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, key, iters=20, warmup=3, flush_l2=True):
    """Device time of one call of fn in ms over ``iters`` calls after
    ``warmup`` (torch.profiler): for each kernel whose name holds ``key``
    (each runs once a call) the median, least and most of its traced
    durations, summed over those kernels; None when none was traced. The
    profiler can miss kernels at the start of its window, so a total over
    the calls would undercount. With ``flush_l2``, a read and write of
    256 MiB before each call evicts the 50 MB L2, so the inputs come from HBM
    as the bound assumes."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    flush = torch.zeros(2 ** 26, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush_l2:
                flush.add_(1.0)
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and key in ev.name:
            by_name.setdefault(ev.name, []).append(ev.time_range.elapsed_us() / 1e3)
    if not by_name:
        return None
    traced = sum(len(v) for v in by_name.values())
    return {"median": sum(statistics.median(v) for v in by_name.values()),
            "min": sum(min(v) for v in by_name.values()),
            "max": sum(max(v) for v in by_name.values()),
            "traced": f"{traced}/{len(by_name) * iters}"}


# ------------------------------------------------------------------ (a)

def phase_card_and_build():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card)
    from desr_tpu_torch.ops import _build

    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    names = ("conv3x3", "masked_loss")
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc process per source
        paths = list(pool.map(lambda n: _build.build(n, verbose=True), names))
    print(f"[a] built {', '.join(os.path.relpath(p, ROOT) for p in paths)} "
          f"in {time.perf_counter() - t0:.1f} s")
    return card


# ------------------------------------------------------------------ (b)

# the bf16 body's tile edges: (NHWC shape, C_out)
EDGE_CASES = (((2, 21, 37, 72), 80), ((2, 30, 37, 16), 16), ((2, 2, 2, 64), 64),
              ((2, 17, 40, 128), 128), ((1, 9, 20, 256), 300))


def _inputs(dtype, seed=0, shape=SERVE_SHAPE, cout=None):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    b, h, w, c = shape
    x = torch.randn(shape, generator=g, device="cuda").to(dtype)
    wt = 0.03 * torch.randn((cout or c, c, 3, 3), generator=g, device="cuda")
    scale = 0.5 + 1.5 * torch.rand((b, c), generator=g, device="cuda")
    shift = torch.randn((b, c), generator=g, device="cuda")
    return x, wt, scale, shift


def _compare(name, got, want, dtype, n_pix):
    """Max |kernel - plain| of out (and s, s2), each within its stated bound.

    out: float32 |d| <= 1e-3 + 1e-4 |p| (f32 summation order over 1152
         terms, 2304 at the translator's width);
         bf16 |d| <= 1e-3 + 2^-7 |p| (the same f32 sum, up to order, rounded
         to bf16: at most one bf16 step apart).
    s2:  |d| <= 1e-4 s2; s: |d| <= 1e-4 sqrt(n s2) (>= 1e-4 sum|out|):
         f32 summation order over n pixels.
    """
    import torch

    g, p = got[0].float(), want[0].float()
    rtol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    err = (g - p).abs()
    check(bool(torch.isfinite(g).all()), f"{name}: non-finite kernel output")
    check(bool((err <= 1e-3 + rtol * p.abs()).all()),
          f"{name}: out off by {float(err.max()):.3g} (rtol {rtol:.3g})")
    line = f"[b] {name}: max|d out| {float(err.max()):.3g}"
    if len(got) == 3:
        (s, s2), (ps, ps2) = got[1:], want[1:]
        ds, ds2 = (s - ps).abs(), (s2 - ps2).abs()
        check(bool((ds2 <= 1e-4 * ps2).all()), f"{name}: s2 off by {float(ds2.max()):.3g}")
        check(bool((ds <= 1e-4 * (n_pix * ps2).sqrt()).all()), f"{name}: s off by {float(ds.max()):.3g}")
        line += f", max|d s| {float(ds.max()):.3g}, max rel|d s2| {float((ds2 / ps2).max()):.3g}"
    print(line)
    return float(err.max())


K1_VARIANTS = (("stats", False, False, True),  # name, prologue, relu, stats
               ("norm+relu+stats", True, True, True),
               ("norm", True, False, False))


def phase_kernels():
    """K1/K2 against the plain version; returns the worst bf16 max |d| of
    each kernel at the serving shape and of K1 at the translator's (the edge
    cases are checked, not reported)."""
    import torch

    from desr_tpu_torch.ops import conv3x3 as K

    worst = {"K1": 0.0, "K2": 0.0, "K1 translator": 0.0}
    # the serving path's variants and borders; the translator's ResnetBlockT
    # (G_A_d on the train path) runs stats, then norm+relu+stats, replicate
    for tag, shape, modes, variants in (
            ("", SERVE_SHAPE, ("reflect", "replicate", "zeros"), K1_VARIANTS),
            (" translator", TRANS_SHAPE, ("replicate",), K1_VARIANTS[:2])):
        n_pix = shape[1] * shape[2]
        for dtype in (torch.float32, torch.bfloat16):
            x, w, scale, shift = _inputs(dtype, shape=shape)
            dt = str(dtype)[6:]
            for mode in modes:
                for variant, prologue, relu, stats in variants:
                    sc, sh = (scale, shift) if prologue else (None, None)
                    got = K.conv3x3_fused(x, w, sc, sh, mode, relu, stats)
                    want = K.conv3x3_fused_plain(x, w, sc, sh, mode, relu, stats)
                    got, want = (got, want) if stats else ((got,), (want,))
                    e = _compare(f"K1{tag} {variant} {mode} {dt}", got, want, dtype, n_pix)
                    if dtype == torch.bfloat16:
                        worst["K1" + tag] = max(worst["K1" + tag], e)
                if tag:
                    continue
                got = K.conv3x3(x, w, mode)
                want = K.conv3x3_fused_plain(x, w, pad_mode=mode)
                e = _compare(f"K2 {mode} {dt}", (got,), (want,), dtype, n_pix)
                if dtype == torch.bfloat16:
                    worst["K2"] = max(worst["K2"], e)
            if dtype == torch.bfloat16:
                a = K.conv3x3_fused(x, w, scale, shift, modes[0], True, True)
                again = K.conv3x3_fused(x, w, scale, shift, modes[0], True, True)
                check(all(torch.equal(u, v) for u, v in zip(a, again)),
                      f"K1{tag} bf16: two launches differ")
                print(f"[b] K1{tag} bf16 norm+relu+stats {modes[0]}: two launches bit-equal")
            del x, w, scale, shift
            torch.cuda.synchronize()
    for shape, cout in EDGE_CASES:
        x, w, scale, shift = _inputs(torch.bfloat16, seed=3, shape=shape, cout=cout)
        n_pix = shape[1] * shape[2]
        name = f"{'x'.join(map(str, shape))}->{cout}"
        for mode in ("reflect", "replicate", "zeros"):
            for variant, prologue, relu, stats in K1_VARIANTS:
                sc, sh = (scale, shift) if prologue else (None, None)
                got = K.conv3x3_fused(x, w, sc, sh, mode, relu, stats)
                want = K.conv3x3_fused_plain(x, w, sc, sh, mode, relu, stats)
                got, want = (got, want) if stats else ((got,), (want,))
                _compare(f"K1 edge {name} {variant} {mode} bfloat16", got, want,
                         torch.bfloat16, n_pix)
            _compare(f"K2 edge {name} {mode} bfloat16", (K.conv3x3(x, w, mode),),
                     (K.conv3x3_fused_plain(x, w, pad_mode=mode),), torch.bfloat16, n_pix)
        del x, w, scale, shift
    torch.cuda.synchronize()
    return worst


# ------------------------------------------------------------------ (b')

def _loss_inputs(shape, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    p = torch.randn(shape, generator=g, device="cuda").to(dtype)
    t = torch.randn(shape, generator=g, device="cuda").to(dtype)
    m1 = (torch.rand(shape, generator=g, device="cuda") > 0.3).float()
    m2 = (torch.rand(shape, generator=g, device="cuda") > 0.6).float()
    return p, t, m1, m2


def phase_masked_loss():
    """K3 against its plain version. Each of the three sums has only terms
    >= 0, so f32 summation order bounds |kernel - plain| <= 1e-5 * sum
    (+1e-6 for a sum of 0)."""
    import torch

    from desr_tpu_torch.ops import masked_loss as K3

    worst = 0.0
    for shape in (LOSS_SHAPE, (3, 37, 41)):
        for dtype in (torch.float32, torch.bfloat16):
            ins = _loss_inputs(shape, dtype, seed=sum(shape))
            got = torch.stack(K3.masked_loss_sums(*ins))
            again = torch.stack(K3.masked_loss_sums(*ins))
            want = K3.masked_loss_sums_plain(*ins)
            err = (got - want).abs()
            name = f"K3 {'x'.join(map(str, shape))} {str(dtype)[6:]}"
            check(bool(torch.isfinite(got).all()), f"{name}: non-finite sums")
            check(bool((err <= 1e-5 * want.abs() + 1e-6).all()),
                  f"{name}: sums {got.tolist()} vs plain {want.tolist()}")
            check(torch.equal(got, again), f"{name}: two launches differ")
            print(f"[b'] {name}: max |d| {float(err.max()):.3g}, max rel "
                  f"{float((err / want.abs().clamp_min(1e-30)).max()):.3g} (bound 1e-5); "
                  "two launches bit-equal")
            if shape == LOSS_SHAPE and dtype == torch.float32:
                worst = float(err.max())
    torch.cuda.synchronize()
    return worst


# ------------------------------------------------------------------ (c)

def _write_frames(folder, n, seed=0):
    """n seeded 480x640 frames: smooth RGB with noise, uint16 mm depth with holes."""
    import numpy as np

    from desr_tpu_torch.data.png import write_png

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:480, 0:640].astype(np.float32)
    for sub in ("depth", "img"):
        os.makedirs(os.path.join(folder, sub), exist_ok=True)
    for i in range(n):
        a, b, c = rng.uniform(0.005, 0.03, 3)
        img = np.stack([np.sin(a * xx + i), np.cos(b * yy), np.sin(c * (xx + yy))], -1)
        img = 127.5 + 100 * img + rng.normal(0, 10, img.shape)
        depth = 1500 + 1000 * np.sin(a * xx) * np.cos(b * yy) + 0.5 * yy
        depth += rng.normal(0, 20, depth.shape)
        depth[rng.random(depth.shape) < 0.05] = 0           # speckle holes
        y0, x0 = rng.integers(0, 400), rng.integers(0, 560)
        depth[y0:y0 + 60, x0:x0 + 80] = 0                   # one block hole
        write_png(os.path.join(folder, "img", f"f{i:02d}.png"), img.clip(0, 255).astype(np.uint8))
        write_png(os.path.join(folder, "depth", f"f{i:02d}.png"),
                  depth.clip(0, 65535).astype(np.uint16))


def _read_outputs(folder, n):
    import numpy as np

    from desr_tpu_torch.data.png import read_png

    files = sorted(os.listdir(folder))
    check(len(files) == n, f"{folder}: {len(files)} PNGs, want {n}")
    arrs = [read_png(os.path.join(folder, f)) for f in files]
    for f, a in zip(files, arrs):
        check(a.dtype == np.uint16 and a.shape == (480, 640), f"{f}: {a.dtype} {a.shape}")
    return np.stack(arrs).astype(np.int64)


def phase_serving(tmp):
    import numpy as np
    import torch

    from desr_tpu_torch import checkpoints as ckpt
    from desr_tpu_torch import predict
    from desr_tpu_torch.models.main_model import NET_NAMES, MainModel, NetOptions
    from desr_tpu_torch.ops import conv3x3 as K

    # two requests of 8 frames; seeded random weights at the default widths
    for r in range(2):
        _write_frames(os.path.join(tmp, f"req{r}"), 8, seed=r)
    model = MainModel(NetOptions(), device="cuda", generator=torch.Generator().manual_seed(1))
    for name in NET_NAMES:
        ckpt.save_net(model.nets[name], ckpt.net_ckpt_path(tmp, "smoke", "latest", name))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[c] {n_params} parameters over {len(NET_NAMES)} nets at the default widths")

    def serve(req, out, extra=()):
        argv = ["--name", "smoke", "--checkpoints_dir", tmp,
                "--input_depth", os.path.join(tmp, req, "depth"),
                "--input_img", os.path.join(tmp, req, "img"), "--output", out,
                "--batch_size", "8", "--compute_dtype", "bfloat16", *extra]
        K.conv3x3_fused.launches = K.conv3x3.launches = 0
        t0 = time.perf_counter()
        predict.main(argv)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, K.conv3x3_fused.launches, K.conv3x3.launches

    launches = {"K1": 0, "K2": 0}
    outs = []
    for r in range(2):
        out = os.path.join(tmp, f"out{r}")
        wall, k1, k2 = serve(f"req{r}", out)
        check(k1 == LAUNCHES_PER_BATCH and k2 == 0,
              f"request {r}: K1 launched {k1} times, K2 {k2}; want {LAUNCHES_PER_BATCH} and 0")
        launches["K1"] += k1
        outs.append(_read_outputs(out, 8))
        print(f"[c] request {r}: 8 frames through predict.main in {wall:.2f} s host wall "
              f"(model build + .pth load + PNG I/O included), K1 launches {k1}")
    wall, k1, k2 = serve("req0", os.path.join(tmp, "out0_k2"), ["--net_args", "--pallas_conv"])
    check(k2 == LAUNCHES_PER_BATCH and k1 == 0,
          f"--pallas_conv request: K2 launched {k2} times, K1 {k1}; want {LAUNCHES_PER_BATCH} and 0")
    launches["K2"] += k2
    d_mm = np.abs(_read_outputs(os.path.join(tmp, "out0_k2"), 8) - outs[0])
    # the two routes round to bf16 at different points; they are held to
    # each other in float32 below
    print(f"[c] --pallas_conv request: K2 launches {k2}; bf16 PNGs vs the fused route: "
          f"max |d| {int(d_mm.max())} mm, mean {float(d_mm.mean()):.3f} mm")
    check(all(int(o.max()) > 0 for o in outs), "an output is all zeros")

    # one batch at model level: counts, finiteness, kernel vs plain, timing
    frames = [predict.decode_frame(os.path.join(tmp, "req0", "depth", f"f{i:02d}.png"),
                                   os.path.join(tmp, "req0", "img", f"f{i:02d}.png"), 5100.0)
              for i in range(8)]
    batch = {"B_d": np.stack([f[0] for f in frames]), "B_i": np.stack([f[1] for f in frames])}
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    K.conv3x3_fused.launches = 0
    pred = model.serve_forward(batch)
    check(K.conv3x3_fused.launches == LAUNCHES_PER_BATCH,
          f"serve_forward: {K.conv3x3_fused.launches} K1 launches")
    check(tuple(pred.shape) == (8, 512, 640) and bool(torch.isfinite(pred).all()),
          f"serve_forward: shape {tuple(pred.shape)} or non-finite values")
    report = {}

    def forward(dtype, plain=False, fused=True):
        model.compute_dtype = dtype
        blocks = [m for m in model.modules() if hasattr(m, "fused")]
        for m in blocks:
            m.fused = fused
        try:
            if plain:
                with mock.patch.object(K, "conv3x3_fused", K.conv3x3_fused_plain), \
                        mock.patch.object(K, "conv3x3", K.conv3x3_fused_plain):
                    return model.serve_forward(batch)
            return model.serve_forward(batch)
        finally:
            for m in blocks:
                m.fused = True

    def mean_max(a, b):
        d = (a - b).abs()
        return float(d.mean()), float(d.max())

    # float32: the kernels differ from the plain convs by summation order
    # only, and the K2 route from the fused one by where the bias and the
    # norm are applied: max |d| <= 1e-3 on the tanh output in [-1, 1]
    ref32 = forward(torch.float32, plain=True)
    for label, out in (("kernel (K1)", forward(torch.float32)),
                       ("K2 route", forward(torch.float32, fused=False))):
        mean, mx = mean_max(out, ref32)
        print(f"[c] serve_forward float32 {label} vs plain convs: mean |d| {mean:.3g}, "
              f"max |d| {mx:.3g} (bound 1e-3)")
        check(mx <= 1e-3, f"serve_forward float32 {label}: max |d| {mx:.3g} > 1e-3")
        report[f"f32_{label.split()[0]}_max_abs_diff"] = mx
    # bf16: the kernel must sit as close to the float32 result as the plain
    # bf16 convs do (bf16 error itself sets the scale): within 1.5x
    noise, _ = mean_max(forward(torch.bfloat16, plain=True), ref32)
    for label, out in (("kernel (K1)", forward(torch.bfloat16)),
                       ("K2 route", forward(torch.bfloat16, fused=False))):
        mean, mx = mean_max(out, ref32)
        print(f"[c] serve_forward bfloat16 {label} vs float32 plain: mean |d| {mean:.3g}, "
              f"max |d| {mx:.3g}; plain bf16 convs: mean |d| {noise:.3g} (bound 1.5x)")
        check(mean <= 1.5 * noise, f"serve_forward bf16 {label}: mean |d| {mean:.3g} > 1.5 x {noise:.3g}")
        report[f"bf16_{label.split()[0]}_mean_abs_diff"] = mean
    report["bf16_plain_mean_abs_diff"] = noise
    model.compute_dtype = torch.bfloat16
    ms = cuda_ms(lambda: model.serve_forward(batch), iters=5, warmup=2)
    report["serve_ms_per_batch8"] = ms
    report["serve_frames_per_s"] = 8000.0 / ms
    # where the device time goes: each net alone on this batch's inputs (the
    # model's parameters need no grad, so no autograd graph is built here)
    nets = model.nets
    dt = torch.bfloat16
    img = batch["B_i"].to(dt).permute(0, 3, 1, 2)
    feats = nets["I2D_features"](img)
    pair = torch.cat([batch["B_d"].permute(0, 3, 1, 2), nets["Image2Depth"](feats)], 1).to(dt)
    pair = pair.contiguous(memory_format=torch.channels_last)
    task_in = torch.cat([feats, nets["Depth_f"](pair), pair, img], 1)
    for name, fn in (("I2D_features", lambda: nets["I2D_features"](img)),
                     ("Image2Depth", lambda: nets["Image2Depth"](feats)),
                     ("Depth_f", lambda: nets["Depth_f"](pair)),
                     ("Task", lambda: nets["Task"](task_in))):
        report[f"net_ms_{name}"] = cuda_ms(fn, iters=5, warmup=1)
    print(f"[c] serve_forward bf16 batch 8 (512x640): {ms:.2f} ms per batch, "
          f"{report['serve_frames_per_s']:.1f} frames/s (CUDA events, after warm-up); per net ms: "
          + ", ".join(f"{k[7:]} {v:.2f}" for k, v in report.items() if k.startswith("net_ms_")))
    report.update(_profile(lambda: model.serve_forward(batch), iters=3))
    print("[c] " + json.dumps(report))
    return launches


def _profile(fn, iters, tag="c", unit="batch"):
    """Device time by kernel over ``iters`` calls of fn (torch.profiler), and
    the device's busy share of the window's host wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
    device_ms = sum(by_kernel.values())
    if device_ms == 0:
        print(f"[{tag}] profile: the profiler traced no device time; busy share not measured")
        return {f"profile_device_ms_per_{unit}": None}
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    print(f"[{tag}] profile over {iters} {unit}s: device busy {device_ms / iters:.2f} ms per "
          f"{unit}, {100 * device_ms / wall_ms:.1f}% of the host wall time; top kernels "
          f"(ms per {unit}):")
    for name, t in top:
        print(f"[{tag}]   {t / iters:8.3f}  {name[:110]}")
    out = {f"profile_device_ms_per_{unit}": device_ms / iters,
           "profile_busy_share": device_ms / wall_ms}
    for short, key in (("conv3x3", "conv3x3"), ("masked_loss", "masked_loss")):
        out[f"profile_{short}_ms_per_{unit}"] = sum(
            t for n, t in by_kernel.items() if key in n) / iters
    return out


# ------------------------------------------------------------------ (e)

def _write_train_domain(root, dom, seed):
    """12 frames of phase (c)'s kind, each its own scene with intrinsics."""
    import numpy as np

    folder = os.path.join(root, dom)
    _write_frames(folder, 12, seed=seed)
    for i in range(12):
        kdir = os.path.join(root, "intr", f"{dom}{i:02d}", "intrinsic")
        os.makedirs(kdir, exist_ok=True)
        np.savetxt(os.path.join(kdir, "intrinsic_depth.txt"),
                   [[577.87, 0, 319.5, 0], [0, 577.87, 239.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    # the dataset takes a frame's scene from its name: A00.png -> A00
    for sub in ("depth", "img"):
        for f in os.listdir(os.path.join(folder, sub)):
            os.rename(os.path.join(folder, sub, f), os.path.join(folder, sub, dom + f[1:]))
    return folder


def _train_argv(tmp, name, extra=()):
    a, b = os.path.join(tmp, "A"), os.path.join(tmp, "B")
    return ["--model_type", "main", "--name", name, "--checkpoints_dir", tmp,
            # the README's stage-3 flags (README.md:103-104)
            "--do_train", "--continue_train", "--use_image_for_trans", "--use_masked",
            "--norm_loss", "--use_smooth_loss", "--batch_size", "6",
            "--no_aug", "--compute_dtype", "bfloat16", "--image_and_depth", "--use_scannet",
            "--path_A", f"{a}/depth", "--A_add_paths", f"{a}/img",
            "--path_B", f"{b}/depth", "--B_add_paths", f"{b}/img",
            "--path_to_intr", os.path.join(tmp, "intr"), "--n_epochs", "1",
            "--n_epochs_decay", "0", "--print_freq", "6", "--save_epoch_freq", "1",
            "--num_threads", "0", *extra]


def _state(model, names):
    return {n: {k: v.detach().clone() for k, v in model.nets[n].state_dict().items()}
            for n in names}


def phase_training(tmp):
    import numpy as np
    import torch

    from desr_tpu_torch import checkpoints as ckpt
    from desr_tpu_torch import train
    from desr_tpu_torch.data.loader import create_dataset
    from desr_tpu_torch.data.main_dataset import MainDataset
    from desr_tpu_torch.models.main_model import MainModel
    from desr_tpu_torch.ops import conv3x3 as K
    from desr_tpu_torch.ops import masked_loss as K3
    from desr_tpu_torch.options import train_options

    report = {}
    _write_train_domain(tmp, "A", seed=10)
    _write_train_domain(tmp, "B", seed=20)
    argv = _train_argv(tmp, "train")
    opt = train_options.parse(argv, print_options=False)
    model = MainModel(opt, device="cuda", compute_dtype=torch.bfloat16, is_train=True,
                      generator=torch.Generator().manual_seed(7))
    for n in model.model_names:
        ckpt.save_net(model.nets[n], ckpt.net_ckpt_path(tmp, "train", "latest", n))
    before = _state(model, model.model_names)
    print(f"[e] {sum(p.numel() for p in model.parameters())} parameters over 5 nets at full "
          f"width; trainable: {sum(p.numel() for p in model.parameters() if p.requires_grad)}")

    # the CLI, in-process: 12 pairs at batch 6 = 2 steps
    K.conv3x3_fused.launches = K.conv3x3.launches = K3.masked_loss_sums.launches = 0
    t0 = time.perf_counter()
    losses = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": K.conv3x3_fused.launches, "K2": K.conv3x3.launches,
                "K3": K3.masked_loss_sums.launches}
    check(launches == {"K1": 2 * K1_PER_STEP, "K2": 0, "K3": 2 * K3_PER_STEP},
          f"train.main: launches {launches}; want K1 {2 * K1_PER_STEP}, K2 0, "
          f"K3 {2 * K3_PER_STEP} over 2 steps")
    check(set(model.loss_names) <= set(losses) and all(np.isfinite(list(losses.values()))),
          f"train.main losses: {losses}")
    print(f"[e] train.main: 2 steps of batch 6 in {wall:.1f} s host wall (model build, .pth "
          f"load, PNG decode, checkpoint writes included); launches {launches}; losses "
          + ", ".join(f"{k} {v:.4g}" for k, v in losses.items()))
    trained = MainModel(opt, device="cuda", is_train=True)
    trained.load_networks(tmp, "train", "latest", verbose=False)
    after = _state(trained, model.model_names)
    for n in model.model_names:
        same = all(torch.equal(after[n][k], before[n][k]) for k in before[n])
        check(same == (n not in model.trainable_nets),
              f"{n}: weights {'unchanged' if same else 'changed'} after training")
    print("[e] after train.main: G_A_d, I2D_features, Image2Depth bit-equal to their .pth "
          "files; Depth_f and Task moved")
    del trained

    # model level on one batch of the folder: G falls, launches per step, and
    # of K1's the translator's (read from the counter around G_A_d's forward)
    batch = next(iter(create_dataset(opt, MainDataset)))
    model.set_input(batch)
    in_gad = {"start": 0, "n": 0}
    gad = model.nets["G_A_d"]
    hooks = (gad.register_forward_pre_hook(
                 lambda m, i: in_gad.update(start=K.conv3x3_fused.launches)),
             gad.register_forward_hook(
                 lambda m, i, o: in_gad.update(n=K.conv3x3_fused.launches - in_gad["start"])))
    g = []
    for _ in range(4):
        K.conv3x3_fused.launches = K3.masked_loss_sums.launches = 0
        model.optimize_parameters()
        g.append(float(model.metrics["G"]))
        check((K.conv3x3_fused.launches, K3.masked_loss_sums.launches, in_gad["n"])
              == (K1_PER_STEP, K3_PER_STEP, K1_TRANS_PER_STEP),
              f"step: K1 {K.conv3x3_fused.launches} ({in_gad['n']} in G_A_d), "
              f"K3 {K3.masked_loss_sums.launches}")
    for h in hooks:
        h.remove()
    check(all(np.isfinite(g)) and g[-1] < g[0], f"G over 4 steps on one batch: {g}")
    print(f"[e] G over 4 bf16 steps on one batch: {', '.join(f'{v:.5g}' for v in g)}; "
          f"K1 {K1_PER_STEP} launches a step, {K1_TRANS_PER_STEP} of them in G_A_d")

    report.update(_train_parity(opt, batch))

    # time: bf16 step, batch 6 at 512x640, after warm-up
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(model.optimize_parameters, iters=10, warmup=3)
    report["train_step_ms"] = ms
    report["train_pairs_per_s"] = 6000.0 / ms
    report["train_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    ms_fwd = cuda_ms(lambda: model.losses(model.forward_all(model._batch, True), model._batch),
                     iters=3, warmup=1)
    report["train_forward_and_losses_ms"] = ms_fwd
    print(f"[e] train step bf16, batch 6 at 512x640: {ms:.2f} ms per step, "
          f"{report['train_pairs_per_s']:.2f} pairs/s (CUDA events, 10 steps after 3); "
          f"forward + losses alone {ms_fwd:.2f} ms; peak memory "
          f"{report['train_peak_mem_gib']:.2f} GiB")
    report.update(_profile(model.optimize_parameters, iters=3, tag="e", unit="step"))
    print("[e] " + json.dumps(report))
    return launches


def _train_parity(opt, batch):
    """Float32 at batch 2, 256x384, TF32 off: one step through the kernels
    against the same step with both kernels swapped for their plain versions.

    Loss terms within 1e-4 relative. The step's gradients are ill-conditioned
    at a random init (on the CPU a 1e-7 relative perturbation of K1's outputs
    moves some weight gradients by 2e-3 of their largest entry), so the
    yardstick is the plain route's own sensitivity: the plain step again
    with K1's outputs and moments perturbed by 1e-6 relative noise, the scale
    of the kernels' f32 summation-order differences. Per weight tensor, the
    kernel route's gap to the plain route (relative L2) must be at most
    max(1e-3, 3x that perturbation's gap). Conv biases that feed a norm have
    an exact gradient of 0 (the norm subtracts them again): each bias's gap
    is held to 1e-3 of its net's largest weight gradient, L2 over the tensor.
    """
    from types import SimpleNamespace

    import numpy as np
    import torch

    from desr_tpu_torch.models.main_model import MainModel
    from desr_tpu_torch.ops import conv3x3 as K
    from desr_tpu_torch.ops import masked_loss as K3

    opt32 = SimpleNamespace(**{**vars(opt), "batch_size": 2})
    model = MainModel(opt32, device="cuda", compute_dtype=torch.float32, is_train=True,
                      generator=torch.Generator().manual_seed(8))
    # the U-Nets take multiples of 128: 256x384 of the 512x640 batch
    small = {k: v[:2, :256, :384] if k[0] in "AB" else v[:2] for k, v in batch.items()
             if not k.endswith("paths")}
    small["crop_A"] = small["crop_B"] = np.array([[0, 256, 0, 384]] * 2, np.float32)
    model.set_input(small)

    def step():
        model.hole_generator.manual_seed(11)
        m = model.compute_grads()
        return m, {f"{n}.{k}": p.grad.clone() for n in model.trainable_nets
                   for k, p in model.nets[n].named_parameters()}

    def plain_conv(x, w, sc, sh, pad_mode, relu, stats):
        return K.conv3x3_fused_plain(x, w, sc, sh, pad_mode, relu, stats)

    noise = torch.Generator(device="cuda").manual_seed(12)

    def noisy_conv(*args):
        res = plain_conv(*args)
        res = res if isinstance(res, tuple) else (res,)
        res = tuple(t * (1 + 1e-6 * torch.randn(t.shape, generator=noise, device="cuda"))
                    for t in res)
        return res if len(res) > 1 else res[0]

    m_k, g_k = step()
    with mock.patch.object(K3, "_forward", K3.masked_loss_sums_plain):
        with mock.patch.object(K, "_fused_forward", plain_conv):
            m_p, g_p = step()
        with mock.patch.object(K, "_fused_forward", noisy_conv):
            _, g_n = step()
    worst_loss = max(float((m_k[k] - m_p[k]).abs() / (m_p[k].abs() + 1e-12)) for k in m_p)
    check(all(float((m_k[k] - m_p[k]).abs()) <= 1e-4 * float(m_p[k].abs()) + 1e-7 for k in m_p),
          f"float32 step: a loss term off by {worst_loss:.3g} relative (bound 1e-4)")
    net_scale = {n: max(float(g.norm()) for k, g in g_p.items()
                        if k.startswith(n + ".") and not k.endswith("bias"))
                 for n in model.trainable_nets}
    gaps, bad = {}, []
    for k in g_p:
        scale = net_scale[k.split(".")[0]] if k.endswith("bias") else float(g_p[k].norm())
        gk = float((g_k[k] - g_p[k]).norm()) / scale
        gn = float((g_n[k] - g_p[k]).norm()) / scale
        bound = 1e-3 if k.endswith("bias") else max(1e-3, 3 * gn)
        gaps[k] = (gk, gn, bound)
        if gk > bound:
            bad.append(k)
    weights = sorted((v[0], v[1], k) for k, v in gaps.items() if not k.endswith("bias"))
    print(f"[e] float32 batch 2 at 256x384, kernels vs plain: loss terms max rel "
          f"{worst_loss:.3g} (bound 1e-4); weight grads, relative L2 gap (kernel / 1e-6 "
          f"perturbation): median {weights[len(weights) // 2][0]:.3g} / "
          f"{weights[len(weights) // 2][1]:.3g}, worst {weights[-1][0]:.3g} / "
          f"{weights[-1][1]:.3g} at {weights[-1][2]}; biases worst "
          f"{max(v[0] for k, v in gaps.items() if k.endswith('bias')):.3g} of the net's "
          "largest weight gradient (bound 1e-3)")
    for gk, gn, k in weights[-5:]:
        print(f"[e]   {k}: kernel {gk:.3g}, perturbation {gn:.3g}")
    check(not bad, "float32 step: grads off in "
          + ", ".join(f"{k} ({gaps[k][0]:.3g} > {gaps[k][2]:.3g})" for k in bad[:5]))
    return {"f32_loss_max_rel": worst_loss, "f32_weight_grad_worst_gap": weights[-1][0],
            "f32_weight_grad_median_gap": weights[len(weights) // 2][0],
            "f32_weight_grad_worst_perturbation_gap": max(w[1] for w in weights)}


# ------------------------------------------------------------------ (d)

def phase_report(serve_launches, train_launches, worst, k3_err):
    """One row per kernel and shape (K1 has two); ``launches`` counts the
    serving and train paths' runs together (K2 runs only on the serving
    --pallas_conv route), with each path's count beside it."""
    import torch
    import torch.nn.functional as F

    from desr_tpu_torch.ops import conv3x3 as K
    from desr_tpu_torch.ops import masked_loss as K3

    rows = []
    # K1 and K2 at the serving shape (reflect), K1 at the translator's
    # (replicate): the main path's two shapes of K1, each with its own bound
    for name, entry, shape, mode, replaces in (
            ("conv3x3_fused", "K1", SERVE_SHAPE, "reflect", "desr_tpu/ops/pallas_conv.py:353"),
            ("conv3x3_fused", "K1 translator", TRANS_SHAPE, "replicate",
             "desr_tpu/ops/pallas_conv.py:353"),
            ("conv3x3", "K2", SERVE_SHAPE, "reflect", "desr_tpu/ops/pallas_conv.py:309")):
        b, h, w, c = shape
        x, wt, scale, shift = _inputs(torch.bfloat16, seed=1, shape=shape)
        if name == "conv3x3_fused":
            fn = lambda: K.conv3x3_fused(x, wt, scale, shift, mode, True, True)  # noqa: E731
            plain = lambda: K.conv3x3_fused_plain(x, wt, scale, shift, mode, True, True)  # noqa: E731
            extra_bytes = 2 * b * c * 4 * 2  # f32 scale, shift read; s, s2 written
        else:
            fn = lambda: K.conv3x3(x, wt, mode)  # noqa: E731
            plain = lambda: K.conv3x3_fused_plain(x, wt, pad_mode=mode)  # noqa: E731
            extra_bytes = 0
        flops = 2.0 * 9 * c * c * b * h * w
        io = 2 * b * h * w * c * 2 + 9 * c * c * 2  # bf16 x read and out written, bf16 w read
        xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode=mode)
        xp = xp.contiguous(memory_format=torch.channels_last)
        wb = wt.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        t_ops, t_bytes = flops / PEAK_BF16 * 1e3, (io + extra_bytes) / PEAK_HBM * 1e3
        entry_launches = entry.split()[0]
        row = {
            "name": name, "route": "cuda", "source": "desr_tpu_torch/csrc/conv3x3.cu",
            "replaces": replaces,
            "launches": serve_launches[entry_launches] + train_launches[entry_launches],
            "launches_serving": serve_launches[entry_launches],
            "launches_train": train_launches[entry_launches],
            "max_abs_err": worst[entry],
            "event_ms": cuda_ms(fn), **_device_stats(fn, "conv3x3"),
            "plain_ms": cuda_ms(plain, iters=5),
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": cuda_ms(lambda: F.conv2d(xp, wb)),
            "shape": f"B={b} {h}x{w} {c}->{c} bf16 {mode}"
                     + (" norm+relu+stats" if name == "conv3x3_fused" else ""),
            "flops": flops,
        }
        if entry == "K1 translator":
            # the kernel's counter is one for both shapes: the launches above
            # are all of K1's; this many a train step are at this shape
            row["launches_per_train_step_at_shape"] = K1_TRANS_PER_STEP
        rows.append(row)
        del x, wt, scale, shift, xp, wb
    # K3 at the train step's shape, f32 pred/target (the model's tail is f32);
    # its device time in three rounds, to show that the reading repeats
    ins = _loss_inputs(LOSS_SHAPE, torch.float32, seed=2)
    n = ins[0].numel()
    t_bytes = 4 * 4 * n / PEAK_HBM * 1e3  # four f32 inputs read once; 12 B written
    t_ops = 9 * n / PEAK_F32 * 1e3       # 3 mul + 1 sub + 1 mul, 2 abs, 1 square, 3 adds
    rows.append({
        "name": "masked_loss_sums", "route": "cuda", "source": "desr_tpu_torch/csrc/masked_loss.cu",
        "replaces": "desr_tpu/ops/pallas_kernels.py:97",
        "launches": train_launches["K3"], "launches_serving": 0,
        "launches_train": train_launches["K3"], "max_abs_err": k3_err,
        "event_ms": cuda_ms(lambda: K3.masked_loss_sums(*ins), iters=50, warmup=5),
        **_device_stats(lambda: K3.masked_loss_sums(*ins), "masked_loss", repeats=3),
        # back to back, the 31.5 MB of inputs stay in the 50 MB L2
        "device_ms_l2_warm": device_ms(lambda: K3.masked_loss_sums(*ins), "masked_loss",
                                       flush_l2=False),
        "plain_ms": cuda_ms(lambda: K3.masked_loss_sums_plain(*ins), iters=20),
        "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
        "shape": "6x512x640 f32 pred/target, f32 masks",
    })
    for r in rows:
        # "ms" is the kernels' device time per call where the profiler traced
        # it; CUDA events over back-to-back calls ("event_ms") also count the
        # wrapper's host time, which bounds a call as short as K3's
        r["ms"] = r["device_ms"] if r["device_ms"] is not None else r["event_ms"]
        r["ms_from"] = "torch.profiler" if r["device_ms"] is not None else "CUDA events"
        # share of the roofline this call reached; K1/K2 also their rate
        r["bound_share"] = r["bound_ms"] / r["ms"]
        if "flops" in r:
            r["tflops"] = r.pop("flops") / (r["ms"] * 1e-3) / 1e12
        if r["device_ms"] is not None and r["device_ms_min"] < r["bound_ms"]:
            print(f"[d] {r['name']} ({r['shape']}): a call took {r['device_ms_min']:.4g} ms, "
                  f"under its {r['bound_ms']:.4g} ms bound")
    return rows


def _device_stats(fn, key, repeats=1):
    """``device_ms`` over ``repeats`` rounds: the median of the rounds'
    medians, the least and most call, each round's median and traced count."""
    import statistics

    rounds = [device_ms(fn, key) for _ in range(repeats)]
    if any(r is None for r in rounds):
        return {"device_ms": None}
    return {"device_ms": statistics.median(r["median"] for r in rounds),
            "device_ms_min": min(r["min"] for r in rounds),
            "device_ms_max": max(r["max"] for r in rounds),
            "device_ms_round_medians": [r["median"] for r in rounds],
            "device_kernels_traced": [r["traced"] for r in rounds]}


def main():
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import desr_tpu_torch  # noqa: F401  (fails outside a checkout of the repository)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("[b] TF32 off: torch.backends.cudnn.allow_tf32 = False, "
          "torch.backends.cuda.matmul.allow_tf32 = False")
    card = phase_card_and_build()
    worst = phase_kernels()
    k3_err = phase_masked_loss()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=ROOT) as tmp:
        serve_launches = phase_serving(tmp)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=ROOT) as tmp:
        train_launches = phase_training(tmp)
    rows = phase_report(serve_launches, train_launches, worst, k3_err)
    for r in rows:
        check(r["launches"] > 0, f"{r['name']} was launched neither on the serving nor the "
                                 "train path")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
