#!/usr/bin/env python3
"""Smoke run of the PyTorch port (desr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit when it fails:

(a) card and build: prints the card's name and power limit as nvidia-smi gives
    them, builds the CUDA kernels (K1/K2, K3, K4) from desr_tpu_torch/csrc with nvcc (sm_90a),
    one nvcc per source, and the image decoders (csrc/dataio.cpp) with g++,
    all started together.
(b) kernels: the conv3x3 kernel in each variant of the serving path (K1 =
    conv3x3_fused: stats only, normalise+ReLU+stats, normalise only; K2 =
    conv3x3), for reflect, replicate and zeros borders, in float32 and bf16, at
    the serving shape (B=8, 128x160x128 NHWC), and K1 in the translator's two
    variants (stats only, normalise+ReLU+stats; replicate borders) at its train
    step shape (B=6, 128x160x256), held against the plain PyTorch version on
    the card with TF32 off (torch.backends.cudnn.allow_tf32 and
    torch.backends.cuda.matmul.allow_tf32 are set False for the whole run);
    then K1 (stats only, normalise+ReLU+stats) at the x2 SR stage's shapes:
    the ResnetBlocks at LR (B=4, 128x160x128) and HR (B=4 and B=2,
    256x320x128, reflect), the translators at HR (B=1, 256x320x256,
    replicate and reflect); then the bf16 body at the edges of its tiling
    (C_in and C_out off its 64-channel chunk and N tile, 16 -> 16, W off its
    16-pixel tile, H = W = 2 with reflect, C_out = 300 over two N tiles),
    every K1 variant and K2 in all three borders; two launches of K1 must
    give the same bits. Then K1 (stats only, normalise+ReLU+stats) at this
    slice's shapes: Image_f's in the I2D step (B=24, 96x128x128, reflect),
    the main step's on its 384x512 crops (B=12, 96x128x128, reflect; G_A_d
    B=6, 96x128x256, replicate), the translators serving (B=8,
    128x160x256, replicate) and training in stage 2 (B=6, 64x64x256,
    replicate), and phase (t)'s split generators (B=6, 64x64x128,
    replicate). Then K1 at phase (p)'s shapes: the blocks at 32x32 (width
    8: B=8 32->32; the default widths: B=8 128->128, the translator B=4
    256->256), SR's HR crops (B=8 64x64x128, B=4 64x64x256), I2D's crops
    (B=8 96x128x128), the translator serving 320x320 scenes (B=2
    96x96x256) and I2D / SR-LR serving batches of 2 (B=2 128x160x128).
    Then K1 (stats; normalise+ReLU+stats) and K2 with halo rows
    (``--spatial_devices``): the serving blocks' input B=8 128x160 split in
    two bands of 64 rows and one halo row, (0, 1) and (1, 0), and a middle
    band of four, (1, 1); 128 -> 128 reflect and 256 -> 256 replicate,
    float32 and bf16, each against the plain version, and the two bands'
    outputs concatenated (and the middle band's) against the whole frame's
    launch: bit-equal expected, any difference printed. Then K1
    (norm+relu+stats) with halo rows at the training bands (``train
    --spatial_devices 2``): the main step's blocks on 384x512 crops, B=12
    (48+1)x128 128->128 reflect, the SR step's `Depth_f` at HR, B=2
    (128+1)x320 128->128 reflect, its `G_A_d`, B=1 (128+1)x320 256->256
    replicate (forward only), and stage 2's translator blocks at the
    README's crops, B=6 (32+1)x64 256->256 replicate (norm+relu+stats and
    stats only); each band's forward against the plain version (float32 and
    bf16), and for the trained three at float32 the VJP through the kernel
    against autograd of the plain composition and the two bands' gradients,
    the halo rows' carried home as the exchange's adjoint does, against the
    whole frame's, within 1e-4 of each gradient's largest entry.
(c) serving: 16 synthetic 480x640 RGB-D frames and seeded random .pth files at
    the default full widths; ``desr_tpu_torch.predict.main`` serves them in
    bf16 as two requests of 8 frames, then once more with the ResnetBlock
    convs routed through K2 (``--net_args --pallas_conv``). Checks the PNGs,
    the launch counters (24 per batch), and one batch's ``serve_forward``
    against the same model with the kernel swapped for its plain version.
(b') K3 = masked_loss_sums (one launch a call) and its backward
    masked_loss_grads, at the train step's shape (6, 512, 640) and on its
    384x512 crops (6, 384, 512), the SR step's
    (1, 1024, 1280) and (1, 512, 640), phase (p)'s (4, 128, 128) and
    (4, 256, 256) and a ragged (3, 37, 41), float32 and
    bf16 pred/target, binary masks, against their plain versions: the sums
    within 1e-5, two launches bit-equal; dp (and dt, with and without it)
    bit-equal at float32, within one bf16 step at bf16. Then 100 back-to-back launches give the same bits,
    launches on two streams all give the plain sums, and n below one vector,
    views one value into their storage (all four, or pred alone) work.
(e) training: 12 synthetic 480x640 RGB-D frames per domain with their
    intrinsics and seeded random .pth files for all five nets at full width;
    ``desr_tpu_torch.train.main`` trains on them with the README stage-3 flags
    (--no_aug --continue_train --batch_size 6, bf16) for one epoch of 2 steps.
    Checks the launch counters (K1 42, K3 2 and K3's backward 2 per step), finite losses, the
    frozen nets' weights unchanged and the trained ones moved; at model level
    G falls over 4 steps on one batch; at float32 (batch 2, 256x384) one step
    through the kernels against the same step through their plain versions
    (loss terms, and gradients against the plain route's own sensitivity);
    then times the bf16 step (CUDA events) and profiles it. Then the README's
    command as it stands, without --no_aug (rotate with p 0.9, 384x512
    crops): 2 steps through ``train.main`` (K1 42, K3 2 and 2 a step), one
    model-level step's launches, the step timed and profiled.
(f) SR serving: 8 synthetic 960x1280 RGB-D frames (ScanNet's 480x640 at x2)
    and seeded random .pth files at full width; ``predict.main --SR`` serves
    them in bf16 as two requests of 4 (padded to 1024x1280, guidance at LR
    512x640). Checks the 960x1280 PNGs, K1 at 24 launches per batch, and one
    batch's ``serve_forward`` against the same model with K1 swapped for its
    plain version (phase (c)'s bounds); times the batch and each net.
(m) deployment, on (c)'s and (f)'s checkpoints and frames: ``predict.main
    --export`` of main (batch 8, 480x640 padded to 512x640), ``--SR`` (batch
    4, 960x1280 padded to 1024x1280) and the --pallas_conv route, bf16, with
    torch.export's and its save's seconds; each saved program holds 24
    desr::conv3x3_fused nodes (desr::conv3x3 under --pallas_conv) and as
    many library conv nodes as the nets have other convs, and loads (seconds
    printed); ``--from_export`` serves (c)'s first request of 8 frames and
    (f)'s of 4 (the --pallas_conv route (c)'s first 8 too) with K1 (K2) at
    24 a batch and PNGs
    equal to the live CLI's or within (c)'s bf16 bound; the artifact's batch
    against the live serve_forward's (max |d|, device ms by CUDA events, live,
    artifact, artifact, live; equal under cuDNN's deterministic algorithms),
    the artifact profiled; the CLI's host wall over 16 frames (main; 8 under
    --SR; hard links) at --num_workers 0 and 4;
    ``desr_tpu_torch.metrics.main`` on (c)'s predictions against their
    inputs with the holes filled, with intrinsics: nine finite values, the
    same at --n_cpus 1 and 4, seconds a frame at each; ``ops/ssim.py`` on
    the card against the CPU within 1e-5.
(g) SR training: 4 synthetic 480x640 frames per domain through
    NaiveSRDataset (INTER_AREA x2, pad to 1024x1280, the whole canvas as the
    crop); ``train.main --SR`` with the README's SR flags and bench.py's loss
    flags (batch 1, crop 512x640, lr 2e-5, bf16) for 2 steps. Checks the
    launches (K1 42, K3 2 and K3's backward 2 per step: one HR and one LR
    triplet each), finite losses, frozen nets unchanged
    and trained ones moved, G falling over 4 model-level steps, an f32
    kernel-vs-plain step at HR 256x256 (phase (e)'s bounds), one
    --use_rec_as_real_input step (K1 78 launches, G_B_d unchanged); then
    times and profiles the bf16 step.
(h) I2D serving: 8 synthetic 480x640 frames, RGB only, through
    ``predict.main --I2D`` in bf16 (padded to 512x640; Image_f and Task at
    the default widths, seeded random .pth files). Checks the PNGs, K1 at 12
    a batch, and ``serve_forward`` against the same model with K1 swapped for
    its plain version (phase (c)'s bounds); times the batch and each net.
(i) translate serving: 8 synthetic 480x640 RGB-D frames through
    ``predict.main --translate AtoB`` (G_A) and ``BtoA`` (G_B), bf16, at the
    translator's hardcoded widths. Checks the PNGs (the two directions
    differ), K1 at 18 a batch, each direction's forward against the plain
    version (phase (c)'s bounds); times each direction and G_A's parts.
(j) I2D training: 24 synthetic 480x640 frames a domain through I2DDataset
    (ColorJitter, rotate with p 0.85, 384x512 crops); ``train.main
    --model_type I2D`` with the README stage-1 flags (batch 12, lr 2e-4) plus
    --use_D, for 2 steps: K1 12 a step, finite losses, Image_f bit-equal
    (the Task-only optimizer), Task and D_depth moved; one
    --i2d_train_features step, where every ResnetBlock conv of Image_f gets a
    gradient through K1's backward and Image_f moves; a float32
    kernel-vs-plain step with the adversarial term (phase (e)'s bounds); then
    times and profiles the bf16 step with its D step.
(k) stage-2 training: 12 synthetic 480x640 RGB-D frames a domain in
    <tmp>/train{A,B}/{img,depth}; ``train.main --model_type translation``
    with the README's stage-2 flags (batch 6, 256x256 crops of the 320x320
    Lanczos resize, --max_distance 5100, bf16) for 2 iterations: K1 216 an
    iteration (18 a G apply, 4 applies a G step, 3 G steps), finite losses,
    the six latest_net_*.pth files, which ``predict --translate AtoB`` then
    serves (K1 18 a batch); one model-level iteration moves all six nets;
    a float32 G step and D step at batch 2 through K1 against the same steps
    through its plain version (phase (e)'s bounds, the four Ds' gradients
    too); the bf16 iteration, its G and D steps timed and profiled (with the
    replication_pad kernels' share: K1's backward and the replicate convs);
    one untimed iteration each with --netD Gu
    (BatchNorm counts 3 G applies + real + fake), --use_spnorm and --inp_B
    depth.
(l) --device_aug at the README geometry: 288 synthetic 480x640 frames a
    domain with intrinsics (4 written, the rest hard links to them), and
    24 with 968x1296 colour (ScanNet's; 1 written) for SR.
    For main (batch 6, 384x512 crops), I2D (batch 12) and SR (batch 1, LR
    512x640): one host batch of the --device_aug dataset through its
    device_finish on the card against the same function on the CPU (main
    within 2e-3 and its unrotated frames bit-equal; I2D's images within the
    ColorJitter bounds of tests/test_device_aug.py widened by 2e-3 x 127.5,
    its depths within 2e-3; SR within 1e-5), the upload from pinned memory
    and device_finish's time by CUDA events and by the profiler; then the
    train CLI with 4 loader workers and TF32 as the CLI leaves it (PyTorch's
    defaults), host augmentation (20 steps) and then --device_aug (24):
    launches per step as in (e), (g), (j), finite losses; after the
    loader's first 8 batches (2 a worker, all queued when the epoch starts)
    the wall of 4 steps (a round of the 4 workers) unprofiled gives the
    step's time and pairs/s with the feed (with the host's time inside the
    steps), and under --device_aug the next 4 steps under a
    CUDA-only profiler the card's busy share (kernels and copies over their
    wall) and the profiled step's time; the epoch's last 8 steps, which the
    workers feed back to back, are not read; then 2 I2D steps
    with --profile_dir, whose trace must hold the train_step and
    device_finish spans and K1's kernels.
(n) the train CLI's surface: ``train.main`` with the README stage-3 flags
    on 24 synthetic frames a domain (2 written, the rest hard links) plus
    --steps_per_call 2, --display_freq 6 (one batch), --lr_policy plateau
    and --do_test on one pair: 4 steps as 2 groups, a gallery forward each
    group, launches as predicted (K1 42 a step and a forward, K3 2 and its
    backward 2 a step, K3 2 a forward), finite losses, the gallery's 13
    PNGs and index.html decoded; the gallery forward timed. At float32 under
    deterministic cuDNN and torch's deterministic mode (batch 2, 256x384): 2
    groups of 2 steps bit-equal to 4 single steps, and a save_train_state /
    load_train_state resume bit-equal to the run it left. The SR step (batch
    1, LR 512x640 -> HR 1024x1280, bf16) without remat and under --remat,
    --remat_blocks and --remat_tails: K1 launches a step (42, 54, 54, 42),
    peak GiB, and in turns (each variant twice, the order reversed the
    second time) ms by CUDA events and the host's issue ms, 5 steps a turn
    after one; at float32 (HR 256x256) each
    variant's loss terms (1e-6 relative) and gradients (1e-6 of the net's
    largest, or 3x the plain step's run-to-run floor: the bicubic resize's
    backward has no deterministic version) against the plain step's; one
    I2D step (--i2d_train_features) and one stage-2 G step under
    --remat_tails likewise. A bf16 main step under --norm batch (K1 18: only
    G_A_d's group norms fuse) and one under --init_type orthogonal: finite
    losses, no running statistics moved, the trained nets moved.
(o) the bench and the host image I/O: ``desr_tpu_torch.bench.run`` in-process
    (12 + 10 SR steps, bench.py's configuration, K1 42, K3 2 and its backward
    2 a step, counted; the path ``train_bench``), then ``python -m
    desr_tpu_torch.bench`` as a subprocess (exactly one stdout line with
    bench.py's four keys, its value finite and positive; the line and the
    card it names printed); the image decode route
    (``data/native_io.py:route``, which must be native for PNG and PIL for
    JPEG), the per-frame decode of phase (c)'s first 480x640 RGB and depth
    PNGs (and the RGB one re-encoded with the Paeth filter) through the
    native library and data/png.py in turns (medians), and the decode of the
    committed 968x1296 JPEG fixture, timed and held to the sha256 of
    imageio's pixels.
(p) the quality chain (``desr_tpu_torch/tools/quality_eval.py``, in-process,
    one chain at a time, on synthetic scenes that can be learnt): train
    through ``train.main``, serve through ``predict.main``, score with the
    offline metrics. (p1) main at --width 8, float32, 60 steps (the JAX
    tool's QUALITY_r03 configuration at 10 of its 30 epochs); (p2) main at
    the default widths, bf16, 60 steps (10 epochs); (p3) SR at its 480x640 / 960x1280 geometry, default
    widths, bf16, a 4-step main pretrain and 2 SR steps, served through
    --export / --from_export; (p4) I2D at 480x640 and stage 2 at 320x320,
    2 steps each. Checks: every split's nine metrics finite, one PNG a
    test frame, in (p1) and (p2) trained rmse and rmse_h below the degraded
    input's, launches exactly as the steps and one serving batch give
    (path ``quality``); prints each chain's JSON, its wall split into data
    write, train, serve and score, the train steps/s and the shapes K1 and
    K3 were launched at.
(q) the data mesh (``desr_tpu_torch/parallel``, ``--num_devices``): two
    ranks on the one card over gloo with CUDA tensors (NCCL takes one rank
    a card; gloo goes through the host), float32, TF32 off, torch's
    deterministic mode. Each rank takes its rows of the same global batches
    and runs the main step at stage 3's flags (batch 6 on 384x512 crops, 3 a
    rank), a stage-2 iteration with --netD Gu (one G step and the D step,
    batch 4 at 256x256), an I2D --use_D step (batch 4 at 384x512, a pool of
    2) and the SR step at batch 1 (HR 256x256: both ranks take the whole
    batch), at the default widths with seeded weights; each held against
    the one-process step on the same batch (``phase_data_parallel`` states
    the bounds), the ranks bit-equal on what they reduced, K1 and K3
    launched on every rank as on one (phase (e)'s, (j)'s, (k)'s and (g)'s
    counts, paths ``train_dp_<step>_rank<r>``), the replay pools' draws
    equal. Prints the 2-rank main step's ms and the gradient average's ms
    (the two ranks share the card: not a scaling figure). Then ``predict
    --num_devices 1`` gives the CLI's PNGs without the flag, bit for bit,
    and ``--num_devices 2`` on this one card is refused by predict and train.
(r) the spatial mesh axis (``--spatial_devices``, ``parallel/spatial.py``):
    two gloo ranks on the one card, one spatial group, each frame's rows
    split between them. Through the CLI's rank (``predict._rank_serve``,
    what ``predict --num_devices 2 --spatial_devices 2`` runs in each rank;
    rank 0 gathers the rows and writes the PNGs) at the default widths in
    bf16 with seeded weights: main on 8 480x640 frames, --SR on 4 960x1280
    (HR 1024x1280), --I2D (at --num_workers 2: each rank's pool of two
    host workers decodes its frames, rank 0's writes the PNGs, and every
    rank ends its pool before it returns) and --translate AtoB on the 8,
    and main under --pallas_conv (K2); every K1 / K2 launch of a rank must
    read a halo row
    (paths ``serve_spatial_<mode>_rank<r>``, counts ``K1 halo`` and ``K2
    halo``), the ranks alike. Each against ``predict --num_devices 1`` on
    the same frames (PNGs: max and mean mm), and each mode's forward over
    the two ranks against one process's: float32 under deterministic cuDNN
    within 1e-3, bf16 within the larger of 0.045 and the one process's own
    bf16-vs-float32 gap; prints the launches, halo exchanges, moment
    all-reduces and gathers a forward, ms a batch (two processes sharing
    one card: not a scaling figure) and peak memory a rank against one
    process's.
(s) spatial training (``train --spatial_devices``): two gloo ranks on the
    one card, one spatial group, each frame's rows split between them.
    float32, TF32 off, torch's deterministic mode, width 8, seeded weights:
    the main step on 384x512 crops at batch 2, the same under --norm batch,
    the SR step at batch 1 (HR 512x512), two I2D --use_D steps at batch 2,
    a stage-2 iteration (one G step, then the D step on its feed) at
    batch 2 on 128x128 frames with the translators' hardcoded widths, a
    --steps_per_call 2 group of two main steps (at --lr 0, so that the
    second starts from the same weights on every route; its floor from
    three jitter draws) and one --device_aug main step on the loader's
    first batch (each rank's batch, its band of the data group's frames
    finished on the card, bit-equal to its band of one process's), each
    against the one-process step on the same global batch (terms
    within max(1e-5, 3x the floor), weight gradients within max(1e-3, 3x
    the floor) relative L2, the floor being the larger gap of the
    one-process step with K1's outputs, the InstanceNorms' moments and the
    BatchNorms' outputs (stage 2: the GroupNorms' too) jittered by 1e-6
    relative from two seeds; the
    running statistics within phase (q)'s bounds; the ranks alike bit for
    bit, every K1 launch with halo rows, K1 and K3 as often as one
    process); on the ranks, the group at the default lr equals the same
    two steps taken one at a time, bit for bit. Then bf16 at the default
    widths through the CLI's rank entry
    (``train._rank_main``, what ``train --num_devices 2 --spatial_devices
    2`` runs in each rank): 2 SR steps in bench.py's configuration (batch 1,
    HR 1024x1280; K1 42 a step, all with halo rows, K3 2 and 2) and 2
    stage-2 iterations at the README's flags (batch 6, 256x256 crops from
    12 frames a domain; K1 216 an iteration, each with halo rows and a
    backward), finite losses, frozen nets unchanged and trained ones moved
    in the saved checkpoints; then the bf16 SR step timed (1 after one)
    with its collectives forward and backward and peak memory a rank,
    against one process (two processes sharing one card: not a scaling
    figure); the same step under --remat_blocks on the ranks, held to it
    without remat (deterministic cuDNN: terms within max(1e-5, 3x the
    floor), weight gradients within max(1e-3, 3x the floor), the floor
    that step against itself), timed with its peak memory a rank and its
    recompute's collectives; and the bf16 stage-2 iteration timed (1
    after one) with its collectives and peak memory a rank, against one
    process.
(t) the capabilities no shipped configuration reaches, at full width,
    float32, each through K1 against its plain version (forward within
    (b)'s bound, gradients within (e)'s, max(1e-3, 3x the plain route's
    gap under a 1e-6 perturbation) relative L2): a zoo-A
    ResnetBlock with dropout in training at the main step's block shape
    (B=12, 96x128, 128 channels, reflect; K1 2 a forward, the second
    without a prologue), its Dropout's mask on the card (keep rate within
    0.5 +- 1e-3, the CPU's draw bit for bit, the forward's mask again in
    --remat_blocks' recompute); G_A with dropout at stage 2's B=6 256x256
    (K1 18 a forward); GeneratorI_F -> GeneratorF_D at ngf_img_feature 32
    on B=6 256x256 frames (K1 20 a forward, the dilated blocks on cuDNN);
    define_G(use_old=True) under group norm, GroupNorm(1): a resnet_6blocks
    at Depth_f's geometry (K1 12) and a unet_128 at Task's, forward. Then
    the helpers no model calls, on card tensors at stage 2's shapes against
    the same calls on the CPU: masked_mean_dif, masked_signed_mean, the
    masked cosine loss with compat_bug True and False (each within 1e-5
    relative), MeanMatching both ways with its shift drawn by a CUDA
    generator (bit for bit against the CPU on that shift); one line of
    their gaps.
(d) prints one {"kernels": [...]} line with each kernel's launches on the
    serving and train paths (and by path; ``launches_artifact``: phase (m)'s
    runs of the exported programs), error, time, the wrapper's host time a
    call (``host_ms``; for K1/K2 the issue time of calls queued behind each
    other), the plain version's
    and the library call's times, its bound on this card and the share of it
    reached (bound_share), and for K1/K2 the rate (tflops); K1 has rows at
    the main serving shape, the translator's, the SR step's two HR shapes,
    the I2D step's, the augmented main step's two, the translators' serving
    shape, stage 2's, phase (t)'s split generators' and phase (p)'s eight
    (one in float32; with the time of
    K1's backward at stage 2's shape,
    ``backward_ms`` by CUDA events and ``backward_device_ms`` by the
    profiler, and cuDNN's conv backward alone, ``library_backward_ms`` and
    ``library_backward_device_ms``)
    (``launches_at_shape`` says which path runs each; ``launches_quality``
    counts phase (p)'s); K1 (128 and 256 channels) and K2 with a halo row
    at a rank's band of the serving blocks' input, B=8 (64+1)x160, their
    launches phase (r)'s and (s)'s halo launches, cuDNN on the same rows; K1
    at the training bands of (b) (the lower band, halo rows (1, 0); stage
    2's B=6 (32+1)x64 256->256 replicate among them), with
    the backward of such a launch and of the whole frame's by CUDA events
    and the profiler (``band_backward_ms``, ``whole_backward_ms``); K3's sums and its backward each at the main step's
    two shapes, the SR step's HR shape and phase (p)'s 4x128x128, with the
    wrapper's host time per call (host_ms) and the kernels a call launches;
    the sums rows also time the earlier two-launch design
    (desr_tpu_torch/tools/masked_loss_two_launch.cu, built in phase (a)) on
    the same inputs (two_launch_ms); K4's moments and apply at the serving
    nets' norms (B=8 at 512x640: each resnet_6blocks' 32, 64 and 128
    channels, the U-Nets' levels down to 512 channels at 8x10, in the
    layout each arrives in), the apply with the ResnetBlock tail's skip,
    each against its bytes (moments 2 B a value, apply 4, with the skip 6),
    the plain version's time, and its largest error against float64 beside
    the plain version's. Device times flush L2 before each call;
    a profiler round that traced no kernel is run again (the profiler can
    miss a whole round).

The last line is {"ok": true, "device": {"platform": "gpu", ...}}. Without a
CUDA device, or without the rest of the repository beside it, the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16 = 989e12   # dense bf16 tensor-core FLOP/s, H100 SXM data sheet
PEAK_HBM = 3.35e12   # bytes/s, H100 SXM data sheet
SERVE_SHAPE = (8, 128, 160, 128)  # the ResnetBlocks' NHWC input at 480x640 (padded 512x640), batch 8
LAUNCHES_PER_BATCH = 24           # 12 ResnetBlocks x 2 convs (I2D_features + Depth_f)
# K4's launches (moments, applies) where no gradient flows: a resnet_6blocks
# net's 5 norms and its 6 ResnetBlock tails, a unet_128's 11 norms, a
# PatchGAN's 3 norms, a ResnetBlockT translator's 9 tails (its norms are
# GroupNorms, which K4 leaves alone); nets that train take none
K4_PER_BATCH = (32, 44)           # main and SR serving: 5 + 5 + 11 + 11 norms, + 12 chain tails
K4_PALLAS_PER_BATCH = (56, 56)    # the --pallas_conv route: the blocks' 24 norms as layers, no tails
K4_PER_STEP = (16, 31)            # main and SR steps: the frozen guidance's 2B call and G_A_d
K4_NORM_BATCH_PER_STEP = (0, 9)   # the main step under --norm batch: G_A_d's tails alone
K4_EVAL = (32, 53)                # an eval forward: the four nets and G_A_d
I2D_K4_PER_STEP = (11, 17)        # I2D --use_D: the frozen Image_f, D_depth's two no_grad logits
I2D_K4_PER_STEP_NO_D = (5, 11)    # I2D without --use_D: Image_f alone
I2D_K4_PER_BATCH = (16, 22)       # --I2D serving: Image_f and Task
TRANSLATE_K4_PER_BATCH = (0, 9)   # --translate serving: the G's tails
LOSS_SHAPE = (6, 512, 640)        # K3's input at the train step: batch 6, 480x640 padded
TRANS_SHAPE = (6, 128, 160, 256)  # G_A_d's ResnetBlockT input at the train step (NHWC)
K1_PER_STEP = 42                  # I2D_features 12 + Depth_f 12 (batch 2B) + G_A_d 18 (9 blocks)
K1_TRANS_PER_STEP = 18            # of those, G_A_d's: at TRANS_SHAPE, replicate borders
K3_PER_STEP = 2                   # the syn and real (task, holes, holes_l2) triplets
K3_BWD_PER_STEP = 2               # their backward: one masked_loss_grads launch each
STEP_TIMED = 3                    # train steps timed by CUDA events, after 2 (e, g, j, k)
PEAK_F32 = 67e12                  # f32 FLOP/s outside the tensor cores, H100 SXM data sheet
# the x2 SR stage at the README geometry: LR 512x640 -> HR 1024x1280
SR_SERVE_SHAPE = (4, 256, 320, 128)   # Depth_f's ResnetBlocks at HR, a serving batch of 4
SR_LR_SHAPE = (4, 128, 160, 128)      # I2D_features' at LR, a serving batch of 4
SR_DEPTHF_SHAPE = (2, 256, 320, 128)  # Depth_f's at HR in the train step (batch 2B, B=1)
SR_TRANS_SHAPE = (1, 256, 320, 256)   # G_A_d's (replicate) and G_B_d's (reflect) at HR, B=1
SR_LOSS_SHAPES = ((1, 1024, 1280), (1, 512, 640))  # K3's syn (HR) and real (LR) triplets
SR_K1_PER_STEP = 42       # I2D_features 12 (LR) + Depth_f 12 (HR, with a backward) + G_A_d 18
SR_K1_REC_PER_STEP = 78   # --use_rec_as_real_input: + G_B_d 18 + G_A_d 18 more
SR_K1_BWD_PER_STEP = 12   # of those, Depth_f's take a backward
# stage 1, stage 2 serving and the main step with its augmentation (384x512 crops)
I2D_TRAIN_SHAPE = (24, 96, 128, 128)  # Image_f's ResnetBlocks, I2D step: batch 2B, B=12, 384x512
AUG_SHAPE = (12, 96, 128, 128)        # I2D_features' and Depth_f's, main step on 384x512 crops
AUG_TRANS_SHAPE = (6, 96, 128, 256)   # G_A_d's there
TRANSLATE_SHAPE = (8, 128, 160, 256)  # G_A's or G_B's, serving a batch of 8 at 512x640
AUG_LOSS_SHAPE = (6, 384, 512)        # K3's input, main step on 384x512 crops
I2D_K1_PER_STEP = 12      # Image_f's 6 ResnetBlocks x 2 convs, on the 2B batch
I2D_K1_PER_BATCH = 12     # the same, serving
TRANSLATE_K1_PER_BATCH = 18  # 9 ResnetBlockT x 2 convs
# stage 2 training: batch 6 of 256x256 crops, G_A's and G_B's ResnetBlockT
STAGE2_SHAPE = (6, 64, 64, 256)
# phase (p)'s ResnetBlocks at the quality tool's 128x128 scenes (32x32 in the
# blocks), batch 4, two branches batched: width 8 (32 channels) in float32,
# the default widths in bf16; SR's HR crops, I2D's crops, the translators
Q_W8_SHAPE = (8, 32, 32, 32)           # I2D_features, Depth_f at --width 8 (2B)
Q_SHAPE = (8, 32, 32, 128)             # the same at the default widths; SR at LR
Q_TRANS_SHAPE = (4, 32, 32, 256)       # G_A_d (replicate), f32 and bf16
Q_SR_HR_SHAPE = (8, 64, 64, 128)       # Depth_f at SR's 256x256 HR crops (2B)
Q_SR_TRANS_SHAPE = (4, 64, 64, 256)    # G_A_d at HR; G_A/G_B in stage 2 on 256x256 crops
Q_I2D_SHAPE = (8, 96, 128, 128)        # Image_f on I2D's 384x512 crops (2B, B=4)
Q_TRANSLATE_SHAPE = (2, 96, 96, 256)   # G_B serving 320x320 scenes padded to 384x384
Q_SERVE_SHAPE = (2, 128, 160, 128)     # --I2D serving 480x640 (Image_f); SR serving at LR
Q_LOSS_SHAPE = (4, 128, 128)           # K3 at the main chains' scenes and SR's LR crops
Q_SR_LOSS_SHAPE = (4, 256, 256)        # K3 at SR's HR crops
STAGE2_K1_PER_ITER = 216  # 18 a G apply x 4 live applies a G step x 3 G steps
# phase (t), the capabilities no shipped configuration reaches: the split
# generators at ngf_img_feature 32 on stage 2's batch of 256x256 crops
SPLIT_SHAPE = (6, 64, 64, 128)  # their dilation-1 ResnetBlockTs' NHWC input
SPLIT_K1 = 20             # GeneratorI_F's first block 2 + GeneratorF_D's 9 blocks 18, a forward


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


def issue_ms(fn, calls=50):
    """The host's time to issue one call of fn in ms: ``calls`` calls queued
    back to back while the card runs behind, timed before the sync
    (perf_counter); for calls that keep the card busier than the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def host_ms(fn, calls=200):
    """The host's time per call of fn in ms: ``calls`` back-to-back calls
    from an idle device, one sync at the end (perf_counter)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def _reset_counts():
    from desr_tpu_torch.ops import conv3x3 as K
    from desr_tpu_torch.ops import instance_norm as K4
    from desr_tpu_torch.ops import masked_loss as K3

    K.conv3x3_fused.launches = K.conv3x3.launches = 0
    K3.masked_loss_sums.launches = K3.masked_loss_grads.launches = 0
    K4.instance_norm_moments.launches = K4.norm_apply.launches = 0


def _counts():
    """Each kernel's launches since ``_reset_counts`` ("K4": the moments,
    "K4 apply": the normalisations)."""
    from desr_tpu_torch.ops import conv3x3 as K
    from desr_tpu_torch.ops import instance_norm as K4
    from desr_tpu_torch.ops import masked_loss as K3

    return {"K1": K.conv3x3_fused.launches, "K2": K.conv3x3.launches,
            "K3": K3.masked_loss_sums.launches, "K3 backward": K3.masked_loss_grads.launches,
            "K4": K4.instance_norm_moments.launches, "K4 apply": K4.norm_apply.launches}


def _holds(launches, want):
    """Whether ``launches`` (``_counts()``) has ``want``'s count of each
    kernel ``want`` names."""
    return all(launches[k] == v for k, v in want.items())


def _k4(per, times=1, device="cuda"):
    """``want`` entries for K4's launches, ``per`` (moments, applies) times
    ``times``; none off the card (a CPU rehearsal), where the counters
    count no launch."""
    if device != "cuda":
        return {}
    return {"K4": per[0] * times, "K4 apply": per[1] * times}


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
            "traced": f"{traced}/{len(by_name) * iters}", "names": sorted(by_name)}


# ------------------------------------------------------------------ (a)

def phase_card_and_build():
    from desr_tpu_torch.bench import card_and_power_limit
    from desr_tpu_torch.ops import _build

    card = card_and_power_limit()
    print(card)

    from concurrent.futures import ThreadPoolExecutor

    from desr_tpu_torch.tools.masked_loss_ab import build_two_launch

    t0 = time.perf_counter()
    # one compiler process per source: nvcc for the kernels, g++ for the image decoders
    names = ("conv3x3", "masked_loss", "instance_norm", "dataio")
    with ThreadPoolExecutor(len(names) + 1) as pool:
        two_launch = pool.submit(build_two_launch)
        paths = list(pool.map(lambda n: _build.build(n, verbose=True), names))
        paths.append(two_launch.result())
    print(f"[a] built {', '.join(os.path.relpath(p, ROOT) for p in paths)} "
          f"in {time.perf_counter() - t0:.1f} s")
    return card, paths[-1]


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

    worst = {"K1": 0.0, "K2": 0.0, "K1 translator": 0.0, "K1 SR LR": 0.0, "K1 SR HR": 0.0,
             "K1 SR Depth_f": 0.0, "K1 SR translator": 0.0, "K1 I2D": 0.0, "K1 aug": 0.0,
             "K1 aug translator": 0.0, "K1 translate": 0.0, "K1 stage2": 0.0,
             "K1 quality w8": 0.0, "K1 quality w8 float32": 0.0, "K1 quality": 0.0, "K1 quality translator": 0.0,
             "K1 quality SR HR": 0.0, "K1 quality SR translator": 0.0, "K1 quality I2D": 0.0,
             "K1 quality translate": 0.0, "K1 quality serve": 0.0, "K1 split": 0.0}
    # the serving path's variants and borders; the translator's ResnetBlockT
    # (G_A_d on the train path) runs stats, then norm+relu+stats, replicate;
    # the SR stage's ResnetBlocks at LR and HR, and its translators at HR
    # (G_A_d replicate, G_B_d of --use_rec_as_real_input reflect); then
    # stage 1's Image_f in its train step, the main step's nets on 384x512
    # crops, the stage-2 translators serving and training
    for tag, shape, modes, variants in (
            ("", SERVE_SHAPE, ("reflect", "replicate", "zeros"), K1_VARIANTS),
            (" translator", TRANS_SHAPE, ("replicate",), K1_VARIANTS[:2]),
            (" SR LR", SR_LR_SHAPE, ("reflect",), K1_VARIANTS[:2]),
            (" SR HR", SR_SERVE_SHAPE, ("reflect",), K1_VARIANTS[:2]),
            (" SR Depth_f", SR_DEPTHF_SHAPE, ("reflect",), K1_VARIANTS[:2]),
            (" SR translator", SR_TRANS_SHAPE, ("replicate", "reflect"), K1_VARIANTS[:2]),
            (" I2D", I2D_TRAIN_SHAPE, ("reflect",), K1_VARIANTS[:2]),
            (" aug", AUG_SHAPE, ("reflect",), K1_VARIANTS[:2]),
            (" aug translator", AUG_TRANS_SHAPE, ("replicate",), K1_VARIANTS[:2]),
            (" translate", TRANSLATE_SHAPE, ("replicate",), K1_VARIANTS[:2]),
            (" stage2", STAGE2_SHAPE, ("replicate",), K1_VARIANTS[:2]),
            (" quality w8", Q_W8_SHAPE, ("reflect",), K1_VARIANTS[:2]),
            (" quality", Q_SHAPE, ("reflect",), K1_VARIANTS[:2]),
            (" quality translator", Q_TRANS_SHAPE, ("replicate",), K1_VARIANTS[:2]),
            (" quality SR HR", Q_SR_HR_SHAPE, ("reflect",), K1_VARIANTS[:2]),
            (" quality SR translator", Q_SR_TRANS_SHAPE, ("replicate",), K1_VARIANTS[:2]),
            (" quality I2D", Q_I2D_SHAPE, ("reflect",), K1_VARIANTS[:2]),
            (" quality translate", Q_TRANSLATE_SHAPE, ("replicate",), K1_VARIANTS[:2]),
            (" quality serve", Q_SERVE_SHAPE, ("reflect",), K1_VARIANTS[:2]),
            (" split", SPLIT_SHAPE, ("replicate",), K1_VARIANTS[:2])):
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
                    elif tag == " quality w8":  # phase (p1) runs this shape in float32
                        worst["K1 quality w8 float32"] = max(worst["K1 quality w8 float32"], e)
                if tag:  # K2 runs only at the main serving shape
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


# K1/K2 with halo rows (``--spatial_devices``): the serving blocks' input,
# B=8 128x160 (a 512x640 frame at /4), split over two ranks (64 rows each
# and one halo row: (0, 1) and (1, 0)) and a middle band of four (1, 1);
# the main nets' 128 -> 128 reflect and the translator's 256 -> 256 replicate
HALO_SHAPES = (((8, 128, 160, 128), "reflect", ""), ((8, 128, 160, 256), "replicate",
                                                       " translator"))
HALO_BANDS = ((0, 65, 0, 1), (63, 128, 1, 0), (31, 97, 1, 1))  # x rows lo..hi, halo rows
HALO_SHAPE = (8, 65, 160, 128)   # phase (d)'s halo rows: a rank's band of two, (1, 0)


def phase_halo_kernels():
    """(b) K1 (stats; norm+relu+stats) and K2 with halo rows against their
    plain versions, float32 and bf16, on each band of ``HALO_BANDS``; then
    the two ranks' bands concatenated (and the middle band) against the
    whole frame's launch: each output pixel sums the same taps and channels
    in the same order, so they should be bit-equal; any difference is
    printed and held to ``_compare``'s bound. Returns the worst bf16
    max |d| against the plain version of each."""
    import torch

    from desr_tpu_torch.ops import conv3x3 as K

    worst = {"K1 halo": 0.0, "K1 halo translator": 0.0, "K2 halo": 0.0}
    equal = {}
    for shape, mode, tag in HALO_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype)[6:]
            x, w, scale, shift = _inputs(dtype, seed=7, shape=shape)
            runs = [("K1 " + v, lambda xb, *h, p=p, r=r: K.conv3x3_fused(
                        xb, w, *((scale, shift) if p else (None, None)), mode, r, True, *h),
                     lambda xb, *h, p=p, r=r: K.conv3x3_fused_plain(
                        xb, w, *((scale, shift) if p else (None, None)), mode, r, True, *h))
                    for v, p, r, _ in K1_VARIANTS[:2]]
            if not tag:
                runs.append(("K2", lambda xb, *h: (K.conv3x3(xb, w, mode, *h),),
                             lambda xb, *h: (K.conv3x3_fused_plain(
                                 xb, w, pad_mode=mode, halo_top=h[0], halo_bottom=h[1]),)))
            for name, fn, plain in runs:
                whole = fn(x)[0]
                outs = []
                for lo, hi, top, bottom in HALO_BANDS:
                    xb = x[:, lo:hi].contiguous()
                    got, want = fn(xb, top, bottom), plain(xb, top, bottom)
                    e = _compare(f"{name} halo{tag} ({top}, {bottom}) {mode} {dt}", got, want,
                                 dtype, (hi - lo - top - bottom) * shape[2])
                    if dtype == torch.bfloat16:
                        key = ("K2 halo" if name == "K2" else "K1 halo" + tag)
                        worst[key] = max(worst[key], e)
                    outs.append(got[0])
                for label, got, ref in (("2 ranks", torch.cat(outs[:2], 1), whole),
                                        ("middle band", outs[2], whole[:, 32:96])):
                    key = f"{name}{tag} {mode} {dt} {label}"
                    equal[key] = bool(torch.equal(got, ref))
                    if not equal[key]:
                        _compare(f"{key} vs the whole frame's launch", (got,), (ref,), dtype, 0)
            del x, w, scale, shift
            torch.cuda.synchronize()
    same = [k for k, v in equal.items() if v]
    print(f"[b] halo bands vs the whole frame's launch: {len(same)} of {len(equal)} bit-equal"
          + ("" if len(same) == len(equal) else
             f"; not: {sorted(k for k, v in equal.items() if not v)}"))
    return worst


# K1 with halo rows at the training bands (``train --spatial_devices 2``):
# the ResnetBlocks' NHWC input of the main step on 384x512 crops (B=12: the
# two branches of 6), Depth_f's in the SR step at HR 1024x1280 (B=2) and
# G_A_d's there (B=1, frozen: forward only); each frame split in two bands
# of h rows, a halo row each. (tag, whole-frame shape, pad mode, trained)
TRAIN_HALO = (("main", (12, 96, 128, 128), "reflect", True),
              ("SR Depth_f", (2, 256, 320, 128), "reflect", True),
              ("SR translator", (1, 256, 320, 256), "replicate", False),
              ("stage2", (6, 64, 64, 256), "replicate", True))
# the bands whose blocks also launch K1 without a prologue (a ResnetBlockT's
# first conv: stats only), checked in that variant too, forward and VJP
STATS_ONLY_HALO = ("stage2",)
TRAIN_HALO_PATHS = {  # where each runs, for phase (d)'s rows
    "main": "train --spatial_devices 2, the main step on 384x512 crops at batch 6, a rank: "
            "24 a step (I2D_features; Depth_f's with a backward); phase (s) runs that step "
            "at width 8",
    "SR Depth_f": "train --spatial_devices 2 --SR at bench.py's geometry, a rank: 12 a step, "
                  "each with a backward (phase (s)'s CLI run and timed steps)",
    "SR translator": "the same SR step, a rank: 18 a step (G_A_d, frozen: forward only)",
    "stage2": "train --model_type translation --spatial_devices 2 at the README's flags "
              "(batch 6, 256x256 crops: the bottleneck's 64 rows, 32 a rank), a rank: "
              f"{STAGE2_K1_PER_ITER} an iteration (G_A, G_B: 18 an apply, 4 applies a G step, 3 "
              "G steps), each with a backward; half of them stats only (phase (s)'s CLI run and "
              "timed iterations)"}
VJP_BOUND = 1e-4  # of each gradient's largest entry (tests/test_torch_cuda.py's)


def _k1_vjp(x, w, scale, shift, mode, halo, cots, fn=None):
    """(out, (dx, dw[, dscale, dshift])) of K1 (norm+relu+stats; stats only
    where ``scale`` is None) or ``fn`` on x with ``halo`` rows, for the
    cotangents ``cots`` of (out, s, s2)."""
    import torch

    from desr_tpu_torch.ops import conv3x3 as K

    ins = [t.detach().clone().requires_grad_(True) for t in (x, w, scale, shift)
           if t is not None]
    prologue = ins[2:] or [None, None]
    out, s, s2 = (fn or K.conv3x3_fused)(*ins[:2], *prologue, mode, scale is not None, True,
                                         *halo)
    loss = sum((a.float() * c).sum() for a, c in zip((out, s, s2), cots))
    return out.detach(), torch.autograd.grad(loss, ins)


def phase_halo_training_kernels():
    """(b) K1 (norm+relu+stats) with halo rows at ``TRAIN_HALO``'s bands: the
    forward of each band against the plain version (bf16 and float32,
    ``_compare``'s bounds); where the step trains it, at float32 under
    deterministic cuDNN, the VJP through the kernel (dx with its halo row,
    dw, dscale, dshift; cotangents on out, s and s2) against autograd of
    the plain composition on the same band, and the two bands' gradients
    with the halo rows' cotangents carried home (the exchange's adjoint)
    and dw, dscale, dshift summed (the gradient average, the moments'
    all-reduce) against the whole frame's VJP through the kernel, each
    within ``VJP_BOUND`` of its largest entry. The ``STATS_ONLY_HALO``
    bands take the same checks in K1's stats-only variant too (no
    prologue: a ResnetBlockT's first conv). Returns the worst bf16 forward
    max |d| by entry."""
    import torch

    worst = {}
    for tag, shape, mode, trained in TRAIN_HALO:
        for prologue in (True, False) if tag in STATS_ONLY_HALO else (True,):
            _halo_training_band(tag, shape, mode, trained, prologue, worst)
    return worst


def _halo_training_band(tag, shape, mode, trained, prologue, worst):
    """Phase (b)'s checks of one ``TRAIN_HALO`` band, K1 norm+relu+stats
    (``prologue``) or stats only; the bf16 forward's worst into ``worst``."""
    import torch

    from desr_tpu_torch.ops import conv3x3 as K

    b, hh, wd, c = shape
    h = hh // 2
    bands = ((0, h + 1, (0, 1)), (h - 1, hh, (1, 0)))
    key = "K1 halo train " + tag
    variant = "" if prologue else " stats only"
    worst.setdefault(key, 0.0)
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        x, w, scale, shift = _inputs(dtype, seed=21, shape=shape)
        if not prologue:
            scale = shift = None
        for lo, hi, halo in bands:
            xb = x[:, lo:hi].contiguous()
            e = _compare(f"{key}{variant} {halo} {mode} {dt}",
                         _k1_halo(xb, w, scale, shift, mode, halo),
                         _k1_halo(xb, w, scale, shift, mode, halo, plain=True),
                         dtype, h * wd)
            if dtype == torch.bfloat16:
                worst[key] = max(worst[key], e)
        del x, w, scale, shift
    if trained:
        x, w, scale, shift = _inputs(torch.float32, seed=22, shape=shape)
        if not prologue:
            scale = shift = None
        g = torch.Generator(device="cuda").manual_seed(23)
        cots = [torch.randn((b, hh, wd, c), generator=g, device="cuda"),
                torch.randn((b, c), generator=g, device="cuda"),
                0.01 * torch.randn((b, c), generator=g, device="cuda")]
        with _Deterministic():
            _, whole = _k1_vjp(x, w, scale, shift, mode, (), cots)
            parts, gap = [], 0.0
            for lo, hi, halo in bands:
                xb = x[:, lo:hi].contiguous()
                sl = slice(0, h) if halo == (0, 1) else slice(h, hh)
                band_cots = [cots[0][:, sl].contiguous(), *cots[1:]]
                _, got = _k1_vjp(xb, w, scale, shift, mode, halo, band_cots)
                _, want = _k1_vjp(xb, w, scale, shift, mode, halo, band_cots,
                                  fn=K.conv3x3_fused_plain)
                for name, a, p in zip(("dx", "dw", "dscale", "dshift"), got, want):
                    d = float((a - p).abs().max()) / max(float(p.abs().max()), 1e-30)
                    gap = max(gap, d)
                    check(d <= VJP_BOUND, f"[b] {key}{variant} {halo} VJP {name}: kernel vs plain "
                          f"{d:.3g} of its largest entry > {VJP_BOUND}")
                parts.append(got)
        (d0, *p0), (d1, *p1) = parts
        dx = torch.cat([d0[:, :h], d1[:, 1:]], 1)
        dx[:, h - 1] += d1[:, 0]
        dx[:, h] += d0[:, h]
        home = 0.0
        for name, a, p in zip(("dx", "dw", "dscale", "dshift"),
                              [dx] + [u + v for u, v in zip(p0, p1)], whole):
            d = float((a - p).abs().max()) / max(float(p.abs().max()), 1e-30)
            home = max(home, d)
            check(d <= VJP_BOUND, f"[b] {key}{variant}: two bands' {name} after the exchange's "
                  f"adjoint vs the whole frame's {d:.3g} of its largest entry > {VJP_BOUND}")
        print(f"[b] {key}{variant} B={b} ({h}+1)x{wd} {c}->{c} {mode} float32 (deterministic "
              "cuDNN): "
              f"VJP kernel vs plain {gap:.3g}, two bands after the exchange's adjoint vs the "
              f"whole frame {home:.3g} of each gradient's largest entry (bound {VJP_BOUND})")
        del x, w, scale, shift, cots, whole, parts, dx
        torch.cuda.synchronize()


def _k1_halo(x, w, scale, shift, mode, halo, plain=False):
    """K1 (norm+relu+stats; stats only where ``scale`` is None) with ``halo``
    rows: the kernel, or its plain version."""
    from desr_tpu_torch.ops import conv3x3 as K

    fn = K.conv3x3_fused_plain if plain else K.conv3x3_fused
    return fn(x, w, scale, shift, mode, scale is not None, True, *halo)


# ------------------------------------------------------------------ (b')

def _loss_inputs(shape, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    p = torch.randn(shape, generator=g, device="cuda").to(dtype)
    t = torch.randn(shape, generator=g, device="cuda").to(dtype)
    m1 = (torch.rand(shape, generator=g, device="cuda") > 0.3).float()
    m2 = (torch.rand(shape, generator=g, device="cuda") > 0.6).float()
    return p, t, m1, m2


def _bits(x):
    import torch

    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int16)


def _check_sums(name, got, want):
    """Each of the three sums has only terms >= 0, so f32 summation order
    bounds |kernel - plain| <= 1e-5 * sum (+1e-6 for a sum of 0)."""
    import torch

    err = (got - want).abs()
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite sums")
    check(bool((err <= 1e-5 * want.abs() + 1e-6).all()),
          f"{name}: sums {got.tolist()} vs plain {want.tolist()}")
    return float(err.max()), float((err / want.abs().clamp_min(1e-30)).max())


def _check_grads(name, ins, g):
    """masked_loss_grads against masked_loss_grads_plain, with and without
    dt: the kernel evaluates the plain expression in its order, each
    operation rounded on its own, so float32 must be bit-equal; bf16 within
    one bf16 step (2^-7 relative; it rounds the same f32 value). Returns the
    max |d| of dp and the count of values whose bits differ."""
    import torch

    from desr_tpu_torch.ops import masked_loss as K3

    worst, n_bits = 0.0, 0
    for with_dt in (False, True):
        got = K3.masked_loss_grads(*ins, g, with_dt)
        want = K3.masked_loss_grads_plain(*ins, g, with_dt)
        check((got[1] is not None) == with_dt,
              f"{name}: dt {'missing' if with_dt else 'computed without being asked for'}")
        for tag, a, b in zip(("dp", "dt"), got, want):
            if b is None:
                continue
            check(a.dtype == b.dtype and a.shape == b.shape, f"{name} {tag}: {a.dtype} {a.shape}")
            diff = int((_bits(a) != _bits(b)).sum())
            err = (a.float() - b.float()).abs()
            if a.dtype == torch.float32:
                check(diff == 0, f"{name} {tag}: {diff} values differ in their bits from plain "
                      f"(max |d| {float(err.max()):.3g})")
            else:
                check(bool((err <= 2.0 ** -7 * b.float().abs()).all()),
                      f"{name} {tag}: off by more than one bf16 step (max |d| {float(err.max()):.3g})")
            worst, n_bits = max(worst, float(err.max())), n_bits + diff
    return worst, n_bits


def phase_masked_loss():
    """K3's sums and backward against their plain versions,
    then the ticket, two streams, a tiny n and misaligned views. Returns the
    float32 max |d| of the sums and of dp at the two shapes phase (d) reports."""
    import torch

    from desr_tpu_torch.ops import masked_loss as K3

    worst, worst_bwd = {}, {}
    g = torch.tensor([0.7, -1.3, 0.4], device="cuda")
    for shape in (LOSS_SHAPE, AUG_LOSS_SHAPE, *SR_LOSS_SHAPES, Q_LOSS_SHAPE, Q_SR_LOSS_SHAPE,
                  (3, 37, 41)):
        for dtype in (torch.float32, torch.bfloat16):
            ins = _loss_inputs(shape, dtype, seed=sum(shape))
            got = torch.stack(K3.masked_loss_sums(*ins))
            again = torch.stack(K3.masked_loss_sums(*ins))
            want = K3.masked_loss_sums_plain(*ins)
            name = f"K3 {'x'.join(map(str, shape))} {str(dtype)[6:]}"
            err, rel = _check_sums(name, got, want)
            check(torch.equal(got, again), f"{name}: two launches differ")
            bwd, n_bits = _check_grads(name, ins, g)
            print(f"[b'] {name}: sums max |d| {err:.3g}, max rel {rel:.3g} (bound 1e-5), two "
                  f"launches bit-equal; backward max |d| {bwd:.3g}, {n_bits} values with other "
                  "bits than plain (dp, dt)")
            if shape in (LOSS_SHAPE, AUG_LOSS_SHAPE, SR_LOSS_SHAPES[0], Q_LOSS_SHAPE) \
                    and dtype == torch.float32:
                worst[shape], worst_bwd[shape] = err, bwd
            del ins
    # the ticket: the last block resets it, so launch after launch gives the same bits
    ins = _loss_inputs(SR_LOSS_SHAPES[0], torch.float32, seed=5)
    first = torch.stack(K3.masked_loss_sums(*ins))
    runs = [torch.stack(K3.masked_loss_sums(*ins)) for _ in range(100)]
    check(all(torch.equal(r, first) for r in runs), "K3: 100 back-to-back launches differ")
    # one ticket and partials per stream: two streams, no sync between launches
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    torch.cuda.synchronize()
    outs = []
    for i in range(20):
        with torch.cuda.stream(streams[i % 2]):
            outs.append(torch.stack(K3.masked_loss_sums(*ins)))
    torch.cuda.synchronize()
    _check_sums("K3 two streams", outs[1], K3.masked_loss_sums_plain(*ins))
    check(all(torch.equal(o, first) for o in outs), "K3: launches on two streams differ")
    print("[b'] K3 1x1024x1280 float32: 100 back-to-back launches bit-equal; 20 launches "
          "alternating over two streams bit-equal to them")
    # n below one vector, and views one value into their storage (no common
    # alignment when pred alone is one value in: value by value)
    for dtype in (torch.float32, torch.bfloat16):
        p, t, m1, m2 = _loss_inputs((4, 33, 50), dtype, seed=7)
        flat = [v.flatten() for v in (p, t, m1, m2)]
        for label, case in (("n=3", _loss_inputs((1, 1, 3), dtype, seed=8)),
                            ("all one value in", [v[1:] for v in flat]),
                            ("pred alone one value in",
                             [flat[0][1:]] + [v[:-1] for v in flat[1:]])):
            name = f"K3 {label} {str(dtype)[6:]}"
            want = K3.masked_loss_sums_plain(*case)
            _check_sums(name, torch.stack(K3.masked_loss_sums(*case)), want)
            _check_grads(name, case, g)
        print(f"[b'] K3 {str(dtype)[6:]}: n=3, all four inputs one value into their storage, "
              "pred alone one value in: sums and backward agree with plain")
    torch.cuda.synchronize()
    return worst, worst_bwd


# ------------------------------------------------------------------ (c)

def _write_frames(folder, n, seed=0, hw=(480, 640), img_hw=None):
    """n seeded frames of hw: smooth RGB with noise, uint16 mm depth with holes;
    the RGB of img_hw when given (ScanNet's colour frames are 968x1296)."""
    import numpy as np

    from desr_tpu_torch.data.png import write_png

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]].astype(np.float32)
    iy, ix = (yy, xx) if img_hw is None else np.mgrid[0:img_hw[0], 0:img_hw[1]].astype(np.float32)
    for sub in ("depth", "img"):
        os.makedirs(os.path.join(folder, sub), exist_ok=True)
    for i in range(n):
        a, b, c = rng.uniform(0.005, 0.03, 3)
        img = np.stack([np.sin(a * ix + i), np.cos(b * iy), np.sin(c * (ix + iy))], -1)
        img = 127.5 + 100 * img + rng.normal(0, 10, img.shape)
        depth = 1500 + 1000 * np.sin(a * xx) * np.cos(b * yy) + 0.5 * yy
        depth += rng.normal(0, 20, depth.shape)
        depth[rng.random(depth.shape) < 0.05] = 0           # speckle holes
        y0, x0 = rng.integers(0, hw[0] - 80), rng.integers(0, hw[1] - 80)
        depth[y0:y0 + 60, x0:x0 + 80] = 0                   # one block hole
        write_png(os.path.join(folder, "img", f"f{i:02d}.png"), img.clip(0, 255).astype(np.uint8))
        write_png(os.path.join(folder, "depth", f"f{i:02d}.png"),
                  depth.clip(0, 65535).astype(np.uint16))


def _read_outputs(folder, n, hw=(480, 640)):
    import numpy as np

    from desr_tpu_torch.data.png import read_png

    files = sorted(os.listdir(folder))
    check(len(files) == n, f"{folder}: {len(files)} PNGs, want {n}")
    arrs = [read_png(os.path.join(folder, f)) for f in files]
    for f, a in zip(files, arrs):
        check(a.dtype == np.uint16 and a.shape == hw, f"{f}: {a.dtype} {a.shape}, want {hw}")
    return np.stack(arrs).astype(np.int64)


def phase_serving(tmp):
    import numpy as np
    import torch

    from desr_tpu_torch import checkpoints as ckpt
    from desr_tpu_torch import predict
    from desr_tpu_torch.models.main_model import NET_NAMES, MainModel, NetOptions

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
        _reset_counts()
        t0 = time.perf_counter()
        predict.main(argv)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, _counts()

    launches = dict.fromkeys(_counts(), 0)
    outs = []
    for r in range(2):
        out = os.path.join(tmp, f"out{r}")
        wall, c = serve(f"req{r}", out)
        k4 = c["K4"], c["K4 apply"]
        check(c["K1"] == LAUNCHES_PER_BATCH and c["K2"] == 0 and k4 == K4_PER_BATCH,
              f"request {r}: K1 launched {c['K1']} times, K2 {c['K2']}, K4 {k4}; want "
              f"{LAUNCHES_PER_BATCH}, 0 and {K4_PER_BATCH}")
        for k, v in c.items():
            launches[k] += v
        outs.append(_read_outputs(out, 8))
        print(f"[c] request {r}: 8 frames through predict.main in {wall:.2f} s host wall "
              f"(model build + .pth load + PNG I/O included), K1 launches {c['K1']}, K4 {k4}")
    wall, c = serve("req0", os.path.join(tmp, "out0_k2"), ["--net_args", "--pallas_conv"])
    k1, k2, k4 = c["K1"], c["K2"], (c["K4"], c["K4 apply"])
    check(k2 == LAUNCHES_PER_BATCH and k1 == 0 and k4 == K4_PALLAS_PER_BATCH,
          f"--pallas_conv request: K2 launched {k2} times, K1 {k1}, K4 {k4}; want "
          f"{LAUNCHES_PER_BATCH}, 0 and {K4_PALLAS_PER_BATCH}")
    for k, v in c.items():
        launches[k] += v
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
    _reset_counts()
    pred = model.serve_forward(batch)
    c = _counts()
    check(c["K1"] == LAUNCHES_PER_BATCH and (c["K4"], c["K4 apply"]) == K4_PER_BATCH,
          f"serve_forward: launches {c}")
    check(tuple(pred.shape) == (8, 512, 640) and bool(torch.isfinite(pred).all()),
          f"serve_forward: shape {tuple(pred.shape)} or non-finite values")
    report = _serve_checks(model, batch, "c", k2_route=True)
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
    with open(os.path.join(tmp, "report.json"), "w") as f:  # phase (m) reads its bound
        json.dump(report, f)
    return {"serve_main": launches}


def _serve_checks(model, batch, tag, k2_route):
    """serve_forward through the kernels against the same model with them
    swapped for their plain versions (and, with ``k2_route``, the K2 route):
    K1 and K2 for the plain convs, K4's moments and apply for the plain
    norms and chain tails.

    float32: the kernels differ from the plain versions by summation order
    only, and the K2 route from the fused one by where the bias and the norm
    are applied: max |d| <= 1e-3 on the tanh output in [-1, 1]. bf16: the
    kernels must sit as close to the float32 result as the plain bf16
    versions do (bf16 error itself sets the scale): mean |d| within 1.5x.
    """
    import torch

    from desr_tpu_torch.ops import conv3x3 as K
    from desr_tpu_torch.ops import instance_norm as IN

    report = {}

    def forward(dtype, plain=False, fused=True):
        model.compute_dtype = dtype
        blocks = [m for m in model.modules() if hasattr(m, "fused")]
        for m in blocks:
            m.fused = fused
        try:
            if plain:
                with mock.patch.object(K, "conv3x3_fused", K.conv3x3_fused_plain), \
                        mock.patch.object(K, "conv3x3", K.conv3x3_fused_plain), \
                        mock.patch.object(IN, "instance_norm_moments",
                                          IN.instance_norm_moments_plain), \
                        mock.patch.object(IN, "norm_apply", IN.norm_apply_plain):
                    return model.serve_forward(batch)
            return model.serve_forward(batch)
        finally:
            for m in blocks:
                m.fused = True
            model.compute_dtype = torch.bfloat16

    def mean_max(a, b):
        d = (a - b).abs()
        return float(d.mean()), float(d.max())

    routes = [("kernel (K1)", True)] + ([("K2 route", False)] if k2_route else [])
    ref32 = forward(torch.float32, plain=True)
    for label, fused in routes:
        mean, mx = mean_max(forward(torch.float32, fused=fused), ref32)
        print(f"[{tag}] serve_forward float32 {label} vs plain versions: mean |d| {mean:.3g}, "
              f"max |d| {mx:.3g} (bound 1e-3)")
        check(mx <= 1e-3, f"[{tag}] serve_forward float32 {label}: max |d| {mx:.3g} > 1e-3")
        report[f"f32_{label.split()[0]}_max_abs_diff"] = mx
    noise, _ = mean_max(forward(torch.bfloat16, plain=True), ref32)
    for label, fused in routes:
        mean, mx = mean_max(forward(torch.bfloat16, fused=fused), ref32)
        print(f"[{tag}] serve_forward bfloat16 {label} vs float32 plain: mean |d| {mean:.3g}, "
              f"max |d| {mx:.3g}; plain bf16 versions: mean |d| {noise:.3g} (bound 1.5x)")
        check(mean <= 1.5 * noise,
              f"[{tag}] serve_forward bf16 {label}: mean |d| {mean:.3g} > 1.5 x {noise:.3g}")
        report[f"bf16_{label.split()[0]}_mean_abs_diff"] = mean
    report["bf16_plain_mean_abs_diff"] = noise
    return report


def _profile(fn, iters, tag="c", unit="batch"):
    """Device time by kernel over ``iters`` calls of fn (torch.profiler,
    CUDA activity alone: the host's ops are not recorded, whose events took
    a minute to gather over stage 2's iterations on a slow host), and the
    device's busy share of the window's host wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    for short, key in (("conv3x3", "conv3x3"), ("masked_loss", "masked_loss"),
                       ("k4_moments", "moments_p"), ("k4_apply", "apply_p"),
                       ("replication_pad", "replication_pad"), ("memcpy", "Memcpy")):
        out[f"profile_{short}_ms_per_{unit}"] = sum(
            t for n, t in by_kernel.items() if key in n) / iters
    return out


# ------------------------------------------------------------------ (e)

def _write_train_domain(root, dom, seed, n=12, img_hw=None, unique=None):
    """n 480x640 frames of phase (c)'s kind, each its own scene with intrinsics;
    with ``unique``, that many are written and frame i is a hard link to
    frame i % unique."""
    import numpy as np

    folder = os.path.join(root, dom)
    _write_frames(folder, min(n, unique or n), seed=seed, img_hw=img_hw)
    for sub in ("depth", "img"):
        for i in range(unique or n, n):
            os.link(os.path.join(folder, sub, f"f{i % unique:02d}.png"),
                    os.path.join(folder, sub, f"f{i:02d}.png"))
    for i in range(n):
        kdir = os.path.join(root, "intr", f"{dom}{i:02d}", "intrinsic")
        os.makedirs(kdir, exist_ok=True)
        np.savetxt(os.path.join(kdir, "intrinsic_depth.txt"),
                   [[577.87, 0, 319.5, 0], [0, 577.87, 239.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    # the dataset takes a frame's scene from its name: A00.png -> A00
    for sub in ("depth", "img"):
        for f in os.listdir(os.path.join(folder, sub)):
            os.rename(os.path.join(folder, sub, f), os.path.join(folder, sub, dom + f[1:]))
    return folder


def _train_argv(tmp, name, extra=(), aug=False):
    """The README's stage-3 flags (README.md:103-104); ``aug`` keeps its
    augmentation (rotated 384x512 crops), else ``--no_aug`` (512x640)."""
    a, b = os.path.join(tmp, "A"), os.path.join(tmp, "B")
    return ["--model_type", "main", "--name", name, "--checkpoints_dir", tmp,
            "--do_train", "--continue_train", "--use_image_for_trans", "--use_masked",
            "--norm_loss", "--use_smooth_loss", "--batch_size", "6",
            *([] if aug else ["--no_aug"]),
            "--compute_dtype", "bfloat16", "--image_and_depth", "--use_scannet",
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
    _reset_counts()
    t0 = time.perf_counter()
    losses = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    want = {"K1": 2 * K1_PER_STEP, "K2": 0, "K3": 2 * K3_PER_STEP,
            "K3 backward": 2 * K3_BWD_PER_STEP, **_k4(K4_PER_STEP, 2)}
    check(_holds(launches, want), f"train.main: launches {launches}; want {want} over 2 steps")
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
        _reset_counts()
        model.optimize_parameters()
        g.append(float(model.metrics["G"]))
        c = _counts()
        check((c["K1"], c["K3"], c["K3 backward"], in_gad["n"])
              == (K1_PER_STEP, K3_PER_STEP, K3_BWD_PER_STEP, K1_TRANS_PER_STEP)
              and _holds(c, _k4(K4_PER_STEP)),
              f"step: launches {c} ({in_gad['n']} K1 in G_A_d)")
    for h in hooks:
        h.remove()
    check(all(np.isfinite(g)) and g[-1] < g[0], f"G over 4 steps on one batch: {g}")
    print(f"[e] G over 4 bf16 steps on one batch: {', '.join(f'{v:.5g}' for v in g)}; "
          f"K1 {K1_PER_STEP} launches a step, {K1_TRANS_PER_STEP} of them in G_A_d; K3 "
          f"{K3_PER_STEP} and its backward {K3_BWD_PER_STEP}")

    opt32 = SimpleNamespace(**{**vars(opt), "batch_size": 2})
    # the U-Nets take multiples of 128: 256x384 of the 512x640 batch
    small = {k: v[:2, :256, :384] if k[0] in "AB" else v[:2] for k, v in batch.items()
             if not k.endswith("paths")}
    small["crop_A"] = small["crop_B"] = np.array([[0, 256, 0, 384]] * 2, np.float32)
    report.update(_train_parity(MainModel, opt32, small, "e", "batch 2 at 256x384"))

    # time: bf16 step, batch 6 at 512x640, after warm-up
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(model.optimize_parameters, iters=STEP_TIMED, warmup=2)
    report["train_step_ms"] = ms
    report["train_pairs_per_s"] = 6000.0 / ms
    report["train_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    ms_fwd = cuda_ms(lambda: model.losses(model.forward_all(model._batch, True), model._batch),
                     iters=3, warmup=1)
    report["train_forward_and_losses_ms"] = ms_fwd
    print(f"[e] train step bf16, batch 6 at 512x640: {ms:.2f} ms per step, "
          f"{report['train_pairs_per_s']:.2f} pairs/s (CUDA events, {STEP_TIMED} steps "
          f"after 2); "
          f"forward + losses alone {ms_fwd:.2f} ms; peak memory "
          f"{report['train_peak_mem_gib']:.2f} GiB")
    report.update(_profile(model.optimize_parameters, iters=3, tag="e", unit="step"))

    # the README's command as it stands: no --no_aug, so rotated 384x512 crops
    for n in model.model_names:
        ckpt.save_net(model.nets[n], ckpt.net_ckpt_path(tmp, "aug", "latest", n))
    argv = _train_argv(tmp, "aug", aug=True)
    _reset_counts()
    t0 = time.perf_counter()
    losses = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    aug_launches = _counts()
    check(_holds(aug_launches, want), f"train.main (aug): launches {aug_launches}; want {want}")
    check(set(model.loss_names) <= set(losses) and all(np.isfinite(list(losses.values()))),
          f"train.main (aug) losses: {losses}")
    print(f"[e] train.main without --no_aug: 2 steps of batch 6 on rotated 384x512 crops in "
          f"{wall:.1f} s host wall; launches {aug_launches}; losses "
          + ", ".join(f"{k} {v:.4g}" for k, v in losses.items()))
    opt_aug = train_options.parse(argv, print_options=False)
    batch = next(iter(create_dataset(opt_aug, MainDataset)))
    check(batch["A_d"].shape == (6, 384, 512, 1) and batch["B_i"].shape == (6, 384, 512, 3)
          and (batch["crop_A"] == [0, 384, 0, 512]).all(),
          f"augmented batch: A_d {batch['A_d'].shape}, B_i {batch['B_i'].shape}")
    model.set_input(batch)
    _reset_counts()
    model.optimize_parameters()
    c = _counts()
    check((c["K1"], c["K3"], c["K3 backward"]) == (K1_PER_STEP, K3_PER_STEP, K3_BWD_PER_STEP)
          and _holds(c, _k4(K4_PER_STEP)), f"augmented step: launches {c}")
    check(bool(np.isfinite(float(model.metrics["G"]))), "augmented step: G not finite")
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(model.optimize_parameters, iters=STEP_TIMED, warmup=2)
    report["aug_train_step_ms"] = ms
    report["aug_train_pairs_per_s"] = 6000.0 / ms
    report["aug_train_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[e] train step bf16, batch 6 on 384x512 crops: {ms:.2f} ms per step, "
          f"{report['aug_train_pairs_per_s']:.2f} pairs/s (CUDA events, {STEP_TIMED} steps "
          f"after 2); "
          f"launches a step {c}; peak memory {report['aug_train_peak_mem_gib']:.2f} GiB")
    report.update({f"aug_{k}": v for k, v in _profile(
        model.optimize_parameters, iters=3, tag="e", unit="step").items()})
    print("[e] " + json.dumps(report))
    return {"train_main": launches, "train_main_aug": aug_launches}


def _train_parity(model_cls, opt32, small, tag, what, run=None):
    """Float32, TF32 off, on the reduced batch ``small``: one step of
    ``model_cls(opt32)`` through the kernels against the same step with both
    kernels swapped for their plain versions. ``run(model)`` takes the step
    and returns (loss terms, the nets whose gradients it left); by default
    ``compute_grads`` and the trainable nets.

    The steps run with cuDNN's deterministic algorithms. Loss terms within
    1e-4 relative. The step's gradients are ill-conditioned
    at a random init (on the CPU a 1e-7 relative perturbation of K1's outputs
    moves some weight gradients by 2e-3 of their largest entry), so the
    yardstick is the plain route's own sensitivity: the plain step again
    with K1's outputs perturbed by 1e-6 relative noise and its moments by
    1e-6 of the sums of their terms' magnitudes (sum |acc|, sum acc^2), the
    scale of the kernels' f32 summation-order differences. The plain step
    runs twice: the gap between those two, printed beside, is the floor
    under which the check cannot tell the kernels from the plain route. Per weight tensor, the
    kernel route's gap to the plain route (relative L2) must be at most
    max(1e-3, 3x that perturbation's gap). Conv biases that feed a norm have
    an exact gradient of 0 (the norm subtracts them again): each bias's gap
    is held to 1e-3 of its net's largest weight gradient, L2 over the tensor.
    """
    import torch

    from desr_tpu_torch.ops import conv3x3 as K
    from desr_tpu_torch.ops import masked_loss as K3

    model = model_cls(opt32, device="cuda", compute_dtype=torch.float32, is_train=True,
                      generator=torch.Generator().manual_seed(8))
    model.set_input(small)

    def default_run(model):
        if getattr(model, "hole_generator", None) is not None:
            model.hole_generator.manual_seed(11)
        return model.compute_grads(), model.trainable_nets

    def step():
        m, nets = (run or default_run)(model)
        return m, {f"{n}.{k}": p.grad.clone() for n in nets
                   for k, p in model.nets[n].named_parameters()}

    def plain_conv(x, w, sc, sh, pad_mode, relu, stats):
        return K.conv3x3_fused_plain(x, w, sc, sh, pad_mode, relu, stats)

    noise = torch.Generator(device="cuda").manual_seed(12)

    def jitter(t):
        return 1e-6 * torch.randn(t.shape, generator=noise, device="cuda")

    def noisy_conv(*args):
        res = plain_conv(*args)
        if not isinstance(res, tuple):
            return res * (1 + jitter(res))
        # the moments' summation-order error scales with the sum of the
        # terms' magnitudes, sum |acc| and sum acc^2, not with the sum itself
        out, s, s2 = res
        mag = out.float().abs().sum(dim=(1, 2))
        return out * (1 + jitter(out)), s + mag * jitter(s), s2 * (1 + jitter(s2))

    # cuDNN's default backward algorithms add in a run-dependent order: two
    # runs of one stage-2 step then differ by up to ~2e-3 relative L2 in the
    # median weight gradient (H100 80GB HBM3), which the check would charge
    # to the kernels; with deterministic algorithms they agree to ~3e-7
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        m_k, g_k = step()
        with mock.patch.object(K3, "_forward", K3.masked_loss_sums_plain), \
                mock.patch.object(K3, "masked_loss_grads", K3.masked_loss_grads_plain):
            with mock.patch.object(K, "_fused_forward", plain_conv):
                m_p, g_p = step()
                _, g_p2 = step()  # the plain route's run-to-run floor
            with mock.patch.object(K, "_fused_forward", noisy_conv):
                _, g_n = step()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    worst_loss = max(float((m_k[k] - m_p[k]).abs() / (m_p[k].abs() + 1e-12)) for k in m_p)
    check(all(float((m_k[k] - m_p[k]).abs()) <= 1e-4 * float(m_p[k].abs()) + 1e-7 for k in m_p),
          f"[{tag}] float32 step: a loss term off by {worst_loss:.3g} relative (bound 1e-4)")
    net_scale = {n: max(float(g.norm()) for k, g in g_p.items()
                        if k.startswith(n + ".") and not k.endswith("bias"))
                 for n in {k.split(".")[0] for k in g_p}}
    gaps, bad = {}, []
    for k in g_p:
        scale = net_scale[k.split(".")[0]] if k.endswith("bias") else float(g_p[k].norm())
        gk = float((g_k[k] - g_p[k]).norm()) / scale
        gn = float((g_n[k] - g_p[k]).norm()) / scale
        bound = 1e-3 if k.endswith("bias") else max(1e-3, 3 * gn)
        gaps[k] = (gk, gn, bound, float((g_p2[k] - g_p[k]).norm()) / scale)
        if gk > bound:
            bad.append(k)
    weights = sorted((v[0], v[1], k) for k, v in gaps.items() if not k.endswith("bias"))
    floor = sorted(v[3] for k, v in gaps.items() if not k.endswith("bias"))
    print(f"[{tag}] float32 {what}, kernels vs plain: loss terms max rel "
          f"{worst_loss:.3g} (bound 1e-4); weight grads, relative L2 gap (kernel / 1e-6 "
          f"perturbation): median {weights[len(weights) // 2][0]:.3g} / "
          f"{weights[len(weights) // 2][1]:.3g}, worst {weights[-1][0]:.3g} / "
          f"{weights[-1][1]:.3g} at {weights[-1][2]}; biases worst "
          f"{max(v[0] for k, v in gaps.items() if k.endswith('bias')):.3g} of the net's "
          "largest weight gradient (bound 1e-3)")
    print(f"[{tag}] float32 {what}, plain vs plain (the floor): weight grads median "
          f"{floor[len(floor) // 2]:.3g}, worst {floor[-1]:.3g}")
    for gk, gn, k in weights[-5:]:
        print(f"[{tag}]   {k}: kernel {gk:.3g}, perturbation {gn:.3g}")
    check(not bad, f"[{tag}] float32 step: grads off in "
          + ", ".join(f"{k} ({gaps[k][0]:.3g} > {gaps[k][2]:.3g})" for k in bad[:5]))
    return {"f32_loss_max_rel": worst_loss, "f32_weight_grad_worst_gap": weights[-1][0],
            "f32_weight_grad_median_gap": weights[len(weights) // 2][0],
            "f32_weight_grad_worst_perturbation_gap": max(w[1] for w in weights),
            "f32_weight_grad_median_floor": floor[len(floor) // 2],
            "f32_weight_grad_worst_floor": floor[-1]}


# ------------------------------------------------------------------ (f)

def phase_sr_serving(tmp):
    """SR serving: 8 synthetic 960x1280 frames (ScanNet's 480x640 at x2, the
    SR dataset's canvas) through ``predict.main --SR`` in bf16 as two requests
    of 4: padded to 1024x1280, LR guidance at 512x640."""
    import numpy as np
    import torch

    from desr_tpu_torch import checkpoints as ckpt
    from desr_tpu_torch import predict
    from desr_tpu_torch.models.main_model import NET_NAMES, NetOptions
    from desr_tpu_torch.models.main_sr_model import MainSRModel
    from desr_tpu_torch.ops.resize import resize_bicubic_planar

    for r in range(2):
        _write_frames(os.path.join(tmp, f"req{r}"), 4, seed=30 + r, hw=(960, 1280))
    model = MainSRModel(NetOptions(crop_size_h=512, crop_size_w=640), device="cuda",
                        generator=torch.Generator().manual_seed(2))
    for name in NET_NAMES:
        ckpt.save_net(model.nets[name], ckpt.net_ckpt_path(tmp, "sr", "latest", name))
    launches = {"K1": 0, "K4": 0, "K4 apply": 0}
    for r in range(2):
        out = os.path.join(tmp, f"out{r}")
        argv = ["--name", "sr", "--checkpoints_dir", tmp, "--SR",
                "--input_depth", os.path.join(tmp, f"req{r}", "depth"),
                "--input_img", os.path.join(tmp, f"req{r}", "img"), "--output", out,
                "--batch_size", "4", "--compute_dtype", "bfloat16"]
        _reset_counts()
        t0 = time.perf_counter()
        predict.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = _counts()
        k1, k2, k4 = c["K1"], c["K2"], (c["K4"], c["K4 apply"])
        check(k1 == LAUNCHES_PER_BATCH and k2 == 0 and k4 == K4_PER_BATCH,
              f"SR request {r}: K1 launched {k1} times, K2 {k2}, K4 {k4}; want "
              f"{LAUNCHES_PER_BATCH}, 0 and {K4_PER_BATCH}")
        for k in launches:
            launches[k] += c[k]
        outs = _read_outputs(out, 4, hw=(960, 1280))
        check(int(outs.max()) > 0, f"SR request {r}: an output is all zeros")
        print(f"[f] SR request {r}: 4 frames 960x1280 through predict.main --SR in {wall:.2f} s "
              f"host wall (model build + .pth load + PNG I/O included), K1 launches {k1}, K4 {k4}")

    frames = [predict.decode_frame(os.path.join(tmp, "req0", "depth", f"f{i:02d}.png"),
                                   os.path.join(tmp, "req0", "img", f"f{i:02d}.png"), 5100.0, 256)
              for i in range(4)]
    batch = {"B_d": np.stack([f[0] for f in frames]), "B_i": np.stack([f[1] for f in frames])}
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    _reset_counts()
    pred = model.serve_forward(batch)
    c = _counts()
    check(c["K1"] == LAUNCHES_PER_BATCH and (c["K4"], c["K4 apply"]) == K4_PER_BATCH,
          f"SR serve_forward: launches {c}")
    check(tuple(pred.shape) == (4, 1024, 1280) and bool(torch.isfinite(pred).all()),
          f"SR serve_forward: shape {tuple(pred.shape)} or non-finite values")
    report = _serve_checks(model, batch, "f", k2_route=False)
    ms = cuda_ms(lambda: model.serve_forward(batch), iters=5, warmup=2)
    report["sr_serve_ms_per_batch4"] = ms
    report["sr_serve_frames_per_s"] = 4000.0 / ms
    # where the device time goes: each net alone on this batch's inputs, and
    # the guidance's resizes (LR image down, features and prior up)
    nets, dt = model.nets, torch.bfloat16
    img = batch["B_i"].to(dt).permute(0, 3, 1, 2)
    lr_img = resize_bicubic_planar(img.float(), model.lr_hw).to(dt)
    feats = nets["I2D_features"](lr_img)
    dbi = nets["Image2Depth"](feats)[:, 0].float()
    feats_hr, dbi_hr = model._guidance(img)
    pair = torch.stack([batch["B_d"][..., 0].float(), dbi_hr], 1).to(dt)
    pair = pair.contiguous(memory_format=torch.channels_last)
    task_in = torch.cat([feats_hr, nets["Depth_f"](pair), pair, img], 1)
    for name, fn in (("I2D_features", lambda: nets["I2D_features"](lr_img)),
                     ("Image2Depth", lambda: nets["Image2Depth"](feats)),
                     ("resizes", lambda: (
                         resize_bicubic_planar(img.float(), model.lr_hw).to(dt),
                         resize_bicubic_planar(feats.float(), model.hr_hw).to(dt),
                         resize_bicubic_planar(dbi, model.hr_hw))),
                     ("Depth_f", lambda: nets["Depth_f"](pair)),
                     ("Task", lambda: nets["Task"](task_in))):
        report[f"net_ms_{name}"] = cuda_ms(fn, iters=5, warmup=1)
    del feats_hr, task_in
    print(f"[f] SR serve_forward bf16 batch 4 (1024x1280, LR 512x640): {ms:.2f} ms per batch, "
          f"{report['sr_serve_frames_per_s']:.2f} frames/s (CUDA events, after warm-up); "
          "per net ms: "
          + ", ".join(f"{k[7:]} {v:.2f}" for k, v in report.items() if k.startswith("net_ms_")))
    report.update(_profile(lambda: model.serve_forward(batch), iters=3, tag="f"))
    print("[f] " + json.dumps(report))
    with open(os.path.join(tmp, "report.json"), "w") as f:  # phase (m) reads its bound
        json.dump(report, f)
    return {"serve_sr": launches}


# ------------------------------------------------------------------ (g)

def _sr_train_argv(tmp, name):
    a, b = os.path.join(tmp, "A"), os.path.join(tmp, "B")
    return ["--model_type", "main", "--SR", "--name", name, "--checkpoints_dir", tmp,
            # the README's SR flags (README.md:106-108) and bench.py:62-70's losses
            "--do_train", "--continue_train", "--batch_size", "1", "--crop_size_h", "512",
            "--crop_size_w", "640", "--lr", "2e-5", "--use_image_for_trans", "--use_masked",
            "--norm_loss", "--use_smooth_loss", "--w_syn_norm", "0.05",
            "--compute_dtype", "bfloat16", "--image_and_depth", "--use_scannet",
            "--path_A", f"{a}/depth", "--A_add_paths", f"{a}/img",
            "--path_B", f"{b}/depth", "--B_add_paths", f"{b}/img",
            "--path_to_intr", os.path.join(tmp, "intr"), "--n_epochs", "1",
            "--n_epochs_decay", "0", "--print_freq", "1", "--save_epoch_freq", "1",
            "--num_threads", "0", "--max_dataset_size", "2"]


def phase_sr_training(tmp):
    """The SR train step at the README geometry: 4 synthetic 480x640 frames a
    domain through NaiveSRDataset (INTER_AREA x2, pad to 1024x1280, a crop of
    the whole canvas), batch 1, LR 512x640 -> HR 1024x1280, bf16."""
    import numpy as np
    import torch

    from desr_tpu_torch import checkpoints as ckpt
    from desr_tpu_torch import train
    from desr_tpu_torch.data.loader import create_dataset
    from desr_tpu_torch.data.sr_dataset import NaiveSRDataset
    from desr_tpu_torch.models.main_sr_model import MainSRModel
    from desr_tpu_torch.ops import conv3x3 as K
    from desr_tpu_torch.options import train_options

    report = {}
    _write_train_domain(tmp, "A", seed=40, n=4)
    _write_train_domain(tmp, "B", seed=50, n=4)
    argv = _sr_train_argv(tmp, "srtrain")
    opt = train_options.parse(argv, print_options=False)
    model = MainSRModel(opt, device="cuda", compute_dtype=torch.bfloat16, is_train=True,
                        generator=torch.Generator().manual_seed(9))
    for n in model.model_names:
        ckpt.save_net(model.nets[n], ckpt.net_ckpt_path(tmp, "srtrain", "latest", n))
    before = _state(model, model.model_names)

    # the CLI, in-process: --max_dataset_size 2 at batch 1 = 2 steps
    _reset_counts()
    t0 = time.perf_counter()
    losses = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    want = {"K1": 2 * SR_K1_PER_STEP, "K2": 0, "K3": 2 * K3_PER_STEP,
            "K3 backward": 2 * K3_BWD_PER_STEP, **_k4(K4_PER_STEP, 2)}
    check(_holds(launches, want), f"train.main --SR: launches {launches}; want {want} over 2 steps")
    check(set(model.loss_names) <= set(losses) and all(np.isfinite(list(losses.values()))),
          f"train.main --SR losses: {losses}")
    print(f"[g] train.main --SR: 2 steps of batch 1 (HR 1024x1280) in {wall:.1f} s host wall "
          f"(model build, .pth load, PNG decode and INTER_AREA resize, checkpoint writes "
          f"included); launches {launches}; losses "
          + ", ".join(f"{k} {v:.4g}" for k, v in losses.items()))
    trained = MainSRModel(opt, device="cuda", is_train=True)
    trained.load_networks(tmp, "srtrain", "latest", verbose=False)
    after = _state(trained, model.model_names)
    for n in model.model_names:
        same = all(torch.equal(after[n][k], before[n][k]) for k in before[n])
        check(same == (n not in model.trainable_nets),
              f"SR {n}: weights {'unchanged' if same else 'changed'} after training")
    print("[g] after train.main --SR: G_A_d, I2D_features, Image2Depth bit-equal to their "
          ".pth files; Depth_f and Task moved")
    del trained

    batch = next(iter(create_dataset(opt, NaiveSRDataset)))
    check(batch["A_d"].shape == (1, 1024, 1280, 1) and batch["B_i"].shape == (1, 1024, 1280, 3),
          f"NaiveSRDataset batch: A_d {batch['A_d'].shape}, B_i {batch['B_i'].shape}")
    model.set_input(batch)
    in_gad = {"start": 0, "n": 0}
    gad = model.nets["G_A_d"]
    hooks = (gad.register_forward_pre_hook(
                 lambda m, i: in_gad.update(start=K.conv3x3_fused.launches)),
             gad.register_forward_hook(
                 lambda m, i, o: in_gad.update(n=K.conv3x3_fused.launches - in_gad["start"])))
    g = []
    for _ in range(4):
        _reset_counts()
        model.optimize_parameters()
        g.append(float(model.metrics["G"]))
        c = _counts()
        check((c["K1"], c["K3"], c["K3 backward"], in_gad["n"])
              == (SR_K1_PER_STEP, K3_PER_STEP, K3_BWD_PER_STEP, K1_TRANS_PER_STEP),
              f"SR step: launches {c} ({in_gad['n']} K1 in G_A_d)")
    for h in hooks:
        h.remove()
    check(all(np.isfinite(g)) and g[-1] < g[0], f"SR G over 4 steps on one batch: {g}")
    print(f"[g] G over 4 bf16 SR steps on one batch: {', '.join(f'{v:.5g}' for v in g)}; "
          f"K1 {SR_K1_PER_STEP} launches a step, {K1_TRANS_PER_STEP} of them in G_A_d; K3 "
          f"{K3_PER_STEP} and its backward {K3_BWD_PER_STEP}")

    # float32 kernels vs plain at HR 256x256 (LR 128x128: the U-Nets' /128)
    opt32 = SimpleNamespace(**{**vars(opt), "crop_size_h": 128, "crop_size_w": 128})
    small = {k: v[:, :256, :256] if k[0] in "AB" else v for k, v in batch.items()
             if not k.endswith("paths")}
    small["crop_A"] = np.array([[0, 256, 0, 256]], np.float32)
    small["crop_B"] = np.array([[0, 128, 0, 128]], np.float32)
    report.update({f"sr_{k}": v for k, v in _train_parity(
        MainSRModel, opt32, small, "g", "batch 1 at HR 256x256").items()})

    # --use_rec_as_real_input: the frozen random-init G_B_d and G_A_d again
    rec = MainSRModel(SimpleNamespace(**{**vars(opt), "use_rec_as_real_input": True}),
                      device="cuda", compute_dtype=torch.bfloat16, is_train=True,
                      generator=torch.Generator().manual_seed(10))
    rec.set_input(batch)
    gbd = _state(rec, ["G_B_d"])["G_B_d"]
    _reset_counts()
    rec.optimize_parameters()
    c = _counts()
    k1, k3 = c["K1"], c["K3"]
    check((k1, k3, c["K3 backward"]) == (SR_K1_REC_PER_STEP, K3_PER_STEP, K3_BWD_PER_STEP),
          f"--use_rec_as_real_input step: launches {c}; want K1 {SR_K1_REC_PER_STEP}, K3 "
          f"{K3_PER_STEP}, K3 backward {K3_BWD_PER_STEP}")
    check(all(torch.equal(v, gbd[k]) for k, v in rec.nets["G_B_d"].state_dict().items()),
          "--use_rec_as_real_input: G_B_d changed")
    check(bool(np.isfinite(float(rec.metrics["G"]))), "--use_rec_as_real_input: G not finite")
    print(f"[g] --use_rec_as_real_input step: K1 {k1} launches, K3 {k3}, G "
          f"{float(rec.metrics['G']):.5g}, G_B_d bit-equal after the step")
    del rec

    # time: bf16 step, batch 1 at LR 512x640 -> HR 1024x1280, after warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(model.optimize_parameters, iters=STEP_TIMED, warmup=2)
    report["sr_train_step_ms"] = ms
    report["sr_train_pairs_per_s"] = 1000.0 / ms
    report["sr_train_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    ms_fwd = cuda_ms(lambda: model.losses(model.forward_all(model._batch, True), model._batch),
                     iters=3, warmup=1)
    report["sr_train_forward_and_losses_ms"] = ms_fwd
    print(f"[g] SR train step bf16, batch 1, LR 512x640 -> HR 1024x1280: {ms:.2f} ms per step, "
          f"{report['sr_train_pairs_per_s']:.3f} pairs/s (CUDA events, {STEP_TIMED} steps "
          f"after 2); "
          f"forward + losses alone {ms_fwd:.2f} ms; peak memory "
          f"{report['sr_train_peak_mem_gib']:.2f} GiB")
    report.update(_profile(model.optimize_parameters, iters=3, tag="g", unit="step"))
    print("[g] " + json.dumps(report))
    return {"train_sr": launches}


# ------------------------------------------------------------------ (h)

def _serve_cli(tmp, name, req, out, mode, batch_size=8):
    """predict.main on one request folder in bf16; (host wall s, launches)."""
    import torch

    from desr_tpu_torch import predict

    argv = ["--name", name, "--checkpoints_dir", tmp, *mode,
            "--input_img", os.path.join(tmp, req, "img"), "--output", out,
            "--batch_size", str(batch_size), "--compute_dtype", "bfloat16"]
    _reset_counts()
    t0 = time.perf_counter()
    predict.main(argv)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, _counts()


def _net_times(report, fns):
    """Each net alone on one batch's inputs (CUDA events), into ``report``."""
    for name, fn in fns:
        report[f"net_ms_{name}"] = cuda_ms(fn, iters=5, warmup=1)
    return ", ".join(f"{k[7:]} {v:.2f}" for k, v in report.items() if k.startswith("net_ms_"))


def phase_i2d_serving(tmp):
    """Stage-1 serving: 8 synthetic 480x640 frames through ``predict.main
    --I2D`` (RGB only, padded to 512x640) in bf16, seeded random weights at
    the default widths (Image_f ngf 32 -> 16 features, Task ngf 64)."""
    import numpy as np
    import torch

    from desr_tpu_torch import checkpoints as ckpt
    from desr_tpu_torch import predict
    from desr_tpu_torch.models.i2d_model import I2DModel
    from desr_tpu_torch.models.main_model import NetOptions

    _write_frames(os.path.join(tmp, "req"), 8, seed=60)
    model = I2DModel(NetOptions(), device="cuda", generator=torch.Generator().manual_seed(3))
    for name in model.model_names:
        ckpt.save_net(model.nets[name], ckpt.net_ckpt_path(tmp, "i2d", "latest", name))
    out = os.path.join(tmp, "out")
    wall, launches = _serve_cli(tmp, "i2d", "req", out, ["--I2D"])
    check(_holds(launches, {"K1": I2D_K1_PER_BATCH, "K2": 0, "K3": 0,
                           "K3 backward": 0, **_k4(I2D_K4_PER_BATCH)}),
          f"predict --I2D: launches {launches}; want K1 {I2D_K1_PER_BATCH}, K4 "
          f"{I2D_K4_PER_BATCH} a batch")
    outs = _read_outputs(out, 8)
    check(int(outs.max()) > 0, "predict --I2D: an output is all zeros")
    print(f"[h] predict --I2D: 8 frames 480x640 (RGB only) in {wall:.2f} s host wall (model "
          f"build + .pth load + PNG I/O included), launches {launches}")

    frames = [predict.decode_frame(None, os.path.join(tmp, "req", "img", f"f{i:02d}.png"),
                                   5100.0) for i in range(8)]
    batch = {"B_i": torch.from_numpy(np.stack([f[1] for f in frames])).cuda()}
    _reset_counts()
    pred = model.serve_forward(batch)
    check(_counts()["K1"] == I2D_K1_PER_BATCH, f"I2D serve_forward: {_counts()}")
    check(tuple(pred.shape) == (8, 512, 640) and bool(torch.isfinite(pred).all()),
          f"I2D serve_forward: shape {tuple(pred.shape)} or non-finite values")
    report = _serve_checks(model, batch, "h", k2_route=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: model.serve_forward(batch), iters=5, warmup=2)
    report["i2d_serve_ms_per_batch8"] = ms
    report["i2d_serve_frames_per_s"] = 8000.0 / ms
    report["i2d_serve_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    img = batch["B_i"].to(torch.bfloat16).permute(0, 3, 1, 2)
    feats = model.nets["Image_f"](img)
    per_net = _net_times(report, (("Image_f", lambda: model.nets["Image_f"](img)),
                                       ("Task", lambda: model.nets["Task"](feats))))
    print(f"[h] I2D serve_forward bf16 batch 8 (512x640): {ms:.2f} ms per batch, "
          f"{report['i2d_serve_frames_per_s']:.1f} frames/s (CUDA events, after warm-up); "
          f"peak memory {report['i2d_serve_peak_mem_gib']:.2f} GiB; per net ms: {per_net}")
    report.update(_profile(lambda: model.serve_forward(batch), iters=3, tag="h"))
    print("[h] " + json.dumps(report))
    return {"serve_i2d": launches}


# ------------------------------------------------------------------ (i)

def phase_translate_serving(tmp):
    """Stage-2 serving: 8 synthetic 480x640 RGB-D frames through
    ``predict.main --translate AtoB`` (G_A) and ``BtoA`` (G_B), bf16, padded
    to 512x640; the hardcoded translator widths, seeded random weights."""
    import numpy as np
    import torch

    from desr_tpu_torch import checkpoints as ckpt
    from desr_tpu_torch import predict
    from desr_tpu_torch.models.main_model import NetOptions
    from desr_tpu_torch.models.translation_model import TranslationModel

    _write_frames(os.path.join(tmp, "req"), 8, seed=70)
    model = TranslationModel(NetOptions(), device="cuda",
                             generator=torch.Generator().manual_seed(4))
    for name in model.model_names:
        ckpt.save_net(model.nets[name], ckpt.net_ckpt_path(tmp, "tr", "latest", name))
    paths, outs = {}, {}
    for direction in ("AtoB", "BtoA"):
        out = os.path.join(tmp, f"out_{direction}")
        wall, launches = _serve_cli(tmp, "tr", "req", out,
                                    ["--translate", direction, "--input_depth",
                                     os.path.join(tmp, "req", "depth")])
        check(_holds(launches, {"K1": TRANSLATE_K1_PER_BATCH, "K2": 0, "K3": 0,
                                "K3 backward": 0, **_k4(TRANSLATE_K4_PER_BATCH)}),
              f"predict --translate {direction}: launches {launches}; want K1 "
              f"{TRANSLATE_K1_PER_BATCH}, K4 {TRANSLATE_K4_PER_BATCH} a batch")
        outs[direction] = _read_outputs(out, 8)
        check(int(outs[direction].max()) > 0, f"--translate {direction}: all zeros")
        paths[f"serve_translate_{direction}"] = launches
        print(f"[i] predict --translate {direction}: 8 frames 480x640 in {wall:.2f} s host wall "
              f"(model build + .pth load + PNG I/O included), launches {launches}")
    check(bool((outs["AtoB"] != outs["BtoA"]).any()), "AtoB and BtoA wrote the same PNGs")

    frames = [predict.decode_frame(os.path.join(tmp, "req", "depth", f"f{i:02d}.png"),
                                   os.path.join(tmp, "req", "img", f"f{i:02d}.png"), 5100.0)
              for i in range(8)]
    batch = {"B_d": np.stack([f[0] for f in frames]), "B_i": np.stack([f[1] for f in frames])}
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    report = {}
    for direction in ("AtoB", "BtoA"):
        model.direction = direction
        _reset_counts()
        pred = model.serve_forward(batch)
        check(_counts()["K1"] == TRANSLATE_K1_PER_BATCH, f"{direction} forward: {_counts()}")
        check(tuple(pred.shape) == (8, 512, 640) and bool(torch.isfinite(pred).all()),
              f"{direction} forward: shape {tuple(pred.shape)} or non-finite values")
        report.update({f"{direction}_{k}": v for k, v in
                       _serve_checks(model, batch, "i", k2_route=False).items()})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: model.serve_forward(batch), iters=5, warmup=2)
        report[f"{direction}_serve_ms_per_batch8"] = ms
        report[f"{direction}_serve_frames_per_s"] = 8000.0 / ms
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        report[f"{direction}_serve_peak_mem_gib"] = peak
        print(f"[i] --translate {direction} serve_forward bf16 batch 8 (512x640): {ms:.2f} ms "
              f"per batch, {8000.0 / ms:.1f} frames/s (CUDA events, after warm-up); peak "
              f"memory {peak:.2f} GiB")
    g = model.nets["G_A"]
    dt = torch.bfloat16
    depth = batch["B_d"].to(dt).permute(0, 3, 1, 2)
    img = batch["B_i"].to(dt).permute(0, 3, 1, 2)
    x = torch.cat([g.enc_depth(depth), g.enc_img(img)], 1)
    mid = g.bottlenec(x)
    per_net = _net_times(report, (
        ("encoders", lambda: (g.enc_depth(depth), g.enc_img(img))),
        ("bottleneck", lambda: g.bottlenec(x)), ("decoder", lambda: g.dec_depth(mid))))
    print(f"[i] G_A's parts ms: {per_net}")
    model.direction = "AtoB"
    report.update(_profile(lambda: model.serve_forward(batch), iters=3, tag="i"))
    print("[i] " + json.dumps(report))
    return paths


# ------------------------------------------------------------------ (j)

def _i2d_train_argv(tmp, name, extra=()):
    a, b = os.path.join(tmp, "A"), os.path.join(tmp, "B")
    return ["--model_type", "I2D", "--name", name, "--checkpoints_dir", tmp,
            # the README's stage-1 flags (README.md:90-93), epochs cut, plus --use_D
            "--do_train", "--image_and_depth", "--use_scannet", "--batch_size", "12",
            "--lr", "2e-4", "--use_D", "--continue_train", "--compute_dtype", "bfloat16",
            "--path_A", f"{a}/depth", "--A_add_paths", f"{a}/img",
            "--path_B", f"{b}/depth", "--B_add_paths", f"{b}/img", "--n_epochs", "1",
            "--n_epochs_decay", "0", "--print_freq", "12", "--save_epoch_freq", "1",
            "--num_threads", "0", *extra]


def phase_i2d_training(tmp):
    """The stage-1 train step at the README geometry: 24 synthetic 480x640
    frames a domain through I2DDataset (ColorJitter, rotate, 384x512 crops),
    batch 12 (2B = 24 through Image_f), lr 2e-4, --use_D, bf16."""
    import numpy as np
    import torch

    from desr_tpu_torch import checkpoints as ckpt
    from desr_tpu_torch import train
    from desr_tpu_torch.data.i2d_dataset import I2DDataset
    from desr_tpu_torch.data.loader import create_dataset
    from desr_tpu_torch.models.i2d_model import I2DModel
    from desr_tpu_torch.options import train_options

    report = {}
    _write_frames(os.path.join(tmp, "A"), 24, seed=80)
    _write_frames(os.path.join(tmp, "B"), 24, seed=90)
    argv = _i2d_train_argv(tmp, "i2d")
    opt = train_options.parse(argv, print_options=False)
    model = I2DModel(opt, device="cuda", compute_dtype=torch.bfloat16, is_train=True,
                     generator=torch.Generator().manual_seed(5))
    for n in model.model_names:
        ckpt.save_net(model.nets[n], ckpt.net_ckpt_path(tmp, "i2d", "latest", n))
    before = _state(model, model.model_names)
    print(f"[j] {sum(p.numel() for p in model.parameters())} parameters over "
          f"{len(model.model_names)} nets at the default widths; G trains "
          f"{model.trainable_nets}, D_depth its own Adam")

    # the CLI, in-process: 24 pairs at batch 12 = 2 steps
    _reset_counts()
    t0 = time.perf_counter()
    losses = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    want = {"K1": 2 * I2D_K1_PER_STEP, "K2": 0, "K3": 0, "K3 backward": 0,
            **_k4(I2D_K4_PER_STEP, 2)}
    check(_holds(launches, want), f"train.main I2D: launches {launches}; want {want} over 2 steps")
    check(set(model.loss_names) <= set(losses) and all(np.isfinite(list(losses.values()))),
          f"train.main I2D losses: {losses}")
    print(f"[j] train.main --model_type I2D --use_D: 2 steps of batch 12 in {wall:.1f} s host "
          f"wall (model build, .pth load, PNG decode, jitter and rotate, checkpoint writes "
          f"included); launches {launches}; losses "
          + ", ".join(f"{k} {v:.4g}" for k, v in losses.items()))
    trained = I2DModel(opt, device="cuda", is_train=True)
    trained.load_networks(tmp, "i2d", "latest", verbose=False)
    after = _state(trained, model.model_names)
    for n in model.model_names:
        same = all(torch.equal(after[n][k], before[n][k]) for k in before[n])
        check(same == (n == "Image_f"), f"I2D {n}: weights {'unchanged' if same else 'changed'}")
    print("[j] after train.main: Image_f bit-equal to its .pth file (the Task-only "
          "optimizer); Task and D_depth moved")
    del trained

    batch = next(iter(create_dataset(opt, I2DDataset)))
    check(batch["A_i"].shape == (12, 384, 512, 3) and batch["B_d"].shape == (12, 384, 512, 1),
          f"I2DDataset batch: A_i {batch['A_i'].shape}, B_d {batch['B_d'].shape}")
    model.set_input(batch)
    _reset_counts()
    model.optimize_parameters(12, 1)
    c = _counts()
    check(c["K1"] == I2D_K1_PER_STEP and "D_depth" in model.metrics,
          f"I2D step: launches {c}, metrics {sorted(model.metrics)}")

    # --i2d_train_features: K1's backward runs and Image_f moves
    opt_f = train_options.parse(argv + ["--i2d_train_features"], print_options=False)
    feat = I2DModel(opt_f, device="cuda", compute_dtype=torch.bfloat16, is_train=True,
                    generator=torch.Generator().manual_seed(6))
    feat.set_input(batch)
    init = _state(feat, ["Image_f"])["Image_f"]
    _reset_counts()
    feat.compute_grads()
    block_w = [p for k, p in feat.nets["Image_f"].named_parameters() if ".conv_block." in k
               and k.endswith("weight")]
    check(len(block_w) == I2D_K1_PER_STEP and all(
        p.grad is not None and float(p.grad.abs().max()) > 0 for p in block_w),
          "--i2d_train_features: a ResnetBlock conv of Image_f got no gradient")
    feat.optimizer.step()
    moved = [k for k, v in feat.nets["Image_f"].state_dict().items() if not torch.equal(v, init[k])]
    check(len(moved) > 0 and _counts()["K1"] == I2D_K1_PER_STEP,
          f"--i2d_train_features: Image_f moved in {len(moved)} tensors; launches {_counts()}")
    print(f"[j] --i2d_train_features step: K1 {I2D_K1_PER_STEP} forward launches, all "
          f"{len(block_w)} ResnetBlock conv weights of Image_f got gradients through K1's "
          f"backward; {len(moved)} Image_f tensors moved")
    del feat

    # float32, kernels against their plain versions, at batch 2 (2B = 4)
    # with the adversarial term into Image_f
    opt32 = SimpleNamespace(**{**vars(opt_f), "batch_size": 2})
    small = {k: v[:2] for k, v in batch.items() if not k.endswith("paths")}
    report.update(_train_parity(I2DModel, opt32, small, "j",
                                "I2D batch 2 at 384x512, --use_D --i2d_train_features"))

    # time: bf16 step with the D step, batch 12 at 384x512, after warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: model.optimize_parameters(12, 1), iters=STEP_TIMED, warmup=2)
    report["i2d_train_step_ms"] = ms
    report["i2d_train_pairs_per_s"] = 12000.0 / ms
    report["i2d_train_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    ms_g = cuda_ms(lambda: (model.compute_grads(), model.optimizer.step()), iters=5, warmup=1)
    report["i2d_train_g_step_ms"] = ms_g
    print(f"[j] I2D train step bf16 with the D step, batch 12 at 384x512: {ms:.2f} ms per "
          f"step, {report['i2d_train_pairs_per_s']:.2f} pairs/s (CUDA events, {STEP_TIMED} "
          f"steps after 2); the G step alone {ms_g:.2f} ms; peak memory "
          f"{report['i2d_train_peak_mem_gib']:.2f} GiB")
    report.update(_profile(lambda: model.optimize_parameters(12, 1), iters=3, tag="j",
                           unit="step"))
    print("[j] " + json.dumps(report))
    return {"train_i2d": launches}


# ------------------------------------------------------------------ (k)

def _translation_argv(tmp, name, extra=()):
    """The README's stage-2 flags (README.md:97-99), epochs cut."""
    return ["--model_type", "translation", "--name", name, "--checkpoints_dir", tmp,
            "--dataroot", tmp, "--do_train", "--batch_size", "6", "--crop_size_h", "256",
            "--crop_size_w", "256", "--max_distance", "5100", "--compute_dtype", "bfloat16",
            "--n_epochs", "1", "--n_epochs_decay", "0", "--print_freq", "6",
            "--save_epoch_freq", "1", "--num_threads", "0", *extra]


def _translation_run(model):
    """One G step's gradients, then the D step's on its feed (the grads of
    both are left on the nets): the terms of both, and the nets."""
    m, feed = model.compute_grads()
    m.update(model.d_grads(feed))
    return m, model.trainable_nets + model.disc_names


def phase_translation_training(tmp):
    """Stage-2 training at the README geometry: 12 synthetic 480x640 frames a
    domain through TranslationDataset (Lanczos to 320x320, 256x256 crops),
    batch 6, --max_distance 5100, bf16; the hardcoded translators (32+32
    channels, 9 ResnetBlockT at 256) and the four basic Ds at ndf 64."""
    import numpy as np
    import torch

    from desr_tpu_torch import train
    from desr_tpu_torch.data.loader import create_dataset
    from desr_tpu_torch.data.translation_dataset import TranslationDataset
    from desr_tpu_torch.models.translation_model import TranslationModel
    from desr_tpu_torch.options import train_options

    report = {}
    for dom, seed in (("A", 100), ("B", 110)):
        _write_frames(os.path.join(tmp, f"train{dom}"), 12, seed=seed)
    argv = _translation_argv(tmp, "tr2")

    # the CLI, in-process: 12 pairs at batch 6 = 2 iterations
    _reset_counts()
    t0 = time.perf_counter()
    losses = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    want = {"K1": 2 * STAGE2_K1_PER_ITER, "K2": 0, "K3": 0, "K3 backward": 0,
            **_k4((0, 0))}
    check(_holds(launches, want), f"train.main translation: launches {launches}; want {want}")
    check(all(np.isfinite(list(losses.values()))), f"train.main translation losses: {losses}")
    names = ("G_A", "G_B", "D_A_depth", "D_B_depth", "D_A_normal", "D_B_normal")
    files = [os.path.join(tmp, "tr2", f"latest_net_{n}.pth") for n in names]
    check(all(os.path.exists(f) for f in files), "train.main translation: a .pth file is missing")
    print(f"[k] train.main --model_type translation: 2 iterations of batch 6 in {wall:.1f} s host "
          f"wall (model build, PNG decode, Lanczos, checkpoint writes included); launches "
          f"{launches}; the six latest_net_*.pth written; losses "
          + ", ".join(f"{k} {v:.4g}" for k, v in losses.items()))

    # serve the trained G_A from those files
    paths = {"train_translation": launches}
    out = os.path.join(tmp, "out")
    swall, slaunch = _serve_cli(tmp, "tr2", "trainA", out,
                                ["--translate", "AtoB", "--input_depth",
                                 os.path.join(tmp, "trainA", "depth")], batch_size=6)
    check(_holds(slaunch, {"K1": 2 * TRANSLATE_K1_PER_BATCH, "K2": 0, "K3": 0,
                           "K3 backward": 0, **_k4(TRANSLATE_K4_PER_BATCH, 2)}),
          f"predict --translate from the trained G_A: launches {slaunch}")
    check(int(_read_outputs(out, 12).max()) > 0, "predict from the trained G_A: all zeros")
    paths["serve_translate_trained"] = slaunch
    print(f"[k] predict --translate AtoB from the trained latest_net_G_A.pth: 12 frames in two "
          f"batches of 6 in {swall:.2f} s host wall; launches {slaunch}")

    # model level: K1 launches per iteration, finite terms, every net moved
    opt = train_options.parse(argv, print_options=False)
    model = TranslationModel(opt, device="cuda", compute_dtype=torch.bfloat16, is_train=True,
                             generator=torch.Generator().manual_seed(9))
    batch = next(iter(create_dataset(opt, TranslationDataset)))
    check(batch["A_depth"].shape == (6, 256, 256, 1) and batch["B_img"].shape == (6, 256, 256, 3),
          f"TranslationDataset batch: A_depth {batch['A_depth'].shape}")
    model.set_input(batch)
    before = _state(model, model.model_names)
    _reset_counts()
    model.optimize_parameters()
    c = _counts()
    check(c["K1"] == STAGE2_K1_PER_ITER and c["K3"] == 0,
          f"stage-2 iteration: launches {c}; want K1 {STAGE2_K1_PER_ITER}")
    check(all(bool(torch.isfinite(v).all()) for v in model.metrics.values()),
          f"stage-2 iteration: terms {model.metrics}")
    after = _state(model, model.model_names)
    moved = [n for n in model.model_names
             if any(not torch.equal(after[n][k], before[n][k]) for k in before[n])]
    check(moved == list(model.model_names), f"stage-2 iteration: only {moved} moved")
    print(f"[k] one iteration (3 G steps, 1 D step): K1 {c['K1']} launches "
          f"({c['K1'] // 12} a G apply, 4 applies a G step); all six nets moved; terms "
          + ", ".join(f"{k} {float(v):.4g}" for k, v in model.metrics.items()))

    # float32, kernels against their plain versions: a G step and a D step at batch 2
    opt32 = SimpleNamespace(**{**vars(opt), "batch_size": 2})
    small = {k: v[:2] for k, v in batch.items() if not k.endswith("name")}
    report.update(_train_parity(TranslationModel, opt32, small, "k",
                                "stage 2 batch 2 at 256x256, a G step and a D step",
                                run=_translation_run))

    # time: bf16 iteration at batch 6, and its G and D steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(model.optimize_parameters, iters=STEP_TIMED, warmup=2)
    report["stage2_iter_ms"] = ms
    report["stage2_pairs_per_s"] = 6000.0 / ms
    report["stage2_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    feed = {}

    def g_step():
        feed.update(model.compute_grads()[1])
        model.optimizer.step()

    report["stage2_g_step_ms"] = cuda_ms(g_step, iters=5, warmup=1)
    report["stage2_d_step_ms"] = cuda_ms(lambda: (model.d_grads(feed), model.optimizer_D.step()),
                                         iters=5, warmup=1)
    print(f"[k] stage-2 iteration bf16, batch 6 at 256x256: {ms:.2f} ms per iteration, "
          f"{report['stage2_pairs_per_s']:.2f} pairs/s (CUDA events, {STEP_TIMED} iterations "
          f"after 2); "
          f"a G step {report['stage2_g_step_ms']:.2f} ms, a D step "
          f"{report['stage2_d_step_ms']:.2f} ms; peak memory "
          f"{report['stage2_peak_mem_gib']:.2f} GiB")
    prof = _profile(model.optimize_parameters, iters=3, tag="k", unit="iteration")
    report.update(prof)
    if prof.get("profile_device_ms_per_iteration"):
        report["stage2_replication_pad_share"] = (
            prof["profile_replication_pad_ms_per_iteration"]
            / prof["profile_device_ms_per_iteration"])
        print(f"[k] replication_pad kernels, forward and backward (K1's backward pads its "
              f"recomputed input and takes the pad's adjoint; the encoders' and head's "
              f"replicate convs copy theirs): {prof['profile_replication_pad_ms_per_iteration']:.2f}"
              f" ms per iteration, {100 * report['stage2_replication_pad_share']:.1f}% of device "
              "time")
    del model

    # one untimed iteration each: BatchNorm Ds, spectral-norm Ds, a depth-only G_B
    for extra, what in ((["--netD", "Gu"], "--netD Gu"), (["--use_spnorm"], "--use_spnorm"),
                        (["--inp_B", "depth"], "--inp_B depth")):
        opt_x = train_options.parse(argv + extra, print_options=False)
        m = TranslationModel(opt_x, device="cuda", compute_dtype=torch.bfloat16, is_train=True,
                             generator=torch.Generator().manual_seed(10))
        m.set_input(batch)
        _reset_counts()
        m.optimize_parameters()
        c = _counts()
        check(c["K1"] == STAGE2_K1_PER_ITER and all(
            bool(torch.isfinite(v).all()) for v in m.metrics.values()),
              f"{what} iteration: launches {c}, terms {m.metrics}")
        note = ""
        if "--netD" in extra:
            tracked = {int(v) for n in m.disc_names for k, v in m.nets[n].state_dict().items()
                       if k.endswith("num_batches_tracked")}
            check(tracked == {opt_x.num_iter_gen + 2},
                  f"--netD Gu: BatchNorm counted {tracked} batches, want 3 G applies + 2")
            note = f"; each BatchNorm counted {tracked.pop()} batches (3 G steps, real, fake)"
        print(f"[k] {what}: one iteration, K1 {c['K1']}, terms finite{note}")
        del m
    print("[k] " + json.dumps(report))
    return paths


# ------------------------------------------------------------------ (l)

ROT_TOL = 2e-3              # the three-shear warp's bound (tests/test_device_aug.py:22)
FED_WORKERS = 4             # the loader's default --num_threads
# the fed loop: the loader keeps 2 batches a worker in flight (DataLoader's
# default prefetch_factor), all queued when the epoch starts; the timed and
# profiled windows open after those, each a whole number of rounds of the
# workers, and close before the epoch's last 2 * FED_WORKERS batches, whose
# indices are all handed out at once: a worker then runs its last two
# batches back to back, faster than mid-epoch, where it waits on the
# in-order consumer for its next index
FED_WARM = 2 * FED_WORKERS
FED_TIMED, FED_PROFILED = FED_WORKERS, FED_WORKERS
FED_STEPS = FED_WARM + FED_TIMED + FED_PROFILED + FED_WARM
FED_HOST_STEPS = FED_STEPS - FED_PROFILED  # the host augmentation's runs: no profiled window
FED_UNIQUE = 4              # frames written a domain (~0.7 s each); the rest are hard links
FED_SR_UNIQUE = 1           # SR's 968x1296 colour frames written a domain
JIT_BOUNDS = (10.0, 1e-4, 2e-3)  # ColorJitter, 0-255 scale: max, share above 1, above 1e-3


def _aug_parity(tag, ds, n):
    """One host batch of n items of ``ds`` (a --device_aug dataset) through
    its device_finish to the CPU and to the card; the upload from pinned
    memory alone and device_finish (upload and augmenter) by CUDA events, and
    device_finish's device time by the profiler, copies apart. Returns the
    report, the gaps, the two outputs and the batch."""
    import torch

    from desr_tpu_torch.data.loader import collate_tensors, to_device

    batch = collate_tensors([ds[i] for i in range(n)])
    cpu = ds.device_finish(batch, "cpu")
    pinned = {k: v.pin_memory() if torch.is_tensor(v) else v for k, v in batch.items()}
    card = ds.device_finish(pinned, "cuda")
    torch.cuda.synchronize()
    keys = ("A_i", "A_d", "B_i", "B_d")
    for k in keys:
        check(card[k].is_cuda and card[k].shape == cpu[k].shape,
              f"[{tag}] device_finish {k}: {card[k].device} {tuple(card[k].shape)}")
    gaps = {k: (card[k].cpu() - cpu[k]).abs() for k in keys}
    rep = {"upload_ms": cuda_ms(lambda: to_device(pinned, "cuda"), iters=10, warmup=2),
           "finish_event_ms": cuda_ms(lambda: ds.device_finish(pinned, "cuda"), iters=10,
                                      warmup=2)}
    prof = _profile(lambda: ds.device_finish(pinned, "cuda"), iters=5, tag="l", unit="batch")
    total = prof["profile_device_ms_per_batch"]
    rep["augment_device_ms"] = (None if total is None
                                else total - prof["profile_memcpy_ms_per_batch"])
    rep["host_bytes"] = sum(v.numel() * v.element_size() for v in batch.values()
                            if torch.is_tensor(v))
    rep["max_abs_gap"] = {k: float(g.max()) for k, g in gaps.items()}
    return rep, gaps, cpu, card, batch


def _fed_run(argv, model_cls, profiled=True):
    """train.main(argv) for FED_STEPS steps (FED_HOST_STEPS without
    ``profiled``), ``optimize_parameters`` wrapped: a sync and a host
    timestamp after step FED_WARM, after FED_TIMED more and, if ``profiled``,
    after FED_PROFILED more; those FED_PROFILED steps under torch.profiler
    (CUDA activity: kernels and copies) for the card's busy share. Inside the
    timed window, without syncs: the host time spent inside the steps (the
    rest of the wall is the wait for the loader, ``device_finish`` and
    ``set_input``), and a host timestamp after each round of FED_WORKERS
    steps, whose spread shows how steady the window was. TF32 as the train
    CLI leaves it: PyTorch's defaults (cuDNN's convolutions on, matmul
    off)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from desr_tpu_torch import train

    orig = model_cls.optimize_parameters
    n_prof = FED_PROFILED if profiled else 0
    marks = (FED_WARM, FED_WARM + FED_TIMED, FED_WARM + FED_TIMED + n_prof)
    steps = marks[2] + FED_WARM
    st = {"n": 0, "in_step": 0.0}

    def step(self, *a, **k):
        t_in = time.perf_counter()
        out = orig(self, *a, **k)
        st["n"] += 1
        if marks[0] < st["n"] <= marks[1]:
            st["in_step"] += time.perf_counter() - t_in
            if st["n"] < marks[1] and (st["n"] - marks[0]) % FED_WORKERS == 0:
                st[st["n"]] = time.perf_counter()
        if st["n"] in marks:
            torch.cuda.synchronize()
            st[st["n"]] = time.perf_counter()
            if profiled and st["n"] == marks[1]:
                st["prof"] = profile(activities=[ProfilerActivity.CUDA])
                st["prof"].start()
            elif profiled and st["n"] == marks[2]:
                st["prof"].stop()
        return out

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    _reset_counts()
    try:
        with mock.patch.object(model_cls, "optimize_parameters", step):
            losses = train.main(argv)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    launches = _counts()
    check(st["n"] == steps, f"fed loop: {st['n']} steps, want {steps}")
    timed = (st[marks[1]] - st[marks[0]]) * 1e3
    bounds = range(marks[0], marks[1] + 1, FED_WORKERS)
    rounds = [(st[b] - st[a]) * 1e3 / FED_WORKERS for a, b in zip(bounds, bounds[1:])]
    out = {"steps": steps, "step_ms": timed / FED_TIMED,
           "in_step_ms": st["in_step"] * 1e3 / FED_TIMED, "round_step_ms": rounds,
           "losses_finite": bool(all(math.isfinite(v) for v in losses.values()))}
    if profiled:
        window = (st[marks[2]] - st[marks[1]]) * 1e3
        busy = sum(ev.time_range.elapsed_us() for ev in st["prof"].events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        out.update(profiled_step_ms=window / FED_PROFILED, busy_share=busy / window)
    return out, launches


def phase_device_aug(tmp):
    """--device_aug at the README geometry: the augmenter on the card against
    the same function on the CPU, its device ms per batch, and the fed train
    loop (4 loader workers) with the host augmentation and with --device_aug,
    one after the other, for main, I2D and SR (the host runs without the
    profiled window); then a --profile_dir run."""
    import numpy as np
    import torch

    from desr_tpu_torch import checkpoints as ckpt
    from desr_tpu_torch.data.i2d_dataset import I2DDataset
    from desr_tpu_torch.data.main_dataset import MainDataset
    from desr_tpu_torch.data.sr_dataset import NaiveSRDataset
    from desr_tpu_torch.models.i2d_model import I2DModel
    from desr_tpu_torch.models.main_model import MainModel
    from desr_tpu_torch.models.main_sr_model import MainSRModel
    from desr_tpu_torch.options import train_options

    report = {"host_cpus": len(os.sched_getaffinity(0))}
    n_frames = FED_STEPS * 12  # the I2D loop's; main takes half of them
    _write_train_domain(tmp, "A", seed=120, n=n_frames, unique=FED_UNIQUE)
    _write_train_domain(tmp, "B", seed=130, n=n_frames, unique=FED_UNIQUE)
    sr_root = os.path.join(tmp, "sr")
    _write_train_domain(sr_root, "A", seed=140, n=FED_STEPS, img_hw=(968, 1296),
                        unique=FED_SR_UNIQUE)
    _write_train_domain(sr_root, "B", seed=150, n=FED_STEPS, img_hw=(968, 1296),
                        unique=FED_SR_UNIQUE)
    fed = ["--num_threads", str(FED_WORKERS), "--print_freq", "1000000",
           "--save_epoch_freq", "1000"]
    stages = {  # stage: (argv, model class, dataset class, batch, launches a step)
        "main": (_train_argv(tmp, "fed_main", aug=True) + fed
                 + ["--max_dataset_size", str(FED_STEPS * 6)], MainModel, MainDataset, 6,
                 {"K1": K1_PER_STEP, "K2": 0, "K3": K3_PER_STEP, "K3 backward": K3_BWD_PER_STEP,
                  **_k4(K4_PER_STEP)}),
        "I2D": (_i2d_train_argv(tmp, "fed_i2d") + fed, I2DModel, I2DDataset, 12,
                {"K1": I2D_K1_PER_STEP, "K2": 0, "K3": 0, "K3 backward": 0,
                 **_k4(I2D_K4_PER_STEP)}),
        "SR": (_sr_train_argv(sr_root, "fed_sr") + fed
               + ["--max_dataset_size", str(FED_STEPS)], MainSRModel, NaiveSRDataset, 1,
               {"K1": SR_K1_PER_STEP, "K2": 0, "K3": K3_PER_STEP,
                "K3 backward": K3_BWD_PER_STEP, **_k4(K4_PER_STEP)}),
    }
    paths = {}
    for stage, (argv, model_cls, ds_cls, bs, per_step) in stages.items():
        opt = train_options.parse(argv + ["--device_aug"], print_options=False)
        model = model_cls(opt, device="cuda", compute_dtype=torch.bfloat16, is_train=True,
                          generator=torch.Generator().manual_seed(11))
        for n in model.model_names:
            ckpt.save_net(model.nets[n], ckpt.net_ckpt_path(opt.checkpoints_dir, opt.name,
                                                            "latest", n))
        del model

        # the augmenter: card against CPU on one host batch, and its time
        ds = ds_cls(opt, stage="train")
        check(ds.device_aug_active(), f"[l] {stage}: --device_aug inactive")
        rep, gaps, cpu, card, batch = _aug_parity("l", ds, bs)
        if stage == "main":
            unrotated = [(d, b) for d in "AB" for b in range(bs)
                         if float(batch[f"{d}_aug"][b, 0]) == 0.0]
            check(all(torch.equal(card[f"{d}_{k}"][b].cpu(), cpu[f"{d}_{k}"][b])
                      for d, b in unrotated for k in "id"),
                  "[l] main: an unrotated sample differs between card and CPU")
            check(all(float(g.max()) <= ROT_TOL for g in gaps.values()),
                  f"[l] main augmenter card vs CPU: {rep['max_abs_gap']} > {ROT_TOL}")
            rep["unrotated_bit_equal"] = len(unrotated)
        elif stage == "I2D":
            warp = ROT_TOL * 127.5
            for k in ("A_i", "B_i"):
                d = gaps[k] * 127.5
                share1, share_eps = float((d > 1 + warp).float().mean()), float(
                    (d > 1e-3 + warp).float().mean())
                rep[f"{k}_jitter_gap"] = [float(d.max()), share1, share_eps]
                check(float(d.max()) <= JIT_BOUNDS[0] + warp and share1 < JIT_BOUNDS[1]
                      and share_eps < JIT_BOUNDS[2],
                      f"[l] I2D {k} card vs CPU: {rep[f'{k}_jitter_gap']}")
            check(max(float(gaps[k].max()) for k in ("A_d", "B_d")) <= ROT_TOL,
                  f"[l] I2D depths card vs CPU: {rep['max_abs_gap']}")
        else:
            check(all(float(g.max()) <= 1e-5 for g in gaps.values()),
                  f"[l] SR finisher card vs CPU: {rep['max_abs_gap']} > 1e-5")
        del cpu, card, batch, gaps
        print(f"[l] {stage} augmenter, batch {bs}: card vs CPU max |d| "
              f"{ {k: f'{v:.3g}' for k, v in rep['max_abs_gap'].items()} }; upload "
              f"{rep['upload_ms']:.3f} ms ({rep['host_bytes'] / 2 ** 20:.1f} MiB pinned), "
              f"device_finish {rep['finish_event_ms']:.3f} ms by CUDA events, "
              f"augmenter {rep['augment_device_ms']} ms of device time (copies apart)")

        # the fed loop: the host path (no profiled window), then --device_aug
        for mode in ("host", "device_aug"):
            aug = mode == "device_aug"
            r, launches = _fed_run(
                argv + (["--device_aug"] if aug
                        else ["--max_dataset_size", str(FED_HOST_STEPS * bs)]),
                model_cls, profiled=aug)
            want = {k: v * r["steps"] for k, v in per_step.items()}
            check(_holds(launches, want) and r["losses_finite"],
                  f"[l] {stage} fed loop ({mode}): launches {launches}, want {want}; {r}")
            paths[f"train_fed_{stage}_{mode}"] = launches
            rep[f"fed_{mode}_step_ms"] = r["step_ms"]
            rep[f"fed_{mode}_pairs_per_s"] = bs * 1000 / r["step_ms"]
            rep[f"fed_{mode}_in_step_ms"] = r["in_step_ms"]
            rep[f"fed_{mode}_round_step_ms"] = r["round_step_ms"]
            if aug:
                rep[f"fed_{mode}_profiled_step_ms"] = r["profiled_step_ms"]
                rep[f"fed_{mode}_busy_share"] = r["busy_share"]
            print(f"[l] {stage} fed loop, {mode}, batch {bs}, {FED_WORKERS} workers: "
                  f"{r['step_ms']:.2f} ms a step ({rep[f'fed_{mode}_pairs_per_s']:.2f} "
                  f"pairs/s with the feed) over {FED_TIMED} steps after {FED_WARM} (host "
                  f"inside the step {r['in_step_ms']:.2f} ms; by round of {FED_WORKERS} "
                  f"{min(r['round_step_ms']):.2f}-{max(r['round_step_ms']):.2f})"
                  + (f"; the next {FED_PROFILED} profiled: {r['profiled_step_ms']:.2f} ms a "
                     f"step, card busy {100 * r['busy_share']:.1f}%" if aug else ""))
        if rep["augment_device_ms"] is not None:
            rep["augment_share_of_fed_step"] = (rep["augment_device_ms"]
                                                / rep["fed_device_aug_step_ms"])
        report[stage] = rep

    # --profile_dir: two I2D steps under --device_aug write a trace
    prof_dir = os.path.join(tmp, "prof")
    _reset_counts()
    from desr_tpu_torch import train

    train.main(stages["I2D"][0] + ["--device_aug", "--num_threads", "0",
                                   "--max_dataset_size", "24", "--profile_dir", prof_dir])
    paths["train_i2d_profiled"] = _counts()
    trace = os.path.join(prof_dir, "trace.json")
    check(os.path.exists(trace) and os.path.getsize(trace) > 0, f"--profile_dir: no {trace}")
    with open(trace) as f:
        names = {ev.get("name", "") for ev in json.load(f).get("traceEvents", [])}
    check({"train_step", "device_finish"} <= names and any("conv3x3" in n for n in names),
          "--profile_dir: the trace lacks train_step, device_finish or K1's kernel")
    report["profile_trace_mib"] = os.path.getsize(trace) / 2 ** 20
    print(f"[l] --profile_dir: {trace} ({report['profile_trace_mib']:.1f} MiB) holds the "
          f"train_step and device_finish spans and K1's kernels")
    print("[l] " + json.dumps(report))
    return paths


# ------------------------------------------------------------------ (m)

CLI_FRAMES = {"main": 16, "SR": 8}  # the CLI's wall over this many frames (hard links)
CLI_WORKERS = (0, 4)     # --num_workers: inline, and a spawned pool of 4


def _deploy_cli(argv):
    """predict.main in-process, synchronised at the end: (host wall s, launches)."""
    import torch

    from desr_tpu_torch import predict

    _reset_counts()
    t0 = time.perf_counter()
    predict.main(argv)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, _counts()


def _export_cli(argv):
    """predict.main --export: (manifest, seconds of the CLI, of torch.export.export
    and of torch.export.save)."""
    import torch

    from desr_tpu_torch import predict

    secs = {}

    def timed(fn, key):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                secs[key] = time.perf_counter() - t0
        return run

    t0 = time.perf_counter()
    with mock.patch.object(torch.export, "export", timed(torch.export.export, "export")), \
            mock.patch.object(torch.export, "save", timed(torch.export.save, "save")):
        manifest = predict.main(argv)
    return manifest, time.perf_counter() - t0, secs["export"], secs["save"]


def _check_graph(tag, art, kernel):
    """The saved program holds one ``kernel`` node per ResnetBlock conv and,
    beside them, exactly as many library conv nodes as the nets have other
    convs: no plain version stands in for a kernel; and K4's nodes, a
    moments and an apply per norm, an apply per fused ResnetBlock's tail.
    Returns the seconds of torch.export.load."""
    import collections

    import torch

    t0 = time.perf_counter()
    program = torch.export.load(os.path.join(art, "serving.pt2"))
    secs = time.perf_counter() - t0
    ops = collections.Counter(str(n.target) for n in program.graph.nodes
                              if n.op == "call_function")
    convs = [k for k, v in program.state_dict.items() if v.dim() == 4]
    in_blocks = sum("conv_block" in k for k in convs)
    library = sum(v for k, v in ops.items() if k.startswith("aten.conv"))
    other = ({"desr.conv3x3_fused.default", "desr.conv3x3.default"} - {kernel}).pop()
    check(ops[kernel] == in_blocks == LAUNCHES_PER_BATCH and ops[other] == 0,
          f"[m] {tag}: {ops[kernel]} {kernel} and {ops[other]} {other} nodes for "
          f"{in_blocks} ResnetBlock convs; want {LAUNCHES_PER_BATCH} and 0")
    check(library == len(convs) - in_blocks,
          f"[m] {tag}: {library} library conv nodes for the nets' {len(convs) - in_blocks} "
          "other convs")
    k4 = ops["desr.instance_norm_moments.default"], ops["desr.norm_apply.default"]
    want_k4 = K4_PER_BATCH if kernel == "desr.conv3x3_fused.default" else K4_PALLAS_PER_BATCH
    check(k4 == want_k4, f"[m] {tag}: K4 nodes (moments, apply) {k4}; want {want_k4}")
    print(f"[m] {tag}: {ops[kernel]} {kernel} nodes (one a ResnetBlock conv), {library} "
          f"library conv nodes for the nets' {library} other convs, K4 nodes {k4}, "
          f"{len(program.graph.nodes)} nodes in all; torch.export.load {secs:.2f} s")
    return secs


def _compare_pngs(tag, got_dir, want_dir, n, hw, noise):
    """The artifact's PNGs against the live CLI's: the same kernels and
    library convs on the same inputs, but cuDNN's default forward algorithms
    need not repeat bit for bit (``_artifact_vs_live`` shows the live route
    against itself), so the bound is ``_serve_checks``'s: mean |d| within
    1.5x the plain bf16 versions' mean |d| from float32 (``noise`` on [-1, 1];
    2550 mm a unit)."""
    import numpy as np

    d = np.abs(_read_outputs(got_dir, n, hw) - _read_outputs(want_dir, n, hw))
    equal = float((d == 0).mean())
    print(f"[m] {tag}: PNGs against the live CLI's: max |d| {int(d.max())} mm, mean "
          f"{float(d.mean()):.4f} mm, {100 * equal:.4f}% of pixels equal (bound: mean within "
          f"{1.5 * 2550 * noise:.3f} mm)")
    check(float(d.mean()) <= 1.5 * 2550 * noise,
          f"[m] {tag}: mean |d| {float(d.mean()):.4f} mm over the bound")
    return {"max_abs_mm": int(d.max()), "equal_share": equal}


def _link_frames(src_dirs, dst, n):
    """n frames under dst/{depth,img}, hard links cycling through src_dirs' frames."""
    srcs = [(os.path.join(d, "depth", f), os.path.join(d, "img", f))
            for d in src_dirs for f in sorted(os.listdir(os.path.join(d, "depth")))]
    for sub in ("depth", "img"):
        os.makedirs(os.path.join(dst, sub))
    for i in range(n):
        for sub, src in zip(("depth", "img"), srcs[i % len(srcs)]):
            os.link(src, os.path.join(dst, sub, f"g{i:03d}.png"))
    return dst


def _artifact_vs_live(tag, art, model, batch, frames):
    """The artifact's batch against the live serve_forward's on the same
    device tensors: max |d| beside live against itself (cuDNN's default
    forward algorithms need not repeat bit for bit, which bf16 rounding
    turns into ~3e-2), and with cuDNN's deterministic algorithms, where the
    two must be equal; then device ms by CUDA events in the order live,
    artifact, artifact, live."""
    import torch

    from desr_tpu_torch.serving import load_serving

    t0 = time.perf_counter()
    fn, params, _ = load_serving(art)
    load_s = time.perf_counter() - t0

    def exp():
        return fn(params, batch)

    def live():
        return model.serve_forward(batch)

    diff = float((exp() - live()).abs().max())
    floor = float((live() - live()).abs().max())
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        exact = float((exp() - live()).abs().max())
    finally:
        torch.backends.cudnn.deterministic = deterministic
    check(exact == 0.0, f"[m] {tag}: artifact against live under deterministic cuDNN: max |d| "
          f"{exact:.3g}, want 0")
    times = {"live": [], "artifact": []}
    for name in ("live", "artifact", "artifact", "live"):
        times[name].append(cuda_ms(live if name == "live" else exp, iters=5, warmup=2))
    torch.cuda.synchronize()
    out = {f"{k}_ms": sum(v) / len(v) for k, v in times.items()}
    out.update({f"{k}_ms_runs": v for k, v in times.items()}, max_abs_diff=diff,
               live_floor_max_abs_diff=floor, load_serving_s=load_s)
    print(f"[m] {tag}: batch of {frames}, artifact against live serve_forward: max |d| "
          f"{diff:.3g} (live against itself {floor:.3g}; both under deterministic cuDNN "
          f"{exact:.3g}); device ms (CUDA events, 5 after 2, live/artifact/artifact/live) "
          f"live {out['live_ms']:.2f} ({frames * 1e3 / out['live_ms']:.1f} frames/s), artifact "
          f"{out['artifact_ms']:.2f} ({frames * 1e3 / out['artifact_ms']:.1f} frames/s); "
          f"load_serving {load_s:.2f} s")
    return out, exp


def phase_deployment(tmp, serve_dir, sr_dir):
    """Deployment and evaluation on (c)'s and (f)'s checkpoints and frames:
    predict --export / --from_export (main, --SR, the --pallas_conv route),
    the CLI's host wall at --num_workers 0 and 4, the offline metrics and
    SSIM on the card."""
    import numpy as np
    import torch

    from desr_tpu_torch import metrics, predict, serving
    from desr_tpu_torch.data.png import read_png, write_png
    from desr_tpu_torch.models.main_model import MainModel, NetOptions
    from desr_tpu_torch.models.main_sr_model import MainSRModel
    from desr_tpu_torch.ops.ssim import ssim
    from desr_tpu_torch.serving import load_serving

    report = {}
    noise = {}
    for tag, d in (("c", serve_dir), ("f", sr_dir)):
        with open(os.path.join(d, "report.json")) as f:
            noise[tag] = json.load(f)["bf16_plain_mean_abs_diff"]
    paths = {p: dict.fromkeys(_counts(), 0) for p in ("serve_artifact", "serve_artifact_k2")}
    routes = (  # tag, checkpoints, flags, frames a request, output grid, (c)/(f) live PNGs
        ("main", serve_dir, "smoke", [], 8, (480, 640), "out{r}"),
        ("SR", sr_dir, "sr", ["--SR"], 4, (960, 1280), "out{r}"),
        ("--pallas_conv", serve_dir, "smoke", ["--net_args", "--pallas_conv"], 8, (480, 640),
         "out0_k2"))
    arts = {}
    for tag, root, name, flags, bsz, hw, live_out in routes:
        art = os.path.join(tmp, f"art_{tag.strip('-')}")
        arts[tag] = art
        argv = ["--name", name, "--checkpoints_dir", root,
                "--input_depth", os.path.join(root, "req0", "depth"),
                "--input_img", os.path.join(root, "req0", "img"),
                "--output", os.path.join(tmp, "unused"), "--batch_size", str(bsz),
                "--compute_dtype", "bfloat16", "--export", art, *flags]
        manifest, cli_s, export_s, save_s = _export_cli(argv)
        check(not os.path.exists(os.path.join(tmp, "unused")), "--export wrote PNGs")
        mult = 256 if tag == "SR" else 128
        check(manifest["batch"]["B_d"][0] == [bsz, *(-(-x // mult) * mult for x in hw), 1],
              f"[m] {tag}: manifest batch {manifest['batch']}")
        print(f"[m] {tag}: predict --export in {cli_s:.2f} s (model build, .pth load, decode "
              f"included): torch.export.export {export_s:.2f} s, torch.export.save "
              f"{save_s:.2f} s; manifest batch {json.dumps(manifest['batch'])}, compute dtype "
              f"{manifest['compute_dtype']}, platforms {manifest['platforms']}")
        kernel = "desr.conv3x3.default" if "--pallas_conv" in flags else \
            "desr.conv3x3_fused.default"
        load_s = _check_graph(tag, art, kernel)
        report[f"{tag}_export_s"], report[f"{tag}_load_s"] = export_s, load_s
        for r in range(1):  # one request a route: (c)'s and (f)'s first
            out = os.path.join(tmp, f"exp_{tag.strip('-')}{r}")
            wall, c = _deploy_cli(["--input_depth", os.path.join(root, f"req{r}", "depth"),
                                   "--input_img", os.path.join(root, f"req{r}", "img"),
                                   "--output", out, "--from_export", art])
            k = "K2" if "--pallas_conv" in flags else "K1"
            want_k4 = K4_PALLAS_PER_BATCH if k == "K2" else K4_PER_BATCH
            k4 = c.pop("K4"), c.pop("K4 apply")
            check(c[k] == LAUNCHES_PER_BATCH and sum(c.values()) == LAUNCHES_PER_BATCH
                  and k4 == want_k4,
                  f"[m] {tag} --from_export request {r}: launches {c}, K4 {k4}; want {k} "
                  f"{LAUNCHES_PER_BATCH}, K4 {want_k4}")
            path = "serve_artifact_k2" if k == "K2" else "serve_artifact"
            paths[path][k] += c[k]
            paths[path]["K4"] += k4[0]
            paths[path]["K4 apply"] += k4[1]
            cmp = _compare_pngs(f"{tag} --from_export request {r} ({wall:.2f} s host wall, "
                                f"{k} {c[k]})", out, os.path.join(root, live_out.format(r=r)),
                                bsz, hw, noise["f" if tag == "SR" else "c"])
            report[f"{tag}_request{r}"] = dict(cmp, wall_s=wall)

    # the artifact's batch against the live forward's, on the device
    for tag, root, name, model in (
            ("main", serve_dir, "smoke", MainModel(NetOptions(), device="cuda")),
            ("SR", sr_dir, "sr", MainSRModel(NetOptions(crop_size_h=512, crop_size_w=640),
                                              device="cuda"))):
        model.load_networks(root, name, "latest")
        n = 4 if tag == "SR" else 8
        frames = [predict.decode_frame(os.path.join(root, "req0", "depth", f"f{i:02d}.png"),
                                       os.path.join(root, "req0", "img", f"f{i:02d}.png"),
                                       5100.0, 256 if tag == "SR" else 128) for i in range(n)]
        batch = {k: torch.from_numpy(np.stack([f[j] for f in frames])).cuda()
                 for j, k in enumerate(("B_d", "B_i"))}
        out, exp = _artifact_vs_live(tag, arts[tag], model, batch, n)
        report[f"{tag}_device"] = out
        if tag == "main":
            report["main_artifact_profile"] = _profile(exp, iters=3, tag="m")
        del model, batch, exp
        torch.cuda.empty_cache()

    # the CLI as a user runs it: --from_export over CLI_FRAMES frames
    for tag, srcs, bsz, hw in (
            ("main", [os.path.join(serve_dir, f"req{r}") for r in range(2)], 8, (480, 640)),
            ("SR", [os.path.join(sr_dir, f"req{r}") for r in range(2)], 4, (960, 1280))):
        n = CLI_FRAMES[tag]
        req = _link_frames(srcs, os.path.join(tmp, f"many_{tag}"), n)
        for workers in CLI_WORKERS:
            out = os.path.join(tmp, f"many_{tag}_out{workers}")
            load = {}

            def timed_load(*a, **k):
                t0 = time.perf_counter()
                try:
                    return load_serving(*a, **k)
                finally:
                    load["s"] = time.perf_counter() - t0

            with mock.patch.object(serving, "load_serving", timed_load):
                wall, c = _deploy_cli(["--input_depth", os.path.join(req, "depth"),
                                       "--input_img", os.path.join(req, "img"), "--output",
                                       out, "--from_export", arts[tag], "--num_workers",
                                       str(workers)])
            check(c["K1"] == LAUNCHES_PER_BATCH * n // bsz,
                  f"[m] {tag} CLI over {n} frames: launches {c}")
            check(len(os.listdir(out)) == n and read_png(
                os.path.join(out, "g000.png")).shape == hw, f"[m] {tag}: CLI outputs")
            report[f"{tag}_cli_workers{workers}_s"] = wall
            report[f"{tag}_cli_workers{workers}_load_s"] = load["s"]
            print(f"[m] {tag}: predict --from_export over {n} frames at --num_workers "
                  f"{workers}: {wall:.2f} s host wall, {n / wall:.2f} frames/s (the pool's "
                  f"start, PNG decode and write included); the artifact's load {load['s']:.2f} s "
                  f"of it, {n / (wall - load['s']):.2f} frames/s after it")
            shutil.rmtree(out)

    # the offline metrics on (c)'s predictions; targets: the input frames
    # with their holes filled, each frame its own scene with intrinsics
    target = os.path.join(tmp, "target")
    os.makedirs(target)
    for f in sorted(os.listdir(os.path.join(serve_dir, "req0", "depth"))):
        d = read_png(os.path.join(serve_dir, "req0", "depth", f))
        write_png(os.path.join(target, f), np.where(d == 0, 1500, d).astype(np.uint16))
        kdir = os.path.join(tmp, "intr", metrics.filter_basename(f)[:12], "intrinsic")
        os.makedirs(kdir)
        np.savetxt(os.path.join(kdir, "intrinsic_depth.txt"),
                   [[577.87, 0, 319.5, 0], [0, 577.87, 239.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    argv = ["--input_path", os.path.join(serve_dir, "req0", "depth"),
            "--pred_path", os.path.join(serve_dir, "out0"), "--target_path", target,
            "--intr_root", os.path.join(tmp, "intr")]
    vals = {}
    for n_cpus in (1, 4):
        t0 = time.perf_counter()
        vals[n_cpus] = metrics.main(argv + ["--n_cpus", str(n_cpus)])
        report[f"metrics_s_per_frame_cpus{n_cpus}"] = (time.perf_counter() - t0) / 8
    check(sorted(vals[1]) == sorted(metrics.DEFAULT_METRICS)
          and all(math.isfinite(v) for v in vals[1].values()) and vals[1] == vals[4],
          f"[m] metrics: {vals}")
    report["metrics"] = vals[1]
    print(f"[m] desr_tpu_torch.metrics on (c)'s 8 predictions against the hole-filled inputs: "
          + ", ".join(f"{k} {v:.5g}" for k, v in vals[1].items())
          + f"; {report['metrics_s_per_frame_cpus1']:.3f} s a frame at --n_cpus 1, "
          f"{report['metrics_s_per_frame_cpus4']:.3f} at 4 (spawned pool start included)")

    # SSIM on the card against the CPU on the same predictions and targets
    pred = torch.from_numpy(_read_outputs(os.path.join(serve_dir, "out0"), 8)[..., None] / 5100.0)
    tgt = torch.from_numpy(np.stack([read_png(os.path.join(target, f))
                                     for f in sorted(os.listdir(target))])[..., None] / 5100.0)
    on_card, on_cpu = float(ssim(pred.cuda(), tgt.cuda())), float(ssim(pred, tgt))
    check(abs(on_card - on_cpu) <= 1e-5, f"[m] ssim card {on_card} against CPU {on_cpu}")
    report.update(ssim_card=on_card, ssim_cpu=on_cpu)
    print(f"[m] ops/ssim.py on (8, 480, 640, 1): card {on_card:.7f}, CPU {on_cpu:.7f}")
    print("[m] " + json.dumps(report))
    return paths


# ------------------------------------------------------------------ (n)

SURFACE_DEVICE = "cuda"   # phase (n)'s device (a CPU rehearsal sets "cpu")
SURFACE_ARGV = ()         # flags appended to phase (n)'s CLI runs (a rehearsal's widths)
SURFACE_BATCH = (6, 512, 640)  # the CLI's batch: README stage 3 with --no_aug
K1_EVAL = 42              # an eval forward: G_A_d 18 + I2D_features 12 + Depth_f 12 (2B)
K3_EVAL = 2               # its syn and real triplets, no backward
SR_K1_REMAT = {"none": 42, "remat": 54, "remat_blocks": 54, "remat_tails": 42}
REMAT_FLAGS = {"none": (False, None), "remat": (True, None),
               "remat_blocks": (False, "blocks"), "remat_tails": (False, "tails")}


def _synthetic_batch(b, h, w, seed, lr_hw=None):
    """A main / SR / I2D batch of random depths in [-0.9, 0.9] with 5% holes
    at -1, images in [-1, 1], ScanNet's intrinsics and whole-frame crops
    (crop_B on the LR grid ``lr_hw`` for SR)."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def depth():
        d = rng.uniform(-0.9, 0.9, (b, h, w, 1)).astype(np.float32)
        d[rng.uniform(size=d.shape) < 0.05] = -1.0
        return d

    k = np.tile(np.array([[[577.87, 0, 319.5], [0, 577.87, 239.5], [0, 0, 1]]], np.float32),
                (b, 1, 1))
    ch, cw = lr_hw or (h, w)
    return {"A_i": rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32),
            "B_i": rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32),
            "A_d": depth(), "B_d": depth(), "K_A": k, "K_B": k.copy(),
            "crop_A": np.tile(np.array([[0, h, 0, w]], np.float32), (b, 1)),
            "crop_B": np.tile(np.array([[0, ch, 0, cw]], np.float32), (b, 1))}


class _Deterministic:
    """cuDNN's deterministic algorithms and torch's deterministic mode
    inside the block: cuDNN's default backward algorithms add in a
    run-dependent order (phase (e)), and so do the backward of the
    reflect / replicate pads (K1's backward, the nets' pad layers) unless
    torch's mode picks their deterministic versions. warn_only: the SR
    step's bicubic resize has none (upsample_bicubic2d_backward), so its
    gradients keep a run-to-run floor (``_remat_equal`` measures it)."""

    def __enter__(self):
        import torch

        self.prev = (torch.backends.cudnn.deterministic,
                     torch.are_deterministic_algorithms_enabled(),
                     torch.is_deterministic_algorithms_warn_only_enabled())
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)

    def __exit__(self, *exc):
        import torch

        torch.backends.cudnn.deterministic = self.prev[0]
        torch.use_deterministic_algorithms(self.prev[1], warn_only=self.prev[2])


def _sync():
    import torch

    if SURFACE_DEVICE == "cuda":
        torch.cuda.synchronize()


def _same(got, want, by_net=False):
    """(tensors bit-equal, of all; the worst gap) over two dicts of tensors
    with the same keys: relative to each tensor's largest entry, or with
    ``by_net`` to the largest entry of the tensors of its net (the key's
    first part), the scale at which a conv bias that feeds a norm (an exact
    gradient of 0) has its noise read."""
    def mx(v):
        return float(v.float().abs().max()) if v.numel() else 0.0

    net_max = {}
    for k, v in want.items():
        net_max[k.split(".")[0]] = max(net_max.get(k.split(".")[0], 0.0), mx(v))
    equal, worst = 0, 0.0
    for k, v in want.items():
        g = got[k]
        equal += bool(g.dtype == v.dtype and (g == v).all())
        scale = max(net_max[k.split(".")[0]] if by_net else mx(v), 1e-30)
        worst = max(worst, mx(g.float() - v.float()) / scale)
    return equal, len(want), worst


def _grads_of(model, nets):
    return {f"{n}.{k}": p.grad.clone() for n in nets
            for k, p in model.nets[n].named_parameters() if p.grad is not None}


def _weights_of(model, nets):
    return {f"{n}.{k}": v.detach().clone() for n in nets
            for k, v in model.nets[n].state_dict().items()}


def _set_remat(model, variant):
    model.remat_nets, model.remat_inner = REMAT_FLAGS[variant]
    model.apply_remat()


def _remat_equal(tag, model, run, variants):
    """Each remat ``variant``'s ``run(model)`` (loss terms, gradients) at
    float32 under ``_Deterministic`` against the plain one's: the loss terms
    within 1e-6 relative, each gradient within 1e-6 of its net's largest
    entry, or the plain step's own run-to-run floor times 3 where that is
    larger (the plain step is run twice); the tensors bit-equal are
    counted."""
    with _Deterministic():
        _set_remat(model, "none")
        m0, g0 = run(model)
        _, g00 = run(model)
        e0, n0, floor = _same(g00, g0, by_net=True)
        bound = max(1e-6, 3 * floor)
        print(f"[n] {tag}, float32, deterministic: the plain step against itself, gradients "
              f"{e0}/{n0} bit-equal (worst {floor:.3g} of the net's largest entry)")
        for variant in variants:
            _set_remat(model, variant)
            m1, g1 = run(model)
            em, nm, wm = _same(m1, m0)
            eg, ng, wg = _same(g1, g0, by_net=True)
            print(f"[n] {tag} {variant} against no remat: loss terms {em}/{nm} bit-equal (worst "
                  f"{wm:.3g}), gradients {eg}/{ng} bit-equal (worst {wg:.3g} of the net's "
                  f"largest entry; bound {bound:.3g})")
            check(wm <= 1e-6 and wg <= bound,
                  f"[n] {tag} {variant}: loss terms {wm:.3g}, gradients {wg:.3g} off "
                  f"(bounds 1e-6, {bound:.3g})")
        _set_remat(model, "none")


def phase_train_surface(tmp):
    """(n): the train CLI's surface: gallery, --steps_per_call, plateau LR,
    the remat flags, --norm batch, --init_type and the train state."""
    import numpy as np
    import torch

    from desr_tpu_torch import checkpoints as ckpt
    from desr_tpu_torch import train
    from desr_tpu_torch.data.png import read_png
    from desr_tpu_torch.models.i2d_model import I2DModel
    from desr_tpu_torch.models.main_model import MainModel
    from desr_tpu_torch.models.main_sr_model import MainSRModel
    from desr_tpu_torch.models.translation_model import TranslationModel
    from desr_tpu_torch.options import train_options

    dev = SURFACE_DEVICE
    report, paths = {}, {}
    # 1. train.main: README stage 3, 4 steps of batch 6 as 2 groups of 2, a
    # gallery each group, plateau LR, a test pass over one pair
    b = SURFACE_BATCH[0]
    for dom, seed, n in (("A", 60, 4 * b), ("B", 70, 4 * b), ("C", 80, 1), ("D", 90, 1)):
        _write_train_domain(tmp, dom, seed=seed, n=n, unique=min(n, 2))
    c, d = os.path.join(tmp, "C"), os.path.join(tmp, "D")
    argv = _train_argv(tmp, "surface", [
        "--batch_size", str(b), "--do_test", "--display_freq", str(b), "--steps_per_call", "2", "--lr_policy",
        "plateau", "--path_A_test", f"{c}/depth", "--A_add_paths_test", f"{c}/img",
        "--path_B_test", f"{d}/depth", "--B_add_paths_test", f"{d}/img", *SURFACE_ARGV])
    _reset_counts()
    t0 = time.perf_counter()
    losses = train.main(argv)
    _sync()
    wall = time.perf_counter() - t0
    launches = _counts()
    # 4 steps; 2 gallery forwards (one a group) and 1 test forward
    want = {"K1": 4 * K1_PER_STEP + 3 * K1_EVAL, "K2": 0, "K3": 4 * K3_PER_STEP + 3 * K3_EVAL,
            "K3 backward": 4 * K3_BWD_PER_STEP,
            **_k4((4 * K4_PER_STEP[0] + 3 * K4_EVAL[0], 4 * K4_PER_STEP[1] + 3 * K4_EVAL[1]),
                  device=dev)}
    check(_holds(launches, want), f"[n] train.main: launches {launches}; want {want}")
    check(losses and all(np.isfinite(list(losses.values()))), f"[n] train.main losses: {losses}")
    web = os.path.join(tmp, "surface", "web")
    names = sorted(os.listdir(os.path.join(web, "images")))
    with open(os.path.join(web, "index.html")) as f:
        index = f.read()
    check(len(names) == 13 and all(f"images/{n}" in index for n in names),
          f"[n] gallery: {names}")
    for n in names:
        img = read_png(os.path.join(web, "images", n))
        check(img.dtype == np.uint8 and img.shape == (*SURFACE_BATCH[1:], 3),
              f"[n] gallery {n}: {img.dtype} {img.shape}")
    paths["train_surface"] = launches
    print(f"[n] train.main, README stage 3 + --steps_per_call 2 --display_freq {b} "
          f"--lr_policy plateau --do_test: 4 steps of batch {b} in {wall:.1f} s host wall; "
          f"launches {launches} (4 steps, 2 gallery forwards, 1 test forward); gallery "
          f"{len(names)} PNGs {SURFACE_BATCH[1]}x{SURFACE_BATCH[2]} and index.html decoded; "
          "losses " + ", ".join(f"{k} {v:.4g}" for k, v in losses.items()))

    opt = train_options.parse(argv, print_options=False)
    model = MainModel(opt, device=dev, compute_dtype=torch.bfloat16, is_train=True,
                      generator=torch.Generator().manual_seed(7))
    model.set_input(_synthetic_batch(*SURFACE_BATCH, seed=1))
    if dev == "cuda":
        report["gallery_forward_ms"] = cuda_ms(lambda: model.calculate(stage="train"),
                                               iters=5, warmup=1)
        print(f"[n] the gallery's eval forward (calculate, bf16, batch {b} at "
              f"{SURFACE_BATCH[1]}x{SURFACE_BATCH[2]}): {report['gallery_forward_ms']:.2f} ms "
              "(CUDA events, 5 after 1)")
        # host wall a step: 4 host batches one by one (each upload waits for
        # the step before it) against one group of 4 (all uploaded, then the
        # steps queued); in turns single, grouped, grouped, single
        group = [_synthetic_batch(*SURFACE_BATCH, seed=10 + i) for i in range(4)]

        def singles():
            for batch in group:
                model.set_input(batch)
                model.optimize_parameters()

        walls = {"single": [], "grouped": []}
        singles()
        for name in ("single", "grouped", "grouped", "single"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            singles() if name == "single" else model.optimize_parameters_multi(group, 0)
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3 / len(group))
        report.update({f"step_wall_{k}_ms": v for k, v in walls.items()})
        print(f"[n] host wall a bf16 main step (batch {b}, {len(group)} host batches, with "
              f"their uploads): one by one {', '.join(f'{v:.2f}' for v in walls['single'])} ms, "
              f"as one group of {len(group)} {', '.join(f'{v:.2f}' for v in walls['grouped'])} "
              "ms (turns: single, grouped, grouped, single)")
    del model

    # float32, deterministic: 2 groups of 2 against 4 single steps
    opt32 = SimpleNamespace(**{**vars(opt), "batch_size": 2})
    batches = [_synthetic_batch(2, 256, 384, seed=s) for s in range(4)]

    def main32():
        return MainModel(opt32, device=dev, compute_dtype=torch.float32, is_train=True,
                         generator=torch.Generator().manual_seed(8))

    with _Deterministic():
        single, multi = main32(), main32()
        for i, batch in enumerate(batches):
            single.set_input(batch)
            single.optimize_parameters(i + 1)
        multi.optimize_parameters_multi(batches[:2], 2)
        multi.optimize_parameters_multi(batches[2:], 4)
    eq, n, worst = _same(_weights_of(multi, multi.model_names),
                         _weights_of(single, single.model_names))
    check(eq == n, f"[n] --steps_per_call 2: {n - eq} of {n} tensors differ (worst {worst:.3g})")
    print(f"[n] float32 batch 2 at 256x384, deterministic: 2 groups of 2 steps "
          f"(optimize_parameters_multi) against 4 single steps: {eq}/{n} tensors bit-equal")

    # 5. the train state: save after step 2, resume in a model that stepped elsewhere
    with _Deterministic():
        ckpt.save_train_state(single, os.path.join(tmp, "state"), 4)
        resumed = main32()
        resumed.set_input(batches[0])
        resumed.optimize_parameters(1)
        check(ckpt.load_train_state(resumed, os.path.join(tmp, "state")) == 4,
              "[n] load_train_state picked another step")
        for m in (single, resumed):
            m.set_input(batches[1])
            m.optimize_parameters(5)
    eq, n, worst = _same(_weights_of(resumed, resumed.model_names),
                         _weights_of(single, single.model_names))
    check(eq == n, f"[n] resume: {n - eq} of {n} tensors differ (worst {worst:.3g})")
    print(f"[n] save_train_state after step 4, load_train_state into a model that took another "
          f"step: the next step's weights {eq}/{n} tensors bit-equal to the uninterrupted run")
    del single, multi, resumed

    # 2. the SR step at the README geometry under each remat flag
    sr_argv = _sr_train_argv(tmp, "srremat")
    sr_opt = train_options.parse(sr_argv + list(SURFACE_ARGV), print_options=False)
    lr_hw = (sr_opt.crop_size_h, sr_opt.crop_size_w)
    sr = MainSRModel(sr_opt, device=dev, compute_dtype=torch.bfloat16, is_train=True,
                     generator=torch.Generator().manual_seed(9))
    sr.set_input(_synthetic_batch(1, 2 * lr_hw[0], 2 * lr_hw[1], seed=2, lr_hw=lr_hw))
    for variant in REMAT_FLAGS:  # one step each: launches and peak memory
        _set_remat(sr, variant)
        _reset_counts()
        if dev == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        sr.optimize_parameters()
        _sync()
        c = _counts()
        paths[f"train_sr_{variant}"] = c
        check(c["K1"] == SR_K1_REMAT[variant] and _holds(c, _k4(K4_PER_STEP, device=dev))
              and np.isfinite(float(sr.metrics["G"])),
              f"[n] SR step {variant}: launches {c}, G {float(sr.metrics['G'])}")
        if dev == "cuda":
            report[f"sr_step_{variant}_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if dev == "cuda":
        # in turns, each variant twice (forward, then backward order): a
        # warm-up step in the mode, then 5 steps timed by CUDA events and by
        # the host's clock up to the last step's return (the issue time:
        # near the event time, the host bounds the step)
        steps = 5
        ms, issue = {v: [] for v in REMAT_FLAGS}, {v: [] for v in REMAT_FLAGS}
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for variant in list(REMAT_FLAGS) + list(REMAT_FLAGS)[::-1]:
            _set_remat(sr, variant)
            sr.optimize_parameters()
            torch.cuda.synchronize()
            start.record()
            t0 = time.perf_counter()
            for _ in range(steps):
                sr.optimize_parameters()
            issue[variant].append((time.perf_counter() - t0) * 1e3 / steps)
            end.record()
            torch.cuda.synchronize()
            ms[variant].append(start.elapsed_time(end) / steps)
        for variant in REMAT_FLAGS:
            report[f"sr_step_{variant}_ms"] = ms[variant]
            report[f"sr_step_{variant}_issue_ms"] = issue[variant]
            print(f"[n] SR step bf16 {variant}, batch 1, LR {lr_hw[0]}x{lr_hw[1]} -> HR "
                  f"{2 * lr_hw[0]}x{2 * lr_hw[1]}: {', '.join(f'{v:.2f}' for v in ms[variant])} "
                  f"ms (CUDA events, {steps} steps a turn, turns none, remat, remat_blocks, "
                  f"remat_tails, then back), host issue "
                  f"{', '.join(f'{v:.2f}' for v in issue[variant])} ms a step, peak "
                  f"{report[f'sr_step_{variant}_peak_gib']:.2f} GiB, K1 "
                  f"{paths[f'train_sr_{variant}']['K1']} launches a step")
    del sr
    sr32 = MainSRModel(SimpleNamespace(**{**vars(sr_opt), "crop_size_h": 128,
                                          "crop_size_w": 128}),
                       device=dev, compute_dtype=torch.float32, is_train=True,
                       generator=torch.Generator().manual_seed(10))
    sr32.set_input(_synthetic_batch(1, 256, 256, seed=3, lr_hw=(128, 128)))

    def main_run(model):
        model.hole_generator.manual_seed(11)
        return model.compute_grads(), _grads_of(model, model.trainable_nets)

    _remat_equal("SR step at HR 256x256", sr32, main_run, ("remat", "remat_blocks", "remat_tails"))
    del sr32

    # 3. one I2D step and one stage-2 G step under --remat_tails
    i2d = I2DModel(train_options.parse(_i2d_train_argv(tmp, "i2dremat", [
        "--i2d_train_features", *SURFACE_ARGV]), print_options=False),
        device=dev, compute_dtype=torch.float32, is_train=True,
        generator=torch.Generator().manual_seed(12))
    i2d.set_input(_synthetic_batch(2, 256, 256, seed=4))
    _remat_equal("I2D step (--i2d_train_features), batch 2 at 256x256", i2d,
                 lambda m: (m.compute_grads(), _grads_of(m, m.trainable_nets)), ("remat_tails",))
    del i2d
    tr = TranslationModel(train_options.parse(_translation_argv(tmp, "trremat", [
        "--batch_size", "2", "--compute_dtype", "float32"]), print_options=False),
        device=dev, compute_dtype=torch.float32, is_train=True,
        generator=torch.Generator().manual_seed(13))
    rng = np.random.default_rng(5)
    tr.set_input({k: rng.uniform(-0.9, 0.9, (2, 64, 64, 3 if k.endswith("img") else 1))
                  .astype(np.float32) for k in ("A_depth", "A_img", "B_depth", "B_img")})
    _remat_equal("stage-2 G step, batch 2 at 64x64", tr,
                 lambda m: (m.compute_grads()[0], _grads_of(m, m.trainable_nets)),
                 ("remat_tails",))
    del tr

    # 4. a main step under --norm batch, and one under --init_type orthogonal
    batch = _synthetic_batch(*SURFACE_BATCH, seed=6)
    for flags, k1, k4 in ((("--norm", "batch"), K1_TRANS_PER_STEP, K4_NORM_BATCH_PER_STEP),
                          (("--init_type", "orthogonal"), K1_PER_STEP, K4_PER_STEP)):
        fopt = train_options.parse(argv + list(flags), print_options=False)
        m = MainModel(fopt, device=dev, compute_dtype=torch.bfloat16, is_train=True,
                      generator=torch.Generator().manual_seed(14))
        before = _weights_of(m, m.model_names)
        m.set_input(batch)
        _reset_counts()
        m.optimize_parameters()
        _sync()
        c = _counts()
        after = _weights_of(m, m.model_names)
        stats = [k for k in before if "running_" in k or "num_batches" in k]
        moved = [k for k in stats if not torch.equal(after[k], before[k])]
        trained = {k for k in before if k.split(".")[0] in m.trainable_nets}
        finite = all(np.isfinite(float(v)) for v in m.metrics.values())
        paths["train_" + "_".join(f.strip("-") for f in flags)] = c
        check(finite and not moved and c["K1"] == k1 and _holds(c, _k4(k4, device=dev))
              and all(not torch.equal(after[k], before[k]) for k in trained
                      if k.endswith("weight") and "running" not in k)
              and (bool(stats) == (flags[0] == "--norm")),
              f"[n] main step {' '.join(flags)}: finite {finite}, stats moved {moved[:3]}, "
              f"launches {c}")
        print(f"[n] main step bf16 {' '.join(flags)} (fresh seeded weights), batch {b}: losses "
              f"finite (G {float(m.metrics['G']):.5g}); {len(stats)} BatchNorm statistics, none "
              f"moved (the JAX step passes no stats sink); launches {c}")
        del m
    print("[n] " + json.dumps(report))
    return paths


# ------------------------------------------------------------------ (o)

FIXTURE_JPEG = os.path.join(ROOT, "tests", "data", "jpeg_968x1296.jpg")
# sha256 of imageio.v2.imread(FIXTURE_JPEG)'s pixels (tests/test_torch_native_io.py)
FIXTURE_SHA256 = "eaf0616b7e2e389d4cb152e06c67e2207c92bbd2cbea8d838144e82c7ff3ae08"
DECODE_TURNS = 20        # per-frame decode times: median of this many, the routes in turns
PAETH_TURNS = 5          # data/png.py undoes the Paeth filter value by value: ~0.5 s a frame


def _paeth_png(arr):
    """A uint8 (H, W, C) array as PNG bytes with the Paeth filter on every
    row, which data/png.py undoes in a Python loop (its own writer, which
    wrote every other frame here, uses the Up filter)."""
    import struct
    import zlib

    import numpy as np

    h, w, ch = arr.shape
    rows = arr.reshape(h, w * ch).astype(np.int16)
    a = np.pad(rows, ((0, 0), (ch, 0)))[:, :-ch]   # left
    b = np.pad(rows, ((1, 0), (0, 0)))[:-1]          # up
    c = np.pad(b, ((0, 0), (ch, 0)))[:, :-ch]        # up-left
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    raw = np.concatenate([np.full((h, 1), 4, np.uint8), ((rows - pred) & 0xFF).astype(np.uint8)],
                         axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, {3: 2, 4: 6}[ch], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))


def phase_bench_io(tmp):
    """(o) ``desr_tpu_torch.bench``, in-process under the launch counters and
    as a user runs it, then the image decode route and its per-frame times."""
    import hashlib
    import statistics

    import numpy as np
    import torch

    from desr_tpu_torch import bench
    from desr_tpu_torch.data import native_io, png

    report = {}
    steps = bench.WARMUP + bench.STEPS
    _reset_counts()
    res = bench.run("cuda")
    launches = _counts()
    want = {"K1": steps * SR_K1_PER_STEP, "K2": 0, "K3": steps * K3_PER_STEP,
            "K3 backward": steps * K3_BWD_PER_STEP, **_k4(K4_PER_STEP, steps)}
    check(_holds(launches, want), f"bench.run: launches {launches}; want {want} over {steps} steps")
    check(all(math.isfinite(v) for v in res["losses"].values()), f"bench losses {res['losses']}")
    report.update({f"bench_{k}": v for k, v in res.items() if k != "losses"})
    print(f"[o] bench.run in-process: {steps} SR steps (batch 1, LR 512x640 -> HR 1024x1280, "
          f"bf16), {res['pairs_per_sec']:.4f} pairs/s; the timed {bench.STEPS} steps "
          f"{res['step_ms']:.2f} ms a step by the host clock, {res['event_ms']:.2f} ms by CUDA "
          f"events; peak {res['peak_gib']:.2f} GiB; launches {launches} "
          f"(K1 {SR_K1_PER_STEP}, K3 {K3_PER_STEP} and its backward {K3_BWD_PER_STEP} a step)")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "desr_tpu_torch.bench"], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"python -m desr_tpu_torch.bench exited {proc.returncode}:\n"
          + proc.stderr[-3000:])
    lines = proc.stdout.splitlines()
    check(len(lines) == 1, f"python -m desr_tpu_torch.bench printed {len(lines)} stdout lines")
    line = json.loads(lines[0])
    check(sorted(line) == ["metric", "unit", "value", "vs_baseline"]
          and line["metric"] == bench.METRIC and math.isfinite(line["value"])
          and line["value"] > 0, f"the bench's line: {lines[0]}")
    report.update(bench_cli_value=line["value"], bench_cli_vs_baseline=line["vs_baseline"],
                  bench_cli_wall_s=wall)
    for d in proc.stderr.splitlines():
        if d.startswith("# "):
            print(f"[o] bench stderr: {d[2:]}")
    print(f"[o] python -m desr_tpu_torch.bench ({wall:.1f} s wall) printed: {lines[0]}")

    route, detail = native_io.route()
    print(f"[o] image decode route: {route} ({detail})")
    check(route == "native", f"the native image library did not build: {detail}")
    check("JPEG: PIL" in detail, f"no JPEG decoder: {detail}")
    frames = os.path.join(tmp, "frames")
    _write_frames(frames, 1, seed=0)  # phase (c)'s first frame, which (m) serves
    rgb = os.path.join(frames, "img", "f00.png")
    paeth = os.path.join(tmp, "paeth.png")
    with open(paeth, "wb") as f:
        f.write(_paeth_png(png.read_png(rgb)))
    for label, path, turns in (("rgb", rgb, DECODE_TURNS),
                               ("depth", os.path.join(frames, "depth", "f00.png"), DECODE_TURNS),
                               ("rgb_paeth", paeth, PAETH_TURNS)):
        check(np.array_equal(native_io.read_image(path), png.read_png(path)),
              f"{label}: the native and stdlib decodes differ")
        times = {"native": [], "stdlib": []}
        for _ in range(turns):
            for route_name, fn in (("native", native_io.read_image), ("stdlib", png.read_png)):
                t0 = time.perf_counter()
                fn(path)
                times[route_name].append((time.perf_counter() - t0) * 1e3)
        nat, std = statistics.median(times["native"]), statistics.median(times["stdlib"])
        report.update({f"decode_{label}_native_ms": nat, f"decode_{label}_stdlib_ms": std})
        print(f"[o] 480x640 {label} PNG ({os.path.getsize(path)} B): native {nat:.2f} ms, "
              f"data/png.py {std:.2f} ms a frame (medians of {turns}, in turns), "
              f"{std / nat:.2f}x")
    pix = native_io.read_image(FIXTURE_JPEG)
    sha = hashlib.sha256(np.ascontiguousarray(pix).tobytes()).hexdigest()
    check(pix.shape == (968, 1296, 3) and pix.dtype == np.uint8 and sha == FIXTURE_SHA256,
          f"the JPEG fixture decoded to {pix.shape} {pix.dtype}, sha256 {sha}; "
          f"imageio's pixels hash to {FIXTURE_SHA256}")
    times = []
    for _ in range(DECODE_TURNS):
        t0 = time.perf_counter()
        native_io.read_image(FIXTURE_JPEG)
        times.append((time.perf_counter() - t0) * 1e3)
    report["decode_jpeg_968x1296_ms"] = statistics.median(times)
    print(f"[o] 968x1296 JPEG fixture: decode through PIL {statistics.median(times):.2f} ms a "
          f"frame (median of {DECODE_TURNS}); pixels' sha256 {sha} as imageio's")
    print("[o] " + json.dumps(report))
    return {"train_bench": launches}


# ------------------------------------------------------------------ (p)

# (tag, the quality tool's argv after --root, width: None runs the options'
# default widths, whether trained rmse and rmse_h must beat the degraded input)
QUALITY_CHAINS = (
    ("p1 main width 8 f32", ["--stage", "main", "--width", "8", "--epochs", "10",
                             "--n_train", "24", "--n_test", "8", "--batch_size", "4",
                             "--hw", "128", "128", "--compute_dtype", "float32",
                             "--seed", "0"], 8, True),
    ("p2 main full width bf16", ["--stage", "main", "--compute_dtype", "bfloat16",
                                 "--epochs", "10"], None, True),
    ("p3 sr full width bf16", ["--stage", "sr", "--compute_dtype", "bfloat16", "--n_train", "4",
                               "--n_test", "2", "--sr_pre_epochs", "4", "--epochs", "2"],
     None, False),
    ("p4 i2d full width bf16", ["--stage", "i2d", "--compute_dtype", "bfloat16", "--n_train", "4",
                                "--n_test", "2", "--epochs", "2"], None, False),
    ("p4 translation bf16", ["--stage", "translation", "--hw", "320", "320", "--compute_dtype",
                             "bfloat16", "--n_train", "4", "--n_test", "2", "--epochs", "2"],
     None, False),
)
# launches by stage: K1 a train step (an iteration of stage 2), K1 a serving
# batch, K3 (and its backward) a step (a gallery forward: K3 alone), K1 a
# gallery forward (None: no chain of the stage reaches one)
QUALITY_LAUNCHES = {"main": (K1_PER_STEP, LAUNCHES_PER_BATCH, K3_PER_STEP, K1_PER_STEP),
                    "sr": (SR_K1_PER_STEP, LAUNCHES_PER_BATCH, K3_PER_STEP, None),
                    "i2d": (I2D_K1_PER_STEP, I2D_K1_PER_BATCH, 0, None),
                    "translation": (STAGE2_K1_PER_ITER, TRANSLATE_K1_PER_BATCH, 0, None)}
# K4's (moments, applies) by stage: a train step, a serving batch, a gallery forward
QUALITY_K4 = {"main": (K4_PER_STEP, K4_PER_BATCH, K4_EVAL),
              "sr": (K4_PER_STEP, K4_PER_BATCH, None),
              "i2d": (I2D_K4_PER_STEP_NO_D, I2D_K4_PER_BATCH, None),
              "translation": ((0, 0), TRANSLATE_K4_PER_BATCH, None)}
DISPLAY_FREQ = 400  # the train CLI's --display_freq, which the tool leaves at its default
QUALITY_METRICS = ("rmse", "mae", "rmse_h", "rmse_d", "psnr", "ssim", "mae_h", "mae_d", "mse_v")


def _launch_log():
    """Patches that log each K1 and K3 launch's shape beside the counters:
    ({(x's NHWC shape, C_out, dtype, pad mode): launches}, {(K3 shape, dtype): launches})."""
    from desr_tpu_torch.ops import conv3x3 as K
    from desr_tpu_torch.ops import masked_loss as K3

    k1, k3 = {}, {}
    launch1, launch3 = K._launch, K3._launch

    def log1(x, w, scale, shift, pad_mode, relu, stats, *halo):
        key = (tuple(x.shape), w.shape[0], str(x.dtype)[6:], pad_mode)
        k1[key] = k1.get(key, 0) + 1
        return launch1(x, w, scale, shift, pad_mode, relu, stats, *halo)

    def log3(pred, target, m1, m2):
        key = (tuple(pred.shape), str(pred.dtype)[6:])
        k3[key] = k3.get(key, 0) + 1
        return launch3(pred, target, m1, m2)

    patches = (mock.patch.object(K, "_launch", log1), mock.patch.object(K3, "_launch", log3))
    return k1, k3, patches


def phase_quality(tmp):
    """(p) the quality chain on the card: ``desr_tpu_torch.tools.quality_eval``
    in-process, one chain at a time (train -> serve -> score on synthetic
    scenes), with the kernels' launches counted and their shapes logged."""
    import torch

    from desr_tpu_torch.tools import quality_eval as qe

    total = dict.fromkeys(_counts(), 0)
    for tag, argv, width, must_learn in QUALITY_CHAINS:
        args = qe.parse_args(["--root", os.path.join(tmp, tag.replace(" ", "_"))] + argv)
        args.width = width
        k1_log, k3_log, patches = _launch_log()
        _reset_counts()
        t0 = time.perf_counter()
        with patches[0], patches[1]:
            res = qe.run(args)  # prints the chain's JSON line
        wall = time.perf_counter() - t0
        launches = _counts()
        torch.cuda.empty_cache()
        splits = [s for s in ("baseline", "baseline_bicubic", "baseline_mean", "trained")
                  if s in res]
        for split in splits:
            bad = {k: res[split].get(k) for k in QUALITY_METRICS
                   if not math.isfinite(res[split].get(k, math.nan))}
            check(not bad, f"[p] {tag}: {split} metrics not finite: {bad}")
        preds = os.listdir(os.path.join(args.root, "pred_" + args.name))
        check(len(preds) == args.n_test and all(p.endswith(".png") for p in preds),
              f"[p] {tag}: {len(preds)} predictions for {args.n_test} test frames")
        if must_learn:
            for k in ("rmse", "rmse_h"):
                check(res["trained"][k] < res["baseline"][k],
                      f"[p] {tag}: trained {k} {res['trained'][k]:.2f} not below the degraded "
                      f"input's {res['baseline'][k]:.2f}")
        if args.stage == "sr":
            check(os.path.exists(os.path.join(args.root, "export_" + args.name, "serving.pt2")),
                  f"[p] {tag}: no exported artifact")
        steps = res["steps"] + (args.sr_pre_epochs * (args.n_train // args.batch_size)
                                if args.stage == "sr" else 0)
        sec = res["seconds"]
        print(f"[p] {tag}: {wall:.1f} s (data {sec['data']:.1f}, train {sec['train']:.1f}, "
              f"serve {sec['serve']:.1f}, score {sec['score']:.1f}); {steps} train steps, "
              f"{steps / sec['train']:.2f} steps/s with the train CLI's set-up; "
              f"launches {launches}")
        for k in ("rmse", "rmse_h"):
            print(f"[p] {tag}: {k} {res['baseline'][k]:.2f} (degraded input) -> "
                  f"{res['trained'][k]:.2f} (trained)")
        print(f"[p] {tag}: K1 launches by (NHWC x, C_out, dtype, pad): "
              + json.dumps({str(k): v for k, v in sorted(k1_log.items())}))
        print(f"[p] {tag}: K3 sums launches by (shape, dtype): "
              + json.dumps({str(k): v for k, v in sorted(k3_log.items())}))
        # the train steps', the gallery forwards' (one every --display_freq
        # images) and one serving batch's (n_test frames)
        k1_step, k1_batch, k3_step, k1_eval = QUALITY_LAUNCHES[args.stage]
        shows = steps * args.batch_size // DISPLAY_FREQ
        k4_step, k4_batch, k4_eval = QUALITY_K4[args.stage]
        want = {"K1": steps * k1_step + shows * (k1_eval or 0) + k1_batch, "K2": 0,
                "K3": (steps + shows) * k3_step, "K3 backward": steps * k3_step,
                **_k4([steps * a + shows * (e or 0) + b
                       for a, b, e in zip(k4_step, k4_batch, k4_eval or (0, 0))])}
        check(k1_eval is not None or not shows, f"[p] {tag}: {shows} gallery forwards")
        check(_holds(launches, want), f"[p] {tag}: launches {launches}; want {want} for {steps} "
              f"steps and {shows} gallery forwards")
        for k, v in launches.items():
            total[k] += v
        shutil.rmtree(args.root)
    return {"quality": total}


# ------------------------------------------------------------------ (q)

DP_RANKS = 2               # two gloo ranks time-share the one card
DP_DEVICE = "cuda"         # phase (q)'s device (a CPU rehearsal sets "cpu")
DP_MAIN = (6, 384, 512)    # the main step's global batch on the README's crops: 3 a rank
DP_I2D = (4, 384, 512)     # I2D --use_D, 2 a rank; a pool of 2 swaps in the first step
DP_TRANS = (4, 256, 256)   # stage 2 with --netD Gu, 2 a rank
DP_SR_LR = (128, 128)      # the SR step at batch 1 (the replicate path), HR 256x256
DP_TIMED = 1               # main steps timed on the ranks after the checked one
DP_REDUCE = 1              # gradient averages timed after them
DP_LAUNCHES = {            # a rank's launches: phase (e)'s, (j)'s, (k)'s with one G step, (g)'s
    "main": {"K1": K1_PER_STEP, "K3": K3_PER_STEP, "K3 backward": K3_PER_STEP},
    "i2d": {"K1": I2D_K1_PER_STEP, "K3": 0, "K3 backward": 0},
    "translation": {"K1": 4 * TRANSLATE_K1_PER_BATCH, "K3": 0, "K3 backward": 0},
    "sr": {"K1": SR_K1_PER_STEP, "K3": K3_PER_STEP, "K3 backward": K3_PER_STEP},
}
# K4's (moments, applies) a rank: the same steps' (I2D under --use_D); phase (s)'s too
STEP_K4 = {"main": K4_PER_STEP, "i2d": I2D_K4_PER_STEP, "translation": (0, 0),
           "sr": K4_PER_STEP}


def _dp_host(t):
    return t.detach().float().cpu().numpy()


def _dp_model(kind, tmp, mesh):
    """Phase (q)'s model of ``kind`` on ``mesh``'s device, float32, its
    weights drawn from seed 8 (alike on every rank and in one process)."""
    import torch

    from desr_tpu_torch.models.i2d_model import I2DModel
    from desr_tpu_torch.models.main_model import MainModel
    from desr_tpu_torch.models.main_sr_model import MainSRModel
    from desr_tpu_torch.models.translation_model import TranslationModel
    from desr_tpu_torch.options import train_options

    f32 = ["--compute_dtype", "float32"]
    argv, cls = {
        "main": (_train_argv(tmp, "q", f32, aug=True), MainModel),
        "sr": (_sr_train_argv(tmp, "q") + f32 + ["--crop_size_h", str(DP_SR_LR[0]),
                                                  "--crop_size_w", str(DP_SR_LR[1])],
               MainSRModel),
        "i2d": (_i2d_train_argv(tmp, "q", f32 + ["--batch_size", str(DP_I2D[0]),
                                                 "--pool_size", "2"]), I2DModel),
        "translation": (_translation_argv(tmp, "q", f32 + [
            "--batch_size", str(DP_TRANS[0]), "--netD", "Gu", "--num_iter_gen", "1"]),
            TranslationModel),
    }[kind]
    opt = train_options.parse(argv, print_options=False)
    return cls(opt, device=mesh.device, compute_dtype=torch.float32, is_train=True,
               generator=torch.Generator().manual_seed(8), mesh=mesh)


def _dp_batches():
    b, h, w = DP_TRANS
    t = _synthetic_batch(b, h, w, 43)
    return {"main": _synthetic_batch(*DP_MAIN, 41),
            "i2d": _synthetic_batch(*DP_I2D, 42),
            "translation": {"A_depth": t["A_d"], "A_img": t["A_i"], "B_depth": t["B_d"],
                            "B_img": t["B_i"]},
            "sr": _synthetic_batch(1, 2 * DP_SR_LR[0], 2 * DP_SR_LR[1], 44, lr_hw=DP_SR_LR)}


def _dp_step(kind, tmp, mesh, batch, perturb=False):
    """One step of ``kind`` on ``mesh`` (its launches counted from just
    before the step to just after): the global metrics, the gradients left
    on the nets the step trains (G and, where it has one, D), the running
    statistics, and for I2D the replay pool. ``perturb``: K1's outputs
    jittered by 1e-6 relative (``_train_parity``'s yardstick)."""
    import torch

    from desr_tpu_torch.ops import conv3x3 as K

    model = _dp_model(kind, tmp, mesh)
    model.set_input(batch)
    iters = len(next(iter(batch.values())))
    run = K._fused_forward
    noise = torch.Generator(device=mesh.device).manual_seed(12)

    def jittered(*args):
        res = run(*args)
        out = res[0] if isinstance(res, tuple) else res
        out = out * (1 + 1e-6 * torch.randn(out.shape, generator=noise, device=out.device))
        return (out, *res[1:]) if isinstance(res, tuple) else out

    with mock.patch.object(K, "_fused_forward", jittered if perturb else run):
        torch.cuda.synchronize()
        _reset_counts()
        model.optimize_parameters(iters)
        torch.cuda.synchronize()
        counts = _counts()
    nets = list(model.optimized_nets)
    res = {"metrics": {k: float(v) for k, v in model.metrics.items()}, "counts": counts,
           "split": model.step_group is not None,
           "grads": {f"{n}.{k}": _dp_host(p.grad) for n in nets
                     for k, p in model.nets[n].named_parameters() if p.grad is not None},
           "weights": {f"{n}.{k}": _dp_host(p) for n in nets
                       for k, p in model.nets[n].named_parameters()},
           "stats": {f"{n}.{k}": _dp_host(v) for n in model.model_names
                     for k, v in model.nets[n].state_dict().items() if "running" in k}}
    if kind == "i2d":
        pool = model.fake_depth_pool
        res.update(pool=_dp_host(torch.stack(pool.images)), pool_rng=pool.rng.getstate())
    return model, res, iters


def _dp_time(model, batch, iters):
    """Host ms a step of ``DP_TIMED`` main steps, the card synchronised."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DP_TIMED):
        model.set_input(batch)
        model.optimize_parameters(iters)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / DP_TIMED


def _dp_rank(mesh, tmp):
    """One of phase (q)'s ranks: the four steps on its rows of each global
    batch, then the main step timed (``DP_TIMED`` steps, both ranks on the
    one card) and the gradient average alone (``DP_REDUCE`` calls)."""
    import torch
    import torch.distributed as dist

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    with _Deterministic():
        batches = _dp_batches()
        for kind in ("main", "translation", "i2d", "sr"):
            model, out[kind], iters = _dp_step(kind, tmp, mesh, batches[kind])
            if kind != "main":
                continue
            dist.barrier()
            out["step_ms"] = _dp_time(model, batches[kind], iters)
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(DP_REDUCE):
                model.reduce_grads(model.trainable_nets)
            torch.cuda.synchronize()
            out["reduce_ms"] = (time.perf_counter() - t0) * 1e3 / DP_REDUCE
            out["reduce_mib"] = sum(p.numel() for n in model.trainable_nets
                                    for p in model.nets[n].parameters()) * 4 / 2 ** 20
            del model
            torch.cuda.empty_cache()
    return out


def _dp_rel(a, b, scale=None):
    import numpy as np

    return float(np.linalg.norm(a - b) / (scale or max(np.linalg.norm(b), 1e-30)))


def _dp_check(kind, ranks, one, yards, term_rtol, stats_tol=None, weights_tol=None):
    """Phase (q)'s checks of one step: the ranks split the batch (not SR's
    batch of 1) and agree bit for bit on what they reduced; each rank ran
    the kernels as the one-process path does. Against the one-process step
    ``one``: each term within max(``term_rtol``, 3x its gap in the
    one-process steps ``yards``); each weight gradient within max(1e-3, 3x
    that gap) relative L2 and each bias within 1e-3 of its net's largest
    weight gradient, or with ``weights_tol`` (rtol, atol) the weights after
    the step instead, as the CPU tests of the adversarial stages hold them;
    the running statistics within ``stats_tol`` (rtol, atol). Returns the
    worst gaps."""
    import numpy as np

    def yard(key, k, rel):
        return max(rel(y[key][k], one[key][k]) for y in yards)

    def term_bound(k):
        return max(term_rtol, 3 * yard("metrics", k, lambda a, b: abs(a - b) / max(abs(b), 1e-12)))

    def grad_bound(k):
        return max(1e-3, 3 * yard("grads", k, _dp_rel))

    r0, r1 = ranks
    check(r0["split"] == r1["split"] == (kind != "sr") and not one["split"],
          f"[q] {kind}: split {r0['split']}, {r1['split']}, one process {one['split']}")
    for key in ("metrics", "grads", "weights", "stats"):
        for k in r0[key]:
            check(np.array_equal(r0[key][k], r1[key][k]), f"[q] {kind}: the ranks differ on {k}")
    for r, res in enumerate(ranks):
        check(res["counts"] == one["counts"]
              and _holds(res["counts"], {**DP_LAUNCHES[kind], "K2": 0,
                                         **_k4(STEP_K4[kind], device=DP_DEVICE)}),
              f"[q] {kind}: rank {r} launches {res['counts']}, one process {one['counts']}, "
              f"want {DP_LAUNCHES[kind]}, K4 {STEP_K4[kind]}")
    terms = {k: abs(r0["metrics"][k] - v) / max(abs(v), 1e-12) for k, v in one["metrics"].items()}
    bad = [k for k, v in one["metrics"].items()
           if abs(r0["metrics"][k] - v) > term_bound(k) * abs(v) + 1e-7]
    check(not bad, f"[q] {kind}: terms off "
          + ", ".join(f"{k} ({terms[k]:.3g} > {term_bound(k):.3g})" for k in bad))
    net_scale = {}
    for k, v in one["grads"].items():
        if not k.endswith("bias"):
            n = k.split(".")[0]
            net_scale[n] = max(net_scale.get(n, 0.0), float(np.linalg.norm(v)))
    gaps, bad = {}, []
    for k, v in one["grads"].items():
        scale = net_scale[k.split(".")[0]] if k.endswith("bias") else None
        gaps[k] = _dp_rel(r0["grads"][k], v, scale)
        if gaps[k] > (1e-3 if k.endswith("bias") else grad_bound(k)):
            bad.append(k)
    if weights_tol:
        rtol, atol = weights_tol
        bad = [k for k, v in one["weights"].items()
               if not np.allclose(r0["weights"][k], v, rtol=rtol, atol=atol)]
    check(not bad, f"[q] {kind}: " + ("weights after the step off in " + ", ".join(bad[:5])
                                      if weights_tol else "gradients off " + ", ".join(
        f"{k} ({gaps[k]:.3g} > {grad_bound(k):.3g})" for k in bad[:5])))
    weights_gap = max(float(np.abs(r0["weights"][k] - v).max())
                      for k, v in one["weights"].items())
    stats = {k: float(np.abs(r0["stats"][k] - v).max()) for k, v in one["stats"].items()}
    if stats_tol:
        rtol, atol = stats_tol
        bad = [k for k, v in one["stats"].items()
               if not np.allclose(r0["stats"][k], v, rtol=rtol, atol=atol)]
        check(not bad, f"[q] {kind}: running statistics off in {bad[:5]}")
    weights = sorted(v for k, v in gaps.items() if not k.endswith("bias"))
    return {"terms_max_rel": max(terms.values()), "grad_median_rel": weights[len(weights) // 2],
            "grad_worst_rel": weights[-1],
            "floor_grad_worst_rel": max(yard("grads", k, _dp_rel) for k in gaps
                                        if not k.endswith("bias")),
            "bias_worst": max([v for k, v in gaps.items() if k.endswith("bias")] or [0.0]),
            "weights_max_abs": weights_gap,
            "stats_max_abs": max(stats.values()) if stats else None}


def _dp_predict(tmp):
    """``predict --num_devices 1`` against the CLI without the flag (today's
    output) on 4 frames at the default widths; ``--num_devices 2`` on this
    one-card machine raises, in the serving and the train CLI."""
    import contextlib
    import io

    import numpy as np
    import torch

    from desr_tpu_torch import checkpoints as ckpt
    from desr_tpu_torch import predict, train
    from desr_tpu_torch.models.main_model import NET_NAMES, MainModel, NetOptions

    _write_frames(os.path.join(tmp, "req"), 4, seed=5)
    model = MainModel(NetOptions(), device="cuda", generator=torch.Generator().manual_seed(1))
    for name in NET_NAMES:
        ckpt.save_net(model.nets[name], ckpt.net_ckpt_path(tmp, "dp", "latest", name))
    base = ["--name", "dp", "--checkpoints_dir", tmp,
            "--input_depth", os.path.join(tmp, "req", "depth"),
            "--input_img", os.path.join(tmp, "req", "img"), "--batch_size", "4"]
    outs = {}
    # cuDNN's default bf16 forward does not repeat bit for bit (phase (m))
    with _Deterministic():
        for tag, extra in (("default", []), ("one", ["--num_devices", "1"])):
            predict.main(base + ["--output", os.path.join(tmp, tag)] + extra)
            outs[tag] = _read_outputs(os.path.join(tmp, tag), 4)
    check(np.array_equal(outs["one"], outs["default"]),
          "[q] predict --num_devices 1 differs from the CLI without it")
    refused = {}
    for name, fn, argv in (
            ("predict", predict.main, base + ["--output", os.path.join(tmp, "two"),
                                              "--num_devices", "2"]),
            ("train", train.main, _train_argv(tmp, "dp2", ["--num_devices", "2"]))):
        err = io.StringIO()
        with contextlib.redirect_stderr(err), contextlib.redirect_stdout(io.StringIO()):
            try:
                fn(argv)
                code = 0
            except SystemExit as e:
                code = e.code
        refused[name] = err.getvalue().strip().splitlines()[-1]
        check(code not in (0, None) and "only 1 CUDA device" in refused[name],
              f"[q] {name} --num_devices 2 on one card: exit {code}, {refused[name]!r}")
    print(f"[q] predict --num_devices 1: PNGs bit-equal to the CLI without the flag (4 frames, "
          f"480x640, bf16, deterministic cuDNN); --num_devices 2 on this one card refused: "
          f"{refused}")


def phase_data_parallel(tmp):
    """(q): the data mesh over two gloo ranks on the one card (NCCL takes
    one rank a card), float32, TF32 off, torch's deterministic mode: the
    main step, a stage-2 iteration with --netD Gu, an I2D --use_D step and
    the SR step at batch 1, each against the one-process step on the same
    global batch; then ``predict --num_devices 1`` and the refusal of 2.

    The bounds are the CPU tests' (tests/test_torch_parallel_steps.py,
    _gan.py): terms 1e-5 relative (stage 2: 2e-3), the Gu running
    statistics rtol 2e-3 and atol 5e-4, weight gradients 1e-3 relative L2;
    each widened to 3x the one-process step's own floor where that is
    larger: its gap to the same step run again (SR's bicubic backward has
    no deterministic version) and to the step with K1's outputs jittered by
    1e-6 relative, the scale of the float32 rounding that cuDNN's other
    algorithms at 3 frames a rank than at 6 leave, on steps that are
    ill-conditioned at a random init (phase (e)). SR at batch 1 runs the
    whole batch on both ranks (JAX's replicated case): the average of equal
    gradients."""
    import torch

    from desr_tpu_torch import parallel

    t0 = time.perf_counter()
    ranks = parallel.launch(_dp_rank, [f"{DP_DEVICE}:0"] * DP_RANKS, backend="gloo",
                            args=(tmp,), workdir=tmp)
    launch_s = time.perf_counter() - t0
    one = parallel.make_mesh([DP_DEVICE])
    batches = _dp_batches()
    gaps = {}
    with _Deterministic():
        # (term rtol, running statistics (rtol, atol), weights after the step (rtol,
        # atol)): the CPU tests'; I2D's Adam moves a weight by lr (2e-4) whatever
        # its gradient's size, so a sign flip at the noise floor moves it by 2 lr
        for kind, term_rtol, stats_tol, weights_tol in (
                ("main", 1e-5, None, None), ("sr", 1e-5, None, None),
                ("translation", 2e-3, (2e-3, 5e-4), (2e-3, 6e-4)),
                ("i2d", 1e-5, None, (0.0, 2 * 2e-4 + 1e-7))):
            model, ref, iters = _dp_step(kind, tmp, one, batches[kind])
            if kind == "main":
                one_ms = _dp_time(model, batches[kind], iters)
            del model
            # the one-process step's own floors: run again, and with K1 jittered
            yards = [_dp_step(kind, tmp, one, batches[kind], perturb=p)[1] for p in (False, True)]
            gaps[kind] = _dp_check(kind, [r[kind] for r in ranks], ref, yards, term_rtol,
                                   stats_tol, weights_tol)
            if kind == "i2d":
                pools = (ranks[0]["i2d"], ranks[1]["i2d"], ref)
            torch.cuda.empty_cache()
    import numpy as np

    check(pools[0]["pool_rng"] == pools[1]["pool_rng"] == pools[2]["pool_rng"],
          "[q] i2d: the ranks' replay pools drew otherwise than one process")
    pool_gap = float(np.abs(pools[0]["pool"] - pools[2]["pool"]).max())
    check(pool_gap <= 1e-4, f"[q] i2d: the pool's images off by {pool_gap:.3g}")
    for kind, g in gaps.items():
        print(f"[q] {kind}: 2 ranks vs one process: terms max rel {g['terms_max_rel']:.3g}, "
              f"weight grads rel L2 median {g['grad_median_rel']:.3g} worst "
              f"{g['grad_worst_rel']:.3g} (the one-process floor's worst "
              f"{g['floor_grad_worst_rel']:.3g}), biases worst {g['bias_worst']:.3g}, "
              f"weights after the step max |d| {g['weights_max_abs']:.3g}"
              + (f", running stats max |d| {g['stats_max_abs']:.3g}"
                 if g["stats_max_abs"] is not None else "")
              + f"; launches a rank {ranks[0][kind]['counts']}")
    print(f"[q] i2d: pool draws equal, images max |d| {pool_gap:.3g}")
    step_ms = [r["step_ms"] for r in ranks]
    reduce_ms = [r["reduce_ms"] for r in ranks]
    print(f"[q] main step over 2 gloo ranks that share one card (not a scaling figure): "
          f"{max(step_ms):.1f} ms a step (ranks {step_ms[0]:.1f}, {step_ms[1]:.1f}; batch "
          f"{DP_MAIN[0]} at {DP_MAIN[1]}x{DP_MAIN[2]}, {DP_MAIN[0] // DP_RANKS} a rank, "
          f"float32, deterministic), one process on the whole batch {one_ms:.1f} ms; the "
          f"gradient average alone {max(reduce_ms):.2f} ms a call ({ranks[0]['reduce_mib']:.1f} "
          f"MiB, gloo through the host); launch and all steps {launch_s:.1f} s")
    _dp_predict(tmp)
    print("[q] " + json.dumps({"step_ms": step_ms, "one_process_ms": one_ms,
                               "reduce_ms": reduce_ms,
                               "reduce_mib": ranks[0]["reduce_mib"], "launch_s": launch_s,
                               "gaps": gaps, "pool_max_abs": pool_gap}))
    return {f"train_dp_{kind}_rank{r}": res[kind]["counts"]
            for r, res in enumerate(ranks) for kind in DP_LAUNCHES}


# ------------------------------------------------------------------ (d)

# ------------------------------------------------------------------ (r)

SP_RANKS = 2                # two gloo ranks time-share the one card: one spatial group
SP_DEVICE = "cuda"          # phase (r)'s device (a CPU rehearsal sets "cpu")
SP_ARGV = ()                # flags appended to phase (r)'s CLI runs (a rehearsal's widths)
SP_NET_ARGS = ()            # --net_args of its models (a rehearsal's widths)
# mode: (the CLI's flags, frames, their size, a batch, K1 launches a batch)
SP_MODES = {
    "main": ((), "frames", (480, 640), 8, LAUNCHES_PER_BATCH),
    "sr": (("--SR",), "frames_sr", (960, 1280), 4, LAUNCHES_PER_BATCH),
    "i2d": (("--I2D",), "frames", (480, 640), 8, I2D_K1_PER_BATCH),
    "translate": (("--translate", "AtoB"), "frames", (480, 640), 8, TRANSLATE_K1_PER_BATCH),
}
SP_K4 = {"main": K4_PER_BATCH, "sr": K4_PER_BATCH, "i2d": I2D_K4_PER_BATCH,  # a rank's
         "translate": TRANSLATE_K4_PER_BATCH}
SP_CKPT = {"main": "sp_main", "sr": "sp_main", "i2d": "sp_i2d", "translate": "sp_tr"}
SP_F32_BATCH = 2            # the float32 check's batch (the bf16 one serves the CLI's)
SP_TIMED = 1                # forwards timed a mode, after one
SP_POOLED = {"i2d": 2}      # modes the ranks' CLI serves with --num_workers N (each rank a pool)
SP_F32_BOUND = 1e-3         # float32, deterministic cuDNN: (c)'s bound of the kernels' route


def _sp_argv(tmp, mode, out, extra=(), net_extra=()):
    """The CLI's argv for ``mode`` (bf16, the mode's batch) writing to ``out``."""
    flags, folder, _, batch, _ = SP_MODES[mode]
    argv = ["--name", SP_CKPT[mode], "--checkpoints_dir", tmp, *flags,
            "--input_img", os.path.join(tmp, folder, "img"), "--output", out,
            "--batch_size", str(batch), "--compute_dtype", "bfloat16", *SP_ARGV, *extra]
    if mode != "i2d":
        argv += ["--input_depth", os.path.join(tmp, folder, "depth")]
    net_args = list(SP_NET_ARGS) + list(net_extra)
    return argv + (["--net_args", *net_args] if net_args else [])


def _sp_model(mode, tmp, mesh):
    """The mode's model on ``mesh``'s device, its checkpoints loaded, bf16."""
    import torch

    from desr_tpu_torch import predict
    from desr_tpu_torch.models.i2d_model import I2DModel
    from desr_tpu_torch.models.main_model import MainModel
    from desr_tpu_torch.models.main_sr_model import MainSRModel
    from desr_tpu_torch.models.translation_model import TranslationModel

    hw = SP_MODES[mode][2]
    # the SR grid's LR half of the frame padded to /256, as the CLI takes it
    lr = [str(-(-n // 256) * 128) for n in hw]
    opt = predict.parse_net_args(list(SP_NET_ARGS) + (
        ["--crop_size_h", lr[0], "--crop_size_w", lr[1]] if mode == "sr" else []))
    kw = dict(device=mesh.device, compute_dtype=torch.bfloat16, mesh=mesh)
    model = (TranslationModel(opt, direction="AtoB", **kw) if mode == "translate" else
             {"main": MainModel, "sr": MainSRModel, "i2d": I2DModel}[mode](opt, **kw))
    model.load_networks(tmp, SP_CKPT[mode], verbose=False)
    return model


def _sp_batch(tmp, mode, n):
    """The first ``n`` frames of the mode's folder as one global host batch."""
    import numpy as np

    from desr_tpu_torch import predict

    _, folder, _, _, _ = SP_MODES[mode]
    frames = [predict.decode_frame(os.path.join(tmp, folder, "depth", f"f{i:02d}.png"),
                                   os.path.join(tmp, folder, "img", f"f{i:02d}.png"), 5100.0,
                                   256 if mode == "sr" else 128) for i in range(n)]
    return {"B_d": np.stack([f[0] for f in frames]), "B_i": np.stack([f[1] for f in frames])}


def _sp_counts():
    from desr_tpu_torch.ops import conv3x3 as K
    from desr_tpu_torch.parallel import spatial as S

    from desr_tpu_torch.ops import instance_norm as K4

    return {"K1": K.conv3x3_fused.launches, "K1 halo": K.conv3x3_fused.launches_halo,
            "K2": K.conv3x3.launches, "K2 halo": K.conv3x3.launches_halo,
            "K4": K4.instance_norm_moments.launches, "K4 apply": K4.norm_apply.launches,
            **S.COUNTS}


def _sp_reset():
    import torch

    from desr_tpu_torch.parallel import spatial as S

    torch.cuda.synchronize()
    _reset_counts()
    from desr_tpu_torch.ops import conv3x3 as K

    K.conv3x3_fused.launches_halo = K.conv3x3.launches_halo = 0
    S.reset_counts()


def _sp_forwards(mode, tmp, mesh):
    """One mode's serving forward on ``mesh``: launches and collectives of
    one bf16 forward of the CLI's batch, its peak memory (this process's),
    ms a forward (CUDA events, ``SP_TIMED`` after one; the ranks in step),
    its predictions (this rank's rows, on the host), then float32 under
    deterministic cuDNN on ``SP_F32_BATCH`` frames."""
    import torch

    model = _sp_model(mode, tmp, mesh)
    batch = _sp_batch(tmp, mode, SP_MODES[mode][3])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _sp_reset()
    pred = model.serve_forward(batch)
    torch.cuda.synchronize()
    out = {"counts": _sp_counts(), "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "bf16": pred.float().cpu().numpy()}
    out["ms"] = cuda_ms(lambda: model.serve_forward(batch), iters=SP_TIMED, warmup=1)
    model.compute_dtype = torch.float32
    small = {k: v[:SP_F32_BATCH] for k, v in batch.items()}
    with _Deterministic():
        out["f32"] = model.serve_forward(small).cpu().numpy()
        model.compute_dtype = torch.bfloat16
        out["bf16_small"] = model.serve_forward(small).float().cpu().numpy()
    del model, pred
    torch.cuda.empty_cache()
    return out


def _sp_rank(mesh, tmp):
    """One of phase (r)'s ranks: the CLI's rank (``predict._rank_serve``) in
    each mode (``SP_POOLED``'s with a pool of host workers a rank, which
    ``_rank_serve`` ends before it returns), then under ``--pallas_conv``
    (K2), each with its launches and collectives; then ``_sp_forwards`` of
    each mode."""
    import torch

    from desr_tpu_torch import predict

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"cli": {}, "forward": {}}
    for mode in SP_MODES:
        _sp_reset()
        t0 = time.perf_counter()
        pool = ["--num_workers", str(SP_POOLED[mode])] if mode in SP_POOLED else []
        predict._rank_serve(mesh, _sp_argv(tmp, mode, os.path.join(tmp, f"out2_{mode}"), pool))
        torch.cuda.synchronize()
        res["cli"][mode] = dict(_sp_counts(), wall_s=time.perf_counter() - t0)
    _sp_reset()
    predict._rank_serve(mesh, _sp_argv(tmp, "main", os.path.join(tmp, "out2_k2"),
                                       net_extra=["--pallas_conv"]))
    res["cli"]["main_pallas_conv"] = _sp_counts()
    for mode in SP_MODES:
        res["forward"][mode] = _sp_forwards(mode, tmp, mesh)
    return res


def _sp_gap(a, b):
    import numpy as np

    d = np.abs(a - b)
    return float(d.max()), float(d.mean())


def phase_spatial(tmp):
    """(r): ``predict --num_devices 2 --spatial_devices 2`` over two gloo
    ranks on the one card (NCCL takes one rank a card), each frame's rows
    split between them: main, --SR (960x1280 frames, HR 1024x1280),
    --I2D and --translate AtoB at the default widths in bf16, and main
    under --pallas_conv, through the CLI's rank entry
    (``predict._rank_serve``: rank 0 gathers and writes the PNGs), against
    ``predict --num_devices 1``. Then each mode's forward: launches and
    collectives a forward, peak memory a rank, ms a batch (two processes
    time-sharing one card: not a scaling figure), and the predictions:
    float32 under deterministic cuDNN within ``SP_F32_BOUND``; bf16 within
    the one-process route's own spread (its bf16 against its float32 on the
    same frames, and PERF.md's 0.045 between live runs, the larger)."""
    import numpy as np
    import torch

    from desr_tpu_torch import checkpoints as ckpt
    from desr_tpu_torch import parallel, predict
    from desr_tpu_torch.models.main_model import MainModel, NetOptions
    from desr_tpu_torch.models.i2d_model import I2DModel
    from desr_tpu_torch.models.translation_model import TranslationModel

    t0 = time.perf_counter()
    for seed, (_, folder, hw, n, _) in enumerate(SP_MODES.values()):
        if not os.path.isdir(os.path.join(tmp, folder)):
            _write_frames(os.path.join(tmp, folder), n, seed=90 + seed, hw=hw)
    opt = predict.parse_net_args(list(SP_NET_ARGS))
    for name, cls, seed in (("sp_main", MainModel, 1), ("sp_i2d", I2DModel, 3),
                            ("sp_tr", TranslationModel, 4)):
        model = cls(opt, device=SP_DEVICE, generator=torch.Generator().manual_seed(seed))
        names = model.model_names if name != "sp_main" else (
            "I2D_features", "Image2Depth", "Depth_f", "Task")
        for n in names:
            ckpt.save_net(model.nets[n], ckpt.net_ckpt_path(tmp, name, "latest", n))
        del model
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = parallel.launch(_sp_rank, [f"{SP_DEVICE}:0"] * SP_RANKS, backend="gloo",
                            args=(tmp,), workdir=tmp, spatial=SP_RANKS)
    ranks_s = time.perf_counter() - t0
    one = parallel.make_mesh([SP_DEVICE])
    report = {"setup_s": setup_s, "ranks_s": ranks_s}
    paths = {}
    for mode, (_, _, hw, n, k1) in SP_MODES.items():
        _sp_reset()
        out1 = os.path.join(tmp, f"out1_{mode}")
        t1 = time.perf_counter()
        predict.main(_sp_argv(tmp, mode, out1, ["--num_devices", "1"]))
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t1
        want = {"K1": k1, "K1 halo": 0, "K2": 0, "K2 halo": 0,
                **_k4(SP_K4[mode], device=SP_DEVICE)}
        got1 = {k: v for k, v in _sp_counts().items() if k in want}
        check(got1 == want, f"[r] {mode} --num_devices 1: launches {got1}; want {want}")
        for r, rank in enumerate(ranks):
            c = rank["cli"][mode]
            # every ResnetBlock is split at these frames: each launch has a halo row
            check(c["K1"] == k1 and c["K1 halo"] == k1 and c["K2"] == 0
                  and _holds(c, _k4(SP_K4[mode], device=SP_DEVICE)),
                  f"[r] {mode} rank {r}: launches {c}; want K1 {k1}, all with a halo row, "
                  f"K4 {SP_K4[mode]}")
            paths[f"serve_spatial_{mode}_rank{r}"] = {
                k: c[k] for k in ("K1", "K1 halo", "K4", "K4 apply")}
        check(ranks[0]["cli"][mode] == {**ranks[1]["cli"][mode],
                                        "wall_s": ranks[0]["cli"][mode]["wall_s"]},
              f"[r] {mode}: the ranks issued other launches or collectives: "
              f"{ranks[0]['cli'][mode]} / {ranks[1]['cli'][mode]}")
        png1 = _read_outputs(out1, n, hw=hw)
        png2 = _read_outputs(os.path.join(tmp, f"out2_{mode}"), n, hw=hw)
        check(int(png2.max()) > 0, f"[r] {mode}: all zeros")
        d_png = np.abs(png2 - png1)
        fwd1 = _sp_forwards(mode, tmp, one)
        fwd2 = [rank["forward"][mode] for rank in ranks]
        f32_2 = np.concatenate([f["f32"] for f in fwd2], 1)
        bf_2 = np.concatenate([f["bf16_small"] for f in fwd2], 1)
        check(f32_2.shape == fwd1["f32"].shape and np.isfinite(f32_2).all(),
              f"[r] {mode}: float32 rows {f32_2.shape} or non-finite")
        g32 = _sp_gap(f32_2, fwd1["f32"])
        gbf = _sp_gap(bf_2, fwd1["bf16_small"])
        spread = _sp_gap(fwd1["bf16_small"], fwd1["f32"])
        bound = max(0.045, spread[0])
        check(g32[0] <= SP_F32_BOUND, f"[r] {mode} float32: 2 ranks vs one process max |d| "
              f"{g32[0]:.3g} > {SP_F32_BOUND}")
        check(gbf[0] <= bound, f"[r] {mode} bf16: 2 ranks vs one process max |d| {gbf[0]:.3g} "
              f"> {bound:.3g}")
        c = fwd2[0]["counts"]
        report[mode] = {
            "png_max_mm": int(d_png.max()), "png_mean_mm": float(d_png.mean()),
            "f32_max": g32[0], "f32_mean": g32[1], "bf16_max": gbf[0], "bf16_mean": gbf[1],
            "one_process_bf16_vs_f32_max": spread[0], "one_process_bf16_vs_f32_mean": spread[1],
            "ms_2_ranks": [f["ms"] for f in fwd2], "ms_one_process": fwd1["ms"],
            "peak_gib_ranks": [f["peak_gib"] for f in fwd2], "peak_gib_one_process": fwd1["peak_gib"],
            "forward_counts_rank": c, "cli_wall_s_ranks": [r["cli"][mode]["wall_s"] for r in ranks],
            "cli_wall_s_one_process": wall1, "num_workers_ranks": SP_POOLED.get(mode, 0)}
        print(f"[r] {mode} ({n} frames {hw[0]}x{hw[1]}, --num_workers "
              f"{SP_POOLED.get(mode, 0)} a rank): per rank K1 {c['K1']} a forward, "
              f"{c['K1 halo']} with halo rows; {c['exchange']} halo exchanges, {c['all_reduce']} "
              f"moment all-reduces, {c['gather']} gathers along H a forward; "
              f"{max(report[mode]['ms_2_ranks']):.2f} ms a batch over 2 gloo ranks sharing one "
              f"card (not a scaling figure) vs one process {fwd1['ms']:.2f}; peak memory a rank "
              f"{max(report[mode]['peak_gib_ranks']):.3f} GiB vs one process "
              f"{fwd1['peak_gib']:.3f}; float32 max |d| {g32[0]:.3g} (bound {SP_F32_BOUND}); "
              f"bf16 max |d| {gbf[0]:.3g}, mean {gbf[1]:.3g} (bound {bound:.3g}: the one "
              f"process's bf16 vs float32 max {spread[0]:.3g}); PNGs max {int(d_png.max())} mm, "
              f"mean {float(d_png.mean()):.3f} mm")
    k2 = ranks[0]["cli"]["main_pallas_conv"]
    check(k2["K2"] == LAUNCHES_PER_BATCH and k2["K2 halo"] == LAUNCHES_PER_BATCH
          and k2["K1"] == 0 and _holds(k2, _k4(K4_PALLAS_PER_BATCH, device=SP_DEVICE)),
          f"[r] --pallas_conv over 2 ranks: launches {k2}; want K4 {K4_PALLAS_PER_BATCH}")
    for r, rank in enumerate(ranks):
        paths[f"serve_spatial_pallas_conv_rank{r}"] = {
            k: rank["cli"]["main_pallas_conv"][k] for k in ("K2", "K2 halo", "K4", "K4 apply")}
    print(f"[r] main --pallas_conv over 2 ranks: per rank K2 {k2['K2']}, {k2['K2 halo']} with "
          "halo rows")
    print("[r] " + json.dumps(report))
    return paths


# ------------------------------------------------------------------ (s)

ST_RANKS = 2                # two gloo ranks time-share the one card: one spatial group
ST_DEVICE = "cuda"          # phase (s)'s device (a CPU rehearsal sets "cpu")
ST_WIDTH = ("--ImageDepthf_outf", "8", "--ImageDepthf_basef", "8", "--Depthf_outf", "8",
            "--Depthf_basef", "8", "--I2D_base", "8", "--Task_basef", "8", "--Imagef_outf",
            "8", "--Imagef_basef", "8", "--ndf", "8")  # the float32 checks' widths
# the float32 checks: kind -> (global batch, H, W); SR's H, W are HR (LR 256x256: the
# U-Nets halve the LR grid 7 times)
# stage 2 (translation: one G step, then the D step on its feed) at 128x128, the
# smallest frame whose translator bottleneck (H/4 = 32 rows) two ranks split, at
# the translators' hardcoded widths
# --steps_per_call 2 (main_group: a group of two main steps, the second on a
# batch of its own, at --lr 0 so that the second starts from the first's
# weights on every route: Adam's first step moves each weight by lr x the
# sign of its gradient, which flips at the noise floor) and --device_aug
# (main_device_aug: the main step on the loader's first batch, each rank's
# band of the frames finished on the card)
ST_CHECKS = {"main": (2, 384, 512), "norm_batch": (2, 384, 512), "sr": (1, 512, 512),
             "i2d": (2, 384, 512), "translation": (2, 128, 128),
             "main_group": (2, 384, 512), "main_device_aug": (2, 384, 512)}
# K4's (moments, applies) a rank in each: phase (q)'s steps; main_group two of them
ST_K4 = {**STEP_K4, "norm_batch": K4_NORM_BATCH_PER_STEP,
         "main_group": tuple(2 * v for v in K4_PER_STEP), "main_device_aug": K4_PER_STEP}
ST_FULL_ARGV = ()           # flags appended to the bf16 full-width runs (a rehearsal's widths)
ST_SR_HR = (1024, 1280)     # the bf16 SR step's HR frame: bench.py's geometry
ST_TIMED = 1                # bf16 SR steps timed, after one
ST_JITTER_SEEDS = (12, 13)  # the one-process floor: the larger gap of two jittered steps
ST_GROUP_SEEDS = {"main_group": (14,)}  # a third draw for the group's second step
ST_STAGE2 = (6, 256, 256)   # the bf16 stage-2 iteration: the README's batch and crops
ST_STAGE2_TIMED = 1         # its iterations timed, after one (~1400 collectives each)
ST_STAGE2_FRAMES = (2, 12)  # frames written a domain for its CLI run, and linked to


def _st_argv(kind, tmp):
    """The float32 check's argv of ``kind`` at width 8."""
    f32 = ["--compute_dtype", "float32", *ST_WIDTH]
    b, h, w = ST_CHECKS[kind]
    if kind == "translation":  # the translators' widths are hardcoded; the Ds' at ndf 64
        return _translation_argv(tmp, "st", ["--compute_dtype", "float32", "--batch_size",
                                             str(b), "--crop_size_h", str(h), "--crop_size_w",
                                             str(w), "--num_iter_gen", "1"])
    if kind == "sr":
        return _sr_train_argv(tmp, "st") + f32 + ["--crop_size_h", str(h // 2),
                                                   "--crop_size_w", str(w // 2)]
    if kind == "i2d":
        return _i2d_train_argv(tmp, "st", f32 + ["--batch_size", str(b), "--pool_size", "2"])
    return _train_argv(tmp, "st", f32 + ["--batch_size", str(b)]
                       + (["--norm", "batch"] if kind == "norm_batch" else [])
                       + (["--device_aug"] if kind == "main_device_aug" else [])
                       + (["--lr", "0"] if kind == "main_group" else []), aug=True)


def _st_batch(kind):
    """The kind's global host batch (main_group: a list of two; None for
    main_device_aug, whose loader gives it)."""
    b, h, w = ST_CHECKS[kind]
    seed = 60 + list(ST_CHECKS).index(kind)
    if kind == "translation":
        return _translation_batch(b, h, w, seed)
    if kind == "main_group":
        return [_synthetic_batch(b, h, w, seed), _synthetic_batch(b, h, w, seed + 100)]
    if kind == "main_device_aug":
        return None
    return _synthetic_batch(b, h, w, seed, lr_hw=(h // 2, w // 2) if kind == "sr" else None)


def _st_device_aug_batch(opt, mesh):
    """The first batch of ``opt``'s ``--device_aug`` loader on ``mesh``: on
    ranks their band of the data group's frames, finished on the card
    (``RankLoader`` over ``DeviceLoader``), in one process the whole batch,
    drawn as the ranks draw (``shared_draws``); and its tensors on the host."""
    import torch

    from desr_tpu_torch.data.loader import create_dataset
    from desr_tpu_torch.data.main_dataset import MainDataset

    loader = create_dataset(opt, MainDataset, device=mesh.device,
                            mesh=mesh if mesh.size > 1 else None)
    loader.dataset.shared_draws = True
    batch = next(iter(loader))
    return batch, {k: _dp_host(v) for k, v in batch.items() if torch.is_tensor(v)}


def _translation_batch(b, h, w, seed):
    """A stage-2 batch as ``TranslationDataset`` gives it: depths in [-1, 1]
    with 5% holes at -1, images in [-1, 1]."""
    bat = _synthetic_batch(b, h, w, seed)
    return {"A_depth": bat["A_d"], "A_img": bat["A_i"], "B_depth": bat["B_d"],
            "B_img": bat["B_i"]}


def _st_counts():
    """K1's launches (with halo rows among them) and backwards with halo
    rows, K3's, and the collectives: halo exchanges, gathers along H and
    the spatial moments' all-reduces in the forward, every all_reduce_sum
    (BatchNorm, counts, moments) and the adjoints in the backward."""
    from desr_tpu_torch.ops import conv3x3 as K
    from desr_tpu_torch.parallel import mesh as M
    from desr_tpu_torch.parallel import spatial as S

    return {**_counts(), "K1 halo": K.conv3x3_fused.launches_halo,
            "K1 backward halo": K.conv3x3_fused.backwards_halo, **S.COUNTS, **M.COUNTS}


def _st_reset():
    from desr_tpu_torch.ops import conv3x3 as K
    from desr_tpu_torch.parallel import mesh as M
    from desr_tpu_torch.parallel import spatial as S

    _reset_counts()
    K.conv3x3_fused.launches_halo = K.conv3x3_fused.backwards_halo = 0
    S.reset_counts()
    for k in M.COUNTS:
        M.COUNTS[k] = 0


class _StJitter:
    """The one-process step's own floor: K1's outputs, the InstanceNorms'
    moments and the BatchNorms' outputs times (1 + 1e-6 N(0, 1)), the scale
    of the float32 rounding that the bands' other summation order leaves
    (phase (q)'s yardstick, which jitters K1 alone), drawn from ``seed``;
    with ``group_norm`` the GroupNorms' outputs too (the stage-2
    translators normalise by GroupNorm)."""

    def __init__(self, seed, group_norm=False):
        self.seed, self.group_norm = seed, group_norm

    def __enter__(self):
        import contextlib

        import torch

        from desr_tpu_torch.models import layers as TL
        from desr_tpu_torch.ops import conv3x3 as K
        from desr_tpu_torch.ops import instance_norm as IN

        gen = torch.Generator(device=ST_DEVICE).manual_seed(self.seed)

        def noise(t):
            return t * (1 + 1e-6 * torch.randn(t.shape, generator=gen, device=t.device))

        run, moments, bn = K._fused_forward, IN.instance_norm_moments, TL.BatchNorm2d.forward
        gn = TL.GroupNorm.forward

        def conv(*args):
            res = run(*args)
            return (noise(res[0]), *res[1:]) if isinstance(res, tuple) else noise(res)

        self.stack = contextlib.ExitStack()
        for patch in (mock.patch.object(K, "_fused_forward", conv),
                      mock.patch.object(IN, "instance_norm_moments",
                                        lambda x: tuple(noise(t) for t in moments(x))),
                      mock.patch.object(TL.BatchNorm2d, "forward",
                                        lambda m, x: noise(bn(m, x))),
                      mock.patch.object(TL.GroupNorm, "forward",
                                        (lambda m, x: noise(gn(m, x))) if self.group_norm
                                        else gn)):
            self.stack.enter_context(patch)

    def __exit__(self, *exc):
        self.stack.close()


def _st_step(kind, tmp, mesh, jitter=None):
    """One float32 step of ``kind`` on ``mesh`` (two for I2D --use_D, whose
    pool swaps in the second; for stage 2 an iteration of one G step and
    the D step), its weights drawn from seed 8: the global
    metrics, the first step's gradients on the optimized nets, their
    weights and every running statistic after it, the replay pool, and the
    launches and collectives of the first step. ``jitter``: a seed of
    ``_StJitter``'s noise, or None."""
    import contextlib

    import torch

    from desr_tpu_torch.models.i2d_model import I2DModel
    from desr_tpu_torch.models.main_model import MainModel
    from desr_tpu_torch.models.main_sr_model import MainSRModel
    from desr_tpu_torch.models.translation_model import TranslationModel
    from desr_tpu_torch.options import train_options

    cls = {"sr": MainSRModel, "i2d": I2DModel, "translation": TranslationModel}.get(kind,
                                                                                    MainModel)
    opt = train_options.parse(_st_argv(kind, tmp), print_options=False)
    model = cls(opt, device=mesh.device, compute_dtype=torch.float32, is_train=True,
                generator=torch.Generator().manual_seed(8), mesh=mesh)
    batch = _st_batch(kind)
    nets = list(model.optimized_nets)
    b = ST_CHECKS[kind][0]
    res = {}
    if kind == "main_device_aug":
        batch, res["batch"] = _st_device_aug_batch(opt, mesh)
    with (_StJitter(jitter, group_norm=kind == "translation") if jitter is not None
          else contextlib.nullcontext()):
        for it in range(1, 3 if kind == "i2d" else 2):
            if kind != "main_group":
                model.set_input(batch)
            torch.cuda.synchronize() if ST_DEVICE == "cuda" else None
            _st_reset()
            if kind == "main_group":  # both steps counted; the second's gradients kept
                model.optimize_parameters_multi(batch, len(batch) * b)
            else:
                model.optimize_parameters(it * b)
            torch.cuda.synchronize() if ST_DEVICE == "cuda" else None
            if it == 1:
                res["counts"] = _st_counts()
                res["grads"] = {f"{n}.{k}": _dp_host(p.grad) for n in nets
                                for k, p in model.nets[n].named_parameters()
                                if p.grad is not None}
    res.update(metrics={k: float(v) for k, v in model.metrics.items()},
               split=model.step_group is not None, h_split=bool(model._batch.h_split),
               weights={f"{n}.{k}": _dp_host(p) for n in nets
                        for k, p in model.nets[n].named_parameters()},
               stats={f"{n}.{k}": _dp_host(v) for n in model.model_names
                      for k, v in model.nets[n].state_dict().items() if "running" in k})
    if kind == "i2d":
        pool = model.fake_depth_pool
        res.update(pool=_dp_host(torch.stack(pool.images)), pool_rng=pool.rng.getstate())
    if kind == "main_group" and mesh.size > 1 and jitter is None:
        res["group_vs_single"] = _st_group_vs_single(tmp, mesh, batch)
    return res


def _st_group_vs_single(tmp, mesh, batches):
    """On the ranks, at the default lr (the weights moving between the
    steps): the ``optimize_parameters_multi`` group of ``batches`` and the
    same steps one at a time from the same init, each in a model of its
    own: whether their metrics, gradients and weights are bit-equal (phase
    (n)'s check of one process, here on bands), and their launches and
    collectives."""
    import torch

    from desr_tpu_torch.models.main_model import MainModel
    from desr_tpu_torch.options import train_options

    argv = [a for a in _st_argv("main_group", tmp)]
    i = argv.index("--lr")
    del argv[i:i + 2]
    b = len(batches[0]["A_i"])
    runs = []
    for grouped in (True, False):
        model = MainModel(train_options.parse(argv, print_options=False), device=mesh.device,
                          compute_dtype=torch.float32, is_train=True,
                          generator=torch.Generator().manual_seed(8), mesh=mesh)
        _st_reset()
        if grouped:
            model.optimize_parameters_multi(batches, len(batches) * b)
        else:
            for it, batch in enumerate(batches, 1):
                model.set_input(batch)
                model.optimize_parameters(it * b)
        torch.cuda.synchronize() if ST_DEVICE == "cuda" else None
        runs.append(({k: float(v) for k, v in model.metrics.items()},
                     {f"{n}.{k}": p.grad.clone() for n in model.trainable_nets
                      for k, p in model.nets[n].named_parameters() if p.grad is not None},
                     {f"{n}.{k}": p.detach().clone() for n in model.trainable_nets
                      for k, p in model.nets[n].named_parameters()}, _st_counts()))
        del model
    (m0, g0, w0, c0), (m1, g1, w1, c1) = runs
    return {"metrics": m0 == m1, "counts": c0 == c1,
            "grads": all(torch.equal(v, g1[k]) for k, v in g0.items()),
            "weights": all(torch.equal(v, w1[k]) for k, v in w0.items())}


def _st_full_argv(tmp):
    """bench.py's SR configuration through the CLI: batch 1, LR 512x640 ->
    HR 1024x1280, --norm_loss --use_smooth_loss, bf16, 2 steps, over
    ``ST_RANKS`` spatial ranks."""
    return (_sr_train_argv(tmp, "stcli") + ["--num_devices", str(ST_RANKS),
                                            "--spatial_devices", str(ST_RANKS)]
            + list(ST_FULL_ARGV))


def _st_timed(model, batch, first_iter, steps=None):
    """ms a step of ``steps`` (``ST_TIMED``) steps of ``model`` on ``batch``
    (host clock, the card synchronised; the ranks start together),
    counting from iteration ``first_iter``."""
    import torch
    import torch.distributed as dist

    steps = steps or ST_TIMED
    if model.mesh.size > 1:
        dist.barrier()
    t0 = time.perf_counter()
    for it in range(steps):
        model.set_input(batch)
        model.optimize_parameters(first_iter + it)
    if ST_DEVICE == "cuda":
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def _st_peak(reset=False):
    """This process's peak GiB on the card since the last reset (None on
    the CPU); with ``reset`` the caches are emptied and a new peak opened."""
    import torch

    if ST_DEVICE != "cuda":
        return None
    if reset:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return None
    return torch.cuda.max_memory_allocated() / 2 ** 30


def _st_sr_bf16(tmp, mesh, remat=False):
    """The bf16 SR step at full width on ``mesh``, HR ``ST_SR_HR``: one
    step's launches and collectives, ms a step over ``ST_TIMED`` steps after
    one and this process's peak memory. With ``remat`` then, on the same
    model: under deterministic cuDNN the step's gradients from the same
    weights and holes without remat twice (the floor) and under
    ``--remat_blocks``, their gaps; then the remat step's launches and
    collectives (its recompute's apart), ms and peak memory."""
    import torch

    from desr_tpu_torch.models.main_sr_model import MainSRModel
    from desr_tpu_torch.options import train_options

    hr = ST_SR_HR
    opt = train_options.parse(_sr_train_argv(tmp, "stcli") + list(ST_FULL_ARGV)
                              + ["--crop_size_h", str(hr[0] // 2),
                                 "--crop_size_w", str(hr[1] // 2)], print_options=False)
    model = MainSRModel(opt, device=mesh.device, compute_dtype=torch.bfloat16, is_train=True,
                        generator=torch.Generator().manual_seed(9), mesh=mesh)
    batch = _synthetic_batch(1, *hr, 64, lr_hw=(hr[0] // 2, hr[1] // 2))
    sync = torch.cuda.synchronize if ST_DEVICE == "cuda" else (lambda: None)
    _st_peak(reset=True)
    model.set_input(batch)
    sync()
    _st_reset()
    model.optimize_parameters(1)
    sync()
    out = {"counts": _st_counts(), "ms": _st_timed(model, batch, 2), "peak_gib": _st_peak()}
    out["losses"] = {k: float(v) for k, v in model.metrics.items()}
    if remat:
        out["remat"] = _st_remat_sr(model, batch, sync)
    del model
    if ST_DEVICE == "cuda":
        torch.cuda.empty_cache()
    return out


def _st_remat_sr(model, batch, sync):
    """``_st_sr_bf16``'s ``--remat_blocks`` half on its model (the staged
    ``batch``): the gaps to the step without remat (loss terms relative;
    weight gradients relative L2 and their floor, the larger gap of the
    step without remat against itself), then the remat step's launches,
    ms and peak GiB."""
    import numpy as np
    import torch

    def run():
        model.hole_generator.manual_seed(11)
        m = model.compute_grads()
        return ({k: float(v) for k, v in m.items()},
                {f"{n}.{k}": p.grad.detach().clone() for n in model.trainable_nets
                 for k, p in model.nets[n].named_parameters() if p.grad is not None})

    def rel(a, b):
        return float(torch.linalg.vector_norm((a - b).float())
                     / torch.linalg.vector_norm(b.float()).clamp(min=1e-30))

    model.set_input(batch)
    with _Deterministic():
        _set_remat(model, "none")
        m0, g0 = run()
        m00, g00 = run()
        _set_remat(model, "remat_blocks")
        m1, g1 = run()
    res = {"terms_rel": {k: abs(m1[k] - v) / max(abs(v), 1e-12) for k, v in m0.items()},
           "terms_floor_rel": {k: abs(m00[k] - v) / max(abs(v), 1e-12) for k, v in m0.items()},
           "grads_rel": {k: rel(g1[k], v) for k, v in g0.items()},
           "grads_floor_rel": {k: rel(g00[k], v) for k, v in g0.items()},
           "grads_bit_equal": int(sum(bool(torch.equal(g1[k], v)) for k, v in g0.items())),
           "grads_n": len(g0)}
    res["grads_norm"] = float(np.sqrt(sum(float(v.float().square().sum()) for v in g1.values())))
    del g0, g00, g1
    _st_peak(reset=True)
    model.set_input(batch)
    sync()
    _st_reset()
    model.optimize_parameters(1)
    sync()
    res.update(counts=_st_counts(), ms=_st_timed(model, batch, 2), peak_gib=_st_peak(),
               losses={k: float(v) for k, v in model.metrics.items()})
    _set_remat(model, "none")
    return res


def _st_stage2_argv(tmp, name, extra=()):
    """The README's stage-2 flags (``_translation_argv``) over ``ST_RANKS``
    spatial ranks."""
    return _translation_argv(tmp, name, ["--num_devices", str(ST_RANKS), "--spatial_devices",
                                         str(ST_RANKS), *extra, *ST_FULL_ARGV])


def _st_stage2_bf16(tmp, mesh):
    """The bf16 stage-2 iteration at the README's flags (``ST_STAGE2``: 3 G
    steps, then the D step) on ``mesh`` (one process: the ranks time the
    CLI's own iterations): one iteration's launches and collectives, ms an
    iteration over ``ST_STAGE2_TIMED`` after one, this process's peak
    memory and the terms."""
    import torch

    from desr_tpu_torch.models.translation_model import TranslationModel
    from desr_tpu_torch.options import train_options

    opt = train_options.parse(_st_stage2_argv(tmp, "st2"), print_options=False)
    model = TranslationModel(opt, device=mesh.device, compute_dtype=torch.bfloat16,
                             is_train=True, generator=torch.Generator().manual_seed(10),
                             mesh=mesh)
    batch = _translation_batch(*ST_STAGE2, 65)
    sync = torch.cuda.synchronize if ST_DEVICE == "cuda" else (lambda: None)
    _st_peak(reset=True)
    model.set_input(batch)
    sync()
    _st_reset()
    model.optimize_parameters(ST_STAGE2[0])
    sync()
    out = {"counts": _st_counts(), "ms": _st_timed(model, batch, 2, ST_STAGE2_TIMED),
           "peak_gib": _st_peak(), "losses": {k: float(v) for k, v in model.metrics.items()}}
    del model
    if ST_DEVICE == "cuda":
        torch.cuda.empty_cache()
    return out


def _st_rank(mesh, tmp):
    """One of phase (s)'s ranks: the float32 checks (TF32 off, torch's
    deterministic mode), then the CLI's rank entry (``train._rank_main``,
    what ``train --num_devices 2 --spatial_devices 2`` runs in each rank)
    for 2 bf16 SR steps and 2 bf16 stage-2 iterations (each iteration timed,
    host clock with the card synchronised, and the run's peak memory), then
    the bf16 SR step timed without and with ``--remat_blocks``."""
    import torch

    from desr_tpu_torch import train
    from desr_tpu_torch.models.translation_model import TranslationModel

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    with _Deterministic():
        for kind in ST_CHECKS:
            out[kind] = _st_step(kind, tmp, mesh)
    torch.backends.cudnn.allow_tf32 = True  # the CLI's own setting
    sync = torch.cuda.synchronize if ST_DEVICE == "cuda" else (lambda: None)
    iteration = TranslationModel.optimize_parameters
    iter_ms = []

    def timed_iteration(model, *args, **kw):
        sync()
        t0 = time.perf_counter()
        iteration(model, *args, **kw)
        sync()
        iter_ms.append((time.perf_counter() - t0) * 1e3)

    for key, argv in (("cli", _st_full_argv(tmp)),
                      ("cli_stage2", _st_stage2_argv(tmp, "st2cli", ["--continue_train"]))):
        _st_reset()
        _st_peak(reset=True)
        t0 = time.perf_counter()
        with mock.patch.object(TranslationModel, "optimize_parameters", timed_iteration):
            out[f"{key}_losses"] = {k: float(v)
                                    for k, v in train._rank_main(mesh, argv).items()}
        sync()
        out[f"{key}_counts"] = _st_counts()
        out[f"{key}_s"] = time.perf_counter() - t0
        out[f"{key}_peak_gib"] = _st_peak()
    out["cli_stage2_iter_ms"] = iter_ms
    out["sr_bf16"] = _st_sr_bf16(tmp, mesh, remat=True)
    return out


def _st_check(kind, ranks, one, floors):
    """Phase (s)'s checks of one float32 step over the two ranks against one
    process's (``one``) and its floor, the larger gap of the jittered
    one-process steps ``floors`` (a single draw of the noise can leave a
    tensor almost where it was): the ranks split
    the frames' rows and agree bit for bit on what they reduced; every K1
    launch of a rank reads a halo row, and each rank launches K1 and K3 as
    often as one process; each term within max(1e-5, 3x its floor)
    relative, each weight gradient within max(1e-3, 3x its floor) relative
    L2 and each bias within 1e-3 of its net's largest gradient norm (each
    term's floor is printed beside any gap past phase (q)'s 1e-5); I2D's
    pool draws equal and its weights within 2 Adam steps' sign flips (2 x 2
    lr); the running statistics within phase (q)'s (2e-3, 5e-4). Returns
    the gaps."""
    import numpy as np

    r0, r1 = ranks
    check(r0["split"] and r0["h_split"] and r1["h_split"] and not one["split"],
          f"[s] {kind}: split {r0['split']}, h_split {r0['h_split']}, one {one['split']}")
    for key in ("metrics", "grads", "weights", "stats"):
        for k in r0[key]:
            check(np.array_equal(r0[key][k], r1[key][k]), f"[s] {kind}: the ranks differ on {k}")
    k4 = _k4(ST_K4[kind], device=ST_DEVICE)
    for r, res in enumerate(ranks):
        c, o = res["counts"], one["counts"]
        check(c["K1"] == o["K1"] == c["K1 halo"] and c["K3"] == o["K3"]
              and c["K3 backward"] == o["K3 backward"] and c["K2"] == 0
              and _holds(c, k4) and _holds(o, k4),
              f"[s] {kind}: rank {r} launches {c}, one process {o}; want K4 {ST_K4[kind]}")
    check(r0["counts"] == r1["counts"], f"[s] {kind}: the ranks issued other launches or "
          f"collectives: {r0['counts']} / {r1['counts']}")
    terms, term_floors, bad = {}, {}, []
    for k, v in one["metrics"].items():
        terms[k] = abs(r0["metrics"][k] - v) / max(abs(v), 1e-12)
        term_floors[k] = fl = max(abs(f["metrics"][k] - v) for f in floors) / max(abs(v), 1e-12)
        if abs(r0["metrics"][k] - v) > max(1e-5, 3 * fl) * abs(v) + 1e-7:
            bad.append(f"{k} ({terms[k]:.3g})")
    check(not bad, f"[s] {kind}: terms off " + ", ".join(bad))
    net_scale = {}
    for k, v in one["grads"].items():
        if not k.endswith("bias"):
            n = k.split(".")[0]
            net_scale[n] = max(net_scale.get(n, 0.0), float(np.linalg.norm(v)))
    gaps, bad = {}, []
    for k, v in one["grads"].items():
        if k.endswith("bias"):
            gaps[k] = _dp_rel(r0["grads"][k], v, net_scale[k.split(".")[0]])
            bound = 1e-3
        else:
            gaps[k] = _dp_rel(r0["grads"][k], v)
            bound = max(1e-3, 3 * max(_dp_rel(f["grads"][k], v) for f in floors))
        if gaps[k] > bound:
            bad.append(f"{k} ({gaps[k]:.3g} > {bound:.3g})")
    check(not bad, f"[s] {kind}: gradients off " + ", ".join(bad[:5]))
    if kind == "i2d":
        check(r0["pool_rng"] == r1["pool_rng"] == one["pool_rng"],
              "[s] i2d: the ranks' replay pools drew otherwise than one process")
        pool_gap = float(np.abs(r0["pool"] - one["pool"]).max())
        check(pool_gap <= 1e-4, f"[s] i2d: the pool's images off by {pool_gap:.3g}")
        bad = [k for k, v in one["weights"].items()
               if not np.allclose(r0["weights"][k], v, rtol=0, atol=2 * 2 * 2e-4 + 1e-7)]
        check(not bad, f"[s] i2d: weights after the steps off in {bad[:5]}")
    bad = [k for k, v in one["stats"].items()
           if not np.allclose(r0["stats"][k], v, rtol=2e-3, atol=5e-4)]
    check(not bad, f"[s] {kind}: running statistics off in {bad[:5]}")
    weights = sorted(v for k, v in gaps.items() if not k.endswith("bias"))
    return {"terms_max_rel": max(terms.values()),
            "terms_floor_max_rel": max(term_floors.values()),
            # each term past phase (q)'s 1e-5: [its gap, its floor], both relative
            "terms_over_1e-5": {k: [g, term_floors[k]] for k, g in terms.items() if g > 1e-5},
            "grad_median_rel": weights[len(weights) // 2],
            "grad_worst_rel": weights[-1],
            "floor_grad_worst_rel": max(_dp_rel(f["grads"][k], one["grads"][k])
                                        for k in gaps if not k.endswith("bias") for f in floors),
            "stats_max_abs": max([float(np.abs(r0["stats"][k] - v).max())
                                  for k, v in one["stats"].items()] or [0.0])}


def phase_spatial_training(tmp):
    """(s): ``train --num_devices 2 --spatial_devices 2`` over two gloo ranks
    on the one card (NCCL takes one rank a card), each frame's rows split
    between them. Float32 at width 8 (TF32 off, torch's deterministic
    mode): the main step on 384x512 crops (batch 2), the same under --norm
    batch, the SR step at batch 1 (HR 512x640), two I2D --use_D steps
    (batch 2) and a stage-2 iteration at 128x128 (batch 2, one G step, the
    translators' own widths), each against the one-process step on the
    same global batch (``_st_check`` states the bounds). Then bf16 at the
    full widths through the CLI's rank entry: 2 SR steps in bench.py's
    configuration and 2 stage-2 iterations at the README's flags (finite
    losses, frozen nets unchanged, trained nets moved, every K1 launch
    with halo rows); the SR step at HR 1024x1280 timed with its peak memory
    a rank, against one process (two processes sharing one card: not a
    scaling figure), and under --remat_blocks on the ranks against it
    (``_st_remat_report``); the stage-2 iteration timed the same way
    (``_st_stage2_report``)."""
    import numpy as np
    import torch

    from desr_tpu_torch import checkpoints as ckpt
    from desr_tpu_torch import parallel
    from desr_tpu_torch.models.main_sr_model import MainSRModel
    from desr_tpu_torch.models.translation_model import TranslationModel
    from desr_tpu_torch.options import train_options

    t0 = time.perf_counter()
    _write_train_domain(tmp, "A", seed=70, n=2)
    _write_train_domain(tmp, "B", seed=71, n=2)
    written, n = ST_STAGE2_FRAMES
    for dom, seed in (("A", 72), ("B", 73)):  # stage 2's dataroot: <tmp>/train{A,B}
        folder = os.path.join(tmp, f"train{dom}")
        _write_frames(folder, written, seed=seed)
        for sub in ("depth", "img"):
            for i in range(written, n):
                os.link(os.path.join(folder, sub, f"f{i % written:02d}.png"),
                        os.path.join(folder, sub, f"f{i:02d}.png"))
    before, trained = {}, {}
    for key, name, argv, cls in (
            ("sr", "stcli", _st_full_argv(tmp), MainSRModel),
            ("stage2", "st2cli", _st_stage2_argv(tmp, "st2cli"), TranslationModel)):
        opt = train_options.parse(argv, print_options=False)
        model = cls(opt, device=ST_DEVICE, compute_dtype=torch.bfloat16, is_train=True,
                    generator=torch.Generator().manual_seed(9))
        for net in model.model_names:
            ckpt.save_net(model.nets[net], ckpt.net_ckpt_path(tmp, name, "latest", net))
        before[key] = (name, _state(model, model.model_names))
        trained[key] = model.optimized_nets if key == "stage2" else model.trainable_nets
        del model
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = parallel.launch(_st_rank, [f"{ST_DEVICE}:0"] * ST_RANKS, backend="gloo",
                            args=(tmp,), workdir=tmp, spatial=ST_RANKS)
    ranks_s = time.perf_counter() - t0
    one_mesh = parallel.make_mesh([ST_DEVICE])
    report, paths = {"setup_s": setup_s, "ranks_s": ranks_s}, {}
    with _Deterministic():
        for kind in ST_CHECKS:
            one = _st_step(kind, tmp, one_mesh)
            floors = [_st_step(kind, tmp, one_mesh, jitter=seed)
                      for seed in ST_JITTER_SEEDS + ST_GROUP_SEEDS.get(kind, ())]
            report[kind] = g = _st_check(kind, [r[kind] for r in ranks], one, floors)
            c = ranks[0][kind]["counts"]
            report[kind]["counts_rank"] = c
            over = ", ".join(f"{k} {gap:.3g} (floor {fl:.3g})"
                             for k, (gap, fl) in g["terms_over_1e-5"].items())
            print(f"[s] {kind} float32 {ST_CHECKS[kind]}: 2 ranks vs one process: terms max "
                  f"rel {g['terms_max_rel']:.3g} (the one-process floor's max "
                  f"{g['terms_floor_max_rel']:.3g}; past 1e-5: {over or 'none'}), "
                  f"weight grads rel L2 median "
                  f"{g['grad_median_rel']:.3g} worst {g['grad_worst_rel']:.3g} (the one-process "
                  f"floor's worst {g['floor_grad_worst_rel']:.3g}), running stats max |d| "
                  f"{g['stats_max_abs']:.3g}; a rank: K1 {c['K1']} ({c['K1 halo']} with halo "
                  f"rows, {c['K1 backward halo']} backwards with halo rows), K3 {c['K3']}")
            for r, rank in enumerate(ranks):
                paths[f"train_spatial_{kind}_rank{r}"] = {
                    k: rank[kind]["counts"][k]
                    for k in ("K1", "K1 halo", "K1 backward halo", "K3", "K3 backward")}
            if kind == "main_device_aug":
                report[kind]["batch_keys_bit_equal"] = _st_device_aug_bands(
                    [r[kind]["batch"] for r in ranks], one["batch"])
            if kind == "main_group":
                report[kind]["group_vs_single"] = _st_group_report(ranks)
    # the CLI's 2 bf16 SR steps: launches, losses, the nets it saved
    want = {"K1": 2 * SR_K1_PER_STEP, "K1 halo": 2 * SR_K1_PER_STEP, "K2": 0,
            "K3": 2 * K3_PER_STEP, "K3 backward": 2 * K3_BWD_PER_STEP,
            "K1 backward halo": 2 * SR_K1_BWD_PER_STEP, **_k4(K4_PER_STEP, 2, ST_DEVICE)}
    for r, rank in enumerate(ranks):
        c = rank["cli_counts"]
        got = {k: c[k] for k in want}
        check(got == want, f"[s] train --spatial_devices 2 --SR rank {r}: launches {got}; "
              f"want {want}")
        check(all(np.isfinite(list(rank["cli_losses"].values()))) and rank["cli_losses"],
              f"[s] CLI rank {r}: losses {rank['cli_losses']}")
        paths[f"train_spatial_cli_rank{r}"] = got
    check(ranks[0]["cli_counts"] == ranks[1]["cli_counts"],
          f"[s] CLI: the ranks issued other launches or collectives: "
          f"{ranks[0]['cli_counts']} / {ranks[1]['cli_counts']}")
    # the CLI's 2 bf16 stage-2 iterations: every K1 launch with halo rows,
    # each with a backward (the G steps'), finite losses
    per_iter = STAGE2_K1_PER_ITER
    want = {"K1": 2 * per_iter, "K1 halo": 2 * per_iter, "K1 backward halo": 2 * per_iter,
            "K2": 0, "K3": 0, "K3 backward": 0, **_k4((0, 0), device=ST_DEVICE)}
    for r, rank in enumerate(ranks):
        c = rank["cli_stage2_counts"]
        got = {k: c[k] for k in want}
        check(got == want, f"[s] train --spatial_devices 2 --model_type translation rank {r}: "
              f"launches {got}; want {want}")
        check(all(np.isfinite(list(rank["cli_stage2_losses"].values())))
              and rank["cli_stage2_losses"],
              f"[s] stage-2 CLI rank {r}: losses {rank['cli_stage2_losses']}")
        paths[f"train_spatial_stage2_cli_rank{r}"] = got
    check(ranks[0]["cli_stage2_counts"] == ranks[1]["cli_stage2_counts"],
          f"[s] stage-2 CLI: the ranks issued other launches or collectives: "
          f"{ranks[0]['cli_stage2_counts']} / {ranks[1]['cli_stage2_counts']}")
    # the nets rank 0 saved at the epochs' ends (save_net: a state_dict file)
    for key, (name, states) in before.items():
        for n, state in states.items():
            after = torch.load(ckpt.net_ckpt_path(tmp, name, "latest", n), map_location="cpu")
            same = all(torch.equal(v.cpu(), after[k].cpu()) for k, v in state.items())
            check(same == (n not in trained[key]),
                  f"[s] {key} CLI: {n} " + ("moved" if same else "unchanged")
                  + (" (trained)" if n in trained[key] else " (frozen)"))
    # the bf16 SR step at full width: ms, peak memory a rank, collectives
    one = _st_sr_bf16(tmp, one_mesh)
    sr = [rank["sr_bf16"] for rank in ranks]
    for r, s in enumerate(sr):
        check(all(np.isfinite(list(s["losses"].values()))), f"[s] bf16 SR rank {r}: {s['losses']}")
    c = sr[0]["counts"]
    report["sr_bf16"] = {"ms_ranks": [s["ms"] for s in sr], "ms_one_process": one["ms"],
                         "peak_gib_ranks": [s["peak_gib"] for s in sr],
                         "peak_gib_one_process": one["peak_gib"], "counts_rank": c,
                         "counts_one_process": one["counts"],
                         "cli_s_ranks": [rank["cli_s"] for rank in ranks]}
    check(c["K1"] == c["K1 halo"] == one["counts"]["K1"] == SR_K1_PER_STEP
          and c["K1 backward halo"] == SR_K1_BWD_PER_STEP
          and _holds(c, _k4(K4_PER_STEP, device=ST_DEVICE))
          and _holds(one["counts"], _k4(K4_PER_STEP, device=ST_DEVICE)),
          f"[s] bf16 SR step: a rank's launches {c}, one process {one['counts']}")
    print(f"[s] bf16 SR step, batch 1, HR {ST_SR_HR[0]}x{ST_SR_HR[1]}, default widths: per "
          f"rank K1 {c['K1']} ({c['K1 halo']} with halo rows, {c['K1 backward halo']} "
          f"backwards with halo rows), K3 {c['K3']}, K3 backward {c['K3 backward']}; a step's "
          f"collectives: forward {c['exchange']} halo exchanges, {c['gather']} gathers along "
          f"H, {c['all_reduce']} moment all-reduces; backward {c['exchange_bwd']} exchange "
          f"adjoints, {c['gather_bwd']} gather adjoints, {c['all_reduce_sum_bwd']} all-reduce "
          f"adjoints ({c['all_reduce_sum']} all_reduce_sum in all, forward); "
          f"{max(s['ms'] for s in sr):.1f} ms a step over 2 gloo ranks sharing one card (not a "
          f"scaling figure) vs one process {one['ms']:.1f} ms; peak memory a rank "
          + (f"{max(s['peak_gib'] for s in sr):.3f} GiB vs one process {one['peak_gib']:.3f} GiB"
             if one["peak_gib"] is not None else "not measured (CPU)"))
    print(f"[s] CLI train --num_devices 2 --spatial_devices 2 --SR: 2 steps, a rank K1 "
          f"{ranks[0]['cli_counts']['K1']} (all with halo rows), K3 "
          f"{ranks[0]['cli_counts']['K3']}, finite losses, frozen nets unchanged, "
          f"{', '.join(trained['sr'])} moved; {max(r['cli_s'] for r in ranks):.1f} s")
    c = ranks[0]["cli_stage2_counts"]
    print(f"[s] CLI train --num_devices 2 --spatial_devices 2 --model_type translation (README "
          f"flags: batch 6, 256x256 crops, bf16): 2 iterations, a rank K1 {c['K1']} (all with "
          f"halo rows, {c['K1 backward halo']} backwards with halo rows), finite losses, "
          f"{', '.join(trained['stage2'])} moved; "
          f"{max(r['cli_stage2_s'] for r in ranks):.1f} s")
    report.update(_st_remat_report(ranks))
    report.update(_st_stage2_report(ranks, _st_stage2_bf16(tmp, one_mesh)))
    print("[s] " + json.dumps(report))
    return paths


def _st_group_report(ranks):
    """The ranks' ``--steps_per_call 2`` group at the default lr equals the
    same two steps taken one at a time on them, bit for bit."""
    for r, rank in enumerate(ranks):
        g = rank["main_group"]["group_vs_single"]
        check(all(g.values()), f"[s] --steps_per_call 2 rank {r}: the group against two single "
              f"steps, bit-equal: {g}")
    print("[s] --steps_per_call 2 main on the ranks, default lr: the group's metrics, "
          "gradients, weights and collectives equal two single steps' bit for bit")
    return ranks[0]["main_group"]["group_vs_single"]


def _st_device_aug_bands(ranks, one):
    """Each rank's first ``--device_aug`` batch is its band of one
    process's, bit for bit: every image value's rows split in two by its
    own height, K and the crop boxes whole. Returns the keys compared."""
    import numpy as np

    for r, got in enumerate(ranks):
        check(set(got) == set(one), f"[s] --device_aug rank {r}: keys {sorted(got)}")
        for k, v in one.items():
            if v.ndim == 4:
                h = v.shape[1] // len(ranks)
                v = v[:, r * h:(r + 1) * h]
            check(got[k].shape == v.shape and np.array_equal(got[k], v),
                  f"[s] --device_aug rank {r}: {k} is not its band of one process's batch "
                  f"(max |d| {float(np.abs(got[k] - v).max()) if got[k].shape == v.shape else 'shape'})")
    print(f"[s] --device_aug main, batch {ST_CHECKS['main_device_aug'][0]}: each rank's "
          f"finished batch is its band of one process's, bit for bit ({', '.join(sorted(one))})")
    return sorted(one)


def _st_remat_report(ranks):
    """Phase (s)'s checks of the bf16 SR step under ``--remat_blocks`` on the
    two ranks (``_st_remat_sr``): the ranks alike; loss terms within
    max(1e-5, 3x their floor) relative and weight gradients within
    max(1e-3, 3x their floor) relative L2 of the step without remat
    (``_st_check``'s bounds; the floor: that step against itself under
    deterministic cuDNN, which the SR step's bicubic backward does not
    make bit-exact); every K1 launch with halo rows, the recompute's
    exchanges alike on both ranks. Returns the report's entries."""
    import numpy as np

    rm = [rank["sr_bf16"]["remat"] for rank in ranks]
    check(rm[0]["counts"] == rm[1]["counts"] and rm[0]["grads_norm"] == rm[1]["grads_norm"],
          f"[s] --remat_blocks SR: the ranks differ: {rm[0]['counts']} / {rm[1]['counts']}, "
          f"grads norm {rm[0]['grads_norm']} / {rm[1]['grads_norm']}")
    r, c = rm[0], rm[0]["counts"]
    bad = [k for k, v in r["terms_rel"].items() if v > max(1e-5, 3 * r["terms_floor_rel"][k])]
    bad += [k for k, v in r["grads_rel"].items() if v > max(1e-3, 3 * r["grads_floor_rel"][k])]
    check(not bad, f"[s] --remat_blocks SR step vs no remat, off in {bad[:5]}")
    check(c["K1"] == c["K1 halo"] > SR_K1_PER_STEP and c["exchange_remat"] > 0
          and _holds(c, _k4(K4_PER_STEP, device=ST_DEVICE)),
          f"[s] --remat_blocks SR step: a rank's launches and collectives {c}")
    for i, rank in enumerate(rm):
        check(all(np.isfinite(list(rank["losses"].values()))),
              f"[s] --remat_blocks SR rank {i}: {rank['losses']}")
    plain = [rank["sr_bf16"] for rank in ranks]
    worst = max(r["grads_rel"].values())
    print(f"[s] bf16 SR step under --remat_blocks over 2 ranks, HR {ST_SR_HR[0]}x{ST_SR_HR[1]}: "
          f"against no remat (deterministic cuDNN) terms max rel {max(r['terms_rel'].values()):.3g}"
          f", weight grads worst rel L2 {worst:.3g} (the step against itself "
          f"{max(r['grads_floor_rel'].values()):.3g}; {r['grads_bit_equal']}/{r['grads_n']} "
          f"bit-equal); a rank K1 {c['K1']} (all with halo rows; {c['K1'] - SR_K1_PER_STEP} in "
          f"the recompute), recompute collectives {c['exchange_remat']} exchanges, "
          f"{c['gather_remat']} gathers, {c['all_reduce_remat']} moment all-reduces; "
          f"{max(x['ms'] for x in rm):.1f} ms a step (no remat "
          f"{max(x['ms'] for x in plain):.1f}); peak memory a rank "
          + (f"{max(x['peak_gib'] for x in rm):.3f} GiB (no remat "
             f"{max(x['peak_gib'] for x in plain):.3f})"
             if r["peak_gib"] is not None else "not measured (CPU)"))
    return {"sr_bf16_remat_blocks": {
        "ms_ranks": [x["ms"] for x in rm], "peak_gib_ranks": [x["peak_gib"] for x in rm],
        "terms_max_rel": max(r["terms_rel"].values()), "grad_worst_rel": worst,
        "grad_floor_worst_rel": max(r["grads_floor_rel"].values()),
        "grads_bit_equal": r["grads_bit_equal"], "grads_n": r["grads_n"], "counts_rank": c}}


def _st_stage2_report(ranks, one):
    """The bf16 stage-2 iteration at the README's flags on the two ranks
    (the CLI's second iteration, and the CLI run's peak memory) against
    one process (``_st_stage2_bf16``): a rank's collectives an iteration
    (half the CLI's two), K1 as often as one process; ms an iteration and
    peak memory a rank. Returns the report's entries."""
    c = {k: v // 2 for k, v in ranks[0]["cli_stage2_counts"].items()}
    o = one["counts"]
    check(c["K1"] == o["K1"] == STAGE2_K1_PER_ITER and len(ranks[0]["cli_stage2_iter_ms"]) == 2
          and _holds(c, _k4((0, 0), device=ST_DEVICE)) and _holds(o, _k4((0, 0), device=ST_DEVICE)),
          f"[s] bf16 stage-2 iteration: a rank's launches {c}, one process {o}, iterations "
          f"timed {ranks[0]['cli_stage2_iter_ms']}")
    ms = [rank["cli_stage2_iter_ms"][-1] for rank in ranks]
    peak = [rank["cli_stage2_peak_gib"] for rank in ranks]
    print(f"[s] bf16 stage-2 iteration (3 G steps, 1 D step), batch {ST_STAGE2[0]} at "
          f"{ST_STAGE2[1]}x{ST_STAGE2[2]}, README flags: per rank K1 {c['K1']} (all with halo "
          f"rows, {c['K1 backward halo']} backwards with halo rows); collectives an iteration: "
          f"forward {c['exchange']} halo exchanges, {c['gather']} gathers along H, "
          f"{c['all_reduce']} moment all-reduces; backward {c['exchange_bwd']} exchange "
          f"adjoints, {c['gather_bwd']} gather adjoints, {c['all_reduce_sum_bwd']} all-reduce "
          f"adjoints; {max(ms):.1f} ms the CLI's second iteration over 2 gloo ranks sharing one "
          f"card (not a scaling figure) vs one process {one['ms']:.1f} ms; peak memory a rank "
          + (f"{max(peak):.3f} GiB (the CLI run) vs one process {one['peak_gib']:.3f} GiB"
             if one["peak_gib"] is not None else "not measured (CPU)"))
    return {"stage2_bf16": {"ms_ranks": ms, "ms_one_process": one["ms"],
                            "peak_gib_ranks": peak, "peak_gib_one_process": one["peak_gib"],
                            "counts_rank": c, "counts_one_process": o}}


# ------------------------------------------------------------------ (t)

LAST_DEVICE = "cuda"             # phase (t)'s device (a CPU rehearsal sets "cpu")
LAST_BLOCK = (12, 128, 96, 128)  # the main step's ResnetBlock input on 384x512 crops (NCHW)
LAST_STAGE2 = (6, 256, 256)      # stage 2's batch and crops: G_A, and the split generators
LAST_OLD = {"resnet_6blocks": ((12, 2, 384, 512), 128, 32),  # Depth_f's geometry
            "unet_128": ((6, 3, 384, 512), 1, 64)}          # Task's: input, output_nc, ngf
LAST_HELPER_REL = 1e-5  # the helpers' reductions on the card against the CPU's, float32


def _last_grads_close(tag, got, want, floor):
    """A forward and backward through K1 (``got``) against the same through
    its plain version (``want``), float32: the output within (b)'s bound,
    1e-3 + 1e-4 |p| (``_compare``'s); the gradients within phase (e)'s
    bound (``_train_parity``), each input's and each weight's within
    max(1e-3, 3x ``floor``'s gap) relative L2, ``floor`` being the plain
    route with K1's outputs and moments perturbed by 1e-6 relative, and a
    bias's within 1e-3 of the net's largest weight-gradient norm (a conv
    bias before a norm has an exact gradient of 0). Not an entry's worst
    gap: a ReLU whose pre-activation is within rounding of 0 opens on one
    route and not the other and moves that element's whole cotangent, so a
    bound on single entries fails where the relative L2 gap stays small.
    Returns the worst gaps and their floors."""
    import torch

    (out, dxs, grads), (p_out, p_dxs, p_grads), (_, f_dxs, f_grads) = got, want, floor
    err = (out - p_out).abs()
    check(bool(torch.isfinite(out).all()) and bool((err <= 1e-3 + 1e-4 * p_out.abs()).all()),
          f"[t] {tag}: output off by {float(err.max()):.3g}")

    def rel(a, b, scale=None):
        return float((a - b).norm() / (b.norm() if scale is None else scale).clamp(min=1e-30))

    check(set(grads) == set(p_grads), f"[t] {tag}: gradients of {sorted(grads)}")
    scale = max(g.norm() for k, g in p_grads.items() if not k.endswith("bias"))
    pairs = [(f"input {i}", d, p, f, None) for i, (d, p, f) in enumerate(zip(dxs, p_dxs, f_dxs))]
    pairs += [(k, grads[k], g, f_grads[k], scale if k.endswith("bias") else None)
              for k, g in p_grads.items()]
    gap, bad = {"out": float(err.max()), "grads": 0.0, "floor": 0.0}, []
    for k, d, p, f, sc in pairs:
        g, fl = rel(d, p, sc), rel(f, p, sc)
        bound = 1e-3 if sc is not None else max(1e-3, 3 * fl)
        if g > gap["grads"]:
            gap["grads"], gap["floor"] = g, fl
        if g > bound:
            bad.append(f"{k} ({g:.3g} > {bound:.3g})")
    check(not bad, f"[t] {tag}: gradients off (relative L2): " + ", ".join(bad[:5]))
    return gap


def _last_sync():
    import torch

    if LAST_DEVICE == "cuda":
        torch.cuda.synchronize()


def _last_step(net, inputs, route=None):
    """A forward and backward of a seeded scalar through ``net`` on the
    ``inputs``, through K1, or with ``route`` "plain" its plain version, or
    "noisy" the plain version with its outputs and moments perturbed by
    1e-6 relative (seeded): (output, input gradients, parameter gradients),
    and K1's launches."""
    import contextlib

    import torch

    from desr_tpu_torch.ops import conv3x3 as K

    noise = torch.Generator().manual_seed(12)

    def jitter(t):
        return 1e-6 * torch.randn(t.shape, generator=noise).to(t.device)

    def noisy(*args):
        out, s, s2 = K.conv3x3_fused_plain(*args[:6], True, *args[7:])
        mag = out.float().abs().sum(dim=(1, 2))
        out = out * (1 + jitter(out))
        return (out, s + mag * jitter(s), s2 * (1 + jitter(s2))) if args[6] else out

    net.zero_grad(set_to_none=True)
    xs = [x.detach().clone().requires_grad_(True) for x in inputs]
    fwd = {"plain": K.conv3x3_fused_plain, "noisy": noisy}.get(route)
    patch = (mock.patch.object(K, "_fused_forward", fwd) if fwd is not None
             else contextlib.nullcontext())
    _last_sync()
    _reset_counts()
    with patch:
        out = net(*xs)
        cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(5)).to(out.device)
        (out * cot).sum().backward()
    _last_sync()
    k1 = _counts()["K1"]
    return (out.detach(), [x.grad for x in xs],
            {k: p.grad.clone() for k, p in net.named_parameters() if p.grad is not None}), k1


def _last_helpers():
    """The JAX package's helpers that no model calls, on card tensors at
    stage 2's shapes against the same calls on the CPU: ``masked_mean_dif``
    and ``masked_signed_mean`` on (6, 1, 256, 256) depth maps and the masked
    cosine loss under both ``compat_bug`` denominators on (6, 3, 256, 256)
    normals, each within ``LAST_HELPER_REL`` relative; MeanMatching in both
    directions, its shift drawn on the card by a CUDA generator and in
    [0, mu), its output equal bit for bit to the CPU's post-draw part on
    that shift. Returns the gaps."""
    import torch

    from desr_tpu_torch.ops import losses as L

    dev = LAST_DEVICE
    b, h, w = LAST_STAGE2
    gen = torch.Generator().manual_seed(31)
    # [-1, 1] depth maps with holes at exactly -1 (9% and 5%), fake ~0.1 deeper
    real, fake = (torch.clamp(torch.rand((b, 1, h, w), generator=gen) * 2.2 - lo, -1.0, 1.0)
                  for lo in (1.2, 1.1))
    mask = (torch.rand((b, 1, h, w), generator=gen) > 0.3).float()
    normals = [torch.randn((b, 3, h, w), generator=gen) for _ in range(2)]
    mask3 = mask.expand(-1, 3, -1, -1)
    calls = {
        "masked_mean_dif": (L.masked_mean_dif, (real, fake, mask), {}),
        "masked_signed_mean": (L.masked_signed_mean, (real, fake, mask), {}),
        "masked_cos_sim_loss_planar": (L.masked_cos_sim_loss_planar, (*normals, mask3), {}),
        "masked_cos_sim_loss_planar_compat_bug_false": (
            L.masked_cos_sim_loss_planar, (*normals, mask3), {"compat_bug": False}),
    }
    gaps = {}
    for name, (fn, args, kw) in calls.items():
        want = float(fn(*args, **kw))
        got = fn(*(a.to(dev) for a in args), **kw)
        check(got.device.type == dev, f"[t] {name} ran on {got.device}")
        gaps[name] = abs(float(got) - want) / abs(want)
        check(math.isfinite(float(got)) and gaps[name] <= LAST_HELPER_REL,
              f"[t] {name} on the card {float(got)!r}, on the CPU {want!r}")
    mu = 0.3
    for direction in ("A2B", "B2A"):
        out = L.mean_matching_shift(torch.Generator(device=dev).manual_seed(41), real.to(dev),
                                    fake.to(dev), direction, mu)
        shift = torch.rand((), generator=torch.Generator(device=dev).manual_seed(41),
                           device=dev) * mu
        want = L.mean_matching_apply(real, fake, direction, shift.cpu())
        gap = max(float((o.cpu() - wt).abs().max()) for o, wt in zip(out, want))
        check(all(o.device.type == dev for o in out) and 0.0 <= float(shift) < mu
              and all(torch.equal(o.cpu(), wt) for o, wt in zip(out, want)),
              f"[t] MeanMatching {direction}: shift {float(shift)!r} on {shift.device}, "
              f"max |d| vs the CPU {gap:.3g}")
        gaps[f"mean_matching_{direction}"] = gap
        gaps[f"mean_matching_{direction}_shift"] = float(shift)
    return gaps


def _last_routes(net, inputs):
    """``_last_step`` through K1, its plain version and the perturbed plain
    version: (the three results, K1's launches on the kernel route)."""
    got, k1 = _last_step(net, inputs)
    want, _ = _last_step(net, inputs, "plain")
    floor, _ = _last_step(net, inputs, "noisy")
    return got, want, floor, k1


def phase_last_capabilities(tmp):
    """(t): the capabilities no shipped configuration reaches, at full width
    on the card, float32 (TF32 off), each through K1 against the same
    through its plain version (``_last_grads_close``: (b)'s bound on the
    output, (e)'s on the gradients, against the plain route's own
    sensitivity):

    - a zoo-A ResnetBlock with dropout in training at the main step's block
      shape (B=12, 96x128, 128 channels, reflect), forward and backward: K1
      2 launches a forward, the second without a prologue; its Dropout's
      mask drawn on the card (keep rate within 0.5 +- 1e-3 over its 18.9M
      values), equal bit for bit to the CPU's draw at a small shape, and the
      same mask in ``--remat_blocks``'s recompute as in the forward, whose
      step then equals the step without remat within those bounds;
    - G_A (the translator) with dropout at stage 2's shape (B=6 256x256),
      forward and backward: K1 18 a forward;
    - GeneratorI_F -> GeneratorF_D at ngf_img_feature 32 on B=6 256x256
      frames, forward and backward: K1 ``SPLIT_K1`` a forward (the dilated
      blocks on cuDNN);
    - ``define_G(use_old=True)`` under group norm, GroupNorm(1): a
      resnet_6blocks at Depth_f's geometry (K1 12 a forward) against its
      plain version, and a unet_128 at Task's, finite, forward only;
    - the JAX package's helpers that no model calls (``_last_helpers``):
      the masked means, the masked cosine loss under both ``compat_bug``
      denominators, MeanMatching with its shift drawn on the card, against
      the same calls on the CPU."""
    import torch

    from desr_tpu_torch.models import layers as TL
    from desr_tpu_torch.models import networks as TN
    from desr_tpu_torch.models import translation_networks as TT
    from desr_tpu_torch.ops import conv3x3 as K
    from desr_tpu_torch.ops import instance_norm as IN

    paths, report = {}, {}
    gen = torch.Generator().manual_seed(21)
    dev = LAST_DEVICE

    def randn(*shape, seed):
        return torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(dev)

    # the dropout ResnetBlock; its masks recorded
    t0 = time.perf_counter()
    block = TN.ResnetBlock(LAST_BLOCK[1], "reflect", TL.InstanceNorm2d, True, True)
    block = TL.name_dropouts(TN.init_weights(block, generator=gen)).to(dev).train()
    TL.set_dropout_key(block, 3, 7)
    x = randn(*LAST_BLOCK, seed=22)
    masks = []
    keep = TL.dropout_keep

    def recording(*args, **kw):
        masks.append(keep(*args, **kw))
        return masks[-1]

    with mock.patch.object(TL, "dropout_keep", recording):
        got, want, floor, k1 = _last_routes(block, [x])
        check(k1 == 2, f"[t] dropout block: K1 {k1}; want 2, the second without a prologue")
        report["dropout_block"] = _last_grads_close("dropout ResnetBlock", got, want, floor)
        rate = float(masks[0].double().mean())
        check(abs(rate - 0.5) <= 1e-3 and all(torch.equal(m, masks[0]) for m in masks[1:]),
              f"[t] dropout mask on the card: keep rate {rate:.6f}, or another mask in a step")
        masks.clear()
        TL.set_remat(block, "blocks")
        remat, k1_remat = _last_step(block, [x])
        TL.set_remat(block, None)
    check(len(masks) == 2 and torch.equal(masks[0], masks[1]) and k1_remat == 4,
          f"[t] --remat_blocks: {len(masks)} masks drawn, K1 {k1_remat} (want the forward's "
          "mask again in the recompute, K1 4)")
    report["dropout_block_remat_vs_none"] = _last_grads_close(
        "dropout ResnetBlock under --remat_blocks", remat, got, floor)
    small = (2, 8, 64, 64)
    key = TL.dropout_key(3, 7, "conv_block.4.")
    on_card = TL.dropout_keep(key, small, (0, 2, 2), (0, 64), dev).cpu()
    check(torch.equal(on_card, TL.dropout_keep(key, small, (0, 2, 2), (0, 64), "cpu")),
          "[t] the dropout mask drawn on the card differs from the CPU's")
    report["dropout_keep_rate_on_card"] = rate
    paths["train_last_dropout_block"] = {"K1": k1 + k1_remat}
    print(f"[t] dropout ResnetBlock {LAST_BLOCK} float32: K1 2 a forward (the second stats "
          f"only), vs plain {report['dropout_block']}; the mask's keep rate on the card "
          f"{rate:.6f} over {masks[0].numel()} values, equal to the CPU's draw, the same in "
          f"--remat_blocks' recompute (K1 4), that step vs none "
          f"{report['dropout_block_remat_vs_none']}; {time.perf_counter() - t0:.1f} s")
    del block, x, got, want, floor, remat, masks

    # G_A with dropout at stage 2's shape
    t0 = time.perf_counter()
    b, h, w = LAST_STAGE2
    g_a = TT.define_Gen(TT.default_translator_opt(dropout=True), "img_depth", generator=gen)
    g_a = g_a.to(dev).train()
    TL.set_dropout_key(g_a, 3, 8)
    inputs = [randn(b, 1, h, w, seed=23).clamp(-1, 1), randn(b, 3, h, w, seed=24).clamp(-1, 1)]
    got, want, floor, k1 = _last_routes(g_a, inputs)
    check(k1 == TRANSLATE_K1_PER_BATCH, f"[t] G_A dropout: K1 {k1}; want "
          f"{TRANSLATE_K1_PER_BATCH}")
    report["g_a_dropout"] = _last_grads_close("G_A with dropout", got, want, floor)
    paths["train_last_g_a_dropout"] = {"K1": k1}
    print(f"[t] G_A with dropout, B={b} {h}x{w} float32: K1 {k1} a forward (9 blocks, each "
          f"split at its Dropout), vs plain {report['g_a_dropout']}; "
          f"{time.perf_counter() - t0:.1f} s")
    del g_a, got, want, floor

    # the split generators, chained
    t0 = time.perf_counter()
    opt = TT.default_translator_opt()
    opt.ngf_img_feature = 32
    i_f = TT.define_Gen(opt, "img", "feature", generator=gen)
    f_d = TT.define_Gen(opt, "feature", "depth", generator=gen)
    chain = torch.nn.Sequential(i_f, f_d).to(dev).train()
    img = randn(b, 3, h, w, seed=25).clamp(-1, 1)
    got, want, floor, k1 = _last_routes(chain, [img])
    check(k1 == SPLIT_K1, f"[t] GeneratorI_F -> GeneratorF_D: K1 {k1}; want {SPLIT_K1}")
    report["split_generators"] = _last_grads_close("split generators", got, want, floor)
    paths["train_last_split_generators"] = {"K1": k1}
    print(f"[t] GeneratorI_F -> GeneratorF_D, ngf_img_feature 32, B={b} {h}x{w} float32: K1 "
          f"{k1} a forward (I_F's first block 2, F_D's nine 18; I_F's dilated blocks on "
          f"cuDNN), vs plain {report['split_generators']}; {time.perf_counter() - t0:.1f} s")
    del chain, i_f, f_d, got, want, floor

    # use_old GroupNorm(1)
    t0 = time.perf_counter()
    for netG, (shape, out_nc, ngf) in LAST_OLD.items():
        net = TN.define_G(shape[1], out_nc, ngf, netG, norm="group", use_old=True,
                          generator=gen).to(dev).eval()
        x = randn(*shape, seed=26).clamp(-1, 1)
        with torch.no_grad():
            _last_sync()
            _reset_counts()
            out = net(x)
            _last_sync()
            c = _counts()
            k1 = c["K1"]
            with mock.patch.object(K, "_fused_forward", K.conv3x3_fused_plain), \
                    mock.patch.object(IN, "norm_apply", IN.norm_apply_plain):
                plain = net(x)
        err = (out - plain).abs()
        # the ResnetBlocks' GroupNorm(1) folds into the chain: K4 applies their tails alone
        want_k1, want_k4 = (12, (0, 6)) if netG == "resnet_6blocks" else (0, (0, 0))
        check(bool(torch.isfinite(out).all()) and k1 == want_k1 and _holds(c, _k4(want_k4))
              and bool((err <= 1e-3 + 1e-4 * plain.abs()).all()),
              f"[t] use_old {netG}: launches {c} (want K1 {want_k1}, K4 {want_k4}), max |d| vs "
              f"plain {float(err.max()):.3g}")
        report[f"use_old_{netG}"] = {"out": float(err.max()), "K1": k1}
        if k1:
            paths[f"serve_last_use_old_{netG}"] = {"K1": k1}
        del net, x, out, plain
    print(f"[t] define_G(use_old=True), GroupNorm(1): resnet_6blocks "
          f"{LAST_OLD['resnet_6blocks'][0]} K1 12 a forward, vs plain "
          f"{report['use_old_resnet_6blocks']['out']:.3g}; unet_128 "
          f"{LAST_OLD['unet_128'][0]} finite; {time.perf_counter() - t0:.1f} s")

    # the helpers no model calls
    t0 = time.perf_counter()
    report["helpers"] = _last_helpers()
    print(f"[t] the helpers no model calls, on the card against the CPU (relative gaps; "
          f"MeanMatching max |d| and its shift drawn on the card): "
          f"{json.dumps(report['helpers'])}; {time.perf_counter() - t0:.2f} s")
    if dev == "cuda":
        torch.cuda.empty_cache()
    print("[t] " + json.dumps(report))
    return paths


def phase_report(paths, worst, k3_err, k3_bwd_err, two_launch_so):
    """One row per kernel and shape (K1 has four, K3's sums and backward two
    each); ``launches``
    counts every path's runs together (K2 runs only on the serving
    --pallas_conv route): ``launches_serving`` phases (c) and (f),
    ``launches_train`` phases (e) and (g), and ``launches_by_path`` each.
    ``paths`` maps a path to its launch counts by kernel; ``two_launch_so``
    is the earlier two-launch design of K3's sums, timed beside them."""
    import torch
    import torch.nn.functional as F

    from desr_tpu_torch.ops import conv3x3 as K
    from desr_tpu_torch.ops import masked_loss as K3
    from desr_tpu_torch.tools.masked_loss_ab import TwoLaunch

    two_launch = TwoLaunch(two_launch_so)

    def counts(kernel):
        by_path = {p: c.get(kernel, 0) for p, c in paths.items()}
        serving = sum(v for p, v in by_path.items() if p.startswith("serve"))
        train = sum(v for p, v in by_path.items() if p.startswith("train"))
        artifact = sum(v for p, v in by_path.items() if p.startswith("serve_artifact"))
        quality = by_path.get("quality", 0)
        return {"launches": serving + train + quality, "launches_serving": serving,
                "launches_train": train, "launches_artifact": artifact,
                "launches_quality": quality, "launches_by_path": by_path}

    rows = []
    # K1 and K2 at the main serving shape (reflect), K1 at the translator's
    # (replicate), at the SR step's two HR shapes: Depth_f's (reflect) and
    # G_A_d's (replicate), at the I2D step's, the augmented main step's two and
    # the translators' serving shape; each with its own bound.
    # "launches_at_shape" says which path launches K1 at that shape, how often
    k1 = "desr_tpu/ops/pallas_conv.py:353"
    for name, entry, shape, mode, replaces, at_shape, *rest in (
            ("conv3x3_fused", "K1", SERVE_SHAPE, "reflect", k1,
             "main serving 24 a batch (I2D_features, Depth_f); I2D serving 12 (Image_f); "
             "main step 24 at B=12"),
            ("conv3x3_fused", "K1 translator", TRANS_SHAPE, "replicate", k1,
             f"main step {K1_TRANS_PER_STEP} (G_A_d)"),
            ("conv3x3_fused", "K1 SR Depth_f", SR_DEPTHF_SHAPE, "reflect", k1,
             "SR step and the bench's 12 (Depth_f, with a backward)"),
            ("conv3x3_fused", "K1 SR translator", SR_TRANS_SHAPE, "replicate", k1,
             f"SR step and the bench's {K1_TRANS_PER_STEP} (G_A_d)"),
            ("conv3x3_fused", "K1 I2D", I2D_TRAIN_SHAPE, "reflect", k1,
             f"I2D step {I2D_K1_PER_STEP} (Image_f; with a backward under "
             "--i2d_train_features)"),
            ("conv3x3_fused", "K1 aug", AUG_SHAPE, "reflect", k1,
             "augmented main step 24 (I2D_features, Depth_f with a backward); phase (t): a "
             "dropout ResnetBlock 2 (float32, with a backward), a use_old resnet_6blocks 12"),
            ("conv3x3_fused", "K1 aug translator", AUG_TRANS_SHAPE, "replicate", k1,
             f"augmented main step {K1_TRANS_PER_STEP} (G_A_d)"),
            ("conv3x3_fused", "K1 translate", TRANSLATE_SHAPE, "replicate", k1,
             f"--translate serving {TRANSLATE_K1_PER_BATCH} a batch (G_A or G_B)"),
            ("conv3x3_fused", "K1 stage2", STAGE2_SHAPE, "replicate", k1,
             f"stage-2 iteration {STAGE2_K1_PER_ITER} (G_A, G_B: 18 an apply, 4 applies a "
             "G step, 3 G steps; each with a backward); phase (t): G_A with dropout 18 "
             "(float32, with a backward)"),
            ("conv3x3", "K2", SERVE_SHAPE, "reflect", "desr_tpu/ops/pallas_conv.py:309",
             "main serving --pallas_conv route 24 a batch"),
            # phase (p)'s shapes (the quality chains; the launches are K1's on that path)
            ("conv3x3_fused", "K1 quality w8 float32", Q_W8_SHAPE, "reflect", k1,
             "quality p1 (main, --width 8, float32): I2D_features, Depth_f 24 a step at "
             "B=8, serving 24 a batch of 8", torch.float32),
            ("conv3x3_fused", "K1 quality", Q_SHAPE, "reflect", k1,
             "quality p2 (main, default widths): 24 a step at B=8, serving 24 a batch of 8; "
             "p3's pretrain 24 a step, its SR fine-tune 12 (I2D_features at LR)"),
            ("conv3x3_fused", "K1 quality translator", Q_TRANS_SHAPE, "replicate", k1,
             f"quality p1 (float32) and p2, p3's pretrain: {K1_TRANS_PER_STEP} a step (G_A_d)"),
            ("conv3x3_fused", "K1 quality SR HR", Q_SR_HR_SHAPE, "reflect", k1,
             "quality p3's SR fine-tune 12 a step (Depth_f at HR, with a backward)"),
            ("conv3x3_fused", "K1 quality SR translator", Q_SR_TRANS_SHAPE, "replicate", k1,
             f"quality p3's SR fine-tune {K1_TRANS_PER_STEP} a step (G_A_d at HR); p4's "
             "stage-2 iterations (G_A, G_B, each with a backward)"),
            ("conv3x3_fused", "K1 quality I2D", Q_I2D_SHAPE, "reflect", k1,
             f"quality p4's I2D steps {I2D_K1_PER_STEP} (Image_f)"),
            ("conv3x3_fused", "K1 quality translate", Q_TRANSLATE_SHAPE, "replicate", k1,
             f"quality p4's --translate BtoA serving {TRANSLATE_K1_PER_BATCH} a batch of 2"),
            ("conv3x3_fused", "K1 quality serve", Q_SERVE_SHAPE, "reflect", k1,
             f"quality p4's --I2D serving {I2D_K1_PER_BATCH} a batch of 2; p3's SR serving "
             "12 (I2D_features at LR) from the artifact"),
            ("conv3x3_fused", "K1 split", SPLIT_SHAPE, "replicate", k1,
             f"phase (t): GeneratorI_F -> GeneratorF_D {SPLIT_K1} a forward (float32, with "
             "a backward), on the kernel and on its plain version")):
        dtype = rest[0] if rest else torch.bfloat16
        dt = str(dtype)[6:]
        b, h, w, c = shape
        x, wt, scale, shift = _inputs(dtype, seed=1, shape=shape)
        if name == "conv3x3_fused":
            fn = lambda: K.conv3x3_fused(x, wt, scale, shift, mode, True, True)  # noqa: E731
            plain = lambda: K.conv3x3_fused_plain(x, wt, scale, shift, mode, True, True)  # noqa: E731
            extra_bytes = 2 * b * c * 4 * 2  # f32 scale, shift read; s, s2 written
        else:
            fn = lambda: K.conv3x3(x, wt, mode)  # noqa: E731
            plain = lambda: K.conv3x3_fused_plain(x, wt, pad_mode=mode)  # noqa: E731
            extra_bytes = 0
        flops = 2.0 * 9 * c * c * b * h * w
        size = x.element_size()
        io = 2 * b * h * w * c * size + 9 * c * c * size  # x read and out written, w read
        xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode=mode)
        xp = xp.contiguous(memory_format=torch.channels_last)
        wb = wt.to(dtype).contiguous(memory_format=torch.channels_last)
        # float32 runs on the CUDA cores (TF32 is off), bf16 on the tensor cores
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
        t_ops, t_bytes = flops / peak * 1e3, (io + extra_bytes) / PEAK_HBM * 1e3
        row = {
            "name": name, "route": "cuda", "source": "desr_tpu_torch/csrc/conv3x3.cu",
            "replaces": replaces, **counts(entry.split()[0]),
            "max_abs_err": worst[entry],
            "event_ms": cuda_ms(fn), **_device_stats(fn, "conv3x3"),
            # the wrapper and the desr:: operator's dispatch, per call
            "host_ms": issue_ms(fn),
            "plain_ms": cuda_ms(plain, iters=5),
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": cuda_ms(lambda: F.conv2d(xp, wb)),
            "shape": f"B={b} {h}x{w} {c}->{c} {dt} {mode}"
                     + (" norm+relu+stats" if name == "conv3x3_fused" else ""),
            "flops": flops,
        }
        # the kernel's counter is one for all shapes: "launches" are all of K1's
        row["launches_at_shape"] = at_shape
        if entry == "K1 stage2":
            row.update(_k1_backward_ms(x, wt, scale, shift, xp, wb, mode))
            print(f"[d] K1 composition's backward at {row['shape']}: {row['backward_ms']:.4g} "
                  f"ms a call by CUDA events, {row['backward_device_ms']} ms of device time "
                  f"(cuDNN's conv backward alone {row['library_backward_ms']:.4g} / "
                  f"{row['library_backward_device_ms']} ms); the forward "
                  f"{row['event_ms']:.4g} / {row['device_ms']} ms")
        rows.append(row)
        del x, wt, scale, shift, xp, wb
    # K1 and K2 with halo rows at a rank's band of the serving blocks' input
    # (phase (r)'s: 64 of 128 rows and one halo row); launches: the halo
    # launches of every path (phase (r)'s ranks); cuDNN on the same rows,
    # padded at the frame's edge alone
    for name, entry, shape, mode, replaces, at_shape in (
            ("conv3x3_fused", "K1 halo", HALO_SHAPE, "reflect", k1,
             "--spatial_devices 2 serving, a rank: main 24 a batch of 8 (I2D_features, "
             "Depth_f), --SR 12 at B=4 (Depth_f at HR; I2D_features' 12 at B=4 64+1x160), "
             "--I2D 12 (Image_f); all with halo rows"),
            ("conv3x3_fused", "K1 halo translator", HALO_SHAPE[:3] + (256,), "replicate", k1,
             "--spatial_devices 2 --translate serving, a rank: 18 a batch (G_A)"),
            ("conv3x3", "K2 halo", HALO_SHAPE, "reflect", "desr_tpu/ops/pallas_conv.py:309",
             "--spatial_devices 2 main serving --pallas_conv route, a rank: 24 a batch")):
        b, h_in, w, c = shape
        h = h_in - 1
        x, wt, scale, shift = _inputs(torch.bfloat16, seed=1, shape=shape)
        if name == "conv3x3_fused":
            fn = lambda: K.conv3x3_fused(x, wt, scale, shift, mode, True, True, 1, 0)  # noqa: E731
            plain = lambda: K.conv3x3_fused_plain(x, wt, scale, shift, mode, True, True, 1, 0)  # noqa: E731
            extra_bytes = 2 * b * c * 4 * 2
        else:
            fn = lambda: K.conv3x3(x, wt, mode, 1, 0)  # noqa: E731
            plain = lambda: K.conv3x3_fused_plain(x, wt, pad_mode=mode, halo_top=1)  # noqa: E731
            extra_bytes = 0
        flops = 2.0 * 9 * c * c * b * h * w
        io = (b * h_in * w * c + b * h * w * c + 9 * c * c) * x.element_size()
        xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 0, 1), mode=mode)
        xp = xp.contiguous(memory_format=torch.channels_last)
        wb = wt.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        t_ops, t_bytes = flops / PEAK_BF16 * 1e3, (io + extra_bytes) / PEAK_HBM * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": "desr_tpu_torch/csrc/conv3x3.cu",
            "replaces": replaces, **counts(entry.split()[0] + " halo"),
            "max_abs_err": worst[entry],
            "event_ms": cuda_ms(fn), **_device_stats(fn, "conv3x3"),
            "host_ms": issue_ms(fn), "plain_ms": cuda_ms(plain, iters=5),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": cuda_ms(lambda: F.conv2d(xp, wb)),
            "shape": f"B={b} ({h}+1)x{w} {c}->{c} bfloat16 {mode}, halo rows (1, 0)"
                     + (" norm+relu+stats" if name == "conv3x3_fused" else ""),
            "flops": flops, "launches_at_shape": at_shape,
        })
        del x, wt, scale, shift, xp, wb
    # K1 with halo rows at the training bands (phase (b)'s TRAIN_HALO; the
    # lower band, halo rows (1, 0)); where the step trains it, the backward
    # of that launch (CUDA events, the composition's, as K1's backward has
    # always been) beside the whole frame's
    for tag, whole, mode, trained in TRAIN_HALO:
        b, hh, w, c = whole
        h = hh // 2
        key = "K1 halo train " + tag
        x, wt, scale, shift = _inputs(torch.bfloat16, seed=1, shape=(b, h + 1, w, c))
        fn = lambda: K.conv3x3_fused(x, wt, scale, shift, mode, True, True, 1, 0)  # noqa: E731
        plain = lambda: K.conv3x3_fused_plain(x, wt, scale, shift, mode, True, True, 1, 0)  # noqa: E731
        flops = 2.0 * 9 * c * c * b * h * w
        io = (b * (h + 1) * w * c + b * h * w * c + 9 * c * c) * x.element_size()
        xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 0, 1), mode=mode)
        xp = xp.contiguous(memory_format=torch.channels_last)
        wb = wt.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        t_ops, t_bytes = flops / PEAK_BF16 * 1e3, (io + 2 * b * c * 4 * 2) / PEAK_HBM * 1e3
        row = {
            "name": "conv3x3_fused", "route": "cuda", "source": "desr_tpu_torch/csrc/conv3x3.cu",
            "replaces": k1, **counts("K1 halo"), "max_abs_err": worst[key],
            # the backwards of K1 launches with halo rows on every path (the
            # composition's VJP through cuDNN, no kernel of its own)
            "backward_launches_halo": sum(c.get("K1 backward halo", 0) for c in paths.values()),
            "event_ms": cuda_ms(fn), **_device_stats(fn, "conv3x3"),
            "host_ms": issue_ms(fn), "plain_ms": cuda_ms(plain, iters=5),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": cuda_ms(lambda: F.conv2d(xp, wb)),
            "shape": f"B={b} ({h}+1)x{w} {c}->{c} bfloat16 {mode}, halo rows (1, 0) "
                     "norm+relu+stats",
            "flops": flops,
            "launches_at_shape": TRAIN_HALO_PATHS[tag],
        }
        if trained:
            row.update({f"band_{k}": v for k, v in _k1_backward_ms(
                x, wt, scale, shift, xp, wb, mode, halo=(1, 0)).items()})
            xw, wtw, scw, shw = _inputs(torch.bfloat16, seed=1, shape=whole)
            xpw = F.pad(xw.permute(0, 3, 1, 2), (1, 1, 1, 1), mode=mode)
            xpw = xpw.contiguous(memory_format=torch.channels_last)
            row.update({f"whole_{k}": v for k, v in _k1_backward_ms(
                xw, wtw, scw, shw, xpw, wb, mode).items()})
            print(f"[d] K1 composition's backward at {row['shape']}: "
                  f"{row['band_backward_ms']:.4g} ms a call by CUDA events (cuDNN's conv "
                  f"backward alone {row['band_library_backward_ms']:.4g}); the whole frame's "
                  f"B={b} {hh}x{w}: {row['whole_backward_ms']:.4g} ms "
                  f"({row['whole_library_backward_ms']:.4g})")
            del xw, wtw, scw, shw, xpw
        rows.append(row)
        del x, wt, scale, shift, xp, wb
    # K3 at the main train step's shape and at the SR step's HR one, f32
    # pred/target (the model's tail is f32): the sums, then the backward as
    # the step runs it (target is data: no dt); the two-launch design on the
    # same inputs, which must give the plain sums too
    g = torch.tensor([0.7, -1.3, 0.4], device="cuda")
    for shape, at_shape in ((LOSS_SHAPE, f"main step {K3_PER_STEP} (--no_aug)"),
                            (AUG_LOSS_SHAPE, f"augmented main step {K3_PER_STEP}"),
                            (SR_LOSS_SHAPES[0], "SR step and the bench's 1 (+1 at 1x512x640)"),
                            (Q_LOSS_SHAPE, f"quality p1 and p2 {K3_PER_STEP} a step")):
        ins = _loss_inputs(shape, torch.float32, seed=2)
        n = ins[0].numel()
        label = f"{'x'.join(map(str, shape))} f32 pred/target, f32 masks"
        sums = lambda: K3.masked_loss_sums(*ins)  # noqa: E731
        old = lambda: two_launch.call(ins, torch.empty(3, device="cuda"))  # noqa: E731
        out = torch.empty(3, device="cuda")
        two_launch.call(ins, out)
        want = K3.masked_loss_sums_plain(*ins)
        check(bool(((out - want).abs() <= 1e-5 * want.abs()).all()),
              f"the two-launch sums at {shape}: {out.tolist()} against {want.tolist()}")
        old_stats = _device_stats(old, "masked_loss")
        t_bytes = 4 * 4 * n / PEAK_HBM * 1e3  # four f32 inputs read once; 12 B written
        t_ops = 9 * n / PEAK_F32 * 1e3       # 3 mul + 1 sub + 1 mul, 2 abs, 1 square, 3 adds
        rows.append({
            "name": "masked_loss_sums", "route": "cuda",
            "source": "desr_tpu_torch/csrc/masked_loss.cu",
            "replaces": "desr_tpu/ops/pallas_kernels.py:97", **counts("K3"),
            "launches_at_shape": at_shape, "max_abs_err": k3_err[shape],
            **_device_stats(sums, "masked_loss_sums"),
            "event_ms": cuda_ms(sums, iters=50, warmup=5),
            # back to back, inputs under the 50 MB L2 stay there
            "device_ms_l2_warm": _device_stats(sums, "masked_loss_sums",
                                               flush_l2=False)["device_ms"],
            "host_ms": host_ms(sums),
            "plain_ms": cuda_ms(lambda: K3.masked_loss_sums_plain(*ins), iters=20),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "two_launch_ms": old_stats["device_ms"],
            "two_launch_kernels_per_call": old_stats.get("device_kernels_per_call"),
            "shape": label,
        })
        bwd = lambda: K3.masked_loss_grads(*ins, g, False)  # noqa: E731
        plain = lambda: K3.masked_loss_grads_plain(*ins, g, False)  # noqa: E731
        t_bytes = (4 * 4 + 4) * n / PEAK_HBM * 1e3  # four f32 inputs read, f32 dp written
        t_ops = 15 * n / PEAK_F32 * 1e3  # d1, d2 4; 2 signs; 7 mul/add of gt; the negation
        rows.append({
            "name": "masked_loss_grads", "route": "cuda",
            "source": "desr_tpu_torch/csrc/masked_loss.cu",
            "replaces": "desr_tpu/ops/pallas_kernels.py:129 (_mls_bwd, the VJP of :120)",
            **counts("K3 backward"), "launches_at_shape": at_shape,
            "max_abs_err": k3_bwd_err[shape],
            **_device_stats(bwd, "masked_loss_grads"),
            "event_ms": cuda_ms(bwd, iters=50, warmup=5),
            "host_ms": host_ms(bwd),
            "plain_ms": cuda_ms(plain, iters=20),
            # the plain backward's kernels, all of them (L2 not flushed)
            "plain_device_ms": _profile(plain, iters=10, tag="d", unit="call")[
                "profile_device_ms_per_call"],
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            # the backward before this kernel was the plain version: plain_device_ms
            "library_ms": None, "shape": label + ", no dt",
        })
        del ins
    rows += _k4_rows(counts)
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


# K4's rows: (B, C, H, W), layout, which norms of a main serving batch of 8
# (512x640) run at that shape; every shape and layout phase (c)'s serving
# forward gives K4, and the tail's
K4_SHAPES = (
    ((8, 32, 512, 640), "nchw", "the resnet_6blocks stems (I2D_features, Depth_f) 2"),
    ((8, 32, 512, 640), "channels_last", "the resnet_6blocks' last up 2"),
    ((8, 64, 256, 320), "nchw", "the resnet_6blocks' first down 2, the U-Nets' 256x320 up 2"),
    ((8, 64, 256, 320), "channels_last", "the resnet_6blocks' first up 2"),
    ((8, 128, 128, 160), "nchw", "the resnet_6blocks' second down 2, the U-Nets' 128x160 "
                                 "levels 4"),
    ((8, 256, 64, 80), "nchw", "the U-Nets' 64x80 levels 4"),
    ((8, 512, 32, 40), "nchw", "the U-Nets' 32x40 levels 4"),
    ((8, 512, 8, 10), "nchw", "the U-Nets' 8x10 levels 4 (16x20: 4 more)"),
)
K4_TAIL_SHAPE = (8, 128, 128, 160)  # the ResnetBlocks' output, channels_last: 12 tails


def _k4_rows(counts):
    """Phase (d)'s K4 rows (see ``K4_SHAPES``): the moments, the apply
    (normalise+ReLU from the moments) and the tail's apply (scale, shift and
    the skip), bf16, each with its device time (L2 flushed), its bound (HBM
    bytes: 2 B a value read for the moments; 2 read and 2 written for the
    apply, 2 more read for the skip; the f32 vectors are 8 B a (b, c)), the
    plain version's time, and both versions' largest error against the
    float64 norm. Each row is checked as the card test checks it: the
    moments within 1e-5 of the float64 sum |x| and sum x^2, the apply's
    error no larger than the plain version's plus half a bf16 step. The
    apply rows from the moments also time the library's whole norm,
    ``F.instance_norm`` then ``relu_`` (a channels_last x copied to NCHW by
    it and back, to the layout K4 keeps), against K4's two launches, both
    by CUDA events (``library_ms``, ``norm_ms``)."""
    import torch
    import torch.nn.functional as F

    from desr_tpu_torch.ops import instance_norm as K4

    src, replaces = "desr_tpu_torch/csrc/instance_norm.cu", "none (XLA fused the JAX InstanceNorm)"
    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = []
    kernel_key = {"instance_norm_moments": "moments_", "norm_apply": "apply_"}

    def row(name, entry, shape, layout, fn, plain, nbytes, err, at_shape):
        return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                **counts(entry), "max_abs_err": err,
                # the kernels: moments_{planes,pixels}_kernel, apply_{planes,pixels}_kernel
                "event_ms": cuda_ms(fn), **_device_stats(fn, kernel_key[name]),
                "host_ms": issue_ms(fn), "plain_ms": cuda_ms(plain, iters=5),
                "bound_ms": nbytes / PEAK_HBM * 1e3, "bound_by": "bytes", "library_ms": None,
                "shape": f"B={shape[0]} {shape[1]}x{shape[2]}x{shape[3]} bfloat16 {layout}",
                "launches_at_shape": at_shape}

    def apply_errs(tag, got, plain, ref):
        e = {"k4": float((got.double() - ref).abs().max()),
             "plain": float((plain.double() - ref).abs().max()),
             "half_step": _half_step(ref)}
        check(e["k4"] <= e["plain"] + e["half_step"],
              f"[d] K4 apply {tag}: largest error against float64 {e['k4']:.4g} > the plain "
              f"version's {e['plain']:.4g} + half a bf16 step {e['half_step']:.4g}")
        return e

    with torch.no_grad():
        for shape, layout, at_shape in K4_SHAPES + ((K4_TAIL_SHAPE, "channels_last", None),):
            b, c, h, w = shape
            n = b * c * h * w
            tag = f"{shape} {layout}"
            x = (1.7 * torch.randn(shape, generator=gen, device="cuda") + 0.4).to(torch.bfloat16)
            if layout == "channels_last":
                x = x.contiguous(memory_format=torch.channels_last)
            x64 = x.double()
            mean = x64.mean(dim=(2, 3), keepdim=True)
            std = (x64.var(dim=(2, 3), unbiased=False, keepdim=True) + 1e-5).sqrt()
            if at_shape is None:  # the tail: x * scale + shift + skip
                sc = torch.rand(shape[:2], generator=gen, device="cuda") + 0.5
                sh = torch.randn(shape[:2], generator=gen, device="cuda")
                skip = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                skip = skip.contiguous(memory_format=torch.channels_last)
                fn = lambda: K4.norm_apply(x, sc, sh, skip=skip)  # noqa: E731
                plain = lambda: K4.norm_apply_plain(x, sc, sh, skip=skip)  # noqa: E731
                ref = (x64 * sc.double()[:, :, None, None] + sh.double()[:, :, None, None]
                       + skip.double())
                rows.append(row("norm_apply", "K4 apply", shape, layout + ", scale/shift + skip",
                                fn, plain, 6 * n + 8 * b * c,
                                apply_errs(tag + " + skip", fn(), plain(), ref),
                                "main serving 12 a batch (the ResnetBlocks' tails)"))
                del skip
                continue
            s, s2 = K4.instance_norm_moments(x)
            mom = lambda: K4.instance_norm_moments(x)  # noqa: E731
            mom_plain = lambda: K4.instance_norm_moments_plain(x)  # noqa: E731
            ps, ps2 = mom_plain()
            err = {}
            for key, got, pl, ref, mag in (
                    ("s", s, ps, x64.sum(dim=(2, 3)), x64.abs().sum(dim=(2, 3))),
                    ("s2", s2, ps2, x64.square().sum(dim=(2, 3)), None)):
                mag = ref if mag is None else mag
                err[key] = {"k4": float((got.double() - ref).abs().max()),
                            "plain": float((pl.double() - ref).abs().max()),
                            "k4_rel": float(((got.double() - ref).abs() / mag).max())}
                check(err[key]["k4_rel"] < 1e-5, f"[d] K4 moments {tag}: {key} off the float64 "
                      f"sums by {err[key]['k4_rel']:.3g} of their magnitude (bound 1e-5)")
            rows.append(row("instance_norm_moments", "K4", shape, layout, mom, mom_plain, 2 * n,
                            err, at_shape))
            app = lambda: K4.norm_apply(x, s, s2, h * w, 1e-5, True)  # noqa: E731
            app_plain = lambda: K4.norm_apply_plain(x, s, s2, h * w, 1e-5, True)  # noqa: E731
            fmt = torch.channels_last if layout == "channels_last" else torch.contiguous_format
            lib = lambda: F.instance_norm(x, eps=1e-5).relu_().contiguous(  # noqa: E731
                memory_format=fmt)
            pair = lambda: K4.norm_apply(x, *K4.instance_norm_moments(x), h * w,  # noqa: E731
                                         1e-5, True)
            ref = ((x64 - mean) / std).clamp(min=0)
            r = row("norm_apply", "K4 apply", shape, layout + ", from moments, relu", app,
                    app_plain, 4 * n + 8 * b * c, apply_errs(tag, app(), app_plain(), ref),
                    at_shape)
            r["max_abs_err"]["library"] = float((lib().double() - ref).abs().max())
            r.update(library_ms=cuda_ms(lib), norm_ms=cuda_ms(pair))
            rows.append(r)
            del x, x64, mean, std, ref
    for r in rows:
        e = r["max_abs_err"]
        if r["name"] == "instance_norm_moments":
            print(f"[d] K4 {r['name']} {r['shape']}: largest error against float64, s "
                  f"{e['s']['k4']:.3g} (plain {e['s']['plain']:.3g}), s2 {e['s2']['k4']:.3g} "
                  f"(plain {e['s2']['plain']:.3g})")
            continue
        print(f"[d] K4 {r['name']} {r['shape']}: largest error against float64 {e['k4']:.3g} "
              f"(plain {e['plain']:.3g}, half a step {e['half_step']:.3g}"
              + (f", library {e['library']:.3g}); the whole norm {r['norm_ms']:.4g} ms, "
                 f"F.instance_norm + relu_ {r['library_ms']:.4g} ms (CUDA events)"
                 if "library" in e else ")"))
    return rows


def _half_step(v):
    """Half a bf16 step at |v|'s largest value."""
    return 0.5 * 2.0 ** (math.floor(math.log2(max(float(v.abs().max()), 1e-30))) - 7)


def _k1_backward_ms(x, wt, scale, shift, xp, wb, mode, halo=()):
    """Times of the backward of one ``conv3x3_fused`` launch (norm+relu+stats)
    on these inputs, whose graph is kept: the stats' cotangents folded into
    the output's, ``aten.convolution_backward`` on the recomputed padded
    input, the pad's and the prologue's adjoints; and of cuDNN's backward
    of ``F.conv2d`` on the padded input alone. CUDA events over back-to-back
    calls (host time included) and the profiler's device time a call (all
    its kernels, L2 not flushed)."""
    import torch
    import torch.nn.functional as F

    from desr_tpu_torch.ops import conv3x3 as K

    ins = [t.detach().requires_grad_(True) for t in (x, wt, scale, shift)]
    outs = K.conv3x3_fused(*ins, mode, True, True, *halo)
    gen = torch.Generator(device="cuda").manual_seed(5)
    gouts = [torch.randn(t.shape, generator=gen, device="cuda").to(t.dtype) for t in outs]
    xpl, wbl = xp.detach().requires_grad_(True), wb.detach().requires_grad_(True)
    y = F.conv2d(xpl, wbl)
    gy = torch.randn(y.shape, generator=gen, device="cuda").to(y.dtype)

    def bwd():
        return torch.autograd.grad(outs, ins, gouts, retain_graph=True)

    def lib():
        return torch.autograd.grad(y, (xpl, wbl), gy, retain_graph=True)

    def device(fn):
        # the profiler can trace nothing in a round (it once missed
        # cuDNN's backward alone): up to three rounds
        for _ in range(3):
            ms = _profile(fn, iters=10, tag="d", unit="call")["profile_device_ms_per_call"]
            if ms is not None:
                return ms
        return None

    return {"backward_ms": cuda_ms(bwd, iters=10), "backward_device_ms": device(bwd),
            "library_backward_ms": cuda_ms(lib, iters=10),
            "library_backward_device_ms": device(lib)}


def _device_stats(fn, key, repeats=1, flush_l2=True):
    """``device_ms`` over ``repeats`` rounds that traced the kernels: the
    median of the rounds' medians, the least and most call, each round's
    median and traced count. The profiler can miss a whole round, so up to
    2 * repeats + 1 rounds are run; None only when none traced them."""
    import statistics

    rounds = []
    for _ in range(2 * repeats + 1):
        r = device_ms(fn, key, flush_l2=flush_l2)
        if r is not None:
            rounds.append(r)
        if len(rounds) == repeats:
            break
    if not rounds:
        return {"device_ms": None}
    return {"device_ms": statistics.median(r["median"] for r in rounds),
            "device_ms_min": min(r["min"] for r in rounds),
            "device_ms_max": max(r["max"] for r in rounds),
            "device_ms_round_medians": [r["median"] for r in rounds],
            "device_kernels_traced": [r["traced"] for r in rounds],
            "device_kernels_per_call": len(rounds[0]["names"]),
            "device_kernel_names": [n[:90] for n in rounds[0]["names"]]}


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
    card, two_launch_so = phase_card_and_build()
    worst = phase_kernels()
    worst.update(phase_halo_kernels())
    worst.update(phase_halo_training_kernels())
    k3_err, k3_bwd_err = phase_masked_loss()
    paths = {}  # each path's launches by kernel, from its phase's run of the entry point
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=ROOT) as root:
        for phase in (phase_serving, phase_training, phase_sr_serving, phase_deployment,
                      phase_sr_training, phase_i2d_serving, phase_translate_serving,
                      phase_i2d_training, phase_translation_training, phase_device_aug,
                      phase_train_surface, phase_bench_io, phase_quality,
                      phase_data_parallel, phase_spatial, phase_spatial_training,
                      phase_last_capabilities):
            t0 = time.perf_counter()
            tmp = os.path.join(root, phase.__name__)
            os.makedirs(tmp)
            if phase is phase_deployment:  # serves (c)'s and (f)'s checkpoints and frames
                served = [os.path.join(root, p.__name__) for p in (phase_serving, phase_sr_serving)]
                paths.update(phase(tmp, *served))
                for d in served:
                    shutil.rmtree(d)
            else:
                paths.update(phase(tmp))
            if phase not in (phase_serving, phase_sr_serving):
                shutil.rmtree(tmp)
            torch.cuda.empty_cache()
            print(f"[{phase.__name__}] {time.perf_counter() - t0:.1f} s")
    rows = phase_report(paths, worst, k3_err, k3_bwd_err, two_launch_so)
    for r in rows:
        check(r["launches"] > 0, f"{r['name']} was launched on no path")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
