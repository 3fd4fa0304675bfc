"""Trajectory-level quality evidence for the port: train -> serve -> score.

The port's counterpart of the repository's ``tools/quality_eval.py``. It
writes a *learnable* synthetic RGB-D set, trains a stage through the port's
training CLI (``desr_tpu_torch.train.main``), serves the checkpoints through
its serving CLI (``desr_tpu_torch.predict.main``; the SR stage through
``--export`` then ``--from_export``) and scores the predictions with the
offline metrics (``desr_tpu_torch.metrics.calculate_given_paths``: rmse over
valid-target pixels, rmse_h over input-hole pixels, rmse_d over jointly
valid ones). A trained model must beat the degraded input on them.

Scene model (the JAX tool's, array for array from the same seed):
- clean depth = low-frequency sinusoids + a planar ramp, in mm;
- RGB = Lambertian shading of the depth normals x a low-frequency albedo;
- degraded = clean + Gaussian sensor noise + rectangular dropouts + speckle.

Stages (``--stage``): ``main`` (the stage-3 depth enhancement at ``--hw``),
``sr`` (the x2 SR fine-tune at the ScanNet geometry, 480x640 sensor frames
and 960x1280 HR ground truth, after one main-stage pretrain of
``--sr_pre_epochs``; served through the exported artifact; with a bicubic
baseline), ``i2d`` (stage 1, depth from RGB alone at 480x640; with a constant
train-mean baseline) and ``translation`` (stage 2's G_B, LQ -> HQ).

It runs on the card unless asked for the CPU: ``--device`` (default
``cuda``) goes to every train and predict call, and without a card the tool
exits with an error before it writes anything. (The JAX tool's ``--platform
cpu|native`` picked JAX's backend; its ``--num_devices 1`` to ``predict.py``
is left out, since the port's ``predict`` refuses that flag.)

Usage (CPU, a few minutes at width 8):
    python -m desr_tpu_torch.tools.quality_eval --root <dir> --device cpu
    python -m desr_tpu_torch.tools.quality_eval --root <dir> --compute_dtype bfloat16

Stdout holds ONE JSON line: ``baseline``, ``trained``, ``improvement``,
``delta_higher_better`` (and ``baseline_bicubic`` under ``sr``,
``baseline_mean`` under ``i2d``), as the JAX tool's, plus ``seconds`` (the
wall of the data write, training, serving and scoring) and ``device``. The
CLIs' own output goes to stderr. ``width_flags(None)`` is the options'
default widths (``run`` with ``args.width = None``).

``--framework reference|both`` also trains the original PyTorch reference
(``--reference_root``, or ``$DESR_REFERENCE_ROOT``) on the same data from
the same init checkpoints, on the CPU, through its own training loop.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import shutil
import sys
import time
from glob import glob

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# ---------------------------------------------------------------- scene gen


def _lowfreq_field(rng, h, w, n_waves=4, amp=1.0, freq=1.0):
    """Sum of random low-frequency sinusoids in [-amp, amp]-ish."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    f = np.zeros((h, w))
    for _ in range(n_waves):
        fx, fy = rng.uniform(0.3, 2.0, 2) * 2 * np.pi * freq
        px, py = rng.uniform(0, 2 * np.pi, 2)
        f += rng.uniform(0.3, 1.0) * np.sin(fx * xx / w + px) * np.sin(fy * yy / h + py)
    return amp * f / n_waves


def degrade(rng, clean):
    """Sensor model: Gaussian noise + rectangular dropouts + speckle holes."""
    h, w = clean.shape
    noisy = clean + rng.normal(0, 25.0, clean.shape)
    for _ in range(rng.integers(6, 12)):  # sensor dropout rectangles
        rh, rw = rng.integers(8, 28, 2)
        rh, rw = min(rh, h - 1), min(rw, w - 1)  # keep rects inside tiny frames
        y0 = int(rng.integers(0, h - rh))
        x0 = int(rng.integers(0, w - rw))
        noisy[y0:y0 + rh, x0:x0 + rw] = 0.0
    noisy[rng.random(clean.shape) < 0.01] = 0.0  # speckle holes
    return np.clip(noisy, 0, 65535).astype(np.uint16)


def make_scene(rng, h, w, freq=1.0):
    """Returns (clean_mm uint16, rgb uint8, degraded_mm uint16).

    ``freq`` scales the sinusoid frequencies: the SR stage trains on HR
    crops of 960x1280 canvases, so its scenes carry ~4x the structure to put
    full wavelengths inside a training crop."""
    base = rng.uniform(1400, 2600)
    ramp = (_lowfreq_field(rng, h, w, 2, 600.0, freq)
            + rng.uniform(-3, 3) * np.arange(w)[None, :]
            + rng.uniform(-3, 3) * np.arange(h)[:, None])
    clean = np.clip(base + ramp + _lowfreq_field(rng, h, w, 5, 500.0, freq), 600, 4800)

    # Lambertian shade from the depth gradient + low-freq albedo -> RGB that
    # carries geometric signal (the guidance the image branches rely on)
    dzdx = np.gradient(clean, axis=1)
    dzdy = np.gradient(clean, axis=0)
    n = np.stack([-dzdx, -dzdy, 20.0 * np.ones_like(clean)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    light = np.array([0.3, -0.2, 0.93])
    shade = np.clip(n @ light, 0, 1)
    albedo = 0.55 + _lowfreq_field(rng, h, w, 3, 0.35)
    rgb = np.stack([np.clip(shade * albedo * g, 0, 1) for g in rng.uniform(0.8, 1.2, 3)], -1)
    rgb8 = (rgb * 255).astype(np.uint8)

    return clean.astype(np.uint16), rgb8, degrade(rng, clean)


# ------------------------------------------------------------ dataset writers


def _imwrite(path, arr):
    from desr_tpu_torch.data.png import write_png

    write_png(path, np.ascontiguousarray(arr))


def _imread(path):
    from desr_tpu_torch.data.native_io import read_image

    return read_image(path)


def _make_dirs(root, names):
    dirs = {k: os.path.join(root, k) for k in names}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    return dirs


def _intrinsics_writer(intr, h, w):
    """``put(stem)`` writes ``<intr>/<stem[:12]>/intrinsic/intrinsic_depth.txt``:
    a steep focal (4.5 w) that keeps normals well-conditioned at small sizes."""
    fx = 4.5 * w

    def put(stem):
        d = os.path.join(intr, stem[:12], "intrinsic")
        os.makedirs(d, exist_ok=True)
        np.savetxt(os.path.join(d, "intrinsic_depth.txt"),
                   np.array([[fx, 0, w / 2, 0], [0, fx, h / 2, 0],
                             [0, 0, 1, 0], [0, 0, 0, 1]]))
    return put


_MAIN_DIRS = ["A_depth", "A_img", "B_depth", "B_img", "test_in", "test_img", "test_gt"]


def write_dataset(root, n_train, n_test, h, w, seed=23):
    """Main / I2D set: A = clean synthetic renders, B = degraded real
    frames (distinct scenes, unpaired), paired test frames (degraded in,
    clean ground truth)."""
    rng = np.random.default_rng(seed)
    dirs = _make_dirs(root, _MAIN_DIRS)
    intr = os.path.join(root, "intr")
    put_intr = _intrinsics_writer(intr, h, w)
    for i in range(n_train):
        stem = f"scene{i:04d}_00_{i}"
        clean, rgb, noisy = make_scene(rng, h, w)
        # predict serves the B (real) branch: the served frames are degraded
        _imwrite(os.path.join(dirs["B_depth"], stem + ".png"), noisy)
        _imwrite(os.path.join(dirs["B_img"], stem + ".png"), rgb)
        clean_b, rgb_b, _ = make_scene(rng, h, w)
        _imwrite(os.path.join(dirs["A_depth"], stem + ".png"), clean_b)
        _imwrite(os.path.join(dirs["A_img"], stem + ".png"), rgb_b)
        put_intr(stem)
    for i in range(n_test):
        stem = f"scene{n_train + i:04d}_00_{n_train + i}"
        clean, rgb, noisy = make_scene(rng, h, w)
        _imwrite(os.path.join(dirs["test_in"], stem + ".png"), noisy)
        _imwrite(os.path.join(dirs["test_img"], stem + ".png"), rgb)
        _imwrite(os.path.join(dirs["test_gt"], stem + ".png"), clean)
        put_intr(stem)
    return dirs, intr


def write_dataset_sr(root, n_train, n_test, seed=23):
    """SR set at the real pipeline's geometry: 480x640 train frames (A
    clean, B degraded), from which the naive SR dataset builds its 960x1280
    canvases; test scenes made at 960x1280 as ground truth, their degraded
    LR view the [0::2, 0::2] subsample, and the served input its x2
    INTER_AREA canvas (``test_in_hr``, ``test_img_hr``). The LR prediction is
    scored against the HR target by the metric's SR rule (target[0::2,
    0::2])."""
    from desr_tpu_torch.ops.resize import resize_cv2_inter_area_np

    rng = np.random.default_rng(seed)
    dirs = _make_dirs(root, _MAIN_DIRS + ["test_in_hr", "test_img_hr"])
    intr = os.path.join(root, "intr")
    h, w = 480, 640
    put_intr = _intrinsics_writer(intr, h, w)
    for i in range(n_train):
        stem = f"scene{i:04d}_00_{i}"
        clean_a, rgb_a, _ = make_scene(rng, h, w, freq=4.0)
        _imwrite(os.path.join(dirs["A_depth"], stem + ".png"), clean_a)
        _imwrite(os.path.join(dirs["A_img"], stem + ".png"), rgb_a)
        clean_b, rgb_b, noisy_b = make_scene(rng, h, w, freq=4.0)
        _imwrite(os.path.join(dirs["B_depth"], stem + ".png"), noisy_b)
        _imwrite(os.path.join(dirs["B_img"], stem + ".png"), rgb_b)
        put_intr(stem)
    for i in range(n_test):
        stem = f"scene{n_train + i:04d}_00_{n_train + i}"
        clean_hr, rgb_hr, _ = make_scene(rng, 2 * h, 2 * w, freq=4.0)  # HR ground truth
        lr = degrade(rng, clean_hr[0::2, 0::2].astype(np.float64))
        lr_rgb = rgb_hr[0::2, 0::2]
        _imwrite(os.path.join(dirs["test_gt"], stem + ".png"), clean_hr)
        _imwrite(os.path.join(dirs["test_in"], stem + ".png"), lr)
        _imwrite(os.path.join(dirs["test_img"], stem + ".png"), lr_rgb)
        # the served input: the x2 INTER_AREA canvas the SR model trains on
        up = resize_cv2_inter_area_np(lr.astype(np.float32), (2 * h, 2 * w))
        _imwrite(os.path.join(dirs["test_in_hr"], stem + ".png"),
                 np.clip(up, 0, 65535).astype(np.uint16))
        up_rgb = resize_cv2_inter_area_np(lr_rgb.astype(np.float32), (2 * h, 2 * w))
        _imwrite(os.path.join(dirs["test_img_hr"], stem + ".png"),
                 np.clip(np.rint(up_rgb), 0, 255).astype(np.uint8))
        put_intr(stem)
    return dirs, intr


def write_bicubic_baseline(dirs, out_dir):
    """Bicubic x2 upsample (cv2's float INTER_CUBIC) of the degraded LR
    input: the classical SR baseline the trained model must beat."""
    from desr_tpu_torch.ops.resize import resize_cv2_cubic_np

    os.makedirs(out_dir, exist_ok=True)
    for p in sorted(glob(os.path.join(dirs["test_in"], "*.png"))):
        lr = _imread(p).astype(np.float32)
        hr = resize_cv2_cubic_np(lr, (lr.shape[0] * 2, lr.shape[1] * 2))
        _imwrite(os.path.join(out_dir, os.path.basename(p)),
                 np.clip(hr, 0, 65535).astype(np.uint16))
    return out_dir


def write_dataset_translation(root, n_train, n_test, seed=23, hw=(320, 320)):
    """Stage-2 set in ``<root>/train{A,B}/{img,depth}``: A clean scenes, B
    degraded (unpaired), made at ``hw`` (320x320 is the dataset's resize
    target); paired test frames for scoring G_B (LQ -> HQ)."""
    rng = np.random.default_rng(seed)
    h, w = hw
    names = ["test_in", "test_img", "test_gt"]
    dirs = _make_dirs(root, names)
    for d in ("trainA", "trainB"):
        for sub in ("img", "depth"):
            dirs[d + "_" + sub] = os.path.join(root, d, sub)
            os.makedirs(dirs[d + "_" + sub], exist_ok=True)
    intr = os.path.join(root, "intr")
    put_intr = _intrinsics_writer(intr, h, w)
    for i in range(n_train):
        stem = f"scene{i:04d}_00_{i}"
        clean_a, rgb_a, _ = make_scene(rng, h, w)
        _imwrite(os.path.join(dirs["trainA_depth"], stem + ".png"), clean_a)
        _imwrite(os.path.join(dirs["trainA_img"], stem + ".png"), rgb_a)
        _, rgb_b, noisy_b = make_scene(rng, h, w)
        _imwrite(os.path.join(dirs["trainB_depth"], stem + ".png"), noisy_b)
        _imwrite(os.path.join(dirs["trainB_img"], stem + ".png"), rgb_b)
    for i in range(n_test):
        stem = f"scene{n_train + i:04d}_00_{n_train + i}"
        clean, rgb, noisy = make_scene(rng, h, w)
        _imwrite(os.path.join(dirs["test_in"], stem + ".png"), noisy)
        _imwrite(os.path.join(dirs["test_img"], stem + ".png"), rgb)
        _imwrite(os.path.join(dirs["test_gt"], stem + ".png"), clean)
        put_intr(stem)
    return dirs, intr


def write_mean_baseline(dirs, out_dir):
    """The train set's mean depth as a constant prediction: the scale-free
    floor a depth-from-RGB predictor must beat on the structure metrics."""
    os.makedirs(out_dir, exist_ok=True)
    trains = sorted(glob(os.path.join(dirs["A_depth"], "*.png")))
    mean = float(np.mean([_imread(p).astype(np.float64).mean() for p in trains]))
    for p in sorted(glob(os.path.join(dirs["test_in"], "*.png"))):
        shp = _imread(p).shape
        _imwrite(os.path.join(out_dir, os.path.basename(p)),
                 np.full(shp, mean, np.float64).astype(np.uint16))
    return out_dir


# ------------------------------------------------- reference (torch) arm


def _install_albu_shim():
    """An ``albumentations`` module (and a ``torchvision`` stub) for the
    reference's datasets, on the port's own transforms.

    The reference pins albumentations 0.4.6, whose call-level semantics the
    port carries in ``data/transforms.py``; the shim maps the few classes the
    reference datasets use (Compose, Resize, Rotate, RandomCrop,
    HorizontalFlip, PadIfNeeded over joint image + depth targets) onto them.
    torchvision's transforms are constructed but never applied by the main
    datasets; ColorJitter is applied by the I2D one and runs on the port's
    ``color_jitter``.
    """
    if "albumentations" in sys.modules:
        return
    import random as _random
    import types

    from desr_tpu_torch.data import transforms as T

    class _Tf:
        def __init__(self, p=1.0):
            self.p = p

        def draw(self):
            return None

    class Resize(_Tf):
        def __init__(self, height, width, interpolation=1, p=1.0):
            super().__init__(p)
            self.h, self.w, self.interp = height, width, interpolation

        def apply(self, x, _):
            return T.resize(x, self.h, self.w, self.interp)

    class Rotate(_Tf):
        def __init__(self, limit, p=0.5):
            super().__init__(p)
            self.limit = limit

        def draw(self):
            return _random.uniform(self.limit[0], self.limit[1])

        def apply(self, x, angle):
            return T.rotate(x, angle)

    class RandomCrop(_Tf):
        def __init__(self, height, width, p=1.0):
            super().__init__(p)
            self.ch, self.cw = height, width

        def draw(self):
            return _random.random(), _random.random()

        def apply(self, x, hw_start):
            h, w = x.shape[:2]
            y1 = int((h - self.ch) * hw_start[0])
            x1 = int((w - self.cw) * hw_start[1])
            return x[y1:y1 + self.ch, x1:x1 + self.cw]

    class HorizontalFlip(_Tf):
        def apply(self, x, _):
            return T.hflip(x)

    class PadIfNeeded(_Tf):
        def __init__(self, min_height, min_width, p=1.0):
            super().__init__(p)
            self.mh, self.mw = min_height, min_width

        def apply(self, x, _):
            return T.pad_if_needed(x, self.mh, self.mw)

    class Compose:
        # 0.4.6: each transform fires iff random() < p, with ONE param draw
        # shared across all targets (additional_targets={'depth': 'image'})
        def __init__(self, transforms, p=1, additional_targets=None):
            self.transforms = transforms

        def __call__(self, **targets):
            out = dict(targets)
            for t in self.transforms:
                if _random.random() < t.p:
                    params = t.draw()
                    out = {k: t.apply(v, params) for k, v in out.items()}
            return out

    mod = types.ModuleType("albumentations")
    for cls in (Compose, Resize, Rotate, RandomCrop, HorizontalFlip, PadIfNeeded):
        setattr(mod, cls.__name__, cls)
    sys.modules["albumentations"] = mod

    if "torchvision" not in sys.modules:
        class _Inert:
            def __init__(self, *a, **k):
                pass

            def __call__(self, *a, **k):
                raise NotImplementedError(
                    "torchvision stub (quality_eval reference arm): a transform was "
                    "applied, but torchvision is not installed")

        def _stub_attr(name):
            if name.startswith("__"):  # hasattr probes (inspect etc.)
                raise AttributeError(name)
            return _Inert

        class _ColorJitter:
            """torchvision's ColorJitter on PIL images, through the port's
            ``color_jitter`` (the same factor laws and random op order)."""

            def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
                self.kw = dict(brightness=brightness, contrast=contrast,
                               saturation=saturation, hue=hue)

            def __call__(self, img):
                from PIL import Image

                arr = np.asarray(img.convert("RGB")).astype(np.uint8)
                rng = np.random.default_rng(_random.getrandbits(32))
                out = T.color_jitter(rng, arr, **self.kw)
                return Image.fromarray(np.clip(out, 0, 255).astype(np.uint8))

        tv = types.ModuleType("torchvision")
        tvt = types.ModuleType("torchvision.transforms")
        tvf = types.ModuleType("torchvision.transforms.functional")
        tv.__getattr__ = tvt.__getattr__ = tvf.__getattr__ = _stub_attr
        tv.transforms = tvt
        tvt.functional = tvf
        tvt.ColorJitter = _ColorJitter
        sys.modules["torchvision"] = tv
        sys.modules["torchvision.transforms"] = tvt
        sys.modules["torchvision.transforms.functional"] = tvf


def _parse_train_options(argv):
    from desr_tpu_torch.options import train_options

    with contextlib.redirect_stdout(sys.stderr):
        return train_options.parse(argv)


def make_shared_init(dirs, intr, args, arm_names):
    """One set of ``init`` .pth checkpoints every arm starts from: the port's
    model for the stage, its weights drawn from ``--seed``, saved under the
    first arm and copied to the others, which train with ``--continue_train
    --epoch init``."""
    from desr_tpu_torch.train import create_model

    opt = _parse_train_options(_train_argv(dirs, intr, args, arm_names[0])[1:])
    model = create_model(opt, args.device)
    model.save_networks("init")
    src = os.path.join(opt.checkpoints_dir, opt.name)
    for arm in arm_names[1:]:
        dst = os.path.join(args.ckpt_dir, arm)
        os.makedirs(dst, exist_ok=True)
        for f in os.listdir(src):
            if f.startswith("init_net_"):
                shutil.copy2(os.path.join(src, f), os.path.join(dst, f))


def train_reference(dirs, intr, args, name):
    """Drive the reference's own training loop on the same data and options
    (its main.py:58-107): create_dataset over its stage's dataset ->
    set_input -> optimize_parameters -> update_learning_rate a epoch ->
    save_networks('latest'), on the CPU. Serving and scoring then go through
    the port's chain, as for the port's arm."""
    import importlib
    import random as _random

    import torch

    root = args.reference_root
    if not root or not os.path.isdir(root):
        raise FileNotFoundError(
            f"the reference arm needs the reference checkout (--reference_root: {root!r})")
    _install_albu_shim()
    if root not in sys.path:
        sys.path.append(root)  # append: never shadow the port's modules

    ref_data = importlib.import_module("data")
    if args.stage == "sr":
        ref_cls = importlib.import_module("models.main_sr_model").MainSRModel
        ref_ds = importlib.import_module("data.my_naive_sr_dataset")
        # the reference SR model hardcodes gpu_ids=[0,1,2,3] for its G_A_d
        # (models/main_sr_model.py:166): strip them at init_net on the CPU
        ref_tn = importlib.import_module("models.translation_network")
        orig_init_net = ref_tn.init_net

        def cpu_init_net(net, init_type="normal", init_gain="relu", gpu_ids=(), param=None):
            return orig_init_net(net, init_type, init_gain, [], param)

        ref_tn.init_net = cpu_init_net
    elif args.stage == "i2d":
        ref_cls = importlib.import_module("models.I2D_model").I2DModel
        ref_ds = importlib.import_module("data.my_I2D_dataset")
    elif args.stage == "translation":
        ref_cls = importlib.import_module("models.translation_model").TranslationModel
        ref_ds = importlib.import_module("data.translation_dataset")
    else:
        ref_cls = importlib.import_module("models.main_model").MainModel
        ref_ds = importlib.import_module("data.my_main_dataset")

    opt = _parse_train_options(_train_argv(dirs, intr, args, name)[1:])
    ropt = copy.deepcopy(opt)
    ropt.gpu_ids = []  # the reference's init_net: no gpu_ids -> CPU
    ropt.num_threads = 0  # inline loading
    if args.stage == "translation":
        ropt.dataroot = args.root  # <dataroot>/train{A,B}/{img,depth}
    else:
        # CustomDatasetDataLoader builds a throwaway UnalignedDataset first
        # (data/__init__.py:74-76): <dataroot>/trainA, trainB must exist
        ropt.dataroot = os.path.join(args.root, "_ref_dataroot")
        for sub in ("trainA", "trainB"):
            os.makedirs(os.path.join(ropt.dataroot, sub), exist_ok=True)

    torch.manual_seed(args.seed)
    np.random.seed(args.seed)
    _random.seed(args.seed)
    with contextlib.redirect_stdout(sys.stderr):
        model = ref_cls(ropt)
        model.setup(ropt)  # --continue_train: loads the shared init .pth
        dataset = ref_data.create_dataset(ropt, ref_ds.MyUnalignedDataset)
        total_iters = 0
        for _epoch in range(1, args.epochs + 1):
            model._train()
            for data in dataset:
                model.set_input(data)
                total_iters += ropt.batch_size
                model.optimize_parameters(total_iters, ropt.update_ratio)
            model.update_learning_rate()
        model.save_networks("latest")


# ---------------------------------------------------------------- pipeline


def width_flags(width, stage="main"):
    """The nets' width flags, all at ``width``; none (the options' default
    widths) when ``width`` is None. The translator's widths are fixed."""
    if width is None:
        return []
    w = str(width)
    if stage == "i2d":
        return ["--Imagef_outf", w, "--Imagef_basef", w, "--Task_basef", w]
    return ["--ImageDepthf_outf", w, "--ImageDepthf_basef", w,
            "--Depthf_outf", w, "--Depthf_basef", w,
            "--I2D_base", w, "--Task_basef", w]


def _train_argv(dirs, intr, args, name):
    argv = _stage_argv(dirs, intr, args, name)
    if getattr(args, "_shared_init", False):
        argv += ["--continue_train", "--epoch", "init"]
    if getattr(args, "_continue_latest", False):
        # the later flag wins: overrides a preceding '--epoch init'
        argv += ["--continue_train", "--epoch", "latest"]
    return argv


def _common_argv(args, name):
    return ["--name", name, "--checkpoints_dir", args.ckpt_dir,
            "--batch_size", str(args.batch_size), "--compute_dtype", args.compute_dtype,
            "--lr", str(args.lr), "--n_epochs", str(args.epochs), "--n_epochs_decay", "0"]


def _tail_argv(args):
    return ["--save_epoch_freq", str(args.epochs), "--print_freq", str(args.batch_size * 8),
            "--num_threads", "1", "--seed", str(args.seed), "--device", args.device]


def _stage_argv(dirs, intr, args, name):
    """The train CLI's argv for ``args.stage`` (argv[0] is the program)."""
    if args.stage == "i2d":
        # stage 1: fixed dataset geometry (480x640, 384x512 crops); the
        # optimizer covers Task alone unless --i2d_train_features
        return (["train", "--model_type", "I2D", "--do_train",
                 "--image_and_depth", "--use_scannet", "--norm_loss"]
                + _common_argv(args, name)
                + ["--path_A", dirs["A_depth"], "--A_add_paths", dirs["A_img"],
                   "--path_B", dirs["B_depth"], "--B_add_paths", dirs["B_img"]]
                + _tail_argv(args)
                + (["--i2d_train_features"] if args.i2d_train_features else [])
                + width_flags(args.width, "i2d"))
    if args.stage == "translation":
        # stage 2 at the README's flags; the translator's widths are fixed
        return (["train", "--model_type", "translation", "--do_train",
                 "--dataroot", args.root] + _common_argv(args, name)
                + ["--crop_size_h", str(args.crop_size), "--crop_size_w", str(args.crop_size),
                   "--max_distance", "5100"] + _tail_argv(args))
    lh, lw = getattr(args, "_load_hw", args.hw)
    return (["train", "--model_type", "main", "--do_train"]
            + (["--SR"] if args.stage == "sr" else [])
            + ["--image_and_depth", "--use_scannet",
               "--use_image_for_trans", "--use_masked", "--norm_loss"]
            + _common_argv(args, name)
            + ["--path_A", dirs["A_depth"], "--A_add_paths", dirs["A_img"],
               "--path_B", dirs["B_depth"], "--B_add_paths", dirs["B_img"],
               "--path_to_intr", intr,
               "--load_size_h", str(lh), "--load_size_w", str(lw),
               "--crop_size_h", str(args.hw[0]), "--crop_size_w", str(args.hw[1])]
            + _tail_argv(args) + width_flags(args.width))


def train(dirs, intr, args, name):
    """``desr_tpu_torch.train.main`` on the stage's argv, in this process."""
    from desr_tpu_torch.train import main as train_main

    with contextlib.redirect_stdout(sys.stderr):
        train_main(_train_argv(dirs, intr, args, name)[1:])


def _predict(argv):
    from desr_tpu_torch.predict import main as predict_main

    with contextlib.redirect_stdout(sys.stderr):
        return predict_main(argv)


def _net_args(flags):
    return ["--net_args"] + flags if flags else []


def serve(dirs, args, out_dir, name):
    """``desr_tpu_torch.predict.main`` on the test frames: main, ``--SR``
    through ``--export`` then ``--from_export``, ``--I2D`` from the RGB
    alone, ``--translate BtoA`` (G_B: LQ -> HQ)."""
    in_d = dirs["test_in_hr"] if args.stage == "sr" else dirs["test_in"]
    in_i = dirs["test_img_hr"] if args.stage == "sr" else dirs["test_img"]
    run = ["--batch_size", str(args.n_test), "--compute_dtype", args.compute_dtype,
           "--device", args.device]
    ckpt = ["--name", name, "--checkpoints_dir", args.ckpt_dir]
    if args.stage == "i2d":  # predict --I2D takes no --input_depth
        _predict(ckpt + ["--input_img", in_i, "--output", out_dir] + run
                 + ["--I2D"] + _net_args(width_flags(args.width, "i2d")))
        return
    frames = ["--input_depth", in_d, "--input_img", in_i, "--output", out_dir]
    if args.stage == "translation":
        _predict(ckpt + frames + run + ["--translate", "BtoA"])
        return
    if args.stage == "sr":
        # through the exported artifact (desr_tpu_torch/serving.py)
        export_dir = os.path.join(args.root, "export_" + name)
        _predict(ckpt + frames + run + ["--SR", "--export", export_dir]
                 + _net_args(width_flags(args.width)))
        _predict(["--from_export", export_dir] + frames + run)
    else:
        _predict(ckpt + frames + run + _net_args(width_flags(args.width)))


def score(dirs, pred_dir, intr):
    """The nine offline metrics of ``pred_dir`` against the test ground truth."""
    from desr_tpu_torch.metrics import DEFAULT_METRICS, calculate_given_paths

    inp = sorted(glob(os.path.join(dirs["test_in"], "*.png")))
    pred = sorted(glob(os.path.join(pred_dir, "*.png")))
    tgt = sorted(glob(os.path.join(dirs["test_gt"], "*.png")))
    if not (len(inp) == len(pred) == len(tgt) and inp):
        raise ValueError(f"pred/gt mismatch: {len(inp)} inputs, {len(pred)} predictions, "
                         f"{len(tgt)} targets")
    return calculate_given_paths(inp, pred, tgt, list(DEFAULT_METRICS), 5100, n_cpus=1,
                                 intr_root=intr)


def build_parser():
    p = argparse.ArgumentParser(prog="python -m desr_tpu_torch.tools.quality_eval")
    p.add_argument("--root", default=os.path.join(ROOT, "quality_eval_out"),
                   help="folder for the data, checkpoints and outputs")
    p.add_argument("--name", default="qeval")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; without a GPU, cpu must be asked for")
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--width", type=int, default=8,
                   help="one value for every width flag of the trained and guidance nets")
    p.add_argument("--n_train", type=int, default=24)
    p.add_argument("--n_test", type=int, default=8)
    p.add_argument("--hw", type=int, nargs=2, default=(128, 128))
    p.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--stage", default="main", choices=["main", "sr", "i2d", "translation"],
                   help="'sr': the x2 SR fine-tune at the ScanNet geometry (480x640 -> "
                        "960x1280 canvases, HR ground truth), served through predict "
                        "--export/--from_export, with a bicubic baseline; 'i2d': stage 1's "
                        "depth from RGB (480x640), served through predict --I2D, with a "
                        "constant train-mean baseline; 'translation': stage 2's G_B")
    p.add_argument("--crop_size", type=int, default=256,
                   help="translation stage: the train crop (frames are resized to 320x320)")
    p.add_argument("--sr_pre_epochs", type=int, default=0,
                   help="sr stage: epochs of the main-stage pretrain (0: --epochs)")
    p.add_argument("--i2d_train_features", action="store_true",
                   help="i2d stage: also train Image_f")
    p.add_argument("--framework", default="ours", choices=["ours", "reference", "both"],
                   help="'both': train the port and the original PyTorch reference from "
                        "the same init checkpoints on the same data, serve and score both")
    p.add_argument("--reference_root", default=os.environ.get("DESR_REFERENCE_ROOT"),
                   help="the reference checkout, for --framework reference|both "
                        "(default: $DESR_REFERENCE_ROOT)")
    return p


def parse_args(argv=None):
    """The tool's options, with ``ckpt_dir``; exits when the device is absent."""
    from desr_tpu_torch import resolve_device

    parser = build_parser()
    args = parser.parse_args(argv)
    args.ckpt_dir = os.path.join(args.root, "ckpt")
    try:
        resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        parser.error(str(e))
    return args


class _Clock:
    """Wall seconds by phase: data, train, serve, score."""

    def __init__(self):
        self.seconds = {"data": 0.0, "train": 0.0, "serve": 0.0, "score": 0.0}

    @contextlib.contextmanager
    def __call__(self, phase):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[phase] += time.perf_counter() - t0


def run(args):
    """The chain for parsed ``args`` (``parse_args``); prints and returns the
    result. ``args.width = None`` runs the options' default widths."""
    clock = _Clock()
    extra_scores = {}
    with clock("data"):
        if args.stage == "sr":
            dirs, intr = write_dataset_sr(args.root, args.n_train, args.n_test)
            bic = write_bicubic_baseline(dirs, os.path.join(args.root, "bicubic"))
        elif args.stage == "translation":
            dirs, intr = write_dataset_translation(args.root, args.n_train, args.n_test,
                                                   hw=args.hw)
        elif args.stage == "i2d":
            args.hw = (480, 640)  # the I2D dataset's fixed geometry
            dirs, intr = write_dataset(args.root, args.n_train, args.n_test, *args.hw)
            mean_dir = write_mean_baseline(dirs, os.path.join(args.root, "mean"))
        else:
            dirs, intr = write_dataset(args.root, args.n_train, args.n_test, *args.hw)
    with clock("score"):
        if args.stage == "sr":
            extra_scores["baseline_bicubic"] = score(dirs, bic, intr)
        elif args.stage == "i2d":
            extra_scores["baseline_mean"] = score(dirs, mean_dir, intr)
        # the degraded input as the prediction (under sr, the metric's SR rule)
        baseline = score(dirs, dirs["test_in"], intr)

    arms = {"ours": [args.name], "reference": [args.name + "_ref"],
            "both": [args.name, args.name + "_ref"]}[args.framework]
    args._shared_init = args.framework != "ours"
    if args._shared_init and args.stage != "sr":
        with clock("train"):
            make_shared_init(dirs, intr, args, arms)

    # The SR stage fine-tunes trained main-stage weights (README: lr / 10,
    # --continue_train): ONE main-stage pretrain on the same folders, then
    # every arm's SR fine-tune continues from the same handoff checkpoints.
    sr_pretrained = False
    scores = {}
    for arm in arms:
        with clock("train"):
            if args.stage == "sr":
                if not sr_pretrained:
                    pre = copy.copy(args)
                    pre.stage = "main"
                    pre._load_hw = (240, 320)  # random 128x128 crops of 480x640
                    pre._shared_init = False
                    if args.sr_pre_epochs:
                        pre.epochs = args.sr_pre_epochs
                    train(dirs, intr, pre, arms[0])
                    src = os.path.join(args.ckpt_dir, arms[0])
                    for other in arms[1:]:
                        dst = os.path.join(args.ckpt_dir, other)
                        os.makedirs(dst, exist_ok=True)
                        for f in os.listdir(src):
                            if f.startswith("latest_net_"):
                                shutil.copy2(os.path.join(src, f), os.path.join(dst, f))
                    sr_pretrained = True
                ft = copy.copy(args)
                ft.lr = args.lr * 0.1  # the README's main -> SR lr ratio
                ft._continue_latest = True
                ft._shared_init = False
                if arm.endswith("_ref"):
                    train_reference(dirs, intr, ft, arm)
                else:
                    train(dirs, intr, ft, arm)
            elif arm.endswith("_ref"):
                train_reference(dirs, intr, args, arm)
            else:
                train(dirs, intr, args, arm)
        pred_dir = os.path.join(args.root, "pred_" + arm)
        with clock("serve"):
            serve(dirs, args, pred_dir, arm)
        with clock("score"):
            scores["reference" if arm.endswith("_ref") else "trained"] = \
                score(dirs, pred_dir, intr)

    steps = args.epochs * (args.n_train // args.batch_size)
    result = {
        "steps": steps, "epochs": args.epochs, "width": args.width,
        "hw": list(args.hw), "n_train": args.n_train, "n_test": args.n_test,
        "stage": args.stage, "framework": args.framework, "seed": args.seed,
        "shared_init": args._shared_init, "compute_dtype": args.compute_dtype,
        "device": args.device, "seconds": clock.seconds,
        "baseline": baseline, **extra_scores, **scores,
    }
    if "trained" in scores:
        trained = scores["trained"]
        result["improvement"] = {
            k: (1.0 - trained[k] / baseline[k] if baseline.get(k) else None)
            for k in ("rmse", "mae", "rmse_h", "rmse_d", "mse_v")
            if k in trained and k in baseline}
        result["delta_higher_better"] = {
            k: trained[k] - baseline[k] for k in ("psnr", "ssim")
            if k in trained and k in baseline}
    if "trained" in scores and "reference" in scores:
        ref = scores["reference"]
        # the port relative to the reference-trained model, per metric
        result["ours_vs_reference_rel"] = {
            k: (scores["trained"][k] - ref[k]) / abs(ref[k]) for k in ref if ref.get(k)}
    print(json.dumps(result))
    return result


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
