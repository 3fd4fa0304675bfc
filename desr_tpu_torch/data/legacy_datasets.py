"""The reference's older CycleGAN dataset classes (counterpart of
``desr_tpu/data/legacy_datasets.py``): ``UnalignedDataset``,
``AlignedDataset``, ``SingleDataset`` and ``TemplateDataset``, which
``--dataset_mode unaligned|aligned|single|template`` names. No training stage
reads them; they stay resolvable and working on plain image folders, with
the upstream transform flags:

- ``--preprocess {resize_and_crop,crop,scale_width,scale_width_and_crop,
  none}`` drives the geometry as the reference's ``get_transform``
  (data/base_dataset.py:83-116): resizes are cv2's INTER_CUBIC
  (``data/transforms.py``, ``ops/resize.py:resize_cv2_cubic_np``), 'none'
  rounds H and W to multiples of 4, 'scale_width' keeps H >= crop_size;
  aligned A/B share one crop/flip draw while unaligned draws per image.
- ``--custom_pathes`` swaps <dataroot>/<phase>{A,B} for --path_A/--path_B.
- ``--take N`` subsamples both folders with the reference's seed-23
  ``RandomState.randint(0, len - 1, N)`` draw, A's indices first.
- ``--uint16`` loads raw 16-bit values, applies the geometry, then clamps at
  8000, divides by 8000 and normalises to [-1, 1] as one channel.
- ``--image_and_depth`` pairs each depth frame with an RGB frame from
  --A_add_paths/--B_add_paths: a 50% paired flip, bicubic to 256x256 and a
  4-channel image + depth concat.

Each item draws from numpy's ``default_rng(SeedSequence([seed, index]))``, as
the JAX classes do, so items compare value for value. All return HWC float32
arrays in [-1, 1] under keys A/B (+ paths), channels last.
"""

from __future__ import annotations

import os

import numpy as np

from desr_tpu_torch.data import transforms as T
from desr_tpu_torch.data.base_dataset import load_image
from desr_tpu_torch.data.image_folder import make_dataset

_GRAY = np.array([0.299, 0.587, 0.114], np.float32)  # PIL convert('L') weights


def _as_rgb(img):
    img = np.asarray(img).astype(np.float32)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img[..., :3]


def _get_params(rng, opt, hw):
    """One shared crop-position/flip draw (reference data/base_dataset.py:64-80).

    The reference's random.randint is INCLUSIVE of the high bound."""
    h, w = hw
    new_h, new_w = h, w
    if opt.preprocess == "resize_and_crop":
        new_h = new_w = opt.load_size
    elif opt.preprocess == "scale_width_and_crop":
        new_w = opt.load_size
        new_h = opt.load_size * h // w
    x = int(rng.integers(0, max(0, new_w - opt.crop_size) + 1))
    y = int(rng.integers(0, max(0, new_h - opt.crop_size) + 1))
    return {"crop_pos": (x, y), "flip": bool(rng.uniform() > 0.5)}


def _legacy_transform(rng, img, opt, params=None):
    """Geometry half of the reference's get_transform
    (data/base_dataset.py:83-116), on an HWC float array. ``params=None``
    draws crop/flip per call (torchvision RandomCrop/RandomHorizontalFlip);
    a params dict replays a shared draw (the aligned A/B contract)."""
    pre = opt.preprocess
    if "resize" in pre:
        img = T.resize(img, opt.load_size, opt.load_size, T.INTER_CUBIC)
    elif "scale_width" in pre:
        h, w = img.shape[:2]
        # __scale_width (data/base_dataset.py:130-136): no-op only when the
        # width already matches AND the height still covers the crop
        if not (w == opt.load_size and h >= opt.crop_size):
            img = T.resize(img, int(max(opt.load_size * h / w, opt.crop_size)),
                           opt.load_size, T.INTER_CUBIC)
    if "crop" in pre:
        cs = opt.crop_size
        if params is None:
            y, x = T.random_crop_params(rng, img.shape[0], img.shape[1], cs, cs)
        else:
            x, y = params["crop_pos"]
        img = T.crop(img, y, x, cs, cs)
    if pre == "none":
        # __make_power_2 base 4 (data/base_dataset.py:119-127)
        h, w = img.shape[:2]
        nh, nw = int(round(h / 4) * 4), int(round(w / 4) * 4)
        if (nh, nw) != (h, w):
            img = T.resize(img, nh, nw, T.INTER_CUBIC)
    if not opt.no_flip:
        flip = params["flip"] if params is not None else bool(rng.uniform() > 0.5)
        if flip:
            img = T.hflip(img)
    return img


def _finish_rgb(img, grayscale=False):
    """ToTensor + Normalize(0.5) tail (data/base_dataset.py:108-116), HWC."""
    if grayscale:
        img = (img @ _GRAY)[..., None]
    return np.clip((img - 127.5) / 127.5, -1, 1).astype(np.float32)


def _finish_uint16(raw):
    """clamp-8000 / 8000 / Normalize((0.5,), (0.5,)) single-channel tail
    (unaligned_dataset.py:104-116). Bicubic undershoot is clipped at 0 —
    PIL's integer modes clamp on resize, cv2's float path doesn't."""
    d = np.clip(np.asarray(raw, np.float32), 0.0, 8000.0) / 8000.0
    if d.ndim == 3:
        d = d[..., 0]
    return ((d - 0.5) / 0.5)[..., None].astype(np.float32)


def _take_subsample(opt, A, B):
    """Seed-23 joint subsample (unaligned_dataset.py:46-53): A's indices are
    drawn before B's from one freshly-seeded legacy MT19937 stream; the high
    bound len-1 is EXCLUSIVE, so the last file is never sampled."""
    rs = np.random.RandomState(23)
    idx_A = rs.randint(0, len(A) - 1, opt.take)
    idx_B = rs.randint(0, len(B) - 1, opt.take)
    return ([A[i] for i in idx_A], [B[i] for i in idx_B]), (idx_A, idx_B)


class UnalignedDataset:
    """Two unpaired folders <dataroot>/<phase>{A,B} (unaligned_dataset.py)."""

    @staticmethod
    def modify_commandline_options(parser, is_train):
        return parser

    def __init__(self, opt, stage="train"):
        self.opt = opt
        phase = getattr(opt, "phase", "train") if stage != "test" else "test"
        dir_A = os.path.join(opt.dataroot, phase + "A")
        dir_B = os.path.join(opt.dataroot, phase + "B")
        if getattr(opt, "custom_pathes", False):  # unaligned_dataset.py:36-38
            dir_A, dir_B = opt.path_A, opt.path_B
        A = sorted(make_dataset(dir_A, opt.max_dataset_size))
        B = sorted(make_dataset(dir_B, opt.max_dataset_size))
        self.paired = getattr(opt, "image_and_depth", False)
        if self.paired:  # unaligned_dataset.py:41-43,60-62
            A_add = sorted(make_dataset(opt.A_add_paths, opt.max_dataset_size))
            B_add = sorted(make_dataset(opt.B_add_paths, opt.max_dataset_size))
        if getattr(opt, "take", 0) > 0:
            (A, B), (idx_A, idx_B) = _take_subsample(opt, A, B)
            if self.paired:
                A_add = [A_add[i] for i in idx_A]
                B_add = [B_add[i] for i in idx_B]
        self.A_paths, self.B_paths = A, B
        if self.paired:
            self.A_add_paths, self.B_add_paths = A_add, B_add
        self.A_size, self.B_size = len(self.A_paths), len(self.B_paths)
        self.serial = getattr(opt, "serial_batches", False)
        self.seed = getattr(opt, "seed", 0)

    def _paired_item(self, rng, depth_path, img_path):
        """image_and_depth branch (unaligned_dataset.py:117-158): paired 50%
        hflip -> bicubic 256x256 -> [img 3ch | depth 1ch] concat."""
        img = _as_rgb(load_image(img_path))
        depth = np.asarray(load_image(depth_path), np.float32)
        if rng.uniform() > 0.5:  # paired_transform, unaligned_dataset.py:174-177
            img, depth = T.hflip(img), T.hflip(depth)
        img = T.resize(img, 256, 256, T.INTER_CUBIC)
        depth = T.resize(depth, 256, 256, T.INTER_CUBIC)
        return np.concatenate([_finish_rgb(img), _finish_uint16(depth)], -1)

    def __getitem__(self, index):
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, index]))
        A_path = self.A_paths[index % self.A_size]
        index_B = index % self.B_size if self.serial else int(rng.integers(0, self.B_size))
        B_path = self.B_paths[index_B]
        if self.paired:  # overrides the plain branches, as in the reference
            A = self._paired_item(rng, A_path, self.A_add_paths[index % self.A_size])
            B = self._paired_item(rng, B_path, self.B_add_paths[index_B])
        elif getattr(self.opt, "uint16", False):  # unaligned_dataset.py:96-116
            A = _finish_uint16(_legacy_transform(
                rng, np.asarray(load_image(A_path), np.float32), self.opt))
            B = _finish_uint16(_legacy_transform(
                rng, np.asarray(load_image(B_path), np.float32), self.opt))
        else:
            A = _finish_rgb(_legacy_transform(rng, _as_rgb(load_image(A_path)), self.opt))
            B = _finish_rgb(_legacy_transform(rng, _as_rgb(load_image(B_path)), self.opt))
        return {"A": A, "B": B, "A_paths": str(A_path), "B_paths": str(B_path)}

    def __len__(self):
        return max(self.A_size, self.B_size)


class AlignedDataset:
    """Side-by-side AB images under <dataroot>/<phase> (aligned_dataset.py)."""

    @staticmethod
    def modify_commandline_options(parser, is_train):
        return parser

    def __init__(self, opt, stage="train"):
        self.opt = opt
        if opt.load_size < opt.crop_size:
            raise ValueError("load_size must cover crop_size (aligned_dataset.py:23)")
        phase = getattr(opt, "phase", "train") if stage != "test" else "test"
        self.AB_paths = sorted(make_dataset(os.path.join(opt.dataroot, phase),
                                            opt.max_dataset_size))

    def __getitem__(self, index):
        rng = np.random.default_rng(np.random.SeedSequence([self.opt.seed, index]))
        path = self.AB_paths[index]
        ab = _as_rgb(load_image(path))
        w = ab.shape[1] // 2
        A, B = ab[:, :w], ab[:, w:]
        # ONE params draw shared by both halves (aligned_dataset.py:49-54)
        params = _get_params(rng, self.opt, A.shape[:2])
        btoA = getattr(self.opt, "direction", "AtoB") == "BtoA"
        in_gray = (self.opt.output_nc if btoA else self.opt.input_nc) == 1
        out_gray = (self.opt.input_nc if btoA else self.opt.output_nc) == 1
        A = _finish_rgb(_legacy_transform(rng, A, self.opt, params), in_gray)
        B = _finish_rgb(_legacy_transform(rng, B, self.opt, params), out_gray)
        return {"A": A, "B": B, "A_paths": str(path), "B_paths": str(path)}

    def __len__(self):
        return len(self.AB_paths)


class SingleDataset:
    """One folder of images, A-only (single_dataset.py)."""

    @staticmethod
    def modify_commandline_options(parser, is_train):
        return parser

    def __init__(self, opt, stage="train"):
        self.opt = opt
        self.A_paths = sorted(make_dataset(opt.dataroot, opt.max_dataset_size))

    def __getitem__(self, index):
        rng = np.random.default_rng(np.random.SeedSequence([self.opt.seed, index]))
        path = self.A_paths[index]
        btoA = getattr(self.opt, "direction", "AtoB") == "BtoA"
        gray = (self.opt.output_nc if btoA else self.opt.input_nc) == 1
        A = _finish_rgb(_legacy_transform(rng, _as_rgb(load_image(path)), self.opt), gray)
        return {"A": A, "A_paths": str(path)}

    def __len__(self):
        return len(self.A_paths)


class TemplateDataset:
    """Minimal example dataset showing the registry contract
    (reference data/template_dataset.py): a ``modify_commandline_options``
    hook adding a flag, paired A/B from one folder, fixed-size output."""

    @staticmethod
    def modify_commandline_options(parser, is_train):
        parser.add_argument("--new_dataset_option", type=float, default=1.0,
                            help="template example option")
        return parser

    def __init__(self, opt, stage="train"):
        self.opt = opt
        self.paths = sorted(make_dataset(opt.dataroot, opt.max_dataset_size))

    def __getitem__(self, index):
        path = self.paths[index]
        img = _as_rgb(load_image(path))
        img = T.resize(img, self.opt.load_size, self.opt.load_size, T.INTER_CUBIC)
        img = _finish_rgb(img)
        return {"data_A": img, "data_B": img, "path": str(path)}

    def __len__(self):
        return len(self.paths)
