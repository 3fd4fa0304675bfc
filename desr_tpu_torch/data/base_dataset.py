"""Frame loaders and the unpaired folder dataset (counterpart of
``desr_tpu/data/base_dataset.py``), reading through ``data/native_io.py``, with the
host half of ``--device_aug`` (``prepare_full``) and its card half
(``device_finish``, over ``ops/device_aug.py``)."""

from __future__ import annotations

import glob
import os

import numpy as np

from desr_tpu_torch.data import transforms as T
from desr_tpu_torch.data.image_folder import make_dataset
from desr_tpu_torch.data.native_io import read_image


def load_image(path):
    """A frame's pixels with the JAX function's dtypes (base_dataset.py:21-31):
    a PNG decodes as uint16 there, cut to uint8 for colour within 0..255, so
    8-bit grey comes back uint16 and 16-bit colour within 0..255 uint8; a
    JPEG (PIL in both packages) is uint8."""
    arr = read_image(path)
    if not str(path).endswith(".png"):
        return arr
    if arr.dtype == np.uint8:
        return arr if arr.ndim == 3 else arr.astype(np.uint16)
    return arr.astype(np.uint8) if arr.ndim == 3 and arr.max(initial=0) <= 255 else arr


def load_depth_png(path):
    """Depth PNG (mm) -> int32 (H, W) array, the first channel of a colour
    one (base_dataset.py:34-49: the reference's int path)."""
    arr = read_image(path)
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr.astype(np.int32) if str(path).endswith(".png") else arr


def _read_split(split_dir, fname, base_dir):
    """A frozen split list, deduplicated in order, joined onto base_dir; files
    missing on disk are dropped (base_dataset.py:54-74)."""
    seen, names = set(), []
    with open(os.path.join(split_dir, fname)) as f:
        for line in f:
            name = line.strip()
            if name and name not in seen:
                seen.add(name)
                names.append(name)
    paths = [os.path.join(base_dir, n) for n in names]
    existing = [p for p in paths if os.path.exists(p)]
    if len(existing) != len(paths):
        print(f"split {fname}: {len(paths) - len(existing)}/{len(paths)} "
              f"listed files missing under {base_dir}")
    return existing


def draw_geo_params(rng, p_rot, h, w, crop_h, crop_w):
    """The geometric chain's draws, in the order of base_dataset.py:77-89:
    the rotation gate, the angle (only when gated), crop y, crop x, the flip."""
    did_rot = bool(rng.uniform() < p_rot)
    angle = float(rng.uniform(-30, 30)) if did_rot else 0.0
    y, x = T.random_crop_params(rng, h, w, crop_h, crop_w)
    flip = bool(rng.uniform() < 0.5)
    return did_rot, angle, y, x, flip


def augment_pair(rng, p_rot, depth, img, crop_h, crop_w):
    """Rotate (with probability ``p_rot``), crop and flip a normalised
    depth/image pair jointly, on one draw of ``draw_geo_params``
    (main_dataset.py:39-49, i2d_dataset.py:32-41). Not clipped: the caller
    clips after the crop and the flip."""
    h, w = img.shape[:2]
    did_rot, angle, y, x, flip = draw_geo_params(rng, p_rot, h, w, crop_h, crop_w)
    if did_rot:  # one warp of both: the same taps and weights for every channel
        both = T.rotate(np.concatenate([img, depth[..., None]], axis=-1), angle)
        img, depth = both[..., :-1], both[..., -1]
    img, depth = T.crop(img, y, x, crop_h, crop_w), T.crop(depth, y, x, crop_h, crop_w)
    if flip:
        img, depth = T.hflip(img), T.hflip(depth)
    return depth, img


def normalize_pair(depth, img):
    """Image + depth normalisation (my_main_dataset.py:32-52)."""
    return T.normalize_depth_np(np.asarray(depth)), T.normalize_image_np(np.asarray(img))



def _worker_number():
    """1 + the DataLoader worker's id in a worker process, 0 inline."""
    from torch.utils.data import get_worker_info

    info = get_worker_info()
    return 0 if info is None else info.id + 1

class UnpairedFolderDataset:
    """Unpaired sampling (base_dataset.py:92-241): B sequential
    (index % B_size), A uniform random from the item's own generator."""

    def __init__(self, opt, stage="train"):
        self.opt = opt
        self.stage = stage
        self.train = stage != "test"
        self._draws = 0
        self.seed = getattr(opt, "seed", 0)

        dir_A = opt.path_A if self.train else opt.path_A_test
        dir_B = opt.path_B if self.train else opt.path_B_test
        dir_A_add = opt.A_add_paths if self.train else opt.A_add_paths_test
        dir_B_add = opt.B_add_paths if self.train else opt.B_add_paths_test

        if getattr(opt, "split_files", ""):
            phase = "train" if self.train else "test"
            self.A_paths = _read_split(opt.split_files, f"{phase}A_d.txt", dir_A)
            self.B_paths = _read_split(opt.split_files, f"{phase}B_d.txt", dir_B)
            if opt.image_and_depth:
                self.A_add_paths = _read_split(opt.split_files, f"{phase}A_i.txt", dir_A_add)
                self.B_add_paths = _read_split(opt.split_files, f"{phase}B_i.txt", dir_B_add)
            if getattr(opt, "take", 0) > 0:
                self._take(opt.take)
        elif getattr(opt, "take", 0) > 0:
            self.A_paths = sorted(glob.glob(dir_A + "/*"))
            self.B_paths = sorted(glob.glob(dir_B + "/*"))
            if opt.image_and_depth:
                self.A_add_paths = sorted(glob.glob(dir_A_add + "/*"))
                self.B_add_paths = sorted(glob.glob(dir_B_add + "/*"))
            self._take(opt.take)
        else:
            self.A_paths = sorted(make_dataset(dir_A, opt.max_dataset_size))
            self.B_paths = sorted(glob.glob(f"{dir_B}/*"))
            if opt.image_and_depth:
                self.A_add_paths = sorted(make_dataset(dir_A_add, opt.max_dataset_size))
                self.B_add_paths = sorted(glob.glob(f"{dir_B_add}/*"))
        self.A_size = len(self.A_paths)
        self.B_size = len(self.B_paths)
        self._K_cache = {}

    def _take(self, take):
        """--take: a seed-23 random subset, A and B alike (my_main_dataset.py:118-133)."""
        np.random.seed(23)
        idx_A = np.random.randint(0, len(self.A_paths) - 1, take)
        idx_B = np.random.randint(0, len(self.B_paths) - 1, take)
        self.A_paths = list(np.array(self.A_paths)[idx_A])
        self.B_paths = list(np.array(self.B_paths)[idx_B])
        if self.opt.image_and_depth:
            self.A_add_paths = list(np.array(self.A_add_paths)[idx_A])
            self.B_add_paths = list(np.array(self.B_add_paths)[idx_B])

    shared_draws = False  # set by the loader on a spatial mesh

    def item_rng(self, index):
        # the process id and a per-dataset draw counter in the entropy, as
        # the JAX package: forked loader workers would otherwise replay the
        # same draws. The S ranks of a spatial data group decode the same
        # items and must draw alike (``shared_draws``): there the loader
        # worker's number stands in for the process id, as each rank's
        # worker k decodes the same batches in the same order
        self._draws += 1
        stream = _worker_number() if self.shared_draws else os.getpid()
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, index, self._draws - 1, stream]))

    def pick_indices(self, index, rng):
        return int(rng.integers(0, self.A_size)), index % self.B_size

    def load_depth(self, path, domain):
        if str(path).endswith(".npy"):
            return np.load(path).astype(np.float32)
        if domain == "B" and not self.opt.use_scannet and not str(path).endswith(".png"):
            return np.load(path).astype(np.float32)
        return load_depth_png(path)

    def get_intrinsics(self, f_path):
        """Per-scene 3x3 K from <path_to_intr>/<scene>/intrinsic/intrinsic_depth.txt,
        the scene being the first 12 characters of the file name; cached."""
        scene = os.path.basename(str(f_path)).split(".")[0][:12]
        if scene not in self._K_cache:
            p = os.path.join(self.opt.path_to_intr, scene, "intrinsic", "intrinsic_depth.txt")
            self._K_cache[scene] = np.loadtxt(p)[:3, :3]
        return self._K_cache[scene]

    def interiornet_K(self):
        return np.asarray([[600.0, 0, 320], [0, 600, 240], [0, 0, 1]])

    # -- --device_aug (base_dataset.py:182-238) --------------------------------

    def device_aug_active(self):
        """Whether items ship the device half; subclasses narrow it."""
        return self.train and getattr(self.opt, "device_aug", False)

    def aug_geometry(self):
        """(load_h, load_w, crop_h, crop_w) of the geometric chain."""
        opt = self.opt
        return opt.load_size_h, opt.load_size_w, opt.crop_size_h, opt.crop_size_w

    def prepare_full(self, rng, depth, img, raw_img=False):
        """The host half of ``--device_aug``: normalise and resize to the load
        size, draw the host path's geometric parameters from ``rng``, and
        return the (H, W, 4) image + depth stack, unclipped (the warp clips
        after the crop, as the host path does), with its [angle, cy, cx,
        flip] row. ``raw_img`` keeps the image in [0, 255] for the card's
        ColorJitter (I2D)."""
        lh, lw, ch, cw = self.aug_geometry()
        if raw_img:
            depth, img = T.normalize_depth_np(np.asarray(depth)), np.asarray(img, np.float32)
        else:
            depth, img = normalize_pair(depth, img)
        img, depth = T.resize(img, lh, lw), T.resize(depth, lh, lw)
        _, angle, y, x, flip = draw_geo_params(rng, self.P_ROT, lh, lw, ch, cw)
        full = np.concatenate([img, depth[..., None]], axis=-1).astype(np.float32)
        return full, np.array([angle, y, x, float(flip)], np.float32)

    def device_finish(self, batch, device):
        """The card's half of a ``--device_aug`` batch: ``batch`` is the
        collated host batch (pinned on a CUDA run); its tensors go to
        ``device`` without blocking, and one warp per domain (with
        ColorJitter when the batch has ``A_jit``, its rounds sized from the
        host's rows) replaces ``A_full``, ``A_aug`` (and ``A_jit``) and B's
        by the model's input keys at crop size."""
        from desr_tpu_torch.data.loader import to_device
        from desr_tpu_torch.ops.device_aug import augment_stack, jitter_round_sizes, model_inputs

        out = to_device(batch, device)
        _, _, ch, cw = self.aug_geometry()
        stacks = []
        for d in "AB":
            jit = out.pop(f"{d}_jit", None)
            sizes = None if jit is None else jitter_round_sizes(batch[f"{d}_jit"][:, 4:8])
            stacks.append(augment_stack(out.pop(f"{d}_full"), out.pop(f"{d}_aug"), ch, cw,
                                        jit, sizes))
        out.update(model_inputs(*stacks))
        return out

    def __len__(self):
        return min(self.A_size, self.B_size)
