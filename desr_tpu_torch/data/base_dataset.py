"""Frame loaders and the unpaired folder dataset (counterpart of
``desr_tpu/data/base_dataset.py``), on the package's own PNG codec."""

from __future__ import annotations

import glob
import os

import numpy as np

from desr_tpu_torch.data import transforms as T
from desr_tpu_torch.data.image_folder import make_dataset
from desr_tpu_torch.data.png import read_png


def load_image(path):
    """RGB(A) PNG -> uint8 (H, W, C) array."""
    return read_png(path)


def load_depth_png(path):
    """uint16 depth PNG (mm) -> int32 (H, W) array (the reference's int path)."""
    arr = read_png(path)
    if arr.ndim == 3:
        arr = arr[..., 0]
    if arr.dtype == np.uint16:
        arr = arr.astype(np.int32)
    return arr


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

    def item_rng(self, index):
        # the process id and a per-dataset draw counter in the entropy, as
        # the JAX package: forked loader workers would otherwise replay the
        # same draws
        self._draws += 1
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, index, self._draws - 1, os.getpid()]))

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

    def __len__(self):
        return min(self.A_size, self.B_size)
