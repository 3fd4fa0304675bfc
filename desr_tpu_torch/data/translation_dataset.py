"""Stage-2 translation dataset (counterpart of ``desr_tpu/data/translation_dataset.py``).

Layout ``<dataroot>/<phase>{A,B}/{img,depth}``, the image and depth lists of a
domain paired by sorted order and by name (:40-52, :113-116). Item ``index``
takes B's frame ``index`` and, when |A| != |B|, A's next index from a queue
refilled with an epoch's permutation of A (:65-67, :107-112), else A's frame
``index``. Each item draws from its own generator,
``SeedSequence([seed, index, draw])`` with a per-dataset draw counter. Per
domain (:82-93): uint8 RGB (RGBA cut to RGB) and uint16 depth normalised to
[-1, 1] (depth clipped at --max_distance), Lanczos-resized to 320x320, then at
train time a random crop of --crop_size_h x --crop_size_w and a horizontal
flip, drawn for A and then for B. An item with a non-finite or constant map is
drawn again at a random index, at most 8 times (:124-125). Emits A_depth /
B_depth (H, W, 1) and A_img / B_img (H, W, 3) float32, and the frame names.

Frames are read as imageio reads them (``data/native_io.py:read_image``):
PNG and JPEG colour frames, 16-bit PNG depth maps.
"""

from __future__ import annotations

import glob
import itertools
import os
import queue

import numpy as np

from desr_tpu_torch.data import transforms as T
from desr_tpu_torch.data.native_io import read_image

LOAD_HW = 320  # Resize(320, 320) (translation_dataset.py:84)


class TranslationDataset:
    IMG_EXTENSIONS = (".png", ".jpg")

    def __init__(self, opt, stage="train"):
        self.opt = opt
        train = stage != "test"
        self.is_train = getattr(opt, "isTrain", True)  # the resample runs in the test pass too
        self.crop = self.is_train and train
        self.scale = opt.max_distance / 2
        self.seed = getattr(opt, "seed", 0)
        self._draw = itertools.count()
        phase = getattr(opt, "phase", "train") if train else "test"
        self.A_imgs, self.A_depths = self._domain(os.path.join(opt.dataroot, phase + "A"))
        self.B_imgs, self.B_depths = self._domain(os.path.join(opt.dataroot, phase + "B"))
        self.A_size, self.B_size = len(self.A_imgs), len(self.B_imgs)
        self.queue_A_index = queue.Queue()

    def _domain(self, root):
        imgs = self._paths(os.path.join(root, "img"))
        depths = self._paths(os.path.join(root, "depth"))
        if len(imgs) != len(depths):
            raise ValueError(f"not pair img depth: {len(imgs)} images, {len(depths)} depths "
                             f"under {root}")
        for f in imgs + depths:
            if not f.endswith(self.IMG_EXTENSIONS):
                raise ValueError(f"not implemented file extension type {f}")
        return imgs, depths

    def _paths(self, d):
        if not os.path.isdir(d):
            raise NotADirectoryError(f"{d} is not a valid directory")
        files = sorted(glob.glob(os.path.join(d, "**/*.*"), recursive=True))
        return files[: min(self.opt.max_dataset_size, len(files))]

    def normalize_img(self, img):
        if img.dtype != np.uint8:
            raise ValueError(f"Img datatype: {img.dtype}, want uint8")
        if img.ndim == 3 and img.shape[2] > 3:
            img = img[:, :, :3]
        return img.astype(np.float32) / 127.5 - 1.0

    def normalize_depth(self, depth):
        if depth.dtype != np.uint16:
            raise ValueError(f"Depth datatype: {depth.dtype}, want uint16")
        if depth.ndim == 3:
            depth = depth[..., 0]
        d = depth.astype(np.float32)
        d = np.where(d > self.opt.max_distance, self.opt.max_distance, d)
        return d / self.scale - 1.0

    def _transform(self, rng, depth, img):
        img = T.resize(self.normalize_img(img), LOAD_HW, LOAD_HW, T.INTER_LANCZOS4)
        depth = T.resize(self.normalize_depth(depth), LOAD_HW, LOAD_HW, T.INTER_LANCZOS4)
        if self.crop:
            ch, cw = self.opt.crop_size_h, self.opt.crop_size_w
            y, x = T.random_crop_params(rng, LOAD_HW, LOAD_HW, ch, cw)
            img, depth = T.crop(img, y, x, ch, cw), T.crop(depth, y, x, ch, cw)
            if rng.uniform() < 0.5:
                img, depth = T.hflip(img), T.hflip(depth)
        return depth[..., None].astype(np.float32), img.astype(np.float32)

    @staticmethod
    def _bad(*maps):
        return any(not np.isfinite(m).all() or np.unique(m).shape[0] < 2 for m in maps)

    def __getitem__(self, index, _depth_guard=0):
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, index, next(self._draw)]))
        if self.A_size != self.B_size:
            if self.queue_A_index.empty():
                for i in rng.permutation(self.A_size):
                    self.queue_A_index.put(int(i))
            index_A = self.queue_A_index.get()
        else:
            index_A = index
        A_img_p, A_depth_p = self.A_imgs[index_A], self.A_depths[index_A]
        B_img_p, B_depth_p = self.B_imgs[index], self.B_depths[index]

        def name(p):
            return os.path.basename(p).split(".")[0]

        for img_p, depth_p in ((A_img_p, A_depth_p), (B_img_p, B_depth_p)):
            if name(img_p) != name(depth_p):
                raise ValueError(f"not pair img depth: {img_p}, {depth_p}")
        A_depth, A_img = self._transform(rng, read_image(A_depth_p), read_image(A_img_p))
        B_depth, B_img = self._transform(rng, read_image(B_depth_p), read_image(B_img_p))
        if self.is_train and _depth_guard < 8 and self._bad(A_depth, A_img, B_depth, B_img):
            return self.__getitem__(int(rng.integers(0, self.B_size)), _depth_guard + 1)
        return {"A_depth": A_depth, "A_img": A_img, "A_name": name(A_img_p),
                "B_depth": B_depth, "B_img": B_img, "B_name": name(B_img_p)}

    def __len__(self):
        return self.B_size
