"""Naive x2 SR dataset (counterpart of ``desr_tpu/data/sr_dataset.py``).

Each frame: Resize(960, 1280, INTER_AREA), centred PadIfNeeded(1024, 1280)
(reflect-101), then at train time one random crop of (2·crop_h, 2·crop_w)
drawn by ``_draw_crop``; at test time the whole canvas (sr_dataset.py:34-50).
A_d/B_d are the HR crops: the model makes its LR views itself. K_A is scaled
element-wise by ``SCALE_K`` (sr_dataset.py:19,85), and the crop boxes carry
the random offsets (train) or the fixed test canvases (:87-94). The host
path only: ``--device_aug`` is refused by the options.
"""

from __future__ import annotations

import numpy as np

from desr_tpu_torch.data import transforms as T
from desr_tpu_torch.data.base_dataset import UnpairedFolderDataset, load_image, normalize_pair

SCALE_K = np.array([[2.0, 1.0, 2.0], [1.0, 2.0, 2.0], [1.0, 1.0, 1.0]])


class NaiveSRDataset(UnpairedFolderDataset):
    LOAD_H, LOAD_W = 960, 1280
    PAD_H, PAD_W = 1024, 1280

    def _draw_crop(self, rng):
        """The one draw of the SR transform: the HR crop's top-left corner."""
        ch, cw = self.opt.crop_size_h * 2, self.opt.crop_size_w * 2
        h = int(rng.integers(0, self.PAD_H - ch + 1))
        w = int(rng.integers(0, self.PAD_W - cw + 1))
        return h, w

    def _transform_pair(self, rng, depth, img):
        depth, img = normalize_pair(depth, img)
        img = T.pad_if_needed(T.resize(img, self.LOAD_H, self.LOAD_W), self.PAD_H, self.PAD_W)
        depth = T.pad_if_needed(T.resize(depth, self.LOAD_H, self.LOAD_W),
                                self.PAD_H, self.PAD_W)
        ch, cw = self.opt.crop_size_h * 2, self.opt.crop_size_w * 2
        h = w = 0
        if self.train:
            h, w = self._draw_crop(rng)
            depth = depth[h:h + ch, w:w + cw]
            img = img[h:h + ch, w:w + cw]
        img = np.clip(img, -1, 1).astype(np.float32)
        depth = np.clip(depth, -1, 1).astype(np.float32)
        return depth[..., None], img, h, w

    def __getitem__(self, index):
        opt = self.opt
        rng = self.item_rng(index)
        index_A, index_B = self.pick_indices(index, rng)
        A_path, B_path = self.A_paths[index_A], self.B_paths[index_B]
        A_depth = self.load_depth(A_path, "A")
        B_depth = self.load_depth(B_path, "B")
        A_img = load_image(self.A_add_paths[index_A])[..., :3].astype(np.float32)
        B_img = load_image(self.B_add_paths[index_B])[..., :3].astype(np.float32)
        A_d, A_i, h_a, w_a = self._transform_pair(rng, A_depth, A_img)
        B_d, B_i, h_b, w_b = self._transform_pair(rng, B_depth, B_img)
        K_B = self.get_intrinsics(B_path)
        K_A = self.interiornet_K() if opt.interiornet else self.get_intrinsics(A_path)
        K_A = K_A * SCALE_K
        if self.train:
            crop_A = np.array([h_a, opt.crop_size_h * 2 + h_a, w_a, opt.crop_size_w * 2 + w_a],
                              np.float32)
            crop_B = np.array([h_b, opt.crop_size_h + h_b, w_b, opt.crop_size_w + w_b],
                              np.float32)
        else:
            crop_A = np.array([0, 1024, 0, 1280], np.float32)
            crop_B = np.array([0, 512, 0, 640], np.float32)
        return {"A_i": A_i, "B_i": B_i, "A_d": A_d, "B_d": B_d,
                "A_paths": str(A_path), "B_paths": str(B_path),
                "K_A": K_A.astype(np.float32), "K_B": K_B.astype(np.float32),
                "crop_A": crop_A, "crop_B": crop_B}
