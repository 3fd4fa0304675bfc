"""Stage-1 I2D dataset (counterpart of ``desr_tpu/data/i2d_dataset.py``).

Fixed geometry: Resize to 480x640, then train: Rotate(±30°, p 0.85) +
RandomCrop(384, 512) + HFlip, applied jointly to image and depth; test:
PadIfNeeded(512, 640) (i2d_dataset.py:27-44). At train time the uint8 RGB
first gets ColorJitter(0.1, 0.1, 0.1, 0.05), A's then B's, before the
normalisation (:74-76). The host path only: ``--device_aug`` is refused by
the options. Emits HWC numpy: A_i/B_i (H, W, 3), A_d/B_d (H, W, 1).
"""

from __future__ import annotations

import numpy as np

from desr_tpu_torch.data import transforms as T
from desr_tpu_torch.data.base_dataset import (UnpairedFolderDataset, augment_pair, load_image,
                                              normalize_pair)


class I2DDataset(UnpairedFolderDataset):
    LOAD_H, LOAD_W = 480, 640
    CROP_H, CROP_W = 384, 512
    P_ROT = 0.85  # my_I2D_dataset.py:91

    def _transform_pair(self, rng, depth, img):
        depth, img = normalize_pair(depth, img)
        img = T.resize(img, self.LOAD_H, self.LOAD_W, 3)
        depth = T.resize(depth, self.LOAD_H, self.LOAD_W, 3)
        if self.train:
            depth, img = augment_pair(rng, self.P_ROT, depth, img, self.CROP_H, self.CROP_W)
        else:
            img = T.pad_if_needed(img, 512, 640)
            depth = T.pad_if_needed(depth, 512, 640)
        img = np.clip(img, -1, 1).astype(np.float32)
        depth = np.clip(depth, -1, 1).astype(np.float32)
        return depth[..., None], img

    def __getitem__(self, index):
        rng = self.item_rng(index)
        index_A, index_B = self.pick_indices(index, rng)
        A_path, B_path = self.A_paths[index_A], self.B_paths[index_B]
        A_depth = self.load_depth(A_path, "A")
        B_depth = self.load_depth(B_path, "B")
        A_img = load_image(self.A_add_paths[index_A])[..., :3]
        B_img = load_image(self.B_add_paths[index_B])[..., :3]
        if self.train:
            A_img = T.color_jitter(rng, A_img)
            B_img = T.color_jitter(rng, B_img)
        A_d, A_i = self._transform_pair(rng, A_depth, A_img)
        B_d, B_i = self._transform_pair(rng, B_depth, B_img)
        return {"A_i": A_i, "B_i": B_i, "A_d": A_d, "B_d": B_d,
                "A_paths": str(A_path), "B_paths": str(B_path)}
