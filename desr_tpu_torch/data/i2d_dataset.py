"""Stage-1 I2D dataset (counterpart of ``desr_tpu/data/i2d_dataset.py``).

Fixed geometry: Resize to 480x640, then train: Rotate(±30°, p 0.85) +
RandomCrop(384, 512) + HFlip, applied jointly to image and depth; test:
PadIfNeeded(512, 640) (i2d_dataset.py:27-44). At train time the uint8 RGB
first gets ColorJitter(0.1, 0.1, 0.1, 0.05), A's then B's, before the
normalisation (:74-76). Emits HWC numpy: A_i/B_i (H, W, 3), A_d/B_d (H, W, 1).
Under ``--device_aug`` an item ships the load-size stacks with the image in
[0, 255], their parameter rows and the jitter rows, and ``device_finish``
jitters and warps the batch where the step runs (i2d_dataset.py:57-79).
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

    def aug_geometry(self):
        return self.LOAD_H, self.LOAD_W, self.CROP_H, self.CROP_W

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
        paths = {"A_paths": str(A_path), "B_paths": str(B_path)}
        if self.device_aug_active():
            # the host path's draws in its order: the jitter's, A's then B's,
            # then the geometry's in prepare_full. A frame whose raw size is
            # not the load size is jittered here, before its resize, and
            # its row disables the card's jitter (enable 0)
            jit_rows, imgs = [], []
            for img in (A_img, B_img):
                b, c, s, h, order = T.draw_jitter_params(rng)
                if img.shape[:2] != (self.LOAD_H, self.LOAD_W):
                    img = T.apply_jitter(img, b, c, s, h, order)
                    row = [1.0, 1.0, 1.0, 0.0, 0, 1, 2, 3, 0.0]
                else:
                    row = [b, c, s, h, *order, 1.0]
                jit_rows.append(np.asarray(row, np.float32))
                imgs.append(img)
            A_full, A_aug = self.prepare_full(rng, A_depth, imgs[0], raw_img=True)
            B_full, B_aug = self.prepare_full(rng, B_depth, imgs[1], raw_img=True)
            return {"A_full": A_full, "A_aug": A_aug, "A_jit": jit_rows[0],
                    "B_full": B_full, "B_aug": B_aug, "B_jit": jit_rows[1], **paths}
        if self.train:
            A_img = T.color_jitter(rng, A_img)
            B_img = T.color_jitter(rng, B_img)
        A_d, A_i = self._transform_pair(rng, A_depth, A_img)
        B_d, B_i = self._transform_pair(rng, B_depth, B_img)
        return {"A_i": A_i, "B_i": B_i, "A_d": A_d, "B_d": B_d, **paths}
