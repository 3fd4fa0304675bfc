"""Stage-3 main dataset (counterpart of ``desr_tpu/data/main_dataset.py``).

Geometry: Resize to load_size (INTER_AREA), then train: Rotate(±30°,
p 0.9) + RandomCrop(crop_size_h, crop_size_w) + HFlip, or with ``--no_aug``
PadIfNeeded(512, 640) + HFlip with p 0.5; test: PadIfNeeded(512, 640)
(main_dataset.py:28-55). Emits per-sample intrinsics K_A/K_B and the crop
boxes the K-based normals read. The host path only: ``--device_aug`` is
refused by the options.
"""

from __future__ import annotations

import numpy as np

from desr_tpu_torch.data import transforms as T
from desr_tpu_torch.data.base_dataset import (UnpairedFolderDataset, augment_pair, load_image,
                                              normalize_pair)


class MainDataset(UnpairedFolderDataset):
    P_ROT = 0.9  # my_main_dataset.py:66

    @property
    def augments(self):
        return self.train and not self.opt.no_aug

    def _transform_pair(self, rng, depth, img):
        opt = self.opt
        depth, img = normalize_pair(depth, img)
        img = T.resize(img, opt.load_size_h, opt.load_size_w, 3)
        depth = T.resize(depth, opt.load_size_h, opt.load_size_w, 3)
        if self.augments:
            depth, img = augment_pair(rng, self.P_ROT, depth, img,
                                      opt.crop_size_h, opt.crop_size_w)
        else:
            img = T.pad_if_needed(img, 512, 640)
            depth = T.pad_if_needed(depth, 512, 640)
            if self.train and rng.uniform() < 0.5:
                img, depth = T.hflip(img), T.hflip(depth)
        img = np.clip(img, -1, 1).astype(np.float32)
        depth = np.clip(depth, -1, 1).astype(np.float32)
        return depth[..., None], img

    def crop_boxes(self):
        """The normals' crop boxes (main_dataset.py:57-63)."""
        if self.augments:
            box = np.array([0, self.opt.crop_size_h, 0, self.opt.crop_size_w], np.float32)
        else:
            box = np.array([0, 512, 0, 640], np.float32)
        return box.copy(), box.copy()

    def __getitem__(self, index):
        rng = self.item_rng(index)
        index_A, index_B = self.pick_indices(index, rng)
        A_path, B_path = self.A_paths[index_A], self.B_paths[index_B]
        A_depth = self.load_depth(A_path, "A")
        B_depth = self.load_depth(B_path, "B")
        A_img = load_image(self.A_add_paths[index_A])[..., :3].astype(np.float32)
        B_img = load_image(self.B_add_paths[index_B])[..., :3].astype(np.float32)
        K_B = self.get_intrinsics(B_path)
        K_A = self.interiornet_K() if self.opt.interiornet else self.get_intrinsics(A_path)
        crop_A, crop_B = self.crop_boxes()
        A_d, A_i = self._transform_pair(rng, A_depth, A_img)
        B_d, B_i = self._transform_pair(rng, B_depth, B_img)
        return {"A_i": A_i, "B_i": B_i, "A_d": A_d, "B_d": B_d,
                "A_paths": str(A_path), "B_paths": str(B_path),
                "K_A": K_A.astype(np.float32), "K_B": K_B.astype(np.float32),
                "crop_A": crop_A, "crop_B": crop_B}
