"""Host-side geometry and normalisers (counterpart of ``desr_tpu/data/transforms.py``).

The JAX package calls cv2 with albumentations 0.4.6 semantics; the card's
machine has no cv2, so the port writes the branches it runs in numpy:
Resize with interpolation 3 (cv2 INTER_AREA, through the matrices of
``ops/resize.py``), PadIfNeeded (centred, border REFLECT_101, which is
numpy's "reflect") and the horizontal flip. The other interpolation codes
and rotation wait for the port of the augmentation.
"""

from __future__ import annotations

import numpy as np

from desr_tpu_torch.ops.resize import resize_cv2_inter_area_np

INTER_AREA = 3


def resize(img, height, width, interpolation=INTER_AREA):
    """cv2.resize of a float HW or HWC array to (height, width)
    (transforms.py:44-47); only INTER_AREA is ported."""
    if img.shape[0] == height and img.shape[1] == width:
        return img
    if interpolation != INTER_AREA:
        raise NotImplementedError(
            f"resizing with cv2 interpolation {interpolation} (transforms.py:44-47): "
            "not yet ported; INTER_AREA (3) is")
    return resize_cv2_inter_area_np(img, (height, width))


def pad_if_needed(img, min_h, min_w):
    """Centred reflect-101 pad up to (min_h, min_w) (transforms.py:58-67)."""
    h, w = img.shape[:2]
    pt = max((min_h - h) // 2, 0)
    pb = max(min_h - h - pt, 0)
    pl = max((min_w - w) // 2, 0)
    pr = max(min_w - w - pl, 0)
    if pt == pb == pl == pr == 0:
        return img
    pads = [(pt, pb), (pl, pr)] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, pads, mode="reflect")


def hflip(img):
    return np.ascontiguousarray(img[:, ::-1])


def normalize_image_np(img):
    """(u8-range float) -> [-1, 1] (my_main_dataset.py:35-36)."""
    return (img.astype(np.float32) - 127.5) / 127.5


def normalize_depth_np(depth, meters=5100.0):
    """int depth (mm) or float depth -> [-1, 1] (my_main_dataset.py:38-52)."""
    if np.issubdtype(depth.dtype, np.integer):
        d = np.where(depth > meters, meters, depth) / meters
    else:
        d = np.where(depth < 0.33, 0.0, depth)
        d = np.where(d > meters, meters, d) / meters
    return (d * 2.0 - 1.0).astype(np.float32)
