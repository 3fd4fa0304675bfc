"""Host-side output helpers (counterpart of ``desr_tpu/utils/util.py``).

Images are written through the port's stdlib PNG codec (``data/png.py``);
only ``save_image``'s aspect stretch goes through PIL, as the JAX function
does.
"""

from __future__ import annotations

import os

import numpy as np

from desr_tpu_torch.data.png import write_png


def data_to_meters(x, max_distance):
    """[-1, 1] depth to meters (util/util.py:8-12)."""
    x = x * (max_distance / 2) + (max_distance / 2)
    return x / 1000.0


def tensor2im(arr, imtype=np.uint8):
    """[-1, 1] float array (H, W, C), or a batch of them (its first), to a
    uint8 HWC image; one channel is repeated to three."""
    a = np.asarray(arr)
    if a.ndim == 4:
        a = a[0]
    if a.ndim == 3 and a.shape[-1] == 1:
        a = np.repeat(a, 3, axis=-1)
    a = (a + 1) / 2.0 * 255.0
    return np.clip(a, 0, 255).astype(imtype)


def save_image(image_numpy, image_path, aspect_ratio=1.0):
    """Write a uint8 (H, W, 3) image as a PNG, its width stretched by
    ``aspect_ratio`` above 1 or its height by 1 / ``aspect_ratio`` below 1
    with PIL's bicubic filter, as the JAX function does (util.py:30-38). Only
    the stretch needs PIL."""
    img = np.ascontiguousarray(image_numpy)
    if aspect_ratio != 1.0:
        from PIL import Image

        h, w = img.shape[:2]
        size = (int(w * aspect_ratio), h) if aspect_ratio > 1.0 else (w, int(h / aspect_ratio))
        img = np.asarray(Image.fromarray(img).resize(size, Image.BICUBIC))
    write_png(image_path, np.ascontiguousarray(img))


def save_uint16_png(depth01, path):
    """Save a [0, 1] depth map as a x5100 uint16 PNG (main_model.py:323-336).

    Values are truncated to integers, as ``astype(np.uint16)`` does in the JAX
    package.
    """
    arr = np.clip(np.asarray(depth01), 0, 1) * 5100.0
    write_png(path, arr.astype(np.uint16))


def mkdirs(paths):
    if isinstance(paths, (list, tuple)):
        for p in paths:
            os.makedirs(p, exist_ok=True)
    else:
        os.makedirs(paths, exist_ok=True)


def crop_indx(f_name):
    """The ssim-patch crop box of a Scannet_ssim name ``scene0000_00_<i>_<j>``:
    h = 64 i + 5, w = 64 j + 5, 320x320 (models/norms.py:167-174)."""
    parts = f_name.split("_")
    i, j = int(parts[-2]), int(parts[-1])
    h_start = 64 * i + 5
    w_start = 64 * j + 5
    return h_start, h_start + 320, w_start, w_start + 320


def diagnose_network(params, name="network"):
    """Mean over tensors of each one's mean absolute value; ``params`` is a
    dict of tensors or arrays (a state_dict)."""
    vals = [np.abs(to_numpy(v)).mean() for v in params.values()]
    mean = float(np.mean(vals)) if vals else 0.0
    print(name, mean)
    return mean


def to_numpy(v):
    """A tensor (any device and float dtype) or array as a numpy array,
    float32 for a tensor."""
    if hasattr(v, "detach"):
        v = v.detach().float().cpu().numpy()
    return np.asarray(v)
