"""The losses of stages 1 and 3, planar (counterpart of ``desr_tpu/ops/losses.py``).

Depth maps are (B, H, W), normal and image maps (B, C, H, W); each loss
returns a scalar. The masked (task, holes, holes_l2) triplets run on the K3
kernel (``ops/masked_loss.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(x, y):
    return (x - y).abs().mean()


def mse_loss(x, y):
    return (x - y).square().mean()


def gan_loss(prediction, target_is_real, mode="lsgan"):
    """The GAN objective on raw discriminator logits (losses.py:111-130):
    lsgan = MSE against 1/0 labels, vanilla = BCE with logits, wgangp = -+mean."""
    if mode == "lsgan":
        return (prediction - (1.0 if target_is_real else 0.0)).square().mean()
    if mode == "vanilla":
        target = torch.full_like(prediction, 1.0 if target_is_real else 0.0)
        return F.binary_cross_entropy_with_logits(prediction, target)
    if mode == "wgangp":
        return -prediction.mean() if target_is_real else prediction.mean()
    raise NotImplementedError(f"gan mode {mode} not implemented")


def tv_loss_planar(img):
    """Unnormalised total variation over the last two dims (losses.py:219)."""
    w_var = (img[..., :, :-1] - img[..., :, 1:]).square().sum()
    h_var = (img[..., :-1, :] - img[..., 1:, :]).square().sum()
    return h_var + w_var


@functools.lru_cache(maxsize=128)
def _align_corners_matrix(in_size, out_size):
    """(out, in) bilinear align_corners=True interpolation matrix (losses.py:138)."""
    if out_size == 1:
        src = np.zeros((1,))
    else:
        src = np.arange(out_size) * ((in_size - 1) / (out_size - 1))
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = src - lo
    m = np.zeros((out_size, in_size), dtype=np.float32)
    np.add.at(m, (np.arange(out_size), lo), 1.0 - frac)
    np.add.at(m, (np.arange(out_size), hi), frac)
    return m


@functools.lru_cache(maxsize=128)
def _align_corners_tensor(in_size, out_size, device):
    # cached on the device: a copy from pageable host memory every step
    # would stall the host until the card drains its queue
    return torch.from_numpy(_align_corners_matrix(in_size, out_size)).to(device)


def _resize_ac_planar(x, out_hw):
    """align_corners=True bilinear on the last two dims, as two matrix
    products in f32 (losses.py:258)."""
    h, w = x.shape[-2], x.shape[-1]
    oh, ow = out_hw
    y = x.float()
    if oh != h:
        y = torch.einsum("oh,...hw->...ow", _align_corners_tensor(h, oh, y.device), y)
    if ow != w:
        y = torch.einsum("ow,...hw->...ho", _align_corners_tensor(w, ow, y.device), y)
    return y.to(x.dtype)


def scale_pyramid_planar(img, num_scales):
    """Bilinear (align_corners=True) pyramid on (..., H, W), smallest first
    (losses.py:271)."""
    h, w = img.shape[-2], img.shape[-1]
    scaled = [img] + [_resize_ac_planar(img, (h // 2 ** i, w // 2 ** i))
                      for i in range(1, num_scales)]
    return scaled[::-1]


def smooth_weight_loss_planar(depth_bhw, image_b3hw, num_scales=3):
    """Image-gradient-weighted depth smoothness (losses.py:282): at each scale
    of the pyramid (smallest first, the i-th divided by 2^i), mean |grad d|
    weighted by exp(-mean_c |grad image|), along rows and columns."""
    images = scale_pyramid_planar(image_b3hw, num_scales)
    depths = scale_pyramid_planar(depth_bhw, num_scales)
    total = 0.0
    for i in range(num_scales):
        d, im = depths[i], images[i]
        wx = torch.exp(-(im[..., :-1, :] - im[..., 1:, :]).abs().mean(dim=1))
        wy = torch.exp(-(im[..., :, :-1] - im[..., :, 1:]).abs().mean(dim=1))
        total = total + ((d[..., :-1, :] - d[..., 1:, :]) * wx).abs().mean() / 2 ** i
        total = total + ((d[..., :, :-1] - d[..., :, 1:]) * wy).abs().mean() / 2 ** i
    return total
