"""SSIM on tensors (counterpart of ``desr_tpu/ops/ssim.py``): the offline
metric's formula (new_metrics.py:86-111 of the reference): an 11x11
Gaussian window of sigma 1.5 built from an mgrid, a 'valid' filter,
K1 = 0.01, K2 = 0.03, L = ``max_val``. The filter is a depthwise conv on
the input's device; the window is symmetric, so correlation is convolution.

The window is the metric's ``fspecial_gauss`` (new_metrics.py:70-84):
offsets -5..5 for size 11. The JAX function's ``_gauss_window``
(desr_tpu/ops/ssim.py:25) takes -4..5, a 10x10 window, and so reads up to
5e-4 off the metric on a smooth frame (ROADMAP, faults of the reference).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=8)
def _gauss_window(size=11, sigma=1.5):
    """fspecial_gauss of new_metrics.py:70-84 (2-D, normalised), float32 numpy."""
    xx, yy = np.mgrid[-size // 2 + 1: size // 2 + 1, -size // 2 + 1: size // 2 + 1]
    g = np.exp(-((xx ** 2 + yy ** 2) / (2.0 * sigma ** 2)))
    return (g / g.sum()).astype(np.float32)


def ssim(img1, img2, max_val=1.0, size=11, sigma=1.5):
    """Mean SSIM over the valid window positions, a scalar tensor.

    Images are (H, W), (H, W, C) or (B, H, W, C), the JAX function's
    layouts; computed in float32 on img1's device.
    """
    if img1.dim() == 2:
        img1, img2 = img1[None, :, :, None], img2[None, :, :, None]
    elif img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    x = img1.float().permute(0, 3, 1, 2)
    y = img2.float().permute(0, 3, 1, 2)
    c = x.shape[1]
    w = torch.from_numpy(_gauss_window(size, sigma)).to(x.device)
    w = w.expand(c, 1, size, size)

    def filt(t):
        return F.conv2d(t, w, groups=c)

    c1, c2 = (0.01 * max_val) ** 2, (0.03 * max_val) ** 2
    mu1, mu2 = filt(x), filt(y)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = filt(x * x) - mu1_sq
    sigma2_sq = filt(y * y) - mu2_sq
    sigma12 = filt(x * y) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean()
