"""Resizes with PyTorch ``F.interpolate`` semantics (counterpart of
``desr_tpu/ops/resize.py``), and cv2's INTER_AREA for the host data path.

The JAX package imitates ``F.interpolate(..., align_corners=False)`` with
dense matrices (bicubic with a = -0.75, half-pixel centres, edge clamp, no
antialias); here bicubic and bilinear are ``F.interpolate`` itself. Nearest
is a gather at the JAX package's source rows ``floor(i * in / out)``,
computed in float64: ``F.interpolate``'s float32 scale rounds some of them
down at non-integer ratios (26 -> 22: row 11 reads row 12, not 13). Every
resize computes in float32 and casts back to the input's dtype, as
``_apply_separable`` does (resize.py:93-117).

The host data path resizes with the JAX package's numpy matrices of cv2's
INTER_AREA (``resize_matrix``, ``resize_cv2_inter_area_np``) and with the
matrices of cv2's INTER_LANCZOS4 (``lanczos4_matrix``,
``resize_cv2_lanczos4_np``): the card's machine has no cv2.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=256)
def resize_matrix(in_size, out_size, mode):
    """(out_size, in_size) float32 matrix of cv2's INTER_AREA along one axis
    (resize.py:65-90): "cv2_area" (area decimation) or "cv2_area_up" (its
    zoom coefficients). Cached: treat the result as read-only."""
    scale = in_size / out_size
    m = np.zeros((out_size, in_size), dtype=np.float64)
    if mode == "cv2_area":
        # dst[j] = the area average of src over [j*scale, (j+1)*scale),
        # fractional cells weighted by their overlap
        for j in range(out_size):
            lo, hi = j * scale, (j + 1) * scale
            for i in range(int(np.floor(lo)), min(int(np.ceil(hi)), in_size)):
                m[j, i] = (min(i + 1.0, hi) - max(float(i), lo)) / scale
    elif mode == "cv2_area_up":
        # OpenCV's INTER_AREA branch when not both axes shrink: sx =
        # floor(dx * scale), fx = (dx + 1) - (sx + 1) / scale wrapped into
        # [0, 1); pixel replication at an integer zoom
        inv = out_size / in_size
        for dx in range(out_size):
            sx = int(np.floor(dx * scale))
            fx = (dx + 1) - (sx + 1) * inv
            fx = 0.0 if fx <= 0 else fx - np.floor(fx)
            m[dx, min(sx, in_size - 1)] += 1.0 - fx
            m[dx, min(sx + 1, in_size - 1)] += fx
    else:
        raise ValueError(mode)
    return m.astype(np.float32)


@functools.lru_cache(maxsize=256)
def nearest_index(in_size, out_size):
    """Source index of each output row of a nearest resize: floor(i * in / out)
    in float64, clipped (resize.py:40-42)."""
    src = np.floor(np.arange(out_size) * (in_size / out_size)).astype(np.int64)
    return np.clip(src, 0, in_size - 1)


@functools.lru_cache(maxsize=64)
def _nearest_index_on(in_size, out_size, device):
    """``nearest_index`` as a tensor on ``device``, made once: a host-to-device
    copy per call would wait for the device's queue to drain."""
    return torch.from_numpy(nearest_index(in_size, out_size)).to(device)


def _resize_planar(x, out_hw, mode):
    """Resize the last two dims of x, in float32, cast back to x's dtype."""
    h, w = x.shape[-2:]
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return x
    y = x.float()
    if mode == "nearest":
        y = y.index_select(-2, _nearest_index_on(h, oh, x.device))
        y = y.index_select(-1, _nearest_index_on(w, ow, x.device))
    else:
        lead = y.shape[:-2]
        y4 = y if y.dim() == 4 else y.reshape(-1, 1, h, w)
        y4 = F.interpolate(y4, size=(oh, ow), mode=mode, align_corners=False)
        y = y4 if y.dim() == 4 else y4.reshape(*lead, oh, ow)
    return y.to(x.dtype)


def _resize_nhwc(x, out_hw, mode):
    return _resize_planar(x.permute(0, 3, 1, 2), out_hw, mode).permute(0, 2, 3, 1)


def resize_bicubic(img, out_hw):
    """``F.interpolate(mode='bicubic', align_corners=False)`` of an NHWC tensor."""
    return _resize_nhwc(img, out_hw, "bicubic")


def resize_bilinear(img, out_hw):
    """``F.interpolate(mode='bilinear', align_corners=False)`` of an NHWC tensor."""
    return _resize_nhwc(img, out_hw, "bilinear")


def resize_nearest(img, out_hw):
    """Nearest resize of an NHWC tensor, source rows floor(i * in / out)."""
    return _resize_nhwc(img, out_hw, "nearest")


def resize_bicubic_planar(x, out_hw):
    """Bicubic on the last two dims of (..., H, W), e.g. (B, H, W) or NCHW."""
    return _resize_planar(x, out_hw, "bicubic")


def resize_bilinear_planar(x, out_hw):
    return _resize_planar(x, out_hw, "bilinear")


def resize_nearest_planar(x, out_hw):
    return _resize_planar(x, out_hw, "nearest")


def resize_cv2_inter_area_np(img, out_hw):
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)`` of a float
    (H, W) or (H, W, C) numpy array, in float32 (resize.py:148-161): cv2's
    area decimation when both axes shrink (or keep their size), its zoom
    coefficients on both axes otherwise."""
    h, w = img.shape[:2]
    oh, ow = out_hw
    mode = "cv2_area" if (h >= oh and w >= ow) else "cv2_area_up"
    x = np.asarray(img, dtype=np.float32)
    if oh != h:
        x = np.tensordot(resize_matrix(h, oh, mode), x, axes=(1, 0))
    if ow != w:
        x = np.moveaxis(np.tensordot(resize_matrix(w, ow, mode), x, axes=(1, 1)), 0, 1)
    return np.ascontiguousarray(x, dtype=np.float32)


@functools.lru_cache(maxsize=64)
def lanczos4_matrix(in_size, out_size):
    """(out_size, in_size) float64 matrix of cv2's INTER_LANCZOS4 along one
    axis, as cv2's resizeGeneric builds it: output j reads source position
    f = float32((j + 0.5) * in / out - 0.5), the 8 taps floor(f) - 3 ..
    floor(f) + 4 weighted by sinc(z) sinc(z / 4) at z = frac(f) + 3 - k,
    normalised to sum 1 (interpolateLanczos4), taps past either edge clamped
    to it. The kernel does not widen when it shrinks, so a downscale aliases
    as cv2's does. Cached: treat the result as read-only."""
    m = np.zeros((out_size, in_size), dtype=np.float64)
    src = ((np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5).astype(np.float32)
    sx = np.floor(src).astype(np.int64)
    z = (src - sx).astype(np.float64)[:, None] + 3.0 - np.arange(8)[None, :]
    c = np.sinc(z) * np.sinc(z / 4.0)
    c /= c.sum(axis=1, keepdims=True)
    taps = np.clip(sx[:, None] - 3 + np.arange(8)[None, :], 0, in_size - 1)
    np.add.at(m, (np.repeat(np.arange(out_size), 8), taps.reshape(-1)), c.reshape(-1))
    return m


def resize_cv2_lanczos4_np(img, out_hw):
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_LANCZOS4)`` of a
    float (H, W) or (H, W, C) numpy array, in float32 (the translation
    dataset's Resize(320, 320, interpolation=4))."""
    h, w = img.shape[:2]
    oh, ow = out_hw
    x = np.asarray(img, dtype=np.float64)
    if ow != w:
        x = np.moveaxis(np.tensordot(lanczos4_matrix(w, ow), x, axes=(1, 1)), 0, 1)
    if oh != h:
        x = np.tensordot(lanczos4_matrix(h, oh), x, axes=(1, 0))
    return np.ascontiguousarray(x, dtype=np.float32)
