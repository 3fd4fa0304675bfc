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
INTER_AREA (``resize_matrix``, ``resize_cv2_inter_area_np``), with the
matrices of cv2's INTER_LANCZOS4 (``lanczos4_matrix``,
``resize_cv2_lanczos4_np``), with cv2's INTER_CUBIC (``cubic_taps``,
``resize_cv2_cubic_np``, the legacy datasets'), INTER_NEAREST
(``cv2_nearest_index``) and INTER_LINEAR (``linear_taps``): the port needs
no cv2. The SR stage's
``--device_aug`` half resizes on the card with the same INTER_AREA weights
(``resize_cv2_inter_area``).

Under ``--spatial_devices`` the planar resizes take a ``spatial`` group
(``parallel/spatial.py``) and a rank's band of the input's rows, and give
the rank's band of the output's: at an integer ratio (the SR stage's x2 and
x1/2) the band is resized with ``m`` rows of each neighbour's around it
(replicated at the frame's edges, as the interpolation clamps) and the
rows those add are cropped off. The source coordinates of the band are
then those of the whole frame, shifted, so each output row is the same
weighted sum of the same input rows as on one process. Nearest keeps
within the band.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from desr_tpu_torch.parallel import spatial as S


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


def _resize_planar(x, out_hw, mode, spatial=None):
    """Resize the last two dims of x, in float32, cast back to x's dtype;
    on a rank's band of rows under an active ``spatial`` (``_resize_band``)."""
    sp = S.active(spatial)
    if sp is not None:
        return _resize_band(x, out_hw, mode, sp)
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


def _resize_band(x, out_hw, mode, sp):
    """The rank's band of the resize of a frame whose band of rows x holds
    (global H = rows x S; ``out_hw`` global), at an integer ratio of H."""
    h, w = x.shape[-2:]
    big, oh = h * sp.size, out_hw[0]
    up, down = (oh // big, 0) if oh >= big else (0, big // oh)
    if oh % sp.size or (up and oh % big) or (down and big % oh):
        raise NotImplementedError(f"a resize of {big} rows to {oh} over {sp.size} ranks")
    band = oh // sp.size
    if oh == big or mode == "nearest":  # source rows within the band
        return _resize_planar(x, (band, out_hw[1]), mode)
    # bicubic reads 2 rows past its source row each side: 2 input rows at
    # x``up``, ``down`` (>= 2) at 1/``down``, which keeps the band's start on
    # an output row
    m = 2 if up else down
    dim = x.dim() - 2
    ext, ht, hb = S.exchange_rows(x, m, m, sp, dim=dim)
    if m - ht or m - hb:
        ext = F.pad(ext.reshape(-1, 1, *ext.shape[-2:]), (0, 0, m - ht, m - hb),
                    mode="replicate").reshape(*x.shape[:-2], h + 2 * m, w)
    y = _resize_planar(ext, ((h + 2 * m) * up if up else (h + 2 * m) // down, out_hw[1]), mode)
    lo = m * up if up else 1
    return y.narrow(dim, lo, band)


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


def resize_bicubic_planar(x, out_hw, spatial=None):
    """Bicubic on the last two dims of (..., H, W), e.g. (B, H, W) or NCHW;
    a rank's band under ``spatial`` (see the module)."""
    return _resize_planar(x, out_hw, "bicubic", spatial)


def resize_bilinear_planar(x, out_hw):
    return _resize_planar(x, out_hw, "bilinear")


def resize_nearest_planar(x, out_hw, spatial=None):
    return _resize_planar(x, out_hw, "nearest", spatial)


@functools.lru_cache(maxsize=64)
def _resize_matrix_on(in_size, out_size, mode, device):
    """``resize_matrix`` as a tensor on ``device``, made once per size: a
    host-to-device copy per call would wait for the device's queue to drain."""
    return torch.from_numpy(resize_matrix(in_size, out_size, mode)).to(device)


def resize_cv2_inter_area(img, out_hw):
    """``cv2.resize(..., interpolation=cv2.INTER_AREA)`` of an NHWC tensor,
    in float32 (resize.py:148-161): the rows, then the columns, each one
    matmul with ``resize_matrix``'s weights, as ``resize_cv2_inter_area_np``.
    The columns' matmul takes W first: with C innermost, (W, C) slices
    would make one thin product per row."""
    b, h, w, c = img.shape
    oh, ow = out_hw
    mode = "cv2_area" if (h >= oh and w >= ow) else "cv2_area_up"
    x = img.float()
    if oh != h:
        x = torch.matmul(_resize_matrix_on(h, oh, mode, x.device),
                         x.reshape(b, h, w * c)).reshape(b, oh, w, c)
    if ow != w:
        x = torch.matmul(_resize_matrix_on(w, ow, mode, x.device),
                         x.permute(2, 0, 1, 3).reshape(w, b * oh * c))
        x = x.reshape(ow, b, oh, c).permute(1, 2, 0, 3)
    return x


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


@functools.lru_cache(maxsize=64)
def cubic_taps(in_size, out_size):
    """cv2's INTER_CUBIC along one axis, as its resizeGeneric builds it:
    output j reads source position f = float32((j + 0.5) * scale - 0.5),
    scale = 1 / (out / in), at the 4 taps floor(f) - 1 .. floor(f) + 2
    (``(out_size, 4)`` indices, taps past either edge clamped to it: a
    replicated border), weighted by interpolateCubic's float32 coefficients
    (a = -0.75) of frac(f) (4 float32 ``(out_size,)`` rows). The kernel does
    not widen when it shrinks. Cached: treat the result as read-only."""
    src = ((np.arange(out_size) + 0.5) * (1.0 / (out_size / in_size)) - 0.5).astype(np.float32)
    sx = np.floor(src)
    x = (src - sx).astype(np.float32)
    a, one = np.float32(-0.75), np.float32(1.0)
    x1, y = x + one, one - x
    c0 = ((a * x1 - 5 * a) * x1 + 8 * a) * x1 - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + one
    c2 = ((a + 2) * y - (a + 3)) * y * y + one
    taps = np.clip(sx.astype(np.int64)[:, None] - 1 + np.arange(4)[None, :], 0, in_size - 1)
    return taps, (c0, c1, c2, one - c0 - c1 - c2)


def resize_cv2_cubic_np(img, out_hw):
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_CUBIC)`` of a float
    (H, W) or (H, W, C) numpy array, in float32 with cv2's own float code's
    order of operations (HResizeCubic along each row, then VResizeCubic's
    ``b0 S0 + (b1 S1 + (b2 S2 + b3 S3))`` down the columns): equal to cv2 with
    its IPP path off. cv2 hands float INTER_CUBIC to IPP by default, whose
    sums differ by up to ~2e-6 of the values' scale."""
    h, w = img.shape[:2]
    oh, ow = out_hw
    x = np.asarray(img, dtype=np.float32)
    if ow != w:
        taps, c = cubic_taps(w, ow)
        c = [k.reshape((1, ow) + (1,) * (x.ndim - 2)) for k in c]
        s = [x[:, taps[:, k]] for k in range(4)]
        x = ((s[0] * c[0] + s[1] * c[1]) + s[2] * c[2]) + s[3] * c[3]
    if oh != h:
        taps, b = cubic_taps(h, oh)
        b = [k.reshape((oh,) + (1,) * (x.ndim - 1)) for k in b]
        s = [x[taps[:, k]] for k in range(4)]
        x = b[0] * s[0] + (b[1] * s[1] + (b[2] * s[2] + b[3] * s[3]))
    return np.ascontiguousarray(x, dtype=np.float32)


@functools.lru_cache(maxsize=64)
def cv2_nearest_index(in_size, out_size):
    """cv2's INTER_NEAREST source index along one axis, as its resizeNN
    builds it: output j reads floor(j * ifx) with ifx = 1 / (out / in) in
    float64, clamped to the last source row. Cached: treat it as read-only."""
    ifx = 1.0 / (out_size / in_size)
    return np.minimum(np.floor(np.arange(out_size) * ifx).astype(np.int64), in_size - 1)


def resize_cv2_nearest_np(img, out_hw):
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST)`` of an
    (H, W) or (H, W, C) numpy array: a gather at ``cv2_nearest_index``'s
    rows and columns, the values as they are (float32 for a float array)."""
    h, w = img.shape[:2]
    oh, ow = out_hw
    x = np.asarray(img, dtype=np.float32)
    return np.ascontiguousarray(x[cv2_nearest_index(h, oh)][:, cv2_nearest_index(w, ow)])


@functools.lru_cache(maxsize=64)
def linear_taps(in_size, out_size, clamp_weights=True):
    """cv2's INTER_LINEAR along one axis, as its resizeGeneric builds it:
    output j reads source position f = float32((j + 0.5) * scale - 0.5),
    scale = 1 / (out / in), at the taps floor(f) and floor(f) + 1 weighted
    1 - frac(f) and frac(f) in float32, each tap clamped into the axis.
    Along a row (``clamp_weights``) a position before the first source
    pixel or at or past the last takes that pixel alone (weights 1 and 0);
    down the columns cv2 keeps the weights and reads the clamped row twice.
    Returns the (out_size, 2) indices and the two float32 ``(out_size,)``
    weights. Cached: treat the result as read-only."""
    src = ((np.arange(out_size) + 0.5) * (1.0 / (out_size / in_size)) - 0.5).astype(np.float32)
    sx = np.floor(src).astype(np.int64)
    fx = (src - sx).astype(np.float32)
    if clamp_weights:
        fx = np.where((sx < 0) | (sx >= in_size - 1), np.float32(0.0), fx)
    taps = np.clip(np.stack([sx, sx + 1], axis=1), 0, in_size - 1)
    return taps, (np.float32(1.0) - fx, fx)


def resize_cv2_linear_np(img, out_hw):
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)`` of a float
    (H, W) or (H, W, C) numpy array, in float32 in the order of cv2's float
    code: HResizeLinear's ``S0 a0 + S1 a1`` along each row, then
    VResizeLinear's ``S0 b0 + S1 b1`` down the columns (``linear_taps``:
    half-pixel centres, the edges clamped). Equal to cv2 with its IPP path
    off; cv2 hands float INTER_LINEAR to IPP by default, whose source
    positions differ (up to ~4e-5 of a [-1, 1] range at a 12x downscale,
    ~5e-6 at 3x)."""
    h, w = img.shape[:2]
    oh, ow = out_hw
    x = np.asarray(img, dtype=np.float32)
    if ow != w:
        taps, (a0, a1) = linear_taps(w, ow)
        shape = (1, ow) + (1,) * (x.ndim - 2)
        x = x[:, taps[:, 0]] * a0.reshape(shape) + x[:, taps[:, 1]] * a1.reshape(shape)
    if oh != h:
        taps, (b0, b1) = linear_taps(h, oh, clamp_weights=False)
        shape = (oh,) + (1,) * (x.ndim - 1)
        x = x[taps[:, 0]] * b0.reshape(shape) + x[taps[:, 1]] * b1.reshape(shape)
    return np.ascontiguousarray(x, dtype=np.float32)
