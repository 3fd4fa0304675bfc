"""Host-side geometry and normalisers (counterpart of ``desr_tpu/data/transforms.py``).

The JAX package calls cv2 with albumentations 0.4.6 semantics. The port calls
no cv2, whose builds differ from host to host, and writes the branches in
numpy: Resize with every interpolation code the JAX package passes to cv2,
0 (INTER_NEAREST), 1 (INTER_LINEAR), 2 (INTER_CUBIC, the legacy datasets'),
3 (INTER_AREA) and 4 (INTER_LANCZOS4), through the index and weight tables
of ``ops/resize.py``; PadIfNeeded (centred, border REFLECT_101, which is
numpy's "reflect"), Rotate (cv2's bilinear ``warpAffine``, border
REFLECT_101), RandomCrop, the horizontal flip and ColorJitter, whose hue step
is cv2's uint8 RGB<->HSV round trip written as arithmetic.
"""

from __future__ import annotations

import numpy as np

INTER_NEAREST = 0
INTER_LINEAR = 1
INTER_CUBIC = 2
INTER_AREA = 3
INTER_LANCZOS4 = 4


def resize(img, height, width, interpolation=INTER_AREA):
    """cv2.resize of a float HW or HWC array to (height, width)
    (transforms.py:44-47) with cv2's interpolation code 0-4."""
    if img.shape[0] == height and img.shape[1] == width:
        return img
    # imported here: ops.resize imports torch, which the serving CLI's
    # decode workers (this module's other users) do without
    from desr_tpu_torch.ops import resize as R

    fns = {INTER_NEAREST: R.resize_cv2_nearest_np, INTER_LINEAR: R.resize_cv2_linear_np,
           INTER_CUBIC: R.resize_cv2_cubic_np, INTER_AREA: R.resize_cv2_inter_area_np,
           INTER_LANCZOS4: R.resize_cv2_lanczos4_np}
    if interpolation not in fns:
        raise KeyError(f"cv2 interpolation {interpolation}: the resize takes codes 0-4")
    return fns[interpolation](img, (height, width))


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


def _fma(a, b, c):
    """float32 a * b + c rounded once (the product is exact in float64)."""
    return (np.asarray(a, np.float64) * b + np.asarray(c, np.float64)).astype(np.float32)


def _reflect_101(i, n):
    """cv2's BORDER_REFLECT_101 index (gfedcb|abcdefgh|gfedcb), any distance out."""
    if n == 1:
        return np.zeros_like(i)
    i = np.mod(i, 2 * (n - 1))
    return np.where(i >= n, 2 * (n - 1) - i, i)


def _rotation_matrix(h, w, angle):
    """The float32 destination -> source map of ``rotate``: the inverse
    (cv2.invertAffineTransform) of cv2.getRotationMatrix2D((w/2, h/2),
    angle, 1), in float64 and then rounded, as warpAffine takes it."""
    a = np.deg2rad(angle)
    alpha, beta = np.cos(a), np.sin(a)
    cx, cy = w / 2, h / 2
    m = [alpha, beta, (1 - alpha) * cx - beta * cy, -beta, alpha, beta * cx + (1 - alpha) * cy]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22, a12, a21 = m[4] * d, m[0] * d, -m[1] * d, -m[3] * d
    b1 = -a11 * m[2] - a12 * m[5]
    b2 = -a21 * m[2] - a22 * m[5]
    return np.array([[a11, a12, b1], [a21, a22, b2]]).astype(np.float32)


def rotate(img, angle):
    """cv2.warpAffine(img, getRotationMatrix2D((w/2, h/2), angle, 1), (w, h),
    INTER_LINEAR, BORDER_REFLECT_101) of a float HW or HWC array
    (transforms.py:50-55; albumentations 0.4.6 rotates about (w/2, h/2), with
    no -0.5).

    The warp runs in float32 in the order of cv2's own floating-point warp
    (OpenCV 5): source x = fma(m00, x, m01 * y + m02) and likewise y, then
    two bilinear lerps along x and one along y, each an fma. Taps outside the
    frame fold back by REFLECT_101, as often as they need to. The float32
    data is not clipped.
    """
    h, w = img.shape[:2]
    m = _rotation_matrix(h, w, angle)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    sx = _fma(m[0, 0], xs, m[0, 1] * ys + m[0, 2])
    sy = _fma(m[1, 0], xs, m[1, 1] * ys + m[1, 2])
    x0, y0 = np.floor(sx), np.floor(sy)
    fx, fy = sx - x0, sy - y0
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    xa, xb = _reflect_101(x0, w), _reflect_101(x0 + 1, w)
    ya, yb = _reflect_101(y0, h), _reflect_101(y0 + 1, h)
    src = np.asarray(img, np.float32)
    if src.ndim == 3:
        fx, fy = fx[..., None], fy[..., None]
    p00, p01, p10, p11 = src[ya, xa], src[ya, xb], src[yb, xa], src[yb, xb]
    top = _fma(fx, p01 - p00, p00)
    bottom = _fma(fx, p11 - p10, p10)
    return _fma(fy, bottom - top, top)


def random_crop_params(rng, h, w, crop_h, crop_w):
    """albumentations 0.4.6 F.random_crop: offset = int((extent - crop) * u)
    (transforms.py:70-74); the last offset is never drawn."""
    y = int(max(h - crop_h, 0) * float(rng.uniform()))
    x = int(max(w - crop_w, 0) * float(rng.uniform()))
    return y, x


def crop(img, y, x, crop_h, crop_w):
    return img[y:y + crop_h, x:x + crop_w]


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


# -- ColorJitter (transforms.py:85-133) ----------------------------------------

_HSV_SHIFT = 12


def rgb2hsv_u8(r, g, b):
    """cv2.COLOR_RGB2HSV on uint8 values (int32 arrays in and out): H in
    [0, 180), S and V in [0, 256).

    cv2's fixed-point tables sdiv[i] = rint((255 << 12) / i) and
    hdiv[i] = rint((180 << 12) / (6 i)) are computed in float32 rather than
    looked up, as ``desr_tpu/ops/device_aug.py:_rgb2hsv_u8`` does: no true
    quotient lies on a .5 boundary, so the float32 division rounds to the
    table's value.
    """
    v = np.maximum(np.maximum(r, g), b)
    vmin = np.minimum(np.minimum(r, g), b)
    diff = v - vmin
    half = 1 << (_HSV_SHIFT - 1)
    sdiv_v = np.where(v > 0, np.rint(np.float32(255 << _HSV_SHIFT)
                                     / np.maximum(v, 1).astype(np.float32)), 0).astype(np.int32)
    hdiv_d = np.where(diff > 0, np.rint(np.float32((180 << _HSV_SHIFT) // 6)
                                        / np.maximum(diff, 1).astype(np.float32)),
                      0).astype(np.int32)
    s = (diff * sdiv_v + half) >> _HSV_SHIFT
    h_num = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h_num * hdiv_d + half) >> _HSV_SHIFT
    return np.where(h < 0, h + 180, h), s, v


def hsv2rgb_u8(h, s, v):
    """cv2.COLOR_HSV2RGB on uint8 values (int32 arrays in and out), as
    ``device_aug.py:_hsv2rgb_u8``: the sector interpolation in float32 at
    [0, 1] scale and the final value * 255 floored. ``1 - s * f`` is one fma,
    as in cv2's vector path: so the table equals cv2's on all 180 * 256 * 256
    inputs (cv2's scalar path, which takes the pixels of a row past its last
    full vector, rounds some of them otherwise)."""
    f32 = np.float32
    hf = h.astype(f32) * f32(6.0 / 180.0)
    sf = s.astype(f32) * f32(1.0 / 255.0)
    vf = v.astype(f32) * f32(1.0 / 255.0)
    sector = np.floor(hf)
    frac = hf - sector
    sec = sector.astype(np.int32)
    one = f32(1.0)
    tab = [vf, vf * (one - sf), vf * _fma(-sf, frac, one), vf * _fma(-sf, one - frac, one)]
    # OpenCV's sector_data (b, g, r tab indices per sector), in rgb order
    r_idx, g_idx, b_idx = (0, 2, 1, 1, 3, 0), (3, 0, 0, 2, 1, 1), (1, 1, 3, 0, 0, 2)

    def pick(idx):
        out = tab[idx[0]]
        for k in range(1, 6):
            out = np.where(sec == k, tab[idx[k]], out)
        return np.floor(out * f32(255.0)).astype(np.int32)

    return pick(r_idx), pick(g_idx), pick(b_idx)


def draw_jitter_params(rng, brightness=0.1, contrast=0.1, saturation=0.1, hue=0.05):
    """ColorJitter's draws: four factor uniforms, then the op-order permutation."""
    b = float(rng.uniform(1 - brightness, 1 + brightness))
    c = float(rng.uniform(1 - contrast, 1 + contrast))
    s = float(rng.uniform(1 - saturation, 1 + saturation))
    hshift = float(rng.uniform(-hue, hue))
    order = rng.permutation(4)
    return b, c, s, hshift, order


def color_jitter(rng, img_u8, brightness=0.1, contrast=0.1, saturation=0.1, hue=0.05):
    """torchvision-style ColorJitter on a uint8 RGB image
    (my_I2D_dataset.py:212-214): factors from [1-x, 1+x] (hue from
    [-hue, hue]), applied in a random order. Returns float32 in [0, 255]."""
    return apply_jitter(img_u8, *draw_jitter_params(rng, brightness, contrast, saturation, hue))


def apply_jitter(img_u8, b, c, s, hshift, order):
    """Apply drawn ColorJitter parameters (transforms.py:106-133)."""
    img = img_u8.astype(np.float32)

    def do_brightness(x):
        return np.clip(x * b, 0, 255)

    def do_contrast(x):
        mean = x.mean()
        return np.clip(mean + (x - mean) * c, 0, 255)

    def do_saturation(x):
        gray = (x @ np.array([0.299, 0.587, 0.114], np.float32))[..., None]
        return np.clip(gray + (x - gray) * s, 0, 255)

    def do_hue(x):
        xi = x.astype(np.uint8).astype(np.int32)
        h, sat, val = rgb2hsv_u8(xi[..., 0], xi[..., 1], xi[..., 2])
        # the shift in float32, as the JAX package keeps it: float64 would
        # flip the uint8 truncation of H on ~1e-5 of the pixels
        hf = (h.astype(np.float32) + np.float32(hshift) * np.float32(180.0)) % np.float32(180.0)
        rgb = hsv2rgb_u8(hf.astype(np.uint8).astype(np.int32), sat, val)
        return np.stack(rgb, axis=-1).astype(np.float32)

    ops = [do_brightness, do_contrast, do_saturation, do_hue]
    for i in order:
        img = ops[i](img)
    return img
