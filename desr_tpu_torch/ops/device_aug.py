"""The augmentation of ``--device_aug`` on tensors (counterpart of
``desr_tpu/ops/device_aug.py``): rotate + crop + flip, ColorJitter, and the
SR stage's normalise + INTER_AREA + pad + crop, run where the tensors lie
(the card in training; the CPU in the tests).

The host keeps decode and the load-size resize and draws every random
number with the item's numpy generator (``data/base_dataset.py``), so the
parameters equal the host path's for the same ``--seed``. Their rows come
up with the frames and steer plain tensor ops: nothing random is drawn here
and nothing is read back to the host. A per-sample choice (crop offset,
flip, the jitter's op order) becomes an index or a mask.

The rotation is the JAX package's Paeth three-shear map, R^-1 = Shx(a)
Shy(b) Shx(a) with a = -tan(t/2), b = sin(t) in float32, each pass a
per-line 2-tap blend (1 - f) x[t + k] + f x[t + k + 1] of the line shifted
by k + f, REFLECT_101 at any distance: not cv2's direct bilinear warp, which
the host path's ``transforms.rotate`` computes. The JAX package windows the
lines in tiles of 16 around TPU gathers (device_aug.py:49-93); here each
line is one gather of its two taps, which gives the same blend, and the crop
and flip fold into the last pass's indices. Angle 0, crop and flip are
bit-exact; at other angles the shifts' float32 tan and sin may differ from
XLA's by an ulp.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from desr_tpu_torch.ops.resize import resize_cv2_inter_area


def _reflect_101(i, n):
    """cv2's BORDER_REFLECT_101 index of an integer tensor, any distance out
    (``data/transforms.py:_reflect_101``)."""
    if n == 1:
        return torch.zeros_like(i)
    i = torch.remainder(i, 2 * (n - 1))
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def _shear_lines(canvas, shifts, lines=None, cols=None):
    """out[b, i, j] = canvas[b, l, t + shifts[b, l]] by the 2-tap blend, with
    l = lines[b, i] and t = cols[b, j] (all lines and positions by default).

    canvas (B, L, M, C); shifts (B, L) float32; lines (B, L') and cols
    (B, M') int64. Taps past either end of a line fold by REFLECT_101.
    """
    b, n_lines, m, _ = canvas.shape
    dev = canvas.device
    if lines is None:
        lines = torch.arange(n_lines, device=dev).expand(b, n_lines)
    if cols is None:
        cols = torch.arange(m, device=dev).expand(b, m)
    sh = shifts.gather(1, lines)
    k = torch.floor(sh)
    f = (sh - k)[..., None, None]
    pos = cols[:, None, :] + k.long()[:, :, None]
    bi = torch.arange(b, device=dev)[:, None, None]
    li = lines[:, :, None]
    return (1.0 - f) * canvas[bi, li, _reflect_101(pos, m)] \
        + f * canvas[bi, li, _reflect_101(pos + 1, m)]


def _first_two_shears(src, angle):
    """The rows' and the columns' passes of ``src`` (B, H, W, C) rotated by
    ``angle`` (B,) degrees, and the rows' shifts a * y for the third pass
    (device_aug.py:106-117; angle, tan, sin and shifts in float32)."""
    h, w = src.shape[1:3]
    th = angle.float() * (math.pi / 180.0)
    y = torch.arange(h, dtype=torch.float32, device=src.device) - h / 2.0
    x = torch.arange(w, dtype=torch.float32, device=src.device) - w / 2.0
    ay = -torch.tan(th / 2.0)[:, None] * y
    out = _shear_lines(src, ay)
    return _shear_lines(out.transpose(1, 2), torch.sin(th)[:, None] * x).transpose(1, 2), ay


def paeth_rotate(src, angle):
    """Rotate each (H, W, C) frame of ``src`` (B, H, W, C) by ``angle`` (B,)
    degrees about cv2's centre (w/2, h/2), by three shears."""
    out, ay = _first_two_shears(src, angle)
    return _shear_lines(out, ay)


def warp_affine_crop(src, params, out_h, out_w):
    """``hflip?(crop(rotate(src, angle)))`` per sample, the host chain's order
    (device_aug.py:121-137): ``src`` (B, H, W, C); ``params`` (B, 4) rows
    [angle, cy, cx, flip] (flip 0 or 1). The last shear makes only the
    crop's rows and columns, read right to left where flipped."""
    dev = src.device
    out, ay = _first_two_shears(src, params[:, 0])
    j = torch.arange(out_w, device=dev)
    cols = params[:, 2].long()[:, None] + torch.where(params[:, 3:] > 0.5, out_w - 1 - j, j)
    lines = params[:, 1].long()[:, None] + torch.arange(out_h, device=dev)
    return _shear_lines(out, ay, lines, cols)


# -- ColorJitter (device_aug.py:140-247) ---------------------------------------

_HSV_SHIFT = 12


def _rgb2hsv_u8(r, g, b):
    """cv2.COLOR_RGB2HSV on uint8 values (int32 tensors in and out), cv2's
    fixed-point tables computed as float32 divisions (device_aug.py:154-182).
    Tensor by tensor: ``scalar / tensor`` would multiply by a reciprocal."""
    v = torch.maximum(torch.maximum(r, g), b)
    vmin = torch.minimum(torch.minimum(r, g), b)
    diff = v - vmin
    half = 1 << (_HSV_SHIFT - 1)

    def table(num, den):
        den = den.clamp(min=1).float()
        return torch.round(torch.full_like(den, float(num)) / den).int()

    sdiv_v = torch.where(v > 0, table(255 << _HSV_SHIFT, v), 0)
    hdiv_d = torch.where(diff > 0, table((180 << _HSV_SHIFT) // 6, diff), 0)
    s = (diff * sdiv_v + half) >> _HSV_SHIFT
    h_num = torch.where(v == r, g - b, torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h_num * hdiv_d + half) >> _HSV_SHIFT
    return torch.where(h < 0, h + 180, h), s, v


def _hsv2rgb_u8(h, s, v):
    """cv2.COLOR_HSV2RGB on uint8 values (int32 tensors in and out): the
    sector interpolation in float32 at [0, 1] scale, value * 255 floored
    (device_aug.py:185-212), one rounding per operation."""
    hf = h.float() * (6.0 / 180.0)
    sf = s.float() * (1.0 / 255.0)
    vf = v.float() * (1.0 / 255.0)
    sector = torch.floor(hf)
    frac = hf - sector
    sec = sector.int()
    tab = [vf, vf * (1.0 - sf), vf * (1.0 - sf * frac), vf * (1.0 - sf * (1.0 - frac))]
    # OpenCV's sector_data (b, g, r tab indices per sector), in rgb order
    r_idx, g_idx, b_idx = (0, 2, 1, 1, 3, 0), (3, 0, 0, 2, 1, 1), (1, 1, 3, 0, 0, 2)

    def pick(idx):
        out = tab[idx[0]]
        for k in range(1, 6):
            out = torch.where(sec == k, tab[idx[k]], out)
        return torch.floor(out * 255.0).int()

    return pick(r_idx), pick(g_idx), pick(b_idx)


def jitter_round_sizes(order):
    """For each of the jitter's four rounds, how many samples take each op:
    ``sizes[i][k]`` from the host's (B, 4) op-order rows (numpy or a CPU
    tensor), so that the card's rounds split the batch without a read-back."""
    order = np.asarray(order).astype(np.int64)
    return tuple(tuple(int(n) for n in np.bincount(order[:, i], minlength=4)) for i in range(4))


def color_jitter_device(img, factors, order, sizes):
    """ColorJitter of each (H, W, 3) float32 RGB frame of ``img`` (B, H, W, 3)
    in [0, 255] (device_aug.py:215-247). factors (B, 4) = [brightness,
    contrast, saturation, hue shift]; order (B, 4) the ops' permutation, on
    ``img``'s device; ``sizes`` its ``jitter_round_sizes``. Four rounds, where
    the JAX package switches per sample: each sorts the batch by the round's
    op (a stable argsort of the order column, on the device), applies each op
    to its run of ``sizes[i][k]`` samples, and scatters the runs back."""

    def do_brightness(x, f):
        return torch.clamp(x * f[:, 0, None, None, None], 0.0, 255.0)

    def do_contrast(x, f):
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        return torch.clamp(mean + (x - mean) * f[:, 1, None, None, None], 0.0, 255.0)

    def do_saturation(x, f):
        # the dot with (0.299, 0.587, 0.114) term by term: a product with N = 3
        # runs as a slow matrix-vector kernel on the card
        gray = (x[..., 0:1] * 0.299 + x[..., 1:2] * 0.587) + x[..., 2:3] * 0.114
        return torch.clamp(gray + (x - gray) * f[:, 2, None, None, None], 0.0, 255.0)

    def do_hue(x, f):
        xi = x.to(torch.uint8).int()  # truncates, as the host's astype
        h, s, v = _rgb2hsv_u8(xi[..., 0], xi[..., 1], xi[..., 2])
        hf = torch.remainder(h.float() + f[:, 3, None, None] * 180.0, 180.0)
        return torch.stack(_hsv2rgb_u8(hf.int(), s, v), dim=-1).float()

    ops = (do_brightness, do_contrast, do_saturation, do_hue)
    factors = factors.float()
    for i in range(4):
        perm = torch.argsort(order[:, i], stable=True)
        x, f = img.index_select(0, perm), factors.index_select(0, perm)
        runs, start = [], 0
        for op, n in zip(ops, sizes[i]):
            if n:
                runs.append(op(x[start:start + n], f[start:start + n]))
            start += n
        img = torch.empty_like(img).index_copy_(0, perm, torch.cat(runs))
    return img


def model_inputs(a, b):
    """The model's input keys from A's and B's (B, H, W, 4) image + depth stacks."""
    return {"A_i": a[..., :3].contiguous(), "A_d": a[..., 3:].contiguous(),
            "B_i": b[..., :3].contiguous(), "B_d": b[..., 3:].contiguous()}


@torch.no_grad()
def augment_stack(full, geo, out_h, out_w, jit=None, jit_sizes=None):
    """The card's half of ``--device_aug`` for one domain of the unpaired
    A/B datasets (device_aug.py:250-301): ``full`` (B, H, W, 4), the image's
    RGB and the depth stacked, warped jointly by its (B, 4) ``[angle, cy, cx,
    flip]`` rows ``geo`` to (out_h, out_w) and clipped after the warp, as the
    host path clips after its crop.

    With ``jit`` (the I2D stage) the image channels arrive in [0, 255] with
    (B, 9) rows ``[b, c, s, hue, order0..3, enable]`` and ``jit_sizes`` from
    the host's copy of them: ColorJitter, then the normalisation, then the
    warp. ``enable`` 0 marks frames the host already jittered (raw size not
    the load size)."""
    if jit is not None:
        img = full[..., :3]
        jittered = color_jitter_device(img, jit[:, :4], jit[:, 4:8], jit_sizes)
        img = torch.where(jit[:, 8, None, None, None] > 0.5, jittered, img)
        img = (img - 127.5) / 127.5  # normalize_image_np, after the jitter as on the host
        full = torch.cat([img, full[..., 3:]], dim=-1)
    return torch.clamp(warp_affine_crop(full, geo, out_h, out_w), -1.0, 1.0)


def _norm_depth(d):
    # transforms.normalize_depth_np: integer (mm) sources clip at 5100;
    # float sources also zero the < 0.33 tail
    x = d.float()
    if d.is_floating_point():
        x = torch.where(x < 0.33, torch.zeros_like(x), x)
    return torch.clamp(x, max=5100.0) / 5100.0 * 2.0 - 1.0


@torch.no_grad()
def sr_finish_stack(img, depth, off, load_hw, pad_hw, out_hw):
    """The card's half of the SR stage's ``--device_aug`` for one domain
    (device_aug.py:304-365): from the decoded frames, (B, Hi, Wi, 3) uint8
    images and (B, Hd, Wd) integer (mm) or float depths, and (B, 2) crop
    offsets drawn on the host, the host path's chain: normalise, INTER_AREA
    to ``load_hw``, REFLECT_101 pad to ``pad_hw``, crop ``out_hw`` at the
    offsets, clip; the (B, *out_hw, 4) image + depth stack. The pad folds
    into the crop's indices. Any source geometry: the resize matrices are
    cached per size."""
    load_h, load_w = load_hw
    full = torch.cat([resize_cv2_inter_area((img.float() - 127.5) / 127.5, load_hw),
                      resize_cv2_inter_area(_norm_depth(depth)[..., None], load_hw)], dim=-1)
    dev = full.device
    off = off.long()
    pad = [int((t - n) / 2.0) if n < t else 0 for n, t in zip(load_hw, pad_hw)]
    rows = _reflect_101(off[:, :1] - pad[0] + torch.arange(out_hw[0], device=dev), load_h)
    cols = _reflect_101(off[:, 1:] - pad[1] + torch.arange(out_hw[1], device=dev), load_w)
    bi = torch.arange(full.shape[0], device=dev)[:, None, None]
    return torch.clamp(full[bi, rows[:, :, None], cols[:, None, :]], -1.0, 1.0)
