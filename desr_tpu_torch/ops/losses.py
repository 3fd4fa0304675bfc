"""The losses of stages 1, 2 and 3, planar (counterpart of ``desr_tpu/ops/losses.py``).

Depth maps are (B, H, W), normal and image maps (B, C, H, W); each loss
returns a scalar. The masked (task, holes, holes_l2) triplets of stage 3 run
on the K3 kernel (``ops/masked_loss.py``); stage 2's masked L1s are plain
sums, as in the JAX package.

Over data-parallel ranks (``desr_tpu_torch/parallel``) each rank's loss is N
times its share of the global one, so that the ranks' mean gradient is the
global gradient. A mean over the equal shards already is, and needs nothing.
The losses whose value is not such a mean take ``group``, the process group
of the N ranks that hold distinct parts of the batch (the model's
``step_group``; None: one process, the batch's own value):
``masked_l1_loss`` and ``masked_cos_sim_loss_planar`` divide by the global
mask count, ``tv_loss_planar``'s sum is scaled by N.

Under ``--spatial_devices`` the maps are a rank's band of each frame's
rows (the rule above reads over all N = data x spatial ranks): the TV
losses take ``spatial`` and count the row difference at a seam once, on
the upper rank, from one row of the rank below; the smoothness loss,
whose align-corners pyramid reads rows that no band holds, gathers its
maps along H and runs whole on every rank. K3's masked means
(``ops/masked_loss.py``) are means over the rank's equal band.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from desr_tpu_torch.ops.normals import safe_norm
from desr_tpu_torch.parallel import spatial as S
from desr_tpu_torch.parallel.mesh import all_reduce_sum, group_size


def l1_loss(x, y):
    return (x - y).abs().mean()


def mse_loss(x, y):
    return (x - y).square().mean()


def _over_count(total, count, eps, group):
    """total / (count + eps); over ``group``'s N ranks N total over the
    global count."""
    if group is None:
        return total / (count + eps)
    return total * group_size(group) / (all_reduce_sum(count, group) + eps)


def masked_l1_loss(x, y, mask, eps=1e-6, group=None):
    """sum(|y - x| * mask) / (sum(mask) + eps) (losses.py:31); over ``group``
    N times this rank's sum over the global count."""
    mask = mask.to(x.dtype)
    return _over_count(((y - x).abs() * mask).sum(), mask.sum(), eps, group)


def _below(x, spatial):
    """x with the first row of the rank below appended along H (none at
    the frame's bottom), under an active ``spatial``; else x."""
    sp = S.active(spatial)
    return x if sp is None else S.exchange_rows(x, 0, 1, sp, dim=x.dim() - 2)[0]


def tv_norm_planar(x, spatial=None):
    """TV_norm of (B, C, H, W) maps over their first two channels, divided by
    their size (losses.py:226). On a rank's equal band (``spatial``) the
    global size is N times the band's, so the band's sum over its own size
    is N times its share of the frame's value."""
    x = x[:, :2]
    xh = _below(x, spatial)
    tv_h = (xh[..., 1:, :] - xh[..., :-1, :]).square().sum()
    tv_w = (x[..., :, 1:] - x[..., :, :-1]).square().sum()
    return (tv_h + tv_w) / x.numel()


def _cos_planar(x, y, eps):
    nx = torch.clamp(safe_norm(x, dim=1, keepdim=False), min=eps)
    ny = torch.clamp(safe_norm(y, dim=1, keepdim=False), min=eps)
    return (x * y).sum(dim=1) / (nx * ny)


def cos_sim_loss_planar(x, y, eps=1e-8):
    """mean(1 - cos) over channel axis 1 of (B, C, H, W) maps (losses.py:236)."""
    return (1.0 - _cos_planar(x, y, eps)).mean()


def masked_cos_sim_loss_planar(x, y, mask_b3hw, eps=1e-8, group=None):
    """sum((1 - cos) * mask) / (sum(mask) + 1e6) on (B, C, H, W) maps with a
    (B, C, H, W) mask (losses.py:246, the as-shipped ``compat_bug=True``
    denominator); over ``group`` N times this rank's sum over the global
    count."""
    loss = (1.0 - _cos_planar(x, y, eps))[:, None]
    mask = mask_b3hw.to(x.dtype)
    return _over_count((loss * mask).sum(), mask.sum(), 1e6, group)


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


def tv_loss_planar(img, group=None, spatial=None):
    """Unnormalised total variation over the last two dims (losses.py:219);
    over ``group`` N times this rank's sum, the seam below a band counted
    on its rank (``spatial``)."""
    w_var = (img[..., :, :-1] - img[..., :, 1:]).square().sum()
    ih = _below(img, spatial)
    h_var = (ih[..., :-1, :] - ih[..., 1:, :]).square().sum()
    return h_var + w_var if group is None else (h_var + w_var) * group_size(group)


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


def smooth_weight_loss_planar(depth_bhw, image_b3hw, num_scales=3, spatial=None):
    """Image-gradient-weighted depth smoothness (losses.py:282): at each scale
    of the pyramid (smallest first, the i-th divided by 2^i), mean |grad d|
    weighted by exp(-mean_c |grad image|), along rows and columns. Under an
    active ``spatial`` both maps are gathered along H (one and three
    channels) and the loss is the whole frames', alike on the group's
    ranks."""
    sp = S.active(spatial)
    if sp is not None:
        depth_bhw, image_b3hw = S.gather_h(depth_bhw, sp, 1), S.gather_h(image_b3hw, sp, 2)
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


def gradient_penalty(d_apply, real, fake, generator=None, gp_type="mixed", constant=1.0,
                     lambda_gp=10.0, eps=1e-16):
    """WGAN-GP gradient penalty (losses.py:155-177; networks.py:282-316 of
    the reference, which no shipped config calls). ``d_apply`` maps an NHWC
    batch to logits; ``gp_type`` "real" and "fake" take the gradient at that
    batch, "mixed" at ``alpha * real + (1 - alpha) * fake`` with one alpha a
    sample drawn from ``generator`` (U[0, 1), on real's device). Returns
    (penalty, the gradient at the interpolate); the penalty is
    differentiable in D's weights (and, through ``fake``, in G's)."""
    if lambda_gp <= 0.0:
        return torch.zeros((), device=real.device), None
    if gp_type == "real":
        interp = real
    elif gp_type == "fake":
        interp = fake
    elif gp_type == "mixed":
        alpha = torch.rand((real.shape[0], 1, 1, 1), generator=generator, device=real.device,
                           dtype=real.dtype)
        interp = alpha * real + (1 - alpha) * fake
    else:
        raise NotImplementedError(gp_type)
    if not interp.requires_grad:
        interp = interp.detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(d_apply(interp).sum(), interp, create_graph=True)
    norm = torch.linalg.vector_norm(grads.reshape(real.shape[0], -1) + eps, dim=1)
    return (norm - constant).square().mean() * lambda_gp, grads
