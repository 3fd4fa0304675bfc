"""The layers the serving nets use, as ``nn.Module``s (counterpart of
``desr_tpu/models/layers.py``).

Parameters are float32 and are cast to the input's dtype at each call, as the
JAX layers cast theirs to ``ctx.dtype``; so a net runs in bf16 or float32 by
the dtype of what it is given. Conv weights are OIHW and transposed-conv
weights IOHW, so ``state_dict`` keys and shapes equal the JAX param dicts.

Plain ``torch.nn`` modules are used where they already have the semantics
(ReLU, LeakyReLU, Tanh, the pads, nearest Upsample, Dropout). The JAX package's
XLA-steering variants of the same functions (ring_pad, tap_conv, split_conv,
fused_pad, phase_convt, row_tap, fold_norm) are not ported.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from torch.nn import (  # noqa: F401  (re-exported for networks.py)
    Dropout,
    Identity,
    LeakyReLU,
    ReflectionPad2d,
    ReLU,
    ReplicationPad2d,
    Tanh,
    Upsample,
)


def _cast(p, x):
    return None if p is None else p.to(x.dtype)


class Conv2d(nn.Conv2d):
    """torch Conv2d (zeros/reflect/replicate padding, stride) with f32 params."""

    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype), _cast(self.bias, x))


class ConvTranspose2d(nn.ConvTranspose2d):
    """torch ConvTranspose2d (``output_padding``) with f32 params."""

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight.to(x.dtype), _cast(self.bias, x),
                                  self.stride, self.padding, self.output_padding,
                                  self.groups, self.dilation)


def moments_hw(x):
    """(sum, sum of squares) over H and W of an NCHW tensor, in f32: (B, C) each."""
    x32 = x.float()
    return x32.sum(dim=(2, 3)), x32.square().sum(dim=(2, 3))


class InstanceNorm2d(nn.Module):
    """affine=False, no running stats, eps 1e-5 (layers.py:1129-1161).

    One-pass moments as in the JAX layer: var = max(E[x^2] - E[x]^2, 0) from
    f32 sums, and the normalisation itself in the input's dtype. Against a
    two-pass variance this loses digits only where |mean| >> std; the port's
    tests hold it to the JAX layer at 1e-5 abs in float32.
    """

    def __init__(self, num_features, eps=1e-5):
        super().__init__()
        self.num_features = num_features
        self.eps = eps

    def forward(self, x):
        n = x.shape[2] * x.shape[3]
        s, s2 = moments_hw(x)
        mean = s / n
        var = torch.clamp(s2 / n - mean.square(), min=0.0)
        scale = torch.rsqrt(var + self.eps).to(x.dtype)[:, :, None, None]
        return (x - mean.to(x.dtype)[:, :, None, None]) * scale


class GroupNorm(nn.Module):
    """GroupNorm, eps 1e-5 (layers.py:1203-1248); the translation lineage's
    is GroupNorm(8, affine=True) with keys ``weight`` and ``bias``.

    One-pass moments per (batch, group) in f32 as in the JAX layer, the
    normalisation and the affine in the input's dtype.
    """

    def __init__(self, num_groups, num_channels, affine=True, eps=1e-5):
        super().__init__()
        self.g, self.c, self.affine, self.eps = num_groups, num_channels, affine, eps
        if affine:
            self.weight = nn.Parameter(torch.ones(num_channels))
            self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        b, c, h, w = x.shape
        xg = x.reshape(b, self.g, c // self.g, h, w)
        n = xg[0, 0].numel()
        x32 = xg.float()
        mean = x32.sum(dim=(2, 3, 4), keepdim=True) / n
        meansq = x32.square().sum(dim=(2, 3, 4), keepdim=True) / n
        var = torch.clamp(meansq - mean.square(), min=0.0)
        scale = torch.rsqrt(var + self.eps).to(x.dtype)
        out = ((xg - mean.to(x.dtype)) * scale).reshape(b, c, h, w)
        if self.affine:
            out = out * self.weight.to(x.dtype)[:, None, None] + self.bias.to(x.dtype)[:, None, None]
        return out


def norm_vectors(norm, s, s2, n, bias=None):
    """Per-(batch, channel) f32 (scale, shift) with norm(x + bias) == x * scale + shift.

    ``s``/``s2`` are the one-pass moments of the BIAS-LESS x over n pixels, as
    the fused conv kernel emits them; folding the bias here is exact
    (layers.py:1164-1200). For GroupNorm the moments pool over each group's
    channels, and an affine weight and bias fold into the vectors too.
    """
    if not isinstance(norm, (InstanceNorm2d, GroupNorm)):
        raise NotImplementedError(f"norm_vectors for {type(norm).__name__}: not yet ported")
    s, s2 = s.float(), s2.float()
    if bias is not None:
        b = bias.float()
        s2 = s2 + 2.0 * b * s + n * b.square()
        s = s + n * b
    else:
        b = 0.0
    if isinstance(norm, GroupNorm):
        bsz, c = s.shape
        cs = c // norm.g
        mean = (s.reshape(bsz, norm.g, cs).sum(-1) / (n * cs)).repeat_interleave(cs, dim=1)
        meansq = (s2.reshape(bsz, norm.g, cs).sum(-1) / (n * cs)).repeat_interleave(cs, dim=1)
    else:
        mean, meansq = s / n, s2 / n
    var = torch.clamp(meansq - mean.square(), min=0.0)
    inv = torch.rsqrt(var + norm.eps)
    scale, shift = inv, (b - mean) * inv
    if getattr(norm, "affine", False):
        scale = scale * norm.weight.float()
        shift = shift * norm.weight.float() + norm.bias.float()
    return scale, shift


def get_norm_layer(norm_type, lineage="pix2pix"):
    """(factory(ch) -> module, use_bias for convs) (layers.py:1393).

    Convs carry a bias only with instance norm (or none). GroupNorm has 8
    groups, affine in the translation lineage and not in the pix2pix one.
    BatchNorm comes with a later slice.
    """
    if norm_type == "instance":
        return InstanceNorm2d, True
    if norm_type == "none":
        return (lambda ch: Identity()), True
    if norm_type == "group":
        affine = lineage == "translation"
        return (lambda ch: GroupNorm(8, ch, affine=affine)), False
    if norm_type == "batch":
        raise NotImplementedError(f"norm {norm_type!r}: not yet ported")
    raise NotImplementedError(f"norm layer {norm_type}")
