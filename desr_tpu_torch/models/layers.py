"""The layers the serving nets use, as ``nn.Module``s (counterpart of
``desr_tpu/models/layers.py``).

Parameters are float32 and are cast to the input's dtype at each call, as the
JAX layers cast theirs to ``ctx.dtype``; so a net runs in bf16 or float32 by
the dtype of what it is given. Conv weights are OIHW and transposed-conv
weights IOHW, so ``state_dict`` keys and shapes equal the JAX param dicts.

Plain ``torch.nn`` modules are used where they already have the semantics
(ReLU, LeakyReLU, Tanh, the pads, Dropout, and Upsample: nearest, and bilinear
with align_corners=False, which is the JAX layer's ``resize_bilinear``).
BatchNorm and the spectral-norm conv follow the JAX layers rather than
``torch.nn``'s (see each). The JAX package's XLA-steering variants of the
same functions (ring_pad, tap_conv, split_conv, fused_pad, phase_convt,
row_tap, fold_norm) are not ported.

The remat of ``--remat_blocks`` and ``--remat_tails`` (the JAX
``run_block_remat`` and ``Sequential._apply_remat_tails``, layers.py:374-460)
is ``run_layers``: each maximal run of primitive layers goes under one
``torch.utils.checkpoint``, whole (blocks) or saving the conv outputs
(tails); composite modules run outside and handle their own runs, and
BatchNorm stays outside every checkpoint.
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

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

from desr_tpu_torch.parallel.mesh import all_reduce_sum


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


_BN_MODE = []  # the (train, track) of the innermost batch_norm_mode


@contextlib.contextmanager
def batch_norm_mode(train, track=False):
    """Every ``BatchNorm2d`` called inside normalises with the batch's
    moments when ``train`` (else with its running statistics) and moves its
    running statistics only when ``track`` too: the JAX ``Ctx(train=...)``
    and its ``stats`` sink (layers.py:1251-1300). Outside any such context a
    BatchNorm follows its module's ``training`` flag for both (the
    translation discriminators, which the JAX package always runs in train
    mode with a sink)."""
    _BN_MODE.append((bool(train), bool(train and track)))
    try:
        yield
    finally:
        _BN_MODE.pop()


class BatchNorm2d(nn.Module):
    """affine BatchNorm with running statistics (layers.py:1251-1308).

    In train mode it normalises with the batch's mean and biased variance,
    and where it tracks, moves the running statistics by torch's momentum
    0.1, the running variance from the unbiased batch variance (repeated
    forwards in one step chain, as the JAX sink does); in eval mode it uses
    the running statistics. ``batch_norm_mode`` sets the mode, else the
    module's ``training`` flag does. The statistics and the affine run in f32
    and the result is rounded to the input's dtype. Keys ``weight``,
    ``bias``, ``running_mean``, ``running_var`` and ``num_batches_tracked``
    (int64).

    With a process group in ``group`` (``set_batch_norm_group``: the ranks
    that split the batch) the train-mode moments are the global batch's, as
    GSPMD computes them in the JAX package: the per-channel sum, sum of
    squares and count are summed over the ranks in one differentiable
    all_reduce, and the mean and biased variance taken from them in one
    pass (E[x^2] - E[x]^2, clamped at 0, as InstanceNorm's here); the
    running variance's unbiased factor uses the global count.
    ``torch.nn.SyncBatchNorm`` does not serve: it refuses CPU tensors.
    """

    group = None

    def __init__(self, num_features, eps=1e-5, momentum=0.1):
        super().__init__()
        self.c, self.eps, self.momentum = num_features, eps, momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def forward(self, x):
        x32 = x.float()
        train, track = _BN_MODE[-1] if _BN_MODE else (self.training, self.training)
        n = x32.numel() // self.c
        if train and self.group is None:
            var, mean = torch.var_mean(x32, dim=(0, 2, 3), unbiased=False)
        elif train:
            sums = all_reduce_sum(torch.stack([
                x32.sum(dim=(0, 2, 3)), x32.square().sum(dim=(0, 2, 3)),
                x32.new_full((self.c,), float(n))]), self.group)
            n = sums[2]
            mean = sums[0] / n
            var = torch.clamp(sums[1] / n - mean.square(), min=0.0)
        if track:
            with torch.no_grad():
                # a global count (a tensor) spans at least two ranks' pixels
                unbiased = var * (n / (n - 1)) if torch.is_tensor(n) or n > 1 else var
                m = self.momentum
                self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
                self.running_var.copy_((1 - m) * self.running_var + m * unbiased)
                self.num_batches_tracked += 1
        if not train:
            mean, var = self.running_mean, self.running_var
        out = (x32 - mean[:, None, None]) * torch.rsqrt(var + self.eps)[:, None, None]
        return (out * self.weight[:, None, None] + self.bias[:, None, None]).to(x.dtype)


def set_batch_norm_group(module, group):
    """The process group over which every ``BatchNorm2d`` in ``module``
    takes its train-mode moments (None: the local batch's)."""
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.group = group


class SpectralNormConv2d(nn.Module):
    """Conv2d (zeros padding) with its weight divided by its largest singular
    value, as the JAX layer computes it (layers.py:1419-1472), which is not
    ``torch.nn.utils.spectral_norm``: each forward runs ``n_iters`` = 3 power
    iterations from the STORED ``weight_u`` under no-grad and never writes u
    back, then sigma = u . (W v) with the gradient through W alone. Keys
    ``weight_orig``, ``bias``, ``weight_u`` and ``weight_v``; ``reset_uv``
    converges u and v for a fresh weight, as the JAX init does.
    """

    n_iters = 3
    n_init_iters = 30

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, padding=0, bias=True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight_orig = nn.Parameter(torch.zeros(out_ch, in_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.register_buffer("weight_u", torch.zeros(out_ch))
        self.register_buffer("weight_v", torch.zeros(in_ch * kernel_size * kernel_size))

    @staticmethod
    def _power(wm, u, iters):
        for _ in range(iters):
            v = F.normalize(wm.t() @ u, dim=0, eps=1e-12)
            u = F.normalize(wm @ v, dim=0, eps=1e-12)
        return u, v

    @torch.no_grad()
    def reset_uv(self, generator=None):
        """u from N(0, 1), normalised, then ``n_init_iters`` power iterations."""
        wm = self.weight_orig.reshape(self.weight_orig.shape[0], -1)
        u = torch.randn(wm.shape[0], generator=generator).to(wm.device)
        u, v = self._power(wm, u / u.norm(), self.n_init_iters)
        self.weight_u.copy_(u)
        self.weight_v.copy_(v)

    def forward(self, x):
        w = self.weight_orig
        wm = w.reshape(w.shape[0], -1)
        with torch.no_grad():
            u, v = self._power(wm, self.weight_u, self.n_iters)
        w_sn = w / (u @ (wm @ v))
        return F.conv2d(x, w_sn.to(x.dtype), _cast(self.bias, x), self.stride, self.padding)


def get_norm_layer(norm_type, lineage="pix2pix"):
    """(factory(ch) -> module, use_bias for convs) (layers.py:1393).

    Convs carry a bias only with instance norm (or none). GroupNorm has 8
    groups, affine in the translation lineage and not in the pix2pix one.
    BatchNorm is the JAX layer's (see ``batch_norm_mode``).
    """
    if norm_type == "batch":
        return BatchNorm2d, False
    if norm_type == "instance":
        return InstanceNorm2d, True
    if norm_type == "none":
        return (lambda ch: Identity()), True
    if norm_type == "group":
        affine = lineage == "translation"
        return (lambda ch: GroupNorm(8, ch, affine=affine)), False
    raise NotImplementedError(f"norm layer {norm_type}")


# -- remat (--remat, --remat_blocks, --remat_tails) ----------------------------

@functools.cache
def _conv_ops():
    from desr_tpu_torch.ops import conv3x3  # noqa: F401  (registers desr::)

    return (torch.ops.aten.convolution.default, torch.ops.desr.conv3x3_fused.default,
            torch.ops.desr.conv3x3.default)


def _save_conv_outputs(ctx, op, *args, **kwargs):
    """The ``--remat_tails`` policy: keep what the convolutions (cuDNN's, K1,
    K2) return, recompute everything else in the backward."""
    return CheckpointPolicy.MUST_SAVE if op in _conv_ops() \
        else CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(fn, mode, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` (non-reentrant) when
    ``mode`` is set and a gradient is being recorded: "blocks" (or "net")
    keeps only the inputs and recomputes all of ``fn`` in the backward;
    "tails" also keeps the conv outputs (a selective-checkpoint policy), so
    only the norms and activations are recomputed. Under no_grad (frozen
    nets, eval forwards) it is the plain call. Nothing inside draws random
    numbers, so no RNG state is kept."""
    if mode is None or not torch.is_grad_enabled():
        return fn(*args)
    kw = {"context_fn": functools.partial(create_selective_checkpoint_contexts,
                                          _save_conv_outputs)} if mode == "tails" else {}
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)


def with_batch_norm_mode(fn, train, track=False):
    """``fn`` that enters ``batch_norm_mode(train, track)`` itself, so that a
    checkpoint's recompute (which runs in the backward, outside the caller's
    context) normalises as the first forward did."""
    def run(*args):
        with batch_norm_mode(train, track):
            return fn(*args)
    return run


def _is_primitive(layer):
    """A layer ``run_layers`` may put under a checkpoint: not a BatchNorm
    (its running statistics must not move in a recompute) and not a
    composite (``remat`` attribute: it handles its own runs)."""
    return not isinstance(layer, BatchNorm2d) and not hasattr(layer, "remat")


def _run_span(layers, x):
    for layer in layers:
        x = layer(x)
    return x


def run_layers(layers, x, mode):
    """Apply ``layers`` (modules or callables) in order; with a remat
    ``mode`` ("blocks" or "tails") each maximal run of primitive layers goes
    through ``remat_call`` as one span (layers.py:374-460)."""
    layers = list(layers)
    if mode is None or not torch.is_grad_enabled():
        return _run_span(layers, x)
    i, n = 0, len(layers)
    while i < n:
        if not _is_primitive(layers[i]):
            x = layers[i](x)
            i += 1
            continue
        j = i
        while j < n and _is_primitive(layers[j]):
            j += 1
        x = remat_call(functools.partial(_run_span, layers[i:j]), mode, x)
        i = j
    return x


def set_remat(net, mode):
    """Set the remat ``mode`` (None, "blocks" or "tails") on every composite
    of ``net`` that reads one; returns ``net``."""
    for m in net.modules():
        if hasattr(m, "remat"):
            m.remat = mode
    return net
