"""The layers the serving nets use, as ``nn.Module``s (counterpart of
``desr_tpu/models/layers.py``).

Parameters are float32 and are cast to the input's dtype at each call, as the
JAX layers cast theirs to ``ctx.dtype``; so a net runs in bf16 or float32 by
the dtype of what it is given. Conv weights are OIHW and transposed-conv
weights IOHW, so ``state_dict`` keys and shapes equal the JAX param dicts.

Plain ``torch.nn`` modules are used where they already have the semantics
(ReLU, LeakyReLU, Tanh), or subclassed where only the spatial axis needs
more (the pads, and Upsample: nearest, and bilinear with
align_corners=False, which is the JAX layer's ``resize_bilinear``).
BatchNorm, Dropout and the spectral-norm conv follow the JAX layers rather
than ``torch.nn``'s (see each): Dropout's mask is a pure function of a
seed, the step, the layer's ``state_dict`` prefix and the element's place
in the global batch, so a checkpoint's recompute, N ranks and S bands draw
one process's mask. The JAX package's XLA-steering variants of the
same functions (ring_pad, tap_conv, split_conv, fused_pad, phase_convt,
row_tap, fold_norm) are not ported.

The remat of ``--remat_blocks`` and ``--remat_tails`` (the JAX
``run_block_remat`` and ``Sequential._apply_remat_tails``, layers.py:374-460)
is ``run_layers``: each maximal run of primitive layers goes under one
``torch.utils.checkpoint``, whole (blocks) or saving the conv outputs
(tails); composite modules run outside and handle their own runs, and
BatchNorm stays outside every checkpoint.

Under ``--spatial_devices`` (``parallel/spatial.py``) a rank holds a band of
each frame's rows, and the layers that read across rows take a ``spatial``
tag (``set_spatial_group``): a conv or a pad takes the halo rows its window
reads from the neighbouring ranks and pads H only at the frame's edges, a
transposed conv crops its output to the rank's rows, and InstanceNorm and
GroupNorm sum their moments over the ranks. A conv with no padding of its
own and stride 1 reads rows that the pad before it already added (every
such conv in the nets follows a ReflectionPad2d or a ReplicationPad2d, or
is 1x1). A padded conv, ``Conv2d`` or ``SpectralNormConv2d``
(``conv_rows``), runs on a band only where its output is the input's
rows / stride (``band_rule``); the PatchGAN's 4x4 stride-1 tail, which
gives H - 1 rows, runs whole (``networks.NLayerDiscriminator``). In
training BatchNorm takes its moments over the step's group, data x
spatial. Every backward comes from autograd through the exchanges'
adjoints (``parallel/spatial.py``).
"""

from __future__ import annotations

import contextlib
import functools
import zlib

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from torch.nn import (  # noqa: F401  (re-exported for networks.py)
    Identity,
    LeakyReLU,
    ReLU,
    Tanh,
)

from desr_tpu_torch.ops import instance_norm as IN
from desr_tpu_torch.parallel import spatial as S
from desr_tpu_torch.parallel.mesh import all_reduce_sum
from desr_tpu_torch.parallel.spatial import set_spatial_group  # noqa: F401


def _cast(p, x):
    return None if p is None else p.to(x.dtype)


def conv_halo(k, stride, padding):
    """(rows above, rows below) beyond a rank's band that a conv's window
    reads, where its output is the input's rows / stride: output row y reads
    input rows y*stride - padding .. + k - 1 (3x3 s1 p1: (1, 1); 3x3 s2 p1:
    (1, 0); 4x4 s2 p1: (1, 1); 7x7 s1 p3: (3, 3))."""
    return padding, k - stride - padding


def convt_halo(k, stride, padding):
    """(rows above, rows below) of the input that a transposed conv's
    output band reads, where its output is the input's rows x stride
    (4x4 s2 p1: (1, 1); 3x3 s2 p1 with output_padding 1: (0, 1))."""
    return (k - 1 - padding) // stride, (stride - 1 + padding) // stride


def band_rule(k, stride, padding):
    """Whether a conv's output is its input's rows / stride for every H
    that stride divides (floor((H + 2p - k) / s) + 1 = H / s): then a
    rank's band with ``conv_halo`` rows gives the band's output rows."""
    return k - stride <= 2 * padding < k


def _rows_pad(x, sp, top, bottom, w_pads, mode):
    """x with ``top`` / ``bottom`` halo rows from its neighbours and the
    frame's edges padded by ``mode`` (zeros: "constant") to as many; W
    padded by ``w_pads`` = (left, right)."""
    x, ht, hb = S.exchange_rows(x, top, bottom, sp)
    pads = (*w_pads, top - ht, bottom - hb)
    if not any(pads):
        return x
    return F.pad(x, pads) if mode in ("zeros", "constant") else F.pad(x, pads, mode=mode)


def conv_rows(conv, x, w, b, plain):
    """``conv``'s output (a ``Conv2d`` or a ``SpectralNormConv2d``: its
    kernel_size, stride, padding, padding_mode, dilation and groups) of x
    with weight ``w`` and bias ``b``: ``plain(x, w, b)`` without an active
    ``spatial`` tag, or for a stride-1 conv with no H padding (its rows
    come with x, see the module); else the rank's band of rows, from
    ``conv_halo`` rows of its neighbours and H padded at the frame's edges."""
    sp = S.active(conv.spatial)
    (k, _), (stride, _), (p, pw) = conv.kernel_size, conv.stride, conv.padding
    if sp is None or (p == 0 and stride == 1):
        return plain(x, w, b)
    top, bottom = conv_halo(k, stride, p)
    if not band_rule(k, stride, p) or conv.dilation != (1, 1) or x.shape[2] % stride:
        raise NotImplementedError(
            f"a {k}x{k} stride-{stride} conv (padding {p}) on {x.shape[2]} rows a rank")
    mode = conv.padding_mode
    x = _rows_pad(x, sp, top, bottom, (0, 0) if mode == "zeros" else (pw, pw), mode)
    return F.conv2d(x, w, b, conv.stride, (0, pw) if mode == "zeros" else 0,
                    conv.dilation, conv.groups)


class Conv2d(nn.Conv2d):
    """torch Conv2d (zeros/reflect/replicate padding, stride) with f32 params;
    on a rank's band of rows under a ``spatial`` tag (``conv_rows``)."""

    spatial = None

    def forward(self, x):
        return conv_rows(self, x, self.weight.to(x.dtype), _cast(self.bias, x),
                         self._conv_forward)


class ConvTranspose2d(nn.ConvTranspose2d):
    """torch ConvTranspose2d (``output_padding``) with f32 params; under a
    ``spatial`` tag it reads ``convt_halo`` rows (zeros past the frame's
    edges) and crops its output to the rank's rows."""

    spatial = None

    def forward(self, x):
        w, b = self.weight.to(x.dtype), _cast(self.bias, x)
        sp = S.active(self.spatial)
        if sp is None:
            return F.conv_transpose2d(x, w, b, self.stride, self.padding, self.output_padding,
                                      self.groups, self.dilation)
        (k, _), (stride, _), (p, pw), (op, opw) = (self.kernel_size, self.stride,
                                                   self.padding, self.output_padding)
        if k + op - 2 * p != stride or self.dilation != (1, 1):
            raise NotImplementedError(f"a {k}x{k} stride-{stride} transposed conv whose "
                                      "output is not its input's rows x stride")
        h = x.shape[2]
        top, bottom = convt_halo(k, stride, p)
        x = _rows_pad(x, sp, top, bottom, (0, 0), "zeros")
        y = F.conv_transpose2d(x, w, b, self.stride, (0, pw), (0, opw), self.groups,
                               self.dilation)
        return y[:, :, top * stride + p:top * stride + p + h * stride]


class ReflectionPad2d(nn.ReflectionPad2d):
    """Reflect padding; under a ``spatial`` tag the rows at a seam between
    ranks come from the neighbour and only the frame's edges reflect."""

    spatial = None

    def forward(self, x):
        sp = S.active(self.spatial)
        if sp is None:
            return super().forward(x)
        left, right, top, bottom = self.padding
        return _rows_pad(x, sp, top, bottom, (left, right), "reflect")


class ReplicationPad2d(nn.ReplicationPad2d):
    """Replicate padding; rows at a seam as ``ReflectionPad2d``'s."""

    spatial = None

    def forward(self, x):
        sp = S.active(self.spatial)
        if sp is None:
            return super().forward(x)
        left, right, top, bottom = self.padding
        return _rows_pad(x, sp, top, bottom, (left, right), "replicate")


class Upsample(nn.Upsample):
    """torch Upsample by an integer factor. Under a ``spatial`` tag nearest
    keeps within each rank's rows; bilinear reads one row each side (the
    frame's edges replicated, as its clamp does) and crops."""

    spatial = None

    def forward(self, x):
        sp = S.active(self.spatial)
        f = self.scale_factor
        if sp is None or (self.mode == "nearest" and float(f) == int(f)):
            return super().forward(x)
        if self.mode != "bilinear" or self.align_corners or float(f) != int(f):
            raise NotImplementedError(f"Upsample {self.mode} x{f} on a rank's rows")
        f, h = int(f), x.shape[2]
        y = super().forward(_rows_pad(x, sp, 1, 1, (0, 0), "replicate"))
        return y[:, :, f:f + h * f]


_M32 = 0xFFFFFFFF


def _mul32(x, c):
    """x * c mod 2**32 for x in [0, 2**32) (a Python int or an int64
    tensor) and a constant c < 2**32, in 16-bit halves, so that no product
    leaves int64."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """A bijection of [0, 2**32) that scatters neighbouring inputs (the
    "lowbias32" integer finaliser: xorshift, multiply, xorshift, multiply,
    xorshift)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def dropout_key(seed, step, prefix):
    """The 32-bit key of a Dropout's mask: the model's ``seed``, the
    ``step`` and the layer's ``state_dict`` prefix, folded in as the JAX
    layer folds ``crc32(prefix) % 2**31`` into its step's key
    (desr_tpu/models/layers.py:1364-1375)."""
    key = _mix32(int(seed) & _M32)
    key = _mix32(key ^ (int(step) & _M32))
    return _mix32(key ^ (zlib.crc32(prefix.encode()) % 2 ** 31))


def dropout_keep(key, shape, rows, h_rows, device, p=0.5):
    """The bool keep mask of a rank's block of an NCHW tensor of ``shape``:
    element (b, c, y, x) of the global tensor is kept where
    mix(lo32(i) ^ mix(hi32(i) ^ key)) < (1 - p) * 2**32, i its row-major
    index in the global batch (``_mix32``). So the mask is the one drawn at
    the global shape and cut to the block, and no generator's state enters.

    ``rows`` = (lo, hi, n): the block's batch holds rows lo..hi of a global
    batch of n; a batch of k times hi - lo rows holds them for each of k
    branches concatenated along B (branch j's rows j*n + lo .. j*n + hi of
    a global k*n: the main model's batched syn and real calls).
    ``h_rows`` = (y0, h): the block's rows start at row y0 of frames of h
    rows (a spatial rank's band)."""
    b, c, hb, w = shape
    lo, hi, n = rows
    if b % (hi - lo):
        raise ValueError(f"a batch of {b} rows is no whole number of shares of rows {lo}..{hi}")
    k = b // (hi - lo)
    y0, h = h_rows
    ar = functools.partial(torch.arange, device=device, dtype=torch.int64)
    bi = torch.cat([ar(j * n + lo, j * n + hi) for j in range(k)])
    i = (((bi[:, None, None, None] * c + ar(c)[None, :, None, None]) * h
          + ar(y0, y0 + hb)[None, None, :, None]) * w + ar(w)[None, None, None, :])
    mixed = _mix32((i & _M32) ^ _mix32((i >> 32) ^ key))
    return mixed < round((1.0 - p) * 2 ** 32)


class Dropout(nn.Module):
    """The JAX layer's dropout (layers.py:1364-1375): the identity in eval
    and at p = 0; in training each value is kept with probability 1 - p and
    divided by 1 - p (x 2 at the nets' p = 0.5), or set to 0. No
    parameters, so no ``state_dict`` keys.

    The mask (``dropout_keep``) is a pure function of ``seed`` and ``step``
    (which the model sets, ``set_dropout_key``), of ``prefix``, the layer's
    ``state_dict`` prefix in its net (``name_dropouts``, which the net's
    builder calls), and of the element's place in the global batch. It does
    not read a generator, so a ``torch.utils.checkpoint`` recompute under
    ``--remat``, ``--remat_blocks`` or ``--remat_tails`` draws the forward's
    mask. ``rows`` (the model's staged ``Shard.rows``) places a rank's
    batch in the global one, and under a ``spatial`` tag the band's rows
    sit at rank x its rows in a frame of S times as many: N ranks and S
    bands draw one process's mask. Inside ``spatial.whole()`` (a U-Net
    level no rank splits) the tensor is the whole frame on every rank of
    the group, and so is its mask. A test may set ``mask`` (a keep mask of
    the input's shape) outright: then it is used as it is.
    """

    spatial = None
    seed = 0
    step = 0
    prefix = ""
    rows = None
    mask = None

    def __init__(self, p=0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = self.mask
        if keep is None:
            sp = S.active(self.spatial)
            h = x.shape[2]
            h_rows = (0, h) if sp is None else (sp.rank * h, sp.size * h)
            rows = self.rows or (0, x.shape[0], x.shape[0])
            keep = dropout_keep(dropout_key(self.seed, self.step, self.prefix), x.shape, rows,
                                h_rows, x.device, self.p)
        return torch.where(keep.to(x.device, torch.bool), x / (1.0 - self.p),
                           torch.zeros((), dtype=x.dtype, device=x.device))


def name_dropouts(net):
    """Set each ``Dropout``'s ``prefix`` to its ``state_dict`` prefix in
    ``net`` (the JAX layer's ``prefix``); returns ``net``."""
    for name, m in net.named_modules():
        if isinstance(m, Dropout):
            m.prefix = name + "."
    return net


def set_dropout_key(module, seed, step, rows=None):
    """Set the ``seed``, the ``step`` and the ``rows`` = (lo, hi, n) of the
    global batch the rank holds (None: the whole batch) on every
    ``Dropout`` of ``module``."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.seed, m.step, m.rows = seed, step, None if rows is None else tuple(rows)


def frame_moments(s, s2, n, spatial):
    """(s, s2, n) of a rank's band as the whole frame's: the stacked sums in
    one all_reduce over the spatial group and n x S, where ``spatial`` is
    active; else as given."""
    sp = S.active(spatial)
    if sp is None:
        return s, s2, n
    s, s2 = S.reduce_sum(torch.stack([s, s2]), sp).unbind(0)
    return s, s2, n * sp.size


class InstanceNorm2d(nn.Module):
    """affine=False, no running stats, eps 1e-5 (layers.py:1129-1161).

    One-pass moments as in the JAX layer: var = max(E[x^2] - E[x]^2, 0) from
    f32 sums. Against a two-pass variance this loses digits only where
    |mean| >> std; the port's tests hold it to the JAX layer at 1e-5 abs in
    float32. Under a ``spatial`` tag the sums are the frame's
    (``frame_moments``), all-reduced between the moments and the apply.

    Where no gradient flows the moments and the normalisation are K4's two
    operators (``ops/instance_norm.py``; on the card the kernels, which
    normalise in f32 and round once); else the plain versions, which
    normalise in the input's dtype. ``relu=True`` applies the ReLU that
    follows the norm in the same pass (``run_layers`` passes it).
    """

    spatial = None

    def __init__(self, num_features, eps=1e-5):
        super().__init__()
        self.num_features = num_features
        self.eps = eps

    def forward(self, x, relu=False):
        if IN.kernel_route(x):
            x = IN.dense(x)
        s, s2 = IN.instance_norm_moments(x)
        s, s2, n = frame_moments(s, s2, x.shape[2] * x.shape[3], self.spatial)
        return IN.norm_apply(x, s, s2, n, self.eps, relu)


class GroupNorm(nn.Module):
    """GroupNorm, eps 1e-5 (layers.py:1203-1248); the translation lineage's
    is GroupNorm(8, affine=True) with keys ``weight`` and ``bias``.

    One-pass moments per (batch, group) in f32 as in the JAX layer, the
    normalisation and the affine in the input's dtype; the frame's under a
    ``spatial`` tag (``frame_moments``).
    """

    spatial = None

    def __init__(self, num_groups, num_channels, affine=True, eps=1e-5):
        super().__init__()
        self.g, self.c, self.affine, self.eps = num_groups, num_channels, affine, eps
        if affine:
            self.weight = nn.Parameter(torch.ones(num_channels))
            self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        b, c, h, w = x.shape
        xg = x.reshape(b, self.g, c // self.g, h, w)
        x32 = xg.float()
        s, s2, n = frame_moments(x32.sum(dim=(2, 3, 4), keepdim=True),
                                 x32.square().sum(dim=(2, 3, 4), keepdim=True),
                                 xg[0, 0].numel(), self.spatial)
        mean, meansq = s / n, s2 / n
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
        raise NotImplementedError(f"norm_vectors for {type(norm).__name__}: K1's chain folds "
                                  "InstanceNorm and GroupNorm only")
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
    that split the batch, along B or, under ``--spatial_devices``, along H)
    the train-mode moments are the global batch's, as GSPMD computes them
    in the JAX package: the per-channel sum, sum of squares and count are
    summed over the ranks in one differentiable all_reduce, and the mean
    and biased variance taken from them in one pass (E[x^2] - E[x]^2,
    clamped at 0, as InstanceNorm's here); the running variance's unbiased
    factor uses the global count. Under a ``spatial`` tag inside
    ``spatial.whole()`` (a level no rank splits) the S ranks of a data
    group hold the same whole tensor, so the moments are summed over
    ``whole_group`` instead, the ranks that split the batch along B.
    ``torch.nn.SyncBatchNorm`` does not serve: it refuses CPU tensors.
    """

    group = None
    whole_group = None
    spatial = None

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
        whole = self.spatial is not None and S.active(self.spatial) is None
        group = self.whole_group if whole else self.group
        if train and group is None:
            var, mean = torch.var_mean(x32, dim=(0, 2, 3), unbiased=False)
        elif train:
            sums = all_reduce_sum(torch.stack([
                x32.sum(dim=(0, 2, 3)), x32.square().sum(dim=(0, 2, 3)),
                x32.new_full((self.c,), float(n))]), group)
            n = sums[2]
            mean = sums[0] / n
            var = torch.clamp(sums[1] / n - mean.square(), min=0.0)
        if track:
            with torch.no_grad():
                # a global count is a tensor (read without a sync)
                unbiased = (var * (n / (n - 1).clamp(min=1)) if torch.is_tensor(n)
                            else var * (n / (n - 1)) if n > 1 else var)
                m = self.momentum
                self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
                self.running_var.copy_((1 - m) * self.running_var + m * unbiased)
                self.num_batches_tracked += 1
        if not train:
            mean, var = self.running_mean, self.running_var
        out = (x32 - mean[:, None, None]) * torch.rsqrt(var + self.eps)[:, None, None]
        return (out * self.weight[:, None, None] + self.bias[:, None, None]).to(x.dtype)


def set_batch_norm_group(module, group, whole_group=None):
    """The process groups over which every ``BatchNorm2d`` in ``module``
    takes its train-mode moments (None: the local batch's): ``group``, and
    ``whole_group`` on a tensor that the spatial ranks hold whole (a
    ``spatial``-tagged BatchNorm inside ``spatial.whole()``)."""
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.group, m.whole_group = group, whole_group


class SpectralNormConv2d(nn.Module):
    """Conv2d (zeros padding) with its weight divided by its largest singular
    value, as the JAX layer computes it (layers.py:1419-1472), which is not
    ``torch.nn.utils.spectral_norm``: each forward runs ``n_iters`` = 3 power
    iterations from the STORED ``weight_u`` under no-grad and never writes u
    back, then sigma = u . (W v) with the gradient through W alone. Keys
    ``weight_orig``, ``bias``, ``weight_u`` and ``weight_v``; ``reset_uv``
    converges u and v for a fresh weight, as the JAX init does.

    Under a ``spatial`` tag the conv runs on the rank's band by ``Conv2d``'s
    rule and halo rows (``conv_rows``). The power iteration reads only the
    weight and the stored ``weight_u``, which are alike on every rank, so
    every rank computes the same sigma with no collective.
    """

    n_iters = 3
    n_init_iters = 30
    spatial = None
    padding_mode, dilation, groups = "zeros", (1, 1), 1

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, padding=0, bias=True):
        super().__init__()
        self.kernel_size = (kernel_size, kernel_size)
        self.stride, self.padding = (stride, stride), (padding, padding)
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
        return conv_rows(self, x, w_sn.to(x.dtype), _cast(self.bias, x), self._plain)

    def _plain(self, x, w, b):
        return F.conv2d(x, w, b, self.stride, self.padding)


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
    nets, eval forwards) it is the plain call. Nothing inside draws from a
    generator (a Dropout's mask is a pure function, ``dropout_keep``), so
    no RNG state is kept.

    On a rank's band (``--spatial_devices``) the recompute runs in the
    spatial state of the first forward (``spatial.replay``: inside or
    outside ``whole()``, which also picks a BatchNorm's group), and issues
    the span's collectives again, in the forward's order on every rank
    (counted as ``exchange_remat``, ``gather_remat``, ``all_reduce_remat``).
    Under "tails" an exchange's output is recomputed, not saved: the policy
    keeps only the convs' outputs, and a conv's padded input, which its
    backward reads, is rebuilt from the exchange's rows, so each exchange
    in the span is one more ``all_gather`` in the backward on every rank.
    """
    if mode is None or not torch.is_grad_enabled():
        return fn(*args)
    kw = {"context_fn": functools.partial(create_selective_checkpoint_contexts,
                                          _save_conv_outputs)} if mode == "tails" else {}
    return checkpoint(S.replay(fn), *args, use_reentrant=False, preserve_rng_state=False, **kw)


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
    """Apply ``layers`` in order; an ``InstanceNorm2d`` followed by a ``ReLU``
    takes the ReLU into its own pass."""
    i = 0
    while i < len(layers):
        layer = layers[i]
        if isinstance(layer, InstanceNorm2d) and i + 1 < len(layers) \
                and isinstance(layers[i + 1], ReLU):
            x = layer(x, relu=True)
            i += 2
        else:
            x = layer(x)
            i += 1
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
