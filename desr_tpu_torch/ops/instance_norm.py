"""InstanceNorm's moments and its normalisation in two kernels (K4).

K4 replaces no Pallas kernel: on the TPU, XLA fused the JAX package's
InstanceNorm (``desr_tpu/models/layers.py:1129-1161``) and the ResnetBlock
chain's last multiply-add and skip into the passes around them, where eager
PyTorch runs each norm as about seven full-size passes. Two operators:

- ``instance_norm_moments(x) -> (s, s2)``: the f32 per-(b, c) sums of x and
  of x^2 over H and W, from one read of x, summed in a fixed order;
- ``norm_apply(x, a, b, n, eps, relu, skip)``: ``[relu](x * scale + shift)
  [+ skip]`` in f32, rounded once to x's dtype, in x's memory format; with
  ``n`` the per-(b, c) mean and 1 / std come from the moments ``(a, b) = (s,
  s2)`` over n values inside the kernel (the one-pass variance
  ``max(E[x^2] - E[x]^2, 0)`` of the JAX layer, then ``(x - mean) / std``),
  without it ``(a, b)`` are the (scale, shift) of ``layers.norm_vectors``.

The kernels are ``desr_tpu_torch/csrc/instance_norm.cu`` (built with nvcc for
sm_90a on the first CUDA call, loaded with ctypes); both read x as
NCHW-contiguous ("planes") or channels_last ("pixels") and raise on any
other layout. Both are bytes-bound: see the source's note.

K4 takes a call where no gradient flows (``kernel_route``): under
``no_grad``, or where no input requires one. There the wrappers call the
``desr::`` operators, so ``torch.export`` keeps each as one node of the
serving artifact (``desr_tpu_torch/serving.py``); on a CUDA tensor an
operator launches its kernel or raises, on a CPU tensor it runs the plain
version. Where a gradient flows the wrappers run the plain versions, which
are the layers' arithmetic as it was before K4 (``InstanceNorm2d``'s
normalisation in the input's dtype, the chain's tail rounded before its
skip), bit for bit. The norm's backward is autograd's through them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from desr_tpu_torch.ops.masked_loss import _on_device

DTYPES = (torch.float32, torch.bfloat16)
PLANES, PIXELS = 0, 1    # NCHW-contiguous x, channels_last x
NTHREADS = 256           # the kernels' block
SLICE = 128              # channels a pixels block covers
MOMENTS_UNROLL = 4       # vectors a thread of the moments loads at once
BLOCKS_PER_SM = 8        # the grid a plan aims at, where the values allow
MAX_SPLITS = 64          # blocks a plane at most


def kernel_route(*tensors):
    """Whether K4 takes the call: no gradient flows through any of
    ``tensors`` (None entries ignored)."""
    return not (torch.is_grad_enabled()
                and any(t is not None and t.requires_grad for t in tensors))


def dense(x):
    """x itself where it is NCHW-contiguous or channels_last, else a copy in
    the order its strides give (a rank's band of a transposed conv's output
    is a view): the layout the plain version's output would have."""
    if x.is_contiguous() or x.is_contiguous(memory_format=torch.channels_last):
        return x
    fmt = torch.channels_last if x.stride(1) < x.stride(3) else torch.contiguous_format
    return x.contiguous(memory_format=fmt)


def instance_norm_moments_plain(x):
    """(sum, sum of squares) over H and W of an NCHW tensor, in f32: (B, C) each."""
    x32 = x.float()
    return x32.sum(dim=(2, 3)), x32.square().sum(dim=(2, 3))


def norm_apply_plain(x, a, b, n=None, eps=1e-5, relu=False, skip=None):
    """Plain PyTorch version of ``norm_apply``. With ``n``: InstanceNorm's
    normalisation from the moments, in x's dtype (mean and 1 / std rounded
    to it); without: ``(x * a + b)`` in f32 rounded to x's dtype. Then
    [relu], then [skip +]."""
    if n is not None:
        mean = a / n
        var = torch.clamp(b / n - mean.square(), min=0.0)
        scale = torch.rsqrt(var + eps).to(x.dtype)[:, :, None, None]
        out = (x - mean.to(x.dtype)[:, :, None, None]) * scale
        if relu:
            out = torch.relu(out)
    else:
        v = x.float() * a[:, :, None, None] + b[:, :, None, None]
        out = (torch.relu(v) if relu else v).to(x.dtype)
    return out if skip is None else skip + out


class LaunchPlan(NamedTuple):
    """Both kernels' launch for one x. ``outer``: B * C planes or B images;
    ``chunk``: a plane's values a block (a multiple of ``vec``), or an
    image's pixels a tile; ``splits``: blocks a plane, or tiles an image
    (times ``slices`` channel slices: the pixels grid's y)."""
    layout: int
    vec: int     # values a load: 16 bytes' worth, or 1
    outer: int
    hw: int
    c: int
    chunk: int
    splits: int
    slices: int


def layout_of(x):
    if x.is_contiguous():
        return PLANES
    if x.is_contiguous(memory_format=torch.channels_last):
        return PIXELS
    raise ValueError(f"K4 reads an NCHW-contiguous or a channels_last x; got strides "
                     f"{tuple(x.stride())} for shape {tuple(x.shape)}")


@functools.lru_cache(maxsize=512)
def launch_plan(layout, shape, elem_size, aligned, sms):
    """The plan for an x of ``shape`` (B, C, H, W) in ``layout``, ``aligned``
    to 16 bytes (and its skip), on a card of ``sms`` SMs: 16-byte loads
    where the contiguous run (hw, or C) allows, and about BLOCKS_PER_SM
    blocks an SM where x has the values for them."""
    b, c, h, w = shape
    hw = h * w
    full = 16 // elem_size
    target = BLOCKS_PER_SM * sms
    if layout == PLANES:
        vec = full if aligned and hw % full == 0 else 1
        planes = b * c
        most = max(1, min(MAX_SPLITS, hw // (NTHREADS * vec * MOMENTS_UNROLL)))
        splits = min(most, -(-target // planes))
        chunk = -(-hw // splits)
        chunk = -(-chunk // vec) * vec
        return LaunchPlan(layout, vec, planes, hw, c, chunk, -(-hw // chunk), 1)
    vec = full if aligned and c % full == 0 else 1
    slices = -(-c // SLICE)
    rows = NTHREADS // (min(SLICE, c) // vec)
    most = max(1, hw // (rows * MOMENTS_UNROLL))
    tiles = min(most, -(-target // (b * slices)))
    tile_px = -(-hw // tiles)
    return LaunchPlan(layout, vec, b, hw, c, tile_px, -(-hw // tile_px), slices)


def _plan_for(x, *others):
    dev = x.device
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, *others))
    return launch_plan(layout_of(x), tuple(x.shape), x.element_size(), aligned,
                       _sms(dev.index))


@functools.cache
def _sms(device_index):
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.cache
def _library():
    """The built kernel library's C functions with their signatures (built on first use)."""
    from desr_tpu_torch.ops import _build

    lib = _build.load("instance_norm")
    vp, ci, ll, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.desr_instance_norm_moments.argtypes = [vp] * 5 + [ci] * 3 + [ll] * 2 + [ci, ll, ci, vp]
    lib.desr_norm_apply.argtypes = [vp] * 5 + [cf] * 2 + [ci] * 5 + [ll] * 2 + [ci, ll, ci, vp]
    lib.desr_instance_norm_moments.restype = lib.desr_norm_apply.restype = ci
    return lib


_tickets: dict = {}


def _tickets_for(device_index, stream, n):
    """At least n zeroed tickets for (device, stream), kept: each launch
    leaves its tickets at 0 for the next."""
    buf = _tickets.get((device_index, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32,
                          device=torch.device("cuda", device_index))
        _tickets[(device_index, stream)] = buf
    return buf


def _check_kernel_input(x):
    if x.dtype not in DTYPES:
        raise TypeError(f"K4 takes float32 or bfloat16 x, not {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"K4 takes a (B, C, H, W) x; got shape {tuple(x.shape)}")
    if x.numel() == 0:
        raise ValueError(f"K4 takes a non-empty x; got shape {tuple(x.shape)}")


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"K4 {what} launch failed: CUDA error {err}")


def _moments_cuda(x):
    _check_kernel_input(x)
    p = _plan_for(x)
    b, c = x.shape[:2]
    dev = x.device
    with _on_device(dev):
        lib = _library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        s = torch.empty((b, c), dtype=torch.float32, device=dev)
        s2 = torch.empty_like(s)
        partials = tickets = None
        if p.splits > 1:
            per_block = 2 if p.layout == PLANES else 2 * c
            partials = torch.empty(p.outer * p.splits * per_block, dtype=torch.float32,
                                   device=dev)
            tickets = _tickets_for(dev.index, stream, p.outer * p.slices)
        err = lib.desr_instance_norm_moments(
            x.data_ptr(), s.data_ptr(), s2.data_ptr(),
            None if partials is None else partials.data_ptr(),
            None if tickets is None else tickets.data_ptr(), p.layout,
            int(x.dtype == torch.bfloat16), p.vec, p.outer, p.hw, c, p.chunk, p.splits, stream)
    _raise_on(err, "moments")
    instance_norm_moments.launches += 1
    return s, s2


def _apply_cuda(x, a, b, n, eps, relu, skip):
    _check_kernel_input(x)
    bc = tuple(x.shape[:2])
    for name, v in (("a", a), ("b", b)):
        if tuple(v.shape) != bc or v.dtype != torch.float32 or v.device != x.device:
            raise ValueError(f"norm_apply's {name} must be {bc} float32 on {x.device}; got "
                             f"{tuple(v.shape)} {v.dtype} on {v.device}")
    if skip is not None and (skip.shape != x.shape or skip.dtype != x.dtype
                             or skip.stride() != x.stride() or skip.device != x.device):
        raise ValueError("norm_apply's skip must have x's shape, dtype, strides and device")
    a, b = a.contiguous(), b.contiguous()
    p = _plan_for(x, *(() if skip is None else (skip,)))
    dev = x.device
    out = torch.empty_like(x)
    with _on_device(dev):
        lib = _library()
        err = lib.desr_norm_apply(
            x.data_ptr(), None if skip is None else skip.data_ptr(), out.data_ptr(),
            a.data_ptr(), b.data_ptr(), float(n if n is not None else 0.0), float(eps),
            int(n is not None), int(relu), p.layout, int(x.dtype == torch.bfloat16), p.vec,
            p.outer, p.hw, x.shape[1], p.chunk, p.splits,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "apply")
    norm_apply.launches += 1
    return out


def _moments_impl(x):
    if x.device.type == "cpu":
        return instance_norm_moments_plain(x)
    return _moments_cuda(x)


def _apply_impl(x, a, b, n, eps, relu, skip=None):
    if x.device.type == "cpu":
        return norm_apply_plain(x, a, b, n, eps, relu, skip)
    return _apply_cuda(x, a, b, n, eps, relu, skip)


# K4 as operators of their own, so that torch.export keeps each call as one
# node of the graph it saves (desr::instance_norm_moments, desr::norm_apply)
# and the saved program launches the kernels. The implementations are
# Python: the counters count on every route. No Autograd kernel: the
# wrappers call the operators only where no gradient flows.
_LIB = torch.library.Library("desr", "FRAGMENT")
_LIB.define("instance_norm_moments(Tensor x) -> (Tensor, Tensor)")
_LIB.define("norm_apply(Tensor x, Tensor a, Tensor b, float? n, float eps, bool relu, "
            "Tensor? skip=None) -> Tensor")
for _key in ("CPU", "CUDA"):
    _LIB.impl("instance_norm_moments", _moments_impl, _key)
    _LIB.impl("norm_apply", _apply_impl, _key)


@torch.library.register_fake("desr::instance_norm_moments", lib=_LIB)
def _moments_fake(x):
    bc = tuple(x.shape[:2])
    return x.new_empty(bc, dtype=torch.float32), x.new_empty(bc, dtype=torch.float32)


@torch.library.register_fake("desr::norm_apply", lib=_LIB)
def _apply_fake(x, a, b, n, eps, relu, skip=None):
    return torch.empty_like(x)


_MOMENTS_OP = torch.ops.desr.instance_norm_moments.default
_APPLY_OP = torch.ops.desr.norm_apply.default


def instance_norm_moments(x):
    """(s, s2): the f32 (B, C) sums of x and of x^2 over H and W of an NCHW
    x. One ``desr::instance_norm_moments`` call where no gradient flows,
    else the plain version."""
    if kernel_route(x):
        return _MOMENTS_OP(x)
    return instance_norm_moments_plain(x)


def norm_apply(x, a, b, n=None, eps=1e-5, relu=False, skip=None):
    """``[relu](x * scale + shift) [+ skip]`` in x's memory format, with
    (scale, shift) = (a, b), or from the moments (a, b) = (s, s2) over n
    values per (b, c) with ``eps`` when ``n`` is given (InstanceNorm's
    normalisation). One ``desr::norm_apply`` call where no gradient flows,
    else the plain version (``norm_apply_plain``)."""
    if kernel_route(x, a, b, skip):
        return _APPLY_OP(x, a, b, n, eps, relu, skip)
    return norm_apply_plain(x, a, b, n, eps, relu, skip)


instance_norm_moments.launches = 0
norm_apply.launches = 0
