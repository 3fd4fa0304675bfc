"""3x3 stride-1 convolution with a fused normalise(+ReLU) prologue and moments.

Replaces the Pallas TPU kernel of ``desr_tpu/ops/pallas_conv.py``:

- ``conv3x3_fused`` is ``conv2d_pallas_fused`` (pallas_conv.py:353): the
  ResnetBlock chains' [pad(1) -> 3x3 conv -> InstanceNorm -> ReLU] links, with
  the previous norm's normalise(+ReLU) applied as the input is loaded and the
  next norm's moments taken from the f32 accumulator;
- ``conv3x3`` is ``conv2d_pallas`` (pallas_conv.py:309): the same launch with
  the prologue and the stats off.

The kernel is ``desr_tpu_torch/csrc/conv3x3.cu`` (built with nvcc for sm_90a
on the first CUDA call, loaded with ctypes). Unlike the TPU kernel it reads
reflect and replicate borders itself, so its output equals ``apply_ring``'s
(layers.py:702) with no ring corrections. Its bf16 body is an implicit GEMM on
Hopper's warpgroup MMA: one block covers all output channels of a tile (up to
256; more take more blocks), the input halo is staged once per 64-channel
chunk and read by all 9 taps, and the weights stream through a ring in the
128-byte-swizzled layout ``pack_weights`` gives them. What bounds it on the
H100: at the serving shape (B=8, 128x160, 128->128, bf16) a launch is 48.3
GFLOP against ~84 MB moved, so the tensor cores (989 TFLOP/s bf16) set the
floor at about 0.049 ms, above the 0.025 ms that HBM (3.35 TB/s) needs. The
float32 body is an exact f32 path on the CUDA cores.

Halo rows (``halo_top``, ``halo_bottom``, each 0 or 1): under
``--spatial_devices`` a rank holds a band of a frame's rows, and x then
carries one more row above and/or below its band, a neighbour's
(``desr_tpu_torch/parallel/spatial.py``). x has ``H_out + halo_top +
halo_bottom`` rows and output row y reads rows ``y + halo_top + dy - 1``:
an end of H with a halo row is not padded, an end without one (the frame's
edge) is padded with ``pad_mode`` as before. The prologue applies to the
halo rows too, and the moments count the output rows alone. The backward
of a launch with halo rows is not ported (training under
``--spatial_devices`` is not).

A CPU tensor takes the plain PyTorch version (``conv3x3_fused_plain``), which
is also the kernel's oracle on the card. A CUDA tensor launches the kernel or
raises: there is no fallback.

Both wrappers call operators registered with ``torch.library``
(``desr::conv3x3_fused``, ``desr::conv3x3``), so ``torch.export`` keeps each
call as one node of the graph it saves (``desr_tpu_torch/serving.py``); each
has a fake implementation for tracing and an autograd formula, the custom
VJPs of pallas_conv.py:322-333 and :379-413. As in the JAX package the
backward is no kernel of its own: the stats cotangents fold into the output's
(``g_out + g_s + 2 out g_s2``), then one ``aten.convolution_backward`` on the
normalised, padded input (recomputed from x, as ``_fused_bwd`` does) gives dx
and dw without re-running the forward conv, and the adjoints of the pad and
the prologue finish dx, dscale and dshift. The backward runs in x's dtype.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

PAD_MODES = {"zeros": 0, "reflect": 1, "replicate": 2}
DTYPES = (torch.float32, torch.bfloat16)
# tile geometry of the two bodies in csrc/conv3x3.cu (its C entry points
# refuse a bf16 (nt, th) they were not built for)
F32_TILE = (8, 16)   # conv3x3_f32_kernel: rows, columns
BF16_TW = 16         # bf16 body: tile columns (a warp's 16 A rows)
BF16_KC = 64         # bf16 body: input channels per chunk (128 bytes a pixel)


def bf16_tiling(cout):
    """(nt, th) of the bf16 body for ``cout`` output channels: the output
    channels one block covers (a wgmma N of 64, 128 or 256; wider layers
    take ceil(cout / 256) blocks per tile) and the tile's rows."""
    nt = 256 if cout > 128 else 128 if cout > 64 else 64
    return nt, 16 if nt == 64 else 8


def _swizzle(nt, device):
    """Index of the 16-byte group stored in slot q of weight row n: the
    128-byte swizzle (q ^ n % 8), its own inverse."""
    n = torch.arange(nt, device=device)
    return torch.arange(8, device=device)[None, :] ^ (n % 8)[:, None]


@functools.lru_cache(maxsize=32)
def _pack_index(o, i, nt, device):
    """Where ``pack_weights`` takes each packed entry from: an index into
    w.reshape(-1) with one 0 appended (index o * i * 9)."""
    n = o * i * 9
    tiles, chunks = -(-o // nt), -(-i // BF16_KC)
    idx = torch.full((tiles * nt, chunks * BF16_KC, 3, 3), n, dtype=torch.long, device=device)
    idx[:o, :i] = torch.arange(n, device=device).reshape(o, i, 3, 3)
    idx = idx.reshape(tiles, nt, chunks, BF16_KC, 9).permute(0, 2, 4, 1, 3)
    idx = idx.reshape(tiles, chunks, 9, nt, 8, 8)
    # contiguous, so that the gather through it is too: the kernel reads the
    # packed weights by address
    return idx[:, :, :, torch.arange(nt, device=device)[:, None],
               _swizzle(nt, device)].contiguous()


def pack_weights(w, nt, dtype=torch.bfloat16):
    """(O, I, 3, 3) weights -> the bf16 body's layout, ``[ceil(O / nt)][chunk]
    [tap][nt][64]``: for N tile, 64-input-channel chunk and tap (dy * 3 + dx),
    an nt x 64 K-major matrix (row n = output channel, 128 bytes of input
    channels) whose 8-channel groups are XOR-swizzled by n % 8, as wgmma's
    128-byte swizzle reads them. Channels past O and I are 0. One gather
    through a cached index (``_pack_index``)."""
    o, i = w.shape[:2]
    flat = F.pad(w.detach().to(dtype).reshape(-1), (0, 1))
    return flat[_pack_index(o, i, nt, w.device)]


def conv3x3_fused_plain(x, w, scale=None, shift=None, pad_mode="reflect",
                        relu=False, stats=False, halo_top=0, halo_bottom=0):
    """Plain PyTorch version of ``conv3x3_fused``: same arguments, same results.

    The prologue runs in f32 and is rounded to x's dtype; the conv accumulates
    in f32 over the dtype-rounded input and weights; the stats are sums of that
    f32 accumulator before it is rounded to the output dtype. W is padded
    with ``pad_mode``, H only at an end without a halo row.
    """
    dt = x.dtype
    if scale is not None:
        v = x.float() * scale.float()[:, None, None, :] + shift.float()[:, None, None, :]
        if relu:
            v = torch.relu(v)
        x = v.to(dt)
    xn = x.permute(0, 3, 1, 2).float()
    w32 = w.to(dt).float()
    pads = (1, 1, 1 - halo_top, 1 - halo_bottom)
    if pad_mode == "zeros" and pads == (1, 1, 1, 1):
        acc = F.conv2d(xn, w32, padding=1)
    elif pad_mode == "zeros":
        acc = F.conv2d(F.pad(xn, pads), w32)
    else:
        acc = F.conv2d(F.pad(xn, pads, mode=pad_mode), w32)
    out = acc.to(dt).permute(0, 2, 3, 1)
    if not stats:
        return out
    return out, acc.sum(dim=(2, 3)), acc.square().sum(dim=(2, 3))


def _check(x, w, scale, shift, pad_mode, halo_top=0, halo_bottom=0):
    if pad_mode not in PAD_MODES:
        raise ValueError(f"pad_mode {pad_mode!r} not in {sorted(PAD_MODES)}")
    if halo_top not in (0, 1) or halo_bottom not in (0, 1):
        raise ValueError(f"halo rows are 0 or 1; got {halo_top}, {halo_bottom}")
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[2:]) != (3, 3):
        raise ValueError(f"want NHWC x and (O, I, 3, 3) w; got {tuple(x.shape)}, {tuple(w.shape)}")
    b, h, wd, c = x.shape
    if w.shape[1] != c:
        raise ValueError(f"w has {w.shape[1]} input channels, x has {c}")
    if h <= halo_top + halo_bottom:
        raise ValueError(f"x has {h} rows: no output row beside {halo_top + halo_bottom} halo rows")
    if pad_mode == "reflect" and min(h, wd) < 2:
        raise ValueError(f"reflect padding needs H, W >= 2; got {h}x{wd}")
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift go together")
    if scale is not None:
        for name, v in (("scale", scale), ("shift", shift)):
            if tuple(v.shape) != (b, c):
                raise ValueError(f"{name} must be (B, C_in) = {(b, c)}; got {tuple(v.shape)}")


def _launch(x, w, scale, shift, pad_mode, relu, stats, halo_top=0, halo_bottom=0):
    """Launch the CUDA kernel on x's device and PyTorch's current stream;
    x has ``halo_top + halo_bottom`` rows more than the output."""
    if x.dtype not in DTYPES:
        raise TypeError(f"conv3x3 kernel takes float32 or bfloat16, not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("conv3x3 kernel needs a contiguous NHWC x "
                         "(an NCHW tensor in torch.channels_last, permuted)")
    for name, v in (("w", w), ("scale", scale), ("shift", shift)):
        if v is not None and v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, x on {x.device}")
    lib = _library()
    b, h, wd, c = x.shape
    h -= halo_top + halo_bottom  # the output's rows
    o = w.shape[0]
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        nt, th = bf16_tiling(o)
        tw = BF16_TW
        wt = pack_weights(w, nt)
    else:  # (O, I, 3, 3) -> (9, I, O) tap-major matrix
        th, tw = F32_TILE
        wt = w.detach().float().permute(2, 3, 1, 0).reshape(9, c, o).contiguous()
    if scale is not None:
        scale = scale.detach().float().contiguous()
        shift = shift.detach().float().contiguous()
    out = torch.empty((b, h, wd, o), dtype=x.dtype, device=x.device)
    psum = psq = None
    if stats:
        tiles = -(-h // th) * -(-wd // tw)
        psum = torch.empty((b, tiles, o), dtype=torch.float32, device=x.device)
        psq = torch.empty_like(psum)

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = (ptr(x), ptr(wt), ptr(scale), ptr(shift), ptr(out), ptr(psum), ptr(psq),
            b, h, wd, c, o, PAD_MODES[pad_mode], int(relu), int(halo_top), int(halo_bottom))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if bf16:
            err = lib.desr_conv3x3_bf16(*args, nt, th, stream)
        else:
            err = lib.desr_conv3x3_f32(*args, stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed: CUDA error {err}")
    if not stats:
        return out
    # deterministic second pass over the per-tile partials
    return out, psum.sum(dim=1), psq.sum(dim=1)


@functools.cache
def _library():
    """The built kernel library with its C signatures declared (built on first use)."""
    from desr_tpu_torch.ops import _build

    lib = _build.load("conv3x3")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.desr_conv3x3_bf16.argtypes = [vp] * 7 + [ci] * 11 + [vp]
    lib.desr_conv3x3_bf16.restype = ci
    lib.desr_conv3x3_f32.argtypes = [vp] * 7 + [ci] * 9 + [vp]
    lib.desr_conv3x3_f32.restype = ci
    return lib


def _prologue(x, scale, shift, relu):
    """(input the conv reads, f32 pre-activation or None), both NHWC."""
    if scale is None:
        return x, None
    v = x.float() * scale.float()[:, None, None, :] + shift.float()[:, None, None, :]
    return (torch.relu(v) if relu else v).to(x.dtype), v


def _vjp(ctx, grads, need_dx, need_dw):
    """(dx, dw, dscale, dshift) of the plain composition prologue -> pad ->
    conv (-> moments) at the inputs ``ctx`` saved, for the cotangents
    ``grads`` of (out, s, s2) (stats) or of out alone."""
    if ctx.halo != (0, 0):
        raise NotImplementedError(
            "the backward of conv3x3 with halo rows: training under --spatial_devices "
            "is not yet ported")
    x, w, scale, shift, out = ctx.saved_tensors
    dt = x.dtype
    if ctx.stats:
        # s = sum(out32), s2 = sum(out32^2) fold into the output's
        # cotangent (pallas_conv.py:390-397): no conv recompute for them
        g_out, g_s, g_s2 = grads
        g = (g_out.float() + g_s[:, None, None, :]
             + 2.0 * out.float() * g_s2[:, None, None, :]).to(dt)
    else:
        g = grads[0].to(dt)
    xin, v = _prologue(x, scale, shift, ctx.relu)
    xin = xin.permute(0, 3, 1, 2)
    zeros = ctx.pad_mode == "zeros"
    xp = xin if zeros else F.pad(xin, (1, 1, 1, 1), mode=ctx.pad_mode)
    dxp, dw, _ = torch.ops.aten.convolution_backward(
        g.permute(0, 3, 1, 2), xp, w.to(dt), None, [1, 1], [1, 1] if zeros else [0, 0],
        [1, 1], False, [0, 0], 1, [need_dx, need_dw, False])
    dx = dscale = dshift = None
    if dxp is not None:
        if zeros:
            dxin = dxp
        else:  # adjoint of the border pad
            leaf = xin.detach().requires_grad_(True)
            with torch.enable_grad():
                (dxin,) = torch.autograd.grad(
                    F.pad(leaf, (1, 1, 1, 1), mode=ctx.pad_mode), leaf, dxp)
        dxin = dxin.permute(0, 2, 3, 1)
        if scale is None:
            dx = dxin
        else:  # adjoint of [relu](x * scale + shift), in f32
            dv = dxin.float()
            if ctx.relu:
                dv = dv * (v > 0)
            dx = (dv * scale.float()[:, None, None, :]).to(dt)
            dscale = (dv * x.float()).sum(dim=(1, 2)).to(scale.dtype)
            dshift = dv.sum(dim=(1, 2)).to(shift.dtype)
    return dx, None if dw is None else dw.to(w.dtype), dscale, dshift


def _fused_forward(x, w, scale, shift, pad_mode, relu, stats, halo_top=0, halo_bottom=0):
    """K1 on x's device: the plain version on the CPU, the kernel on CUDA.
    ``launches_halo`` counts the launches with a halo row."""
    halo = (halo_top, halo_bottom)
    if x.device.type == "cpu":
        return conv3x3_fused_plain(x, w, scale, shift, pad_mode, relu, stats, *halo)
    res = _launch(x, w, scale, shift, pad_mode, relu, stats, *halo)
    conv3x3_fused.launches += 1
    conv3x3_fused.launches_halo += halo != (0, 0)
    return res


def _conv_forward(x, w, pad_mode, halo_top=0, halo_bottom=0):
    """K2 on x's device: the plain version on the CPU, the kernel on CUDA."""
    halo = (halo_top, halo_bottom)
    if x.device.type == "cpu":
        return conv3x3_fused_plain(x, w, None, None, pad_mode, False, False, *halo)
    res = _launch(x, w, None, None, pad_mode, False, False, *halo)
    conv3x3.launches += 1
    conv3x3.launches_halo += halo != (0, 0)
    return res


# K1 and K2 as operators of their own, so that torch.export keeps each call
# as one node (desr::conv3x3_fused, desr::conv3x3) of the graph it saves and
# the saved program launches the kernel, not its plain version. The
# implementations are Python: the counters count on every route. K1 always
# returns three tensors; without stats the two moments are empty.
_LIB = torch.library.Library("desr", "DEF")
# The halo arguments default to 0, so a program exported before they existed
# still loads and calls the same operators.
_LIB.define("conv3x3_fused(Tensor x, Tensor w, Tensor? scale, Tensor? shift, str pad_mode, "
            "bool relu, bool stats, int halo_top=0, int halo_bottom=0) "
            "-> (Tensor, Tensor, Tensor)")
_LIB.define("conv3x3(Tensor x, Tensor w, str pad_mode, int halo_top=0, int halo_bottom=0) "
            "-> Tensor")


def _halo(halo_top, halo_bottom):
    """The halo arguments to pass on: none when both are 0, so a call
    without halo rows is the call it was before they existed (in an exported
    graph, and to a stand-in for ``_fused_forward`` that predates them)."""
    return (halo_top, halo_bottom) if halo_top or halo_bottom else ()


def _fused_impl(x, w, scale, shift, pad_mode, relu, stats, halo_top=0, halo_bottom=0):
    res = _fused_forward(x, w, scale, shift, pad_mode, relu, stats, *_halo(halo_top, halo_bottom))
    if not stats:
        return res.contiguous(), x.new_empty(0, dtype=torch.float32), \
            x.new_empty(0, dtype=torch.float32)
    return res[0].contiguous(), res[1], res[2]


def _conv_impl(x, w, pad_mode, halo_top=0, halo_bottom=0):
    return _conv_forward(x, w, pad_mode, *_halo(halo_top, halo_bottom)).contiguous()


for _key in ("CPU", "CUDA"):
    _LIB.impl("conv3x3_fused", _fused_impl, _key)
    _LIB.impl("conv3x3", _conv_impl, _key)


@torch.library.register_fake("desr::conv3x3_fused", lib=_LIB)
def _fused_fake(x, w, scale, shift, pad_mode, relu, stats, halo_top=0, halo_bottom=0):
    b, h, wd, _ = x.shape
    h = h - halo_top - halo_bottom
    moments = (b, w.shape[0]) if stats else (0,)
    return (x.new_empty((b, h, wd, w.shape[0])), x.new_empty(moments, dtype=torch.float32),
            x.new_empty(moments, dtype=torch.float32))


@torch.library.register_fake("desr::conv3x3", lib=_LIB)
def _conv_fake(x, w, pad_mode, halo_top=0, halo_bottom=0):
    b, h, wd, _ = x.shape
    return x.new_empty((b, h - halo_top - halo_bottom, wd, w.shape[0]))


# The Autograd kernels are registered by hand: torch.library.register_autograd's
# generated kernel cost ~140 us of host time a call with a gradient on the
# card's host, and stage 2's iteration (216 calls) 8.7% (PERF.md, section 6;
# desr_tpu_torch/tools/dispatch_ab.py).
# Without a gradient the call goes straight one level down.
class _FusedGrad(torch.autograd.Function):
    """desr::conv3x3_fused's Autograd kernel: the forward one level down
    (the CPU or CUDA implementation), the VJP of the plain composition."""

    @staticmethod
    def forward(ctx, x, w, scale, shift, pad_mode, relu, stats, halo_top, halo_bottom):
        with torch._C._AutoDispatchBelowAutograd():
            res = _FUSED_OP(x, w, scale, shift, pad_mode, relu, stats, halo_top, halo_bottom)
        ctx.pad_mode, ctx.relu, ctx.stats = pad_mode, relu, stats
        ctx.halo = (halo_top, halo_bottom)
        ctx.save_for_backward(x, w, scale, shift, res[0] if stats else None)
        return res

    @staticmethod
    def backward(ctx, g_out, g_s, g_s2):
        need = ctx.needs_input_grad
        grads = (g_out, g_s, g_s2) if ctx.stats else (g_out,)
        return (*_vjp(ctx, grads, need[0] or need[2] or need[3], need[1]),
                None, None, None, None, None)


class _ConvGrad(torch.autograd.Function):
    """desr::conv3x3's Autograd kernel, as ``_FusedGrad``."""

    @staticmethod
    def forward(ctx, x, w, pad_mode, halo_top, halo_bottom):
        with torch._C._AutoDispatchBelowAutograd():
            out = _CONV_OP(x, w, pad_mode, halo_top, halo_bottom)
        ctx.pad_mode, ctx.relu, ctx.stats = pad_mode, False, False
        ctx.halo = (halo_top, halo_bottom)
        ctx.save_for_backward(x, w, None, None, None)
        return out

    @staticmethod
    def backward(ctx, g):
        dx, dw, _, _ = _vjp(ctx, (g,), *ctx.needs_input_grad[:2])
        return dx, dw, None, None, None


def _fused_autograd(x, w, scale, shift, pad_mode, relu, stats, halo_top=0, halo_bottom=0):
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad or (
            scale is not None and (scale.requires_grad or shift.requires_grad))):
        return _FusedGrad.apply(x, w, scale, shift, pad_mode, relu, stats, halo_top,
                                halo_bottom)
    with torch._C._AutoDispatchBelowAutograd():
        return _FUSED_OP(x, w, scale, shift, pad_mode, relu, stats, halo_top, halo_bottom)


def _conv_autograd(x, w, pad_mode, halo_top=0, halo_bottom=0):
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _ConvGrad.apply(x, w, pad_mode, halo_top, halo_bottom)
    with torch._C._AutoDispatchBelowAutograd():
        return _CONV_OP(x, w, pad_mode, halo_top, halo_bottom)


_LIB.impl("conv3x3_fused", _fused_autograd, "Autograd")
_LIB.impl("conv3x3", _conv_autograd, "Autograd")
_FUSED_OP = torch.ops.desr.conv3x3_fused.default
_CONV_OP = torch.ops.desr.conv3x3.default


def conv3x3_fused(x, w, scale=None, shift=None, pad_mode="reflect", relu=False,
                  stats=False, halo_top=0, halo_bottom=0):
    """out = conv3x3(pad([relu](x * scale + shift))), NHWC x, OIHW w, no bias.

    ``scale``/``shift``: per-(batch, C_in) f32 vectors (None: no prologue).
    ``pad_mode``: "reflect" | "replicate" (the prologue applies to the border
    values too) | "zeros" (the padding stays 0). Returns ``out`` in x's dtype,
    or ``(out, s, s2)`` with the (B, C_out) f32 sum and sum of squares of the
    f32 accumulator over H and W when ``stats``. ``halo_top`` /
    ``halo_bottom``: x's extra rows above / below (see the module's
    docstring); the output has that many rows fewer. Differentiable in x, w,
    scale and shift without halo rows. One ``desr::conv3x3_fused`` call.
    """
    _check(x, w, scale, shift, pad_mode, halo_top, halo_bottom)
    out, s, s2 = _FUSED_OP(x, w, scale, shift, pad_mode, relu, stats,
                           *_halo(halo_top, halo_bottom))
    return (out, s, s2) if stats else out


def conv3x3(x, w, pad_mode="reflect", halo_top=0, halo_bottom=0):
    """Stride-1 3x3 conv of NHWC x with OIHW w and a 1-pixel border; no bias;
    halo rows as ``conv3x3_fused``'s. Differentiable in x and w without halo
    rows. One ``desr::conv3x3`` call."""
    _check(x, w, None, None, pad_mode, halo_top, halo_bottom)
    return _CONV_OP(x, w, pad_mode, *_halo(halo_top, halo_bottom))


conv3x3_fused.launches = conv3x3_fused.launches_halo = 0
conv3x3.launches = conv3x3.launches_halo = 0
