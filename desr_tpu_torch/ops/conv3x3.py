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
(layers.py:702) with no ring corrections. What bounds it on the H100: at the
serving shape (B=8, 128x160, 128->128, bf16) a launch is 48.3 GFLOP against
~84 MB moved, so the tensor cores (989 TFLOP/s bf16) set the floor at about
0.049 ms, above the 0.025 ms that HBM (3.35 TB/s) needs.

A CPU tensor takes the plain PyTorch version (``conv3x3_fused_plain``), which
is also the kernel's oracle on the card. A CUDA tensor launches the kernel or
raises: there is no fallback.

Both wrappers are differentiable in x, w, scale and shift (``_Conv3x3``, the
custom VJPs of pallas_conv.py:322-333 and :379-413). As in the JAX package the
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


def conv3x3_fused_plain(x, w, scale=None, shift=None, pad_mode="reflect",
                        relu=False, stats=False):
    """Plain PyTorch version of ``conv3x3_fused``: same arguments, same results.

    The prologue runs in f32 and is rounded to x's dtype; the conv accumulates
    in f32 over the dtype-rounded input and weights; the stats are sums of that
    f32 accumulator before it is rounded to the output dtype.
    """
    dt = x.dtype
    if scale is not None:
        v = x.float() * scale.float()[:, None, None, :] + shift.float()[:, None, None, :]
        if relu:
            v = torch.relu(v)
        x = v.to(dt)
    xn = x.permute(0, 3, 1, 2).float()
    w32 = w.to(dt).float()
    if pad_mode == "zeros":
        acc = F.conv2d(xn, w32, padding=1)
    else:
        acc = F.conv2d(F.pad(xn, (1, 1, 1, 1), mode=pad_mode), w32)
    out = acc.to(dt).permute(0, 2, 3, 1)
    if not stats:
        return out
    return out, acc.sum(dim=(2, 3)), acc.square().sum(dim=(2, 3))


def _check(x, w, scale, shift, pad_mode):
    if pad_mode not in PAD_MODES:
        raise ValueError(f"pad_mode {pad_mode!r} not in {sorted(PAD_MODES)}")
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[2:]) != (3, 3):
        raise ValueError(f"want NHWC x and (O, I, 3, 3) w; got {tuple(x.shape)}, {tuple(w.shape)}")
    b, h, wd, c = x.shape
    if w.shape[1] != c:
        raise ValueError(f"w has {w.shape[1]} input channels, x has {c}")
    if pad_mode == "reflect" and min(h, wd) < 2:
        raise ValueError(f"reflect padding needs H, W >= 2; got {h}x{wd}")
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift go together")
    if scale is not None:
        for name, v in (("scale", scale), ("shift", shift)):
            if tuple(v.shape) != (b, c):
                raise ValueError(f"{name} must be (B, C_in) = {(b, c)}; got {tuple(v.shape)}")


def _launch(x, w, scale, shift, pad_mode, relu, stats):
    """Launch the CUDA kernel on x's device and PyTorch's current stream."""
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
    o = w.shape[0]
    # (O, I, 3, 3) -> (9, I, O) tap-major matrix in the kernel's weight type
    wt = w.detach().to(x.dtype).permute(2, 3, 1, 0).reshape(9, c, o).contiguous()
    if scale is not None:
        scale = scale.detach().float().contiguous()
        shift = shift.detach().float().contiguous()
    out = torch.empty((b, h, wd, o), dtype=x.dtype, device=x.device)
    psum = psq = None
    if stats:
        tiles = lib.desr_conv3x3_tiles(h, wd)
        psum = torch.empty((b, tiles, o), dtype=torch.float32, device=x.device)
        psq = torch.empty_like(psum)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.desr_conv3x3(ptr(x), ptr(wt), ptr(scale), ptr(shift), ptr(out),
                               ptr(psum), ptr(psq), b, h, wd, c, o,
                               PAD_MODES[pad_mode], int(relu),
                               int(x.dtype == torch.bfloat16), stream)
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
    lib.desr_conv3x3.argtypes = [vp] * 7 + [ci] * 8 + [vp]
    lib.desr_conv3x3.restype = ci
    lib.desr_conv3x3_tiles.argtypes = [ci, ci]
    lib.desr_conv3x3_tiles.restype = ci
    return lib


def _prologue(x, scale, shift, relu):
    """(input the conv reads, f32 pre-activation or None), both NHWC."""
    if scale is None:
        return x, None
    v = x.float() * scale.float()[:, None, None, :] + shift.float()[:, None, None, :]
    return (torch.relu(v) if relu else v).to(x.dtype), v


class _Conv3x3(torch.autograd.Function):
    """The forward of either wrapper (kernel or plain version, by device) with
    the VJP of the plain composition prologue -> pad -> conv (-> moments)."""

    @staticmethod
    def forward(ctx, x, w, scale, shift, pad_mode, relu, stats, forward_fn):
        res = forward_fn(x, w, scale, shift, pad_mode, relu, stats)
        ctx.pad_mode, ctx.relu, ctx.stats = pad_mode, relu, stats
        ctx.save_for_backward(x, w, scale, shift, res[0] if stats else None)
        return res

    @staticmethod
    def backward(ctx, *grads):
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
            [1, 1], False, [0, 0], 1,
            [any(ctx.needs_input_grad[i] for i in (0, 2, 3)), ctx.needs_input_grad[1], False])
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
        return (dx, None if dw is None else dw.to(w.dtype), dscale, dshift,
                None, None, None, None)


def _fused_forward(x, w, scale, shift, pad_mode, relu, stats):
    if x.device.type == "cpu":
        return conv3x3_fused_plain(x, w, scale, shift, pad_mode, relu, stats)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_fused runs on cuda or cpu tensors, not {x.device}")
    res = _launch(x, w, scale, shift, pad_mode, relu, stats)
    conv3x3_fused.launches += 1
    return res


def _plain_conv_forward(x, w, scale, shift, pad_mode, relu, stats):
    if x.device.type == "cpu":
        return conv3x3_fused_plain(x, w, None, None, pad_mode)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3 runs on cuda or cpu tensors, not {x.device}")
    res = _launch(x, w, None, None, pad_mode, False, False)
    conv3x3.launches += 1
    return res


def conv3x3_fused(x, w, scale=None, shift=None, pad_mode="reflect", relu=False,
                  stats=False):
    """out = conv3x3(pad([relu](x * scale + shift))), NHWC x, OIHW w, no bias.

    ``scale``/``shift``: per-(batch, C_in) f32 vectors (None: no prologue).
    ``pad_mode``: "reflect" | "replicate" (the prologue applies to the border
    values too) | "zeros" (the padding stays 0). Returns ``out`` in x's dtype,
    or ``(out, s, s2)`` with the (B, C_out) f32 sum and sum of squares of the
    f32 accumulator over H and W when ``stats``. Differentiable in x, w,
    scale and shift.
    """
    _check(x, w, scale, shift, pad_mode)
    return _Conv3x3.apply(x, w, scale, shift, pad_mode, relu, stats, _fused_forward)


def conv3x3(x, w, pad_mode="reflect"):
    """Stride-1 3x3 conv of NHWC x with OIHW w and a 1-pixel border; no bias.
    Differentiable in x and w."""
    _check(x, w, None, None, pad_mode)
    return _Conv3x3.apply(x, w, None, None, pad_mode, False, False, _plain_conv_forward)


conv3x3_fused.launches = 0
conv3x3.launches = 0
