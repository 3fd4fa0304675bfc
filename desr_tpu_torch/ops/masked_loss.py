"""Fused masked-loss sums of the stage-3 loss tail (K3).

Replaces the Pallas TPU kernel of ``desr_tpu/ops/pallas_kernels.py``:
``masked_loss_sums`` (:97), its differentiable form ``masked_loss_sums_diff``
(:120) and ``fused_hole_means`` (:142). One pass over (pred, target, m1, m2)
gives the f32 sums

    s0 = sum |t*m1 - p*m1|,  s1 = sum |(t*m1 - p*m1)*m2|,  s2 = sum ((t*m1 - p*m1)*m2)^2

from which the main model takes its (task, holes, holes_l2) triplets. The
kernel is ``desr_tpu_torch/csrc/masked_loss.cu`` (built with nvcc for sm_90a
on the first CUDA call, loaded with ctypes); it is bytes-bound, see the
source's note. A CPU tensor takes the plain version (``masked_loss_sums_plain``,
the JAX ``masked_loss_sums_reference``, :40), which is also the kernel's
oracle on the card. A CUDA tensor launches the kernel or raises.

The sums are differentiable in pred and target (``_MaskedLossSums``); the
backward is the closed form of the JAX custom VJP (``_mls_bwd``, :129-136),
one elementwise expression as XLA's there, and the masks get no gradient.
"""

from __future__ import annotations

import ctypes
import functools

import torch

DTYPES = (torch.float32, torch.bfloat16)


def masked_loss_sums_plain(pred, target, m1, m2):
    """The three f32 sums as a (3,) tensor, in plain PyTorch (f32 math)."""
    p, t, a, b = (v.float() for v in (pred, target, m1, m2))
    d1 = t * a - p * a
    d2 = t * a * b - p * a * b
    return torch.stack([d1.abs().sum(), d2.abs().sum(), d2.square().sum()])


def _check(pred, target, m1, m2):
    shape = tuple(pred.shape)
    for name, v in (("target", target), ("m1", m1), ("m2", m2)):
        if tuple(v.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(v.shape)}, pred {shape}")
        if v.device != pred.device:
            raise ValueError(f"{name} is on {v.device}, pred on {pred.device}")


def _launch(pred, target, m1, m2):
    """Launch the CUDA kernel on pred's device and PyTorch's current stream."""
    for name, v in (("pred", pred), ("target", target)):
        if v.dtype not in DTYPES:
            raise TypeError(f"masked_loss kernel takes float32 or bfloat16 {name}, not {v.dtype}")
    for name, v in (("m1", m1), ("m2", m2)):
        if v.dtype != torch.float32:
            raise TypeError(f"masked_loss kernel takes float32 masks, not {name} {v.dtype}")
    for name, v in (("pred", pred), ("target", target), ("m1", m1), ("m2", m2)):
        if not v.is_contiguous():
            raise ValueError(f"masked_loss kernel needs contiguous inputs; {name} is not")
    lib = _library()
    n = pred.numel()
    partials = torch.empty((lib.desr_masked_loss_blocks(n), 3), dtype=torch.float32,
                           device=pred.device)
    out = torch.empty(3, dtype=torch.float32, device=pred.device)
    ins = (pred, target, m1, m2)
    vec = all(v.data_ptr() % (4 * v.element_size()) == 0 for v in ins)
    with torch.cuda.device(pred.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.desr_masked_loss_sums(*(v.data_ptr() for v in ins), partials.data_ptr(),
                                        out.data_ptr(), n, int(pred.dtype == torch.bfloat16),
                                        int(target.dtype == torch.bfloat16), int(vec), stream)
    if err != 0:
        raise RuntimeError(f"masked_loss kernel launch failed: CUDA error {err}")
    return out


@functools.cache
def _library():
    """The built kernel library with its C signatures declared (built on first use)."""
    from desr_tpu_torch.ops import _build

    lib = _build.load("masked_loss")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.desr_masked_loss_sums.argtypes = [vp] * 6 + [ctypes.c_longlong] + [ci] * 3 + [vp]
    lib.desr_masked_loss_sums.restype = ci
    lib.desr_masked_loss_blocks.argtypes = [ctypes.c_longlong]
    lib.desr_masked_loss_blocks.restype = ci
    return lib


def _forward(pred, target, m1, m2):
    if pred.device.type == "cpu":
        return masked_loss_sums_plain(pred, target, m1, m2)
    if pred.device.type != "cuda":
        raise ValueError(f"masked_loss_sums runs on cuda or cpu tensors, not {pred.device}")
    out = _launch(pred, target, m1, m2)
    masked_loss_sums.launches += 1
    return out


class _MaskedLossSums(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pred, target, m1, m2):
        ctx.save_for_backward(pred, target, m1, m2)
        return _forward(pred, target, m1, m2)

    @staticmethod
    def backward(ctx, g):
        p, t, m1, m2 = ctx.saved_tensors
        g0, g1, g2 = g.float()
        d1 = (t * m1 - p * m1).float()
        d2 = d1 * m2
        gt = (torch.sign(d1) * g0 + m1 * (torch.sign(d2) * g1 + 2.0 * d2 * g2)) * m1
        return (-gt).to(p.dtype), gt.to(t.dtype), None, None


def masked_loss_sums(pred, target, m1, m2):
    """(s0, s1, s2) f32 scalars: sum |d1|, sum |d1*m2|, sum (d1*m2)^2 with
    d1 = target*m1 - pred*m1, over tensors of one shape. Differentiable in
    pred and target."""
    _check(pred, target, m1, m2)
    s = _MaskedLossSums.apply(pred, target, m1, m2)
    return s[0], s[1], s[2]


def fused_hole_means(pred, target, m1, m2):
    """The (task, holes, holes_l2) triplet (pallas_kernels.py:142-152):
    mean|d1|, mean|d1*m2| and 5 * mean (d1*m2)^2."""
    s0, s1, s2 = masked_loss_sums(pred, target, m1, m2)
    n = pred.numel()
    return s0 / n, s1 / n, s2 / n * 5.0


masked_loss_sums.launches = 0
