"""Fused masked-loss sums of the stage-3 loss tail (K3), and their gradient.

Replaces the Pallas TPU kernel of ``desr_tpu/ops/pallas_kernels.py``:
``masked_loss_sums`` (:97), its differentiable form ``masked_loss_sums_diff``
(:120, custom VJP :124-139) and ``fused_hole_means`` (:142). One pass over
(pred, target, m1, m2) gives the f32 sums

    s0 = sum |t*m1 - p*m1|,  s1 = sum |(t*m1 - p*m1)*m2|,  s2 = sum ((t*m1 - p*m1)*m2)^2

from which the main model takes its (task, holes, holes_l2) triplets. The
kernels are ``desr_tpu_torch/csrc/masked_loss.cu`` (built with nvcc for
sm_90a on the first CUDA call, loaded with ctypes): the sums in one launch,
split over the SMs by ``launch_plan``, and the backward in one elementwise
pass (``masked_loss_grads``); both are bytes-bound, see the source's note.
A CPU tensor takes the plain versions (``masked_loss_sums_plain``, the JAX
``masked_loss_sums_reference``, :40; ``masked_loss_grads_plain``, the JAX
``_mls_bwd``, :129-136), which are also the kernels' oracles on the card. A
CUDA tensor launches the kernel or raises.

The sums are differentiable in pred and target (``_MaskedLossSums``); the
masks get no gradient, and target's is computed only when it needs one.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from types import SimpleNamespace
from typing import NamedTuple

import torch

DTYPES = (torch.float32, torch.bfloat16)
MIN_BLOCK_VALUES = 2048   # values the sums kernel gives a block at least, where n allows
MAX_BLOCKS_PER_SM = 32    # Hopper's most resident blocks an SM: sizes the partials


def masked_loss_sums_plain(pred, target, m1, m2):
    """The three f32 sums as a (3,) tensor, in plain PyTorch (f32 math)."""
    p, t, a, b = (v.float() for v in (pred, target, m1, m2))
    d1 = t * a - p * a
    d2 = t * a * b - p * a * b
    return torch.stack([d1.abs().sum(), d2.abs().sum(), d2.square().sum()])


def masked_loss_grads_plain(pred, target, m1, m2, g, with_dt=True):
    """(dp, dt) of sum_k g[k] * s_k in plain PyTorch: the closed form of the
    JAX custom VJP (pallas_kernels.py:129-136); dt is None unless ``with_dt``."""
    g0, g1, g2 = g.float()
    d1 = (target * m1 - pred * m1).float()
    d2 = d1 * m2
    gt = (torch.sign(d1) * g0 + m1 * (torch.sign(d2) * g1 + 2.0 * d2 * g2)) * m1
    return (-gt).to(pred.dtype), gt.to(target.dtype) if with_dt else None


class LaunchPlan(NamedTuple):
    """The sums kernel's launch. Values [0, head) and [head + units * unit, n)
    are read one by one (by block 0); the units between are split over the
    grid, block b taking units // grid, one more if b < units % grid, each
    block one contiguous range."""
    n: int
    head: int    # values before every input is 16-byte aligned
    unit: int    # values a unit: 4 (f32 inputs), 8 (a bf16 one: 16 B), 1 (no common alignment)
    units: int
    grid: int


def _common_head(residues, sizes):
    """The least h with every address + h * size 16-byte aligned, or None."""
    for h in range(16):
        if all((r + h * s) % 16 == 0 for r, s in zip(residues, sizes)):
            return h
    return None


def launch_plan(n, addrs, elem_sizes, sms, resident):
    """The sums kernel's grid and split of n values. ``addrs`` and
    ``elem_sizes``: the four inputs' data pointers and bytes a value;
    ``resident``: blocks an SM holds. The grid is whole waves over the
    ``sms`` SMs (at most ``resident``), fewer blocks for a small n, each
    block at least MIN_BLOCK_VALUES values where n allows."""
    return _plan(n, tuple(a % 16 for a in addrs), tuple(elem_sizes), sms, resident)


@functools.lru_cache(maxsize=256)
def _plan(n, residues, sizes, sms, resident):
    head = _common_head(residues, sizes)
    if head is None:  # the inputs share no 16-byte alignment: value by value
        head, unit = 0, 1
    else:
        head, unit = min(head, n), 16 // min(sizes)
    units = (n - head) // unit
    per_block = max(1, MIN_BLOCK_VALUES // unit)  # units
    if units >= sms * per_block:
        grid = sms * min(resident, units // (sms * per_block))
    else:
        grid = max(1, -(-units // per_block))
    return LaunchPlan(n, head, unit, units, grid)


def _check(pred, target, m1, m2):
    shape = tuple(pred.shape)
    for name, v in (("target", target), ("m1", m1), ("m2", m2)):
        if tuple(v.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(v.shape)}, pred {shape}")
        if v.device != pred.device:
            raise ValueError(f"{name} is on {v.device}, pred on {pred.device}")


def _check_kernel_inputs(pred, target, m1, m2):
    """What the CUDA kernels take; raises before anything builds or launches."""
    for name, v in (("pred", pred), ("target", target)):
        if v.dtype not in DTYPES:
            raise TypeError(f"masked_loss kernel takes float32 or bfloat16 {name}, not {v.dtype}")
    for name, v in (("m1", m1), ("m2", m2)):
        if v.dtype != torch.float32:
            raise TypeError(f"masked_loss kernel takes float32 masks, not {name} {v.dtype}")
    for name, v in (("pred", pred), ("target", target), ("m1", m1), ("m2", m2)):
        if not v.is_contiguous():
            raise ValueError(f"masked_loss kernel needs contiguous inputs; {name} is not")


def _on_device(dev):
    """pred's device as the current one, entered only when it is not already."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


@functools.cache
def _library():
    """The built kernel library's C functions with their signatures (built on first use)."""
    from desr_tpu_torch.ops import _build

    lib = _build.load("masked_loss")
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fns = SimpleNamespace(occupancy=lib.desr_masked_loss_occupancy, sums=lib.desr_masked_loss_sums,
                          grads=lib.desr_masked_loss_grads)
    fns.occupancy.argtypes = [ci, ci, ctypes.POINTER(ci)]
    fns.sums.argtypes = [vp] * 6 + [ll] * 3 + [ci] * 4 + [vp]
    fns.grads.argtypes = [vp] * 7 + [ll] * 3 + [ci] * 2 + [vp]
    for f in (fns.occupancy, fns.sums, fns.grads):
        f.restype = ci
    return fns


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"masked_loss {what} failed: CUDA error {err}")


@functools.cache
def _resident(device_index, pred_bf16, target_bf16):
    """(SMs, blocks an SM holds) of the sums kernel on the current device,
    which is ``device_index`` (queried once per device and dtypes)."""
    out = (ctypes.c_int * 2)()
    _raise_on(_library().occupancy(int(pred_bf16), int(target_bf16), out), "occupancy query")
    return out[0], out[1]


_scratch: dict = {}


def _scratch_for(device_index, stream, sms):
    """The sums kernel's ticket and partials, one zeroed buffer per (device,
    stream), kept: the kernel leaves the ticket at 0 for the next launch."""
    key = (device_index, stream)
    buf = _scratch.get(key)
    if buf is None:
        buf = torch.zeros(4 + 3 * sms * MAX_BLOCKS_PER_SM, dtype=torch.int32,
                          device=torch.device("cuda", device_index))
        _scratch[key] = buf
    return buf


def _launch(pred, target, m1, m2):
    """Launch the sums kernel on pred's device and its current stream."""
    _check_kernel_inputs(pred, target, m1, m2)
    ins = (pred, target, m1, m2)
    dev = pred.device
    with _on_device(dev):
        fns = _library()
        pbf, tbf = pred.dtype == torch.bfloat16, target.dtype == torch.bfloat16
        sms, resident = _resident(dev.index, pbf, tbf)
        addrs = [v.data_ptr() for v in ins]
        plan = launch_plan(pred.numel(), addrs, [v.element_size() for v in ins], sms, resident)
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = _scratch_for(dev.index, stream, sms)
        out = torch.empty(3, dtype=torch.float32, device=dev)
        err = fns.sums(*addrs, scratch.data_ptr(), out.data_ptr(), plan.n, plan.head, plan.units,
                       plan.unit, plan.grid, int(pbf), int(tbf), stream)
    _raise_on(err, "sums launch")
    return out


def _forward(pred, target, m1, m2):
    if pred.device.type == "cpu":
        return masked_loss_sums_plain(pred, target, m1, m2)
    if pred.device.type != "cuda":
        raise ValueError(f"masked_loss_sums runs on cuda or cpu tensors, not {pred.device}")
    out = _launch(pred, target, m1, m2)
    masked_loss_sums.launches += 1
    return out


def masked_loss_grads(pred, target, m1, m2, g, with_dt=True):
    """(dp, dt) of sum_k g[k] * s_k for the (3,) f32 cotangents ``g``: the
    plain version on CPU tensors, one kernel launch on CUDA tensors (g stays
    on the device). dt is None unless ``with_dt``."""
    if pred.device.type == "cpu":
        return masked_loss_grads_plain(pred, target, m1, m2, g, with_dt)
    if pred.device.type != "cuda":
        raise ValueError(f"masked_loss_grads runs on cuda or cpu tensors, not {pred.device}")
    _check_kernel_inputs(pred, target, m1, m2)
    if tuple(g.shape) != (3,) or g.dtype != torch.float32 or g.device != pred.device:
        raise ValueError(f"masked_loss_grads takes (3,) float32 cotangents on {pred.device}, "
                         f"not {tuple(g.shape)} {g.dtype} on {g.device}")
    g = g.contiguous()
    dp = torch.empty_like(pred)
    dt = torch.empty_like(target) if with_dt else None
    ins = (pred, target, m1, m2, dp) + ((dt,) if with_dt else ())
    n, dev = pred.numel(), pred.device
    # 4-value groups from the first value where all six pointers are 16-byte
    # aligned; none (value by value) when they never are
    h = _common_head([v.data_ptr() % 16 for v in ins], [v.element_size() for v in ins])
    head = 0 if h is None else min(h, n)
    groups = 0 if h is None else (n - head) // 4
    with _on_device(dev):
        fns = _library()
        err = fns.grads(pred.data_ptr(), target.data_ptr(), m1.data_ptr(), m2.data_ptr(),
                        g.data_ptr(), dp.data_ptr(), dt.data_ptr() if with_dt else None, n, head,
                        groups, int(pred.dtype == torch.bfloat16),
                        int(target.dtype == torch.bfloat16),
                        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "grads launch")
    masked_loss_grads.launches += 1
    return dp, dt


class _MaskedLossSums(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pred, target, m1, m2):
        ctx.save_for_backward(pred, target, m1, m2)
        return _forward(pred, target, m1, m2)

    @staticmethod
    def backward(ctx, g):
        p, t, m1, m2 = ctx.saved_tensors
        dp, dt = masked_loss_grads(p, t, m1, m2, g, ctx.needs_input_grad[1])
        return dp if ctx.needs_input_grad[0] else None, dt, None, None


def masked_loss_sums(pred, target, m1, m2):
    """(s0, s1, s2) f32 scalars: sum |d1|, sum |d1*m2|, sum (d1*m2)^2 with
    d1 = target*m1 - pred*m1, over tensors of one shape. Differentiable in
    pred and target."""
    _check(pred, target, m1, m2)
    return _MaskedLossSums.apply(pred, target, m1, m2).unbind()


@functools.lru_cache(maxsize=64)
def _mean_scale(n, device):
    return torch.tensor([1.0 / n, 1.0 / n, 5.0 / n], dtype=torch.float32, device=device)


def fused_hole_means(pred, target, m1, m2):
    """The (task, holes, holes_l2) triplet (pallas_kernels.py:142-152):
    mean|d1|, mean|d1*m2| and 5 * mean (d1*m2)^2."""
    _check(pred, target, m1, m2)
    s = _MaskedLossSums.apply(pred, target, m1, m2)
    return (s * _mean_scale(pred.numel(), s.device)).unbind()


masked_loss_sums.launches = 0
masked_loss_grads.launches = 0
