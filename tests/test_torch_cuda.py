"""The port's CUDA kernels (K1/K2 conv3x3, K3 masked-loss sums) against their
plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device. The file
imports neither JAX nor anything of ``desr_tpu``, so that it runs on a machine
with the card and no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from desr_tpu_torch.ops import conv3x3 as K
from desr_tpu_torch.ops import masked_loss as K3

torch.set_num_threads(2)

# out: f32 summation order over 9 * C_in terms (float32); at most one bf16
# step apart after the same f32 sum in another order (bfloat16).
# s, s2: f32 summation order over the H * W pixels.
OUT_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-3),
           torch.bfloat16: dict(rtol=2 ** -7, atol=1e-3)}
STATS_TOL = dict(rtol=1e-4, atol=1e-2)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, cout, seed, dev):
    rng = np.random.default_rng(seed)
    b, c = shape[0], shape[-1]
    arrs = (rng.standard_normal(shape), 0.1 * rng.standard_normal((cout, c, 3, 3)),
            rng.uniform(0.5, 2.0, (b, c)), rng.standard_normal((b, c)))
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrs]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["reflect", "replicate", "zeros"])
def test_cuda_kernel_matches_plain(mode, dtype):
    """Ragged tiles (21x37), C_in not a multiple of the 16-channel chunk (72)
    and C_out not a multiple of the 64-channel block tile (80)."""
    dev = _cuda()
    dt = getattr(torch, dtype)
    x, w, scale, shift = _inputs((2, 21, 37, 72), 80, 51, dev)
    x = x.to(dt)
    for sc, sh, relu in ((None, None, False), (scale, shift, True), (scale, shift, False)):
        got = K.conv3x3_fused(x, w, sc, sh, mode, relu, True)
        want = K.conv3x3_fused_plain(x, w, sc, sh, mode, relu, True)
        torch.testing.assert_close(got[0].float(), want[0].float(), **OUT_TOL[dt])
        for g, v in zip(got[1:], want[1:]):
            torch.testing.assert_close(g, v, **STATS_TOL)
    torch.testing.assert_close(K.conv3x3(x, w, mode).float(),
                               K.conv3x3_fused_plain(x, w, pad_mode=mode).float(),
                               **OUT_TOL[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cout,mode", [
    ((1, 2, 2, 3), 5, "reflect"), ((1, 1, 7, 20), 3, "replicate"), ((3, 1, 1, 1), 1, "zeros"),
])
def test_cuda_kernel_takes_tiny_shapes(shape, cout, mode):
    dev = _cuda()
    x, w, scale, shift = _inputs(shape, cout, 61, dev)
    for dt in (torch.float32, torch.bfloat16):
        got = K.conv3x3_fused(x.to(dt), w, scale, shift, mode, True, True)
        want = K.conv3x3_fused_plain(x.to(dt), w, scale, shift, mode, True, True)
        torch.testing.assert_close(got[0].float(), want[0].float(), **OUT_TOL[dt])
        for g, v in zip(got[1:], want[1:]):
            torch.testing.assert_close(g, v, **STATS_TOL)


@pytest.mark.cuda
def test_cuda_stats_are_deterministic():
    """The moments come from per-tile partials and a fixed-order second
    pass (no float atomics): two launches give the same bits."""
    dev = _cuda()
    x, w, scale, shift = _inputs((2, 40, 48, 64), 64, 71, dev)
    x = x.to(torch.bfloat16)
    a = K.conv3x3_fused(x, w, scale, shift, "reflect", True, True)
    b = K.conv3x3_fused(x, w, scale, shift, "reflect", True, True)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.cuda
@pytest.mark.parametrize("case,err", [
    ("float16", TypeError), ("strided", ValueError), ("w_on_cpu", ValueError),
])
def test_cuda_wrapper_raises_instead_of_falling_back(case, err):
    dev = _cuda()
    x = torch.zeros(2, 6, 9, 4, device=dev)
    w = torch.zeros(8, 4, 3, 3, device=dev)
    if case == "float16":
        x = x.half()
    elif case == "strided":
        x = torch.zeros(2, 6, 18, 4, device=dev)[:, :, ::2]
    else:
        w = w.cpu()
    before = K.conv3x3_fused.launches
    with pytest.raises(err):
        K.conv3x3_fused(x, w, pad_mode="reflect")
    assert K.conv3x3_fused.launches == before


# ------------------------------------------------------------------ K1 backward

@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["reflect", "replicate", "zeros"])
def test_cuda_conv3x3_fused_grads_match_plain_autograd(mode):
    """The kernel's forward under the autograd Function, backward included:
    dx, dw, dscale, dshift with cotangents on out, s and s2, against autograd
    of the plain version on the card (float32, TF32 off): within 1e-4 of each
    gradient's largest entry."""
    dev = _cuda()
    x, w, scale, shift = _inputs((2, 21, 37, 72), 80, 52, dev)
    rng = np.random.default_rng(53)
    g_out = torch.from_numpy(rng.standard_normal((2, 21, 37, 80)).astype(np.float32)).to(dev)
    g_s = torch.from_numpy(rng.standard_normal((2, 80)).astype(np.float32)).to(dev)
    g_s2 = 0.01 * torch.from_numpy(rng.standard_normal((2, 80)).astype(np.float32)).to(dev)
    grads = []
    for fn in (K.conv3x3_fused, K.conv3x3_fused_plain):
        ins = [t.clone().requires_grad_(True) for t in (x, w, scale, shift)]
        out, s, s2 = fn(*ins, mode, True, True)
        loss = (out * g_out).sum() + (s * g_s).sum() + (s2 * g_s2).sum()
        grads.append(torch.autograd.grad(loss, ins))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))


# ------------------------------------------------------------------ K3


def _loss_inputs(shape, seed, dev, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    p, t = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for _ in range(2))
    m1, m2 = (torch.from_numpy((rng.random(shape) > q).astype(np.float32)) for q in (0.3, 0.6))
    return p.to(dev, dtype), t.to(dev, dtype), m1.to(dev), m2.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(6, 512, 640), (3, 37, 41), (1, 1, 3)])
def test_cuda_masked_loss_matches_plain(shape, dtype):
    """Each sum within 1e-5 of itself (its terms are >= 0: f32 summation
    order only), ragged tails (not a multiple of 4) included."""
    dev = _cuda()
    ins = _loss_inputs(shape, 81, dev, getattr(torch, dtype))
    got = torch.stack(K3.masked_loss_sums(*ins))
    want = K3.masked_loss_sums_plain(*ins)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_cuda_masked_loss_takes_misaligned_views_and_is_deterministic():
    """A view one element into its storage is not aligned for vector loads
    (the scalar path runs); two launches give the same bits."""
    dev = _cuda()
    p, t, m1, m2 = (v.flatten()[1:] for v in _loss_inputs((4, 33, 50), 82, dev))
    got = torch.stack(K3.masked_loss_sums(p, t, m1, m2))
    torch.testing.assert_close(got, K3.masked_loss_sums_plain(p, t, m1, m2), rtol=1e-5, atol=1e-6)
    assert torch.equal(got, torch.stack(K3.masked_loss_sums(p, t, m1, m2)))


@pytest.mark.cuda
def test_cuda_masked_loss_grads_and_launch_count():
    dev = _cuda()
    p, t, m1, m2 = _loss_inputs((2, 40, 48), 83, dev)
    p.requires_grad_(True)
    before = K3.masked_loss_sums.launches
    task, holes, l2 = K3.fused_hole_means(p, t, m1, m2)
    (g,) = torch.autograd.grad(task + 2 * holes + 3 * l2, p)
    assert K3.masked_loss_sums.launches == before + 1
    n = p.numel()
    d1 = (t * m1 - p * m1).detach()
    d2 = d1 * m2
    want = -(torch.sign(d1) / n + m1 * (2 * torch.sign(d2) / n + 3 * 2 * d2 * 5 / n)) * m1
    torch.testing.assert_close(g, want, rtol=1e-6, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("case,err", [("float16", TypeError), ("strided", ValueError)])
def test_cuda_masked_loss_raises_instead_of_falling_back(case, err):
    dev = _cuda()
    p, t, m1, m2 = _loss_inputs((2, 8, 16), 84, dev)
    if case == "float16":
        p = p.half()
    else:
        p = torch.zeros(2, 8, 32, device=dev)[:, :, ::2]
    before = K3.masked_loss_sums.launches
    with pytest.raises(err):
        K3.masked_loss_sums(p, t, m1, m2)
    assert K3.masked_loss_sums.launches == before
