"""The port's K3 module (desr_tpu_torch/ops/masked_loss.py) against the JAX
Pallas masked-loss kernel.

On the CPU the port's wrapper takes the plain PyTorch version; the JAX side
runs the Pallas kernel in interpret mode and its pure-jnp reference. The CUDA
kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py and chip_smoke.py phase (b')).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import randn

from desr_tpu.ops import pallas_kernels as PK
from desr_tpu_torch.ops import masked_loss as K3


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    p = randn(shape, seed)
    t = randn(shape, seed + 1)
    m1 = (rng.random(shape) > 0.3).astype(np.float32)
    m2 = (rng.random(shape) > 0.6).astype(np.float32)
    return p, t, m1, m2


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


# f32 summation order over up to 12k terms of |d| <= ~6: each sum within
# 1e-5 relative (s2 too, its terms are squares of the same d)
SHAPES = [(2, 48, 64), (3, 37, 41), (1, 1, 5)]


@pytest.mark.parametrize("shape", SHAPES, ids=["aligned", "ragged", "tiny"])
def test_sums_match_pallas_and_reference(shape):
    p, t, m1, m2 = _inputs(shape, seed=sum(shape))
    want = PK.masked_loss_sums(*map(jnp.asarray, (p, t, m1, m2)), force_interpret=True)
    ref = PK.masked_loss_sums_reference(*map(jnp.asarray, (p, t, m1, m2)))
    got = K3.masked_loss_sums(*_t(p, t, m1, m2))
    for g, w, r in zip(got, want, ref):
        assert g.dtype == torch.float32 and g.dim() == 0
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)
        np.testing.assert_allclose(float(g), float(r), rtol=1e-5)


def test_bf16_inputs_upcast_as_they_load():
    """bf16 pred/target: the sums are those of the f32 upcast values."""
    p, t, m1, m2 = _inputs((2, 20, 30), seed=3)
    pb, tb = torch.from_numpy(p).bfloat16(), torch.from_numpy(t).bfloat16()
    got = K3.masked_loss_sums(pb, tb, *_t(m1, m2))
    want = PK.masked_loss_sums_reference(jnp.asarray(pb.float().numpy()),
                                         jnp.asarray(tb.float().numpy()),
                                         jnp.asarray(m1), jnp.asarray(m2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)


@pytest.mark.parametrize("shape", [(2, 24, 32), (3, 7, 11)], ids=["aligned", "ragged"])
def test_grads_match_jax_custom_vjp(shape):
    """The closed-form backward (pallas_kernels.py:129-136) against jax.vjp of
    masked_loss_sums_diff with cotangents on all three sums; the masks get
    no gradient. Elementwise f32 arithmetic: within 1e-6."""
    p, t, m1, m2 = _inputs(shape, seed=7)
    cot = np.array([0.7, -1.3, 0.4], np.float32)
    _, vjp = jax.vjp(lambda a, b: PK.masked_loss_sums_diff(a, b, jnp.asarray(m1),
                                                           jnp.asarray(m2), True),
                     jnp.asarray(p), jnp.asarray(t))
    wp, wt = vjp(tuple(jnp.float32(c) for c in cot))
    pt, tt, m1t, m2t = _t(p, t, m1, m2)
    pt.requires_grad_(True)
    tt.requires_grad_(True)
    m1t.requires_grad_(True)
    sums = K3.masked_loss_sums(pt, tt, m1t, m2t)
    loss = sum(float(c) * s for c, s in zip(cot, sums))
    gp, gt, gm = torch.autograd.grad(loss, (pt, tt, m1t), allow_unused=True)
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=0, atol=1e-6)
    np.testing.assert_allclose(gt.numpy(), np.asarray(wt), rtol=0, atol=1e-6)
    assert gm is None


def _jax_vjp(p, t, m1, m2, cot):
    _, vjp = jax.vjp(lambda a, b: PK.masked_loss_sums_diff(a, b, jnp.asarray(m1),
                                                           jnp.asarray(m2), True),
                     jnp.asarray(p), jnp.asarray(t))
    return [np.asarray(v) for v in vjp(tuple(jnp.float32(c) for c in cot))]


@pytest.mark.parametrize("with_dt", [True, False], ids=["with_dt", "no_dt"])
def test_grads_plain_match_jax_vjp(with_dt):
    """masked_loss_grads_plain, the kernel's oracle on the card, against
    jax.vjp of masked_loss_sums_diff at f32 (1e-6); without dt it returns
    None for target."""
    p, t, m1, m2 = _inputs((3, 7, 11), seed=9)
    cot = np.array([-0.6, 1.1, 0.25], np.float32)
    wp, wt = _jax_vjp(p, t, m1, m2, cot)
    dp, dt = K3.masked_loss_grads_plain(*_t(p, t, m1, m2), torch.from_numpy(cot), with_dt)
    np.testing.assert_allclose(dp.numpy(), wp, rtol=0, atol=1e-6)
    if with_dt:
        np.testing.assert_allclose(dt.numpy(), wt, rtol=0, atol=1e-6)
    else:
        assert dt is None


def test_target_without_grad_gets_no_dt_computed(monkeypatch):
    """The main path's targets are data: autograd asks the backward for dp
    only, and dt is never computed; dp still equals JAX's."""
    p, t, m1, m2 = _inputs((2, 16, 24), seed=13)
    cot = np.array([0.5, -0.2, 1.5], np.float32)
    wp, _ = _jax_vjp(p, t, m1, m2, cot)
    seen, plain = [], K3.masked_loss_grads_plain

    def spy(*args):
        seen.append(args[-1])
        return plain(*args)

    monkeypatch.setattr(K3, "masked_loss_grads_plain", spy)
    pt, tt, m1t, m2t = _t(p, t, m1, m2)
    pt.requires_grad_(True)
    sums = K3.masked_loss_sums(pt, tt, m1t, m2t)
    (gp,) = torch.autograd.grad(sum(float(c) * s for c, s in zip(cot, sums)), (pt,))
    assert seen == [False]
    np.testing.assert_allclose(gp.numpy(), wp, rtol=0, atol=1e-6)


def _block_ranges(plan):
    """Each block's values as csrc/masked_loss.cu walks them (block_range,
    add_edges): its share of the units, and for block 0 the head and tail."""
    q, r = divmod(plan.units, plan.grid)
    body_end = plan.head + plan.units * plan.unit
    out = []
    for b in range(plan.grid):
        begin, count = b * q + min(b, r), q + (b < r)
        ranges = [(plan.head + begin * plan.unit, plan.head + (begin + count) * plan.unit)]
        out.append(ranges + ([(0, plan.head), (body_end, plan.n)] if b == 0 else []))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offsets", [(0,) * 4, (1,) * 4, (2,) * 4, (3,) * 4, (1, 0, 0, 0)],
                         ids=["off0", "off1", "off2", "off3", "pred_off1"])
@pytest.mark.parametrize("n", [1, 3, 4, 5, 8191, 8193, 1_310_720, 1_966_083])
def test_launch_plan_covers_every_value_once(n, offsets, dtype):
    """The sums kernel's plan on 132 SMs: pred and target of ``dtype`` and f32
    masks, each a view ``offsets`` values into 16-byte aligned storage. Every
    value is read exactly once; the body's ranges differ by at most one unit
    and start 16-byte aligned in every input, with whole 16-byte multiples of
    each; the grid is whole waves (or one block per MIN_BLOCK_VALUES values)
    within the resident blocks."""
    sms, resident = 132, 2
    size = 2 if dtype == "bfloat16" else 4
    sizes = (size, size, 4, 4)
    bases = (1 << 20, 3 << 20, 5 << 20, 7 << 20)
    addrs = [b + o * s for b, o, s in zip(bases, offsets, sizes)]
    plan = K3.launch_plan(n, addrs, sizes, sms, resident)
    seen = np.zeros(n, np.int32)
    counts = set()
    for b, ranges in enumerate(_block_ranges(plan)):
        (lo, hi), edges = ranges[0], ranges[1:]
        counts.add(hi - lo)
        for a, z in ranges:
            seen[a:z] += 1
        if plan.unit > 1 and hi > lo:
            for addr, s in zip(addrs, sizes):
                assert (addr + lo * s) % 16 == 0 and ((hi - lo) * s) % 16 == 0
    assert (seen == 1).all()
    assert max(counts) - min(counts) <= plan.unit
    assert 1 <= plan.grid <= sms * resident
    if plan.unit > 1:
        assert plan.unit == 16 // min(sizes)
        assert plan.head < 8 and n - plan.head - plan.units * plan.unit < plan.unit
    else:
        assert offsets == (1, 0, 0, 0)
    per_block = max(1, K3.MIN_BLOCK_VALUES // plan.unit)
    if plan.units >= sms * per_block:
        assert plan.grid % sms == 0
    else:
        assert plan.grid == max(1, -(-plan.units // per_block))


def test_fused_hole_means_match_jax():
    p, t, m1, m2 = _inputs((2, 32, 40), seed=11)
    want = PK.fused_hole_means(*map(jnp.asarray, (p, t, m1, m2)), force_interpret=True)
    got = K3.fused_hole_means(*_t(p, t, m1, m2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)


@pytest.mark.parametrize("case,err,match", [
    ("shape", ValueError, "shape"), ("device", ValueError, "meta"),
])
def test_wrapper_rejects_mismatched_inputs(case, err, match):
    p = torch.zeros(2, 3, 4)
    m = torch.zeros(2, 3, 5) if case == "shape" else torch.zeros(2, 3, 4, device="meta")
    with pytest.raises(err, match=match):
        K3.masked_loss_sums(p, p, m, torch.zeros(2, 3, 4))


@pytest.mark.parametrize("case,err", [
    ("float16", TypeError), ("float64_mask", TypeError), ("strided", ValueError),
])
def test_kernel_path_raises_instead_of_falling_back(case, err):
    """The launch path checks what the CUDA kernel takes before it builds or
    launches anything, and raises: no plain-version fallback (checked here on
    CPU tensors handed to it directly)."""
    p = torch.zeros(2, 6, 8)
    m1 = torch.zeros(2, 6, 8)
    if case == "float16":
        p = p.half()
    elif case == "float64_mask":
        m1 = m1.double()
    else:
        p = torch.zeros(2, 6, 16)[:, :, ::2]
    with pytest.raises(err):
        K3._launch(p, torch.zeros(2, 6, 8), m1, torch.zeros(2, 6, 8))
