"""The port's stage-3 train slice against the JAX package, fp32 on the CPU:
K1's backward, the hole sampler, normals and losses, the full train step
(loss terms, trainable grads, a few Adam steps), the main dataset, the
options and the ``python -m desr_tpu_torch.train`` driver.

The two packages draw train-time holes from different generators, so the
step tests inject the same hole masks into both by monkeypatching each
package's ``random_rect_holes`` here in the test.
"""

import argparse
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import jax_params, nhwc_to_nchw, randn

import desr_tpu.ops.depth as JDPT
import desr_tpu_torch.ops.depth as TDPT
from desr_tpu.ops import losses as JLS
from desr_tpu.ops import normals as JN
from desr_tpu.ops.pallas_conv import conv2d_pallas_fused
from desr_tpu_torch.models.main_model import MainModel
from desr_tpu_torch.ops import conv3x3 as K
from desr_tpu_torch.ops import losses as TLS
from desr_tpu_torch.ops import normals as TN
from desr_tpu_torch.options import train_options
from desr_tpu_torch.weights import from_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--ImageDepthf_outf", "8", "--ImageDepthf_basef", "8", "--Depthf_outf", "8",
         "--Depthf_basef", "8", "--I2D_base", "8", "--Task_basef", "8"]
STAGE3 = ["--model_type", "main", "--use_image_for_trans", "--use_masked", "--norm_loss",
          "--use_smooth_loss", "--w_syn_norm", "0.1", "--compute_dtype", "float32"]


# ----------------------------------------------------------------- K1 backward

def _jax_fused(mode):
    """The JAX conv with the kernel's semantics: zeros pads virtually inside
    the Pallas kernel (the prologue never touches the pad); reflect and
    replicate pad first, which commutes with the per-channel prologue."""
    if mode == "zeros":
        return lambda x, w, sc, sh: conv2d_pallas_fused(x, w, sc, sh, 1, True, True, True)
    jmode = "reflect" if mode == "reflect" else "edge"
    return lambda x, w, sc, sh: conv2d_pallas_fused(
        jnp.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)), mode=jmode), w, sc, sh, 0, True, True, True)


# the Pallas kernel's tilings: output W >= 128, input W % 8 == 0 and, with a
# prologue, C_in >= 128
@pytest.mark.parametrize("mode,shape", [
    ("zeros", (1, 16, 128, 128)), ("reflect", (1, 16, 134, 128)), ("replicate", (1, 16, 134, 128)),
])
def test_conv3x3_fused_backward_matches_jax_vjp(mode, shape):
    """dx, dw, dscale, dshift with cotangents on out, s and s2, against
    jax.vjp of the Pallas kernel (interpret mode): f32 order noise, within
    1e-4 of each gradient's largest entry."""
    cout = 16
    x = randn(shape, 1)
    w = randn((cout, shape[-1], 3, 3), 2, 0.1)
    rng = np.random.default_rng(3)
    sc = rng.uniform(0.5, 2.0, (shape[0], shape[-1])).astype(np.float32)
    sh = rng.standard_normal((shape[0], shape[-1])).astype(np.float32)
    g_out = randn(shape[:3] + (cout,), 4)
    g_s, g_s2 = randn((shape[0], cout), 5), randn((shape[0], cout), 6, 0.01)
    _, vjp = jax.vjp(_jax_fused(mode), *map(jnp.asarray, (x, w, sc, sh)))
    want = vjp((jnp.asarray(g_out), jnp.asarray(g_s), jnp.asarray(g_s2)))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, sc, sh)]
    out, s, s2 = K.conv3x3_fused(*ins, pad_mode=mode, relu=True, stats=True)
    loss = ((out * torch.from_numpy(g_out)).sum() + (s * torch.from_numpy(g_s)).sum()
            + (s2 * torch.from_numpy(g_s2)).sum())
    got = torch.autograd.grad(loss, ins)
    for name, g, v in zip(("dx", "dw", "dscale", "dshift"), got, want):
        v = np.asarray(v)
        np.testing.assert_allclose(g.numpy(), v, rtol=0, atol=1e-4 * np.abs(v).max(),
                                   err_msg=name)


def test_conv3x3_backward_matches_jax_vjp():
    """K2 (no prologue, no stats): dx, dw against jax.vjp of the plain
    Pallas conv's XLA reference, reflect border."""
    x, w = randn((2, 9, 11, 8), 7), randn((6, 8, 3, 3), 8, 0.2)
    g = randn((2, 9, 11, 6), 9)
    ref = lambda xx, ww: jax.lax.conv_general_dilated(  # noqa: E731
        jnp.pad(xx, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="reflect"), ww, (1, 1), "VALID",
        dimension_numbers=("NHWC", "OIHW", "NHWC"))
    _, vjp = jax.vjp(ref, jnp.asarray(x), jnp.asarray(w))
    want = vjp(jnp.asarray(g))
    xt, wt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    got = torch.autograd.grad((K.conv3x3(xt, wt, "reflect") * torch.from_numpy(g)).sum(), (xt, wt))
    for gg, v in zip(got, want):
        np.testing.assert_allclose(gg.numpy(), np.asarray(v), rtol=1e-5, atol=1e-5)


def test_depth_f_resnet_block_weights_get_jax_grads():
    """Every Depth_f param, the ResnetBlocks' conv weights included, gets the
    JAX gradient (a fused-chain conv that detached its weight gave none)."""
    from desr_tpu.models import layers as JL
    from desr_tpu.models import networks as JNW
    from desr_tpu_torch.models import networks as TNW

    jnet = JNW.define_G(2, 8, 8, "resnet_6blocks", n_down=2)
    params = jax_params(jnet, seed=11)
    tnet = TNW.define_G(2, 8, 8, "resnet_6blocks", n_down=2)
    tnet.load_state_dict(from_jax_params(params), strict=True)
    x, r = randn((2, 32, 32, 2), 12), randn((2, 32, 32, 8), 13)
    want = jax.jit(jax.grad(lambda p: jnp.sum(
        jnet.apply(p, jnp.asarray(x), JL.Ctx(dtype=jnp.float32)) * r)))(params)
    out = tnet(nhwc_to_nchw(x))
    (out.permute(0, 2, 3, 1) * torch.from_numpy(r)).sum().backward()
    key = "model.10.conv_block.1.weight"  # a ResnetBlock conv, through K1's Function
    assert tnet.get_parameter(key).grad is not None and float(
        tnet.get_parameter(key).grad.abs().max()) > 0
    _assert_grads_close({k: p.grad for k, p in tnet.named_parameters()}, want, "Depth_f")


# ----------------------------------------------------------------- ops

def test_random_rect_holes_contract():
    """Counts, sizes and the one shared Bernoulli draw per axis
    (depth.py:84-164): with p=1 every sample is punched, with p=0 nothing;
    punched pixels are valid ones; at 480x640 a rectangle spans at most
    W//8-1 = 79 columns and H//8-1 = 59 rows."""
    g = torch.Generator().manual_seed(0)
    base = torch.ones(16, 480, 640)
    base[:, :, :50] = 0.0  # invalid strip: never punched
    m = TDPT.random_rect_holes(base, n_max=60, p=1.0, generator=g)
    assert m.shape == base.shape and m.dtype == base.dtype
    assert set(torch.unique(m).tolist()) <= {0.0, 1.0}
    assert bool((m[:, :, :50] == 1).all())
    holes = (m == 0).float()
    per_sample = holes.sum(dim=(1, 2))
    assert bool((per_sample > 0).all())
    # the widest run of holes in a row is bounded by n_rect rectangles of < 80 columns
    assert float(per_sample.max()) <= 59 * 79 * 59
    assert bool((TDPT.random_rect_holes(base, n_max=11, p=0.0) == 1).all())
    # one Bernoulli per axis per sample: with p=0.5 some samples have no holes
    m = TDPT.random_rect_holes(torch.ones(64, 96, 128), n_max=20, p=0.5, generator=g)
    none = ((m == 0).sum(dim=(1, 2)) == 0).float().mean()
    assert 0.5 < float(none) < 0.95  # P(both axes on) = 0.25
    # a single rectangle's size range: n_min = n_max - 1 = 1 rectangle
    sizes = []
    for _ in range(50):
        m = TDPT.random_rect_holes(torch.ones(1, 480, 640), n_max=2, n_min=1, p=1.0, generator=g)
        ys, xs = torch.nonzero(m[0] == 0, as_tuple=True)
        if len(ys):
            sizes.append((int(ys.max() - ys.min()) + 1, int(xs.max() - xs.min()) + 1))
    assert sizes and all(h <= 59 and w <= 79 for h, w in sizes)
    assert max(w for _, w in sizes) > 40 and min(w for _, w in sizes) >= 1


def _depth(shape, seed):
    return np.random.default_rng(seed).uniform(-0.9, 0.9, shape).astype(np.float32)


def test_normals_match_jax():
    """Image-space and K-based normals, fp32: within 1e-5 (unit vectors)."""
    b, h, w = 2, 24, 32
    d = _depth((b, h, w), 1)
    Kmat = np.tile(np.array([[[577.0, 0, 320], [0, 577, 240], [0, 0, 1]]], np.float32), (b, 1, 1))
    crop = np.array([[0, h, 0, w], [16, 16 + h, 8, 8 + w]], np.float32)
    np.testing.assert_allclose(TN.surface_normals_planar(torch.from_numpy(d)).numpy(),
                               np.asarray(JN.surface_normals_planar(jnp.asarray(d))), atol=1e-5)
    got = TN.surface_normals_from_K_planar(*map(torch.from_numpy, (d, Kmat, crop)))
    want = JN.surface_normals_from_K_planar(*map(jnp.asarray, (d, Kmat, crop)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(TN._inv3x3(torch.from_numpy(Kmat)).numpy(),
                               np.asarray(JN._inv3x3(jnp.asarray(Kmat))), rtol=1e-6)
    z = torch.zeros(3, 4, requires_grad=True)
    TN.safe_norm(z).sum().backward()
    assert bool(torch.isfinite(z.grad).all())


def test_losses_and_their_grads_match_jax():
    """l1, mse, TV, the align-corners pyramid and the smoothness loss, fp32:
    values within 1e-5 relative, the smoothness grad within 1e-6."""
    d, p = _depth((2, 24, 32), 2), _depth((2, 24, 32), 3)
    img = randn((2, 3, 24, 32), 4)
    td, tp, timg = map(torch.from_numpy, (d, p, img))
    jd, jp, jimg = map(jnp.asarray, (d, p, img))
    for name, got, want in (
            ("l1", TLS.l1_loss(td, tp), JLS.l1_loss(jd, jp)),
            ("mse", TLS.mse_loss(td, tp), JLS.mse_loss(jd, jp)),
            ("tv", TLS.tv_loss_planar(timg), JLS.tv_loss_planar(jimg)),
            ("smooth", TLS.smooth_weight_loss_planar(tp, timg, 3),
             jax.jit(JLS.smooth_weight_loss_planar, static_argnums=2)(jp, jimg, 3))):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5, err_msg=name)
    for t, j in zip(TLS.scale_pyramid_planar(timg, 3), JLS.scale_pyramid_planar(jimg, 3)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)
    tp.requires_grad_(True)
    (g,) = torch.autograd.grad(TLS.smooth_weight_loss_planar(tp, timg, 3), tp)
    want = jax.jit(jax.grad(lambda q: JLS.smooth_weight_loss_planar(q, jimg, 3)))(jp)
    np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=1e-6)


# ----------------------------------------------------------------- train step

B, H, W = 2, 128, 128


def _batch(seed=0):
    """tests/test_model_main.py:21-37's fake batch, with holes in both depths."""
    rng = np.random.default_rng(seed)
    depth_a = rng.uniform(-0.5, 1, (B, H, W, 1)).astype(np.float32)
    depth_b = rng.uniform(-0.5, 1, (B, H, W, 1)).astype(np.float32)
    depth_a[depth_a < -0.4] = -1.0
    depth_b[depth_b < -0.3] = -1.0
    Kmat = np.tile(np.array([[[577.0, 0, 320], [0, 577, 240], [0, 0, 1]]], np.float32), (B, 1, 1))
    crop = np.tile(np.array([[0, H, 0, W]], np.float32), (B, 1))
    return {"A_i": rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32),
            "B_i": rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32),
            "A_d": depth_a, "B_d": depth_b, "K_A": Kmat, "K_B": Kmat.copy(),
            "crop_A": crop, "crop_B": crop.copy()}


def _covers():
    """Fixed rectangle covers for the real (0) and synthetic (1) branch."""
    out = []
    for seed in (1, 2):
        rng = np.random.default_rng(seed)
        cover = np.zeros((B, H, W), bool)
        for i in range(B):
            for _ in range(6):
                y, x = rng.integers(0, H, 2)
                sy, sx = rng.integers(4, 30, 2)
                cover[i, y:y + sy, x:x + sx] = True
        out.append(cover)
    return out


class _InjectHoles:
    """random_rect_holes stand-ins: call k of a forward (real, then syn)
    punches cover k % 2 where the base mask is valid."""

    def __init__(self):
        self.covers = _covers()
        self.calls = {"jax": 0, "torch": 0}

    def _next(self, pkg):
        c = self.covers[self.calls[pkg] % 2]
        self.calls[pkg] += 1
        return c

    def jax(self, rng, base, **kw):
        return jnp.where((base > 0.05) & self._next("jax"), 0.0, 1.0).astype(base.dtype)

    def torch(self, base, **kw):
        c = torch.from_numpy(self._next("torch")).to(base.device)
        return torch.where((base > 0.05) & c, 0.0, 1.0).to(base.dtype)


N_STEPS = 3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The same params, batch and holes through both packages: N_STEPS of
    JAX's train step (its forward, loss zoo, value_and_grad and adam_update,
    main_model.py:365-393, jitted once here) and of the port's."""
    from desr_tpu.models.main_model import MainModel as JaxMainModel
    from desr_tpu.ops.optim import adam_init, adam_update
    from desr_tpu.options.train_options import TrainOptions

    ck = str(tmp_path_factory.mktemp("ck"))
    argv = STAGE3 + SMALL + ["--name", "t", "--checkpoints_dir", ck, "--batch_size", str(B),
                             "--crop_size_h", str(H), "--crop_size_w", str(W)]
    inject = _InjectHoles()
    batch = _batch()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JDPT, "random_rect_holes", inject.jax)
        mp.setattr(TDPT, "random_rect_holes", inject.torch)
        jm = JaxMainModel(TrainOptions().parse(argv))
        jm.init_params(0)
        params0 = {n: {k: np.array(v) for k, v in p.items()} for n, p in jm.params.items()}
        forward, losses = jm._forward_fn(), jm._losses_fn()
        jb = {k: jnp.asarray(v) for k, v in batch.items()}

        def loss_fn(g_train, params):
            f = forward(dict(params, **g_train), jb, jax.random.PRNGKey(0), True)
            return losses(f, jb)

        value_and_grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        g_train = {n: jm.params[n] for n in ("Depth_f", "Task")}
        state = adam_init(g_train)
        jmetrics, jgrads = [], None
        for _ in range(N_STEPS):
            (_, m), grads = value_and_grad(g_train, jm.params)
            jgrads = jgrads or {n: {k: np.asarray(v) for k, v in g.items()}
                                for n, g in grads.items()}
            jmetrics.append({k: float(v) for k, v in m.items()})
            g_train, state = adam_update(grads, state, g_train, jm.opt.lr, b1=0.9, b2=0.999)
        jparams = {n: {k: np.asarray(v) for k, v in p.items()} for n, p in g_train.items()}

        tm = MainModel(train_options.parse(argv + ["--device", "cpu"], print_options=False),
                       device="cpu", compute_dtype=torch.float32, is_train=True)
        for n, p in params0.items():
            tm.nets[n].load_state_dict(from_jax_params(p), strict=True)
        tm.set_input(batch)
        tmetrics = [{k: float(v) for k, v in tm.compute_grads().items()}]
        tgrads = {n: {k: p.grad.clone() for k, p in tm.nets[n].named_parameters()}
                  for n in tm.trainable_nets}
        tm.optimizer.step()
        for i in range(1, N_STEPS):
            tm.optimize_parameters(i + 1)
            tmetrics.append({k: float(v) for k, v in tm.metrics.items()})
    assert inject.calls["torch"] == 2 * N_STEPS
    return dict(jm=jm, tm=tm, params0=params0, jgrads=jgrads, tgrads=tgrads,
                jmetrics=jmetrics, tmetrics=tmetrics, jparams=jparams)


def test_train_step_loss_terms_match_jax(runs):
    """Every loss term of the step, first step, fp32: within 1e-4 relative
    (or 1e-6 absolute for terms near 0)."""
    j, t = runs["jmetrics"][0], runs["tmetrics"][0]
    names = runs["jm"].loss_names + ["G", "mean_of_abs_diff_syn", "mean_of_abs_diff_real"]
    assert set(runs["tm"].loss_names) == set(runs["jm"].loss_names)
    for k in names:
        assert np.isfinite(t[k]), k
        np.testing.assert_allclose(t[k], j[k], rtol=1e-4, atol=1e-6, err_msg=k)


def _assert_grads_close(got, want, what):
    """Each weight's gradient within 1e-3 of its largest entry (f32 order
    noise through the backward). Each bias within 1e-3 of the net's largest
    entry: a conv bias that feeds an InstanceNorm has an exact gradient of 0
    (the norm subtracts it again), so what both packages give there is f32
    noise of that scale."""
    assert set(got) == set(want)
    net_max = max(np.abs(v).max() for v in want.values())
    for k, g in got.items():
        v = np.asarray(want[k])
        scale = net_max if k.endswith("bias") else np.abs(v).max()
        np.testing.assert_allclose(g.detach().numpy(), v, rtol=0, atol=1e-3 * max(scale, 1e-12),
                                   err_msg=f"{what}.{k}")


def test_train_step_grads_match_jax(runs):
    """Depth_f and Task grads of the first step against the JAX step's (the
    value_and_grad that MainModel._grads_for_oracle also takes): each weight
    within 3e-2 of its L2 norm, each bias within 1e-3 of the net's largest
    entry.

    The step's gradients are ill-conditioned at this random init: the Task
    inputs of the two packages differ by up to 2.3e-5 (f32 order through the
    frozen nets and Depth_f), and 1e-5 of noise on Task's input alone moves
    JAX's own weight gradients by up to 1.1e-2 of their largest entry (ReLU
    kinks). The bound is the JAX package's own against the torch reference
    (tests/test_lockstep.py:94-97 takes 3e-2). Given the same inputs and
    cotangents the nets' gradients agree within 1e-3 of their largest entry
    (test_depth_f_resnet_block_weights_get_jax_grads)."""
    for n in ("Depth_f", "Task"):
        want, got = runs["jgrads"][n], runs["tgrads"][n]
        assert set(got) == set(want)
        net_max = max(np.abs(v).max() for v in want.values())
        for k, g in got.items():
            v, g = np.asarray(want[k]), g.numpy()
            if k.endswith("bias"):
                np.testing.assert_allclose(g, v, rtol=0, atol=1e-3 * net_max, err_msg=f"{n}.{k}")
            else:
                rel = np.linalg.norm(g - v) / np.linalg.norm(v)
                assert rel <= 3e-2, (f"{n}.{k}", rel)


def test_train_trajectory_matches_jax(runs):
    """loss_G over N_STEPS Adam steps (betas 0.9, 0.999, lr 2e-4): within
    1e-4 relative of the JAX train_step's, and falling."""
    jg = [m["G"] for m in runs["jmetrics"]]
    tg = [m["G"] for m in runs["tmetrics"]]
    np.testing.assert_allclose(tg, jg, rtol=1e-4)
    assert tg[-1] < tg[0]


def test_train_step_moves_only_the_trainable_nets(runs):
    """Frozen nets bit-equal; Depth_f and Task moved in the direction JAX's
    Adam moved them over N_STEPS.

    Adam's first step is lr * sign(g), so a coordinate whose gradient is near
    0 flips with the grads' ~1e-2 noise (test_train_step_grads_match_jax).
    Each tensor with a gradient (its largest JAX entry >= 1e-4 of the net's
    largest) has its update within 0.25 relative L2 of JAX's and >= 95% of
    its coordinates moved the same way (measured: <= 0.17, >= 97.4%; a wrong
    gradient gives ~1.4 and ~50%). The conv biases that feed a norm have an
    exact gradient of 0 (theirs are <= 1e-5 of the net's largest, f32 noise):
    there Adam's range, 2 lr a step, is all both packages share."""
    tm, params0 = runs["tm"], runs["params0"]
    for n in tm.model_names:
        now = {k: v.numpy() for k, v in tm.nets[n].state_dict().items()}
        moved = any(not np.array_equal(now[k], params0[n][k]) for k in now)
        assert moved == (n in ("Depth_f", "Task")), n
        if not moved:
            continue
        grads = runs["jgrads"][n]
        net_max = max(np.abs(v).max() for v in grads.values())
        for k in now:
            dt, dj = now[k] - params0[n][k], runs["jparams"][n][k] - params0[n][k]
            if np.abs(grads[k]).max() >= 1e-4 * net_max:
                rel = np.linalg.norm(dt - dj) / np.linalg.norm(dj)
                agree = np.mean(np.sign(dt) == np.sign(dj))
                assert rel <= 0.25 and agree >= 0.95, (f"{n}.{k}", rel, agree)
            else:
                np.testing.assert_allclose(dt, dj, rtol=0, atol=2 * N_STEPS * 2e-4,
                                           err_msg=f"{n}.{k}")


def test_batched_branches_match_sequential():
    """--no_batched_branches: the real and synthetic branches as separate net
    calls give the batch-2B call's losses (per-sample layers only): f32 order
    noise, 1e-5 relative."""
    out = []
    for extra in ([], ["--no_batched_branches"]):
        opt = train_options.parse(STAGE3 + SMALL + extra + ["--device", "cpu"],
                                  print_options=False)
        m = MainModel(opt, device="cpu", compute_dtype=torch.float32, is_train=True,
                      hole_generator=torch.Generator().manual_seed(5))
        m.set_input(_batch(3))
        with torch.no_grad():
            out.append(m.losses(m.forward_all(m._batch, train=True), m._batch)[1])
    for k in out[0]:
        np.testing.assert_allclose(float(out[1][k]), float(out[0][k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("policy", ["linear", "step", "cosine"])
def test_lr_schedule_matches_jax_and_reaches_adam(policy):
    from desr_tpu.ops.optim import lr_schedule as jax_lr
    from desr_tpu_torch.ops.optim import lr_schedule

    for epoch in (1, 7, 50, 120, 199):
        assert lr_schedule(policy, epoch, 2e-4, 100, 100, 1, 50) == jax_lr(
            policy, epoch, 2e-4, 100, 100, epoch_count=1, lr_decay_iters=50)
    opt = train_options.parse(STAGE3 + SMALL + ["--lr_policy", policy, "--device", "cpu"],
                              print_options=False)
    m = MainModel(opt, device="cpu", compute_dtype=torch.float32, is_train=True)
    lr = m.update_learning_rate(150)
    assert lr == lr_schedule(policy, 150, opt.lr, 100, 100, 1, 50)
    assert all(g["lr"] == lr for g in m.optimizer.param_groups)
    assert m.optimizer.defaults["betas"] == (0.9, 0.999)


def test_model_refuses_the_as_shipped_crashes():
    base = STAGE3 + SMALL
    for argv, msg in ((base + ["--use_edge"], "CannyFilter"),
                      ([a for a in base if a != "--use_image_for_trans"], "netG_B_d"),
                      (base + ["--use_rec_as_real_input"], "--SR")):
        opt = train_options.parse(argv + ["--device", "cpu"], print_options=False)
        with pytest.raises(NotImplementedError, match=msg):
            MainModel(opt, device="cpu", is_train=True)


# ----------------------------------------------------------------- data

def _write_folder(root, n=3, hw=(256, 320), seed=0):
    """Scene-named depth/image PNGs for A and B, and their intrinsics."""
    from desr_tpu_torch.data.png import write_png

    rng = np.random.default_rng(seed)
    for dom in ("A", "B"):
        for sub in ("depth", "img"):
            os.makedirs(os.path.join(root, dom, sub), exist_ok=True)
        for i in range(n):
            name = f"scene000{i}_00_{i:04d}.png"
            write_png(os.path.join(root, dom, "depth", name),
                      rng.integers(0, 7000, hw).astype(np.uint16))
            write_png(os.path.join(root, dom, "img", name),
                      rng.integers(0, 256, hw + (3,)).astype(np.uint8))
            kdir = os.path.join(root, "intr", f"scene000{i}_00", "intrinsic")
            os.makedirs(kdir, exist_ok=True)
            np.savetxt(os.path.join(kdir, "intrinsic_depth.txt"),
                       np.diag([570.0 + i, 571.0, 1.0, 1.0]) + np.eye(4, k=2) * 200)


def _data_flags(root, hw=(256, 320)):
    paths = []
    for suffix in ("", "_test"):
        paths += [f"--path_A{suffix}", f"{root}/A/depth", f"--path_B{suffix}", f"{root}/B/depth",
                  f"--A_add_paths{suffix}", f"{root}/A/img", f"--B_add_paths{suffix}",
                  f"{root}/B/img"]
    return paths + ["--path_to_intr", f"{root}/intr", "--image_and_depth", "--use_scannet",
                    "--no_aug", "--load_size_h", str(hw[0]), "--load_size_w", str(hw[1])]


@pytest.mark.parametrize("stage", ["test", "train"])
def test_main_dataset_items_equal_jax(tmp_path, stage):
    """Bit-equal items (depth, image, K, crop, paths) on a tiny folder: the
    test branch pads to 512x640 (reflect-101), the --no_aug train branch also
    flips on the same numpy draws."""
    from desr_tpu.data.main_dataset import MainDataset as JaxDataset
    from desr_tpu.options.train_options import TrainOptions
    from desr_tpu_torch.data.main_dataset import MainDataset

    _write_folder(str(tmp_path))
    argv = ["--model_type", "main", "--name", "d", "--checkpoints_dir", str(tmp_path / "ck"),
            *_data_flags(str(tmp_path))]
    jds = JaxDataset(TrainOptions().parse(argv), stage=stage)
    tds = MainDataset(train_options.parse(argv, print_options=False), stage=stage)
    assert len(jds) == len(tds) == 3
    for i in range(3):
        a, b = jds[i], tds[i]
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k
    assert tds[0]["A_d"].shape == (512, 640, 1) and tds[0]["A_i"].shape == (512, 640, 3)


def test_loader_workers_give_the_inline_batches(tmp_path):
    """create_dataset: spawned workers (--num_threads 2) give the inline
    loader's batches, in the order the --seed shuffle draws: the sequential
    B side bit for bit (the A frame is a per-process random draw, item_rng),
    the A side in shape; --max_dataset_size caps the items."""
    from desr_tpu_torch.data.loader import create_dataset
    from desr_tpu_torch.data.main_dataset import MainDataset

    _write_folder(str(tmp_path))
    argv = ["--model_type", "main", *_data_flags(str(tmp_path)), "--batch_size_val", "2"]

    def batches(*extra):
        opt = train_options.parse(argv + list(extra), print_options=False)
        return list(create_dataset(opt, MainDataset, stage="test"))

    inline, spawned = batches("--num_threads", "0"), batches("--num_threads", "2")
    assert [len(b["A_paths"]) for b in inline] == [2, 1]
    for a, b in zip(inline, spawned, strict=True):
        assert set(a) == set(b)
        for k in a:
            if not (k.startswith("B") or k.endswith("_B")):
                assert np.shape(a[k]) == np.shape(b[k]), k
            elif isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k
    capped = batches("--num_threads", "0", "--max_dataset_size", "2")
    assert sum(len(b["A_paths"]) for b in capped) == 2


def test_unported_dataset_branches_raise(tmp_path):
    """A resize other than INTER_AREA still raises (the rotate + crop branch
    is ported: tests/test_torch_augment.py); the resize to --load_size_h/_w
    (INTER_AREA, here 256x320 -> 240x320, then padded to 512x640) gives the
    JAX dataset's items within 1e-6, test and --no_aug train branches."""
    from desr_tpu.data.main_dataset import MainDataset as JaxDataset
    from desr_tpu.options.train_options import TrainOptions
    from desr_tpu_torch.data import transforms as TT
    from desr_tpu_torch.data.main_dataset import MainDataset

    _write_folder(str(tmp_path), n=1)
    flags = _data_flags(str(tmp_path))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        TT.resize(np.zeros((4, 6), np.float32), 8, 12, interpolation=1)
    argv = ["--model_type", "main", "--name", "d", "--checkpoints_dir", str(tmp_path / "ck"),
            *flags[:-4], "--load_size_h", "240", "--load_size_w", "320"]
    for stage in ("test", "train"):
        a = JaxDataset(TrainOptions().parse(argv), stage=stage)[0]
        b = MainDataset(train_options.parse(argv, print_options=False), stage=stage)[0]
        assert set(a) == set(b) and b["A_d"].shape == (512, 640, 1)
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-6, err_msg=k)
            else:
                assert a[k] == b[k], k


# ----------------------------------------------------------------- options + driver

def _jax_parser():
    from desr_tpu.models import get_option_setter
    from desr_tpu.options.train_options import TrainOptions

    p = TrainOptions().initialize(argparse.ArgumentParser())
    return get_option_setter("main")(p, True)


def test_every_port_flag_default_equals_jax():
    """Each flag the port runs has the JAX TrainOptions default (main stage
    included), --device_aug and --profile_dir among them; every JAX flag is
    known to the port, so none gets argparse's unknown-flag error."""
    jp, tp = _jax_parser(), train_options.build_parser()
    port = {s: a for a in tp._actions for s in a.option_strings}
    refused = {f"--{n}" for n in train_options.XLA_ONLY}
    checked = 0
    for a in jp._actions:
        for s in a.option_strings:
            if s in ("-h", "--help"):
                continue
            assert s in port, s
            if s not in refused:
                assert (port[s].dest, port[s].default) == (a.dest, a.default), s
                checked += 1
    assert checked > 150
    assert {"--device_aug", "--profile_dir"} <= set(port) - refused


# the first two cases keep the ids they had while every --spatial_devices > 1
# refused: translation still does, and one device does not divide by S = 2
@pytest.mark.parametrize("flag,msg", [
    pytest.param(["--num_devices", "2", "--spatial_devices", "2", "--model_type", "translation"],
                 "not yet ported", id="flag0-not yet ported"),
    pytest.param(["--spatial_devices", "2"], "--num_devices 1 does not divide by "
                 "--spatial_devices 2", id="flag1-not yet ported"),
    (["--no_donate"], "no counterpart"), (["--fold_norm"], "no counterpart"),
    (["--lr_policy", "bogus"], "not implemented"), (["--bogus_flag"], "unrecognized"),
])
def test_train_cli_refuses_what_it_does_not_run(flag, msg, capsys):
    from desr_tpu_torch import train

    with pytest.raises(SystemExit) as e:
        train.main(["--model_type", "main", "--device", "cpu", *flag])
    assert e.value.code != 0 and msg in capsys.readouterr().err


def test_train_cli_needs_a_card_or_device_cpu(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "desr_tpu_torch.train", "--model_type", "main",
         "--use_image_for_trans", "--name", "x", "--checkpoints_dir", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0 and "no CUDA device" in res.stderr


def test_train_cli_runs_an_epoch_on_the_cpu(tmp_path, monkeypatch):
    """main(argv) end to end with --device cpu: two train steps, a test pass
    with --save_all (uint16 PNGs, rows [16:-16] of the 512x640 prediction),
    checkpoints and the loss log. The translator is cut to 8+8 base
    channels and one block here (its widths are hardcoded)."""
    from desr_tpu_torch import train
    from desr_tpu_torch.models import translation_networks as TT

    small = TT.default_translator_opt
    monkeypatch.setattr(TT, "default_translator_opt",
                        lambda: small(ngf_img=8, ngf_depth=8, n_blocks=1))
    _write_folder(str(tmp_path), n=2)
    ck = tmp_path / "ck"
    losses = train.main([*STAGE3, *SMALL, *_data_flags(str(tmp_path)), "--name", "e",
                         "--checkpoints_dir", str(ck), "--do_train", "--do_test",
                         "--continue_train", "--batch_size", "1", "--n_epochs", "1",
                         "--n_epochs_decay", "0", "--print_freq", "1", "--save_epoch_freq", "1",
                         "--save_all", "--save_image_folder", str(tmp_path / "pred"),
                         "--num_threads", "0",
                         "--device", "cpu"])
    assert losses and all(np.isfinite(v) for v in losses.values())
    for n in MainModel.model_names:
        assert (ck / "e" / f"latest_net_{n}.pth").exists()
        assert (ck / "e" / f"1_net_{n}.pth").exists()
    log = (ck / "e" / "loss_log.txt").read_text()
    assert log.count("(epoch: 1, iters:") == 2
    from desr_tpu_torch.data.png import read_png

    preds = sorted(os.listdir(tmp_path / "pred"))
    assert preds == ["scene0000_00_0000.png", "scene0001_00_0001.png"]
    arr = read_png(tmp_path / "pred" / preds[0])
    assert arr.dtype == np.uint16 and arr.shape == (480, 640)
