"""Training under the port's spatial mesh axis (``train --spatial_devices``)
on the CPU, float32, tiny widths.

Without spawning: K1/K2's VJP with halo rows on two bands, carried home by
the exchange's adjoint, against the whole frame's VJP; the hole sampler's
bands against its whole draw; the PatchGAN's stride-1 tail refused on a
band. Over two gloo ranks (one spatial group) in one launch: the gradient
of a seeded scalar of every layer, loss-side op and PatchGAN against one
process's, and the main, SR and I2D --use_D steps against the port's
one-process steps and the main step against the JAX package's unsharded
step. Over four ranks (2 data x 2 spatial): ``--norm batch`` steps; over
six (2 data x 3 spatial, frames that 3 does not divide, so whole): the
``--norm batch`` main step. And the train CLI over two spatial ranks.

The ranks' functions live in tests/test_torch_spatial_train_ranks.py, which
imports no JAX.
"""

import os
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_spatial_train_ranks as R
from test_torch_common import randn  # noqa: F401  (caps torch's threads)
from test_torch_parallel import _i2d_frames
from test_torch_parallel_steps import (
    ONE,
    _assert_grads,
    _assert_terms,
    _JaxHoles,
    _ranks_agree,
    _small_translator,
)
from test_torch_sr import SR as SR_FLAGS
from test_torch_sr import _batch as _sr_batch
from test_torch_train import SMALL, STAGE3, _batch, _covers

import desr_tpu.ops.depth as JDPT
import desr_tpu_torch.ops.depth as TDPT
from desr_tpu.models import translation_networks as JTN
from desr_tpu_torch import parallel
from desr_tpu_torch.models import layers as TL
from desr_tpu_torch.ops import conv3x3 as K
from desr_tpu_torch.parallel import spatial as S

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, W = 2, 128, 128  # the main step's batch (test_torch_train's): 64 rows a rank
I2D = ["--model_type", "I2D", "--batch_size", "2", "--compute_dtype", "float32",
       "--Imagef_outf", "8", "--Imagef_basef", "8", "--Task_basef", "8", "--ndf", "8",
       "--use_D", "--pool_size", "2", "--norm_loss"]
JITTER_SEEDS = (12, 13)  # the one-process floor's two draws of noise


# ----------------------------------------------------------------- K1 / K2 VJP

def _bands_vjp(run, x, cots, h):
    """The VJP of ``run`` on two bands of x (rows 0..h+1 with a halo row
    below, h-1..2h with one above), the halo rows' cotangents added to the
    rows they were read from, as the exchange's adjoint adds them: (dx,
    {name: input gradient summed over the bands})."""
    outs, grads = [], []
    for lo, hi, halo in ((0, h + 1, (0, 1)), (h - 1, 2 * h, (1, 0))):
        xb = x[:, lo:hi].detach().requires_grad_(True)
        res, ins = run(xb, *halo)
        sl = slice(0, h) if halo == (0, 1) else slice(h, 2 * h)
        torch.autograd.backward([res[0]] + list(res[1:]),
                                [cots[0][:, sl]] + [c for c in cots[1:]])
        outs.append(res[0].detach())
        grads.append((xb.grad, {k: v.grad.clone() for k, v in ins.items()}))
        for v in ins.values():
            v.grad = None
    (d0, g0), (d1, g1) = grads
    dx = torch.cat([d0[:, :h], d1[:, 1:]], 1)
    dx[:, h - 1] += d1[:, 0]
    dx[:, h] += d0[:, h]
    return dx, {k: g0[k] + g1[k] for k in g0}, torch.cat(outs, 1)


@pytest.mark.parametrize("mode", ["zeros", "reflect", "replicate"])
@pytest.mark.parametrize("variant", ["norm+relu+stats", "k2"])
def test_halo_vjp_on_two_bands_equals_the_whole_frame(mode, variant):
    """K1 (prologue, ReLU, moments with their cotangents) and K2 on two
    bands with one halo row each, through ``_vjp`` on the CPU: dx (the halo
    rows' cotangents carried home), dw, dscale and dshift (summed over the
    bands, as the gradient average and the moments' all-reduce sum them)
    equal the whole frame's at f32 within 1e-6 of their largest entry."""
    rng = np.random.default_rng(3)
    h = 10
    x = torch.from_numpy(rng.standard_normal((2, 2 * h, 9, 16)).astype(np.float32))
    params = {"w": torch.from_numpy(0.1 * rng.standard_normal((8, 16, 3, 3)).astype(np.float32)),
              "scale": torch.from_numpy(rng.uniform(0.5, 2, (2, 16)).astype(np.float32)),
              "shift": torch.from_numpy(rng.standard_normal((2, 16)).astype(np.float32))}
    cots = [torch.from_numpy(rng.standard_normal((2, 2 * h, 9, 8)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32)),
            torch.from_numpy(0.1 * rng.standard_normal((2, 8)).astype(np.float32))]

    def run(v, *halo):
        ins = {k: t.clone().requires_grad_(True) for k, t in params.items()
               if variant != "k2" or k == "w"}
        if variant == "k2":
            return (K.conv3x3(v, ins["w"], mode, *halo),), ins
        return K.conv3x3_fused(v, ins["w"], ins["scale"], ins["shift"], mode, True, True,
                               *halo), ins

    n = 1 if variant == "k2" else 3
    xw = x.clone().requires_grad_(True)
    res, ins = run(xw)
    torch.autograd.backward(list(res), cots[:n])
    before = K.conv3x3_fused.backwards_halo + K.conv3x3.backwards_halo
    dx, grads, out = _bands_vjp(run, x, cots[:n], h)
    assert K.conv3x3_fused.backwards_halo + K.conv3x3.backwards_halo == before + 2
    np.testing.assert_allclose(out.numpy(), res[0].detach().numpy(), rtol=0, atol=1e-6)
    for name, got, want in [("dx", dx, xw.grad)] + [(k, grads[k], v.grad) for k, v in ins.items()]:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-6 * float(want.abs().max()), err_msg=name)


def test_halo_vjp_holds_the_halo_rows_and_pads_only_the_edge():
    """A halo launch's dx has x's rows, the halo rows included, and equals
    the autograd of the plain composition: the band padded only at the
    frame's edge (reflect at the top here), then the conv."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((1, 7, 6, 4)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 4, 3, 3)).astype(np.float32))
    xa = x.clone().requires_grad_(True)
    out = K.conv3x3(xa, w, "reflect", 0, 1)
    cot = torch.from_numpy(rng.standard_normal(tuple(out.shape)).astype(np.float32))
    (out * cot).sum().backward()
    xb = x.clone().requires_grad_(True)
    xp = torch.nn.functional.pad(xb.permute(0, 3, 1, 2), (1, 1, 1, 0), mode="reflect")
    ref = torch.nn.functional.conv2d(xp, w).permute(0, 2, 3, 1)
    (ref * cot).sum().backward()
    assert xa.grad.shape == x.shape
    np.testing.assert_allclose(xa.grad.numpy(), xb.grad.numpy(), rtol=0, atol=1e-5)


# ----------------------------------------------------------------- one process

def test_random_rect_holes_bands_cut_the_whole_draw():
    """Each rank's mask is its rows of B and of H of the whole global
    batch's draw: the same generator state on every rank, the frames' H."""
    base = torch.ones(4, 64, 40)
    whole = TDPT.random_rect_holes(base, generator=torch.Generator().manual_seed(3))
    assert (whole == 0).any()
    for b0, b1, y0, y1 in ((0, 2, 0, 32), (0, 2, 32, 64), (2, 4, 32, 64)):
        band = TDPT.random_rect_holes(base[b0:b1, y0:y1], rows=(b0, b1, 4),
                                      h_rows=(y0, y1, 64),
                                      generator=torch.Generator().manual_seed(3))
        np.testing.assert_array_equal(band.numpy(), whole[b0:b1, y0:y1].numpy())


def test_patchgan_stride1_tail_is_refused_on_a_band():
    """The band rule: a 4x4 stride-1 conv with padding 1 gives H - 1 rows,
    so a band of it cannot give the frame's rows; a tagged conv refuses
    rather than pad its last rank to H (the PatchGAN runs its tail whole)."""
    conv = TL.Conv2d(4, 2, 4, stride=1, padding=1)
    conv.spatial = S.Spatial(None, 2, 1)
    assert not TL.band_rule(4, 1, 1) and TL.band_rule(4, 2, 1) and TL.band_rule(3, 2, 1)
    with pytest.raises(NotImplementedError, match="4x4 stride-1 conv"):
        conv(torch.zeros(1, 4, 16, 8))


# the three cases keep the ids they had while the remat flags refused a
# spatial mesh: each remat flag now runs there (tests/test_torch_spatial_remat.py),
# and so do --steps_per_call 2 and --device_aug beside it
# (tests/test_torch_spatial_last.py)
@pytest.mark.parametrize("flag,other,attr", [
    pytest.param("--remat", ["--steps_per_call", "2"], ("steps_per_call", 2), id="--remat"),
    pytest.param("--remat_blocks", ["--device_aug"], ("device_aug", True), id="--remat_blocks"),
    pytest.param("--remat_tails", ["--steps_per_call", "2"], ("steps_per_call", 2),
                 id="--remat_tails"),
])
def test_model_refuses_remat_on_a_spatial_mesh(tmp_path, capsys, flag, other, attr):
    """The train options, which every model is built from, take each remat
    flag with a spatial mesh axis, alone and beside ``--steps_per_call 2``
    or ``--device_aug``, and print no error."""
    from desr_tpu_torch.options import train_options

    argv = _main_argv(tmp_path, [flag, "--device", "cpu", "--num_devices", "2",
                                 "--spatial_devices", "2"])
    assert getattr(train_options.parse(argv, print_options=False), flag[2:])
    opt = train_options.parse(argv + other, print_options=False)
    assert getattr(opt, flag[2:]) and getattr(opt, attr[0]) == attr[1]
    train_options.check_spatial(train_options.build_parser(), opt, 2)
    assert "error" not in capsys.readouterr().err


# ----------------------------------------------------------------- two ranks

def _main_argv(tmp, extra=()):
    return STAGE3 + SMALL + ["--name", "t", "--checkpoints_dir", str(tmp), "--batch_size",
                             str(B), "--crop_size_h", str(H), "--crop_size_w", str(W), *extra]


def _i2d_batch(n=2, hw=128, seed=2):
    rng = np.random.default_rng(seed)
    batch = {k: rng.uniform(-1, 1, (n, hw, hw, c)).astype(np.float32)
             for k, c in (("A_i", 3), ("B_i", 3), ("A_d", 1), ("B_d", 1))}
    batch["B_d"][batch["B_d"] < -0.8] = -1.0
    return batch


def _jax_main_step(argv, batch, covers):
    """The JAX package's unsharded main step at its init, the covers
    injected: (params0, metrics, grads, loss names)."""
    from desr_tpu.models.main_model import MainModel as JaxMainModel
    from desr_tpu.options.train_options import TrainOptions

    from desr_tpu_torch.models.main_model import INPUT_KEYS

    holes = _JaxHoles(covers)
    with mock.patch.object(JDPT, "random_rect_holes", holes), \
            mock.patch.object(JTN, "default_translator_opt", _small_translator(JTN)):
        jm = JaxMainModel(TrainOptions().parse(argv))
        jm.init_params(0)
        params0 = {n: {k: np.array(v) for k, v in p.items()} for n, p in jm.params.items()}
        forward, losses = jm._forward_fn(), jm._losses_fn()
        jb = {k: jnp.asarray(batch[k]) for k in INPUT_KEYS}

        def loss_fn(g_train, params):
            return losses(forward(dict(params, **g_train), jb, jax.random.PRNGKey(0), True), jb)

        g_train = {n: jm.params[n] for n in ("Depth_f", "Task")}
        (_, m), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(g_train, jm.params)
    assert holes.calls == 2
    return (params0, {k: float(v) for k, v in m.items()},
            {n: {k: np.asarray(v) for k, v in g.items()} for n, g in grads.items()},
            jm.loss_names)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One launch of two gloo ranks, one spatial group: every layer's and
    op's gradients, then the main step (from the JAX init, covers
    injected), the SR step (its seeded init, holes drawn) and two I2D
    --use_D steps; the same functions in one process; and the JAX
    package's unsharded main step."""
    tmp = tmp_path_factory.mktemp("spatial_train")
    argv = _main_argv(tmp)
    batch, covers = _batch(), _covers()
    params0, jmetrics, jgrads, loss_names = _jax_main_step(argv, batch, covers)
    sr_argv = SR_FLAGS + ["--name", "sr", "--checkpoints_dir", str(tmp)]
    i2d_argv = I2D + ["--name", "i", "--checkpoints_dir", str(tmp)]
    args = ((argv, batch, covers, params0), (sr_argv, _sr_batch()), (i2d_argv, _i2d_batch(), 2))
    ranks = parallel.launch(R.spatial_steps, ["cpu", "cpu"], spatial=2, args=args, workdir=tmp)
    one = {"layers": R.layer_grads(), "steps": R.steps(ONE, *args),
           "floors": [R.steps(ONE, *args, jitter=seed) for seed in JITTER_SEEDS]}
    return dict(ranks=ranks, one=one, jax=(jmetrics, jgrads, loss_names))


def _assert_grads_within_floor(got, one, floors, what):
    """Each weight gradient within max(1e-3, 3x the one-process step's own
    floor) relative L2 of one process's, the floor being the larger gap of
    the same step jittered by 1e-6 relative from two seeds (``R.Jitter``:
    one draw can leave a tensor almost where it was); each tensor at
    the noise floor (largest entry under 1e-4 of its net's: a conv bias
    before an InstanceNorm, whose exact gradient is 0) within 1e-4 of its
    net's largest entry (``_assert_grads``)."""
    for n, tensors in one.items():
        net_max = max(np.abs(v).max() for v in tensors.values())
        for k, v in tensors.items():
            if np.abs(v).max() < 1e-4 * net_max:
                continue
            rel = lambda a: np.linalg.norm(a - v) / np.linalg.norm(v)  # noqa: E731
            bound = max(1e-3, 3 * max(rel(f[n][k]) for f in floors))
            assert rel(got[n][k]) <= bound, (what, f"{n}.{k}", rel(got[n][k]), bound)
    _assert_grads(got, one, np.inf, what)


LAYER_NAMES = list(R.SR._layers()) + list(R._nets()) + list(R._ops())


@pytest.mark.parametrize("name", LAYER_NAMES)
def test_layer_grads_over_two_ranks_equal_one_process(runs, name):
    """Each layer, op and PatchGAN on two ranks' bands: the output (rows
    concatenated; a scalar loss averaged over the ranks, N times each
    rank's share; the PatchGAN's logits whole on both), the input's
    gradient (rows concatenated) and the parameters' gradients (summed over
    the ranks, each a sum over thousands of pixels taken in another order:
    within 1e-5 relative L2, or of 1e-2 of the module's largest gradient
    norm for a bias before an InstanceNorm, whose exact gradient is 0) of a
    seeded scalar, and the BatchNorms' running statistics, against
    one process at f32 within 1e-6 of the largest entry (1e-5 through the
    nets' 6-12 norms, whose moments sum in another order)."""
    (r0, _), (r1, _) = (r["layers"] for r in runs["ranks"])
    got = (r0[name], r1[name])
    want = runs["one"]["layers"][0][name]
    tol = 1e-5 if name in ("resnet_generator", "unet", "resnet_block_t") else 1e-6

    def close(a, b, what):
        assert a.shape == b.shape, (what, a.shape, b.shape)
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(np.abs(b).max(), 1.0),
                                   err_msg=f"{name} {what}")

    if name == "replicate_pad":
        h = R.SR.FRAME[2] // 2
        for r in range(2):
            np.testing.assert_array_equal(got[r]["out"], want["out"][:, :, r * h:r * h + h + 4])
    elif name.startswith("patchgan"):
        close(got[0]["out"], want["out"], "whole logits")
        np.testing.assert_array_equal(got[0]["out"], got[1]["out"])
    elif want["out"].ndim == 0:
        close((got[0]["out"] + got[1]["out"]) / 2, want["out"], "value")
    else:
        close(np.concatenate([g["out"] for g in got], -2), want["out"], "output")
    if want["dx"] is not None:
        close(np.concatenate([g["dx"] for g in got], 2), want["dx"], "input gradient")
    assert set(got[0]["grads"]) == set(want["grads"])
    net_norm = max([np.linalg.norm(v) for v in want["grads"].values()] or [0.0])
    for k, v in want["grads"].items():
        g = got[0]["grads"][k] + got[1]["grads"][k]
        scale = max(np.linalg.norm(v), 1e-2 * net_norm)
        assert np.linalg.norm(g - v) <= 1e-5 * scale, (name, k, np.linalg.norm(g - v), scale)
    for k, v in want["stats"].items():
        np.testing.assert_array_equal(got[0]["stats"][k], got[1]["stats"][k])
        close(got[0]["stats"][k], v, k)


def test_ranks_issue_the_same_collectives(runs):
    """Both ranks issue the same collectives, forward and backward, in the
    layers and in each step (a branch that differed would have deadlocked
    the launch), and every exchange and gather met its adjoint."""
    (l0, c0), (l1, c1) = (r["layers"] for r in runs["ranks"])
    assert c0 == c1 and c0["exchange_bwd"] > 0 and c0["gather_bwd"] > 0
    s0, s1 = (r["steps"] for r in runs["ranks"])
    for kind in ("main", "sr", "i2d"):
        assert s0[kind]["counts"] == s1[kind]["counts"], kind
        c = s0[kind]["counts"]
        assert c["exchange"] > c["exchange_bwd"] > 0 and c["gather_bwd"] > 0, (kind, c)
    assert s0["main"]["counts"]["K1_backwards_halo"] > 0
    assert s0["sr"]["counts"]["K1_backwards_halo"] > 0


@pytest.mark.parametrize("kind", ["main", "sr", "i2d"])
def test_step_over_two_spatial_ranks_equals_one_process(runs, kind):
    """The main step (covers injected), the SR step at batch 1 (holes drawn
    from the hole generator, the rank keeping its rows of the whole
    frame's draw) and two I2D --use_D steps (the replay pool queried with
    whole frames) over two ranks that split each frame's rows: the ranks
    hold the same reduced metrics, gradients and weights; their loss terms
    are the one-process step's within 1e-5 relative and their weight
    gradients within 1e-3 relative L2 (tests/test_torch_parallel_steps.py's
    bounds), widened to 3x the one-process step's own floor where that is
    larger (``_assert_grads_within_floor``: the bands sum the norms'
    moments in another order, and at this random init 1e-6 of jitter alone
    moves a weight gradient of one process by up to ~1e-2); I2D's pool
    draws are one process's and its weights within 2 Adam steps' sign
    flips at the noise floor (2 x 2 lr, as
    tests/test_torch_parallel_gan.py holds them)."""
    ranks = [r["steps"][kind] for r in runs["ranks"]]
    one = runs["one"]["steps"][kind]
    for key in ("metrics", "grads", "state"):
        _ranks_agree(ranks, key)
    _assert_terms(ranks[0]["metrics"], one["metrics"], 1e-5, kind)
    _assert_grads_within_floor(ranks[0]["grads"], one["grads"],
                               [f[kind]["grads"] for f in runs["one"]["floors"]], kind)
    if kind == "i2d":
        assert ranks[0]["pool_rng"] == ranks[1]["pool_rng"] == one["pool_rng"]
        np.testing.assert_allclose(ranks[0]["pool"], one["pool"], rtol=1e-5, atol=1e-5)
        for n, tensors in one["state"].items():
            for k, v in tensors.items():
                np.testing.assert_allclose(ranks[0]["state"][n][k], v, rtol=0,
                                           atol=2 * 2 * 2e-4, err_msg=f"{n}.{k}")
        assert {"D_depth", "G_pred", "G_pred_r"} <= set(one["metrics"])
    else:
        assert all(r["split"] and r["h_split"] for r in ranks)
        assert not one["split"]


@pytest.fixture(scope="module")
def runs64(tmp_path_factory):
    """The main step (its seeded init, covers injected), the SR step and
    two I2D --use_D steps at float64 (``R.float64_steps``), over two gloo
    ranks in one launch and in one process."""
    tmp = tmp_path_factory.mktemp("spatial_train64")
    args = ((_main_argv(tmp), _batch(), _covers()),
            (SR_FLAGS + ["--name", "sr", "--checkpoints_dir", str(tmp)], _sr_batch()),
            (I2D + ["--name", "i", "--checkpoints_dir", str(tmp)], _i2d_batch(), 2))
    ranks = parallel.launch(R.float64_steps, ["cpu", "cpu"], spatial=2, args=args, workdir=tmp)
    return ranks, R.float64_steps(ONE, *args)


@pytest.mark.parametrize("kind", ["main", "sr", "i2d"])
def test_step_over_two_spatial_ranks_at_float64_equals_one_process(runs64, kind):
    """The float32 steps' gaps to one process (up to ~1e-2 relative L2 at
    this random init, ``_assert_grads_within_floor``) are rounding: at
    float64 the same steps over two ranks that split each frame's rows give
    one process's first-step weight gradients within 1e-9 relative L2
    (those at the noise floor, largest entry under 1e-4 of the net's:
    within 1e-9 of the net's largest entry), and its loss terms within
    1e-6 relative (the metrics are reduced as float32)."""
    ranks, one = runs64
    got, want = ranks[0][kind], one[kind]
    assert got["h_split"] and not want["split"]
    _ranks_agree([r[kind] for r in ranks], "grads")
    _assert_terms(got["metrics"], want["metrics"], 1e-6, kind)
    worst = 0.0
    for n, tensors in want["grads"].items():
        assert set(got["grads"][n]) == set(tensors), n
        net_max = max(np.abs(v).max() for v in tensors.values())
        for k, v in tensors.items():
            assert v.dtype == np.float64, (n, k, v.dtype)
            g = got["grads"][n][k]
            if np.abs(v).max() < 1e-4 * net_max:
                np.testing.assert_allclose(g, v, rtol=0, atol=1e-9 * net_max,
                                           err_msg=f"{kind}: {n}.{k}")
            else:
                rel = np.linalg.norm(g - v) / np.linalg.norm(v)
                assert rel <= 1e-9, (kind, f"{n}.{k}", rel)
                worst = max(worst, rel)
    terms = max(abs(got["metrics"][k] - v) / max(abs(v), 1e-12)
                for k, v in want["metrics"].items())
    print(f"{kind} float64: terms max rel {terms:.3g}, weight grads worst rel L2 {worst:.3g}")


def test_main_step_over_two_spatial_ranks_matches_jax_unsharded(runs):
    """Against the JAX package's unsharded step from the same params and
    covers: every loss term within 1e-4 relative (1e-6 absolute near 0),
    every weight gradient within 3e-2 relative L2 and every bias within
    1e-3 of its net's largest entry (tests/test_torch_train.py's bounds)."""
    jmetrics, jgrads, loss_names = runs["jax"]
    got = runs["ranks"][0]["steps"]["main"]
    for k in loss_names + ["G", "mean_of_abs_diff_syn", "mean_of_abs_diff_real"]:
        np.testing.assert_allclose(got["metrics"][k], jmetrics[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    for n in ("Depth_f", "Task"):
        net_max = max(np.abs(v).max() for v in jgrads[n].values())
        assert set(got["grads"][n]) == set(jgrads[n])
        for k, v in jgrads[n].items():
            g = got["grads"][n][k]
            if k.endswith("bias"):
                np.testing.assert_allclose(g, v, rtol=0, atol=1e-3 * net_max, err_msg=f"{n}.{k}")
            else:
                assert np.linalg.norm(g - v) / np.linalg.norm(v) <= 3e-2, f"{n}.{k}"


# ----------------------------------------------------------------- 2 x 2, 2 x 3

@pytest.fixture(scope="module")
def norm_batch(tmp_path_factory):
    """The ``--norm batch`` main step (batch 2, 128x128) and I2D --use_D
    steps in one process, with their floors: (workdir, args, one, floors)."""
    tmp = tmp_path_factory.mktemp("norm_batch")
    argv = _main_argv(tmp, ["--norm", "batch"])
    i2d = I2D + ["--name", "i", "--checkpoints_dir", str(tmp), "--norm", "batch"]
    args = ((argv, _batch(), _covers()), (i2d, _i2d_batch(), 2))
    one = R.norm_batch_steps(ONE, *args)
    floors = [R.norm_batch_steps(ONE, *args, jitter=seed) for seed in JITTER_SEEDS]
    return tmp, args, one, floors


def test_norm_batch_steps_over_a_2x2_mesh_equal_one_process(norm_batch):
    """Four gloo ranks, 2 data x 2 spatial: a ``--norm batch`` main step
    (each rank one frame's 64 rows; BatchNorm's moments over all four) and
    two I2D --use_D ``--norm batch`` steps, whose D steps move D_depth's
    running statistics (its tail runs whole, its moments over the two data
    ranks): the metrics within 1e-5 relative, gradients as
    ``_assert_grads_within_floor`` holds them, the running statistics within
    1e-5 and the weights within 2 x 2 lr of one process's."""
    tmp, args, one, floors = norm_batch
    ranks = parallel.launch(R.norm_batch_steps, ["cpu"] * 4, spatial=2, args=args,
                            workdir=tmp)
    for kind in ("main", "i2d"):
        got = [r[kind] for r in ranks]
        for key in ("metrics", "grads", "state"):
            _ranks_agree(got[:2], key)
            _ranks_agree(got[1:3], key)
        _assert_terms(got[0]["metrics"], one[kind]["metrics"], 1e-5, kind)
        _assert_grads_within_floor(got[0]["grads"], one[kind]["grads"],
                                   [f[kind]["grads"] for f in floors], kind)
        assert got[0]["split"] and got[0]["h_split"] and not one[kind]["split"]
    stats = [k for k in one["i2d"]["state"]["D_depth"] if "running" in k]
    assert stats
    for k in stats:
        np.testing.assert_allclose(ranks[0]["i2d"]["state"]["D_depth"][k],
                                   one["i2d"]["state"]["D_depth"][k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    for n, tensors in one["i2d"]["state"].items():
        for k, v in tensors.items():
            np.testing.assert_allclose(ranks[0]["i2d"]["state"][n][k], v, rtol=0,
                                       atol=2 * 2 * 2e-4, err_msg=f"{n}.{k}")


def test_norm_batch_main_step_over_2x3_whole_frames_equals_one_process(norm_batch):
    """Six gloo ranks, 2 data x 3 spatial, on 128-row frames that 3 does
    not divide: the frames stay whole, each data group's 3 ranks holding
    its frame alike, so the step counts each frame once, over the two data
    ranks. The TV terms (sums scaled by the ranks that hold distinct
    frames), the masked normalisers and BatchNorm's moments are then one
    process's: the metrics within 1e-5 relative (``tv_*`` among them),
    gradients as ``_assert_grads_within_floor`` holds them and the running
    statistics within 1e-5; no rank exchanges a row."""
    tmp, args, one, floors = norm_batch
    ranks = parallel.launch(R.main_step, ["cpu"] * 6, spatial=3, args=args[0], workdir=tmp)
    for a, b in zip(ranks, ranks[1:]):
        for key in ("metrics", "grads", "state"):
            _ranks_agree((a, b), key)
    got, want = ranks[0], one["main"]
    assert got["split"] and not got["h_split"] and not want["split"]
    assert got["counts"]["exchange"] == 0 and got["counts"]["gather"] == 0
    assert [k for k in want["metrics"] if k.startswith("tv_")]
    _assert_terms(got["metrics"], want["metrics"], 1e-5, "main 2x3")
    _assert_grads_within_floor(got["grads"], want["grads"],
                               [f["main"]["grads"] for f in floors], "main 2x3")
    stats = [(n, k) for n, t in want["state"].items() for k in t if "running" in k]
    assert stats
    for n, k in stats:
        np.testing.assert_allclose(got["state"][n][k], want["state"][n][k], rtol=1e-5,
                                   atol=1e-6, err_msg=f"{n}.{k}")


# ----------------------------------------------------------------- the CLI

def test_train_cli_i2d_use_d_over_two_spatial_ranks(tmp_path):
    """``train --device cpu --num_devices 2 --spatial_devices 2 --model_type
    I2D --use_D`` on 4 frames: one epoch of 2 steps, rank 0 writes the
    checkpoints, the loss log and the test predictions, whole frames (the
    512x640 test canvas less 16 rows each side)."""
    flags = _i2d_frames(tmp_path, 4)
    ck = tmp_path / "ck"
    argv = [sys.executable, "-m", "desr_tpu_torch.train", "--model_type", "I2D", "--use_D",
            "--do_train", "--do_test", *flags, "--Imagef_outf", "8", "--Imagef_basef", "8",
            "--Task_basef", "8", "--ndf", "8", "--compute_dtype", "float32", "--name", "e",
            "--checkpoints_dir", str(ck), "--batch_size", "2", "--batch_size_val", "2",
            "--n_epochs", "1", "--n_epochs_decay", "0", "--print_freq", "2",
            "--save_epoch_freq", "1", "--save_all", "--save_image_folder",
            str(tmp_path / "pred"), "--num_threads", "0", "--device", "cpu",
            "--num_devices", "2", "--spatial_devices", "2"]
    env = dict(os.environ, TMPDIR=str(tmp_path), OMP_NUM_THREADS="2")
    res = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    for n in ("Image_f", "Task", "D_depth"):
        assert (ck / "e" / f"latest_net_{n}.pth").exists()
    log = (ck / "e" / "loss_log.txt").read_text()
    assert log.count("(epoch: 1, iters:") == 2 and log.count("D_depth:") == 2
    pngs = sorted(os.listdir(tmp_path / "pred"))
    assert pngs == [f"scene{i:04d}_00_{i:04d}.png" for i in range(4)]
    from desr_tpu_torch.data.native_io import read_image

    assert read_image(str(tmp_path / "pred" / pngs[0])).shape[:2] == (512 - 32, 640)
