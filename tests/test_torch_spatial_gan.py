"""Stage 2 (``train --model_type translation``) under the port's spatial
mesh axis (``--spatial_devices 2``) on the CPU, tiny widths: 128x128
frames at batch 2, so that the translators' bottleneck (32 global rows)
splits over two ranks and K1 reads halo rows, forward and backward.

Over two gloo ranks (one spatial group), one launch a configuration: one
iteration (one G step, then the D step on its feed, as
tests/test_torch_parallel_gan.py explains) with ``--netD basic``, ``Gu``,
``pixel`` (``--norm_d batch``) and ``basic --use_spnorm``, against the
port's one-process iteration at float32 and float64; the Gu iteration
against the JAX package's on a 1 x 2 ('data', 'spatial') mesh; a
``--use_spnorm`` PatchGAN's gradients on two bands. Without spawning:
the FOV normals on two and four bands against the whole frame.

The ranks' functions live in tests/test_torch_spatial_gan_ranks.py, which
imports no JAX.
"""

from unittest import mock

import numpy as np
import pytest
import torch

import test_torch_spatial_gan_ranks as G
from test_torch_common import randn  # noqa: F401  (caps torch's threads)
from test_torch_parallel_gan import _assert_gu
from test_torch_parallel_steps import ONE, _ranks_agree
from test_torch_spatial_train import JITTER_SEEDS, _assert_grads_within_floor

from desr_tpu_torch import parallel
from desr_tpu_torch.ops import normals as NRM
from desr_tpu_torch.parallel import spatial as S

CONFIGS = {"basic": [], "Gu": ["--netD", "Gu"], "pixel": ["--netD", "pixel", "--norm_d", "batch"],
           "spnorm": ["--use_spnorm"]}
BATCH_NORM = ("Gu", "pixel")  # the configurations whose Ds hold a BatchNorm


def _argv(tmp, extra):
    return ["--model_type", "translation", "--name", "g", "--checkpoints_dir", str(tmp),
            "--batch_size", str(G.TB), "--compute_dtype", "float32", "--crop_size_h",
            str(G.TH), "--crop_size_w", str(G.TH), "--ndf", "8", "--num_iter_gen", "1",
            "--num_iter_dis", "1", *extra]


def _jax_gu(argv, batch):
    """The JAX TranslationModel on a 1 x 2 ('data', 'spatial') mesh of the
    conftest's host devices, its translators cut as the port's: (its init,
    the iteration's metrics and state)."""
    from desr_tpu.models import translation_networks as JT
    from desr_tpu.models.translation_model import TranslationModel as JaxTranslationModel
    from desr_tpu.options.train_options import TrainOptions

    jm = JaxTranslationModel(TrainOptions().parse(argv + ["--num_devices", "2",
                                                          "--spatial_devices", "2"]))
    assert dict(jm.mesh.shape) == {"data": 1, "spatial": 2}
    small = JT.default_translator_opt(ngf_img=8, ngf_depth=8, n_blocks=1)
    jm.nets["G_A"] = JT.define_Gen(small, "img_depth")
    jm.nets["G_B"] = JT.define_Gen(small, jm.opt.inp_B)
    jm.setup()
    params0 = {n: {k: np.array(v) for k, v in p.items()} for n, p in jm.params.items()}
    jm.set_input(batch)
    jm.optimize_parameters(G.TB)
    return params0, dict(metrics={k: float(v) for k, v in jm.metrics.items()},
                         state={n: {k: np.asarray(v) for k, v in p.items()}
                                for n, p in jm.params.items()})


def _run(tmp_path_factory, name):
    """The configuration ``name``'s iteration over two ranks (float32 and
    float64, one launch) and in one process, with its float32 floors."""
    tmp = tmp_path_factory.mktemp(f"spatial_gan_{name}")
    argv, batch = _argv(tmp, CONFIGS[name]), G.translation_batch()
    params0, jax_run = _jax_gu(argv, batch) if name == "Gu" else (None, None)
    ranks = parallel.launch(G.translation_runs, ["cpu", "cpu"], spatial=2,
                            args=(argv, batch, params0, name == "spnorm"), workdir=tmp)
    one = G.translation_runs(ONE, argv, batch, params0, name == "spnorm")
    floors = [G.translation_iteration(ONE, argv, batch, params0, jitter=seed)
              for seed in JITTER_SEEDS]
    return dict(ranks=ranks, one=one, floors=floors, jax=jax_run)


@pytest.fixture(scope="module")
def basic(tmp_path_factory):
    return _run(tmp_path_factory, "basic")


@pytest.fixture(scope="module")
def gu(tmp_path_factory):
    return _run(tmp_path_factory, "Gu")


@pytest.fixture(scope="module")
def pixel(tmp_path_factory):
    return _run(tmp_path_factory, "pixel")


@pytest.fixture(scope="module")
def spnorm(tmp_path_factory):
    return _run(tmp_path_factory, "spnorm")


@pytest.fixture(params=list(CONFIGS))
def config(request):
    return request.param, request.getfixturevalue(
        {"basic": "basic", "Gu": "gu", "pixel": "pixel", "spnorm": "spnorm"}[request.param])


def test_iteration_over_two_spatial_ranks_equals_one_process(config):
    """One float32 iteration over two ranks that split each frame's rows:
    the ranks hold the same metrics, gradients and weights; every loss term
    within max(1e-5, 3x the term's floor) relative of the one-process
    iteration, the floor being the larger gap of the same iteration with
    1e-6 relative noise on K1's outputs and the norms (``G.Jitter``, two
    seeds); the G and D weight gradients as ``_assert_grads_within_floor``
    holds them; where a D holds a BatchNorm (Gu, pixel under ``--norm_d
    batch``), its running statistics and every weight after the Adam steps
    within ``_assert_gu``'s bounds."""
    name, run = config
    ranks = [r["f32"] for r in run["ranks"]]
    for key in ("metrics", "grads", "state"):
        _ranks_agree(ranks, key)
    got, want = ranks[0], run["one"]["f32"]
    assert got["h_split"] and not want["h_split"]
    assert set(got["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        floor = max(abs(f["metrics"][k] - v) / max(abs(v), 1e-12) for f in run["floors"])
        bound = max(1e-5, 3 * floor)
        assert abs(got["metrics"][k] - v) <= bound * max(abs(v), 1e-2), (name, k, bound)
    _assert_grads_within_floor(got["grads"], want["grads"],
                               [f["grads"] for f in run["floors"]], name)
    if name in BATCH_NORM:
        assert any("running_mean" in k for k in got["state"]["D_A_depth"])
        _assert_gu(got, want, name)


def test_iteration_over_two_spatial_ranks_at_float64_equals_one_process(config):
    """At float64 the same iteration over two ranks gives the one-process
    iteration's G and D weight gradients within 1e-10 relative L2 (a tensor
    at the noise floor, largest entry under 1e-4 of its net's, within 1e-10
    of the net's largest entry) and its terms within 1e-6 relative (the
    metrics are reduced as float32): the float32 gaps are rounding."""
    name, run = config
    got, want = run["ranks"][0]["f64"], run["one"]["f64"]
    _ranks_agree([r["f64"] for r in run["ranks"]], "grads")
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-6, atol=1e-7,
                                   err_msg=f"{name}: {k}")
    assert set(got["grads"]) == set(want["grads"]) and len(want["grads"]) == 6
    for n, tensors in want["grads"].items():
        net_max = max(np.abs(v).max() for v in tensors.values())
        for k, v in tensors.items():
            assert v.dtype == np.float64
            g = got["grads"][n][k]
            if np.abs(v).max() < 1e-4 * net_max:
                np.testing.assert_allclose(g, v, rtol=0, atol=1e-10 * net_max,
                                           err_msg=f"{name}: {n}.{k}")
            else:
                rel = np.linalg.norm(g - v) / np.linalg.norm(v)
                assert rel <= 1e-10, (name, f"{n}.{k}", rel)


def test_ranks_issue_the_same_collectives(config):
    """Both ranks issue the same collectives in each iteration (a branch
    that differed would have deadlocked the launch); the translators' K1
    blocks took halo rows in the backward and every exchange met its
    adjoint; the Gu and PatchGAN Ds gathered their tails (the pixel D
    returns banded logits and gathers nothing of its own)."""
    name, run = config
    for prec in ("f32", "f64"):
        c0, c1 = (r[prec]["counts"] for r in run["ranks"])
        assert c0 == c1, (name, prec)
        assert c0["K1_backwards_halo"] > 0 and c0["exchange"] > c0["exchange_bwd"] > 0, c0
        assert c0["exchange_remat"] == 0
    # a whole-logit D gathers once an apply: the G step applies the 4 Ds
    # once, the D step once more to concat(real, fake) (``d_stateless``)
    # or twice
    gathers = run["ranks"][0]["f32"]["counts"]["gather"]
    assert gathers == {"basic": 8, "Gu": 12, "pixel": 0, "spnorm": 12}[name], gathers


def test_gu_iteration_over_two_spatial_ranks_matches_jax_spatial_mesh(gu):
    """The port's Gu iteration over two spatial ranks against the JAX
    package's on its 1 x 2 ('data', 'spatial') mesh, from the JAX init:
    terms, the BatchNorms' running statistics and the weights after the
    Adam steps within ``_assert_gu``'s bounds."""
    _assert_gu(gu["ranks"][0]["f32"], gu["jax"], "JAX on a 1 x 2 spatial mesh")


def test_spnorm_patchgan_on_two_bands_equals_the_whole_frame(spnorm):
    """A ``--use_spnorm`` PatchGAN on two ranks' bands: its spectral-norm
    convs run on bands by Conv2d's rule and its stride-1 tail is gathered
    (one gather), so both ranks return the whole frame's logits and the
    input's gradient (rows concatenated) of one process within 1e-6 of the
    largest entry, and the weights' gradients (summed over the ranks)
    within 1e-5 relative L2, or of 1e-2 of the net's largest gradient norm
    for a bias before an InstanceNorm, whose exact gradient is 0
    (tests/test_torch_spatial_train.py's layer bounds)."""
    got = [r["patchgan"] for r in spnorm["ranks"]]
    want = spnorm["one"]["patchgan"]
    assert got[0]["counts"] == got[1]["counts"]
    assert got[0]["counts"]["gather"] == 1 and got[0]["counts"]["exchange"] == 2
    tol = 1e-6

    def close(a, b, what):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(np.abs(b).max(), 1.0),
                                   err_msg=what)

    np.testing.assert_array_equal(got[0]["out"], got[1]["out"])
    close(got[0]["out"], want["out"], "logits")
    close(np.concatenate([g["dx"] for g in got], 2), want["dx"], "input gradient")
    assert set(got[0]["grads"]) == set(want["grads"]) and any(
        k.endswith("weight_orig") for k in want["grads"])
    net_norm = max(np.linalg.norm(v) for v in want["grads"].values())
    for k, v in want["grads"].items():
        g = got[0]["grads"][k] + got[1]["grads"][k]
        scale = max(np.linalg.norm(v), 1e-2 * net_norm)
        assert np.linalg.norm(g - v) <= 1e-5 * scale, (k, np.linalg.norm(g - v), scale)


# ----------------------------------------------------------------- FOV normals

def _on_bands(whole, size):
    """``surface_normals_fov_planar`` of each of ``size`` equal bands of
    ``whole`` (B, H, W), the exchange served from the whole frame's rows,
    concatenated along H; and the halo rows each band took."""
    h = whole.shape[1] // size
    outs, halos = [], []
    for r in range(size):
        sp = S.Spatial(None, size, r)

        def exchange(x, top, bottom, sp_, dim, r=r):
            top, bottom = (0 if sp_.first else top), (0 if sp_.last else bottom)
            halos.append((top, bottom))
            return whole.narrow(dim, r * h - top, h + top + bottom), top, bottom

        with mock.patch.object(S, "exchange_rows", exchange):
            outs.append(NRM.surface_normals_fov_planar(S.take_h(whole, sp, 1), spatial=sp))
    return torch.cat(outs, 2), halos


@pytest.mark.parametrize("size", [2, 4])
def test_fov_normals_on_bands_equal_the_whole_frame(size):
    """The FOV normals of each band (its rows of the frame's camera grid,
    one halo row each side, reflect only at the frame's edges) are the
    whole frame's rows, bit-equal at float32; the first gy row is zero on
    the first rank alone, so the bands' first rows differ from a band
    taken as a frame of its own."""
    rng = np.random.default_rng(6)
    whole = torch.from_numpy(rng.uniform(-1, 1, (2, 128, 96)).astype(np.float32))
    want = NRM.surface_normals_fov_planar(whole)
    got, halos = _on_bands(whole, size)
    assert halos == [(0, 1)] + [(1, 1)] * (size - 2) + [(1, 0)]
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    h = 128 // size
    alone = NRM.surface_normals_fov_planar(whole[:, h:2 * h])
    assert not np.array_equal(alone.numpy(), want[:, :, h:2 * h].numpy())
