"""The port's offline evaluation against the JAX package on the CPU:
``desr_tpu_torch/metrics.py`` (the nine metrics, the CLI's dict, the numpy
copy of cv2's INTER_LINEAR), ``ops/ssim.py`` and ``gradient_penalty``."""

import importlib
import os

import cv2
import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import jax_params, randn

from desr_tpu import metrics as JM
from desr_tpu.models import networks as JNW
from desr_tpu.models.layers import Ctx
from desr_tpu.ops import losses as JLS
from desr_tpu_torch import metrics as TM
from desr_tpu_torch.models import networks as TNW
from desr_tpu_torch.ops import losses as TLS
from desr_tpu_torch.ops import ssim as TSSIM
from desr_tpu_torch.weights import from_jax_params

# the module: desr_tpu.ops re-exports the function under the same name
JSSIM = importlib.import_module("desr_tpu.ops.ssim")

SCENES = ("scene0000_00", "scene0101_02")


def _depth(rng, hw, holes=0.1):
    """uint16 mm: a smooth surface with noise, speckle holes and a block hole."""
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
    d = 1500 + 800 * np.sin(0.05 * xx) * np.cos(0.07 * yy) + rng.normal(0, 30, hw)
    d[rng.random(hw) < holes] = 0
    d[hw[0] // 4:hw[0] // 2, hw[1] // 3:hw[1] // 2] = 0
    return d.clip(0, 65535).astype(np.uint16)


def _triples(root, pred_hw, target_hw, input_hw, seed):
    """Two frames of (input, pred, target) uint16 PNGs, written with imageio
    (the JAX oracle's reader), and each scene's intrinsics."""
    rng = np.random.default_rng(seed)
    for sub in ("input", "pred", "target"):
        os.makedirs(root / sub)
    for scene in SCENES:
        name = f"{scene}_f{seed}.png"
        imageio.imwrite(root / "input" / name, _depth(rng, input_hw, 0.15))
        imageio.imwrite(root / "pred" / name, _depth(rng, pred_hw, 0.0))
        imageio.imwrite(root / "target" / name, _depth(rng, target_hw, 0.05))
        os.makedirs(root / "intr" / scene / "intrinsic")
        K = np.array([[577.0 + rng.uniform(-5, 5), 0, 319.5, 0], [0, 578.0, 239.5, 0],
                      [0, 0, 1, 0], [0, 0, 0, 1]])
        np.savetxt(root / "intr" / scene / "intrinsic" / "intrinsic_depth.txt", K)


def _paths(root):
    return [sorted(str(root / sub / f) for f in os.listdir(root / sub))
            for sub in ("input", "pred", "target")]


GEOMETRIES = {
    # pred, target, input: one grid; the SR rule (target twice the
    # prediction, subsampled) with the input resized at a non-integer ratio
    "same_size": ((60, 80), (60, 80), (60, 80)),
    "sr_rule": ((60, 80), (120, 160), (45, 61)),
}


@pytest.mark.parametrize("intrinsics", [True, False], ids=["intr", "no_intr"])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_metrics_match_jax(tmp_path, geometry, intrinsics):
    """Each frame's nine metrics (eight without intrinsics: no mse_v) and
    the CLI's dict, the port's at --n_cpus 2 (a spawned pool), within 1e-9
    relative of the JAX package's."""
    _triples(tmp_path, *GEOMETRIES[geometry], seed=len(geometry))
    inputs, preds, targets = _paths(tmp_path)
    intr = str(tmp_path / "intr") if intrinsics else None
    names = JM.DEFAULT_METRICS if intrinsics else [m for m in JM.DEFAULT_METRICS if m != "mse_v"]
    for i, p, t, scene in zip(inputs, preds, targets, SCENES):
        k = os.path.join(intr, scene, "intrinsic", "intrinsic_depth.txt") if intr else None
        want = JM.calc_metrics_for_path((i, p, t, k), names, 5100)
        got = TM.calc_metrics_for_path((i, p, t, k), names, 5100)
        assert sorted(got) == sorted(want) == sorted(names)
        for m in names:
            assert np.isfinite(want[m]), m
            np.testing.assert_allclose(got[m], want[m], rtol=1e-9, err_msg=m)
    argv = ["--input_path", str(tmp_path / "input"), "--pred_path", str(tmp_path / "pred"),
            "--target_path", str(tmp_path / "target")] + (["--intr_root", intr] if intr else [])
    want = JM.main(argv + ["--n_cpus", "1"])
    got = TM.main(argv + ["--n_cpus", "2"])
    assert sorted(got) == sorted(want) == sorted(names)
    for m in names:
        np.testing.assert_allclose(got[m], want[m], rtol=1e-9, err_msg=m)


@pytest.mark.parametrize("src,dst", [((37, 53), (60, 41)), ((100, 140), (73, 211)),
                                     ((45, 61), (120, 160)), ((120, 160), (60, 80))])
def test_resize_linear_equals_cv2(src, dst):
    """cv2.resize(INTER_LINEAR) of a float64 depth map, up, down and mixed,
    at non-integer ratios: within 1e-9 (the values are ~0-6000 mm)."""
    a = np.random.default_rng(sum(src)).uniform(0, 6000, src)
    want = cv2.resize(a, (dst[1], dst[0]), interpolation=cv2.INTER_LINEAR)
    got = TM.resize_linear(a, dst)
    assert got.shape == want.shape == dst
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("shape", [(64, 80), (48, 56, 2), (2, 40, 44, 3)],
                         ids=["hw", "hwc", "bhwc"])
def test_ssim_matches_jax(shape, monkeypatch):
    """ops/ssim.py against the offline metric's scipy SSIM within 1e-5 (one
    channel), and against the JAX function within 1e-6 with the metric's
    11x11 window in both: the JAX ``_gauss_window`` builds 10x10 (offsets
    -4..5, desr_tpu/ops/ssim.py:25), a fault of the reference package that
    moves its value by up to 5e-4 from the metric's, so the JAX side gets
    the metric's window here."""
    rng = np.random.default_rng(len(shape))
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    got = float(TSSIM.ssim(torch.from_numpy(a), torch.from_numpy(b)))
    if len(shape) == 2:
        scipy_val = JM._ssim(a.astype(np.float64), b.astype(np.float64))
        np.testing.assert_allclose(got, scipy_val, rtol=0, atol=1e-5)
    assert JSSIM._gauss_window(11, 1.5).shape == (10, 10)
    monkeypatch.setattr(JSSIM, "_gauss_window",
                        lambda size, sigma: JM.fspecial_gauss(size, sigma).astype(np.float32))
    want = float(JSSIM.ssim(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("gp_type", ["real", "fake", "mixed"])
def test_gradient_penalty_matches_jax(gp_type, monkeypatch):
    """The penalty (1e-5 relative), the gradient at the interpolate (1e-5 of
    its largest entry) and the penalty's gradient in D's weights, against
    the JAX function with the same D weights (a basic PatchGAN D, ndf 8);
    "mixed" takes the JAX draw of alpha. The biases of the convs that feed
    an InstanceNorm have an exact gradient of 0, where both frameworks keep
    float32 noise, so D's gradients are held to 1e-5 of the largest entry
    over all of them."""
    jnet = JNW.define_D(3, 8, "basic")
    params = jax_params(jnet, seed=4)
    tnet = TNW.define_D(3, 8, "basic")
    tnet.load_state_dict(from_jax_params(params), strict=True)
    real, fake = randn((2, 32, 32, 3), 5), randn((2, 32, 32, 3), 6)
    rng = jax.random.PRNGKey(7)
    ctx = Ctx(dtype=jnp.float32)

    def jax_gp(p):
        return JLS.gradient_penalty(lambda x: jnet.apply(p, x, ctx), jnp.asarray(real),
                                    jnp.asarray(fake), rng, gp_type)

    (want, want_grads), want_dw = jax.value_and_grad(jax_gp, has_aux=True)(params)
    alpha = np.asarray(jax.random.uniform(rng, (2, 1, 1, 1), jnp.float32))
    if gp_type == "mixed":
        monkeypatch.setattr(torch, "rand", lambda *a, **k: torch.from_numpy(alpha))
    got, got_grads = TLS.gradient_penalty(lambda x: tnet(x.permute(0, 3, 1, 2)),
                                          torch.from_numpy(real), torch.from_numpy(fake),
                                          torch.Generator().manual_seed(0), gp_type)
    got_dw = torch.autograd.grad(got, list(tnet.parameters()), allow_unused=True,
                                 materialize_grads=True)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    g = np.asarray(want_grads)
    np.testing.assert_allclose(got_grads.detach().numpy(), g, rtol=0,
                               atol=1e-5 * np.abs(g).max())
    scale = max(float(np.abs(np.asarray(v)).max()) for v in want_dw.values())
    for (k, _), d in zip(tnet.named_parameters(), got_dw):
        np.testing.assert_allclose(d.numpy(), np.asarray(want_dw[k]), rtol=0, atol=1e-5 * scale,
                                   err_msg=k)


def test_gradient_penalty_off_and_unknown_modes():
    x = torch.zeros(1, 4, 4, 1)
    value, grads = TLS.gradient_penalty(lambda t: t.sum((1, 2, 3)), x, x, lambda_gp=0.0)
    assert float(value) == 0.0 and grads is None
    with pytest.raises(NotImplementedError):
        TLS.gradient_penalty(lambda t: t.sum((1, 2, 3)), x, x, gp_type="both")
