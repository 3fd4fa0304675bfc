"""Shared helpers for the port's parity tests (tests/test_torch_*.py).

Inputs are made from a numpy seed and handed to both packages as numpy
arrays: the JAX side runs NHWC in float32 on the CPU, the port NCHW, so the
helpers transpose at the boundary. This module holds no tests.
"""

import os

import jax
import numpy as np
import pytest
import torch

# the suite runs on several xdist workers: keep each one's torch pool small
torch.set_num_threads(2)


def jax_params(net, seed=0):
    """A JAX ``Net``'s initial params as a numpy dict keyed by state_dict names."""
    return {k: np.array(v) for k, v in jax.jit(net.init)(jax.random.PRNGKey(seed)).items()}


def jax_shapes(net):
    """{key: shape} of a JAX ``Net``'s params, without materialising them."""
    tree = jax.eval_shape(net.init, jax.random.PRNGKey(0))
    return {k: tuple(v.shape) for k, v in tree.items()}


def nhwc_to_nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def nchw_to_nhwc(t):
    return np.moveaxis(t.detach().cpu().numpy(), 1, -1)


def randn(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def quality_tools():
    """(the JAX package's ``tools/quality_eval.py``, the port's
    ``desr_tpu_torch/tools/quality_eval.py``) as modules."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import quality_eval as jqe

    from desr_tpu_torch.tools import quality_eval as qe

    return jqe, qe


def quality_args(root, stage, *extra):
    """The port tool's parsed options for ``stage`` on the CPU, float32."""
    _, qe = quality_tools()
    args = qe.build_parser().parse_args(
        ["--root", str(root), "--stage", stage, "--device", "cpu", *extra])
    args.ckpt_dir = os.path.join(args.root, "ckpt")
    return args


def serve_and_score_both(tmp_path, stage, dirs, intr, *extra):
    """One set of the port's seeded weights for ``stage`` (width 8,
    float32), saved as ``latest`` into both tools' checkpoint folders, then
    each tool's ``serve`` and ``score`` on the test frames ``dirs``. Returns
    ({"jax": scores, "port": scores}, {png name: max |d| in mm},
    {"jax": folder, "port": folder})."""
    import copy
    import shutil

    from desr_tpu_torch.data.native_io import read_image
    from desr_tpu_torch.options import train_options
    from desr_tpu_torch.train import create_model

    jqe, qe = quality_tools()
    args = quality_args(tmp_path / "port", stage, "--n_test", "2", "--width", "8", *extra)
    opt = train_options.parse(qe._train_argv(dirs, intr, args, "qeval")[1:],
                              print_options=False)
    create_model(opt, "cpu").save_networks("latest")
    jargs = copy.copy(args)
    jargs.root = str(tmp_path / "jax")
    jargs.ckpt_dir = os.path.join(jargs.root, "ckpt")
    shutil.copytree(os.path.join(args.ckpt_dir, "qeval"), os.path.join(jargs.ckpt_dir, "qeval"))
    scores, outs = {}, {}
    for tag, tool, a in (("jax", jqe, jargs), ("port", qe, args)):
        outs[tag] = os.path.join(a.root, "pred")
        tool.serve(dirs, a, outs[tag], "qeval")
        scores[tag] = tool.score(dirs, outs[tag], intr)
    names = sorted(os.listdir(outs["jax"]))
    assert names == sorted(os.listdir(outs["port"])) and len(names) == 2
    gaps = {n: int(np.abs(read_image(os.path.join(outs["jax"], n)).astype(np.int64)
                          - read_image(os.path.join(outs["port"], n))).max()) for n in names}
    return scores, gaps, outs


QUALITY_METRICS = {"rmse", "mae", "rmse_h", "rmse_d", "psnr", "ssim", "mae_h", "mae_d", "mse_v"}


def _never(*a, **k):
    raise AssertionError("--framework ours reached the reference arm")


@pytest.fixture
def ours_only(monkeypatch):
    """The port tool's reference arm made to fail: ``--framework ours`` must
    never reach it."""
    _, qe = quality_tools()
    for name in ("train_reference", "_install_albu_shim", "make_shared_init"):
        monkeypatch.setattr(qe, name, _never)


def check_result(res, splits, n_pred, root, arms=("pred_qeval",)):
    """The JAX tool tests' assertions: every split holds the nine metrics,
    all finite; one prediction PNG per test frame."""
    for split in splits:
        assert set(res[split]) >= QUALITY_METRICS, split
        for k, v in res[split].items():
            assert np.isfinite(v), (split, k, v)
    for arm in arms:
        assert len(os.listdir(os.path.join(str(root), arm))) == n_pred
    if "trained" in res:
        assert set(res["improvement"]) == {"rmse", "mae", "rmse_h", "rmse_d", "mse_v"}
        assert set(res["delta_higher_better"]) == {"psnr", "ssim"}
    assert set(res["seconds"]) == {"data", "train", "serve", "score"}


def reference_root():
    from reference_oracle import REFERENCE_ROOT

    if not os.path.isdir(REFERENCE_ROOT):
        pytest.skip("the original reference checkout is not available")
    return REFERENCE_ROOT
