"""The remat flags (``--remat``, ``--remat_blocks``, ``--remat_tails``)
beside ``--spatial_devices 2`` on the CPU, tiny widths: one step of main,
``--SR``, I2D (``--use_D``) and stage 2 under each flag over two gloo ranks
that split each frame's rows, against the same configuration without remat
in one process, at float64 and float32.

A checkpoint's recompute runs in the backward, outside the forward's
``spatial.whole()``; it re-enters the forward's spatial state
(``parallel/spatial.py:replay``) and issues the span's collectives again,
counted apart as ``exchange_remat``, ``gather_remat`` and
``all_reduce_remat``. All the ranks' runs go in one launch; the rank
functions live in tests/test_torch_spatial_gan_ranks.py, which imports no
JAX.
"""

import numpy as np
import pytest
import torch

import test_torch_spatial_gan_ranks as G
from test_torch_common import randn  # noqa: F401  (caps torch's threads)
from test_torch_parallel_steps import ONE, _assert_terms, _ranks_agree
from test_torch_spatial_train import (
    I2D,
    JITTER_SEEDS,
    _assert_grads_within_floor,
    _i2d_batch,
    _main_argv,
)
from test_torch_sr import SR as SR_FLAGS
from test_torch_sr import _batch as _sr_batch
from test_torch_train import _batch, _covers

from desr_tpu_torch import parallel

FLAGS = ("--remat", "--remat_blocks", "--remat_tails")
KINDS = ("main", "sr", "i2d", "translation")


def _translation_argv(tmp):
    return ["--model_type", "translation", "--name", "g", "--checkpoints_dir", str(tmp),
            "--batch_size", str(G.TB), "--compute_dtype", "float32", "--crop_size_h",
            str(G.TH), "--crop_size_w", str(G.TH), "--ndf", "8", "--num_iter_gen", "1",
            "--num_iter_dis", "1"]


def _configs(tmp):
    """{kind: (argv without a remat flag, the step's args)}."""
    return {"main": (_main_argv(tmp), (_batch(), _covers())),
            "sr": (SR_FLAGS + ["--name", "sr", "--checkpoints_dir", str(tmp)], (_sr_batch(),)),
            "i2d": (I2D + ["--name", "i", "--checkpoints_dir", str(tmp)], (_i2d_batch(),)),
            "translation": (_translation_argv(tmp), (G.translation_batch(),))}


@pytest.fixture(scope="module")
def remat(tmp_path_factory):
    """One launch of two gloo ranks (one spatial group) running every kind
    under every flag at float32 and float64; the kinds without remat in one
    process at both precisions, and the float32 floors (``R.Jitter``'s two
    seeds)."""
    tmp = tmp_path_factory.mktemp("spatial_remat")
    configs = _configs(tmp)
    cases = [(f"{kind}{flag}:{dt}", kind, argv + [flag], args, dtype)
             for kind, (argv, args) in configs.items() for flag in FLAGS
             for dt, dtype in (("f32", torch.float32), ("f64", torch.float64))]
    ranks = parallel.launch(G.remat_steps, ["cpu", "cpu"], spatial=2, args=(cases,), workdir=tmp)
    one = {}
    for kind, (argv, args) in configs.items():
        one[kind] = {"f32": G.remat_step(ONE, kind, argv, args),
                     "f64": G.remat_step(ONE, kind, argv, args, torch.float64),
                     "floors": [_jittered(kind, argv, args, seed) for seed in JITTER_SEEDS]}
    return ranks, one


def _jittered(kind, argv, args, seed):
    import test_torch_spatial_train_ranks as R

    if kind == "translation":
        return G.translation_iteration(ONE, argv, *args, jitter=seed)
    if kind == "i2d":
        return R.i2d_steps(ONE, argv, *args, 1, jitter=seed)
    return R.main_step(ONE, argv, *args, sr=kind == "sr", jitter=seed)


CASES = [(kind, flag) for kind in KINDS for flag in FLAGS]


@pytest.mark.parametrize("kind,flag", CASES)
def test_remat_step_on_bands_at_float64_equals_one_process(remat, kind, flag):
    """At float64 the step under ``flag`` over two ranks gives the
    one-process step's weight gradients without remat within 1e-10
    relative L2 (a tensor at the noise floor, largest entry under 1e-4 of
    its net's, within 1e-10 of the net's largest entry), and its loss
    terms within 1e-6 relative (the metrics are reduced as float32)."""
    ranks, one = remat
    got, want = ranks[0][f"{kind}{flag}:f64"], one[kind]["f64"]
    assert got["h_split"]
    _ranks_agree([r[f"{kind}{flag}:f64"] for r in ranks], "grads")
    _assert_terms(got["metrics"], want["metrics"], 1e-6, f"{kind}{flag}")
    for n, tensors in want["grads"].items():
        assert set(got["grads"][n]) == set(tensors), n
        net_max = max(np.abs(v).max() for v in tensors.values())
        for k, v in tensors.items():
            g = got["grads"][n][k]
            if np.abs(v).max() < 1e-4 * net_max:
                np.testing.assert_allclose(g, v, rtol=0, atol=1e-10 * net_max,
                                           err_msg=f"{kind}{flag}: {n}.{k}")
            else:
                rel = np.linalg.norm(g - v) / np.linalg.norm(v)
                assert rel <= 1e-10, (kind, flag, f"{n}.{k}", rel)


@pytest.mark.parametrize("kind,flag", CASES)
def test_remat_step_on_bands_at_float32_equals_one_process(remat, kind, flag):
    """At float32 the step under ``flag`` over two ranks: the ranks hold the
    same metrics and gradients, the loss terms within 1e-5 relative of the
    one-process step without remat and the weight gradients within
    ``_assert_grads_within_floor``'s bounds (max(1e-3, 3x the one-process
    step's jittered floor) relative L2)."""
    ranks, one = remat
    got = [r[f"{kind}{flag}:f32"] for r in ranks]
    for key in ("metrics", "grads"):
        _ranks_agree(got, key)
    want = one[kind]
    _assert_terms(got[0]["metrics"], want["f32"]["metrics"], 1e-5, f"{kind}{flag}")
    _assert_grads_within_floor(got[0]["grads"], want["f32"]["grads"],
                               [f["grads"] for f in want["floors"]], f"{kind}{flag}")


@pytest.mark.parametrize("kind,flag", CASES)
def test_remat_recompute_issues_the_same_collectives_on_every_rank(remat, kind, flag):
    """Both ranks issue the same collectives, the recompute's among them
    (``exchange_remat``); under ``--remat_blocks`` and ``--remat_tails`` the
    translators' and the nets' checkpointed spans exchange rows again in the
    backward, and without remat's flag (``--remat`` where the stage checkpoints
    no whole net, I2D and stage 2) nothing is recomputed."""
    ranks, _ = remat
    for dt in ("f32", "f64"):
        c0, c1 = (r[f"{kind}{flag}:{dt}"]["counts"] for r in ranks)
        assert c0 == c1, (kind, flag, dt)
        if flag == "--remat" and kind in ("i2d", "translation"):
            assert c0["exchange_remat"] == c0["gather_remat"] == 0, (kind, c0)
        else:
            assert c0["exchange_remat"] > 0, (kind, flag, c0)
        assert c0["exchange"] > c0["exchange_bwd"] > 0, (kind, flag, c0)
