"""The port's adversarial train steps over a data mesh of two gloo ranks on
the CPU, float32, tiny widths: one stage-2 iteration with the Gu
discriminator's BatchNorm (against the port's one-process iteration and the
JAX package's ``--num_devices 2`` one) and two I2D --use_D steps with the
replay pool (against the port's one-process steps). The main step is in
tests/test_torch_parallel_steps.py, whose helpers this file shares.
"""

import numpy as np
import pytest

import test_torch_parallel_ranks as R
from test_torch_parallel_steps import CPU2, ONE, _assert_terms, _ranks_agree
from test_torch_translation import _argv as _translation_argv
from test_torch_translation import _pair as _translation_pair

from desr_tpu_torch import parallel


# ----------------------------------------------------------------- stage 2, Gu

TB = 4  # the stage-2 batch: two rows a rank


def _translation_batch(seed=3):
    rng = np.random.default_rng(seed)
    da = rng.uniform(-0.5, 1, (TB, 64, 64, 1)).astype(np.float32)
    db = rng.uniform(-0.5, 1, (TB, 64, 64, 1)).astype(np.float32)
    db[db < -0.3] = -1.0
    return {"A_depth": da, "A_img": rng.uniform(-1, 1, (TB, 64, 64, 3)).astype(np.float32),
            "B_depth": db, "B_img": rng.uniform(-1, 1, (TB, 64, 64, 3)).astype(np.float32)}


@pytest.fixture(scope="module")
def gu_runs(tmp_path_factory):
    """One stage-2 iteration (a G step, then the D step on its feed) with
    --netD Gu at the JAX init: the JAX model on its 2-device mesh, the port
    over two ranks and in one process.

    One G step, as tests/test_torch_translation.py's Gu test takes: with two
    chained G steps Adam's sign flips at the float32 noise floor (up to
    2 + 1.89 lr a weight) already put the port's one-process iteration
    further off JAX's one-device one on the normal Ds' terms than these
    bounds, which is the chain's sensitivity and not the mesh's
    (test_one_iteration_matches_jax takes its second step from JAX's
    weights for that reason)."""
    tmp = tmp_path_factory.mktemp("gu")
    extra = ["--netD", "Gu", "--num_iter_gen", "1", "--batch_size", str(TB),
             "--num_devices", "2"]
    jm, _, params0 = _translation_pair(tmp, extra)
    assert jm.mesh.size == 2 and not jm._d_stateless()
    batch = _translation_batch()
    jm.set_input(batch)
    jm.optimize_parameters(TB)
    want = dict(metrics={k: float(v) for k, v in jm.metrics.items()},
                state={n: {k: np.asarray(v) for k, v in p.items()} for n, p in jm.params.items()})
    argv = _translation_argv(tmp, extra)
    ranks = parallel.launch(R.translation_iteration, CPU2, args=(argv, {}, params0, batch),
                            workdir=tmp)
    return dict(jax=want, ranks=ranks, one=R.translation_iteration(ONE, argv, {}, params0, batch))


def _assert_gu(got, want, what):
    """tests/test_parallel.py:250-290's bounds for the Gu BatchNorm's global
    moments: terms 2e-3 relative, running statistics rtol 2e-3 and atol
    5e-4 (each BatchNorm renormalises by moments summed in another order),
    weights rtol 2e-3 and atol 6e-4 (Adam's first steps are lr x sign)."""
    _assert_terms(got["metrics"], want["metrics"], 2e-3, what)
    for n, tensors in want["state"].items():
        for k, v in tensors.items():
            g = got["state"][n][k]
            if k.endswith("num_batches_tracked"):
                assert int(g) == int(v) == 3, f"{what}: {n}.{k}"
            elif "running" in k:
                np.testing.assert_allclose(g, v, rtol=2e-3, atol=5e-4, err_msg=f"{what}: {n}.{k}")
            else:
                np.testing.assert_allclose(g, v, rtol=2e-3, atol=6e-4, err_msg=f"{what}: {n}.{k}")


def test_gu_iteration_over_two_ranks_equals_one_process(gu_runs):
    ranks = gu_runs["ranks"]
    for key in ("metrics", "state"):
        _ranks_agree(ranks, key)
    assert any("running_mean" in k for k in ranks[0]["state"]["D_A_depth"])
    _assert_gu(ranks[0], gu_runs["one"], "one process")


def test_gu_iteration_over_two_ranks_matches_jax_num_devices_2(gu_runs):
    _assert_gu(gu_runs["ranks"][0], gu_runs["jax"], "JAX on 2 devices")


# ----------------------------------------------------------------- I2D --use_D

def test_i2d_use_d_pool_draws_over_two_ranks_equal_one_process(tmp_path):
    """Two I2D --use_D steps at batch 4 with a pool of 2 (it fills in the
    first step, then swaps): each rank queries its pool with the gathered
    global features, so both ranks' pools, and their generators' states,
    are the one-process pool's; the metrics within 1e-5 relative and the
    trained nets within 2 Adam steps' flips at the noise floor (2 steps x 2
    lr)."""
    argv = ["--model_type", "I2D", "--name", "t", "--checkpoints_dir", str(tmp_path),
            "--batch_size", "4", "--compute_dtype", "float32", "--Imagef_outf", "8",
            "--Imagef_basef", "8", "--Task_basef", "8", "--ndf", "8", "--use_D",
            "--pool_size", "2", "--norm_loss"]
    rng = np.random.default_rng(2)
    batch = {k: rng.uniform(-1, 1, (4, 128, 128, c)).astype(np.float32)
             for k, c in (("A_i", 3), ("B_i", 3), ("A_d", 1), ("B_d", 1))}
    batch["B_d"][batch["B_d"] < -0.8] = -1.0
    ranks = parallel.launch(R.i2d_steps, CPU2, args=(argv, batch, 2), workdir=tmp_path)
    one = R.i2d_steps(ONE, argv, batch, 2)
    for key in ("metrics", "pool", "state"):
        _ranks_agree(ranks, key)
    got = ranks[0]
    assert got["pool_rng"] == ranks[1]["pool_rng"] == one["pool_rng"]
    assert got["pool"].shape == one["pool"].shape == (2, 8, 128, 128)
    np.testing.assert_allclose(got["pool"], one["pool"], rtol=1e-5, atol=1e-5)
    assert {"D_depth", "G_pred", "G_pred_r"} <= set(got["metrics"])
    _assert_terms(got["metrics"], one["metrics"], 1e-5, "I2D")
    for n, tensors in one["state"].items():
        for k, v in tensors.items():
            np.testing.assert_allclose(got["state"][n][k], v, rtol=0, atol=2 * 2 * 2e-4,
                                       err_msg=f"{n}.{k}")
