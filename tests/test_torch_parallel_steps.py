"""The port's train steps over a data mesh of two gloo ranks on the CPU,
float32, tiny widths: the main step with holes against the port's
one-process step on the same global batch and against the JAX package's
``--num_devices 2`` step on the conftest's virtual devices. The stage-2 and
I2D steps are in tests/test_torch_parallel_gan.py.

The ranks run the functions of tests/test_torch_parallel_ranks.py
(``parallel.launch``, a file rendezvous under the test's tmp dir); the
one-process reference runs the same function on a mesh of one device.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import test_torch_parallel_ranks as R
from test_torch_train import SMALL, STAGE3, _batch, _covers

import desr_tpu.ops.depth as JDPT
from desr_tpu.models import translation_networks as JTN
from desr_tpu_torch import parallel
from desr_tpu_torch.models.main_model import INPUT_KEYS

CPU2 = ["cpu", "cpu"]
ONE = parallel.make_mesh(["cpu"])
B, H, W = 2, 128, 128  # the main step's batch (test_torch_train's): one row a rank


def _assert_terms(got, want, rtol, what, atol=1e-7):
    assert set(got) == set(want), what
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=rtol, atol=atol, err_msg=f"{what}: {k}")


def _assert_grads(got, want, bound, what):
    """Each tensor within ``bound`` relative L2 of ``want``'s. A tensor whose
    largest entry is below 1e-4 of its net's largest sits at the float32
    noise floor (a conv bias that feeds an InstanceNorm has an exact
    gradient of 0): it is held within 1e-4 of the net's largest entry."""
    for n, tensors in want.items():
        assert set(got[n]) == set(tensors), n
        net_max = max(np.abs(v).max() for v in tensors.values())
        for k, v in tensors.items():
            g = got[n][k]
            if np.abs(v).max() < 1e-4 * net_max:
                np.testing.assert_allclose(g, v, rtol=0, atol=1e-4 * net_max,
                                           err_msg=f"{what}: {n}.{k}")
            else:
                rel = np.linalg.norm(g - v) / np.linalg.norm(v)
                assert rel <= bound, (what, f"{n}.{k}", rel)


def _ranks_agree(ranks, key):
    """The ranks hold the same reduced values (bit-equal)."""
    a, b = ranks
    if isinstance(a[key], dict):
        for k in a[key]:
            _ranks_agree(({key: a[key][k]}, {key: b[key][k]}), key)
    elif isinstance(a[key], np.ndarray):
        np.testing.assert_array_equal(a[key], b[key])
    else:
        assert a[key] == b[key], key


# ----------------------------------------------------------------- main step

def _small_translator(mod):
    full = mod.default_translator_opt
    return lambda **kw: full(ngf_img=8, ngf_depth=8, n_blocks=1, **kw)


class _JaxHoles:
    """The JAX package's ``random_rect_holes`` stand-in: call k punches
    cover k % 2 (real, then syn) where the base mask is valid."""

    def __init__(self, covers):
        self.covers, self.calls = covers, 0

    def __call__(self, rng, base, **kw):
        cover = self.covers[self.calls % 2]
        self.calls += 1
        return jnp.where((base > 0.05) & cover, 0.0, 1.0).astype(base.dtype)


@pytest.fixture(scope="module")
def main_runs(tmp_path_factory):
    """The main step (stage 3's loss flags, holes on) at the JAX init:
    JAX's ``--num_devices 2`` value_and_grad on the sharded batch with the
    covers injected; the port's over two ranks and in one process, with the
    covers injected and with the holes drawn from the hole generator."""
    from desr_tpu.models.main_model import MainModel as JaxMainModel
    from desr_tpu.options.train_options import TrainOptions

    tmp = tmp_path_factory.mktemp("main")
    argv = STAGE3 + SMALL + ["--name", "t", "--checkpoints_dir", str(tmp), "--batch_size",
                             str(B), "--crop_size_h", str(H), "--crop_size_w", str(W)]
    batch, covers = _batch(), _covers()
    holes = _JaxHoles(covers)
    with mock.patch.object(JDPT, "random_rect_holes", holes), \
            mock.patch.object(JTN, "default_translator_opt", _small_translator(JTN)):
        jm = JaxMainModel(TrainOptions().parse(argv + ["--num_devices", "2"]))
        assert jm.mesh.size == 2
        jm.setup()
        params0 = {n: {k: np.array(v) for k, v in p.items()} for n, p in jm.params.items()}
        forward, losses = jm._forward_fn(), jm._losses_fn()
        jb = jm.shard({k: batch[k] for k in INPUT_KEYS})
        assert len(jb["A_d"].sharding.device_set) == 2

        def loss_fn(g_train, params):
            return losses(forward(dict(params, **g_train), jb, jax.random.PRNGKey(0), True), jb)

        g_train = {n: jm.params[n] for n in ("Depth_f", "Task")}
        (_, m), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(g_train, jm.params)
    assert holes.calls == 2
    jax_run = dict(metrics={k: float(v) for k, v in m.items()},
                   grads={n: {k: np.asarray(v) for k, v in g.items()} for n, g in grads.items()})
    runs = {}
    for name, cov in (("inject", covers), ("drawn", None)):
        runs[name] = (parallel.launch(R.main_step, CPU2, args=(argv, params0, batch, cov),
                                      workdir=tmp),
                      R.main_step(ONE, argv, params0, batch, cov))
    return dict(jax=jax_run, runs=runs, loss_names=jm.loss_names)


@pytest.mark.parametrize("holes", ["inject", "drawn"])
def test_main_step_over_two_ranks_equals_one_process(main_runs, holes):
    """The two ranks split the batch and hold the same reduced metrics and
    gradients; their loss terms are the one-process step's within 1e-5
    relative and their gradients within 1e-3 relative L2 a tensor: with the
    covers injected, and with the holes each rank keeps of the global
    batch's draws."""
    ranks, one = main_runs["runs"][holes]
    assert all(r["split"] for r in ranks) and not one["split"]
    for key in ("metrics", "grads"):
        _ranks_agree(ranks, key)
    _assert_terms(ranks[0]["metrics"], one["metrics"], 1e-5, holes)
    _assert_grads(ranks[0]["grads"], one["grads"], 1e-3, holes)


def test_main_step_over_two_ranks_matches_jax_num_devices_2(main_runs):
    """Against the JAX package's step on its 2-device mesh, the same covers:
    every loss term within the port's existing 1e-4 relative (1e-6
    absolute near 0), every weight gradient within 3e-2 relative L2 and
    every bias within 1e-3 of its net's largest entry
    (tests/test_torch_train.py's bounds and reasons)."""
    ranks, _ = main_runs["runs"]["inject"]
    got, want = ranks[0], main_runs["jax"]
    for k in main_runs["loss_names"] + ["G", "mean_of_abs_diff_syn", "mean_of_abs_diff_real"]:
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    for n in ("Depth_f", "Task"):
        net_max = max(np.abs(v).max() for v in want["grads"][n].values())
        assert set(got["grads"][n]) == set(want["grads"][n])
        for k, v in want["grads"][n].items():
            g = got["grads"][n][k]
            if k.endswith("bias"):
                np.testing.assert_allclose(g, v, rtol=0, atol=1e-3 * net_max, err_msg=f"{n}.{k}")
            else:
                assert np.linalg.norm(g - v) / np.linalg.norm(v) <= 3e-2, f"{n}.{k}"
