"""The port's x2 SR stage (MainSRModel) against the JAX package, float32 on
the CPU at small widths: the serving forward, the train step (loss terms,
trainable grads, three Adam steps) and the --use_rec_as_real_input step.

The translator's widths are hardcoded; both packages' ``default_translator_opt``
is cut here to 8+8 base channels and one block (tests/test_torch_translator.py
holds it at full width). The crop is 128 (HR 256x256): the LR U-Nets take multiples of 128.
Train-time holes come from different generators in the two packages, so the
step tests inject the same masks into both, as tests/test_torch_train.py does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import jax_params  # noqa: F401  (caps torch's threads)

import desr_tpu.ops.depth as JDPT
import desr_tpu_torch.ops.depth as TDPT
from desr_tpu.models import translation_networks as JTT
from desr_tpu_torch.models import translation_networks as TTT
from desr_tpu_torch.models.main_sr_model import MainSRModel
from desr_tpu_torch.options import train_options
from desr_tpu_torch.weights import from_jax_params

CROP, HR = 128, 256
SMALL = ["--ImageDepthf_outf", "8", "--ImageDepthf_basef", "8", "--Depthf_outf", "8",
         "--Depthf_basef", "8", "--I2D_base", "8", "--Task_basef", "8"]
SR = ["--model_type", "main", "--SR", "--use_image_for_trans", "--use_masked", "--norm_loss",
      "--use_smooth_loss", "--w_syn_norm", "0.1", "--compute_dtype", "float32",
      "--crop_size_h", str(CROP), "--crop_size_w", str(CROP), "--batch_size", "1", *SMALL]
N_STEPS = 3


def _batch(b=1, seed=0):
    """tests/test_model_sr.py:22-37's HR batch, with holes in both depths."""
    rng = np.random.default_rng(seed)
    depth_a = rng.uniform(-0.5, 1, (b, HR, HR, 1)).astype(np.float32)
    depth_b = rng.uniform(-0.5, 1, (b, HR, HR, 1)).astype(np.float32)
    depth_a[depth_a < -0.4] = -1.0
    depth_b[depth_b < -0.3] = -1.0
    K = np.tile(np.array([[[577.0, 0, 320], [0, 577, 240], [0, 0, 1]]], np.float32), (b, 1, 1))
    return {"A_i": rng.uniform(-1, 1, (b, HR, HR, 3)).astype(np.float32),
            "B_i": rng.uniform(-1, 1, (b, HR, HR, 3)).astype(np.float32),
            "A_d": depth_a, "B_d": depth_b, "K_A": K * np.array([[2, 1, 2], [1, 2, 2], [1, 1, 1]],
                                                                np.float32),
            "K_B": K.copy(), "crop_A": np.tile(np.array([[0, HR, 0, HR]], np.float32), (b, 1)),
            "crop_B": np.tile(np.array([[0, CROP, 0, CROP]], np.float32), (b, 1))}


class _InjectHoles:
    """random_rect_holes stand-ins: call k of a forward (real, then syn)
    punches fixed rectangle cover k % 2 where the base mask is valid."""

    def __init__(self, b=1):
        self.covers = []
        for seed in (1, 2):
            rng = np.random.default_rng(seed)
            cover = np.zeros((b, HR, HR), bool)
            for i in range(b):
                for _ in range(6):
                    y, x = rng.integers(0, HR, 2)
                    sy, sx = rng.integers(4, 40, 2)
                    cover[i, y:y + sy, x:x + sx] = True
            self.covers.append(cover)
        self.calls = {"jax": 0, "torch": 0}

    def _next(self, pkg):
        c = self.covers[self.calls[pkg] % 2]
        self.calls[pkg] += 1
        return c

    def jax(self, rng, base, **kw):
        return jnp.where((base > 0.05) & self._next("jax"), 0.0, 1.0).astype(base.dtype)

    def torch(self, base, **kw):
        return torch.where((base > 0.05) & torch.from_numpy(self._next("torch")), 0.0,
                           1.0).to(base.dtype)


@pytest.fixture(scope="module")
def small_translator():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (JTT, TTT):
            full = mod.default_translator_opt
            mp.setattr(mod, "default_translator_opt",
                       lambda full=full: full(ngf_img=8, ngf_depth=8, n_blocks=1))
        yield


def _models(argv):
    """The port's MainSRModel (seeded init) and the JAX one with the same
    params, carried across as numpy (the JAX inits' compiles take longer
    than the whole test)."""
    from desr_tpu.models.main_sr_model import MainSRModel as JaxSR
    from desr_tpu.options.train_options import TrainOptions

    tm = MainSRModel(train_options.parse(argv + ["--device", "cpu"], print_options=False),
                     device="cpu", compute_dtype=torch.float32, is_train=True,
                     generator=torch.Generator().manual_seed(3))
    jm = JaxSR(TrainOptions().parse(argv))
    # copies: a JAX CPU array may alias a numpy buffer, and the port's Adam
    # updates its parameters in place while a JAX call may still be reading
    jm.params = {n: {k: jnp.asarray(v.numpy().copy()) for k, v in net.state_dict().items()}
                 for n, net in tm.nets.items()}
    assert set(jm.params) == set(jm.nets)
    for n, p in jm.params.items():  # and back through the weight carrier
        tm.nets[n].load_state_dict(from_jax_params({k: np.asarray(v) for k, v in p.items()}),
                                   strict=True)
    return jm, tm


@pytest.fixture(scope="module")
def runs(small_translator, tmp_path_factory):
    """The same params, batch and holes through both packages: N_STEPS of
    JAX's SR step (forward, loss zoo, value_and_grad, adam_update; jitted
    here) and of the port's; and the eval forward of both."""
    from desr_tpu.ops.optim import adam_init, adam_update

    argv = SR + ["--name", "sr", "--checkpoints_dir", str(tmp_path_factory.mktemp("ck"))]
    jm, tm = _models(argv)
    params0 = {n: {k: np.array(v) for k, v in p.items()} for n, p in jm.params.items()}
    forward, losses = jm._forward_fn(), jm._losses_fn()

    # serving: the eval forward (no holes drawn) on a batch of 2
    serve = _batch(2, seed=4)
    want_serve = jax.jit(lambda p, b: forward(p, b, jax.random.PRNGKey(0), False)[
        "pred_real_depth_hr"])(jm.params, {k: jnp.asarray(v) for k, v in serve.items()})
    got_serve = tm.serve_forward(serve)

    inject, batch = _InjectHoles(), _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JDPT, "random_rect_holes", inject.jax)
        mp.setattr(TDPT, "random_rect_holes", inject.torch)

        def loss_fn(g_train, params):
            return losses(forward(dict(params, **g_train), jb, jax.random.PRNGKey(0), True), jb)

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
                jmetrics=jmetrics, tmetrics=tmetrics, got_serve=got_serve,
                want_serve=np.asarray(want_serve))


def test_sr_serve_forward_matches_jax(runs):
    """pred_real_depth_hr of the eval forward, batch 2 on the 256x256 HR
    grid (LR guidance at 128x128): within 1e-3 (tanh outputs)."""
    got, want = runs["got_serve"], runs["want_serve"]
    assert got.shape == want.shape == (2, HR, HR)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


def test_sr_train_step_loss_terms_match_jax(runs):
    """Every loss term of the first SR step: within 1e-4 relative (or 1e-6
    absolute for terms near 0)."""
    j, t = runs["jmetrics"][0], runs["tmetrics"][0]
    assert set(runs["tm"].loss_names) == set(runs["jm"].loss_names)
    for k in runs["jm"].loss_names + ["G", "mean_of_abs_diff_syn", "mean_of_abs_diff_real"]:
        assert np.isfinite(t[k]), k
        np.testing.assert_allclose(t[k], j[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_sr_train_step_grads_match_jax(runs):
    """Depth_f and Task grads of the first SR step: each weight within 3e-2
    relative L2 of JAX's, each bias within 1e-3 of the net's largest entry
    (the bound and its reason: tests/test_torch_train.py::test_train_step_grads_match_jax)."""
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


def test_sr_train_trajectory_matches_jax(runs):
    """loss_G over three Adam steps: within 1e-4 relative of JAX's, and falling;
    the frozen nets bit-equal, the trained ones moved."""
    jg = [m["G"] for m in runs["jmetrics"]]
    tg = [m["G"] for m in runs["tmetrics"]]
    np.testing.assert_allclose(tg, jg, rtol=1e-4)
    assert tg[-1] < tg[0]
    tm, params0 = runs["tm"], runs["params0"]
    for n in tm.model_names:
        now = tm.nets[n].state_dict()
        moved = any(not np.array_equal(now[k].numpy(), params0[n][k]) for k in now)
        assert moved == (n in ("Depth_f", "Task")), n


def test_sr_rec_input_step_matches_jax(small_translator, tmp_path):
    """--use_rec_as_real_input: the real branch through a frozen zoo-A G_B_d
    (resnet_9blocks at --ngf 8) and G_A_d. The loss terms of a step equal
    JAX's within 1e-4 relative; after the step G_B_d is bit-equal; it is in
    neither model_names nor the saved .pth set."""
    argv = SR + ["--use_rec_as_real_input", "--ngf", "8", "--name", "rec",
                 "--checkpoints_dir", str(tmp_path)]
    jm, tm = _models(argv)
    assert "G_B_d" in tm.nets and "G_B_d" not in tm.model_names
    inject, batch = _InjectHoles(), _batch(seed=5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    forward, losses = jm._forward_fn(), jm._losses_fn()
    gbd = {k: v.clone() for k, v in tm.nets["G_B_d"].state_dict().items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JDPT, "random_rect_holes", inject.jax)
        mp.setattr(TDPT, "random_rect_holes", inject.torch)
        _, j = jax.jit(lambda p: losses(forward(p, jb, jax.random.PRNGKey(0), True), jb))(
            jm.params)
        tm.set_input(batch)
        tm.optimize_parameters(1)
    for k in jm.loss_names + ["G"]:
        np.testing.assert_allclose(float(tm.metrics[k]), float(j[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    for k, v in tm.nets["G_B_d"].state_dict().items():
        assert torch.equal(v, gbd[k]), k
    tm.save_networks("latest")
    saved = sorted(p.name for p in (tmp_path / "rec").iterdir() if p.suffix == ".pth")
    assert saved == sorted(f"latest_net_{n}.pth" for n in tm.model_names)


def test_sr_model_refuses_use_d():
    opt = train_options.parse(SR + ["--use_D", "--device", "cpu"], print_options=False)
    with pytest.raises(NotImplementedError, match="loss_G_pred"):
        MainSRModel(opt, device="cpu", is_train=True)
