"""The port's stage 1 (I2D) against the JAX package, fp32 on the CPU:
``gan_loss``, ``define_D``, the replay pool, and ``I2DModel``'s train step
(loss terms, gradients, Adam steps, the ``--use_D`` discriminator step and
the ``--i2d_train_features`` adversarial term) at small widths on 128x128
crops (torch's U-Net takes sides of 128 and up).

Both packages hold the same weights (the JAX init, carried through
``from_jax_params``). The JAX gradients come from ``jax.grad`` of the loss
written with the JAX package's own forward and loss functions, as
i2d_model.py:117-176 composes them; its value is held to the JAX model's
own ``G`` first.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import jax_params, jax_shapes, nhwc_to_nchw, randn

from desr_tpu.models import networks as JNW
from desr_tpu.models.layers import Ctx
from desr_tpu.ops import losses as JLS
from desr_tpu_torch.models import networks as TNW
from desr_tpu_torch.models.i2d_model import I2DModel
from desr_tpu_torch.ops import losses as TLS
from desr_tpu_torch.options import train_options
from desr_tpu_torch.utils.image_pool import ImagePool
from desr_tpu_torch.weights import from_jax_params

B, H, W = 2, 128, 128
SMALL = ["--Imagef_outf", "8", "--Imagef_basef", "8", "--Task_basef", "8", "--ndf", "8"]


# ----------------------------------------------------------------- parts

@pytest.mark.parametrize("mode", ["lsgan", "vanilla", "wgangp"])
def test_gan_loss_matches_jax(mode):
    """Real and fake targets, values and gradients within 1e-6."""
    x = randn((2, 1, 6, 7), 1, 3.0)
    for real in (True, False):
        want = JLS.gan_loss(jnp.asarray(x), real, mode)
        t = torch.from_numpy(x).requires_grad_(True)
        got = TLS.gan_loss(t, real, mode)
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6, atol=1e-7)
        (g,) = torch.autograd.grad(got, t)
        want_g = jax.grad(lambda p: JLS.gan_loss(p, real, mode))(jnp.asarray(x))
        np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-7)
    with pytest.raises(NotImplementedError):
        TLS.gan_loss(torch.zeros(1), True, "hinge")


@pytest.mark.parametrize("netD,n_layers,norm", [
    ("basic", 3, "instance"), ("n_layers", 2, "instance"), ("n_layers", 4, "none"),
    ("pixel", 3, "instance"),
])
def test_define_D_matches_jax(netD, n_layers, norm):
    """state_dict keys and shapes equal the JAX Net.init's (``model.`` or,
    for pixel, ``net.``); with the JAX weights the logits agree within 1e-5."""
    jnet = JNW.define_D(6, 8, netD, n_layers, norm)
    tnet = TNW.define_D(6, 8, netD, n_layers, norm)
    want_shapes = jax_shapes(jnet)
    assert {k: tuple(v.shape) for k, v in tnet.state_dict().items()} == want_shapes
    assert all(k.startswith("net." if netD == "pixel" else "model.") for k in want_shapes)
    params = jax_params(jnet, seed=3)
    tnet.load_state_dict(from_jax_params(params), strict=True)
    x = randn((2, 64, 64, 6), 4)
    want = np.asarray(jnet.apply(params, jnp.asarray(x), Ctx(dtype=jnp.float32)))
    with torch.no_grad():
        got = tnet(nhwc_to_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_define_D_refuses_batch_norm_and_unknown_names():
    """--norm batch builds the PatchGAN's BatchNorms (no longer refused);
    an unknown name is."""
    net = TNW.define_D(6, 8, "basic", norm="batch")
    assert sum(isinstance(m, TNW.BatchNorm2d) for m in net.modules()) == 3
    with pytest.raises(NotImplementedError, match="not recognized"):
        TNW.define_D(6, 8, "gu")


def test_image_pool_fills_then_replays_half():
    """The first pool_size images pass through and are stored; after that
    each image is swapped, with probability 1/2, for a stored one that it
    replaces (util/image_pool.py:5-54); the draws follow the given seed."""
    import random

    imgs = [torch.full((2, 1, 2, 2), float(i)) for i in range(200)]
    pool = ImagePool(4, random.Random(1))
    assert torch.equal(pool.query(imgs[0]), imgs[0]) and torch.equal(pool.query(imgs[1]), imgs[1])
    outs = [pool.query(x) for x in imgs[2:]]
    swapped = sum(int(o[j, 0, 0, 0] != x[j, 0, 0, 0]) for o, x in zip(outs, imgs[2:])
                  for j in range(2))
    assert 0.4 < swapped / (2 * len(outs)) < 0.6
    assert all(set(o.flatten().tolist()) <= set(range(200)) for o in outs)
    again = ImagePool(4, random.Random(1))
    for x in imgs[:2]:
        again.query(x)
    assert all(torch.equal(again.query(x), o) for x, o in zip(imgs[2:], outs))
    assert ImagePool(0).query(imgs[5]) is imgs[5]


# ----------------------------------------------------------------- the step

def _batch(seed=0):
    rng = np.random.default_rng(seed)
    depth_a = rng.uniform(-1, 1, (B, H, W, 1)).astype(np.float32)
    depth_b = rng.uniform(-1, 1, (B, H, W, 1)).astype(np.float32)
    depth_b[depth_b < -0.8] = -1.0
    return {"A_i": rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32),
            "B_i": rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32),
            "A_d": depth_a, "B_d": depth_b, "A_paths": ["a.png"] * B, "B_paths": ["b.png"] * B}


def _argv(tmp, extra):
    return ["--model_type", "I2D", "--name", "t", "--checkpoints_dir", str(tmp),
            "--batch_size", str(B), "--compute_dtype", "float32", "--norm_loss",
            *SMALL, *extra]


def _jax_grads(jm, params, batch, adv):
    """jax.grad of i2d_model.py's G loss (plus, with ``adv``, the
    unweighted GAN(D(features_real), True) through a frozen D) w.r.t.
    Image_f and Task; and the loss's value."""
    opt, forward = jm.opt, jm._forward_fn()
    jb = {k: jnp.asarray(v) for k, v in batch.items() if not k.endswith("paths")}

    def loss_fn(g, rest):
        full = dict(rest, **g)
        feats_syn, feats_real, pred_syn, pred_real = forward(full, jb, jax.random.PRNGKey(0), True)
        syn_d, real_d = jb["A_d"][..., 0], jb["B_d"][..., 0]
        ms, mr = jnp.where(syn_d < -0.97, 0.0, 1.0), jnp.where(real_d < -0.97, 0.0, 1.0)
        loss = (JLS.l1_loss(syn_d * ms, pred_syn[..., 0] * ms) * opt.w_syn_l1
                + JLS.l1_loss(real_d * mr, pred_real[..., 0] * mr) * opt.w_real_l1) * opt.scale_G
        if adv:
            pr = jm.nets["D_depth"].apply(full["D_depth"], feats_real, Ctx(train=True))
            loss = loss + JLS.gan_loss(pr, True, opt.gan_mode)
        return loss

    g = {n: params[n] for n in ("Image_f", "Task")}
    rest = {n: p for n, p in params.items() if n not in g}
    value, grads = jax.jit(jax.value_and_grad(loss_fn))(g, rest)
    return float(value), {n: {k: np.asarray(v) for k, v in d.items()} for n, d in grads.items()}


def _pair(tmp, extra=()):
    """The JAX I2DModel and the port's on the same weights."""
    from desr_tpu.models.i2d_model import I2DModel as JaxI2DModel
    from desr_tpu.options.train_options import TrainOptions

    jm = JaxI2DModel(TrainOptions().parse(_argv(tmp, extra)))
    jm.setup()
    params0 = {n: {k: np.array(v) for k, v in p.items()} for n, p in jm.params.items()}
    tm = I2DModel(train_options.parse(_argv(tmp, extra) + ["--device", "cpu"],
                                      print_options=False),
                  device="cpu", compute_dtype=torch.float32, is_train=True)
    assert tuple(tm.model_names) == tuple(jm.model_names)
    for n, p in params0.items():
        tm.nets[n].load_state_dict(from_jax_params(p), strict=True)
    return jm, tm, params0


def _assert_grads(got, want, what):
    """Each weight within 3e-2 relative L2 (the bound of
    tests/test_torch_train.py: f32 order noise through an ill-conditioned
    step), each bias within 1e-3 of the net's largest entry (a conv bias
    that feeds an InstanceNorm has an exact gradient of 0)."""
    assert set(got) == set(want)
    net_max = max(np.abs(v).max() for v in want.values())
    for k, g in got.items():
        v, g = want[k], g.numpy()
        if k.endswith("bias"):
            np.testing.assert_allclose(g, v, rtol=0, atol=1e-3 * net_max, err_msg=f"{what}.{k}")
        else:
            rel = np.linalg.norm(g - v) / np.linalg.norm(v)
            assert rel <= 3e-2, (f"{what}.{k}", rel)


N_STEPS = 3


@pytest.fixture(scope="module")
def default_runs(tmp_path_factory):
    """The as-shipped configuration (--norm_loss, no D): JAX's jitted
    train_step and eval_step, and the port's, N_STEPS on one batch."""
    jm, tm, params0 = _pair(tmp_path_factory.mktemp("ck"))
    batch = _batch()
    value, jgrads = _jax_grads(jm, jm.params, batch, adv=False)
    jm.set_input(batch)
    jm.calculate("train")
    jfirst = {k: float(v) for k, v in jm.metrics.items()}
    jg = []
    for i in range(N_STEPS):
        jm.optimize_parameters((i + 1) * B)
        jg.append(float(jm.metrics["G"]))
    tm.set_input(batch)
    tfirst = {k: float(v) for k, v in tm.compute_grads().items()}
    tgrads = {n: {k: p.grad.clone() for k, p in tm.nets[n].named_parameters()
                  if p.grad is not None} for n in tm.nets}
    tm.optimizer.step()
    tg = [tfirst["G"]]
    for i in range(1, N_STEPS):
        tm.optimize_parameters((i + 1) * B)
        tg.append(float(tm.metrics["G"]))
    return dict(jm=jm, tm=tm, params0=params0, value=value, jgrads=jgrads, tgrads=tgrads,
                jfirst=jfirst, tfirst=tfirst, jg=jg, tg=tg)


def test_i2d_loss_terms_match_jax(default_runs):
    """task_syn, task_real, syn_norms (a metric only) and G: within 1e-4
    relative of the JAX model's; the test's JAX loss equals the model's G."""
    r = default_runs
    assert set(r["tm"].loss_names) == set(r["jm"].loss_names) == {"task_syn", "task_real",
                                                                  "syn_norms"}
    np.testing.assert_allclose(r["value"], r["jfirst"]["G"], rtol=1e-6)
    for k in ("task_syn", "task_real", "syn_norms", "G"):
        assert np.isfinite(r["tfirst"][k]), k
        np.testing.assert_allclose(r["tfirst"][k], r["jfirst"][k], rtol=1e-4, err_msg=k)
    assert r["tfirst"]["G"] == pytest.approx(
        r["tfirst"]["task_syn"] + 0.1 * r["tfirst"]["task_real"], rel=1e-6)


def test_i2d_task_grads_match_jax_and_image_f_gets_none(default_runs):
    """Only Task has gradients (the Task-only optimizer); they match JAX's."""
    r = default_runs
    assert set(r["tgrads"]["Image_f"]) == set()
    _assert_grads(r["tgrads"]["Task"], r["jgrads"]["Task"], "Task")


def test_i2d_adam_steps_match_jax(default_runs):
    """loss_G over N_STEPS Adam (0.9, 0.999) steps within 1e-4 relative of
    the JAX model's, falling; Image_f bit-equal to its init in both, Task
    moved in the direction JAX moved it."""
    r = default_runs
    np.testing.assert_allclose(r["tg"], r["jg"], rtol=1e-4)
    assert r["tg"][-1] < r["tg"][0]
    assert r["tm"].optimizer.defaults["betas"] == (0.9, 0.999)
    for k, v in r["tm"].nets["Image_f"].state_dict().items():
        np.testing.assert_array_equal(v.numpy(), r["params0"]["Image_f"][k])
        np.testing.assert_array_equal(np.asarray(r["jm"].params["Image_f"][k]),
                                      r["params0"]["Image_f"][k])
    for k, v in r["tm"].nets["Task"].state_dict().items():
        dt = v.numpy() - r["params0"]["Task"][k]
        dj = np.asarray(r["jm"].params["Task"][k]) - r["params0"]["Task"][k]
        if not k.endswith("bias"):
            assert np.mean(np.sign(dt) == np.sign(dj)) >= 0.95, k


@pytest.fixture(scope="module")
def adv_runs(tmp_path_factory):
    """--use_D --i2d_train_features: the G step's gradients (with the
    adversarial term), then one whole step of each model: G, the D step on
    the pool (still filling, so its input is features_real itself) and the
    G_pred metrics."""
    jm, tm, params0 = _pair(tmp_path_factory.mktemp("ck"), ["--use_D", "--i2d_train_features"])
    batch = _batch(1)
    _, jgrads = _jax_grads(jm, jm.params, batch, adv=True)
    tm.set_input(batch)
    tm.compute_grads()
    tgrads = {n: {k: p.grad.clone() for k, p in tm.nets[n].named_parameters()
                  if p.grad is not None} for n in tm.nets}
    jm.set_input(batch)
    jm.optimize_parameters(B)
    tm.optimize_parameters(B, 1)
    return dict(jm=jm, tm=tm, params0=params0, jgrads=jgrads, tgrads=tgrads)


def test_i2d_adversarial_term_reaches_image_f(adv_runs):
    """Image_f's and Task's gradients with the adversarial term match JAX's;
    D_depth gets none from the G step (it is frozen there)."""
    r = adv_runs
    assert r["tgrads"]["D_depth"] == {}
    for n in ("Image_f", "Task"):
        _assert_grads(r["tgrads"][n], r["jgrads"][n], n)


def test_i2d_d_step_matches_jax(adv_runs):
    """The whole --use_D step. The loss terms and D_depth (taken before any
    update) within 1e-4 relative of the JAX model's. G_pred and G_pred_r read
    D and Image_f after their Adam steps: the port's equal JAX's
    ``g_pred_metrics`` on the port's updated weights within 1e-5, and the
    JAX model's own within 2e-3 (Adam's first step is lr * sign(g), so the
    coordinates whose gradient is at f32 noise move apart). Each of the three
    nets moved in the direction JAX moved it (>= 95% of each weight's
    coordinates agree). D_depth's Adam takes betas (--beta1, 0.999)."""
    r = adv_runs
    jm, tm = r["jm"], r["tm"]
    assert set(tm.loss_names) == set(jm.loss_names)
    assert tm.optimizer_D.defaults["betas"] == (0.5, 0.999)
    for k in ("task_syn", "task_real", "syn_norms", "G", "D_depth"):
        np.testing.assert_allclose(float(tm.metrics[k]), float(jm.metrics[k]), rtol=1e-4,
                                   err_msg=k)
    with torch.no_grad():
        feats_syn, feats_real = tm.forward_all(tm._batch)[:2]
    d_params = {k: jnp.asarray(v.numpy()) for k, v in tm.nets["D_depth"].state_dict().items()}
    want = jm._g_pred_metrics(d_params, *(jnp.asarray(np.moveaxis(f.numpy(), 1, -1))
                                          for f in (feats_real, feats_syn)))
    for k, v in zip(("G_pred", "G_pred_r"), want):
        np.testing.assert_allclose(float(tm.metrics[k]), float(v), rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(float(tm.metrics[k]), float(jm.metrics[k]), rtol=2e-3,
                                   err_msg=k)
    for n in ("Image_f", "Task", "D_depth"):
        for k, v in tm.nets[n].state_dict().items():
            dt = v.numpy() - r["params0"][n][k]
            dj = np.asarray(jm.params[n][k]) - r["params0"][n][k]
            assert np.abs(dt).max() > 0, f"{n}.{k} did not move"
            if not k.endswith("bias"):
                assert np.mean(np.sign(dt) == np.sign(dj)) >= 0.95, f"{n}.{k}"


def test_i2d_d_step_grads_match_jax(tmp_path):
    """D_depth's gradients of 0.5 (GAN(D(feats_syn), True) + GAN(D(fake),
    False)) against jax.grad of the same loss, on the same features."""
    from desr_tpu.models.i2d_model import I2DModel as JaxI2DModel
    from desr_tpu.options.train_options import TrainOptions

    argv = _argv(tmp_path, ["--use_D"])
    jm = JaxI2DModel(TrainOptions().parse(argv))
    jm.setup()
    dparams = {k: np.array(v) for k, v in jm.params["D_depth"].items()}
    tm = I2DModel(train_options.parse(argv + ["--device", "cpu"], print_options=False),
                  device="cpu", compute_dtype=torch.float32, is_train=True)
    tm.nets["D_depth"].load_state_dict(from_jax_params(dparams), strict=True)
    syn, fake = randn((B, 64, 64, 8), 5), randn((B, 64, 64, 8), 6)
    d = jm.nets["D_depth"]

    def loss_fn(p):
        ctx = Ctx(train=True)
        return 0.5 * (JLS.gan_loss(d.apply(p, jnp.asarray(syn), ctx), True, "lsgan")
                      + JLS.gan_loss(d.apply(p, jnp.asarray(fake), ctx), False, "lsgan"))

    value, want = jax.value_and_grad(loss_fn)({k: jnp.asarray(v) for k, v in dparams.items()})
    loss = tm.d_step(nhwc_to_nchw(syn), nhwc_to_nchw(fake))
    np.testing.assert_allclose(float(loss), float(value), rtol=1e-5)
    got = {k: p.grad for k, p in tm.nets["D_depth"].named_parameters()}
    _assert_grads(got, {k: np.asarray(v) for k, v in want.items()}, "D_depth")
    assert not any(p.requires_grad for p in tm.nets["D_depth"].parameters())


def test_i2d_use_d_leaves_task_only_step_alone(tmp_path):
    """With the default optimizer the adversarial term is not taken: a step
    with --use_D gives Task the bits of a step without it, and Image_f
    stays at its init."""
    batch = _batch(2)
    task = []
    for extra in ([], ["--use_D"]):
        tm = I2DModel(train_options.parse(_argv(tmp_path, extra) + ["--device", "cpu"],
                                          print_options=False),
                      device="cpu", compute_dtype=torch.float32, is_train=True,
                      generator=torch.Generator().manual_seed(4))
        init = {k: v.clone() for k, v in tm.nets["Image_f"].state_dict().items()}
        tm.set_input(batch)
        tm.optimize_parameters(B, 1)
        assert all(torch.equal(v, init[k]) for k, v in tm.nets["Image_f"].state_dict().items())
        task.append(tm.nets["Task"].state_dict())
        assert ("D_depth" in tm.metrics) == bool(extra)
    assert all(torch.equal(v, task[1][k]) for k, v in task[0].items())


def test_i2d_direction_and_throttled_d_cadence(tmp_path):
    """--direction BtoA on a batch equals AtoB on the swapped batch; the D
    step runs when iters % (fr * batch_size) == 0 or iters < 800 only."""
    batch = _batch(3)
    swapped = dict(batch, A_i=batch["B_i"], B_i=batch["A_i"], A_d=batch["B_d"], B_d=batch["A_d"])
    out = []
    for extra, b in ((["--direction", "BtoA"], batch), ([], swapped)):
        tm = I2DModel(train_options.parse(_argv(tmp_path, extra) + ["--device", "cpu"],
                                          print_options=False),
                      device="cpu", compute_dtype=torch.float32, is_train=True)
        tm.set_input(b)
        tm.calculate("train")
        out.append({k: float(v) for k, v in tm.metrics.items()})
    assert out[0] == out[1]
    tm = I2DModel(train_options.parse(_argv(tmp_path, ["--use_D"]) + ["--device", "cpu"],
                                      print_options=False),
                  device="cpu", compute_dtype=torch.float32, is_train=True)
    tm.set_input(batch)
    for iters, runs in ((802, False), (2 * 700 * B, True), (798, True)):
        tm.optimize_parameters(iters, 700)
        assert ("D_depth" in tm.metrics) == runs, iters
        assert {"G_pred", "G_pred_r"} <= set(tm.metrics)
