"""The port's stage 2 (translation training) against the JAX package, fp32 on
the CPU: the FOV normals and the stage's losses, the translation lineage's
discriminators (basic, n_layers, Gu, pixel, with and without spectral norm),
BatchNorm's running statistics, the depth-only and upsampling variants of the
translator, and ``TranslationModel``'s G step, D step and one whole
iteration, at the config of tests/test_model_translation.py: translators of
8+8 channels and 2 blocks, ndf 16, 64x64 crops, batch 2, --num_iter_gen 2.

Both packages hold the same weights (the JAX init, carried through
``from_jax_params``). The JAX gradients come from ``jax.value_and_grad`` of
the JAX model's own forward and loss functions, composed as its G and D
steps compose them (translation_model.py:354-421).
"""

from types import SimpleNamespace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import jax_shapes, nchw_to_nhwc, nhwc_to_nchw, randn

from desr_tpu.models import layers as JL
from desr_tpu.models import translation_networks as JT
from desr_tpu.models.layers import Ctx
from desr_tpu.ops import losses as JLS
from desr_tpu.ops import normals as JNM
from desr_tpu_torch.models import layers as TL
from desr_tpu_torch.models import translation_networks as TT
from desr_tpu_torch.models.translation_model import INPUT_KEYS, TranslationModel
from desr_tpu_torch.ops import losses as TLS
from desr_tpu_torch.ops import normals as TNM
from desr_tpu_torch.options import train_options
from desr_tpu_torch.weights import from_jax_params

B, H, W = 2, 64, 64
F32 = Ctx(dtype=jnp.float32)


_DEFAULT_OPT = TT.default_translator_opt


def _small(**kw):
    return _DEFAULT_OPT(ngf_img=8, ngf_depth=8, n_blocks=2, **kw)


# ----------------------------------------------------------------- ops

def _depth(seed, shape=(B, 48, 80)):
    d = np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)
    d[d < -0.7] = -1.0  # holes
    return d


def test_fov_normals_match_jax():
    """surface_normals_fov_planar (normals.py:92-117) within 1e-6, and the
    gradient of a weighted sum of it within 1e-5 relative off the first two
    rows and columns. The quirk's first gy row and first gx column are
    exactly zero, so their normals are -crs / eps with eps = 1e-8: the
    gradient at row 1 and column 1 is a sum of terms of order 1e8 that
    cancel, and in float32 both packages keep a few 1e-2 of noise there
    (against a float64 run of the same function)."""
    d, r = _depth(1), randn((B, 3, 48, 80), 2)
    want = JNM.surface_normals_fov_planar(jnp.asarray(d))
    t = torch.from_numpy(d).requires_grad_(True)
    got = TNM.surface_normals_fov_planar(t)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)
    (g,) = torch.autograd.grad((got * torch.from_numpy(r)).sum(), t)
    want_g = jax.grad(lambda x: jnp.sum(JNM.surface_normals_fov_planar(x) * r))(jnp.asarray(d))
    want_g = np.asarray(want_g)[:, 2:, 2:]
    np.testing.assert_allclose(g.numpy()[:, 2:, 2:], want_g, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want_g).max()))


def _loss_pair(name):
    n1, n2 = randn((B, 3, 20, 24), 3), randn((B, 3, 20, 24), 4)
    d1, d2 = _depth(5, (B, 20, 24)), _depth(6, (B, 20, 24))
    m = d1 > -0.98
    return {
        "masked_l1_loss": (d1, d2, m),
        "tv_norm_planar": (n1,),
        "cos_sim_loss_planar": (n1, n2),
        "masked_cos_sim_loss_planar": (n1, n2, np.repeat(m[:, None], 3, 1)),
    }[name]


_STAGE2_LOSSES = ["masked_l1_loss", "tv_norm_planar", "cos_sim_loss_planar",
                  "masked_cos_sim_loss_planar"]


@pytest.mark.parametrize("name", _STAGE2_LOSSES)
def test_stage2_losses_match_jax(name):
    """Values within 1e-6 relative (the masked cos-sim with its as-shipped
    +1e6 denominator)."""
    args = _loss_pair(name)
    want = float(getattr(JLS, name)(*map(jnp.asarray, args)))
    got = float(getattr(TLS, name)(*map(torch.from_numpy, args)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    assert want != 0


@pytest.mark.parametrize("name", _STAGE2_LOSSES)
def test_stage2_loss_grads_match_jax(name):
    """The gradient with respect to the first map within 1e-5 of its largest
    entry of jax.grad's."""
    args = _loss_pair(name)
    want = np.asarray(jax.grad(lambda x: getattr(JLS, name)(x, *map(jnp.asarray, args[1:])))(
        jnp.asarray(args[0])))
    x = torch.from_numpy(args[0]).requires_grad_(True)
    (got,) = torch.autograd.grad(getattr(TLS, name)(x, *map(torch.from_numpy, args[1:])), x)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale)


# ----------------------------------------------------------------- layers and nets

def _d_opt(netD, norm_d, spnorm):
    return SimpleNamespace(netD=netD, norm_d=norm_d, use_spnorm=spnorm, ndf=16, n_layers_D=2,
                           init_type="normal")


def _jax_apply(jnet, params, *xs, train=True):
    ctx = Ctx(train=train, dtype=jnp.float32)
    return np.asarray(jax.jit(lambda p, *a: jnet.apply(p, *a, ctx))(params, *xs))


def _port_params(tnet):
    return {k: v.numpy() for k, v in tnet.state_dict().items()}


@pytest.mark.parametrize("netD,norm_d,spnorm,input_type", [
    ("basic", "none", False, "depth"), ("basic", "none", True, "normal"),
    ("n_layers", "instance", False, "normal"), ("n_layers", "none", True, "depth"),
    ("Gu", "none", False, "depth"), ("Gu", "none", True, "normal"),
    ("pixel", "none", False, "normal"), ("basic", "batch", False, "depth"),
])
def test_define_D_matches_jax(netD, norm_d, spnorm, input_type):
    """The translation lineage's define_D: state_dict keys and shapes equal
    the JAX Net.init's (``model.``, ``net.`` for pixel; ``weight_orig`` /
    ``weight_u`` / ``weight_v`` under --use_spnorm; BatchNorm's running
    statistics); on the port's initial weights the JAX net's train-mode
    logits within 1e-5 (the JAX init carries over in the model tests)."""
    opt = _d_opt(netD, norm_d, spnorm)
    jnet = JT.define_D(opt, input_type)
    tnet = TT.define_D(opt, input_type, generator=torch.Generator().manual_seed(3))
    want_shapes = jax_shapes(jnet)
    assert {k: tuple(v.shape) for k, v in tnet.state_dict().items()} == want_shapes
    assert all(k.startswith("net." if netD == "pixel" else "model.") for k in want_shapes)
    assert any(k.endswith("weight_u") for k in want_shapes) == (spnorm and netD != "pixel")
    if norm_d == "none" and netD in ("basic", "n_layers"):  # middle convs: no bias, no norm
        assert "model.2.bias" not in want_shapes and "model.3.weight" not in want_shapes
    x = randn((B, 32, 32, 1 if input_type == "depth" else 3), 4)
    want = _jax_apply(jnet, _port_params(tnet), x)
    with torch.no_grad():
        got = nchw_to_nhwc(tnet.train()(nhwc_to_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_batch_norm_running_stats_match_jax():
    """BatchNorm2d: two train applies move running_mean / running_var (from
    the unbiased batch variance, momentum 0.1) as the JAX layer's stats sink
    does, within 1e-6; num_batches_tracked is 2 (int64); the outputs, and an
    eval apply on the running statistics, within 1e-5."""
    jbn, tbn = JL.BatchNorm2d(16), TL.BatchNorm2d(16)
    params = {k: np.asarray(v) for k, v in
              jbn.init(jax.random.PRNGKey(1), "", JL.InitCfg()).items()}
    tbn.load_state_dict(from_jax_params(params), strict=True)
    assert tbn.num_batches_tracked.dtype == torch.int64
    stats = {}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    for seed in (5, 6):
        x = randn((3, 7, 9, 16), seed, 2.0) + 0.5
        want = jbn.apply(jp, jnp.asarray(x), "", Ctx(train=True, stats=stats, dtype=jnp.float32))
        got = nchw_to_nhwc(tbn.train()(nhwc_to_nchw(x)))
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(tbn, k).numpy(), np.asarray(stats[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    assert int(tbn.num_batches_tracked) == int(stats["num_batches_tracked"]) == 2
    jp.update(stats)
    x = randn((2, 5, 5, 16), 7)
    want = jbn.apply(jp, jnp.asarray(x), "", Ctx(train=False, dtype=jnp.float32))
    with torch.no_grad():
        got = nchw_to_nhwc(tbn.eval()(nhwc_to_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("input_type,upsampling", [
    ("depth", "transpose"), ("img_depth", "upconv"), ("img_depth", "uptranspose"),
    ("depth", "uptranspose"),
])
def test_define_gen_variants_match_jax(input_type, upsampling):
    """define_Gen for --inp_B depth (one depth encoder of 2 x ngf_depth
    channels) and the upconv / uptranspose decoders (keys under
    ``resizeconv.1.`` and ``transposeconv.``): keys and shapes equal the
    JAX init's, and on the port's initial weights the 64x64 forward within
    1e-5 of the JAX net's."""
    jnet = JT.define_Gen(JT.default_translator_opt(ngf_img=8, ngf_depth=8, n_blocks=2,
                                                   upsampling_type=upsampling), input_type)
    tnet = TT.define_Gen(_small(upsampling_type=upsampling), input_type)
    shapes = jax_shapes(jnet)
    assert {k: tuple(v.shape) for k, v in tnet.state_dict().items()} == shapes
    assert any(k.startswith("enc_img.") for k in shapes) == (input_type == "img_depth")
    depth = np.random.default_rng(9).uniform(-1, 1, (B, H, W, 1)).astype(np.float32)
    img = randn((B, H, W, 3), 10) if input_type == "img_depth" else None
    want = _jax_apply(jnet, _port_params(tnet), depth, img)
    with torch.no_grad():
        got = nchw_to_nhwc(tnet(nhwc_to_nchw(depth), None if img is None else nhwc_to_nchw(img)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_spectral_norm_conv_matches_jax_and_keeps_its_stored_u():
    """The JAX layer's init (``weight_orig``, ``bias``, ``weight_u``,
    ``weight_v``) loads through from_jax_params and the forward matches the
    JAX layer's within 1e-5; each forward runs 3 power iterations from the
    stored u and writes nothing back, and the weight's gradient flows
    through sigma (u, v fixed), whose value is the weight's largest singular
    value."""
    jconv = JL.SpectralNormConv2d(4, 6, 3, padding=1)
    params = {k: np.asarray(v) for k, v in
              jconv.init(jax.random.PRNGKey(0), "", JL.InitCfg()).items()}
    conv = TL.SpectralNormConv2d(4, 6, 3, padding=1)
    conv.load_state_dict(from_jax_params(params), strict=True)
    u0 = conv.weight_u.clone()
    x = randn((B, 8, 8, 4), 2)
    want = jconv.apply({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), "", F32)
    y = conv(nhwc_to_nchw(x))
    np.testing.assert_allclose(nchw_to_nhwc(y), np.asarray(want), rtol=0, atol=1e-5)
    assert torch.equal(conv.weight_u, u0)
    sigma = torch.linalg.matrix_norm(conv.weight_orig.detach().reshape(6, -1), ord=2)
    plain = torch.nn.functional.conv2d(nhwc_to_nchw(x), conv.weight_orig.detach() / sigma,
                                       conv.bias.detach(), padding=1)
    torch.testing.assert_close(y.detach(), plain, rtol=1e-4, atol=1e-5)
    y.square().sum().backward()
    assert conv.weight_orig.grad is not None and conv.weight_u.grad is None


# ----------------------------------------------------------------- the model

def _argv(tmp, extra=()):
    return ["--model_type", "translation", "--name", "t", "--checkpoints_dir", str(tmp),
            "--batch_size", str(B), "--compute_dtype", "float32", "--crop_size_h", str(H),
            "--crop_size_w", str(W), "--ndf", "16", "--num_iter_gen", "2",
            "--num_iter_dis", "1", *extra]


def _batch(seed=0):
    """tests/test_model_translation.py's fake batch: A's depth in [-0.5, 1],
    B's with holes at -1."""
    rng = np.random.default_rng(seed)
    da = rng.uniform(-0.5, 1, (B, H, W, 1)).astype(np.float32)
    db = rng.uniform(-0.5, 1, (B, H, W, 1)).astype(np.float32)
    db[db < -0.3] = -1.0
    return {"A_depth": da, "A_img": rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32),
            "B_depth": db, "B_img": rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)}


def _pair(tmp, extra=(), **overrides):
    """The JAX TranslationModel and the port's on the same weights, on the
    options of ``extra`` and then the attributes ``overrides``."""
    from desr_tpu.models.translation_model import TranslationModel as JaxTranslationModel
    from desr_tpu.options.train_options import TrainOptions

    jopt = TrainOptions().parse(_argv(tmp, extra))
    jopt.__dict__.update(overrides)
    jm = JaxTranslationModel(jopt)
    small = JT.default_translator_opt(ngf_img=8, ngf_depth=8, n_blocks=2)
    jm.nets["G_A"] = JT.define_Gen(small, "img_depth")
    jm.nets["G_B"] = JT.define_Gen(small, jm.opt.inp_B)
    jm.setup()
    params0 = {n: {k: np.array(v) for k, v in p.items()} for n, p in jm.params.items()}
    opt = train_options.parse(_argv(tmp, extra) + ["--device", "cpu"], print_options=False)
    opt.__dict__.update(overrides)
    with mock.patch.object(TT, "default_translator_opt", _small):
        tm = TranslationModel(opt, device="cpu", compute_dtype=torch.float32, is_train=True)
    assert tuple(tm.model_names) == tuple(jm.model_names)
    for n, p in params0.items():
        tm.nets[n].load_state_dict(from_jax_params(p), strict=True)
    return jm, tm, params0


def _jax_steps(jm, params_list, batch):
    """At each of ``params_list``: the G step's (loss, terms and
    depth_dif_A/B in meters, G grads, D feed) and the D step's (terms, D
    grads) on that feed, from the JAX model's own functions."""
    gen_forward, g_losses, d_losses = jm._forward_fns(), jm._g_losses_fn(), jm._d_losses_fn()
    weights, feed_keys = jm._weights(), jm._d_feed_keys()
    jb = {k: jnp.asarray(batch[k]) for k in INPUT_KEYS}
    g_names = ("G_A", "G_B")

    def g_loss(g, rest):
        full = dict(rest, **g)
        f = gen_forward(full, jb, jax.random.PRNGKey(0), True)
        loss, m = g_losses(f, full, weights, {})
        return loss, (m, {k: f[k] for k in feed_keys})

    def d_loss(d, feed):
        return d_losses(feed, d, {})

    g_vg = jax.jit(jax.value_and_grad(g_loss, has_aux=True))
    d_vg = jax.jit(jax.value_and_grad(d_loss, has_aux=True))
    host = lambda t: {k: np.asarray(v) for k, v in t.items()}  # noqa: E731
    half = jm.opt.max_distance / 2
    meters = lambda x: (x * half + half) / 1000.0  # noqa: E731
    real_B = batch["B_depth"][..., 0]
    out = []
    for params in params_list:
        g = {n: params[n] for n in g_names}
        rest = {n: p for n, p in params.items() if n not in g_names}
        (loss, (m, feed)), g_grads = g_vg(g, rest)
        (_, md), d_grads = d_vg(rest, feed)
        m, feed = host(m), host(feed)
        m["depth_dif_A"] = JLS.masked_l1_loss(meters(feed["real_depth_A"]),
                                              meters(feed["fake_depth_B"]),
                                              feed["real_depth_A"] > -0.98)
        m["depth_dif_B"] = JLS.masked_l1_loss(meters(real_B), meters(feed["fake_depth_A"]),
                                              feed["fake_depth_A"] > -0.98)
        out.append(dict(loss=float(loss), m=m, feed=feed, md=host(md),
                        g_grads={n: host(v) for n, v in g_grads.items()},
                        d_grads={n: host(v) for n, v in d_grads.items()}))
    return out


def _grads(tm, names):
    return {n: {k: p.grad.clone() for k, p in tm.nets[n].named_parameters()
                if p.grad is not None} for n in names}


def _host_tree(tree):
    return {n: {k: np.array(v) for k, v in p.items()} for n, p in tree.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One JAX model and the port's: the G step at the initial weights and
    the D step on its feed, then one whole iteration of each.

    JAX's iteration keeps the weights and Adam state its second G step
    starts from. The port's iteration keeps its own after its first G step
    and then takes its second G step and its D step from JAX's, so that
    each step is held against JAX's from the same start (see
    test_one_iteration_matches_jax). ``want`` holds JAX's steps at the
    initial weights, ``want_2`` at the second G step's start (the D step's
    feed and gradients)."""
    jm, tm, params0 = _pair(tmp_path_factory.mktemp("ck"))
    batch = _batch()
    g_starts, jax_g_step = [], jm._g_step

    def jax_g_step_and_keep(params, opt_state, *args):
        # copies: the step donates its weights and state
        g_starts.append((_host_tree(params), int(opt_state.step), _host_tree(opt_state.m),
                         _host_tree(opt_state.v)))
        return jax_g_step(params, opt_state, *args)

    jm._g_step = jax_g_step_and_keep
    jm.set_input(batch)
    jm.optimize_parameters(B)
    jm._g_step = jax_g_step
    assert len(g_starts) == 2
    params_1, jax_step_1, m_1, v_1 = g_starts[1]
    want, want_2 = _jax_steps(jm, [params0, params_1], batch)

    tm.set_input(batch)
    m, feed = tm.compute_grads()
    g_grads = _grads(tm, tm.model_names)
    md = tm.d_grads(feed)
    d_grads = _grads(tm, tm.model_names)
    # the iteration, with the feeds the G steps return and the D step takes
    returned, taken, after_1 = [], [], {}
    compute, d_step = tm.compute_grads, tm.d_grads

    def compute_and_keep():
        if returned:  # the second G step: keep the port's first, start from JAX's
            for n in ("G_A", "G_B"):
                for k, p in tm.nets[n].named_parameters():
                    st = tm.optimizer.state[p]
                    after_1[f"{n}.{k}"] = (p.detach().clone(), int(st["step"]),
                                           st["exp_avg"].clone(), st["exp_avg_sq"].clone())
                    with torch.no_grad():
                        p.copy_(torch.from_numpy(params_1[n][k]))
                        st["exp_avg"].copy_(torch.from_numpy(m_1[n][k]))
                        st["exp_avg_sq"].copy_(torch.from_numpy(v_1[n][k]))
        returned.append(compute())
        return returned[-1]

    with mock.patch.object(tm, "compute_grads", compute_and_keep), \
            mock.patch.object(tm, "d_grads", lambda f: taken.append(f) or d_step(f)):
        tm.optimize_parameters(B)
    return dict(jm=jm, tm=tm, params0=params0, params_1=params_1, jax_step_1=jax_step_1,
                m_1=m_1, v_1=v_1, after_1=after_1, want=want, want_2=want_2, m=m, feed=feed,
                g_grads=g_grads, md=md, d_grads=d_grads, returned=returned, taken=taken)


def _assert_grads(got, want, what):
    """Each tensor within 3e-2 relative L2 of JAX's (f32 order noise through
    a step that is ill-conditioned at a random init, as in
    tests/test_torch_i2d.py)."""
    assert set(got) == set(want), what
    for k, g in got.items():
        v = want[k]
        rel = np.linalg.norm(g.numpy() - v) / max(np.linalg.norm(v), 1e-30)
        assert rel <= 3e-2, (f"{what}.{k}", rel)


def test_g_step_loss_terms_match_jax(runs):
    """Every term of translation_model.py:220-272 and depth_dif_A/B within
    1e-4 relative; loss_names as the JAX model's (no mean_dif terms)."""
    r = runs
    assert set(r["tm"].loss_names) == set(r["jm"].loss_names)
    want = r["want"]["m"]
    for k in want:
        np.testing.assert_allclose(float(r["m"][k]), want[k], rtol=1e-4, atol=1e-7, err_msg=k)
    assert float(r["m"]["idt_A"]) == 0.0  # --no_idt_A, as shipped
    total = sum(float(r["m"][k]) for k in ("G_A", "G_B", "cycle_B", "cycle_n_B", "idt_B",
                                            "depth_range_A", "depth_range_B"))
    np.testing.assert_allclose(total, r["want"]["loss"], rtol=1e-4)


def test_g_step_grads_go_to_the_generators_alone_and_match_jax(runs):
    r = runs
    for n in r["tm"].disc_names:
        assert r["g_grads"][n] == {}, n
    for n in ("G_A", "G_B"):
        _assert_grads(r["g_grads"][n], r["want"]["g_grads"][n], n)


def test_d_step_on_the_stale_feed_matches_jax(runs):
    """The D step's feed is the G step's detached forward: the fakes, rec_B
    and real_A within 1e-4 of JAX's, and their normals; its terms within
    1e-4 relative and its gradients, to the Ds alone, within 3e-2."""
    r = runs
    assert set(r["feed"]) == set(r["want"]["feed"])
    for k, v in r["feed"].items():
        assert not v.requires_grad, k
        if "depth" in k:
            np.testing.assert_allclose(v.numpy(), r["want"]["feed"][k], rtol=0, atol=1e-4,
                                       err_msg=k)
        else:  # their normals (the fixed-FOV cross products amplify f32 noise)
            depth = r["feed"][k.replace("norm", "depth")]
            assert torch.equal(v, TNM.surface_normals_fov_planar(depth)), k
    for k, v in r["want"]["md"].items():
        np.testing.assert_allclose(float(r["md"][k]), float(v), rtol=1e-4, err_msg=k)
    for n in ("G_A", "G_B"):  # the G step's, left from before
        assert set(r["d_grads"][n]) == set(r["g_grads"][n])
    for n in r["tm"].disc_names:
        _assert_grads(r["d_grads"][n], r["want"]["d_grads"][n], n)


# An entry whose reference gradient is below this share of its tensor's
# largest sits at the f32 noise floor: the two packages' gradients may
# differ in sign there.
NOISE_FLOOR = 1e-4


def _assert_adam_step(got, want, ref_grad, lr, what):
    """|got - want| <= 1e-4 where the reference gradient is above the noise
    floor, else <= 2 lr: Adam's first step moves an entry by lr whatever
    the gradient's size, so a flip of the gradient's sign there changes the
    step by 2 lr; in the second step (b1 0.5, b2 0.999) by at most 1.89 lr."""
    d = np.abs(got - want)
    above = np.abs(ref_grad) >= NOISE_FLOOR * np.abs(ref_grad).max()
    assert d.shape == ref_grad.shape, what
    assert (d[above] <= 1e-4).all(), (what, float(d[above].max()))
    assert (d <= 2 * lr + 1e-7).all(), (what, float(d.max()))


def test_one_iteration_matches_jax(runs):
    """2 G steps (Adam (0.5, 0.999), L2 decay 1e-4) and 1 D step on the last
    G step's feed (Adam (0.5, 0.999), no decay), each held against JAX's
    from the same start: the first G step from the initial weights, the
    second and the D step from the weights and Adam state JAX's second G
    step starts from. After each step every parameter is within 1e-4 of
    JAX's where its reference gradient (JAX's, with the decay) is above the
    f32 noise floor, and within 2 lr below it. (Chained, one step's flips at
    the noise floor move the next step's gradients far above the floor.)
    The port's Adam state after its first step: step 1, moments within
    3e-2 relative L2 of JAX's. The metrics within 1e-4 relative of JAX's."""
    r = runs
    tm, jm = r["tm"], r["jm"]
    lr, wd = tm.optimizer.defaults["lr"], tm.optimizer.defaults["weight_decay"]
    assert len(r["returned"]) == 2 and len(r["taken"]) == 1
    assert r["taken"][0] is r["returned"][-1][1]  # the first D step eats the last G feed
    assert tm.optimizer.defaults["betas"] == tm.optimizer_D.defaults["betas"] == (0.5, 0.999)
    assert wd == 1e-4 and tm.optimizer_D.defaults["weight_decay"] == 0.0
    assert lr == tm.optimizer_D.defaults["lr"] == jm.opt.lr
    for k, v in jm.metrics.items():
        np.testing.assert_allclose(float(tm.metrics[k]), float(v), rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    p0, p1 = r["params0"], r["params_1"]
    assert r["jax_step_1"] == 1
    for n in ("G_A", "G_B"):
        sd = tm.nets[n].state_dict()
        for k, _ in tm.nets[n].named_parameters():
            got_1, step_1, m_1, v_1 = r["after_1"][f"{n}.{k}"]
            _assert_adam_step(got_1.numpy(), p1[n][k], r["want"]["g_grads"][n][k] + wd * p0[n][k],
                              lr, f"{n}.{k} after the first G step")
            assert step_1 == 1, k
            for got, want in ((m_1, r["m_1"][n][k]), (v_1, r["v_1"][n][k])):
                rel = np.linalg.norm(got.numpy() - want) / max(np.linalg.norm(want), 1e-30)
                assert rel <= 3e-2, (f"{n}.{k} Adam moment", rel)
            _assert_adam_step(sd[k].numpy(), np.asarray(jm.params[n][k]),
                              r["want_2"]["g_grads"][n][k] + wd * p1[n][k], lr,
                              f"{n}.{k} after the second G step")
    for n in tm.disc_names:
        sd = tm.nets[n].state_dict()
        for k, _ in tm.nets[n].named_parameters():
            _assert_adam_step(sd[k].numpy(), np.asarray(jm.params[n][k]),
                              r["want_2"]["d_grads"][n][k], lr, f"{n}.{k} after the D step")
    for n in tm.model_names:
        assert set(tm.nets[n].state_dict()) == set(jm.params[n]), n
        assert any(not np.array_equal(v.numpy(), p0[n][k])
                   for k, v in tm.nets[n].state_dict().items()), f"{n} did not move"


def test_gu_d_running_stats_follow_jax(tmp_path):
    """--netD Gu (BatchNorm by construction), one G step, the two depth Ds
    (the normal Ds run the same code): the Ds apply to real and fake apart
    (no batched concat) and their running statistics advance in the G step
    and the D step alike: after one iteration each D has counted 3 batches
    (the G step's fake, then real and fake) and its running moments are
    within 1e-4 relative of the JAX model's."""
    jm, tm, _ = _pair(tmp_path, ["--netD", "Gu", "--num_iter_gen", "1"],
                      disc_for_normals=False)
    assert tm.disc_names == ("D_A_depth", "D_B_depth")
    assert not tm.d_stateless() and not jm._d_stateless()
    batch = _batch(1)
    tm.set_input(batch)
    tm.optimize_parameters(B)
    jm.set_input(batch)
    jm.optimize_parameters(B)
    for n in tm.disc_names:
        sd = tm.nets[n].state_dict()
        counts = {int(v) for k, v in sd.items() if k.endswith("num_batches_tracked")}
        assert counts == {3} == {int(v) for k, v in jm.params[n].items()
                                 if k.endswith("num_batches_tracked")}, n
        for k, v in sd.items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(v.numpy(), np.asarray(jm.params[n][k]), rtol=1e-4,
                                           atol=1e-6, err_msg=f"{n}.{k}")
