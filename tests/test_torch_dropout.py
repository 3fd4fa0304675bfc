"""The port's ``layers.Dropout`` on the CPU: its contract (the JAX layer's
p = 0.5 and x 2, a mask that is a pure function of the seed, the step, the
layer's prefix and the element's place in the global batch, cut to a
rank's rows and band), a train step under each remat flag against the step
without it, and the nets that hold a Dropout in train mode against the JAX
package's with the JAX masks given to the port (``Dropout.mask``): a zoo-A
``ResnetBlock``, a ``unet_128`` with ``use_dropout`` and a
``TranslationGenerator`` with ``dropout``, float32."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import nchw_to_nhwc, nhwc_to_nchw, randn

from desr_tpu.models import layers as JL
from desr_tpu.models import networks as JN
from desr_tpu.models import translation_networks as JT
from desr_tpu_torch.models import layers as TL
from desr_tpu_torch.models import networks as TN
from desr_tpu_torch.models import translation_networks as TT
from desr_tpu_torch.parallel import spatial as S
from desr_tpu_torch.weights import from_jax_params


def _dropout(prefix="model.3.", seed=0, step=0):
    d = TL.Dropout(0.5)
    d.prefix, d.seed, d.step = prefix, seed, step
    return d.train()


def test_keep_rate_and_scale():
    """1e5 values: the keep rate within 0.5 +- 0.01, every kept value
    exactly 2x, every other exactly 0; the identity in eval."""
    d = _dropout()
    x = torch.from_numpy(randn((4, 5, 50, 100), 1)) + 3.0
    y = d(x)
    kept = y != 0
    assert abs(kept.double().mean().item() - 0.5) <= 0.01
    assert torch.equal(y[kept], 2 * x[kept]) and torch.equal(y[~kept], torch.zeros_like(y[~kept]))
    assert d.eval()(x) is x


def test_mask_is_a_function_of_seed_step_and_prefix():
    """The same (seed, step, prefix) give the same mask, whatever was drawn
    before; changing any one of them gives another."""
    x = torch.ones(2, 4, 32, 24)
    ref = _dropout()(x)
    torch.rand(100)  # the default generator's state does not enter
    assert torch.equal(_dropout()(x), ref)
    for kw in ({"seed": 1}, {"step": 1}, {"prefix": "model.4."}):
        other = _dropout(**kw)(x)
        assert not torch.equal(other, ref), kw
        assert 0.45 < (other == ref).double().mean().item() < 0.55, kw


@pytest.mark.parametrize("rows,band", [((0, 2, 4), 0), ((2, 4, 4), 1), ((0, 4, 4), 1),
                                       ((1, 2, 4), 0)])
def test_rank_rows_and_band_cut_the_whole_draw(rows, band):
    """A rank holding rows lo..hi of a global batch of 4 and band ``band``
    of two (a spatial tag) draws one process's mask at those rows; with k
    branches concatenated along B (the main model's batched calls) each
    branch's rows are cut from its part of the global draw; inside
    ``spatial.whole()`` every rank draws the whole frame's mask."""
    x = torch.ones(8, 3, 32, 20)  # two branches of a global batch of 4
    whole = _dropout()(x)
    lo, hi, n = rows
    d = _dropout()
    d.rows, d.spatial = rows, S.Spatial(None, 2, band)
    part = torch.cat([x[lo:hi], x[n + lo:n + hi]])
    got = d(part[:, :, band * 16:(band + 1) * 16])
    want = torch.cat([whole[lo:hi], whole[n + lo:n + hi]])[:, :, band * 16:(band + 1) * 16]
    assert torch.equal(got, want)
    with S.whole():
        assert torch.equal(d(part), torch.cat([whole[lo:hi], whole[n + lo:n + hi]]))


def _step(fn, net, x, cot):
    net.zero_grad(set_to_none=True)
    out = fn(x)
    (out * cot).sum().backward()
    return out.detach(), {k: p.grad.clone() for k, p in net.named_parameters()}


@pytest.mark.parametrize("mode", ["net", "blocks", "tails"])
def test_step_under_each_remat_flag_equals_the_step_without(mode):
    """A ``resnet_6blocks`` with ``use_dropout`` (each block's Dropout
    splitting its K1 chain) and a ``unet_128`` with ``use_dropout`` in
    train mode: the output and every parameter's gradient under
    ``--remat`` ("net": one checkpoint over the call), ``--remat_blocks``
    or ``--remat_tails``, whose recomputes draw the forward's masks, equal
    the step without remat bit for bit at float32."""
    for netG, hw in (("resnet_6blocks", 32), ("unet_128", 128)):
        net = TN.define_G(3, 1, 8, netG, use_dropout=True,
                          generator=torch.Generator().manual_seed(1)).train()
        TL.set_dropout_key(net, 3, 7)
        x = torch.from_numpy(randn((2, 3, hw, hw), 2))
        cot = torch.from_numpy(randn((2, 1, hw, hw), 3))
        out, grads = _step(net, net, x, cot)
        if mode == "net":
            out_r, grads_r = _step(lambda v: TL.remat_call(net, "net", v), net, x, cot)
        else:
            out_r, grads_r = _step(TL.set_remat(net, mode), net, x, cot)
        assert torch.equal(out_r, out), netG
        for k, g in grads.items():
            assert torch.equal(grads_r[k], g), (netG, k)


# ----------------------------------------------------------------- the JAX nets

def _jax_masks(port_net, run_port, rng):
    """Give each Dropout of ``port_net`` the JAX layer's mask at its input's
    shape: bernoulli(fold_in(rng, crc32(prefix) % 2**31), 0.5) over the
    NHWC shape, transposed to NCHW."""
    shapes = {}
    hooks = [m.register_forward_pre_hook(
        lambda m, a: shapes.__setitem__(m, tuple(a[0].shape)))
        for m in port_net.modules() if isinstance(m, TL.Dropout)]
    with torch.no_grad():
        run_port()
    for h in hooks:
        h.remove()
    assert shapes
    for m, (b, c, h, w) in shapes.items():
        key = jax.random.fold_in(rng, zlib.crc32(m.prefix.encode()) % (2 ** 31))
        mask = np.asarray(jax.random.bernoulli(key, 0.5, (b, h, w, c)))
        m.mask = torch.from_numpy(np.ascontiguousarray(mask.transpose(0, 3, 1, 2)))
    return len(shapes)


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max(), err_msg=what)


def _jax_resnet_block():
    factory, use_bias = JL.get_norm_layer("instance")
    block = JN.ResnetBlock(16, "reflect", factory, True, use_bias)
    params = {k: np.asarray(v) for k, v in block.init(jax.random.PRNGKey(4), "",
                                                       JL.InitCfg()).items()}
    port = TL.name_dropouts(TN.ResnetBlock(16, "reflect", TL.InstanceNorm2d, True, use_bias))
    return (lambda p, x, ctx: block.apply(p, x, "", ctx)), params, port, (2, 12, 10, 16)


def _port_params(port):
    """The port net's seeded init as the JAX net's params (one key space)."""
    return {k: v.numpy().copy() for k, v in port.state_dict().items()}


def _jax_unet():
    net = JN.define_G(3, 1, 8, "unet_128", use_dropout=True)
    port = TN.define_G(3, 1, 8, "unet_128", use_dropout=True)
    return net.apply, _port_params(port), port, (1, 128, 128, 3)


def _translator_opt(mod):
    return mod.default_translator_opt(ngf_img=8, ngf_depth=8, n_blocks=2, dropout=True)


def _jax_translator():
    net = JT.define_Gen(_translator_opt(JT), "img_depth")
    port = TT.define_Gen(_translator_opt(TT), "img_depth")
    img = randn((2, 32, 32, 3), 9)

    def apply(p, depth, ctx):
        return net.apply(p, depth, jnp.asarray(img), ctx)
    return apply, _port_params(port), port, (2, 32, 32, 1), img


@pytest.mark.parametrize("which", ["resnet_block", "unet_128", "translator"])
def test_train_mode_matches_jax_with_its_masks(which):
    """In train mode (``ctx.train``, ``ctx.rng``) with the JAX layer's masks
    given to the port's Dropouts: the output and the input's gradient of a
    seeded scalar within 1e-5 of the JAX net's largest value, float32. The
    zoo-A block runs its K1 chain split at the Dropout (the second conv
    stats only, its plain version here)."""
    built = {"resnet_block": _jax_resnet_block, "unet_128": _jax_unet,
             "translator": _jax_translator}[which]()
    apply, params, port, shape = built[:4]
    img = built[4] if which == "translator" else None
    port.load_state_dict(from_jax_params(params), strict=True)
    port.train()
    x = randn(shape, 10)
    rng = jax.random.PRNGKey(11)
    ctx = JL.Ctx(train=True, rng=rng, dtype=jnp.float32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    cot = randn(tuple(shape[:3]) + ((shape[3] if which == "resnet_block" else 1),), 12)

    @jax.jit
    def out_and_dx(v, c):
        out, vjp = jax.vjp(lambda u: apply(jp, u, ctx), v)
        return out, vjp(c)[0]

    want, want_dx = out_and_dx(jnp.asarray(x), jnp.asarray(cot))

    xt = nhwc_to_nchw(x).requires_grad_(True)
    args = (xt,) if img is None else (xt, nhwc_to_nchw(img))
    n = _jax_masks(port, lambda: port(*args), rng)
    assert n == {"resnet_block": 1, "unet_128": 2, "translator": 2}[which]
    out = port(*args)
    (out * nhwc_to_nchw(cot)).sum().backward()
    _close(nchw_to_nhwc(out), np.asarray(want), "output")
    _close(nchw_to_nhwc(xt.grad), np.asarray(want_dx), "input gradient")
