"""The translation zoo's split generators ``GeneratorI_F`` / ``GeneratorF_D``
(the dilated bottleneck) and ``define_G(use_old=True)`` under group norm,
the port against the JAX package on the CPU, float32, at
tests/test_networks_extra.py's shapes (``ngf_img_feature`` 8, 32x32 images
and 8x8x32 features), the JAX init's weights loaded with ``strict=True``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import jax_params, jax_shapes, nchw_to_nhwc, nhwc_to_nchw, randn

from desr_tpu.models import layers as JL
from desr_tpu.models import networks as JN
from desr_tpu.models import translation_networks as JT
from desr_tpu_torch.models import layers as TL
from desr_tpu_torch.models import networks as TN
from desr_tpu_torch.models import translation_networks as TT
from desr_tpu_torch.weights import from_jax_params

F32 = JL.Ctx(dtype=jnp.float32)
SPLIT = {"I_F": (("img", "feature"), (2, 32, 32, 3)),
         "F_D": (("feature", "depth"), (2, 8, 8, 32))}


def _opt(mod):
    opt = mod.default_translator_opt()
    opt.ngf_img_feature = 8
    return opt


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("which", sorted(SPLIT))
def test_split_generator_matches_jax(which):
    """Keys and shapes equal the JAX init's (``enc.`` / ``bottlenec.`` /
    ``dec.``); in eval the forward is the JAX one's within 1e-5 of its
    largest value; every parameter's gradient of the summed output within
    3e-2 relative L2 of JAX's (the bound of a random init's ill-conditioned
    gradients, tests/test_lockstep.py:94-97; largest entry under 1e-4 of
    the net's: a conv bias before a GroupNorm, exact gradient 0, within
    1e-4 of the net's largest entry). GeneratorI_F's first block runs K1's
    chain (its plain version here), its dilated ones cuDNN's convs."""
    (inp, out), shape = SPLIT[which]
    jnet = JT.define_Gen(_opt(JT), inp, out)
    net = TT.define_Gen(_opt(TT), inp, out)
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == jax_shapes(jnet)
    params = jax_params(jnet, 7)
    net.load_state_dict(from_jax_params(params), strict=True)
    dilations = [b.dilation for b in net.bottlenec.model]
    assert dilations == ([1, 2, 4, 8, 8, 8] if which == "I_F" else [1] * 9)
    x = randn(shape, 8)
    jp = {k: jnp.asarray(v) for k, v in params.items()}

    def summed(p):
        out = jnet.apply(p, jnp.asarray(x), F32)
        return out.sum(), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(summed, has_aux=True))(jp)
    want = np.asarray(want)
    got = net.eval()(nhwc_to_nchw(x))
    np.testing.assert_allclose(nchw_to_nhwc(got), want, rtol=0, atol=1e-5 * np.abs(want).max())
    got.sum().backward()
    grads = {k: p.grad.numpy() for k, p in net.named_parameters()}
    assert set(grads) == set(jgrads)
    net_max = max(np.abs(np.asarray(g)).max() for g in jgrads.values())
    for k, g in jgrads.items():
        g = np.asarray(g)
        if np.abs(g).max() < 1e-4 * net_max:
            np.testing.assert_allclose(grads[k], g, rtol=0, atol=1e-4 * net_max, err_msg=k)
        else:
            assert _rel(grads[k], g) <= 3e-2, (k, _rel(grads[k], g))


def test_dilated_block_refuses_a_spatial_tag():
    """A dilated ResnetBlockT's convs keep refusing a rank's band
    (``conv_rows``): no model builds one on a spatial mesh."""
    from desr_tpu_torch.parallel import spatial as S

    block = TT.ResnetBlockT(8, lambda ch: TL.GroupNorm(8, ch), False, dilation=2)
    block.conv_block[0].spatial = S.Spatial(None, 2, 0)
    with pytest.raises(NotImplementedError, match="3x3 stride-1 conv"):
        block(torch.zeros(1, 8, 16, 8))


@pytest.mark.parametrize("netG,hw", [("unet_128", 128), ("resnet_6blocks", 32)])
def test_use_old_group_norm_matches_jax(netG, hw):
    """``define_G(..., norm="group", use_old=True)``: GroupNorm(1,
    affine=False) at every norm (the ResnetBlocks' K1 chains fold its one
    group over all channels, ``norm_vectors``), keys and shapes equal to the
    JAX net's; with the port's seeded weights in both, the forward within
    1e-5 of the JAX one's largest value, and the
    GroupNorm(8) net with the same weights differs from it."""
    jnet = JN.define_G(3, 1, 8, netG, norm="group", use_old=True)
    net = TN.define_G(3, 1, 8, netG, norm="group", use_old=True)
    norms = [m for m in net.modules() if isinstance(m, TL.GroupNorm)]
    assert norms and all(m.g == 1 and not m.affine for m in norms)
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == jax_shapes(jnet)
    params = {k: v.numpy().copy() for k, v in net.state_dict().items()}
    x = randn((2, hw, hw, 3), 10)
    want = np.asarray(jax.jit(lambda p, v: jnet.apply(p, v, F32))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x)))
    with torch.no_grad():
        got = nchw_to_nhwc(net.eval()(nhwc_to_nchw(x)))
        eight = TN.define_G(3, 1, 8, netG, norm="group")
        eight.load_state_dict(from_jax_params(params), strict=True)
        other = nchw_to_nhwc(eight.eval()(nhwc_to_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert np.abs(other - want).max() > 1e-3 * np.abs(want).max()
