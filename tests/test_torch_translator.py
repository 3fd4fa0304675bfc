"""The port's translator (desr_tpu_torch/models/translation_networks.py) and
its GroupNorm layer against the JAX package, fp32 on the CPU.

The translator's widths are hardcoded (translation_networks.py:254-264:
GroupNorm(8), 9 ResnetBlockT at 256 channels), so these tests keep them and
cut the frame to 64x64 instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import jax_params, jax_shapes, nchw_to_nhwc, nhwc_to_nchw, randn

from desr_tpu.models import layers as JL
from desr_tpu.models import translation_networks as JT
from desr_tpu_torch.models import layers as TL
from desr_tpu_torch.models import translation_networks as TT
from desr_tpu_torch.ops import instance_norm as IN
from desr_tpu_torch.weights import from_jax_params

F32 = JL.Ctx(dtype=jnp.float32)


def _gn_params(c, seed):
    rng = np.random.default_rng(seed)
    return {"weight": rng.uniform(0.5, 1.5, c).astype(np.float32),
            "bias": rng.standard_normal(c).astype(np.float32)}


@pytest.mark.parametrize("affine", [True, False])
def test_group_norm_matches_jax(affine):
    """One-pass moments per (batch, group) in f32: 1e-5 abs on unit-scale output."""
    x = randn((2, 9, 11, 16), 1, 2.0) + 0.7
    params = _gn_params(16, 2) if affine else {}
    want = JL.GroupNorm(8, 16, affine=affine).apply(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), "", F32)
    layer = TL.GroupNorm(8, 16, affine=affine)
    if affine:
        layer.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    got = nchw_to_nhwc(layer(nhwc_to_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("with_bias", [True, False])
def test_group_norm_vectors_match_jax(with_bias):
    """The GroupNorm branch of norm_vectors (layers.py:1183-1200), affine
    folded in, and its meaning: x * scale + shift == GroupNorm(x + bias)."""
    x = randn((2, 7, 9, 16), 4, 3.0) + 1.0
    bias = randn((16,), 5) if with_bias else None
    params = _gn_params(16, 6)
    xt = nhwc_to_nchw(x)
    s, s2 = IN.instance_norm_moments(xt)
    norm = TL.GroupNorm(8, 16)
    norm.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    sc, sh = TL.norm_vectors(norm, s, s2, 63, None if bias is None else torch.from_numpy(bias))
    jsc, jsh = JL._norm_vectors(JL.GroupNorm(8, 16), {k: jnp.asarray(v) for k, v in params.items()},
                                "", jnp.asarray(s.numpy()), jnp.asarray(s2.numpy()), 63,
                                None if bias is None else jnp.asarray(bias))
    np.testing.assert_allclose(sc.detach().numpy(), np.asarray(jsc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(sh.detach().numpy(), np.asarray(jsh), rtol=1e-6, atol=1e-5)
    xb = xt + (0 if bias is None else torch.from_numpy(bias)[:, None, None])
    torch.testing.assert_close(xt * sc[:, :, None, None] + sh[:, :, None, None],
                               norm(xb), rtol=0, atol=1e-4)


def test_resnet_block_t_matches_jax():
    """The fused chain (replicate borders, GroupNorm folded) against the JAX
    block's layer-by-layer forward: f32 order noise, 1e-4 abs."""
    factory, use_bias = JL.get_norm_layer("group", lineage="translation")
    jblock = JT.ResnetBlockT(32, 1, factory, use_bias, False)
    cfg = JL.InitCfg(gain_from_nonlinearity=True)
    params = {k: np.asarray(v) for k, v in jblock.init(jax.random.PRNGKey(3), "", cfg).items()}
    for k in params:
        if k.endswith("bias"):  # zero at init; make the affine shift count
            params[k] = randn(params[k].shape, 8, 0.3)
    tfactory, tbias = TL.get_norm_layer("group", lineage="translation")
    tblock = TT.ResnetBlockT(32, tfactory, tbias)
    tblock.load_state_dict(from_jax_params(params), strict=True)
    x = randn((2, 12, 10, 32), 9)
    want = jblock.apply({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), "", F32)
    got = nchw_to_nhwc(tblock(nhwc_to_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)


def test_define_gen_keys_shapes_and_output_match_jax():
    """define_Gen(default_translator_opt(), "img_depth"): the state_dict keys
    and shapes equal Net.init's, and with the JAX params loaded the 64x64
    forward matches within 2e-4 on the tanh output (f32 order noise through
    2 + 18 + 2 convs and their norms)."""
    jnet = JT.define_Gen(JT.default_translator_opt(), input_type="img_depth")
    tnet = TT.define_Gen(TT.default_translator_opt(), "img_depth")
    shapes = jax_shapes(jnet)
    assert {k: tuple(v.shape) for k, v in tnet.state_dict().items()} == shapes
    assert "enc_img.model.0.weight" in shapes and "dec_depth.model.0.transposeconv.weight" in shapes
    params = jax_params(jnet, seed=4)
    tnet.load_state_dict(from_jax_params(params), strict=True)
    depth = np.random.default_rng(5).uniform(-1, 1, (2, 64, 64, 1)).astype(np.float32)
    img = randn((2, 64, 64, 3), 6)
    want = jax.jit(lambda p, d, i: jnet.apply(p, d, i, F32))(params, depth, img)
    with torch.no_grad():
        got = nchw_to_nhwc(tnet(nhwc_to_nchw(depth), nhwc_to_nchw(img)))
    assert got.shape == want.shape == (2, 64, 64, 1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2e-4)


def test_translator_init_is_the_lineage_init():
    """"normal" with gain_from_nonlinearity: conv weights N(0, 0.02), the
    one conv bias (the head's) zero, GroupNorm weights N(1, 0.02), biases 0."""
    net = TT.define_Gen(TT.default_translator_opt(), "img_depth",
                        generator=torch.Generator().manual_seed(1))
    sd = net.state_dict()
    w = torch.cat([v.flatten() for k, v in sd.items() if v.dim() == 4])
    assert abs(float(w.std()) - 0.02) < 1e-3 and abs(float(w.mean())) < 1e-3
    gn = torch.cat([v for k, v in sd.items() if v.dim() == 1 and k.endswith("weight")])
    assert abs(float(gn.mean()) - 1.0) < 2e-3 and abs(float(gn.std()) - 0.02) < 2e-3
    assert all(float(v.abs().max()) == 0 for k, v in sd.items() if k.endswith("bias"))
