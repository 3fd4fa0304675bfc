"""The port's layers (desr_tpu_torch/models/layers.py) against the JAX layers, fp32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import nchw_to_nhwc, nhwc_to_nchw, randn

from desr_tpu.models import layers as JL
from desr_tpu_torch.models import layers as TL
from desr_tpu_torch.ops import instance_norm as IN

CFG = JL.InitCfg(init_gain=0.1)

# (id, jax layer, port layer, input NHWC shape, abs tolerance): each
# tolerance is f32 accumulation-order noise at these sizes
CASES = [
    ("conv_zeros_s1", JL.Conv2d(6, 5, 3, padding=1), TL.Conv2d(6, 5, 3, padding=1), (2, 9, 11, 6), 1e-5),
    ("conv_reflect", JL.Conv2d(6, 5, 3, padding=1, padding_mode="reflect"),
     TL.Conv2d(6, 5, 3, padding=1, padding_mode="reflect"), (2, 9, 11, 6), 1e-5),
    ("conv_replicate", JL.Conv2d(6, 5, 3, padding=1, padding_mode="replicate"),
     TL.Conv2d(6, 5, 3, padding=1, padding_mode="replicate"), (2, 9, 11, 6), 1e-5),
    ("conv_s2_k4", JL.Conv2d(6, 5, 4, stride=2, padding=1, bias=False),
     TL.Conv2d(6, 5, 4, stride=2, padding=1, bias=False), (2, 12, 10, 6), 1e-5),
    ("conv_s2_k3", JL.Conv2d(6, 5, 3, stride=2, padding=1), TL.Conv2d(6, 5, 3, stride=2, padding=1),
     (2, 12, 10, 6), 1e-5),
    ("conv_k7", JL.Conv2d(3, 4, 7), TL.Conv2d(3, 4, 7), (1, 14, 13, 3), 1e-5),
    ("convT_k3_outpad", JL.ConvTranspose2d(6, 4, 3, stride=2, padding=1, output_padding=1),
     TL.ConvTranspose2d(6, 4, 3, stride=2, padding=1, output_padding=1), (2, 5, 7, 6), 1e-5),
    ("convT_k4", JL.ConvTranspose2d(6, 4, 4, stride=2, padding=1),
     TL.ConvTranspose2d(6, 4, 4, stride=2, padding=1), (2, 5, 7, 6), 1e-5),
    ("instance_norm", JL.InstanceNorm2d(6), TL.InstanceNorm2d(6), (2, 9, 11, 6), 1e-5),
    ("relu", JL.ReLU(), TL.ReLU(), (2, 4, 5, 3), 0.0),
    ("leaky_relu", JL.LeakyReLU(0.2), TL.LeakyReLU(0.2), (2, 4, 5, 3), 1e-7),
    ("tanh", JL.Tanh(), TL.Tanh(), (2, 4, 5, 3), 1e-6),
    ("reflection_pad", JL.ReflectionPad2d(3), TL.ReflectionPad2d(3), (2, 6, 7, 3), 0.0),
    ("replication_pad", JL.ReplicationPad2d(1), TL.ReplicationPad2d(1), (2, 6, 7, 3), 0.0),
    ("upsample_nearest", JL.Upsample(2, "nearest"), TL.Upsample(scale_factor=2, mode="nearest"),
     (2, 4, 5, 3), 0.0),
    ("dropout_eval", JL.Dropout(0.5), TL.Dropout(0.5).eval(), (2, 4, 5, 3), 0.0),
]


@pytest.mark.parametrize("name,jl,tl,shape,tol", CASES, ids=[c[0] for c in CASES])
def test_layer_matches_jax(name, jl, tl, shape, tol):
    params = {k: np.asarray(v) for k, v in jl.init(jax.random.PRNGKey(1), "", CFG).items()}
    if "bias" in params:  # zero at init; make the bias path count
        params["bias"] = randn(params["bias"].shape, 3)
    tl.load_state_dict({k: torch.tensor(v) for k, v in params.items()}, strict=True)
    x = randn(shape, 2, 2.0) + 0.5
    want = jl.apply({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), "",
                    JL.Ctx(dtype=jnp.float32))
    got = nchw_to_nhwc(tl(nhwc_to_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


@pytest.mark.parametrize("with_bias", [True, False])
def test_norm_vectors_match_jax(with_bias):
    """Bias folding of the fused chains (layers.py:1164) and its meaning:
    x * scale + shift == InstanceNorm(x + bias)."""
    x = randn((2, 7, 9, 5), 4, 3.0) + 1.0
    bias = randn((5,), 5) if with_bias else None
    xt = nhwc_to_nchw(x)
    s, s2 = IN.instance_norm_moments(xt)
    n = 7 * 9
    sc, sh = TL.norm_vectors(TL.InstanceNorm2d(5), s, s2, n,
                             None if bias is None else torch.from_numpy(bias))
    jsc, jsh = JL._norm_vectors(JL.InstanceNorm2d(5), {}, "", jnp.asarray(s.numpy()),
                                jnp.asarray(s2.numpy()), n,
                                None if bias is None else jnp.asarray(bias))
    np.testing.assert_allclose(sc.numpy(), np.asarray(jsc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(sh.numpy(), np.asarray(jsh), rtol=1e-6, atol=1e-6)
    xb = xt + (0 if bias is None else torch.from_numpy(bias)[:, None, None])
    torch.testing.assert_close(xt * sc[:, :, None, None] + sh[:, :, None, None],
                               TL.InstanceNorm2d(5)(xb), rtol=0, atol=1e-5)


def test_get_norm_layer_bias_rule():
    for norm in ("instance", "none", "batch", "group"):
        _, jax_bias = JL.get_norm_layer(norm)
        factory, bias = TL.get_norm_layer(norm)
        assert bias == jax_bias
        want = {"instance": TL.InstanceNorm2d, "none": TL.Identity, "group": TL.GroupNorm,
                "batch": TL.BatchNorm2d}[norm]
        assert isinstance(factory(8), want)
    # GroupNorm(8): affine in the translation lineage only, as in the JAX package
    for lineage in ("pix2pix", "translation"):
        factory, _ = TL.get_norm_layer("group", lineage)
        jfactory, _ = JL.get_norm_layer("group", lineage)
        assert factory(16).affine == jfactory(16).affine == (lineage == "translation")
        assert factory(16).g == jfactory(16).g == 8


def test_layers_cast_f32_params_to_the_input_dtype():
    conv = TL.Conv2d(3, 4, 3, padding=1, padding_mode="reflect")
    x = torch.from_numpy(randn((1, 3, 5, 6), 6)).bfloat16()
    y = conv(x)
    assert conv.weight.dtype == torch.float32 and y.dtype == torch.bfloat16
    assert TL.InstanceNorm2d(4)(y).dtype == torch.bfloat16
