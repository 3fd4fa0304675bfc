"""The port's generators (desr_tpu_torch/models/networks.py) against JAX ``Net``s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import jax_params, jax_shapes, nchw_to_nhwc, nhwc_to_nchw, randn

from desr_tpu.models import layers as JL
from desr_tpu.models import networks as JN
from desr_tpu_torch.models import networks as TN
from desr_tpu_torch.weights import from_jax_params


def _nets(outf, ngf_resnet, ngf_unet, depthf_outf=None):
    """(name, define_G args) of MainModel's four serving nets (main_model.py:108-126)."""
    depthf_outf = depthf_outf or outf
    return [
        ("I2D_features", (3, outf, ngf_resnet, "resnet_6blocks")),
        ("Image2Depth", (outf, 1, ngf_unet, "unet_128")),
        ("Depth_f", (2, depthf_outf, ngf_resnet, "resnet_6blocks")),
        ("Task", (outf + 5 + depthf_outf, 1, ngf_unet, "unet_128")),
    ]


@pytest.mark.parametrize("name,args", _nets(128, 32, 64), ids=lambda v: v if isinstance(v, str) else "")
def test_state_dict_matches_jax_init_at_default_widths(name, args):
    want = jax_shapes(JN.define_G(*args))
    got = {k: tuple(v.shape) for k, v in TN.define_G(*args).state_dict().items()}
    assert got == want


@pytest.mark.parametrize("name,args", _nets(16, 8, 8), ids=lambda v: v if isinstance(v, str) else "")
def test_forward_matches_jax_at_small_widths(name, args):
    jnet = JN.define_G(*args)
    params = jax_params(jnet, seed=3)
    # non-zero biases so that the fused chains' bias folding is exercised
    for i, k in enumerate(sorted(params)):
        if k.endswith("bias"):
            params[k] = randn(params[k].shape, 100 + i, 0.05)
    tnet = TN.define_G(*args).eval()
    tnet.load_state_dict(from_jax_params(params), strict=True)
    x = randn((2, 128, 128, args[0]), 7)
    want = jax.jit(lambda p, v: jnet.apply(p, v, JL.Ctx(dtype=jnp.float32)))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    with torch.no_grad():
        got = nchw_to_nhwc(tnet(nhwc_to_nchw(x)))
    assert got.shape == want.shape
    # tanh outputs; f32 accumulation order through InstanceNorm chains
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)


def test_resnet_block_matches_jax_fused_chain():
    """One 128-channel block at the smallest shape that takes the JAX ring
    route (H*W >= 16384, layers.py:697-700): the Pallas kernel runs in
    interpret mode through Sequential._run_fused_chain."""
    norm_factory, use_bias = JL.get_norm_layer("instance")
    jblock = JN.ResnetBlock(128, "reflect", norm_factory, False, use_bias)
    params = {k: np.array(v) for k, v in
              jblock.init(jax.random.PRNGKey(5), "b.", JL.InitCfg(init_gain=0.05)).items()}
    for i, k in enumerate(sorted(params)):
        if k.endswith("bias"):
            params[k] = randn(params[k].shape, 200 + i, 0.1)
    x = randn((1, 104, 160, 128), 9)
    want = jax.jit(lambda p, v: jblock.apply(p, v, "b.", JL.Ctx(dtype=jnp.float32,
                                                                  pallas_fuse=True)))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    tblock = TN.ResnetBlock(128, "reflect", TN.InstanceNorm2d, False, use_bias).eval()
    tblock.load_state_dict(from_jax_params({k[2:]: v for k, v in params.items()}), strict=True)
    with torch.no_grad():
        got = nchw_to_nhwc(tblock(nhwc_to_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


def test_resnet_block_routes_agree():
    """fused=False (conv3x3 + norm layers, the --pallas_conv route) computes
    the same function as the fused chain."""
    block = TN.ResnetBlock(16, "reflect", TN.InstanceNorm2d, False, True)
    for m in block.modules():
        if isinstance(m, TN.Conv2d):
            torch.nn.init.normal_(m.bias, 0, 0.1)
    x = torch.from_numpy(randn((2, 16, 9, 12), 4))
    with torch.no_grad():
        fused = block(x)
        block.fused = False
        plain = block(x)
    torch.testing.assert_close(fused, plain, rtol=0, atol=1e-5)


def test_sr_head_and_unported_norms_raise():
    """The U-Net SR head refuses --norm batch (its norms are wider than what
    they normalise, and the JAX layer fails there too); without the head
    --norm batch builds BatchNorm layers."""
    with pytest.raises(NotImplementedError, match="JAX layer fails there too"):
        TN.define_G(4, 1, 8, "unet_128", use_sr=True, norm="batch")
    net = TN.define_G(4, 1, 8, "resnet_6blocks", norm="batch")
    assert sum(isinstance(m, TN.BatchNorm2d) for m in net.modules()) == 17


@pytest.mark.parametrize("netG", ["unet_128", "unet_256"])
def test_sr_head_matches_jax(netG):
    """define_G(use_sr=True) at ngf 8: the JAX keys and shapes (the head's
    norms keep their as-shipped inner_nc width), and on a 128x128 (unet_128)
    or 256x256 (unet_256) input the one-channel output at twice the
    resolution, within 1e-4 (its 4- and 2-channel ResnetBlocks run the fused
    chain)."""
    args = (4, 1, 8, netG)
    jnet = JN.define_G(*args, use_sr=True)
    params = jax_params(jnet, seed=4)
    for i, k in enumerate(sorted(params)):
        if k.endswith("bias"):
            params[k] = randn(params[k].shape, 300 + i, 0.05)
    tnet = TN.define_G(*args, use_sr=True).eval()
    assert {k: tuple(v.shape) for k, v in tnet.state_dict().items()} == jax_shapes(jnet)
    tnet.load_state_dict(from_jax_params(params), strict=True)
    size = 128 if netG == "unet_128" else 256
    x = randn((1, size, size, 4), 8)
    want = jax.jit(lambda p, v: jnet.apply(p, v, JL.Ctx(dtype=jnp.float32)))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    with torch.no_grad():
        got = nchw_to_nhwc(tnet(nhwc_to_nchw(x)))
    assert got.shape == want.shape == (1, 2 * size, 2 * size, 1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)
