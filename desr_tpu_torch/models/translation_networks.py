"""Generator zoo B (translation lineage): the stage-2 translator that stage 3
runs frozen as ``G_A_d`` (counterpart of ``desr_tpu/models/translation_networks.py``).

Only what the main path runs is ported: ``define_Gen`` for the ``img_depth``
input with transposed-conv upsampling and no dilation, and the hardcoded
``default_translator_opt`` (translation_networks.py:254-264).
Attribute names reproduce the JAX ``init`` keys (``enc_img.model.0.weight``,
``bottlenec.model.3.conv_block.1.bias``, ``dec_depth.model.0.transposeconv.weight``),
so a JAX param dict or a reference ``latest_net_G_A_d.pth`` loads with
``load_state_dict(strict=True)``.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn as nn

from desr_tpu_torch.models.layers import Conv2d, ConvTranspose2d, ReLU, Tanh, get_norm_layer
from desr_tpu_torch.models.networks import fused_resnet_chain, init_weights


class TransposeUp(nn.Module):
    """upsampling_type='transpose' (translation_networks.py:57-68)."""

    def __init__(self, in_ch, out_ch, use_bias):
        super().__init__()
        self.transposeconv = ConvTranspose2d(in_ch, out_ch, 4, stride=2, padding=1, bias=use_bias)

    def forward(self, x):
        return self.transposeconv(x)


class ResnetBlockT(nn.Module):
    """[conv3x3 (replicate), norm, ReLU, conv3x3 (replicate), norm] + skip
    (translation_networks.py:124-148), keys under ``conv_block.``.

    The forward is ``fused_resnet_chain`` with replicate borders: the
    [Conv2d(k=3, pad=1, padding_mode=replicate)] link that
    ``Sequential._fused_link`` parses (layers.py:257-262), GroupNorm folded
    into scale/shift.
    """

    def __init__(self, dim, norm_factory, use_bias):
        super().__init__()
        blocks = [Conv2d(dim, dim, 3, padding=1, padding_mode="replicate", bias=use_bias),
                  norm_factory(dim), ReLU(),
                  Conv2d(dim, dim, 3, padding=1, padding_mode="replicate", bias=use_bias),
                  norm_factory(dim)]
        self.conv_block = nn.Sequential(*blocks)

    def forward(self, x):
        b = self.conv_block
        return fused_resnet_chain(x, (b[0], b[3]), (b[1], b[4]), "replicate")


class _Part(nn.Module):
    """A Sequential published as ``model`` (the JAX ``_Wrapped("model", ...)``)."""

    def __init__(self, layers):
        super().__init__()
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        return self.model(x)


def _encoder(input_nc, base_nc, norm_factory, use_bias, n_downsampling):
    """translation_networks.py:151-166."""
    layers = [Conv2d(input_nc, base_nc, 7, padding=3, padding_mode="replicate", bias=use_bias),
              norm_factory(base_nc), ReLU()]
    for i in range(n_downsampling):
        mult = 2 ** i
        layers += [Conv2d(base_nc * mult, base_nc * mult * 2, 4, stride=2, padding=1,
                          padding_mode="replicate", bias=use_bias),
                   norm_factory(base_nc * mult * 2), ReLU()]
    return _Part(layers)


def _decoder(base_nc, output_nc, norm_factory, use_bias, n_downsampling):
    """translation_networks.py:169-184 with transposed-conv upsampling, Tanh head."""
    layers = []
    for i in range(n_downsampling):
        mult = 2 ** (n_downsampling - i)
        layers += [TransposeUp(mult * base_nc, base_nc * mult // 2, use_bias),
                   norm_factory(base_nc * mult // 2), ReLU()]
    layers += [Conv2d(base_nc, output_nc, 7, padding=3, padding_mode="replicate", bias=True),
               Tanh()]
    return _Part(layers)


def _bottleneck(base_nc, n_blocks, norm_factory, use_bias, n_downsampling):
    """translation_networks.py:187-194 without dilation or dropout."""
    dim = base_nc * 2 ** n_downsampling
    return _Part([ResnetBlockT(dim, norm_factory, use_bias) for _ in range(n_blocks)])


class TranslationGenerator(nn.Module):
    """Dual-branch translator, ``img_depth`` input (translation_networks.py:197-248):
    depth and image encoders, concatenated as ``[fd, fi]`` (:243) into the
    ResnetBlockT bottleneck, then the depth decoder with Tanh.
    ``forward(depth, img)`` takes NCHW tensors and returns (B, 1, H, W).
    """

    def __init__(self, opt, use_bias):
        super().__init__()
        if opt.upsampling_type != "transpose" or opt.dropout:
            raise NotImplementedError("translator upsampling other than transpose, or "
                                      "dropout: not yet ported")
        norm_factory, _ = get_norm_layer(opt.norm, lineage="translation")
        nd = opt.n_downsampling
        base_nc = opt.ngf_img + opt.ngf_depth
        self.enc_img = _encoder(opt.input_nc_img, opt.ngf_img, norm_factory, use_bias, nd)
        self.enc_depth = _encoder(opt.input_nc_depth, opt.ngf_depth, norm_factory, use_bias, nd)
        self.bottlenec = _bottleneck(base_nc, opt.n_blocks, norm_factory, use_bias, nd)
        self.dec_depth = _decoder(base_nc, opt.output_nc_depth, norm_factory, use_bias, nd)

    def forward(self, depth, img):
        x = torch.cat([self.enc_depth(depth), self.enc_img(img)], dim=1)
        return self.dec_depth(self.bottlenec(x))


def default_translator_opt(**overrides):
    """The hardcoded translator config of main_model.py:116-117
    (translation_networks.py:254-264)."""
    opt = SimpleNamespace(
        ngf_img=32, ngf_depth=32, ngf=64, norm="group", dropout=False,
        init_type="normal", input_nc_img=3, n_downsampling=2, use_semantic=False,
        n_blocks=9, upsampling_type="transpose", output_nc_depth=1, input_nc_depth=1,
    )
    for k, v in overrides.items():
        setattr(opt, k, v)
    return opt


def define_Gen(opt, input_type, out_type="depth", generator=None) -> nn.Module:
    """Mirror of define_Gen (translation_networks.py:315) for the generators
    stage 3 runs, built on the CPU with the lineage's init (InitCfg with
    ``gain_from_nonlinearity``: "normal" draws N(0, 0.02), layers.py:170-178).
    ``generator`` seeds the init (a fresh one seeded 0 when None)."""
    if (input_type, out_type) != ("img_depth", "depth"):
        raise NotImplementedError(f"define_Gen({input_type!r}, {out_type!r}): not yet ported")
    net = TranslationGenerator(opt, use_bias=opt.norm == "instance")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return init_weights(net, opt.init_type, 0.02, generator)
