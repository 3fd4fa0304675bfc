"""Net zoo B (translation lineage): the stage-2 translators, which stage 3 runs
frozen as ``G_A_d``, and stage 2's discriminators (counterpart of
``desr_tpu/models/translation_networks.py``).

``define_Gen`` builds the ``img_depth`` and ``depth`` inputs with the
transpose, upconv or uptranspose upsampling and no dilation, on the hardcoded
``default_translator_opt`` (translation_networks.py:254-264); ``define_D`` the
basic, n_layers, Gu and pixel discriminators, with --use_spnorm.
Attribute names reproduce the JAX ``init`` keys (``enc_img.model.0.weight``,
``bottlenec.model.3.conv_block.1.bias``, ``dec_depth.model.0.transposeconv.weight``,
``model.0.weight_orig``), so a JAX param dict or a reference
``latest_net_G_A_d.pth`` loads with ``load_state_dict(strict=True)``. Not
ported: the dilated bottleneck and ``GeneratorI_F`` / ``GeneratorF_D``, which
no model builds, and translator dropout, which ``default_translator_opt``
turns off. The composites (encoder, decoder and bottleneck parts, the
ResnetBlockTs, the up layers) read their ``remat`` mode
(``layers.set_remat``), as zoo A's do.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn as nn

from desr_tpu_torch.models.layers import (
    BatchNorm2d,
    Conv2d,
    ConvTranspose2d,
    LeakyReLU,
    ReLU,
    SpectralNormConv2d,
    Tanh,
    Upsample,
    get_norm_layer,
    remat_call,
    run_layers,
)
from desr_tpu_torch.models.networks import (
    NLayerDiscriminator,
    PixelDiscriminator,
    calculate_gain,
    fused_resnet_chain,
    init_weights,
)


class TransposeUp(nn.Module):
    """upsampling_type='transpose' (translation_networks.py:57-68)."""

    remat = None

    def __init__(self, in_ch, out_ch, use_bias):
        super().__init__()
        self.transposeconv = ConvTranspose2d(in_ch, out_ch, 4, stride=2, padding=1, bias=use_bias)

    def forward(self, x):
        return self.transposeconv(x)


def _resizeconv(mode, in_ch, out_ch, use_bias):
    return nn.Sequential(Upsample(scale_factor=2, mode=mode),
                         Conv2d(in_ch, out_ch, 3, padding=1, padding_mode="replicate",
                                bias=use_bias))


class UpConv(nn.Module):
    """upsampling_type='upconv' (translation_networks.py:71-87): nearest x2,
    then a replicate-padded 3x3 conv."""

    remat = None

    def __init__(self, in_ch, out_ch, use_bias):
        super().__init__()
        self.resizeconv = _resizeconv("nearest", in_ch, out_ch, use_bias)

    def forward(self, x):
        return run_layers(self.resizeconv, x, self.remat)


class UpTranspose(nn.Module):
    """upsampling_type='uptranspose' (translation_networks.py:90-118): bilinear
    x2 and a replicate-padded 3x3 conv, plus a bias-free transposed conv."""

    remat = None

    def __init__(self, in_ch, out_ch, use_bias):
        super().__init__()
        self.resizeconv = _resizeconv("bilinear", in_ch, out_ch, use_bias)
        self.transposeconv = ConvTranspose2d(in_ch, out_ch, 4, stride=2, padding=1, bias=False)

    def forward(self, x):
        return run_layers(self.resizeconv, x, self.remat) + self.transposeconv(x)


UP_LAYERS = {"transpose": TransposeUp, "upconv": UpConv, "uptranspose": UpTranspose}


class ResnetBlockT(nn.Module):
    """[conv3x3 (replicate), norm, ReLU, conv3x3 (replicate), norm] + skip
    (translation_networks.py:124-148), keys under ``conv_block.``.

    The forward is ``fused_resnet_chain`` with replicate borders: the
    [Conv2d(k=3, pad=1, padding_mode=replicate)] link that
    ``Sequential._fused_link`` parses (layers.py:257-262), GroupNorm folded
    into scale/shift. Under a remat mode the chain is one checkpointed span.
    """

    remat = None

    def __init__(self, dim, norm_factory, use_bias):
        super().__init__()
        blocks = [Conv2d(dim, dim, 3, padding=1, padding_mode="replicate", bias=use_bias),
                  norm_factory(dim), ReLU(),
                  Conv2d(dim, dim, 3, padding=1, padding_mode="replicate", bias=use_bias),
                  norm_factory(dim)]
        self.conv_block = nn.Sequential(*blocks)

    def forward(self, x):
        return remat_call(self._chain, self.remat, x)

    def _chain(self, x):
        b = self.conv_block
        return fused_resnet_chain(x, (b[0], b[3]), (b[1], b[4]), "replicate")


class _Part(nn.Module):
    """A Sequential published as ``model`` (the JAX ``_Wrapped("model", ...)``)."""

    remat = None

    def __init__(self, layers):
        super().__init__()
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        return run_layers(self.model, x, self.remat)


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


def _decoder(base_nc, output_nc, norm_factory, use_bias, up_layer, n_downsampling):
    """translation_networks.py:169-184, Tanh head."""
    layers = []
    for i in range(n_downsampling):
        mult = 2 ** (n_downsampling - i)
        layers += [up_layer(mult * base_nc, base_nc * mult // 2, use_bias),
                   norm_factory(base_nc * mult // 2), ReLU()]
    layers += [Conv2d(base_nc, output_nc, 7, padding=3, padding_mode="replicate", bias=True),
               Tanh()]
    return _Part(layers)


def _bottleneck(base_nc, n_blocks, norm_factory, use_bias, n_downsampling):
    """translation_networks.py:187-194 without dilation or dropout."""
    dim = base_nc * 2 ** n_downsampling
    return _Part([ResnetBlockT(dim, norm_factory, use_bias) for _ in range(n_blocks)])


class TranslationGenerator(nn.Module):
    """Dual-branch translator (translation_networks.py:197-248). ``img_depth``:
    depth and image encoders, concatenated as ``[fd, fi]`` (:243) into the
    ResnetBlockT bottleneck, then the depth decoder with Tanh; ``depth`` (the
    --inp_B depth G_B, :219-224): one depth encoder of 2 x ngf_depth channels.
    ``forward(depth, img=None)`` takes NCHW tensors and returns (B, 1, H, W).
    """

    def __init__(self, opt, input_type, use_bias):
        super().__init__()
        if input_type not in ("img_depth", "depth"):
            raise NotImplementedError(f"input type {input_type}")
        if opt.dropout:
            raise NotImplementedError("translator dropout: not yet ported")
        norm_factory, _ = get_norm_layer(opt.norm, lineage="translation")
        up_layer = UP_LAYERS[opt.upsampling_type]
        nd = opt.n_downsampling
        self.input_type = input_type
        if input_type == "img_depth":
            base_nc = opt.ngf_img + opt.ngf_depth
            self.enc_img = _encoder(opt.input_nc_img, opt.ngf_img, norm_factory, use_bias, nd)
            self.enc_depth = _encoder(opt.input_nc_depth, opt.ngf_depth, norm_factory,
                                      use_bias, nd)
        else:
            base_nc = opt.ngf_depth * 2
            self.enc_depth = _encoder(opt.input_nc_depth, base_nc, norm_factory, use_bias, nd)
        self.bottlenec = _bottleneck(base_nc, opt.n_blocks, norm_factory, use_bias, nd)
        self.dec_depth = _decoder(base_nc, opt.output_nc_depth, norm_factory, use_bias,
                                  up_layer, nd)

    def forward(self, depth, img=None):
        x = self.enc_depth(depth)
        if self.input_type == "img_depth":
            x = torch.cat([x, self.enc_img(img)], dim=1)
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
    """Mirror of define_Gen (translation_networks.py:208) for the ``img_depth``
    and ``depth`` inputs, built on the CPU with the lineage's init (InitCfg
    with ``gain_from_nonlinearity``, relu: "normal" draws N(0, 0.02), xavier
    and orthogonal take the gain sqrt(2), translation_networks.py:227-228).
    ``generator`` seeds the init (a fresh one seeded 0 when None)."""
    if (input_type, out_type) in (("img", "feature"), ("feature", "depth")):
        raise NotImplementedError(f"define_Gen({input_type!r}, {out_type!r}), the split "
                                  "generators GeneratorI_F / GeneratorF_D: not yet ported")
    net = TranslationGenerator(opt, input_type, use_bias=opt.norm == "instance")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return init_weights(net, opt.init_type, 0.02, generator, gain=calculate_gain("relu"))


class GuDiscriminator(nn.Module):
    """DepthDiscriminator "Gu" (translation_networks.py:345-357): eight 3x3
    conv + BatchNorm + LeakyReLU stages, then a 3x3 conv to one logit; keys
    under ``model.``."""

    def __init__(self, input_nc, ndf, conv_cls):
        super().__init__()
        seq, prev, cur = [], input_nc, ndf
        for m, stride in zip((1, 1, 1, 2, 1, 2, 1, 1), (1, 2, 1, 2, 1, 2, 1, 2)):
            seq += [conv_cls(prev, cur, 3, stride=stride, padding=1, bias=False),
                    BatchNorm2d(cur), LeakyReLU(0.2)]
            prev, cur = cur, cur * m
        seq.append(conv_cls(prev, 1, 3, stride=1, padding=1, bias=True))
        self.model = nn.Sequential(*seq)

    def forward(self, x):
        return self.model(x)


def define_D(opt, input_type="depth", generator=None) -> nn.Module:
    """Mirror of the translation lineage's define_D (translation_networks.py:
    360-385): ``basic`` (3 layers), ``n_layers`` (--n_layers_D), ``Gu``
    (BatchNorm by construction; ndf fixed at 64, as the reference passes
    only input_nc) or ``pixel`` (keys under ``net.``), on --norm_d with
    convs biased only under instance norm (so under the default ``none`` the
    middle convs have neither bias nor norm); --use_spnorm swaps the convs of
    all but ``pixel`` for spectral-norm convs. ``input_type``: depth (1
    channel) or normal (3). The init's gain is leaky_relu(0.2)'s (:366-367)."""
    input_nc = {"depth": 1, "normal": 3}[input_type]
    norm_factory, _ = get_norm_layer(opt.norm_d, lineage="translation")
    use_bias = opt.norm_d == "instance"
    conv_cls = SpectralNormConv2d if getattr(opt, "use_spnorm", False) else Conv2d
    if opt.netD in ("basic", "n_layers"):
        n_layers = 3 if opt.netD == "basic" else opt.n_layers_D
        net = NLayerDiscriminator(input_nc, opt.ndf, n_layers, norm_factory, use_bias, conv_cls)
    elif opt.netD == "Gu":
        net = GuDiscriminator(input_nc, 64, conv_cls)
    elif opt.netD == "pixel":
        net = PixelDiscriminator(input_nc, opt.ndf, norm_factory, use_bias)
    else:
        raise NotImplementedError(f"Discriminator model name [{opt.netD}] is not recognized")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return init_weights(net, opt.init_type, 0.02, generator,
                        gain=calculate_gain("leaky_relu", 0.2))
