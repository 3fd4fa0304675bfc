"""Net zoo B (translation lineage): the stage-2 translators, which stage 3 runs
frozen as ``G_A_d``, and stage 2's discriminators (counterpart of
``desr_tpu/models/translation_networks.py``).

``define_Gen`` builds the ``img_depth`` and ``depth`` inputs with the
transpose, upconv or uptranspose upsampling, on the hardcoded
``default_translator_opt`` (translation_networks.py:254-264), and the split
generators ``GeneratorI_F`` (image -> feature: an encoder and six
ResnetBlockTs dilated 1, 2, 4, 8, 8, 8) and ``GeneratorF_D`` (feature ->
depth: nine ResnetBlockTs and a decoder), which no model builds;
``define_D`` the basic, n_layers, Gu and pixel discriminators, with
--use_spnorm. Attribute names reproduce the JAX ``init`` keys
(``enc_img.model.0.weight``, ``bottlenec.model.3.conv_block.1.bias``,
``dec_depth.model.0.transposeconv.weight``, ``enc.model.0.weight``,
``dec.model.6.weight``, ``model.0.weight_orig``), so a JAX param dict or a
reference ``latest_net_G_A_d.pth`` loads with ``load_state_dict(strict=True)``.
Translator dropout (``opt.dropout``, which ``default_translator_opt`` turns
off) puts a ``layers.Dropout`` in each ResnetBlockT.
The composites (encoder, decoder and bottleneck parts, the
ResnetBlockTs, the up layers) read their ``remat`` mode
(``layers.set_remat``), as zoo A's do. Under ``--spatial_devices`` the
translators run on a rank's band of rows as the serving nets do
(``layers``, ``networks``), and the Gu discriminator gathers before its
first level that the group does not split (``GuDiscriminator``).
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn as nn

from desr_tpu_torch.models.layers import (
    BatchNorm2d,
    Conv2d,
    ConvTranspose2d,
    Dropout,
    LeakyReLU,
    ReLU,
    SpectralNormConv2d,
    Tanh,
    Upsample,
    get_norm_layer,
    name_dropouts,
    remat_call,
    run_layers,
)
from desr_tpu_torch.models.networks import (
    NLayerDiscriminator,
    PixelDiscriminator,
    bands_then_whole,
    calculate_gain,
    fused_resnet_chain,
    init_weights,
)
from desr_tpu_torch.parallel import spatial as S


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
    """[conv3x3 (replicate, dilation d), norm, ReLU, (Dropout), conv3x3, norm]
    + skip (translation_networks.py:124-148), keys under ``conv_block.``.

    With dilation 1 the forward is ``fused_resnet_chain`` with replicate
    borders: the [Conv2d(k=3, pad=1, padding_mode=replicate)] link that
    ``Sequential._fused_link`` parses (layers.py:257-262), GroupNorm folded
    into scale/shift, split at the Dropout in training. A dilated block
    (``GeneratorI_F``'s, padding d) runs its layers, cuDNN's convs, as the
    JAX package runs XLA's there (its ring route needs dilation 1,
    layers.py:674); its convs refuse a ``spatial`` tag (``conv_rows``). Under
    a remat mode the chain is one checkpointed span (a dilated block's runs
    go through ``run_layers``); under a ``spatial`` tag K1 reads halo rows.
    """

    remat = None
    spatial = None

    def __init__(self, dim, norm_factory, use_bias, dilation=1, dropout=False):
        super().__init__()
        conv = lambda: Conv2d(dim, dim, 3, padding=dilation, dilation=dilation,  # noqa: E731
                              padding_mode="replicate", bias=use_bias)
        blocks = [conv(), norm_factory(dim), ReLU()]
        if dropout:
            blocks.append(Dropout(0.5))
        blocks += [conv(), norm_factory(dim)]
        self.conv_block = nn.Sequential(*blocks)
        self.dilation = dilation
        self._dropout = blocks[3] if dropout else None

    def forward(self, x):
        if self.dilation != 1:
            return x + run_layers(self.conv_block, x, self.remat)
        return remat_call(self._chain, self.remat, x)

    def _chain(self, x):
        b = self.conv_block
        return fused_resnet_chain(x, (b[0], b[-2]), (b[1], b[-1]), "replicate", self.spatial,
                                  self._dropout)


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


def _bottleneck(base_nc, n_blocks, norm_factory, use_bias, n_downsampling, dropout=False,
                use_dilation=False):
    """translation_networks.py:187-194: block i dilated min(2**i, 8) with
    ``use_dilation``."""
    dim = base_nc * 2 ** n_downsampling
    return _Part([ResnetBlockT(dim, norm_factory, use_bias,
                               min(2 ** i, 8) if use_dilation else 1, dropout)
                  for i in range(n_blocks)])


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
        self.bottlenec = _bottleneck(base_nc, opt.n_blocks, norm_factory, use_bias, nd,
                                     opt.dropout)
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


class GeneratorI_F(nn.Module):
    """image -> feature split generator (translation_networks.py:266-287):
    an encoder of ``ngf_img_feature`` base channels (``enc.``) and six
    ResnetBlockTs dilated 1, 2, 4, 8, 8, 8 (``bottlenec.``)."""

    def __init__(self, opt, use_bias):
        super().__init__()
        norm_factory, _ = get_norm_layer(opt.norm, lineage="translation")
        base_nc, nd = opt.ngf_img_feature, opt.n_downsampling
        self.enc = _encoder(opt.input_nc_img, base_nc, norm_factory, use_bias, nd)
        self.bottlenec = _bottleneck(base_nc, 6, norm_factory, use_bias, nd, opt.dropout,
                                     use_dilation=True)

    def forward(self, x):
        return self.bottlenec(self.enc(x))


class GeneratorF_D(nn.Module):
    """feature -> depth split generator (translation_networks.py:290-312):
    nine ResnetBlockTs (``bottlenec.``) and the depth decoder with Tanh
    (``dec.``)."""

    def __init__(self, opt, use_bias):
        super().__init__()
        norm_factory, _ = get_norm_layer(opt.norm, lineage="translation")
        base_nc, nd = opt.ngf_img_feature, opt.n_downsampling
        self.bottlenec = _bottleneck(base_nc, 9, norm_factory, use_bias, nd, opt.dropout)
        self.dec = _decoder(base_nc, opt.output_nc_depth, norm_factory, use_bias,
                            UP_LAYERS[opt.upsampling_type], nd)

    def forward(self, x):
        return self.dec(self.bottlenec(x))


def define_Gen(opt, input_type, out_type="depth", generator=None) -> nn.Module:
    """Mirror of define_Gen (translation_networks.py:315-324): ``GeneratorI_F``
    for ("img", "feature"), ``GeneratorF_D`` for ("feature", "depth"), else
    the ``img_depth`` or ``depth`` translator; built on the CPU with the
    lineage's init (InitCfg with ``gain_from_nonlinearity``, relu: "normal"
    draws N(0, 0.02), xavier and orthogonal take the gain sqrt(2),
    translation_networks.py:227-228), each ``Dropout`` named by its
    ``state_dict`` prefix. ``generator`` seeds the init (a fresh one seeded
    0 when None)."""
    use_bias = opt.norm == "instance"
    if (input_type, out_type) == ("img", "feature"):
        net = GeneratorI_F(opt, use_bias)
    elif (input_type, out_type) == ("feature", "depth"):
        net = GeneratorF_D(opt, use_bias)
    else:
        net = TranslationGenerator(opt, input_type, use_bias)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return name_dropouts(init_weights(net, opt.init_type, 0.02, generator,
                                      gain=calculate_gain("relu")))


class GuDiscriminator(nn.Module):
    """DepthDiscriminator "Gu" (translation_networks.py:345-357): eight 3x3
    conv + BatchNorm + LeakyReLU stages, then a 3x3 conv to one logit; keys
    under ``model.``.

    Under a ``spatial`` tag its 3x3 convs (stride 1 or 2, padding 1) run on
    the rank's band while the group splits their output
    (``Spatial.sharded``); before the first conv whose output it does not
    split (16 global rows at a 256 crop over two ranks), the input is
    gathered along H and the rest runs whole (``bands_then_whole``), so
    every rank returns the whole logits. Its BatchNorms take their moments
    over the step's group on bands and over the ranks that split the batch
    at the whole levels (``layers.BatchNorm2d``)."""

    spatial = None

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
        sp = S.active(self.spatial)
        if sp is None:
            return self.model(x)
        return bands_then_whole(self.model, x, sp, lambda conv, h: (
            h % conv.stride[0] == 0 and sp.sharded(h * sp.size // conv.stride[0])))


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
