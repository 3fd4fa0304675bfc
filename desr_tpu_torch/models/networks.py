"""Net zoo A (pix2pix lineage): ResNet and U-Net generators, the U-Net with
its SR head, and the PatchGAN / pixel discriminators (counterpart of
``desr_tpu/models/networks.py``).

Attribute names reproduce the JAX ``Net.init`` keys exactly: ``model.N.…`` for
the ResNet generator and the PatchGAN, ``model.N.conv_block.M.…`` inside the
ResNet's blocks, the nested ``model.model.1.model.…`` of the U-Net and
``net.N.…`` for the pixel discriminator. So a JAX param dict (or a reference
``.pth``) loads with ``load_state_dict(strict=True)``.

``--norm batch`` and ``--norm none`` build BatchNorm or no norm: their
ResnetBlocks take the unfused route (cuDNN's convs, or K2 under
``--pallas_conv``), as K1 fuses only instance and group moments
(layers.py:289-300). Each composite (generator, ResnetBlock, U-Net level)
reads its ``remat`` mode (``layers.set_remat``).

Under ``--spatial_devices`` (``layers.set_spatial_group``) each rank runs
the nets on its band of the frame's rows: the ResnetBlocks' K1 / K2 launches
read one halo row from each neighbour and the norms' moments are the
frame's; each U-Net level is split or whole by its global H (JAX's
``spatial_anchor``, networks.py:187-207): the first whole level gathers its
input and its output goes back to the rank's rows. The PatchGAN runs its
stride-2 convs on bands and gathers before its stride-1 tail, whose logits
(H/8 - 1 rows) every rank then holds whole. The backward of each comes
through the adjoints of the exchanges, of K1's halo rows and of the gathers.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from desr_tpu_torch.models.layers import (
    BatchNorm2d,
    Conv2d,
    ConvTranspose2d,
    Dropout,
    GroupNorm,
    InstanceNorm2d,
    LeakyReLU,
    ReflectionPad2d,
    ReLU,
    ReplicationPad2d,
    SpectralNormConv2d,
    Tanh,
    Upsample,
    frame_moments,
    get_norm_layer,
    norm_vectors,
    remat_call,
    run_layers,
)
from desr_tpu_torch.ops import conv3x3 as K
from desr_tpu_torch.parallel import spatial as S

_PAD_MODE = {"reflect": "reflect", "replicate": "replicate", "zero": "zeros"}


def fused_resnet_chain(x, convs, norms, pad_mode, spatial=None):
    """x + norm2(conv2(relu(norm1(conv1(x))))) as the fused chain of
    ``Sequential._run_fused_chain`` (layers.py:271-337), NCHW in and out.

    conv1 emits its output's moments, ``norm_vectors`` folds conv1's bias and
    the norm (InstanceNorm, or GroupNorm with its affine) into per-(b, c)
    scale/shift, conv2 applies them (+ReLU) as it loads its input and emits
    its own moments, and the last norm is one multiply-add before the skip.
    Both convs are ``conv3x3_fused``: the kernel on the card, its plain
    version on the CPU; differentiable either way.

    Under an active ``spatial`` the rank's band of x, then of conv1's raw
    output, takes one halo row from each neighbour (K1's ``halo_top`` /
    ``halo_bottom``; the prologue normalises the halo rows as its own), and
    each conv's (s, s2) are summed over the ranks in one all_reduce, with n
    the frame's pixel count.
    """
    x = x.contiguous(memory_format=torch.channels_last)
    xh = x.permute(0, 2, 3, 1)  # NHWC view, contiguous
    (c1, c2), (n1, n2) = convs, norms
    sp = S.active(spatial)
    n = xh.shape[1] * xh.shape[2]

    def conv(v, w, *prologue):
        ht = hb = 0
        if sp is not None:
            v, ht, hb = S.exchange_rows(v, 1, 1, sp, dim=1)
        out, s, s2 = K.conv3x3_fused(v, w, *prologue, stats=True, halo_top=ht, halo_bottom=hb)
        return (out, *frame_moments(s, s2, n, sp))

    y, s, s2, n_all = conv(xh, c1.weight, None, None, pad_mode)
    sc, sh = norm_vectors(n1, s, s2, n_all, c1.bias)
    z, s, s2, n_all = conv(y, c2.weight, sc, sh, pad_mode, True)
    sc, sh = norm_vectors(n2, s, s2, n_all, c2.bias)
    out = xh + (z.float() * sc[:, None, None, :] + sh[:, None, None, :]).to(x.dtype)
    return out.permute(0, 3, 1, 2)


class ResnetBlock(nn.Module):
    """[pad, conv3x3, norm, ReLU, (Dropout), pad, conv3x3, norm] + skip
    (networks.py:69-96); keys under ``conv_block.``.

    Under instance or group norm the forward is ``fused_resnet_chain`` on
    every device. With ``fused=False`` each conv is the ``conv3x3`` kernel
    and the norms run as layers (the JAX ``--pallas_conv`` route); under
    batch or no norm with ``fused`` the block runs its layers, cuDNN's convs.
    Under a remat mode the fused chain is one checkpointed span; the layers'
    runs go through ``run_layers`` (a BatchNorm stays outside). Under a
    ``spatial`` tag K1 and K2 read halo rows (``fused_resnet_chain``).
    """

    remat = None
    spatial = None

    def __init__(self, dim, padding_type, norm_layer, use_dropout, use_bias,
                 fused=True):
        super().__init__()
        if padding_type not in _PAD_MODE:
            raise NotImplementedError(padding_type)
        blocks = []
        for half in range(2):
            p = 0
            if padding_type == "reflect":
                blocks.append(ReflectionPad2d(1))
            elif padding_type == "replicate":
                blocks.append(ReplicationPad2d(1))
            else:
                p = 1
            blocks.append(Conv2d(dim, dim, 3, padding=p, bias=use_bias))
            blocks.append(norm_layer(dim))
            if half == 0:
                blocks.append(ReLU())
                if use_dropout:
                    blocks.append(Dropout(0.5))
        self.conv_block = nn.Sequential(*blocks)
        self.pad_mode = _PAD_MODE[padding_type]
        self.fused = fused
        self.use_dropout = use_dropout
        convs = [m for m in blocks if isinstance(m, Conv2d)]
        # the module after each conv is its norm (Identity under --norm none)
        norms = [blocks[next(i for i, b in enumerate(blocks) if b is c) + 1] for c in convs]
        self._convs, self._norms = convs, norms
        self._fusable = all(isinstance(n, (InstanceNorm2d, GroupNorm)) for n in norms)

    def forward(self, x):
        if self.training and self.use_dropout:
            raise NotImplementedError("ResnetBlock dropout in training: not yet ported")
        if not self.fused:
            x = x.contiguous(memory_format=torch.channels_last)
            (c1, c2), (n1, n2) = self._convs, self._norms
            steps = [self._k2(c1), n1, torch.relu, self._k2(c2), n2]
            return x + run_layers(steps, x, self.remat)
        if self._fusable:
            return remat_call(self._chain, self.remat, x)
        return x + run_layers(self.conv_block, x, self.remat)

    def _chain(self, x):
        return fused_resnet_chain(x, self._convs, self._norms, self.pad_mode, self.spatial)

    def _k2(self, conv):
        """The conv as K2 (``conv3x3``) on an NCHW tensor, bias added; with
        halo rows on a rank's band."""
        def run(x):
            xh = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
            halo = ()
            sp = S.active(self.spatial)
            if sp is not None:
                xh, *halo = S.exchange_rows(xh, 1, 1, sp, dim=1)
            y = K.conv3x3(xh, conv.weight, self.pad_mode, *halo).permute(0, 3, 1, 2)
            return y if conv.bias is None else y + conv.bias.to(y.dtype)[:, None, None]
        return run


class ResnetGenerator(nn.Module):
    """networks.py:99-136 (reference networks.py:353-421), ends in Tanh."""

    remat = None

    def __init__(self, input_nc, output_nc, ngf, norm_layer, use_bias, use_dropout,
                 n_blocks, padding_type="reflect", replace_transpose=False,
                 n_downsampling=2, fused=True):
        super().__init__()
        model = [ReflectionPad2d(3), Conv2d(input_nc, ngf, 7, padding=0, bias=use_bias),
                 norm_layer(ngf), ReLU()]
        for i in range(n_downsampling):
            mult = 2 ** i
            model += [Conv2d(ngf * mult, ngf * mult * 2, 3, stride=2, padding=1, bias=use_bias),
                      norm_layer(ngf * mult * 2), ReLU()]
        mult = 2 ** n_downsampling
        for _ in range(n_blocks):
            model.append(ResnetBlock(ngf * mult, padding_type, norm_layer, use_dropout,
                                     use_bias, fused=fused))
        for i in range(n_downsampling):
            mult = 2 ** (n_downsampling - i)
            if replace_transpose:
                model += [Upsample(scale_factor=2, mode="nearest"), ReflectionPad2d(1),
                          Conv2d(ngf * mult, ngf * mult // 2, 3, stride=1, padding=0),
                          norm_layer(ngf * mult // 2), ReLU()]
            else:
                model += [ConvTranspose2d(ngf * mult, ngf * mult // 2, 3, stride=2, padding=1,
                                          output_padding=1, bias=use_bias),
                          norm_layer(ngf * mult // 2), ReLU()]
        model += [ReflectionPad2d(3), Conv2d(ngf, output_nc, 7, padding=0, bias=True), Tanh()]
        self.model = nn.Sequential(*model)

    def forward(self, x):
        return run_layers(self.model, x, self.remat)


class UnetSkipConnectionBlock(nn.Module):
    """networks.py:139-207 (reference networks.py:516-629).

    With ``sr`` the outermost block carries the SR decoder head
    (networks.py:155-172): two transposed convs, each followed by a
    ResnetBlock, emit twice the input's resolution per axis and one channel.
    As shipped, the norms after those convs are built for ``inner_nc``
    channels while they normalise ``inner_nc // 2`` and ``inner_nc // 4``;
    InstanceNorm without affine does not depend on the width (a BatchNorm's
    affine does: the head refuses ``--norm batch``, whose JAX layer fails
    there too).
    Under a remat mode the level's spans before and after its submodule are
    checkpointed apart (``run_layers``; layers.py:422-460). Under a
    ``spatial`` tag a level whose global H the ranks do not split
    (``Spatial.sharded``) gathers its input, runs whole (its inner levels
    too) and returns the rank's rows of its output.
    """

    remat = None
    spatial = None

    def __init__(self, outer_nc, inner_nc, input_nc=None, submodule=None,
                 outermost=False, innermost=False, norm_layer=InstanceNorm2d,
                 use_bias=True, use_dropout=False, sr=False, fused=True):
        super().__init__()
        if input_nc is None:
            input_nc = outer_nc
        self.outermost = outermost
        downconv = Conv2d(input_nc, inner_nc, 4, stride=2, padding=1, bias=use_bias)
        if outermost and sr:
            if norm_layer is BatchNorm2d:
                raise NotImplementedError(
                    "the U-Net SR head under --norm batch: its norms are built for inner_nc "
                    "channels and applied to inner_nc // 2 (the JAX layer fails there too)")
            model = [downconv, submodule, ReLU(),
                     ConvTranspose2d(inner_nc * 2, inner_nc // 2, 4, stride=2, padding=1, bias=True),
                     norm_layer(inner_nc),
                     ResnetBlock(inner_nc // 2, "reflect", norm_layer, use_dropout, use_bias,
                                 fused=fused),
                     ReLU(),
                     ConvTranspose2d(inner_nc // 2, inner_nc // 4, 4, stride=2, padding=1,
                                     bias=True),
                     norm_layer(inner_nc),
                     ResnetBlock(inner_nc // 4, "reflect", norm_layer, use_dropout, use_bias,
                                 fused=fused),
                     ReLU(), Conv2d(inner_nc // 4, 1, 3, padding=1, bias=True), Tanh()]
        elif outermost:
            upconv = ConvTranspose2d(inner_nc * 2, outer_nc, 4, stride=2, padding=1, bias=True)
            model = [downconv, submodule, ReLU(), upconv, Tanh()]
        elif innermost:
            upconv = ConvTranspose2d(inner_nc, outer_nc, 4, stride=2, padding=1, bias=use_bias)
            model = [LeakyReLU(0.2), downconv, ReLU(), upconv, norm_layer(outer_nc)]
        else:
            upconv = ConvTranspose2d(inner_nc * 2, outer_nc, 4, stride=2, padding=1,
                                     bias=use_bias)
            model = [LeakyReLU(0.2), downconv, norm_layer(inner_nc), submodule, ReLU(),
                     upconv, norm_layer(outer_nc)]
            if use_dropout:
                model.append(Dropout(0.5))
        self.model = nn.Sequential(*model)

    def forward(self, x):
        sp = S.active(self.spatial)
        if sp is not None and not sp.sharded(x.shape[2] * sp.size):
            with S.whole():
                out = self._level(S.gather_h(x, sp))
            return S.take_h(out, sp)
        return self._level(x)

    def _level(self, x):
        out = run_layers(self.model, x, self.remat)
        if self.outermost:
            return out
        return torch.cat([x, out], 1)


class UnetGenerator(nn.Module):
    """networks.py:210-221: ``num_downs`` halvings, innermost first; ``use_sr``
    puts the SR head on the outermost block."""

    def __init__(self, input_nc, output_nc, num_downs, ngf, norm_layer, use_bias,
                 use_dropout=False, use_sr=False, fused=True):
        super().__init__()
        kw = dict(norm_layer=norm_layer, use_bias=use_bias)
        block = UnetSkipConnectionBlock(ngf * 8, ngf * 8, innermost=True, **kw)
        for _ in range(num_downs - 5):
            block = UnetSkipConnectionBlock(ngf * 8, ngf * 8, submodule=block,
                                            use_dropout=use_dropout, **kw)
        block = UnetSkipConnectionBlock(ngf * 4, ngf * 8, submodule=block, **kw)
        block = UnetSkipConnectionBlock(ngf * 2, ngf * 4, submodule=block, **kw)
        block = UnetSkipConnectionBlock(ngf, ngf * 2, submodule=block, **kw)
        self.model = UnetSkipConnectionBlock(output_nc, ngf, input_nc=input_nc,
                                             submodule=block, outermost=True,
                                             use_dropout=use_dropout, sr=use_sr, fused=fused,
                                             **kw)

    def forward(self, x):
        return self.model(x)


class NLayerDiscriminator(nn.Module):
    """PatchGAN with ``n_layers`` stride-2 convs (networks.py:249-268), keys
    under ``model.``; returns one logit per patch, (B, 1, h, w). The
    translation lineage builds it with its own norm and bias rule and, under
    --use_spnorm, ``conv_cls`` = SpectralNormConv2d (translation_networks.py:325).

    Under a ``spatial`` tag the stride-2 convs run on the rank's band while
    the group splits their input (``Spatial.sharded``, an even band); the
    first conv that does not (at the latest the 4x4 stride-1 conv, whose
    output has one row fewer than its input) gathers its input along H, and
    it and every layer after it run whole (``spatial.whole()``): every rank
    returns the whole logits, of which a mean (``gan_loss``) is then one
    that every rank of a data group computes alike."""

    spatial = None

    def __init__(self, input_nc, ndf, n_layers, norm_layer, use_bias, conv_cls=Conv2d):
        super().__init__()
        seq = [conv_cls(input_nc, ndf, 4, stride=2, padding=1, bias=True), LeakyReLU(0.2)]
        nf_mult = 1
        for n in range(1, n_layers):
            nf_mult_prev, nf_mult = nf_mult, min(2 ** n, 8)
            seq += [conv_cls(ndf * nf_mult_prev, ndf * nf_mult, 4, stride=2, padding=1,
                             bias=use_bias),
                    norm_layer(ndf * nf_mult), LeakyReLU(0.2)]
        nf_mult_prev, nf_mult = nf_mult, min(2 ** n_layers, 8)
        seq += [conv_cls(ndf * nf_mult_prev, ndf * nf_mult, 4, stride=1, padding=1,
                         bias=use_bias),
                norm_layer(ndf * nf_mult), LeakyReLU(0.2),
                conv_cls(ndf * nf_mult, 1, 4, stride=1, padding=1, bias=True)]
        self.model = nn.Sequential(*seq)

    def forward(self, x):
        sp = S.active(self.spatial)
        if sp is None:
            return self.model(x)
        for i, layer in enumerate(self.model):
            h = x.shape[2]
            if isinstance(layer, Conv2d) and (layer.stride[0] == 1 or h % 2
                                              or not sp.sharded(h * sp.size)):
                with S.whole():
                    return self.model[i:](S.gather_h(x, sp))
            x = layer(x)
        return x


class PixelDiscriminator(nn.Module):
    """1x1-conv pixel GAN (networks.py:271-280), keys under ``net.``."""

    def __init__(self, input_nc, ndf, norm_layer, use_bias):
        super().__init__()
        self.net = nn.Sequential(
            Conv2d(input_nc, ndf, 1, bias=True), LeakyReLU(0.2),
            Conv2d(ndf, ndf * 2, 1, bias=use_bias), norm_layer(ndf * 2), LeakyReLU(0.2),
            Conv2d(ndf * 2, 1, 1, bias=use_bias))

    def forward(self, x):
        return self.net(x)


INIT_TYPES = ("normal", "xavier", "kaiming", "orthogonal")


def calculate_gain(nonlinearity, param=None):
    """torch.nn.init.calculate_gain for the nonlinearities the nets use
    (layers.py:134-145)."""
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        neg = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + neg ** 2))
    if nonlinearity in ("linear", "conv2d", "sigmoid"):
        return 1.0
    if nonlinearity == "tanh":
        return 5.0 / 3
    raise ValueError(nonlinearity)


def init_weight_(w, init_type, init_gain, gain, generator):
    """Draw a conv weight (OIHW, or IOHW for a transposed conv) in place, as
    ``init_weight`` does (layers.py:170-201): "normal" N(0, init_gain);
    "xavier" N(0, gain sqrt(2 / (fan_in + fan_out))); "kaiming"
    N(0, sqrt(2 / fan_in)); "orthogonal" the Q of a QR of an N(0, 1) draw,
    columns signed by R's diagonal, times ``gain``. Fans are torch's: dim 1
    times the kernel's size in, dim 0 times it out. Normal draws, as the JAX
    package makes them (torch's own xavier and kaiming draw uniform)."""
    shape = tuple(w.shape)
    receptive = math.prod(shape[2:])
    fan_in, fan_out = shape[1] * receptive, shape[0] * receptive
    if init_type == "normal":
        w.normal_(0.0, init_gain, generator=generator)
    elif init_type == "xavier":
        w.normal_(0.0, gain * math.sqrt(2.0 / (fan_in + fan_out)), generator=generator)
    elif init_type == "kaiming":
        w.normal_(0.0, math.sqrt(2.0) / math.sqrt(fan_in), generator=generator)
    elif init_type == "orthogonal":
        rows, cols = shape[0], math.prod(shape[1:])
        flat = torch.randn((max(rows, cols), min(rows, cols)), generator=generator)
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))[None, :]
        if rows < cols:
            q = q.T
        w.copy_((gain * q[:rows, :cols]).reshape(shape))
    else:
        raise NotImplementedError(f"initialization method [{init_type}] is not implemented")


@torch.no_grad()
def init_weights(net, init_type="normal", init_gain=0.02, generator=None, gain=None):
    """Conv/convT weights by ``init_weight_``, biases 0 (layers.py:170-196);
    BatchNorm weights ~ N(1, init_gain) and affine GroupNorm weights
    ~ N(1, 0.02), biases 0 (:1213-1220, :1269-1276); a spectral-norm conv's
    u and v converged for its weight (:1439-1461).

    ``gain`` (xavier, orthogonal) is ``init_gain`` in the pix2pix lineage;
    the translation lineage passes ``calculate_gain`` of its nonlinearity
    (``InitCfg(gain_from_nonlinearity=True)``), with init_gain 0.02.
    """
    gain = init_gain if gain is None else gain
    for m in net.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d)):
            init_weight_(m.weight, init_type, init_gain, gain, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, SpectralNormConv2d):
            init_weight_(m.weight_orig, init_type, init_gain, gain, generator)
            if m.bias is not None:
                m.bias.zero_()
            m.reset_uv(generator)
        elif isinstance(m, BatchNorm2d):
            m.weight.normal_(1.0, init_gain, generator=generator)
            m.bias.zero_()
        elif isinstance(m, GroupNorm) and m.affine:
            m.weight.normal_(1.0, 0.02, generator=generator)
            m.bias.zero_()
    return net


def define_G(input_nc, output_nc, ngf, netG, norm="instance", use_dropout=False,
             init_type="normal", init_gain=0.02, replace_transpose=False, n_down=2,
             use_sr=False, use_old=False, generator=None, fused=True) -> nn.Module:
    """Mirror of define_G (networks.py:224-246), built on the CPU.

    ``generator`` seeds the weight init (a fresh one seeded 0 when None).
    ``fused`` picks the ResnetBlock route (see ResnetBlock). ``use_sr`` (the
    U-Net SR head) is a capability of the zoo that no model of either package
    reaches: ``MainSRModel``'s Task is the plain U-Net on the HR grid.
    """
    if use_old and norm == "group":
        raise NotImplementedError("use_old GroupNorm(1): not yet ported")
    norm_layer, use_bias = get_norm_layer(norm)
    if netG in ("resnet_9blocks", "resnet_6blocks"):
        n_blocks = 9 if netG == "resnet_9blocks" else 6
        net = ResnetGenerator(input_nc, output_nc, ngf, norm_layer, use_bias, use_dropout,
                              n_blocks, "reflect", replace_transpose, n_down, fused=fused)
    elif netG in ("unet_128", "unet_256"):
        num_downs = 7 if netG == "unet_128" else 8
        net = UnetGenerator(input_nc, output_nc, num_downs, ngf, norm_layer, use_bias,
                            use_dropout, use_sr, fused)
    else:
        raise NotImplementedError(f"Generator model name [{netG}] is not recognized")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return init_weights(net, init_type, init_gain, generator)


def define_D(input_nc, ndf, netD, n_layers_D=3, norm="instance", init_type="normal",
             init_gain=0.02, generator=None) -> nn.Module:
    """Mirror of define_D (networks.py:283-294), built on the CPU: ``basic``
    (a 3-layer PatchGAN), ``n_layers`` (``n_layers_D`` of them) or ``pixel``.
    ``generator`` seeds the weight init (a fresh one seeded 0 when None)."""
    norm_layer, use_bias = get_norm_layer(norm)
    if netD in ("basic", "n_layers"):
        net = NLayerDiscriminator(input_nc, ndf, 3 if netD == "basic" else n_layers_D,
                                  norm_layer, use_bias)
    elif netD == "pixel":
        net = PixelDiscriminator(input_nc, ndf, norm_layer, use_bias)
    else:
        raise NotImplementedError(f"Discriminator model name [{netD}] is not recognized")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return init_weights(net, init_type, init_gain, generator)
