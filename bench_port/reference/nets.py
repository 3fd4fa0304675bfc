"""Plain PyTorch nets of the stage-3 pipeline, the benchmark's own frozen copy.

Every layer is a stock ``torch.nn`` layer. The module trees are built in the
order the published pix2pix and translation generators build them, so the
``state_dict`` keys are those of the published nets (``model.10.conv_block.1
.weight``, ``model.model.1.model.0.weight``, ``bottlenec.model.0.conv_block
.0.weight``, ...), and the benchmark loads one set of seeded weights into
this copy and into the program under test alike.

``set_precision(net, "fp8")`` holds every convolution's operands and every
layer's output in float8 (e4m3 values, e5m2 cotangents, one scale a tensor)
around float32 arithmetic: the reference computed a precision below the
bfloat16 the configurations state, the benchmark's control.
``"fp8_operands"`` rounds only the convolutions' operands, as a program that
moved its convolutions to float8 inputs would. ``"f32"`` (the default) leaves
it exact; the caller turns TF32 off.

Each 3x3 convolution inside a ResNet block carries ``k1 = True``: those are
the convolutions the program under test runs on its hand-written 3x3 kernel,
and the work counts (``work.py``) read their shapes.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

FP8_E4M3_MAX, FP8_E5M2_MAX = 448.0, 57344.0


def _round(x, dtype, top):
    """x rounded to ``dtype`` with one scale for the tensor (its absolute
    maximum maps to ``top``), in x's dtype."""
    scale = top / x.abs().amax().float().clamp(min=1e-30)
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class Fp8(torch.autograd.Function):
    """float8 as FP8 training keeps tensors: the value rounded to e4m3 in the
    forward, the cotangent to e5m2 in the backward."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, FP8_E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, FP8_E5M2_MAX)


def fp8_round(x):
    return Fp8.apply(x)


class Conv2d(nn.Conv2d):
    quant = None
    k1 = False

    def forward(self, x):
        w = self.weight
        if self.quant is not None:
            x, w = self.quant(x), self.quant(w)
        return self._conv_forward(x, w, self.bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    quant = None

    def forward(self, x):
        w = self.weight
        if self.quant is not None:
            x, w = self.quant(x), self.quant(w)
        return F.conv_transpose2d(x, w, self.bias, self.stride, self.padding,
                                  self.output_padding, self.groups, self.dilation)


def _round_output(module, args, out):
    return fp8_round(out)


def set_precision(net, precision):
    """"f32": exact float32; "fp8": every convolution's operands and every
    layer's output held in float8 (``Fp8``), the arithmetic in float32, as
    the program holds them in bfloat16; "fp8_operands": the convolutions'
    operands alone."""
    if precision not in ("f32", "fp8", "fp8_operands"):
        raise ValueError(precision)
    for m in net.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d)):
            m.quant = None if precision == "f32" else fp8_round
        if precision == "fp8" and not list(m.children()):
            m.register_forward_hook(_round_output)
    return net


class Wrapped(nn.Module):
    """One module published under the key ``model``."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, x):
        return self.model(x)


# -- zoo A: the pix2pix generators (instance norm, biased convs) -------------

class ResnetBlock(nn.Module):
    def __init__(self, dim):
        super().__init__()
        blocks = []
        for half in range(2):
            conv = Conv2d(dim, dim, 3, bias=True)
            conv.k1 = True
            blocks += [nn.ReflectionPad2d(1), conv, nn.InstanceNorm2d(dim)]
            if half == 0:
                blocks.append(nn.ReLU())
        self.conv_block = nn.Sequential(*blocks)

    def forward(self, x):
        return x + self.conv_block(x)


def resnet_generator(input_nc, output_nc, ngf, n_blocks, n_down=2):
    model = [nn.ReflectionPad2d(3), Conv2d(input_nc, ngf, 7), nn.InstanceNorm2d(ngf), nn.ReLU()]
    for i in range(n_down):
        m = 2 ** i
        model += [Conv2d(ngf * m, ngf * m * 2, 3, stride=2, padding=1),
                  nn.InstanceNorm2d(ngf * m * 2), nn.ReLU()]
    m = 2 ** n_down
    model += [ResnetBlock(ngf * m) for _ in range(n_blocks)]
    for i in range(n_down):
        m = 2 ** (n_down - i)
        model += [ConvTranspose2d(ngf * m, ngf * m // 2, 3, stride=2, padding=1,
                                  output_padding=1),
                  nn.InstanceNorm2d(ngf * m // 2), nn.ReLU()]
    model += [nn.ReflectionPad2d(3), Conv2d(ngf, output_nc, 7), nn.Tanh()]
    return Wrapped(nn.Sequential(*model))


class UnetLevel(nn.Module):
    def __init__(self, outer_nc, inner_nc, input_nc=None, submodule=None,
                 outermost=False, innermost=False):
        super().__init__()
        input_nc = outer_nc if input_nc is None else input_nc
        self.outermost = outermost
        down = Conv2d(input_nc, inner_nc, 4, stride=2, padding=1)
        if outermost:
            model = [down, submodule, nn.ReLU(),
                     ConvTranspose2d(inner_nc * 2, outer_nc, 4, stride=2, padding=1), nn.Tanh()]
        elif innermost:
            model = [nn.LeakyReLU(0.2), down, nn.ReLU(),
                     ConvTranspose2d(inner_nc, outer_nc, 4, stride=2, padding=1),
                     nn.InstanceNorm2d(outer_nc)]
        else:
            model = [nn.LeakyReLU(0.2), down, nn.InstanceNorm2d(inner_nc), submodule, nn.ReLU(),
                     ConvTranspose2d(inner_nc * 2, outer_nc, 4, stride=2, padding=1),
                     nn.InstanceNorm2d(outer_nc)]
        self.model = nn.Sequential(*model)

    def forward(self, x):
        out = self.model(x)
        return out if self.outermost else torch.cat([x, out], 1)


def unet_generator(input_nc, output_nc, num_downs, ngf):
    block = UnetLevel(ngf * 8, ngf * 8, innermost=True)
    for _ in range(num_downs - 5):
        block = UnetLevel(ngf * 8, ngf * 8, submodule=block)
    block = UnetLevel(ngf * 4, ngf * 8, submodule=block)
    block = UnetLevel(ngf * 2, ngf * 4, submodule=block)
    block = UnetLevel(ngf, ngf * 2, submodule=block)
    return Wrapped(UnetLevel(output_nc, ngf, input_nc=input_nc, submodule=block, outermost=True))


def generator(kind, input_nc, output_nc, ngf, n_down=2):
    """``resnet_6blocks``, ``resnet_9blocks``, ``unet_128`` or ``unet_256``."""
    if kind in ("resnet_6blocks", "resnet_9blocks"):
        return resnet_generator(input_nc, output_nc, ngf, 6 if kind == "resnet_6blocks" else 9,
                                n_down)
    if kind in ("unet_128", "unet_256"):
        return unet_generator(input_nc, output_nc, 7 if kind == "unet_128" else 8, ngf)
    raise ValueError(f"generator kind {kind}")


# -- zoo B: the frozen depth translator (group norm, unbiased convs) ---------

def _part(layers):
    return Wrapped(nn.Sequential(*layers))


class ResnetBlockT(nn.Module):
    def __init__(self, dim):
        super().__init__()
        c1 = Conv2d(dim, dim, 3, padding=1, padding_mode="replicate", bias=False)
        c2 = Conv2d(dim, dim, 3, padding=1, padding_mode="replicate", bias=False)
        c1.k1 = c2.k1 = True
        self.conv_block = nn.Sequential(c1, nn.GroupNorm(8, dim), nn.ReLU(),
                                        c2, nn.GroupNorm(8, dim))

    def forward(self, x):
        return x + self.conv_block(x)


class TransposeUp(nn.Module):
    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.transposeconv = ConvTranspose2d(in_ch, out_ch, 4, stride=2, padding=1, bias=False)

    def forward(self, x):
        return self.transposeconv(x)


def _encoder(input_nc, base, n_down):
    layers = [Conv2d(input_nc, base, 7, padding=3, padding_mode="replicate", bias=False),
              nn.GroupNorm(8, base), nn.ReLU()]
    for i in range(n_down):
        m = 2 ** i
        layers += [Conv2d(base * m, base * m * 2, 4, stride=2, padding=1,
                          padding_mode="replicate", bias=False),
                   nn.GroupNorm(8, base * m * 2), nn.ReLU()]
    return _part(layers)


class Translator(nn.Module):
    """The image-guided depth translator G_A_d: depth and image encoders,
    concatenated [depth, image], a ResNet bottleneck, the depth decoder."""

    def __init__(self, ngf_img=32, ngf_depth=32, n_blocks=9, n_down=2):
        super().__init__()
        base = ngf_img + ngf_depth
        self.enc_img = _encoder(3, ngf_img, n_down)
        self.enc_depth = _encoder(1, ngf_depth, n_down)
        dim = base * 2 ** n_down
        self.bottlenec = _part([ResnetBlockT(dim) for _ in range(n_blocks)])
        layers = []
        for i in range(n_down):
            m = 2 ** (n_down - i)
            layers += [TransposeUp(base * m, base * m // 2), nn.GroupNorm(8, base * m // 2),
                       nn.ReLU()]
        layers += [Conv2d(base, 1, 7, padding=3, padding_mode="replicate", bias=True), nn.Tanh()]
        self.dec_depth = _part(layers)

    def forward(self, depth, img):
        x = torch.cat([self.enc_depth(depth), self.enc_img(img)], dim=1)
        return self.dec_depth(self.bottlenec(x))
