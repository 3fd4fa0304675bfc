"""The rank side of the port's spatial-mesh tests (tests/test_torch_spatial*.py):
functions that ``desr_tpu_torch.parallel.launch`` runs in each spawned rank
of a ``--spatial_devices`` mesh, and that the tests also call in one process
on whole frames. This module imports torch and the port alone, so that a
spawned rank starts quickly; it holds no tests.

Every function returns host values (numpy arrays, ints).
"""

from unittest import mock

import numpy as np
import torch

from desr_tpu_torch.models import layers as TL
from desr_tpu_torch.models import networks as TN
from desr_tpu_torch.models import translation_networks as TT
from desr_tpu_torch.ops import resize as RS
from desr_tpu_torch.parallel import spatial as S

_DEFAULT_TRANSLATOR = TT.default_translator_opt
FRAME = (2, 8, 64, 20)  # NCHW: two frames of 64x20, 8 channels


def small_translator(**kw):
    """The hardcoded translator cut to 8+8 channels and one block."""
    return _DEFAULT_TRANSLATOR(**dict(dict(ngf_img=8, ngf_depth=8, n_blocks=1), **kw))


def _seeded(module, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=gen))
    return module.eval()


def _layers():
    """{name: (module, input channels)}: every (k, stride, padding, pad mode)
    of a conv, transposed conv, pad and upsample that the serving nets run,
    the norms, the three ResnetBlock routes, and a U-Net of 7 levels whose
    four deep levels two ranks do not split at 128 rows."""
    c = FRAME[1]
    in_norm = TL.InstanceNorm2d
    return {
        "reflect7": (torch.nn.Sequential(TL.ReflectionPad2d(3), TL.Conv2d(c, 4, 7)), c),
        "replicate7": (TL.Conv2d(c, 4, 7, padding=3, padding_mode="replicate"), c),
        "conv3_zeros": (TL.Conv2d(c, 4, 3, padding=1), c),
        "conv3_replicate": (TL.Conv2d(c, 4, 3, padding=1, padding_mode="replicate"), c),
        "conv3_s2": (TL.Conv2d(c, 4, 3, stride=2, padding=1), c),
        "conv4_s2": (TL.Conv2d(c, 4, 4, stride=2, padding=1), c),
        "conv4_s2_replicate": (TL.Conv2d(c, 4, 4, stride=2, padding=1,
                                         padding_mode="replicate"), c),
        "conv1": (TL.Conv2d(c, 4, 1), c),
        "convt4_s2": (TL.ConvTranspose2d(c, 4, 4, stride=2, padding=1), c),
        "convt3_s2": (TL.ConvTranspose2d(c, 4, 3, stride=2, padding=1, output_padding=1), c),
        "upsample_reflect_conv": (torch.nn.Sequential(
            TL.Upsample(scale_factor=2, mode="nearest"), TL.ReflectionPad2d(1),
            TL.Conv2d(c, 4, 3)), c),
        "replicate_pad": (TL.ReplicationPad2d(2), c),
        "upconv": (TT.UpConv(c, 4, True), c),
        "uptranspose": (TT.UpTranspose(c, 4, True), c),
        "transpose_up": (TT.TransposeUp(c, 4, True), c),
        "instance_norm": (in_norm(c), c),
        "group_norm": (TL.GroupNorm(4, c), c),
        "resnet_block": (TN.ResnetBlock(c, "reflect", in_norm, False, True), c),
        "resnet_block_k2": (TN.ResnetBlock(c, "replicate", in_norm, False, True, fused=False), c),
        "resnet_block_zero": (TN.ResnetBlock(c, "zero", in_norm, False, True), c),
        "resnet_block_t": (TT.ResnetBlockT(c, lambda ch: TL.GroupNorm(4, ch), False), c),
        "resnet_generator": (TN.define_G(c, 2, 4, "resnet_6blocks"), c),
        "unet": (TN.define_G(c, 2, 4, "unet_128"), c),
    }


def layer_inputs(seed=0):
    """(frame, U-Net frame): NCHW float32 inputs made from ``seed``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(FRAME).astype(np.float32)
    u = rng.standard_normal((1, FRAME[1], 128, 128)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(u)


RESIZES = {  # name: (function, global output H, W)
    "bicubic_down": (RS.resize_bicubic_planar, 32, 12),
    "bicubic_up": (RS.resize_bicubic_planar, 128, 40),
    "nearest_down": (RS.resize_nearest_planar, 32, 10),
    "nearest_up": (RS.resize_nearest_planar, 128, 20),
}


def run_layers(spatial=None):
    """Each layer's output and each resize's, on the whole frame (``spatial``
    None) or on this rank's band of it (a ``Spatial``): {name: array}, and
    the collectives issued."""
    x, u = layer_inputs()
    out = {}
    S.reset_counts()
    with torch.no_grad():
        for i, (name, (module, _)) in enumerate(_layers().items()):
            module = S.set_spatial_group(_seeded(module, i), spatial)
            v = u if name == "unet" else x
            if spatial is not None:
                v = S.take_h(v, spatial)
            out[name] = module(v).numpy()
        for name, (fn, oh, ow) in RESIZES.items():
            v = x if spatial is None else S.take_h(x, spatial)
            out[name] = fn(v, (oh, ow), spatial).numpy()
            v3 = v[:, 0]  # planar (B, H, W) too
            out[name + "_planar"] = fn(v3, (oh, ow), spatial).numpy()
    return out, dict(S.COUNTS)


def spatial_layers(mesh):
    """``run_layers`` on this rank's band (the launch's ranks form one
    spatial group)."""
    return run_layers(S.from_mesh(mesh))


def serve_models(mesh, params, batches):
    """The four serving modes' forwards at small widths on this rank (one
    process when ``mesh`` is a single device), from the JAX params
    ``params[mode]`` ({net: {key: array}}): {mode: this rank's rows of the
    prediction}, and the K1 launches, halo launches among them, and
    collectives."""
    from desr_tpu_torch.models.i2d_model import I2DModel
    from desr_tpu_torch.models.main_model import MainModel, NetOptions
    from desr_tpu_torch.models.main_sr_model import MainSRModel
    from desr_tpu_torch.models.translation_model import TranslationModel
    from desr_tpu_torch.ops import conv3x3 as K
    from desr_tpu_torch.weights import from_jax_params

    small = dict(ImageDepthf_outf=8, ImageDepthf_basef=8, Depthf_outf=8, Depthf_basef=8,
                 I2D_base=8, Task_basef=8, Imagef_outf=8, Imagef_basef=8)
    kw = dict(device="cpu", compute_dtype=torch.float32, mesh=mesh)
    out, counts = {}, {}
    with mock.patch.object(TT, "default_translator_opt", small_translator):
        models = {
            "main": MainModel(NetOptions(**small), **kw),
            "sr": MainSRModel(NetOptions(**small, crop_size_h=128, crop_size_w=128), **kw),
            "i2d": I2DModel(NetOptions(**small), **kw),
            "translate": TranslationModel(NetOptions(**small), direction="AtoB", **kw),
        }
    calls = {"K1": 0, "K1_halo": 0}
    plain = K._fused_forward

    def count(*args):  # K1's calls (its plain version on the CPU); halo rows after 7
        calls["K1"] += 1
        calls["K1_halo"] += len(args) > 7
        return plain(*args)

    for mode, model in models.items():
        for name, p in params[mode].items():
            if name in model.nets:
                model.nets[name].load_state_dict(from_jax_params(p), strict=True)
        calls.update(K1=0, K1_halo=0)
        S.reset_counts()
        with mock.patch.object(K, "_fused_forward", count):
            out[mode] = model.serve_forward(batches[mode]).numpy()
        counts[mode] = dict(S.COUNTS, **calls)
    return out, counts
