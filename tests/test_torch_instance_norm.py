"""K4, InstanceNorm's moments and its normalisation (``ops/instance_norm.py``),
on the CPU: the plain versions against the layers' arithmetic as it was
before K4, the routing (which calls take the ``desr::`` operators), the
operators' registration, and the kernels' launch plans walked index by
index. The kernels themselves run on the card (``tests/test_torch_cuda.py``).
"""

import collections

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from desr_tpu_torch.models import layers as TL
from desr_tpu_torch.models.main_model import MainModel, NetOptions
from desr_tpu_torch.ops import instance_norm as IN
from desr_tpu_torch.options import train_options

torch.set_num_threads(2)

SMALL = dict(ImageDepthf_outf=8, ImageDepthf_basef=8, Depthf_outf=8, Depthf_basef=8,
             I2D_base=8, Task_basef=8)
K4_OPS = ("desr.instance_norm_moments.default", "desr.norm_apply.default")


class OpSpy(TorchDispatchMode):
    """Counts every operator called below autograd, by name; ``active``
    (when set) says whether a call counts."""

    def __init__(self, active=None):
        super().__init__()
        self.counts = collections.Counter()
        self.active = active

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.active is None or self.active():
            self.counts[str(func)] += 1
        return func(*args, **(kwargs or {}))

    def k4(self):
        return tuple(self.counts[k] for k in K4_OPS)


def _x(shape, dtype, layout, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=gen) * 1.7 + 0.4).to(dtype)
    return x.contiguous(memory_format=torch.channels_last) if layout == "channels_last" else x


def _norm_before_k4(x, eps=1e-5):
    """``InstanceNorm2d.forward`` as it was before K4."""
    x32 = x.float()
    s, s2 = x32.sum(dim=(2, 3)), x32.square().sum(dim=(2, 3))
    n = x.shape[2] * x.shape[3]
    mean = s / n
    var = torch.clamp(s2 / n - mean.square(), min=0.0)
    scale = torch.rsqrt(var + eps).to(x.dtype)[:, :, None, None]
    return (x - mean.to(x.dtype)[:, :, None, None]) * scale


def _tail_before_k4(z, sc, sh, skip):
    """``fused_resnet_chain``'s last line as it was before K4, on NHWC views."""
    zh, xh = z.permute(0, 2, 3, 1), skip.permute(0, 2, 3, 1)
    out = xh + (zh.float() * sc[:, None, None, :] + sh[:, None, None, :]).to(z.dtype)
    return out.permute(0, 3, 1, 2)


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.stride() == want.stride()
    assert torch.equal(got, want)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_norm_is_the_layer_before_k4(dtype, layout, relu):
    """The plain moments and apply, the layer on the operators' route (no
    gradient) and on the plain one (a gradient): the layer before K4, then
    ReLU, bit for bit and in x's memory format."""
    x = _x((2, 5, 7, 9), dtype, layout)
    want = _norm_before_k4(x)
    if relu:
        want = torch.nn.ReLU()(want)
    s, s2 = IN.instance_norm_moments_plain(x)
    _same(IN.norm_apply_plain(x, s, s2, 63, 1e-5, relu), want)
    norm = TL.InstanceNorm2d(5)
    with torch.no_grad():
        _same(norm(x, relu=relu), want)
    xg = x.detach().requires_grad_(True)
    got = norm(xg, relu=relu)
    _same(got.detach(), want)
    got.float().sum().backward()
    assert xg.grad is not None


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_affine_apply_is_the_chain_tail_before_k4(dtype, layout, relu, skip):
    """``norm_apply_plain`` from (scale, shift): f32 multiply-add, [ReLU],
    rounded to x's dtype, [+ skip]; with the skip and no ReLU, the chain's
    tail before K4, bit for bit; in x's memory format."""
    z, sk = _x((2, 6, 5, 8), dtype, layout, 1), _x((2, 6, 5, 8), dtype, layout, 2)
    gen = torch.Generator().manual_seed(3)
    sc, sh = torch.rand(2, 6, generator=gen) + 0.5, torch.randn(2, 6, generator=gen)
    v = z.float() * sc[:, :, None, None] + sh[:, :, None, None]
    want = (torch.relu(v) if relu else v).to(dtype)
    if skip:
        want = sk + want
    got = IN.norm_apply_plain(z, sc, sh, None, 0.0, relu, sk if skip else None)
    _same(got, want)
    with torch.no_grad():
        _same(IN.norm_apply(z, sc, sh, relu=relu, skip=sk if skip else None), want)
    if skip and not relu and layout == "channels_last":
        _same(got, _tail_before_k4(z, sc, sh, sk))


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
def test_dense_keeps_the_plain_versions_layout(layout):
    """A band of a transposed conv's output (a view along H) is copied in
    its strides' order, which is the plain version's output layout."""
    x = _x((2, 4, 10, 6), torch.float32, layout)[:, :, 2:7]
    assert not x.is_contiguous() and not x.is_contiguous(memory_format=torch.channels_last)
    d = IN.dense(x)
    _same(d, x.clone())
    _same(IN.norm_apply_plain(d, *IN.instance_norm_moments_plain(d), 30),
          _norm_before_k4(x))
    assert IN.dense(d) is d


def _serving_model():
    return MainModel(NetOptions(**SMALL), device="cpu", generator=torch.Generator().manual_seed(3))


def _serving_batch(b=2, hw=(128, 128)):
    rng = np.random.default_rng(0)
    return {"B_d": rng.uniform(-1, 1, (b, *hw, 1)).astype(np.float32),
            "B_i": rng.uniform(-1, 1, (b, *hw, 3)).astype(np.float32)}


def test_serving_forward_calls_k4_per_norm_and_tail():
    """Under no_grad a ``ServingForward`` call makes 32 moments calls (5 norms
    in each resnet_6blocks net, 11 in each unet_128) and 44 applies (those
    and the 12 ResnetBlock tails); the ReLUs after the resnet nets' norms
    are folded into the applies, and only the U-Nets' 7 ReLUs each, which
    follow no norm, run on their own."""
    model = _serving_model()
    with OpSpy() as spy:
        model.serve_forward(_serving_batch())
    assert spy.k4() == (32, 44)
    assert spy.counts["aten.relu.default"] == 14
    assert spy.counts["desr.conv3x3_fused.default"] == 24


def _train_model(tmp_path):
    argv = ["--model_type", "main", "--use_image_for_trans", "--use_masked", "--norm_loss",
            "--compute_dtype", "float32", "--name", "t", "--checkpoints_dir", str(tmp_path),
            "--batch_size", "2", "--crop_size_h", "128", "--crop_size_w", "128",
            "--device", "cpu"] + [a for k, v in SMALL.items() for a in (f"--{k}", str(v))]
    return MainModel(train_options.parse(argv, print_options=False), device="cpu",
                     compute_dtype=torch.float32, is_train=True)


def _train_batch():
    rng = np.random.default_rng(1)
    b, h, w = 2, 128, 128
    kmat = np.tile(np.array([[[577.0, 0, 320], [0, 577, 240], [0, 0, 1]]], np.float32), (b, 1, 1))
    crop = np.tile(np.array([[0, h, 0, w]], np.float32), (b, 1))
    return {"A_i": rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32),
            "B_i": rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32),
            "A_d": rng.uniform(-1, 1, (b, h, w, 1)).astype(np.float32),
            "B_d": rng.uniform(-1, 1, (b, h, w, 1)).astype(np.float32),
            "K_A": kmat, "K_B": kmat.copy(), "crop_A": crop, "crop_B": crop.copy()}


def test_train_step_trained_nets_take_no_k4(tmp_path):
    """In a main train step the trained ``Depth_f`` and ``Task`` (a gradient
    flows) make no K4 call. The frozen nets run under no_grad: the guidance
    makes its 16 moments calls (5 + 11 norms) and 22 applies (and 6 tails),
    once for its batched 2B call, and the translator ``G_A_d`` 9 applies, its
    ResnetBlockTs' tails (its GroupNorms stay as they are). The step's
    gradients reach the trained nets."""
    model = _train_model(tmp_path)
    inside = []

    def enter(*_):
        inside.append(True)

    def leave(*_):
        inside.pop()

    for name in ("Depth_f", "Task"):
        model.nets[name].register_forward_pre_hook(enter)
        model.nets[name].register_forward_hook(leave)
    model.set_input(_train_batch())
    with OpSpy(active=lambda: bool(inside)) as trained, OpSpy() as every:
        model.compute_grads()
    assert trained.k4() == (0, 0)
    assert sum(trained.counts.values()) > 0
    assert every.k4() == (16, 31)
    for name in ("Depth_f", "Task"):
        assert all(p.grad is not None for p in model.nets[name].parameters())


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moments_op_passes_opcheck(dtype, layout):
    torch.library.opcheck(torch.ops.desr.instance_norm_moments.default,
                          (_x((2, 3, 5, 6), dtype, layout),))


@pytest.mark.parametrize("variant", ["moments", "moments_relu", "affine_skip", "affine_relu"])
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
def test_norm_apply_op_passes_opcheck(layout, variant):
    x = _x((2, 3, 5, 6), torch.bfloat16, layout)
    if variant.startswith("moments"):
        s, s2 = IN.instance_norm_moments_plain(x)
        args = (x, s, s2, 30.0, 1e-5, variant == "moments_relu", None)
    else:
        gen = torch.Generator().manual_seed(4)
        sc, sh = torch.rand(2, 3, generator=gen) + 0.5, torch.randn(2, 3, generator=gen)
        skip = _x((2, 3, 5, 6), torch.bfloat16, layout, 5) if variant == "affine_skip" else None
        args = (x, sc, sh, None, 0.0, variant == "affine_relu", skip)
    torch.library.opcheck(torch.ops.desr.norm_apply.default, args)


# -------------------------------------------------------- the launch plans

PLAN_CASES = [  # (B, C, H, W), element bytes, 16-byte aligned, SMs
    ((2, 3, 5, 7), 4, True, 4), ((2, 8, 4, 4), 2, True, 4), ((1, 16, 64, 130), 2, True, 2),
    ((2, 32, 40, 64), 2, True, 4), ((3, 200, 3, 5), 2, True, 4), ((2, 512, 2, 5), 2, True, 4),
    ((2, 12, 9, 9), 4, True, 4), ((1, 5, 33, 31), 2, False, 4), ((2, 130, 6, 6), 4, True, 2),
    ((1, 1, 300, 301), 2, True, 8),
]


def _walk_moments(p, shape):
    """How often the moments kernel (``csrc/instance_norm.cu``) reads each
    value of x under plan p, walking its block and thread indices; checks
    each partial and ticket index against the wrapper's buffers."""
    b, c, h, w = shape
    hw = h * w
    seen = np.zeros(b * c * hw, np.int64)
    n_partials = p.outer * p.splits * (2 if p.layout == IN.PLANES else 2 * c)
    for bx in range(p.outer * p.splits):
        for by in range(p.slices):
            if p.layout == IN.PLANES:
                plane, k = divmod(bx, p.splits)
                begin, end = k * p.chunk, min(hw, (k + 1) * p.chunk)
                assert begin < end
                for t in range(IN.NTHREADS):
                    for i in range(begin + t * p.vec, end, IN.NTHREADS * p.vec):
                        assert i + p.vec <= end
                        seen[plane * hw + i:plane * hw + i + p.vec] += 1
                if p.splits > 1:
                    assert 2 * (plane * p.splits + k) + 1 < n_partials and plane < p.outer
                continue
            img, tile = divmod(bx, p.splits)
            p0, p1 = tile * p.chunk, min(hw, (tile + 1) * p.chunk)
            assert p0 < p1
            c0 = by * IN.SLICE
            cs = min(IN.SLICE, c - c0)
            gs = cs // p.vec
            rows = IN.NTHREADS // gs
            assert 2 * cs <= IN.NTHREADS
            for t in range(rows * gs):
                g, r = t % gs, t // gs
                for px in range(p0 + r, p1, rows):
                    i = (img * hw + px) * c + c0 + g * p.vec
                    seen[i:i + p.vec] += 1
            if p.splits > 1:
                last = ((img * p.splits + tile) * 2 + 1) * c + c0 + cs - 1
                assert last < n_partials and img * p.slices + by < p.outer * p.slices
    return seen


@pytest.mark.parametrize("shape,elem,aligned,sms", PLAN_CASES)
@pytest.mark.parametrize("layout", [IN.PLANES, IN.PIXELS])
def test_launch_plan_reads_every_value_once(layout, shape, elem, aligned, sms):
    """Each value of x is read by exactly one thread of one block, in whole
    16-byte vectors where the plan takes them; the partials and tickets
    fit the wrapper's buffers. The apply kernels walk the same tiles."""
    p = IN.launch_plan(layout, shape, elem, aligned, sms)
    b, c, h, w = shape
    full = 16 // elem
    run = h * w if layout == IN.PLANES else c
    assert p.vec == (full if aligned and run % full == 0 else 1)
    if layout == IN.PLANES:
        assert p.chunk % p.vec == 0 and p.splits <= IN.MAX_SPLITS
    else:
        assert p.slices == -(-c // IN.SLICE)
    assert (p.splits - 1) * p.chunk < h * w <= p.splits * p.chunk
    seen = _walk_moments(p, shape)
    np.testing.assert_array_equal(seen, np.ones_like(seen))


def test_launch_plan_fills_the_card_at_the_serving_shapes():
    """At the full-resolution norms (B=8, 32x512x640, bf16) both layouts
    take 16-byte loads and at least one block an SM of a 132-SM card."""
    for layout in (IN.PLANES, IN.PIXELS):
        p = IN.launch_plan(layout, (8, 32, 512, 640), 2, True, 132)
        assert p.vec == 8
        assert p.outer * p.splits * p.slices >= 132
