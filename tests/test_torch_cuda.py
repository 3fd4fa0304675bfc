"""The port's CUDA kernels (K1/K2 conv3x3, K3 masked-loss sums and their
backward) against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device. The file
imports neither JAX nor anything of ``desr_tpu``, so that it runs on a machine
with the card and no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

from unittest import mock

import numpy as np
import pytest
import torch

from desr_tpu_torch.ops import conv3x3 as K
from desr_tpu_torch.ops import masked_loss as K3

torch.set_num_threads(2)

# out: f32 summation order over 9 * C_in terms (float32); at most one bf16
# step apart after the same f32 sum in another order (bfloat16).
# s, s2: f32 summation order over the H * W pixels.
OUT_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-3),
           torch.bfloat16: dict(rtol=2 ** -7, atol=1e-3)}
STATS_TOL = dict(rtol=1e-4, atol=1e-2)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, cout, seed, dev):
    rng = np.random.default_rng(seed)
    b, c = shape[0], shape[-1]
    arrs = (rng.standard_normal(shape), 0.1 * rng.standard_normal((cout, c, 3, 3)),
            rng.uniform(0.5, 2.0, (b, c)), rng.standard_normal((b, c)))
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrs]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["reflect", "replicate", "zeros"])
def test_cuda_kernel_matches_plain(mode, dtype):
    """Ragged tiles (21x37), C_in not a multiple of the bf16 body's
    64-channel chunk (72) and C_out not a multiple of its N tile (80 of 128)."""
    dev = _cuda()
    dt = getattr(torch, dtype)
    x, w, scale, shift = _inputs((2, 21, 37, 72), 80, 51, dev)
    x = x.to(dt)
    for sc, sh, relu in ((None, None, False), (scale, shift, True), (scale, shift, False)):
        got = K.conv3x3_fused(x, w, sc, sh, mode, relu, True)
        want = K.conv3x3_fused_plain(x, w, sc, sh, mode, relu, True)
        torch.testing.assert_close(got[0].float(), want[0].float(), **OUT_TOL[dt])
        for g, v in zip(got[1:], want[1:]):
            torch.testing.assert_close(g, v, **STATS_TOL)
    torch.testing.assert_close(K.conv3x3(x, w, mode).float(),
                               K.conv3x3_fused_plain(x, w, pad_mode=mode).float(),
                               **OUT_TOL[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["reflect", "replicate", "zeros"])
def test_cuda_kernel_with_halo_rows_matches_plain(mode, dtype):
    """K1 and K2 with halo rows (1, 0), (1, 1), (0, 1) against their plain
    versions, on three bands of a 21x37 frame, and the bands' outputs
    concatenated bit-equal to the whole frame's launch (each output pixel
    sums the same taps and channels in the same order)."""
    dev = _cuda()
    dt = getattr(torch, dtype)
    x, w, scale, shift = _inputs((2, 21, 37, 72), 80, 52, dev)
    x = x.to(dt)
    bands = ((0, 8, 0, 1), (6, 15, 1, 1), (13, 21, 1, 0))  # x rows lo..hi, halo rows
    for sc, sh, relu in ((None, None, False), (scale, shift, True)):
        whole = K.conv3x3_fused(x, w, sc, sh, mode, relu, True)
        outs = []
        for lo, hi, top, bottom in bands:
            got = K.conv3x3_fused(x[:, lo:hi].contiguous(), w, sc, sh, mode, relu, True,
                                  top, bottom)
            want = K.conv3x3_fused_plain(x[:, lo:hi], w, sc, sh, mode, relu, True, top, bottom)
            torch.testing.assert_close(got[0].float(), want[0].float(), **OUT_TOL[dt])
            for g, v in zip(got[1:], want[1:]):
                torch.testing.assert_close(g, v, **STATS_TOL)
            outs.append(got[0])
        assert torch.equal(torch.cat(outs, 1), whole[0])
    got = K.conv3x3(x[:, 7:15].contiguous(), w, mode, 1, 1)
    torch.testing.assert_close(got.float(), K.conv3x3_fused_plain(
        x[:, 7:15], w, pad_mode=mode, halo_top=1, halo_bottom=1).float(), **OUT_TOL[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cout,mode", [
    ((1, 2, 2, 3), 5, "reflect"), ((1, 1, 7, 20), 3, "replicate"), ((3, 1, 1, 1), 1, "zeros"),
])
def test_cuda_kernel_takes_tiny_shapes(shape, cout, mode):
    dev = _cuda()
    x, w, scale, shift = _inputs(shape, cout, 61, dev)
    for dt in (torch.float32, torch.bfloat16):
        got = K.conv3x3_fused(x.to(dt), w, scale, shift, mode, True, True)
        want = K.conv3x3_fused_plain(x.to(dt), w, scale, shift, mode, True, True)
        torch.testing.assert_close(got[0].float(), want[0].float(), **OUT_TOL[dt])
        for g, v in zip(got[1:], want[1:]):
            torch.testing.assert_close(g, v, **STATS_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cout,mode", [
    ((2, 30, 37, 16), 16, "reflect"),      # the --SR head's width; W not a multiple of 16
    ((1, 2, 2, 64), 64, "reflect"),        # H = W = 2 with reflect
    ((2, 17, 40, 128), 128, "replicate"),  # one row past a 16-row tile
    ((1, 12, 19, 200), 160, "reflect"),    # N tile 256 with 96 channels masked
    ((1, 9, 20, 256), 300, "zeros"),       # two N tiles
    ((2, 8, 33, 256), 256, "replicate"),   # the translator's width, ragged columns
])
def test_cuda_bf16_body_at_its_tile_edges(shape, cout, mode):
    """The bf16 body where its tiling can break, every variant, K2 included;
    one K1 launch per call."""
    dev = _cuda()
    x, w, scale, shift = _inputs(shape, cout, 54, dev)
    x = x.to(torch.bfloat16)
    for sc, sh, relu, stats in ((None, None, False, True), (scale, shift, True, True),
                                (scale, shift, False, False)):
        before = K.conv3x3_fused.launches
        got = K.conv3x3_fused(x, w, sc, sh, mode, relu, stats)
        assert K.conv3x3_fused.launches == before + 1
        want = K.conv3x3_fused_plain(x, w, sc, sh, mode, relu, stats)
        got, want = (got, want) if stats else ((got,), (want,))
        torch.testing.assert_close(got[0].float(), want[0].float(), **OUT_TOL[torch.bfloat16])
        for g, v in zip(got[1:], want[1:]):
            torch.testing.assert_close(g, v, **STATS_TOL)
    torch.testing.assert_close(K.conv3x3(x, w, mode).float(),
                               K.conv3x3_fused_plain(x, w, pad_mode=mode).float(),
                               **OUT_TOL[torch.bfloat16])


@pytest.mark.cuda
def test_cuda_bf16_body_takes_a_misaligned_x():
    """A contiguous x one element into its storage is not 16-byte aligned:
    the body's scalar halo loads run instead of cp.async."""
    dev = _cuda()
    x, w, scale, shift = _inputs((2, 10, 21, 64), 64, 55, dev)
    xm = torch.empty(x.numel() + 1, dtype=torch.bfloat16, device=dev)[1:].view(x.shape)
    xm.copy_(x)
    assert xm.is_contiguous() and xm.data_ptr() % 16 != 0
    got = K.conv3x3_fused(xm, w, scale, shift, "reflect", True, True)
    want = K.conv3x3_fused_plain(xm, w, scale, shift, "reflect", True, True)
    torch.testing.assert_close(got[0].float(), want[0].float(), **OUT_TOL[torch.bfloat16])
    for g, v in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, v, **STATS_TOL)


@pytest.mark.cuda
def test_cuda_stats_are_deterministic():
    """The moments come from per-tile partials and a fixed-order second
    pass (no float atomics): two launches give the same bits."""
    dev = _cuda()
    x, w, scale, shift = _inputs((2, 40, 48, 64), 64, 71, dev)
    x = x.to(torch.bfloat16)
    a = K.conv3x3_fused(x, w, scale, shift, "reflect", True, True)
    b = K.conv3x3_fused(x, w, scale, shift, "reflect", True, True)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.cuda
@pytest.mark.parametrize("case,err", [
    ("float16", TypeError), ("strided", ValueError), ("w_on_cpu", ValueError),
])
def test_cuda_wrapper_raises_instead_of_falling_back(case, err):
    dev = _cuda()
    x = torch.zeros(2, 6, 9, 4, device=dev)
    w = torch.zeros(8, 4, 3, 3, device=dev)
    if case == "float16":
        x = x.half()
    elif case == "strided":
        x = torch.zeros(2, 6, 18, 4, device=dev)[:, :, ::2]
    else:
        w = w.cpu()
    before = K.conv3x3_fused.launches
    with pytest.raises(err):
        K.conv3x3_fused(x, w, pad_mode="reflect")
    assert K.conv3x3_fused.launches == before


# ------------------------------------------------------------------ K1 backward

@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["reflect", "replicate", "zeros"])
def test_cuda_conv3x3_fused_grads_match_plain_autograd(mode):
    """The kernel's forward under the autograd Function, backward included:
    dx, dw, dscale, dshift with cotangents on out, s and s2, against autograd
    of the plain version on the card (float32, TF32 off): within 1e-4 of each
    gradient's largest entry."""
    dev = _cuda()
    x, w, scale, shift = _inputs((2, 21, 37, 72), 80, 52, dev)
    rng = np.random.default_rng(53)
    g_out = torch.from_numpy(rng.standard_normal((2, 21, 37, 80)).astype(np.float32)).to(dev)
    g_s = torch.from_numpy(rng.standard_normal((2, 80)).astype(np.float32)).to(dev)
    g_s2 = 0.01 * torch.from_numpy(rng.standard_normal((2, 80)).astype(np.float32)).to(dev)
    grads = []
    for fn in (K.conv3x3_fused, K.conv3x3_fused_plain):
        ins = [t.clone().requires_grad_(True) for t in (x, w, scale, shift)]
        out, s, s2 = fn(*ins, mode, True, True)
        loss = (out * g_out).sum() + (s * g_s).sum() + (s2 * g_s2).sum()
        grads.append(torch.autograd.grad(loss, ins))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["reflect", "replicate", "zeros"])
@pytest.mark.parametrize("halo", [(0, 1), (1, 0), (1, 1)])
def test_cuda_conv3x3_fused_halo_grads_match_plain_autograd(mode, halo):
    """K1 launched with halo rows under the autograd Function: dx (halo rows
    included), dw, dscale, dshift with cotangents on out, s and s2, against
    autograd of the plain version with the same halo rows on the card
    (float32, TF32 off), within 1e-4 of each gradient's largest entry; each
    backward counted in ``backwards_halo``."""
    dev = _cuda()
    x, w, scale, shift = _inputs((2, 23, 37, 72), 80, 54, dev)
    rows = 23 - sum(halo)
    rng = np.random.default_rng(55)
    g_out = torch.from_numpy(rng.standard_normal((2, rows, 37, 80)).astype(np.float32)).to(dev)
    g_s = torch.from_numpy(rng.standard_normal((2, 80)).astype(np.float32)).to(dev)
    g_s2 = 0.01 * torch.from_numpy(rng.standard_normal((2, 80)).astype(np.float32)).to(dev)
    grads = []
    before = K.conv3x3_fused.backwards_halo
    for fn in (K.conv3x3_fused, K.conv3x3_fused_plain):
        ins = [t.clone().requires_grad_(True) for t in (x, w, scale, shift)]
        out, s, s2 = fn(*ins, mode, True, True, *halo)
        loss = (out * g_out).sum() + (s * g_s).sum() + (s2 * g_s2).sum()
        grads.append(torch.autograd.grad(loss, ins))
    assert K.conv3x3_fused.backwards_halo == before + 1
    assert grads[0][0].shape == x.shape
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))


# ------------------------------------------------------------------ K3


def _loss_inputs(shape, seed, dev, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    p, t = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for _ in range(2))
    m1, m2 = (torch.from_numpy((rng.random(shape) > q).astype(np.float32)) for q in (0.3, 0.6))
    return p.to(dev, dtype), t.to(dev, dtype), m1.to(dev), m2.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(6, 512, 640), (3, 37, 41), (1, 1, 3)])
def test_cuda_masked_loss_matches_plain(shape, dtype):
    """Each sum within 1e-5 of itself (its terms are >= 0: f32 summation
    order only), ragged tails (not a multiple of 4) included."""
    dev = _cuda()
    ins = _loss_inputs(shape, 81, dev, getattr(torch, dtype))
    got = torch.stack(K3.masked_loss_sums(*ins))
    want = K3.masked_loss_sums_plain(*ins)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_cuda_masked_loss_takes_misaligned_views_and_is_deterministic():
    """A view one element into its storage is not aligned for vector loads
    (the scalar path runs); two launches give the same bits."""
    dev = _cuda()
    p, t, m1, m2 = (v.flatten()[1:] for v in _loss_inputs((4, 33, 50), 82, dev))
    got = torch.stack(K3.masked_loss_sums(p, t, m1, m2))
    torch.testing.assert_close(got, K3.masked_loss_sums_plain(p, t, m1, m2), rtol=1e-5, atol=1e-6)
    assert torch.equal(got, torch.stack(K3.masked_loss_sums(p, t, m1, m2)))


@pytest.mark.cuda
def test_cuda_masked_loss_grads_and_launch_count():
    dev = _cuda()
    p, t, m1, m2 = _loss_inputs((2, 40, 48), 83, dev)
    p.requires_grad_(True)
    before = K3.masked_loss_sums.launches, K3.masked_loss_grads.launches
    task, holes, l2 = K3.fused_hole_means(p, t, m1, m2)
    (g,) = torch.autograd.grad(task + 2 * holes + 3 * l2, p)
    assert (K3.masked_loss_sums.launches, K3.masked_loss_grads.launches) == (
        before[0] + 1, before[1] + 1)
    n = p.numel()
    d1 = (t * m1 - p * m1).detach()
    d2 = d1 * m2
    want = -(torch.sign(d1) / n + m1 * (2 * torch.sign(d2) / n + 3 * 2 * d2 * 5 / n)) * m1
    torch.testing.assert_close(g, want, rtol=1e-6, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 512, 640), (3, 37, 41), (1, 1, 3)])
def test_cuda_masked_loss_sums_one_launch_match_plain(shape, dtype):
    """The sums in one launch (grid over whole waves, head and tail by block
    0), within 1e-5 of the plain sums; one count a call."""
    dev = _cuda()
    ins = _loss_inputs(shape, 85, dev, getattr(torch, dtype))
    before = K3.masked_loss_sums.launches
    got = torch.stack(K3.masked_loss_sums(*ins))
    assert K3.masked_loss_sums.launches == before + 1
    torch.testing.assert_close(got, K3.masked_loss_sums_plain(*ins), rtol=1e-5, atol=1e-6)


def _bits(x):
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int16)


@pytest.mark.cuda
@pytest.mark.parametrize("with_dt", [True, False], ids=["with_dt", "no_dt"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 40, 48), (3, 37, 41), (1, 1, 3), "misaligned"])
def test_cuda_masked_loss_grads_equal_plain_bits(shape, dtype, with_dt):
    """The backward kernel evaluates the plain expression in its order with
    every operation rounded on its own: the same bits as
    masked_loss_grads_plain (bf16: after the same rounding); one launch."""
    dev = _cuda()
    dt_ = getattr(torch, dtype)
    if shape == "misaligned":  # views one value into their storage
        ins = [v.flatten()[1:] for v in _loss_inputs((4, 33, 50), 86, dev, dt_)]
    else:
        ins = _loss_inputs(shape, 86, dev, dt_)
    g = torch.tensor([0.7, -1.3, 0.4], device=dev)
    before = K3.masked_loss_grads.launches
    got = K3.masked_loss_grads(*ins, g, with_dt)
    assert K3.masked_loss_grads.launches == before + 1
    want = K3.masked_loss_grads_plain(*ins, g, with_dt)
    assert got[0].dtype == ins[0].dtype and torch.equal(_bits(got[0]), _bits(want[0]))
    if with_dt:
        assert torch.equal(_bits(got[1]), _bits(want[1]))
    else:
        assert got[1] is None


@pytest.mark.cuda
def test_cuda_masked_loss_ticket_resets_between_launches():
    """The last block resets the ticket: 100 launches in a row give the same
    bits, and a small n (fewer blocks) in between does not disturb it."""
    dev = _cuda()
    ins = _loss_inputs((1, 1024, 1280), 87, dev)
    small = _loss_inputs((1, 1, 3), 88, dev)
    first = torch.stack(K3.masked_loss_sums(*ins))
    for i in range(100):
        if i == 50:
            torch.testing.assert_close(torch.stack(K3.masked_loss_sums(*small)),
                                       K3.masked_loss_sums_plain(*small), rtol=1e-5, atol=1e-6)
        assert torch.equal(torch.stack(K3.masked_loss_sums(*ins)), first)
    torch.testing.assert_close(first, K3.masked_loss_sums_plain(*ins), rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_cuda_masked_loss_on_two_streams():
    """Each stream has its own ticket and partials: launches on two streams
    without a sync between them all give the plain sums, with the same bits."""
    dev = _cuda()
    ins = _loss_inputs((6, 512, 640), 89, dev)
    want = K3.masked_loss_sums_plain(*ins)
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    torch.cuda.synchronize()
    outs = []
    for i in range(20):
        with torch.cuda.stream(streams[i % 2]):
            outs.append(torch.stack(K3.masked_loss_sums(*ins)))
    torch.cuda.synchronize()
    torch.testing.assert_close(outs[0], want, rtol=1e-5, atol=1e-6)
    assert all(torch.equal(o, outs[0]) for o in outs)


@pytest.mark.cuda
@pytest.mark.parametrize("case,err", [("float16", TypeError), ("strided", ValueError)])
def test_cuda_masked_loss_raises_instead_of_falling_back(case, err):
    dev = _cuda()
    p, t, m1, m2 = _loss_inputs((2, 8, 16), 84, dev)
    if case == "float16":
        p = p.half()
    else:
        p = torch.zeros(2, 8, 32, device=dev)[:, :, ::2]
    before = K3.masked_loss_sums.launches
    with pytest.raises(err):
        K3.masked_loss_sums(p, t, m1, m2)
    assert K3.masked_loss_sums.launches == before


# ------------------------------------------------------------------ the exported route

@pytest.mark.cuda
def test_cuda_exported_serving_launches_k1(tmp_path):
    """The main-mode serving forward exported on the card (bf16, small
    widths): 24 desr::conv3x3_fused nodes; served from the artifact, K1
    launches 24 times and the prediction equals the live serve_forward's
    (the same kernels and library convs on the same inputs), under cuDNN's
    deterministic algorithms: its default ones need not repeat bit for bit."""
    dev = _cuda()
    import collections

    from desr_tpu_torch.models.main_model import MainModel, NetOptions
    from desr_tpu_torch.serving import export_serving, load_serving

    model = MainModel(NetOptions(ImageDepthf_outf=8, ImageDepthf_basef=8, Depthf_outf=8,
                                 Depthf_basef=8, I2D_base=8, Task_basef=8), device=dev)
    rng = np.random.default_rng(61)
    batch = {"B_d": rng.uniform(-1, 1, (2, 128, 256, 1)).astype(np.float32),
             "B_i": rng.uniform(-1, 1, (2, 128, 256, 3)).astype(np.float32)}
    manifest = export_serving(model, batch, str(tmp_path), "pred_real_depth")
    assert manifest["platforms"] == ["cuda"] and manifest["compute_dtype"] == "bfloat16"
    program = torch.export.load(str(tmp_path / "serving.pt2"))
    ops = collections.Counter(str(n.target) for n in program.graph.nodes
                              if n.op == "call_function")
    assert ops["desr.conv3x3_fused.default"] == 24
    fn, params, _ = load_serving(str(tmp_path))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        before = K.conv3x3_fused.launches
        got = fn(params, batch)
        torch.cuda.synchronize()
        assert K.conv3x3_fused.launches - before == 24
        want = model.serve_forward(batch)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert got.device.type == "cuda" and got.shape == (2, 128, 256)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["blocks", "tails"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_fused_chain_under_checkpoint_matches_plain(mode, dtype):
    """A ResnetBlock's fused chain (two K1 launches) under
    torch.utils.checkpoint: "blocks" recomputes both launches in the
    backward, "tails" keeps their outputs (the selective policy sees
    desr::conv3x3_fused). With deterministic algorithms the checkpointed
    kernel run equals the uncheckpointed one bit for bit, output and
    gradients; at float32 it equals the same checkpointed chain on the plain
    version, the output within 1e-4 and each gradient within 1e-3 of its
    largest entry (a random cotangent on the output); a conv bias, which
    feeds an InstanceNorm and has an exact gradient of 0, within 1e-3 of
    the largest weight gradient."""
    from desr_tpu_torch.models import layers as TL
    from desr_tpu_torch.models import networks as TN

    dev = _cuda()
    dt = getattr(torch, dtype)
    block = TN.ResnetBlock(128, "reflect", TL.InstanceNorm2d, False, True)
    block = TN.init_weights(block, generator=torch.Generator().manual_seed(0)).to(dev)
    rng = np.random.default_rng(1)
    x0 = torch.from_numpy(rng.standard_normal((2, 128, 24, 40)).astype(np.float32)).to(dev, dt)
    r = torch.from_numpy(rng.standard_normal((2, 128, 24, 40)).astype(np.float32)).to(dev)

    def run(remat, fwd):
        block.remat = remat
        x = x0.clone().requires_grad_(True)
        before = K.conv3x3_fused.launches
        with mock.patch.object(K, "_fused_forward", fwd):
            out = block(x)
            grads = torch.autograd.grad((out.float() * r).sum(), [x, *block.parameters()])
        return out.detach(), grads, K.conv3x3_fused.launches - before

    kernel, plain = K._fused_forward, K.conv3x3_fused_plain
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        out_k, g_k, n_k = run(mode, kernel)
        out_0, g_0, n_0 = run(None, kernel)
        out_p, g_p, _ = run(mode, plain)
    finally:
        torch.use_deterministic_algorithms(False)
    assert n_0 == 2 and n_k == (4 if mode == "blocks" else 2)
    assert torch.equal(out_k, out_0)
    for a, b in zip(g_k, g_0):
        assert torch.equal(a, b)
    if dt == torch.float32:
        torch.testing.assert_close(out_k, out_p, rtol=0, atol=1e-4)
        names = ["x"] + [n for n, _ in block.named_parameters()]
        w_max = max(float(b.abs().max()) for n, b in zip(names, g_p) if n.endswith("weight"))
        for n, a, b in zip(names, g_k, g_p):
            scale = w_max if n.endswith("bias") else float(b.abs().max())
            torch.testing.assert_close(a, b, rtol=0, atol=1e-3 * scale, msg=n)


# ------------------------------------------------------------------ K4

# (B, C, H, W): the serving nets' norms at batch 8 and 512x640 (resnet_6blocks
# stem and ups, downs; the U-Nets' levels down to 8x10), and ragged shapes
# that take the value-by-value paths
K4_SHAPES = [(8, 32, 512, 640), (8, 64, 256, 320), (8, 128, 128, 160), (8, 256, 64, 80),
             (8, 512, 8, 10), (2, 200, 9, 11), (3, 5, 7, 13)]


def _k4_input(shape, dtype, layout, seed, dev, offset=0.4):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((1.7 * rng.standard_normal(shape) + offset).astype(np.float32))
    x = x.to(dev, getattr(torch, dtype))
    return x.contiguous(memory_format=torch.channels_last) if layout == "channels_last" else x


def _k4_ref64(x, relu, skip, scale_shift=None, eps=1e-5):
    """The normalisation in float64 from float64 moments (or the (scale,
    shift) given), [ReLU], [+ skip]."""
    x64 = x.double()
    if scale_shift is None:
        mean = x64.mean(dim=(2, 3), keepdim=True)
        var = (x64.square().mean(dim=(2, 3), keepdim=True) - mean.square()).clamp(min=0)
        y = (x64 - mean) / torch.sqrt(var + eps)
    else:
        sc, sh = scale_shift
        y = x64 * sc.double()[:, :, None, None] + sh.double()[:, :, None, None]
    if relu:
        y = y.clamp(min=0)
    return y if skip is None else y + skip.double()


def _half_ulp(v, dtype):
    """Half a step of ``dtype`` at |v|'s largest value."""
    m = float(v.abs().max())
    mant = 7 if dtype == torch.bfloat16 else 23
    return 0.5 * 2.0 ** (np.floor(np.log2(max(m, 1e-30))) - mant)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["norm", "norm_relu", "tail_skip"])
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("shape", K4_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cuda_k4_matches_plain_and_float64(shape, layout, variant):
    """K4's moments against float64 (within 1e-5 of sum |x| and of sum x^2)
    and the plain version's; its apply's largest error against float64 no
    larger than the plain version's plus half a bf16 step (bf16; f32 for
    the f32 rows), in x's memory format; the norm from moments, with ReLU,
    and the chain's tail from (scale, shift) with a skip."""
    from desr_tpu_torch.ops import instance_norm as IN

    dev = _cuda()
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        x = _k4_input(shape, dtype, layout, 71, dev)
        before = IN.instance_norm_moments.launches, IN.norm_apply.launches
        with torch.no_grad():
            s, s2 = IN.instance_norm_moments(x)
            ps, ps2 = IN.instance_norm_moments_plain(x)
            x64 = x.double()
            for got, plain, ref, mag in ((s, ps, x64.sum(dim=(2, 3)), x64.abs().sum(dim=(2, 3))),
                                         (s2, ps2, x64.square().sum(dim=(2, 3)), None)):
                mag = ref if mag is None else mag
                assert float(((got.double() - ref).abs() / mag).max()) < 1e-5
                assert float(((plain.double() - ref).abs() / mag).max()) < 1e-5
            n = shape[2] * shape[3]
            skip = sc_sh = None
            if variant == "tail_skip":
                rng = np.random.default_rng(72)
                sc_sh = tuple(torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
                    rng.uniform(0.5, 2.0, shape[:2]), rng.standard_normal(shape[:2])))
                skip = _k4_input(shape, dtype, layout, 73, dev)
                a, b, nn_ = sc_sh[0], sc_sh[1], None
            else:
                a, b, nn_ = s, s2, n
            relu = variant == "norm_relu"
            got = IN.norm_apply(x, a, b, nn_, 1e-5, relu, skip)
            plain = IN.norm_apply_plain(x, a, b, nn_, 1e-5, relu, skip)
            torch.cuda.synchronize()
        assert (IN.instance_norm_moments.launches - before[0],
                IN.norm_apply.launches - before[1]) == (1, 1)
        assert got.dtype == dt and got.stride() == x.stride()
        ref = _k4_ref64(x, relu, skip, sc_sh)
        err_k4 = float((got.double() - ref).abs().max())
        err_plain = float((plain.double() - ref).abs().max())
        assert err_k4 <= err_plain + _half_ulp(ref, dt), (dtype, err_k4, err_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
def test_cuda_k4_repeats_bit_for_bit(layout):
    """Two launches of each operator give the same bits (the moments'
    partials summed in a fixed order, the tickets reset between launches),
    at a shape split over many blocks and at one that is not."""
    from desr_tpu_torch.ops import instance_norm as IN

    dev = _cuda()
    for shape in ((8, 32, 512, 640), (8, 512, 8, 10)):
        x = _k4_input(shape, "bfloat16", layout, 74, dev)
        with torch.no_grad():
            runs = []
            for _ in range(2):
                s, s2 = IN.instance_norm_moments(x)
                runs.append((s, s2, IN.norm_apply(x, s, s2, shape[2] * shape[3], 1e-5, True)))
        for a, b in zip(*runs):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["strided", "nhwc_permuted", "float16", "skip_layout"])
def test_cuda_k4_raises_instead_of_falling_back(case):
    """A strided x, an NHWC tensor permuted to a layout that is not
    channels_last, a dtype the kernels do not take, or a skip in another
    layout than x's raise before any launch."""
    from desr_tpu_torch.ops import instance_norm as IN

    dev = _cuda()
    x = _k4_input((2, 16, 8, 12), "bfloat16", "nchw", 75, dev)
    skip = None
    if case == "strided":
        x = x[:, :, :, ::2]
    elif case == "nhwc_permuted":
        x = torch.zeros(2, 8, 12, 16, device=dev, dtype=torch.bfloat16).permute(0, 3, 2, 1)
    elif case == "float16":
        x = x.half()
    else:
        skip = x.contiguous(memory_format=torch.channels_last)
    s = torch.ones(x.shape[:2], device=dev)
    before = IN.instance_norm_moments.launches, IN.norm_apply.launches
    with torch.no_grad():
        if skip is None:
            with pytest.raises((ValueError, TypeError)):
                IN.instance_norm_moments(x)
        with pytest.raises((ValueError, TypeError)):
            IN.norm_apply(x, s, s, 96, 1e-5, False, skip)
    assert (IN.instance_norm_moments.launches, IN.norm_apply.launches) == before


@pytest.mark.cuda
def test_cuda_k4_launches_in_serving_and_not_under_a_gradient():
    """One main serve_forward (small widths, bf16) launches K4 32 times for
    the moments and 44 for the apply, and runs with K1's plain version
    swapped in; ``Depth_f`` under a gradient launches it 0 times, and its
    output then equals the plain route's bit for bit."""
    from desr_tpu_torch.models.main_model import MainModel, NetOptions
    from desr_tpu_torch.ops import instance_norm as IN

    dev = _cuda()
    model = MainModel(NetOptions(ImageDepthf_outf=8, ImageDepthf_basef=8, Depthf_outf=8,
                                 Depthf_basef=8, I2D_base=8, Task_basef=8), device=dev)
    rng = np.random.default_rng(76)
    batch = {"B_d": rng.uniform(-1, 1, (2, 128, 256, 1)).astype(np.float32),
             "B_i": rng.uniform(-1, 1, (2, 128, 256, 3)).astype(np.float32)}
    before = IN.instance_norm_moments.launches, IN.norm_apply.launches
    model.serve_forward(batch)
    torch.cuda.synchronize()
    assert (IN.instance_norm_moments.launches - before[0],
            IN.norm_apply.launches - before[1]) == (32, 44)
    # with K1's plain version in its place (a permuted view, not NHWC-contiguous)
    with mock.patch.object(K, "conv3x3_fused", K.conv3x3_fused_plain):
        assert bool(torch.isfinite(model.serve_forward(batch)).all())
    net = model.nets["Depth_f"].requires_grad_(True)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 2, 128, 256)).astype(np.float32)).to(dev)
    x = x.to(torch.bfloat16)
    before = IN.instance_norm_moments.launches, IN.norm_apply.launches
    out = net(x)
    assert out.requires_grad
    assert (IN.instance_norm_moments.launches, IN.norm_apply.launches) == before
    with mock.patch.object(IN, "kernel_route", lambda *t: False), torch.no_grad():
        plain = net(x)
    assert torch.equal(out.detach(), plain)
