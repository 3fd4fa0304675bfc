"""The port's conv3x3 kernel module against the JAX Pallas conv kernel.

On the CPU the port's wrappers take the plain PyTorch version; the JAX side
runs the Pallas kernel in interpret mode. The CUDA kernel itself is held
against the plain version on the card (the cuda-marked test here and
chip_smoke.py phase (b)).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import randn  # noqa: F401  (sets torch threads)

from desr_tpu.ops.pallas_conv import conv2d_pallas, conv2d_pallas_fused
from desr_tpu_torch.ops import conv3x3 as K

SHAPE, COUT = (2, 24, 160, 128), 64


def _inputs(seed=11, shape=SHAPE, cout=COUT):
    x = randn(shape, seed)
    w = randn((cout, shape[-1], 3, 3), seed + 1, 0.1)
    rng = np.random.default_rng(seed + 2)
    scale = rng.uniform(0.5, 2.0, (shape[0], shape[-1])).astype(np.float32)
    shift = rng.standard_normal((shape[0], shape[-1])).astype(np.float32)
    return x, w, scale, shift


def _close(got, want):
    # f32 accumulation-order noise only (tests/test_pallas_conv.py:103)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-3)


# (prologue, relu, stats): the combinations of tests/test_pallas_conv.py:86-120
@pytest.mark.parametrize("prologue,relu,stats", [
    (True, True, True), (True, False, False), (True, True, False), (False, False, True),
])
def test_fused_zeros_matches_pallas(prologue, relu, stats):
    x, w, scale, shift = _inputs()
    sc, sh = (scale, shift) if prologue else (None, None)
    want = conv2d_pallas_fused(jnp.asarray(x), jnp.asarray(w),
                               None if sc is None else jnp.asarray(sc),
                               None if sh is None else jnp.asarray(sh),
                               1, relu, stats, interpret=True)
    got = K.conv3x3_fused(torch.from_numpy(x), torch.from_numpy(w),
                          None if sc is None else torch.from_numpy(sc),
                          None if sh is None else torch.from_numpy(sh),
                          pad_mode="zeros", relu=relu, stats=stats)
    if not stats:
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, v in zip(got, want):
        _close(g, v)


def test_plain_conv_matches_pallas():
    x, w, _, _ = _inputs(seed=21)
    want = conv2d_pallas(jnp.asarray(x), jnp.asarray(w), 1, interpret=True)
    got = K.conv3x3(torch.from_numpy(x), torch.from_numpy(w), pad_mode="zeros")
    _close(got, want)


@pytest.mark.parametrize("mode,prologue", [
    ("reflect", True), ("replicate", True), ("reflect", False),
])
def test_borders_match_apply_ring(mode, prologue):
    """Reflect/replicate read in place == the zero-pad kernel + ring corrections."""
    from desr_tpu.models import layers as L

    x, w, scale, shift = _inputs(seed=31)
    conv = L.Conv2d(SHAPE[-1], COUT, 3, padding=1, bias=False)
    pro = (jnp.asarray(scale), jnp.asarray(shift), True) if prologue else None
    want = conv.apply_ring({"c.weight": jnp.asarray(w)}, jnp.asarray(x), "c.",
                           L.Ctx(dtype=jnp.float32), "reflect" if mode == "reflect" else "edge",
                           prologue=pro, want_stats=True, add_bias=False)
    got = K.conv3x3_fused(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(scale) if prologue else None,
                          torch.from_numpy(shift) if prologue else None,
                          pad_mode=mode, relu=prologue, stats=True)
    for g, v in zip(got, want):
        _close(g, v)


@pytest.mark.parametrize("kwargs,err", [
    (dict(pad_mode="circular"), "pad_mode"),
    (dict(w_shape=(8, 5, 3, 3)), "input channels"),
    (dict(w_shape=(8, 4, 5, 5)), "3, 3"),
    (dict(scale_shape=(2, 3)), "scale must be"),
    (dict(hw=(1, 9)), "H, W >= 2"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(kwargs, err):
    h, w_ = kwargs.get("hw", (6, 9))
    x = torch.zeros(2, h, w_, 4)
    w = torch.zeros(kwargs.get("w_shape", (8, 4, 3, 3)))
    sc = torch.zeros(kwargs.get("scale_shape", (2, 4)))
    with pytest.raises(ValueError, match=err):
        K.conv3x3_fused(x, w, sc, sc.clone(), pad_mode=kwargs.get("pad_mode", "reflect"))


def test_plain_output_rounds_like_its_dtype():
    """bf16 input: the prologue and the output round to bf16, the stats stay
    the f32 accumulator's (the kernel's contract)."""
    x, w, scale, shift = _inputs(seed=41, shape=(1, 6, 10, 16), cout=8)
    xb = torch.from_numpy(x).bfloat16()
    out, s, s2 = K.conv3x3_fused(xb, torch.from_numpy(w), torch.from_numpy(scale),
                                 torch.from_numpy(shift), "reflect", True, True)
    assert out.dtype == torch.bfloat16 and s.dtype == s2.dtype == torch.float32
    ref32, rs, rs2 = K.conv3x3_fused(xb.float(), torch.from_numpy(w).bfloat16().float(),
                                     torch.from_numpy(scale), torch.from_numpy(shift),
                                     "reflect", True, True)
    # the same f32 math up to the bf16 rounding of the normalised input
    assert (out.float() - ref32).abs().max() <= 0.05 * ref32.abs().max()
    torch.testing.assert_close(s, out.float().sum((1, 2)), rtol=2e-2, atol=0.5)


@pytest.mark.parametrize("case,err", [
    ("float16", TypeError), ("float64", TypeError), ("strided", ValueError),
    ("w_elsewhere", ValueError),
])
def test_kernel_path_raises_instead_of_falling_back(case, err):
    """The launch path checks what the CUDA kernel takes before it builds or
    launches anything, and raises: no plain-version fallback. (Checked here
    on CPU tensors handed to it directly; tests/test_torch_cuda.py checks
    the same through the public wrapper on the card.)"""
    x = torch.zeros(2, 6, 9, 4)
    w = torch.zeros(8, 4, 3, 3)
    if case in ("float16", "float64"):
        x = x.to(getattr(torch, case))
    elif case == "strided":
        x = torch.zeros(2, 6, 18, 4)[:, :, ::2]
    else:
        w = w.to("meta")
    with pytest.raises(err):
        K._launch(x, w, None, None, "reflect", False, False)


# ------------------------------------------------------- the bf16 body's layout

def _unpack(wp, cout, cin):
    """(cout, cin, 3, 3) weights from the packed layout: row n of a (tile,
    chunk, tap) matrix keeps input-channel group g in 16-byte slot g ^ n % 8."""
    tiles, chunks, _, nt = wp.shape[:4]
    n = torch.arange(nt)[:, None]
    w = wp[:, :, :, n, torch.arange(8)[None, :] ^ (n % 8)]
    w = w.reshape(tiles, chunks, 9, nt, K.BF16_KC).permute(0, 3, 1, 4, 2)
    return w.reshape(tiles * nt, chunks * K.BF16_KC, 3, 3)[:cout, :cin]


@pytest.mark.parametrize("cout,cin", [(80, 72), (16, 16), (300, 16), (128, 128), (5, 3)])
def test_packed_weights_unpack_exactly(cout, cin):
    """The wrapper's tile-major, 128-byte-swizzled weight layout loses
    nothing: unpacking it gives w back bit for bit (float32 and bf16), the
    padding past C_out and C_in is 0, and it is laid out contiguously."""
    w = torch.from_numpy(randn((cout, cin, 3, 3), cout + cin))
    nt, _ = K.bf16_tiling(cout)
    for dt in (torch.float32, torch.bfloat16):
        wp = K.pack_weights(w, nt, dt)
        assert tuple(wp.shape) == (-(-cout // nt), -(-cin // K.BF16_KC), 9, nt, 8, 8)
        assert wp.is_contiguous()   # the kernel reads it by address
        assert torch.equal(_unpack(wp, cout, cin), w.to(dt))
        assert int((wp != 0).sum()) == int((w.to(dt) != 0).sum())


def _border(i, n, mode):
    """csrc/conv3x3.cu border_index, on an index tensor (-1: a zero)."""
    inside = (i >= 0) & (i < n)
    if mode == "reflect":
        j = torch.where(i < 0, -i, 2 * n - 2 - i)
    elif mode == "replicate":
        j = torch.where(i < 0, torch.zeros_like(i), torch.full_like(i, n - 1))
    else:
        j = torch.full_like(i, -1)
    j = torch.where((j >= 0) & (j < n), j, torch.full_like(j, -1))
    return torch.where(inside, i, j)


def _walk(x, w, scale, shift, mode, relu, halo_rows=(0, 0)):
    """The bf16 body's loop order and indexing, in float32 on the CPU.

    Per (b, tile, N tile): for each 64-channel chunk the halo as the kernel's
    transform writes it ((TH+2) x 18 pixels, prologue on the mapped value,
    16-byte groups XOR-swizzled by pixel); for each tap the A rows read at the
    kernel's ldmatrix offsets and the weight tile read at wgmma's 128-byte
    swizzled offsets in the packed weights; the moments of each tile over
    its in-image pixels, summed over tiles in tile order. ``halo_rows``: x's
    halo rows above and below, which the index map reads as rows of x.
    """
    b, h_in, wd, c = x.shape
    h = h_in - sum(halo_rows)
    o = w.shape[0]
    nt, th = K.bf16_tiling(o)
    tw, kc = K.BF16_TW, K.BF16_KC
    hwd, hp = tw + 2, (th + 2) * (tw + 2)
    chunks, tiles_h, tiles_w = -(-c // kc), -(-h // th), -(-wd // tw)
    wflat = K.pack_weights(w, nt, torch.float32).reshape(-1)
    out = torch.zeros(b, h, wd, o)
    s = torch.zeros(b, o)
    s2 = torch.zeros(b, o)
    k = torch.arange(kc)
    n = torch.arange(nt)
    b_idx = n[:, None] * kc + ((k[None, :] // 8) ^ (n[:, None] % 8)) * 8 + k[None, :] % 8
    p_all = torch.arange(hp)
    hr, hc = p_all // hwd, p_all % hwd
    # output pixel m of the tile: tile row m // 16, column m % 16
    m = torch.arange(th * tw)
    for bi in range(b):
        for tile in range(tiles_h * tiles_w):
            oh0, ow0 = (tile // tiles_w) * th, (tile % tiles_w) * tw
            sh = _border(oh0 - 1 + halo_rows[0] + hr, h_in, mode)
            sw = _border(ow0 - 1 + hc, wd, mode)
            ok = (sh >= 0) & (sw >= 0)
            for nb in range(-(-o // nt)):
                acc = torch.zeros(th * tw, nt)
                for ch in range(chunks):
                    ci0 = ch * kc
                    v = torch.zeros(hp, kc)
                    cn = min(kc, c - ci0)
                    src = x[bi, sh.clamp(min=0), sw.clamp(min=0), ci0:ci0 + cn]
                    if scale is not None:
                        src = src * scale[bi, ci0:ci0 + cn] + shift[bi, ci0:ci0 + cn]
                        src = torch.relu(src) if relu else src
                    v[:, :cn] = torch.where(ok[:, None], src, torch.zeros(()))
                    halo = torch.zeros(hp * kc)
                    slot = ((k[None, :] // 8) ^ (p_all[:, None] % 8)) * 8 + k[None, :] % 8
                    halo[(p_all[:, None] * kc + slot).reshape(-1)] = v.reshape(-1)
                    for t in range(9):
                        dy, dx = divmod(t, 3)
                        p = (m // tw + dy) * hwd + m % tw + dx
                        a = halo[p[:, None] * kc + ((k[None, :] // 8) ^ (p[:, None] % 8)) * 8
                                 + k[None, :] % 8]
                        off = ((nb * chunks + ch) * 9 + t) * nt * kc
                        acc += a @ wflat[off + b_idx].T
                oh, ow = oh0 + m // tw, ow0 + m % tw
                inside = (oh < h) & (ow < wd)
                cols = slice(nb * nt, min(o, (nb + 1) * nt))
                ncol = cols.stop - cols.start
                out[bi, oh[inside], ow[inside], cols] = acc[inside, :ncol]
                s[bi, cols] += acc[inside, :ncol].sum(0)
                s2[bi, cols] += acc[inside, :ncol].square().sum(0)
    return out, s, s2


@pytest.mark.parametrize("shape,cout,mode", [
    ((2, 9, 13, 72), 80, "reflect"), ((2, 9, 13, 72), 80, "replicate"),
    ((2, 9, 13, 72), 80, "zeros"), ((1, 11, 20, 16), 300, "replicate"),
    ((1, 2, 2, 3), 5, "reflect"), ((1, 18, 17, 64), 16, "zeros"),
])
def test_kernel_walk_equals_plain(shape, cout, mode):
    """The bf16 body's tiling, halo swizzle, chunk/tap order and packed-weight
    indexing, walked in float32, equal conv3x3_fused_plain within f32
    summation order: ragged tiles and channels, two N tiles (300 outputs),
    a partial chunk (16 and 72 inputs) and a 2x2 reflect image."""
    x, w, scale, shift = (torch.from_numpy(a) for a in _inputs(seed=91, shape=shape, cout=cout))
    for sc, sh, relu in ((scale, shift, True), (None, None, False)):
        got = _walk(x, w, sc, sh, mode, relu)
        want = K.conv3x3_fused_plain(x, w, sc, sh, mode, relu, stats=True)
        for g, v in zip(got, want):
            _close(g, v)


@pytest.mark.parametrize("halo", [(1, 0), (0, 1), (1, 1)])
@pytest.mark.parametrize("mode", ["reflect", "replicate", "zeros"])
def test_kernel_walk_with_halo_rows_equals_plain(mode, halo):
    """The bf16 body's index map with halo rows (row y reads x's rows
    y + halo_top + dy - 1, the border mode only at an end without one),
    walked in float32: conv3x3_fused_plain's output and moments over the
    output rows, ragged tiles and a partial chunk (9 + halo rows, 72 in)."""
    x, w, scale, shift = (torch.from_numpy(a) for a in
                          _inputs(seed=92, shape=(1, 9 + sum(halo), 13, 72), cout=80))
    got = _walk(x, w, scale, shift, mode, True, halo)
    want = K.conv3x3_fused_plain(x, w, scale, shift, mode, True, True, *halo)
    assert got[0].shape == want[0].shape == (1, 9, 13, 80)
    for g, v in zip(got, want):
        _close(g, v)
