"""The port's spatial mesh axis (``--spatial_devices``) on the CPU: the 2-D
mesh's layout and ``shard_batch``'s H rule against ``desr_tpu.parallel.mesh``
on the conftest's 8 virtual devices, K1/K2's plain version with halo rows
against the whole frame's rows, and, over two gloo ranks in one launch,
every halo-aware layer, norm, resize and U-Net level the serving nets run,
each rank's band concatenated against the one-process op.

The ranks' functions live in tests/test_torch_spatial_ranks.py, which
imports no JAX.
"""

import jax
import numpy as np
import pytest
import torch

import test_torch_spatial_ranks as R
from test_torch_common import randn  # noqa: F401  (caps torch's threads)

from desr_tpu.parallel import mesh as JM
from desr_tpu_torch import parallel
from desr_tpu_torch.ops import conv3x3 as K
from desr_tpu_torch.parallel import spatial as S
from desr_tpu_torch.parallel.mesh import Mesh, shard_batch


# ----------------------------------------------------------------- layout

@pytest.mark.parametrize("n,s", [(2, 2), (4, 2), (8, 2), (8, 4), (4, 4)])
def test_rank_grid_matches_jax(n, s):
    """rank r is JAX's grid[r // S, r % S] (desr_tpu/parallel/mesh.py:41-43)."""
    devs = jax.devices()[:n]
    grid = np.asarray(JM.make_mesh(devs, spatial=s).devices)
    for r in range(n):
        m = Mesh(tuple(["cpu"] * n), r, spatial=s)
        assert grid[m.data_rank, m.spatial_rank] == devs[r]
        assert (m.data_size, m.data_rank * s + m.spatial_rank) == (n // s, r)


@pytest.mark.parametrize("n,s,b,h", [(2, 2, 2, 64), (4, 2, 4, 64), (4, 2, 3, 64),
                                     (8, 4, 4, 128), (4, 4, 2, 48), (2, 2, 2, 30),
                                     (4, 2, 2, 33)])
def test_shard_batch_h_rule_matches_jax(n, s, b, h):
    """Each rank's block of an image, a planar depth and a small array is the
    one JAX puts on its device: H split when S divides it and H >= 32 and
    the data axis divides the batch, else whole; the Shard records both."""
    rng = np.random.default_rng(0)
    batch = {"img": rng.standard_normal((b, h, 6, 3)).astype(np.float32),
             "depth": rng.standard_normal((b, h, 6)).astype(np.float32),
             "K": rng.standard_normal((b, 3, 3)).astype(np.float32)}
    jmesh = JM.make_mesh(jax.devices()[:n], spatial=s)
    want = JM.shard_batch(batch, jmesh)
    for r in range(n):
        got = shard_batch(batch, Mesh(tuple(["cpu"] * n), r, spatial=s))
        for k in batch:
            by_dev = {sh.device: np.asarray(sh.data) for sh in want[k].addressable_shards}
            np.testing.assert_array_equal(got[k], by_dev[jax.devices()[r]], err_msg=(k, r))
        split = b % (n // s) == 0 and h % s == 0 and h >= 32
        assert got.h_split == split
        if split:
            assert got.h_rows == ((r % s) * h // s, (r % s + 1) * h // s, h)


def test_make_mesh_refuses_an_indivisible_count():
    with pytest.raises(ValueError, match="not divisible by spatial=2"):
        parallel.make_mesh(["cpu"] * 3, spatial=2)


# ----------------------------------------------------------------- K1 / K2

@pytest.mark.parametrize("mode", ["zeros", "reflect", "replicate"])
@pytest.mark.parametrize("variant", ["plain", "stats", "norm+relu+stats", "norm", "k2"])
def test_plain_halo_rows_equal_the_whole_frame_rows(mode, variant):
    """K1/K2's plain version on three bands of a frame, with halo rows
    (1, 0), (1, 1), (0, 1), concatenated: the whole frame's output and,
    summed, its moments; each at f32 within 1e-6 (the moments' sums in
    another order)."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 24, 11, 16)).astype(np.float32))
    w = torch.from_numpy(0.1 * rng.standard_normal((8, 16, 3, 3)).astype(np.float32))
    sc = torch.from_numpy(rng.uniform(0.5, 2, (2, 16)).astype(np.float32))
    sh = torch.from_numpy(rng.standard_normal((2, 16)).astype(np.float32))
    prologue = (sc, sh) if variant.startswith("norm") else (None, None)
    relu, stats = "relu" in variant, variant.endswith("stats")

    def run(v, *halo):
        if variant == "k2":
            return (K.conv3x3(v, w, mode, *halo),)
        res = K.conv3x3_fused(v, w, *prologue, mode, relu, stats, *halo)
        return res if stats else (res,)

    whole = run(x)
    bands = [run(x[:, 0:9], 0, 1), run(x[:, 7:17], 1, 1), run(x[:, 15:24], 1, 0)]
    got = torch.cat([b[0] for b in bands], 1)
    np.testing.assert_allclose(got.numpy(), whole[0].numpy(), rtol=0, atol=1e-6)
    for i in (1, 2)[:len(whole) - 1]:
        s = sum(b[i] for b in bands)
        np.testing.assert_allclose(s.numpy(), whole[i].numpy(), rtol=1e-6,
                                   atol=1e-6 * float(whole[i].abs().max()))


def test_halo_backward_refuses():
    x = torch.randn(1, 6, 5, 4, requires_grad=True)
    w = torch.randn(4, 4, 3, 3)
    out = K.conv3x3_fused(x, w, halo_top=1, halo_bottom=1)
    assert out.shape == (1, 4, 5, 4)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        out.sum().backward()


# ----------------------------------------------------------------- two ranks

@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One launch of two gloo ranks, one spatial group: each rank's outputs
    of every layer, norm and resize on its band of the frame."""
    return parallel.launch(R.spatial_layers, ["cpu", "cpu"], spatial=2,
                           workdir=tmp_path_factory.mktemp("ranks"))


@pytest.fixture(scope="module")
def one_process():
    return R.run_layers()[0]


NAMES = list(R._layers()) + [n + sfx for n in R.RESIZES for sfx in ("", "_planar")]


@pytest.mark.parametrize("name", NAMES)
def test_layer_bands_equal_one_process(two_ranks, one_process, name):
    """The two ranks' bands of a layer's output, concatenated along H: the
    one-process output at f32 within 1e-6 of its largest value (1e-5 for
    the nets: the moments summed in another order, through 6-12 norms). A
    pad alone gives each rank the rows the conv after it reads: its band
    and 2 rows each side, the neighbour's at the seam."""
    want = one_process[name]
    if name == "replicate_pad":
        h = R.FRAME[2] // 2
        for r in range(2):
            np.testing.assert_array_equal(two_ranks[r][0][name], want[:, :, r * h:r * h + h + 4])
        return
    got = np.concatenate([two_ranks[r][0][name] for r in range(2)], axis=-2)
    assert got.shape == want.shape
    tol = 1e-5 if name in ("resnet_generator", "unet") else 1e-6
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1.0))


def test_ranks_issue_the_same_collectives(two_ranks):
    """Both ranks issue the same collectives (a branch that differed would
    have deadlocked the launch): the U-Net's whole levels gather once and
    the norms all-reduce their moments."""
    (_, c0), (_, c1) = two_ranks
    assert c0 == c1
    assert c0["gather"] == 1 and c0["exchange"] > 0 and c0["all_reduce"] > 0


def test_unet_whole_levels_follow_the_global_h_rule():
    """``Spatial.sharded``: split while each of S ranks keeps >= 16 rows."""
    sp = S.Spatial(None, 2, 0)
    assert [sp.sharded(h) for h in (128, 64, 32, 16, 8, 33)] == [True] * 3 + [False] * 3
    sp4 = S.Spatial(None, 4, 3)
    assert [sp4.sharded(h) for h in (128, 64, 32)] == [True, True, False]
