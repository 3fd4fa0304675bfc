"""The JAX package's helpers that no model or CLI reaches, against their
counterparts in the port, float32 on the CPU: ``masked_mean_dif``,
``masked_signed_mean``, MeanMatching (``mean_matching_shift``), the
``compat_bug`` denominators of the masked cosine loss, and the numpy display
helpers ``get_normals`` and ``tensor2im_rgb``.

The JAX side runs NHWC where its helper sums over axes 1-3, the port NCHW;
both packages get the same numpy inputs, made from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import nhwc_to_nchw, randn

from desr_tpu.ops import losses as JLS
from desr_tpu.utils import plots as JP
from desr_tpu_torch.ops import losses as L
from desr_tpu_torch.utils import plots as P

# a float32 sum in another order: relative gaps of a few 1e-7
REL = 1e-6


def _depth_pair(seed, shape=(2, 16, 20, 1)):
    """Two [-1, 1] depth maps with holes at exactly -1 and pixels near 1,
    so the shift meets both its mask and its clamp; and a 0/1 mask."""
    rng = np.random.default_rng(seed)
    real, fake = (np.clip(rng.uniform(-1.2, 1.1, shape), -1.0, 1.0).astype(np.float32)
                  for _ in range(2))
    mask = (rng.uniform(size=shape) > 0.3).astype(np.float32)
    return real, fake, mask


def _close(got, want, rel=REL):
    got, want = float(got), float(want)
    assert abs(got - want) <= rel * abs(want), (got, want)


@pytest.mark.parametrize("name", ["masked_mean_dif", "masked_signed_mean"])
def test_masked_means_match_jax(name):
    """NHWC in JAX against NCHW in the port, within 1e-6 relative."""
    shape = (3, 12, 16, 2)
    x, y = randn(shape, seed=1), randn(shape, seed=2)
    mask = (np.random.default_rng(3).uniform(size=shape) > 0.4).astype(np.float32)
    want = getattr(JLS, name)(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask))
    got = getattr(L, name)(nhwc_to_nchw(x), nhwc_to_nchw(y), nhwc_to_nchw(mask))
    assert got.dtype == torch.float32 and got.dim() == 0
    _close(got, want)


def test_masked_mean_dif_refuses_planar_maps_in_both_packages():
    """Stage 2's (B, H, W) depth maps: JAX's sum over axes 1-3 raises, and
    the port raises the same error type."""
    x, y, mask = _depth_pair(4, (2, 16, 20))
    with pytest.raises(ValueError):
        JLS.masked_mean_dif(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask))
    with pytest.raises(ValueError):
        L.masked_mean_dif(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask))


@pytest.mark.parametrize("direction", ["A2B", "B2A"])
def test_mean_matching_with_jax_draw_is_bit_equal(direction):
    """JAX's own draw, given to the port's post-draw part: equal bit for bit."""
    real, fake, _ = _depth_pair(5)
    key, mu = jax.random.PRNGKey(7), 0.4
    want = JLS.mean_matching_shift(key, jnp.asarray(real), jnp.asarray(fake), direction, mu)
    shift = jax.random.uniform(key, (), minval=0.0, maxval=mu)
    got = L.mean_matching_apply(torch.from_numpy(real), torch.from_numpy(fake), direction,
                                torch.tensor(np.asarray(shift)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    moved = got[1] if direction == "A2B" else got[0]
    assert float((moved - torch.from_numpy(fake if direction == "A2B" else real)).max()) > 0


@pytest.mark.parametrize("direction", ["A2B", "B2A"])
def test_mean_matching_own_draw(direction):
    """The port's draw lies in [0, mu), repeats from the same seed, differs
    from another, and leaves the other side untouched."""
    real, fake, _ = _depth_pair(6)
    real, fake = torch.from_numpy(real), torch.from_numpy(fake)
    mu = 0.3

    def run(seed):
        return L.mean_matching_shift(torch.Generator().manual_seed(seed), real, fake,
                                     direction, mu)

    shift = torch.rand((), generator=torch.Generator().manual_seed(11)) * mu
    assert 0.0 <= float(shift) < mu
    first, again, other = run(11), run(11), run(12)
    kept, moved = (0, 1) if direction == "A2B" else (1, 0)
    assert first[kept] is (real, fake)[kept]
    want = L.mean_matching_apply(real, fake, direction, shift)
    assert torch.equal(first[moved], want[moved]) and torch.equal(again[moved], first[moved])
    assert not torch.equal(other[moved], first[moved])
    src = (real, fake)[moved]
    valid = src > -1.0
    assert torch.equal(first[moved][~valid], src[~valid])
    step = (first[moved] - src)[valid & (first[moved] < 1.0)]
    assert float(step.min()) >= 0.0 and float(step.max()) < mu


def test_mean_matching_refuses_another_direction_in_both_packages():
    real, fake, _ = _depth_pair(8)
    with pytest.raises(NotImplementedError, match="Specify direction"):
        JLS.mean_matching_shift(jax.random.PRNGKey(0), jnp.asarray(real), jnp.asarray(fake),
                                "AtoB", 0.3)
    with pytest.raises(NotImplementedError, match="Specify direction"):
        L.mean_matching_shift(torch.Generator().manual_seed(0), torch.from_numpy(real),
                              torch.from_numpy(fake), "AtoB", 0.3)


@pytest.mark.parametrize("compat_bug", [True, False])
def test_masked_cos_sim_loss_planar_denominators_match_jax(compat_bug):
    """sum(mask) + 1e6 (the reference's shipped constant) and + 1e-6, each
    within 1e-6 relative of JAX's."""
    shape = (2, 3, 16, 20)
    x, y = randn(shape, seed=9), randn(shape, seed=10)
    mask = np.repeat(np.random.default_rng(11).uniform(size=(2, 1, 16, 20)) > 0.3, 3, 1)
    want = JLS.masked_cos_sim_loss_planar(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask),
                                          compat_bug=compat_bug)
    got = L.masked_cos_sim_loss_planar(torch.from_numpy(x), torch.from_numpy(y),
                                       torch.from_numpy(mask), compat_bug=compat_bug)
    _close(got, want)
    if not compat_bug:  # the intended mean, not 1e-6 of it
        assert float(got) > 0.1


def test_display_helpers_are_bit_equal_to_jax():
    """``get_normals`` on a random depth map and ``tensor2im_rgb`` on a batch:
    the same numpy code, the same bits."""
    depth = np.random.default_rng(12).uniform(0.5, 4.0, (24, 32)).astype(np.float32)
    np.testing.assert_array_equal(P.get_normals(depth), JP.get_normals(depth))
    rgb = randn((2, 8, 10, 3), seed=13)
    np.testing.assert_array_equal(P.tensor2im_rgb(rgb), JP.tensor2im_rgb(rgb))
