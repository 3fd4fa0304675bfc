"""``data/transforms.py:resize`` at cv2's INTER_NEAREST (0) and INTER_LINEAR
(1) against ``cv2.resize`` and the JAX package's ``transforms.resize``
(which calls cv2), float32 HW and HWC on the CPU."""

import cv2
import numpy as np
import pytest

from desr_tpu.data import transforms as JT
from desr_tpu_torch.data import transforms as TT

# (in HW, out HW): up and down, integer and non-integer ratios, one axis
SHAPES = [((16, 20), (32, 40)), ((48, 64), (24, 32)), ((15, 21), (40, 50)),
          ((48, 64), (30, 40)), ((40, 20), (30, 50)), ((26, 14), (22, 20)),
          ((13, 17), (13, 34)), ((7, 9), (1, 5))]
IDS = ["up2x", "down2x", "up-frac", "down-frac", "mixed", "26to22", "one-axis", "to-one-row"]


def _frames(hw, seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, hw).astype(np.float32),
            rng.uniform(-1, 1, hw + (3,)).astype(np.float32)]


@pytest.mark.parametrize("hw,out", SHAPES, ids=IDS)
def test_nearest_is_cv2_bit_for_bit(hw, out):
    """INTER_NEAREST: cv2's index rule floor(j * (1 / (out / in))) exactly,
    so the values equal cv2's and the JAX package's bit for bit."""
    for x in _frames(hw, 0):
        got = TT.resize(x, *out, interpolation=TT.INTER_NEAREST)
        assert got.shape == out + x.shape[2:] and got.dtype == np.float32
        np.testing.assert_array_equal(
            got, cv2.resize(x, out[::-1], interpolation=cv2.INTER_NEAREST))
        np.testing.assert_array_equal(got, JT.resize(x, *out, 0))


@pytest.mark.parametrize("hw,out", SHAPES, ids=IDS)
def test_linear_matches_cv2_and_jax(hw, out):
    """INTER_LINEAR: within 1e-5 of cv2 as it runs by default (its IPP path)
    and of the JAX package; within 1e-7 of cv2's own float code (IPP off),
    whose order of operations the port repeats (bit-equal but for 1 ulp at
    a 2x downscale, where cv2 takes its area path)."""
    was = cv2.ipp.useIPP()
    try:
        for x in _frames(hw, 1):
            got = TT.resize(x, *out, interpolation=TT.INTER_LINEAR)
            assert got.shape == out + x.shape[2:] and got.dtype == np.float32
            np.testing.assert_allclose(got, JT.resize(x, *out, 1), rtol=0, atol=1e-5)
            for ipp, tol in ((True, 1e-5), (False, 1e-7)):
                cv2.ipp.setUseIPP(ipp)
                want = cv2.resize(x, out[::-1], interpolation=cv2.INTER_LINEAR)
                np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=f"IPP {ipp}")
    finally:
        cv2.ipp.setUseIPP(was)


def test_linear_clamps_the_edges():
    """Half-pixel centres and the edge clamp: a 2 -> 4 upscale of [a, b]
    gives [a, 0.75 a + 0.25 b, 0.25 a + 0.75 b, b] along a row and down a
    column."""
    x = np.array([[1.0, 3.0]], np.float32)
    want = np.array([1.0, 1.5, 2.5, 3.0], np.float32)
    np.testing.assert_allclose(TT.resize(x, 1, 4, TT.INTER_LINEAR)[0], want, rtol=0, atol=1e-7)
    np.testing.assert_allclose(TT.resize(x.T.copy(), 4, 1, TT.INTER_LINEAR)[:, 0], want,
                               rtol=0, atol=1e-7)
