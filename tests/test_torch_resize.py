"""The port's resizes (desr_tpu_torch/ops/resize.py), its cv2 INTER_AREA and
the naive SR dataset against the JAX package (and cv2), float32 on the CPU."""

import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import randn

from desr_tpu.ops import resize as JR
from desr_tpu_torch.ops import resize as TR
from desr_tpu_torch.options import train_options

# (in, out) per axis: up, down, integer and non-integer ratios; 26 -> 22 is
# where a float32 scale (F.interpolate's nearest) reads row 12 for row 11
SIZES = [((16, 20), (32, 40)), ((32, 40), (16, 20)), ((26, 14), (22, 20)),
         ((20, 29), (14, 20)), ((13, 17), (13, 34))]


@pytest.mark.parametrize("mode", ["bicubic", "bilinear", "nearest"])
@pytest.mark.parametrize("sizes", SIZES, ids=lambda s: f"{s[0][0]}x{s[0][1]}-{s[1][0]}x{s[1][1]}")
def test_resize_matches_jax(mode, sizes):
    """NHWC and planar, float32: within 1e-5 of the JAX matrices (nearest:
    equal, it only copies)."""
    (h, w), out = sizes
    x = randn((2, h, w, 3), 1)
    p = randn((2, 4, h, w), 2)
    got = getattr(TR, f"resize_{mode}")(torch.from_numpy(x), out)
    want = getattr(JR, f"resize_{mode}")(jnp.asarray(x), out)
    got_p = getattr(TR, f"resize_{mode}_planar")(torch.from_numpy(p), out)
    want_p = getattr(JR, f"resize_{mode}_planar")(jnp.asarray(p), out)
    atol = 0 if mode == "nearest" else 1e-5
    assert got.shape == want.shape and got_p.shape == want_p.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=0, atol=atol)
    # (B, H, W) planar maps and the cast back to the input's dtype
    got3 = getattr(TR, f"resize_{mode}_planar")(torch.from_numpy(p[:, 0]), out)
    np.testing.assert_allclose(got3.numpy(), np.asarray(want_p)[:, 0], rtol=0, atol=atol)
    bf = getattr(TR, f"resize_{mode}_planar")(torch.from_numpy(p).bfloat16(), out)
    assert bf.dtype == torch.bfloat16


def test_inter_area_matrices_are_the_jax_package_s():
    for mode in ("cv2_area", "cv2_area_up"):
        for n_in, n_out in ((14, 20), (20, 14), (480, 960), (30, 7)):
            np.testing.assert_array_equal(TR.resize_matrix(n_in, n_out, mode),
                                          JR._resize_matrix(n_in, n_out, mode), err_msg=mode)


@pytest.mark.parametrize("shape,out", [
    ((48, 64), (24, 32)), ((48, 64, 3), (30, 40)), ((16, 20, 3), (32, 40)),
    ((15, 21), (40, 50)), ((40, 20, 3), (30, 50)), ((48, 640), (96, 640)),
], ids=["down2x", "down-frac", "up2x", "up-frac", "mixed", "one-axis"])
def test_inter_area_matches_jax_and_cv2(shape, out):
    """HW and HWC float32: within 1e-5 of resize_cv2_inter_area and of
    cv2.resize(INTER_AREA)."""
    from desr_tpu_torch.data import transforms as T

    x = np.random.default_rng(3).uniform(-1, 1, shape).astype(np.float32)
    got = T.resize(x, *out)
    assert got.shape == out + shape[2:] and got.dtype == np.float32
    want = np.asarray(JR.resize_cv2_inter_area(jnp.asarray(x.reshape(1, *shape[:2], -1)), out))
    np.testing.assert_allclose(got, want.reshape(got.shape), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, cv2.resize(x, out[::-1], interpolation=cv2.INTER_AREA),
                               rtol=0, atol=1e-5)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        T.resize(x, *out, interpolation=2)


def _write_folder(root, n=3, hw=(100, 150), seed=0):
    """Scene-named depth/image PNGs for A and B, and their intrinsics."""
    from desr_tpu_torch.data.png import write_png

    rng = np.random.default_rng(seed)
    for dom in ("A", "B"):
        for sub in ("depth", "img"):
            os.makedirs(os.path.join(root, dom, sub), exist_ok=True)
        for i in range(n):
            name = f"scene000{i}_00_{i:04d}.png"
            write_png(os.path.join(root, dom, "depth", name),
                      rng.integers(0, 7000, hw).astype(np.uint16))
            write_png(os.path.join(root, dom, "img", name),
                      rng.integers(0, 256, hw + (3,)).astype(np.uint8))
            kdir = os.path.join(root, "intr", f"scene000{i}_00", "intrinsic")
            os.makedirs(kdir, exist_ok=True)
            np.savetxt(os.path.join(kdir, "intrinsic_depth.txt"),
                       np.diag([570.0 + i, 571.0, 1.0, 1.0]) + np.eye(4, k=2) * 200)


@pytest.mark.parametrize("stage", ["test", "train"])
def test_sr_dataset_items_equal_jax(tmp_path, stage):
    """NaiveSRDataset items (HR depth and image, K_A scaled by SCALE_K, K_B,
    crop boxes, paths) within 1e-6 of the JAX dataset's on the same draws:
    100x150 frames INTER_AREA-zoomed to 960x1280 (fractional blends), padded
    to 1024x1280, and at train time a 256x256 crop."""
    from desr_tpu.data.sr_dataset import NaiveSRDataset as JaxDataset
    from desr_tpu.options.train_options import TrainOptions
    from desr_tpu_torch.data.loader import dataset_for_model
    from desr_tpu_torch.data.sr_dataset import NaiveSRDataset

    _write_folder(str(tmp_path))
    root = str(tmp_path)
    argv = ["--model_type", "main", "--SR", "--name", "d", "--checkpoints_dir",
            str(tmp_path / "ck"), "--crop_size_h", "128", "--crop_size_w", "128",
            "--image_and_depth", "--use_scannet", "--path_to_intr", f"{root}/intr"]
    for suffix in ("", "_test"):
        argv += [f"--path_A{suffix}", f"{root}/A/depth", f"--path_B{suffix}", f"{root}/B/depth",
                 f"--A_add_paths{suffix}", f"{root}/A/img", f"--B_add_paths{suffix}",
                 f"{root}/B/img"]
    opt = train_options.parse(argv, print_options=False)
    assert dataset_for_model(opt) is NaiveSRDataset
    jds = JaxDataset(TrainOptions().parse(argv), stage=stage)
    tds = NaiveSRDataset(opt, stage=stage)
    assert len(jds) == len(tds) == 3
    hr = (256, 256) if stage == "train" else (1024, 1280)
    for i in range(3):
        a, b = jds[i], tds[i]
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-6, err_msg=k)
            else:
                assert a[k] == b[k], k
        assert b["A_d"].shape == hr + (1,) and b["B_i"].shape == hr + (3,)
    if stage == "test":
        np.testing.assert_array_equal(b["crop_A"], [0, 1024, 0, 1280])
        np.testing.assert_array_equal(b["crop_B"], [0, 512, 0, 640])
