"""The port's augmentation against the JAX package, on the CPU: the rotate
(cv2's warpAffine there, numpy here), the crop, flip and jitter draws, the
ColorJitter, and the items of the main dataset without ``--no_aug`` and of
the I2D dataset, on one PNG fixture folder.

The JAX package's host chain calls cv2 (5.0.0 here). Its float warp and its
vector HSV->RGB path round the same float32 operations, fused where the port
fuses them, so the port matches it bit for bit on frames of this suite's
sizes; the bounds below are stated for the rest. cv2 takes the pixels of a
row past its last full vector (64 pixels here) through a scalar path that
rounds otherwise, by up to 1e-6 in the warp and one uint8 step in the hue
round trip: the jitter fixtures are 64 or 128 pixels wide.
"""

import numpy as np
import pytest

from test_torch_common import randn  # noqa: F401  (caps torch's threads)

from desr_tpu.data import transforms as JT
from desr_tpu.data.base_dataset import draw_geo_params as jax_draw_geo_params
from desr_tpu_torch.data import transforms as TT
from desr_tpu_torch.data.base_dataset import draw_geo_params
from desr_tpu_torch.data.png import write_png
from desr_tpu_torch.options import train_options

ANGLES = (-30.0, -29.5, -17.3, 0.0, 0.4, 12.0, 29.99, 30.0)


@pytest.mark.parametrize("shape", [(48, 64), (48, 64, 3), (37, 53, 1), (7, 5), (2, 9, 3),
                                   (384, 512)],
                         ids=["hw", "hwc", "odd_hw1", "tiny", "two_rows", "crop_size"])
def test_rotate_matches_cv2(shape):
    """At each angle, ±30° included, within 1e-5 abs of the JAX package's
    cv2.warpAffine on uniform [-1, 1] float32. At ±30° the corner taps of
    the small frames fold back by REFLECT_101 more than once."""
    img = np.random.default_rng(sum(shape)).uniform(-1, 1, shape).astype(np.float32)
    for angle in ANGLES:
        want = JT.rotate(img, angle).reshape(shape)
        got = TT.rotate(img, angle)
        assert got.shape == shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=f"angle {angle}")


def test_rotate_is_bit_equal_on_a_480x640_frame():
    """On a ScanNet-size frame the float32 warp equals cv2's bit for bit."""
    img = np.random.default_rng(5).uniform(-1, 1, (480, 640, 3)).astype(np.float32)
    for angle in (-30.0, 17.3):
        np.testing.assert_array_equal(TT.rotate(img, angle), JT.rotate(img, angle))


def test_rotate_keeps_values_and_zero_is_identity():
    """No clipping of out-of-range float data; angle 0 is the identity."""
    img = randn((20, 24), 3, 4.0)
    np.testing.assert_array_equal(TT.rotate(img, 0.0), img)
    assert np.abs(TT.rotate(img, 11.0)).max() > 1.0


def test_draws_match_jax():
    """draw_geo_params, random_crop_params and draw_jitter_params take the
    same draws from the same seed, in the same order."""
    for seed in range(30):
        for p_rot in (0.85, 0.9):
            a = jax_draw_geo_params(np.random.default_rng(seed), p_rot, 480, 640, 384, 512)
            b = draw_geo_params(np.random.default_rng(seed), p_rot, 480, 640, 384, 512)
            assert a == b
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        assert JT.random_crop_params(rj, 240, 320, 128, 160) == TT.random_crop_params(
            rt, 240, 320, 128, 160)
        ja, ta = JT.draw_jitter_params(rj), TT.draw_jitter_params(rt)
        assert ja[:4] == ta[:4] and list(ja[4]) == list(ta[4])
        assert rj.uniform() == rt.uniform()  # both streams advanced alike
    img = np.arange(60, dtype=np.float32).reshape(6, 10)
    np.testing.assert_array_equal(TT.crop(img, 2, 3, 3, 4), JT.crop(img, 2, 3, 3, 4))


@pytest.mark.parametrize("op", range(4), ids=["brightness", "contrast", "saturation", "hue"])
def test_each_jitter_op_matches_jax(op):
    """One op at a time on uint8 RGB 60x128: brightness, contrast and
    saturation within 1e-4 (float32, the same numpy expressions), the hue
    round trip bit-equal in uint8 over 20 shifts."""
    rng = np.random.default_rng(op)
    for i in range(20):
        img = rng.integers(0, 256, (60, 128, 3)).astype(np.uint8)
        b, c, s, hshift, _ = TT.draw_jitter_params(rng)
        want = JT.apply_jitter(img, b, c, s, hshift, [op])
        got = TT.apply_jitter(img, b, c, s, hshift, [op])
        if op == 3:
            np.testing.assert_array_equal(got, want, err_msg=f"hue shift {hshift}")
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_color_jitter_matches_jax():
    """The whole jitter, random order, from the same seed: equal values."""
    for seed in range(10):
        img = np.random.default_rng(seed).integers(0, 256, (32, 64, 3)).astype(np.uint8)
        want = JT.color_jitter(np.random.default_rng(seed), img)
        got = TT.color_jitter(np.random.default_rng(seed), img)
        np.testing.assert_array_equal(got, want)


def test_hsv_tables_equal_cv2_everywhere():
    """The uint8 RGB->HSV conversion over all 2^24 colours and HSV->RGB over
    all 180x256x256 inputs equal cv2's (on a frame cv2 converts with its
    vector path only)."""
    cv2 = pytest.importorskip("cv2")
    rgb = np.arange(2 ** 24, dtype=np.uint32)
    rgb = np.stack([rgb >> 16, (rgb >> 8) & 255, rgb & 255], -1).astype(np.uint8)
    rgb = rgb.reshape(4096, 4096, 3)
    x = rgb.astype(np.int32)
    got = np.stack(TT.rgb2hsv_u8(x[..., 0], x[..., 1], x[..., 2]), -1)
    np.testing.assert_array_equal(got, cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))
    hsv = np.stack(np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij"),
                   -1).astype(np.uint8).reshape(180 * 256, 256, 3)
    x = hsv.astype(np.int32)
    got = np.stack(TT.hsv2rgb_u8(x[..., 0], x[..., 1], x[..., 2]), -1)
    np.testing.assert_array_equal(got, cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


# ----------------------------------------------------------------- datasets

def _write_folder(root, n=3, hw=(48, 64), seed=0):
    """Scene-named depth/image PNGs for A and B, and their intrinsics."""
    rng = np.random.default_rng(seed)
    for dom in ("A", "B"):
        for sub in ("depth", "img"):
            (root / dom / sub).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            name = f"scene000{i}_00_{i:04d}.png"
            write_png(root / dom / "depth" / name, rng.integers(0, 7000, hw).astype(np.uint16))
            write_png(root / dom / "img" / name, rng.integers(0, 256, hw + (3,)).astype(np.uint8))
            kdir = root / "intr" / f"scene000{i}_00" / "intrinsic"
            kdir.mkdir(parents=True, exist_ok=True)
            np.savetxt(kdir / "intrinsic_depth.txt", np.diag([570.0 + i, 571.0, 1.0, 1.0]))


def _data_flags(root):
    flags = ["--image_and_depth", "--use_scannet", "--path_to_intr", f"{root}/intr"]
    for suffix in ("", "_test"):
        flags += [f"--path_A{suffix}", f"{root}/A/depth", f"--path_B{suffix}", f"{root}/B/depth",
                  f"--A_add_paths{suffix}", f"{root}/A/img", f"--B_add_paths{suffix}",
                  f"{root}/B/img"]
    return flags


def _assert_items_close(a, b, atol):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=atol, err_msg=k)
        else:
            assert a[k] == b[k], k


def test_main_dataset_augmented_items_match_jax(tmp_path):
    """Without --no_aug: resize to --load_size (INTER_AREA, 48x64 ->
    120x160), rotate with p 0.9, crop 64x96, flip, on the same numpy draws:
    items within 1e-5 of the JAX dataset's (the warp's bound), crop boxes
    [0, 64, 0, 96]. Six items: both gate outcomes and both flips occur."""
    from desr_tpu.data.main_dataset import MainDataset as JaxDataset
    from desr_tpu.options.train_options import TrainOptions
    from desr_tpu_torch.data.main_dataset import MainDataset

    _write_folder(tmp_path, n=6)
    argv = ["--model_type", "main", "--name", "d", "--checkpoints_dir", str(tmp_path / "ck"),
            *_data_flags(tmp_path), "--load_size_h", "120", "--load_size_w", "160",
            "--crop_size_h", "64", "--crop_size_w", "96"]
    jds = JaxDataset(TrainOptions().parse(argv))
    tds = MainDataset(train_options.parse(argv, print_options=False))
    for i in range(6):
        a, b = jds[i], tds[i]
        _assert_items_close(a, b, 1e-5)
        assert b["A_d"].shape == (64, 96, 1) and b["B_i"].shape == (64, 96, 3)
        np.testing.assert_array_equal(b["crop_A"], [0, 64, 0, 96])
    test_item = MainDataset(train_options.parse(argv, print_options=False), stage="test")[0]
    assert test_item["A_d"].shape == (512, 640, 1)
    np.testing.assert_array_equal(test_item["crop_B"], [0, 512, 0, 640])


@pytest.mark.parametrize("stage", ["train", "test"])
def test_i2d_dataset_items_match_jax(tmp_path, stage):
    """48x64 frames: train jitters A's then B's uint8 image, resizes to
    480x640, rotates with p 0.85, crops 384x512 and flips; test pads to
    512x640. The same items as the JAX dataset within 1e-5 (the warp's
    bound; the jitter is bit-equal on 64-wide frames)."""
    from desr_tpu.data.i2d_dataset import I2DDataset as JaxDataset
    from desr_tpu.options.train_options import TrainOptions
    from desr_tpu_torch.data.i2d_dataset import I2DDataset
    from desr_tpu_torch.data.loader import dataset_for_model

    _write_folder(tmp_path, n=2)
    argv = ["--model_type", "I2D", "--name", "d", "--checkpoints_dir", str(tmp_path / "ck"),
            *_data_flags(tmp_path)]
    opt = train_options.parse(argv, print_options=False)
    assert dataset_for_model(opt) is I2DDataset
    jds = JaxDataset(TrainOptions().parse(argv), stage=stage)
    tds = I2DDataset(opt, stage=stage)
    hw = (384, 512) if stage == "train" else (512, 640)
    for i in range(2):
        a, b = jds[i], tds[i]
        _assert_items_close(a, b, 1e-5)
        assert b["A_i"].shape == hw + (3,) and b["B_d"].shape == hw + (1,)
