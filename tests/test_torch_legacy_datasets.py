"""The port's legacy CycleGAN datasets, cv2's INTER_CUBIC and the
``--dataset_mode`` registry on the CPU, against the JAX package's
``desr_tpu/data/legacy_datasets.py`` (which resizes through cv2) on the same
folders, options and indices.

cv2 hands a float INTER_CUBIC resize to IPP by default, and IPP's sums differ
from cv2's own float code by up to 1.1e-3 on 0..255 (4.4e-6 of the range;
after the datasets' normalisation up to 4.7e-6). The port follows cv2's own
code, so the dataset items are held with IPP off (``no_ipp``), within 1e-6;
the resize itself is held to cv2 both ways."""

import os
from types import SimpleNamespace

import cv2
import numpy as np
import pytest

from desr_tpu_torch.data import png
from desr_tpu_torch.data import transforms as T


def _write_folder(root, n, hw, seed, kind="rgb"):
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        if kind == "depth":
            arr = rng.integers(0, 9000, hw).astype(np.uint16)
        else:
            arr = rng.integers(0, 256, hw + (3,)).astype(np.uint8)
        png.write_png(os.path.join(root, f"f{i:02d}.png"), arr)


def _opt(root, **kw):
    base = dict(dataroot=str(root), phase="train", max_dataset_size=2 ** 31, seed=5,
                preprocess="resize_and_crop", load_size=48, crop_size=32, no_flip=False,
                serial_batches=False, custom_pathes=False, image_and_depth=False, take=0,
                uint16=False, direction="AtoB", input_nc=3, output_nc=3)
    return SimpleNamespace(**{**base, **kw})


CASES = {
    "unaligned_resize_and_crop": ("unaligned", {}),
    "unaligned_scale_width": ("unaligned", dict(preprocess="scale_width")),
    "unaligned_scale_width_and_crop": ("unaligned", dict(preprocess="scale_width_and_crop")),
    "unaligned_none": ("unaligned", dict(preprocess="none")),
    "unaligned_serial_no_flip": ("unaligned", dict(serial_batches=True, no_flip=True)),
    "unaligned_uint16": ("unaligned", dict(uint16=True)),
    "unaligned_image_and_depth": ("unaligned", dict(image_and_depth=True)),
    "unaligned_take": ("unaligned", dict(take=2)),
    "aligned_crop": ("aligned", dict(preprocess="crop")),
    "aligned_btoa_grey": ("aligned", dict(direction="BtoA", output_nc=1)),
    "single": ("single", dict(preprocess="none")),
    "template": ("template", {}),
}


def _dataroot(tmp_path, mode, kw):
    """Frames of 42x58 (no side a multiple of 4), for each mode's layout."""
    hw = (42, 58)
    if mode == "unaligned":
        depth = kw.get("uint16") or kw.get("image_and_depth")
        for d, seed in (("trainA", 1), ("trainB", 2)):
            _write_folder(tmp_path / d, 4, hw, seed, "depth" if depth else "rgb")
        if kw.get("image_and_depth"):
            _write_folder(tmp_path / "addA", 4, hw, 3)
            _write_folder(tmp_path / "addB", 4, hw, 4)
            kw = dict(kw, A_add_paths=str(tmp_path / "addA"), B_add_paths=str(tmp_path / "addB"))
        return _opt(tmp_path, **kw)
    if mode == "aligned":
        _write_folder(tmp_path / "train", 3, (42, 116), 5)
        return _opt(tmp_path, **kw)
    _write_folder(tmp_path / "imgs", 3, hw, 6)
    return _opt(tmp_path / "imgs", **kw)


@pytest.fixture
def no_ipp():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


@pytest.mark.parametrize("case", sorted(CASES))
def test_items_match_jax(tmp_path, case, no_ipp):
    """Every item of the port's class equals the JAX class's for the same opt,
    folder and index (each draws from SeedSequence([seed, index])): arrays
    within 1e-6, the paths equal."""
    from desr_tpu.data import legacy_datasets as J
    from desr_tpu_torch.data import find_dataset_using_name

    mode, kw = CASES[case]
    opt = _dataroot(tmp_path, mode, kw)
    got = find_dataset_using_name(mode)(opt)
    want = J.find_dataset_using_name(mode)(opt)
    assert type(got).__name__ == type(want).__name__ and len(got) == len(want) > 0
    for i in range(len(got)):
        a, b = got[i], want[i]
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(b[k], np.ndarray):
                assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6, err_msg=f"{i} {k}")
            else:
                assert a[k] == b[k], k


@pytest.mark.parametrize("shape,out", [
    ((37, 51), (256, 256)), ((300, 400, 3), (256, 256)), ((64, 80, 3), (29, 31)),
    ((20, 20, 4), (40, 60)), ((33, 17), (33, 64)), ((48, 64), (24, 64)),
], ids=["up", "down-hwc", "down-frac", "up-frac", "one-axis-up", "one-axis-down"])
def test_inter_cubic_matches_cv2(shape, out):
    """float32 HW and HWC, up and down: within 1e-5 of the input's range of
    cv2.resize(INTER_CUBIC) as cv2 runs by default (through IPP), and within
    1e-7 of it with IPP off (cv2's own float code, whose operations the port
    repeats: bit-equal but for 1-ulp differences in a few downscaled pixels)."""
    x = np.random.default_rng(7).uniform(-3, 5, shape).astype(np.float32)
    got = T.resize(x, *out, interpolation=T.INTER_CUBIC)
    assert got.shape == out + shape[2:] and got.dtype == np.float32
    span = x.max() - x.min()
    was = cv2.ipp.useIPP()
    try:
        for ipp, tol in ((True, 1e-5), (False, 1e-7)):
            cv2.ipp.setUseIPP(ipp)
            want = cv2.resize(x, out[::-1], interpolation=cv2.INTER_CUBIC)
            np.testing.assert_allclose(got, want, rtol=0, atol=tol * span, err_msg=f"IPP {ipp}")
    finally:
        cv2.ipp.setUseIPP(was)


def test_registry_resolves_all_eight_names():
    from desr_tpu.data import legacy_datasets as J
    from desr_tpu_torch.data import find_dataset_using_name

    names = ["unaligned", "aligned", "single", "template",
             "my_i2d", "my_main", "my_naive_sr", "translation"]
    for n in names:
        assert find_dataset_using_name(n).__name__ == J.find_dataset_using_name(n).__name__
    with pytest.raises(NotImplementedError, match="not registered"):
        find_dataset_using_name("nope")


def test_template_dataset_option_parses():
    """--dataset_mode template adds --new_dataset_option through the dataset's
    hook (base_options.py:247-253); without it the flag is unknown."""
    from desr_tpu_torch.options import train_options

    opt = train_options.parse(["--dataset_mode", "template", "--new_dataset_option", "2",
                               "--device", "cpu"], print_options=False)
    assert opt.new_dataset_option == 2.0
    assert train_options.parse(["--dataset_mode", "template"],
                               print_options=False).new_dataset_option == 1.0
    with pytest.raises(SystemExit):
        train_options.parse(["--new_dataset_option", "2"], print_options=False)
