"""``--device_aug`` in the port against the JAX package, on the CPU: the
three-shear warp with crop and flip, ColorJitter, INTER_AREA on tensors, the
SR finisher, each dataset's item plus ``device_finish``, and one
``train --device_aug --device cpu`` step each for main, ``--SR`` and I2D.

Bounds (those of tests/test_device_aug.py): angle 0, crop and flip bit-exact;
rotated noise frames within ROT_TOL = 2e-3 (float32 tan and sin of the two
packages may differ by an ulp, and an ulp of a 70-pixel shift moves a noise
pixel by ~1e-5), smooth frames within 1e-5; ColorJitter on the 0-255 scale
at most 10 off, above 1 on under 1e-4 of the values and above 1e-3 on under
2e-3 (the contrast mean's float32 summation order can flip the hue's uint8
truncation); INTER_AREA and the SR finisher within 1e-5.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import randn  # noqa: F401  (caps torch's threads)

from desr_tpu.data.loader import collate as jax_collate
from desr_tpu.ops import device_aug as JA
from desr_tpu.ops.resize import resize_cv2_inter_area as jax_inter_area
from desr_tpu.options.train_options import TrainOptions
from desr_tpu_torch.data import loader as TL
from desr_tpu_torch.data.png import write_png
from desr_tpu_torch.ops import device_aug as TA
from desr_tpu_torch.ops.resize import resize_cv2_inter_area
from desr_tpu_torch.options import train_options

ROT_TOL = 2e-3
SMOOTH_TOL = 1e-5
ANGLES = (0.0, 7.5, -7.5, 30.0, -30.0)


def _noise(shape, seed):
    # out-of-range values too: the clip after the warp is part of the chain
    return np.random.default_rng(seed).uniform(-1.3, 1.3, shape).astype(np.float32)


def _smooth(h, w, c=4):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.stack([np.sin(0.031 * xx + 0.4 * k) * np.cos(0.023 * yy - 0.3 * k)
                     for k in range(c)], -1).astype(np.float32)


def _jax_warp(frames, params, oh, ow):
    return np.stack([np.asarray(JA.warp_affine_crop(f, *p, oh, ow))
                     for f, p in zip(frames, params)])


@pytest.mark.parametrize("hw", [(48, 64), (480, 640)], ids=["48x64", "480x640"])
def test_paeth_rotate_matches_jax(hw):
    """Every angle of ANGLES on a noise stack (four 48x64 frames, or one
    480x640x4 frame); angle 0 bit-exact. A smooth 480x640 frame within 1e-5."""
    n = 4 if hw == (48, 64) else 1
    for angle in ANGLES:
        src = _noise((n,) + hw + (4,), seed=int(abs(angle) * 10) + hw[0])
        got = TA.paeth_rotate(torch.from_numpy(src), torch.full((n,), angle)).numpy()
        want = np.stack([np.asarray(JA.paeth_rotate(f, np.float32(angle))) for f in src])
        assert got.shape == want.shape and got.dtype == np.float32
        if angle == 0.0:
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, src)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=ROT_TOL, err_msg=str(angle))
    smooth = _smooth(480, 640)
    for angle in (30.0, -7.5):
        got = TA.paeth_rotate(torch.from_numpy(smooth[None]), torch.tensor([angle])).numpy()[0]
        want = np.asarray(JA.paeth_rotate(smooth, np.float32(angle)))
        np.testing.assert_allclose(got, want, rtol=0, atol=SMOOTH_TOL, err_msg=str(angle))


def test_warp_batch_crop_flip_and_rotation_match_jax():
    """warp_affine_crop on six 48x64 noise frames, one row each: angle 0 with and
    without the flip bit-exact (crops reaching the frame's last row and
    column), rotated rows with crop and flip within ROT_TOL."""
    src = _noise((6, 48, 64, 4), seed=3)
    params = np.array([[0.0, 0, 0, 0.0], [0.0, 16, 32, 1.0], [0.0, 7, 3, 1.0],
                       [7.5, 16, 32, 1.0], [-30.0, 5, 11, 0.0], [30.0, 0, 32, 1.0]], np.float32)
    got = TA.warp_affine_crop(torch.from_numpy(src), torch.from_numpy(params), 32, 32).numpy()
    want = _jax_warp(src, params, 32, 32)
    assert got.shape == (6, 32, 32, 4)
    np.testing.assert_array_equal(got[:3], want[:3])
    np.testing.assert_array_equal(got[1], src[1, 16:48, 32:64][:, ::-1])
    np.testing.assert_allclose(got[3:], want[3:], rtol=0, atol=ROT_TOL)


def _jitter_gaps(got, want):
    d = np.abs(got - want)
    return d.max(), (d > 1.0).mean(), (d > 1e-3).mean()


def test_color_jitter_device_matches_jax():
    """Six 120x160 uint8 frames with the draws of seeds 0-5 in one batch
    (every op order differs, so each round splits the batch into runs of
    several ops), against JAX's per-frame jitter: max <= 10, above 1 on
    < 1e-4, above 1e-3 on < 2e-3 of the values."""
    from desr_tpu.data.transforms import draw_jitter_params

    imgs = np.random.default_rng(3).integers(0, 256, (6, 120, 160, 3)).astype(np.float32)
    rows = [draw_jitter_params(np.random.default_rng(s)) for s in range(6)]
    factors = np.array([r[:4] for r in rows], np.float32)
    order = np.array([r[4] for r in rows], np.int64)
    sizes = TA.jitter_round_sizes(order)
    assert all(sum(n > 0 for n in r) >= 2 for r in sizes) and all(sum(r) == 6 for r in sizes)
    got = TA.color_jitter_device(torch.from_numpy(imgs), torch.from_numpy(factors),
                                 torch.from_numpy(order), sizes).numpy()
    want = np.stack([np.asarray(JA.color_jitter_device(
        jnp.asarray(i), jnp.asarray(f), jnp.asarray(o, jnp.int32)))
        for i, f, o in zip(imgs, factors, order)])
    dmax, above1, above_eps = _jitter_gaps(got, want)
    assert dmax <= 10.0 and above1 < 1e-4 and above_eps < 2e-3, (dmax, above1, above_eps)


@pytest.mark.parametrize("src_hw,dst_hw", [((968, 1296), (960, 1280)), ((480, 640), (960, 1280)),
                                           ((37, 53), (24, 40)), ((24, 40), (50, 60))],
                         ids=["area_scannet_colour", "up_scannet_depth", "area", "up"])
def test_resize_cv2_inter_area_matches_jax(src_hw, dst_hw):
    """Both branches of cv2's INTER_AREA (area decimation; the zoom
    coefficients) at ScanNet's colour and depth geometries and two small
    ones, within 1e-5."""
    x = np.random.default_rng(sum(src_hw)).uniform(-1, 1, (2,) + src_hw + (3,)).astype(np.float32)
    got = resize_cv2_inter_area(torch.from_numpy(x), dst_hw).numpy()
    want = np.asarray(jax_inter_area(jnp.asarray(x), dst_hw))
    assert got.shape == (2,) + dst_hw + (3,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("depth_dtype", [np.int32, np.float32])
def test_sr_finisher_matches_jax(depth_dtype):
    """sr_finish_stack, A's and B's, at a cut geometry (load 60x80, pad 64x96, crop
    40x48): 62x84 uint8 images (the area branch), 30x40 depths (the zoom
    branch), mm int32 or float (the < 0.33 tail zeroed), crops reaching into
    the reflected pad on every side; within 1e-5."""
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, (2, 2, 62, 84, 3)).astype(np.uint8)
    depth = rng.uniform(0, 7000, (2, 2, 30, 40))
    depth[..., :3, :] = rng.uniform(0, 0.5, (2, 2, 3, 40))
    depth = depth.astype(depth_dtype)
    offs = np.array([[[0, 0], [24, 48]], [[2, 30], [11, 5]]], np.int32)
    args = [(imgs[d], depth[d], offs[d]) for d in range(2)]
    flat = [a for dom in args for a in dom]
    got = TA.model_inputs(*(TA.sr_finish_stack(*map(torch.from_numpy, dom), (60, 80), (64, 96),
                                               (40, 48)) for dom in args))
    want = JA.make_sr_finisher(60, 80, 64, 96, 40, 48)(*flat)
    for k in ("A_i", "A_d", "B_i", "B_d"):
        assert got[k].shape == tuple(want[k].shape) and got[k].is_contiguous(), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-5,
                                   err_msg=k)


# ----------------------------------------------------------------- datasets

def _write_folder(root, n, hw, b_hw=None, seed=0):
    """Scene-named depth/image PNGs for A (hw) and B (b_hw, default hw), and
    their intrinsics."""
    rng = np.random.default_rng(seed)
    for dom, shape in (("A", hw), ("B", b_hw or hw)):
        for sub in ("depth", "img"):
            os.makedirs(os.path.join(root, dom, sub), exist_ok=True)
        for i in range(n):
            name = f"scene000{i}_00_{i:04d}.png"
            write_png(os.path.join(root, dom, "depth", name),
                      rng.integers(0, 7000, shape).astype(np.uint16))
            write_png(os.path.join(root, dom, "img", name),
                      rng.integers(0, 256, shape + (3,)).astype(np.uint8))
            kdir = os.path.join(root, "intr", f"scene000{i}_00", "intrinsic")
            os.makedirs(kdir, exist_ok=True)
            np.savetxt(os.path.join(kdir, "intrinsic_depth.txt"), np.diag([570.0 + i, 571, 1, 1]))


def _data_flags(root):
    flags = ["--image_and_depth", "--use_scannet", "--path_to_intr", f"{root}/intr"]
    for suffix in ("", "_test"):
        flags += [f"--path_A{suffix}", f"{root}/A/depth", f"--path_B{suffix}", f"{root}/B/depth",
                  f"--A_add_paths{suffix}", f"{root}/A/img", f"--B_add_paths{suffix}",
                  f"{root}/B/img"]
    return flags


def _finished_pair(jax_cls, port_cls, argv, n):
    """The first n items of each package's dataset under --device_aug, as one
    collated batch through its device_finish (the port's on CPU tensors)."""
    jds = jax_cls(TrainOptions().parse(argv), stage="train")
    tds = port_cls(train_options.parse(argv, print_options=False), stage="train")
    assert jds.device_aug_active() and tds.device_aug_active()
    jitems, titems = [jds[i] for i in range(n)], [tds[i] for i in range(n)]
    for a, b in zip(jitems, titems):  # the host halves: the same draws and arrays
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-5, err_msg=k)
            else:
                assert a[k] == b[k], k
    want = jds.device_finish(jax_collate(jitems))
    got = tds.device_finish(TL.collate_tensors(titems), "cpu")
    assert set(got) == set(want)
    return ({k: v.numpy() if torch.is_tensor(v) else v for k, v in got.items()},
            {k: np.asarray(v) if hasattr(v, "shape") else v for k, v in want.items()})


def test_main_dataset_device_aug_matches_jax(tmp_path, monkeypatch):
    """Six items of 48x64 frames, resized to 120x160 and cropped 64x96: the
    host halves equal JAX's (stacks within 1e-5, the resize's bound; the same
    parameter rows), and the finished batch equals JAX's within ROT_TOL; the
    unrotated frames are the crop and flip of their stack bit for bit, and
    JAX's within 1e-5; K and crop boxes ride through."""
    from desr_tpu.data.main_dataset import MainDataset as JaxDataset
    from desr_tpu_torch.data.main_dataset import MainDataset

    # the items' generators take the process id: this one's draws leave two
    # of the twelve frames unrotated (B of item 3, A of item 4)
    monkeypatch.setattr(os, "getpid", lambda: 1001)
    _write_folder(str(tmp_path), n=6, hw=(48, 64))
    argv = ["--model_type", "main", "--name", "d", "--checkpoints_dir", str(tmp_path / "ck"),
            *_data_flags(tmp_path), "--load_size_h", "120", "--load_size_w", "160",
            "--crop_size_h", "64", "--crop_size_w", "96", "--device_aug"]
    got, want = _finished_pair(JaxDataset, MainDataset, argv, 6)
    tds = MainDataset(train_options.parse(argv, print_options=False))
    items = [tds[i] for i in range(6)]
    unrotated = [(d, i) for i in range(6) for d in "AB" if items[i][f"{d}_aug"][0] == 0]
    assert unrotated == [("B", 3), ("A", 4)]
    for d, i in unrotated:
        _, cy, cx, flip = items[i][f"{d}_aug"].astype(int)
        crop = np.clip(items[i][f"{d}_full"][cy:cy + 64, cx:cx + 96], -1, 1)
        crop = crop[:, ::-1] if flip else crop
        np.testing.assert_array_equal(got[f"{d}_i"][i], crop[..., :3])
        np.testing.assert_array_equal(got[f"{d}_d"][i], crop[..., 3:])
        for k in (f"{d}_i", f"{d}_d"):
            np.testing.assert_allclose(got[k][i], want[k][i], rtol=0, atol=1e-5, err_msg=k)
    for k in ("A_i", "A_d", "B_i", "B_d", "K_A", "K_B", "crop_A", "crop_B"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ROT_TOL, err_msg=k)
    assert got["A_d"].shape == (6, 64, 96, 1) and got["B_i"].shape == (6, 64, 96, 3)
    assert np.abs(got["A_i"]).max() <= 1.0


def test_i2d_dataset_device_aug_matches_jax(tmp_path):
    """Two items: A frames at the load size 480x640 (the card jitters them,
    enable 1), B frames 48x64 (jittered on the host before the resize, enable
    0). Depths within ROT_TOL; images within the jitter's bounds on the 0-255
    scale, each widened by ROT_TOL * 127.5 for the warp."""
    from desr_tpu.data.i2d_dataset import I2DDataset as JaxDataset
    from desr_tpu_torch.data.i2d_dataset import I2DDataset

    _write_folder(str(tmp_path), n=2, hw=(480, 640), b_hw=(48, 64))
    argv = ["--model_type", "I2D", "--name", "d", "--checkpoints_dir", str(tmp_path / "ck"),
            *_data_flags(tmp_path), "--device_aug"]
    tds = I2DDataset(train_options.parse(argv, print_options=False))
    item = tds[0]
    assert item["A_jit"][8] == 1.0 and item["B_jit"][8] == 0.0
    got, want = _finished_pair(JaxDataset, I2DDataset, argv, 2)
    for k in ("A_d", "B_d"):
        assert got[k].shape == want[k].shape == (2, 384, 512, 1), k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ROT_TOL, err_msg=k)
    warp = ROT_TOL * 127.5
    for k in ("A_i", "B_i"):
        assert got[k].shape == want[k].shape == (2, 384, 512, 3), k
        d = np.abs(got[k] - want[k]) * 127.5
        assert d.max() <= 10.0 + warp and (d > 1.0 + warp).mean() < 1e-4 \
            and (d > 1e-3 + warp).mean() < 2e-3, (k, d.max())


def test_sr_dataset_device_aug_matches_jax(tmp_path):
    """Two items of 48x64 frames through NaiveSRDataset under --device_aug
    (crop 128x160: HR 256x320 of the 1024x1280 canvas): the decoded frames
    and offsets equal JAX's, the finished batch within 1e-5; K_A scaled and
    the crop boxes carry the offsets."""
    from desr_tpu.data.sr_dataset import NaiveSRDataset as JaxDataset
    from desr_tpu_torch.data.sr_dataset import NaiveSRDataset

    _write_folder(str(tmp_path), n=2, hw=(48, 64))
    argv = ["--model_type", "main", "--SR", "--name", "d", "--checkpoints_dir",
            str(tmp_path / "ck"), *_data_flags(tmp_path), "--crop_size_h", "128",
            "--crop_size_w", "160", "--device_aug"]
    got, want = _finished_pair(JaxDataset, NaiveSRDataset, argv, 2)
    for k in ("A_i", "A_d", "B_i", "B_d", "K_A", "K_B", "crop_A", "crop_B"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
    assert got["A_d"].shape == (2, 256, 320, 1)


def test_no_aug_and_test_stage_keep_the_host_path(tmp_path):
    """--device_aug --no_aug (main) ships finished items and create_dataset
    gives the plain loader, as does the test stage; the loader needs the
    device when the dataset ships device halves."""
    from desr_tpu_torch.data.main_dataset import MainDataset

    _write_folder(str(tmp_path), n=2, hw=(48, 64))
    argv = ["--model_type", "main", "--name", "d", "--checkpoints_dir", str(tmp_path / "ck"),
            *_data_flags(tmp_path), "--device_aug", "--num_threads", "0"]
    no_aug = train_options.parse(argv + ["--no_aug"], print_options=False)
    item = MainDataset(no_aug)[0]
    assert "A_full" not in item and item["A_i"].shape == (512, 640, 3)
    assert not isinstance(TL.create_dataset(no_aug, MainDataset, device="cpu"), TL.DeviceLoader)
    opt = train_options.parse(argv, print_options=False)
    assert not isinstance(TL.create_dataset(opt, MainDataset, stage="test"), TL.DeviceLoader)
    with pytest.raises(ValueError, match="device"):
        TL.create_dataset(opt, MainDataset)
    loader = TL.create_dataset(opt, MainDataset, device="cpu")
    assert isinstance(loader, TL.DeviceLoader) and len(loader.dataset) == 2
    batch = next(iter(loader))
    assert batch["A_i"].shape == (1, 384, 512, 3) and "A_full" not in batch


# ----------------------------------------------------------------- the train CLI

SMALL = ["--ImageDepthf_outf", "8", "--ImageDepthf_basef", "8", "--Depthf_outf", "8",
         "--Depthf_basef", "8", "--I2D_base", "8", "--Task_basef", "8"]
STAGE3 = ["--model_type", "main", "--use_image_for_trans", "--use_masked", "--norm_loss",
          "--use_smooth_loss", "--compute_dtype", "float32"]
I2D = ["--model_type", "I2D", "--use_D", "--Imagef_outf", "8", "--Imagef_basef", "8",
       "--Task_basef", "8", "--ndf", "8", "--compute_dtype", "float32"]


@pytest.fixture
def small_translator(monkeypatch):
    from desr_tpu_torch.models import translation_networks as TTT

    full = TTT.default_translator_opt
    monkeypatch.setattr(TTT, "default_translator_opt",
                        lambda **kw: full(ngf_img=8, ngf_depth=8, n_blocks=1, **kw))


@pytest.mark.parametrize("stage", ["main", "SR", "I2D"])
def test_train_cli_device_aug_step_on_the_cpu(tmp_path, monkeypatch, small_translator, stage):
    """One ``train --device_aug --device cpu`` step of each stage that has a
    device half: every batch goes through device_finish before set_input,
    which gets the crop-size tensors; the losses are finite. The I2D run
    also writes a --profile_dir trace with its train_step and
    device_finish spans."""
    from desr_tpu_torch import train
    from desr_tpu_torch.data.base_dataset import UnpairedFolderDataset
    from desr_tpu_torch.data.sr_dataset import NaiveSRDataset
    from desr_tpu_torch.models.base_model import BaseModel

    _write_folder(str(tmp_path), n=1, hw=(48, 64))
    calls, inputs = [], []
    for cls in (UnpairedFolderDataset, NaiveSRDataset):
        orig = cls.device_finish
        monkeypatch.setattr(cls, "device_finish",
                            lambda self, b, dev, orig=orig: calls.append(1) or orig(self, b, dev))
    orig_set = BaseModel.apply_direction
    monkeypatch.setattr(BaseModel, "apply_direction",
                        lambda self, b: inputs.append(dict(b)) or orig_set(self, b))
    common = [*_data_flags(tmp_path), "--name", "e", "--checkpoints_dir", str(tmp_path / "ck"),
              "--do_train", "--device_aug", "--batch_size", "1", "--n_epochs", "1",
              "--n_epochs_decay", "0", "--print_freq", "1", "--num_threads", "0",
              "--device", "cpu"]
    extra, hw = {
        "main": ([*STAGE3, *SMALL, "--continue_train", "--load_size_h", "160",
                  "--load_size_w", "192", "--crop_size_h", "128", "--crop_size_w", "128"],
                 (128, 128)),
        "SR": ([*STAGE3, *SMALL, "--SR", "--continue_train", "--crop_size_h", "128",
                "--crop_size_w", "128"], (256, 256)),
        "I2D": ([*I2D, "--profile_dir", str(tmp_path / "prof")], (384, 512)),
    }[stage]
    losses = train.main(common + extra)
    assert losses and all(np.isfinite(list(losses.values())))
    assert len(calls) == 1 and len(inputs) == 1
    assert "A_full" not in inputs[0] and "A_img_src" not in inputs[0]
    for k, c in (("A_i", 3), ("A_d", 1), ("B_i", 3), ("B_d", 1)):
        assert torch.is_tensor(inputs[0][k]) and tuple(inputs[0][k].shape) == (1, *hw, c), k
    if stage == "I2D":
        trace = tmp_path / "prof" / "trace.json"
        names = {ev.get("name") for ev in json.loads(trace.read_text())["traceEvents"]}
        assert {"train_step", "device_finish"} <= names
