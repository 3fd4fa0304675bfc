"""The port's two CLIs under --SR on the CPU: ``python -m desr_tpu_torch.predict
--SR`` against the JAX package's ``predict.py --SR``, and an SR epoch of
``python -m desr_tpu_torch.train`` with a --save_all test pass.

The translator's hardcoded widths are cut to 8+8 base channels and one
block in both packages here (tests/test_torch_translator.py holds it at full
width)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_common import randn  # noqa: F401  (caps torch's threads)

from desr_tpu.models import translation_networks as JTT
from desr_tpu_torch.data import png
from desr_tpu_torch.models import translation_networks as TTT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--ImageDepthf_outf", "8", "--ImageDepthf_basef", "8", "--Depthf_outf", "8",
         "--Depthf_basef", "8", "--I2D_base", "8", "--Task_basef", "8"]


@pytest.fixture
def small_translator(monkeypatch):
    for mod in (JTT, TTT):
        full = mod.default_translator_opt
        monkeypatch.setattr(mod, "default_translator_opt",
                            lambda full=full: full(ngf_img=8, ngf_depth=8, n_blocks=1))


def test_predict_sr_cli_matches_jax_predict(tmp_path, small_translator):
    """The same .pth set and four 100x140 frames through ``predict.py --SR``
    (JAX) and ``python -m desr_tpu_torch.predict --SR --device cpu``: both pad
    to 256x256 (/256), derive the LR grid 128x128 from the first frame, and
    crop the 1:1 pad offsets off the HR prediction; PNGs within 3 mm (the
    bound of tests/test_torch_slice.py::test_predict_cli_matches_jax_predict)."""
    import imageio.v2 as imageio

    import predict as jax_predict
    from desr_tpu_torch import checkpoints as ckpt
    from desr_tpu_torch.models.networks import define_G

    rng = np.random.default_rng(0)
    for sub in ("depth", "img"):
        os.makedirs(tmp_path / sub)
    for i in range(4):  # two batches of 2: one JAX compile
        png.write_png(tmp_path / "depth" / f"f{i}.png",
                      rng.integers(0, 6000, (100, 140)).astype(np.uint16))
        png.write_png(tmp_path / "img" / f"f{i}.png",
                      rng.integers(0, 255, (100, 140, 3)).astype(np.uint8))
    ckdir = tmp_path / "ckpt"
    nets = {"I2D_features": (3, 8, 8, "resnet_6blocks"), "Image2Depth": (8, 1, 8, "unet_128"),
            "Depth_f": (2, 8, 8, "resnet_6blocks"), "Task": (21, 1, 8, "unet_128")}
    for i, (name, args) in enumerate(nets.items()):  # the port's init, read by both
        net = define_G(*args, generator=torch.Generator().manual_seed(20 + i))
        ckpt.save_net(net, ckpt.net_ckpt_path(str(ckdir), "x", "latest", name))
    common = ["--name", "x", "--checkpoints_dir", str(ckdir), "--SR",
              "--input_depth", str(tmp_path / "depth"), "--input_img", str(tmp_path / "img"),
              "--batch_size", "2", "--compute_dtype", "float32"]
    jax_predict.main(common + ["--output", str(tmp_path / "out_jax"), "--net_args", *SMALL])
    res = subprocess.run(
        [sys.executable, "-m", "desr_tpu_torch.predict", *common, "--device", "cpu",
         "--output", str(tmp_path / "out_torch"), "--net_args", *SMALL],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "loaded" in res.stdout  # the .pth files were read, not the init kept
    files = sorted(os.listdir(tmp_path / "out_jax"))
    assert files == sorted(os.listdir(tmp_path / "out_torch")) == [f"f{i}.png" for i in range(4)]
    for f in files:
        a = imageio.imread(tmp_path / "out_jax" / f).astype(np.int32)
        b = png.read_png(tmp_path / "out_torch" / f)
        assert b.shape == a.shape == (100, 140) and b.dtype == np.uint16
        assert np.abs(a - b.astype(np.int32)).max() <= 3, (f, np.abs(a - b).max())


def test_train_sr_cli_runs_an_epoch_on_the_cpu(tmp_path, small_translator):
    """``main(argv)`` with --SR --device cpu: NaiveSRDataset zooms two 48x64
    frames per domain to 960x1280 and pads them to 1024x1280. An epoch of two
    train steps on 256x256 HR crops writes checkpoints and the loss log; a
    --do_test run from those checkpoints (crop 512x640: the test pass takes
    the whole canvas) writes the HR predictions, rows [32:-32], as uint16
    PNGs."""
    from desr_tpu_torch import train
    from desr_tpu_torch.models.main_sr_model import MainSRModel

    rng = np.random.default_rng(1)
    root = str(tmp_path)
    for dom in ("A", "B"):
        for sub in ("depth", "img"):
            os.makedirs(os.path.join(root, dom, sub))
        for i in range(2):
            name = f"scene000{i}_00_{i:04d}.png"
            png.write_png(os.path.join(root, dom, "depth", name),
                          rng.integers(500, 6000, (48, 64)).astype(np.uint16))
            png.write_png(os.path.join(root, dom, "img", name),
                          rng.integers(0, 256, (48, 64, 3)).astype(np.uint8))
            kdir = os.path.join(root, "intr", f"scene000{i}_00", "intrinsic")
            os.makedirs(kdir, exist_ok=True)
            np.savetxt(os.path.join(kdir, "intrinsic_depth.txt"), np.diag([577.0, 577, 1, 1]))
    data = ["--path_to_intr", f"{root}/intr", "--image_and_depth", "--use_scannet"]
    for suffix in ("", "_test"):
        data += [f"--path_A{suffix}", f"{root}/A/depth", f"--path_B{suffix}", f"{root}/B/depth",
                 f"--A_add_paths{suffix}", f"{root}/A/img", f"--B_add_paths{suffix}",
                 f"{root}/B/img"]
    ck = tmp_path / "ck"
    argv = ["--model_type", "main", "--SR", "--use_image_for_trans", "--use_masked", "--norm_loss",
            "--use_smooth_loss", "--w_syn_norm", "0.05", "--compute_dtype", "float32", *SMALL,
            *data, "--name", "e", "--checkpoints_dir", str(ck), "--continue_train",
            "--batch_size", "1", "--lr", "2e-5", "--n_epochs", "1", "--n_epochs_decay", "0",
            "--print_freq", "1", "--save_epoch_freq", "1", "--num_threads", "0",
            "--device", "cpu"]
    losses = train.main(argv + ["--do_train", "--crop_size_h", "128", "--crop_size_w", "128"])
    assert losses and all(np.isfinite(v) for v in losses.values())
    for n in MainSRModel.model_names:
        assert (ck / "e" / f"latest_net_{n}.pth").exists()
    assert (ck / "e" / "loss_log.txt").read_text().count("(epoch: 1, iters:") == 2
    # the test canvas is 1024x1280, so the test pass needs a 512x640 crop
    losses = train.main(argv + ["--do_test", "--crop_size_h", "512", "--crop_size_w", "640",
                                "--save_all", "--save_image_folder", str(tmp_path / "pred")])
    assert losses and all(np.isfinite(v) for v in losses.values())
    preds = sorted(os.listdir(tmp_path / "pred"))
    assert preds == ["scene0000_00_0000.png", "scene0001_00_0001.png"]
    arr = png.read_png(tmp_path / "pred" / preds[0])
    assert arr.dtype == np.uint16 and arr.shape == (1024 - 64, 1280)
