"""The port's CLIs for stages 1 and 2 on the CPU: ``python -m
desr_tpu_torch.predict --I2D`` and ``--translate AtoB|BtoA`` against the JAX
package's ``predict.py`` on one ``.pth`` set, and a ``--model_type I2D
--use_D`` epoch of ``python -m desr_tpu_torch.train``.

The translator's hardcoded widths are cut to 8+8 base channels and one
block in both packages here (tests/test_torch_translator.py holds it at full
width)."""

import os

import numpy as np
import pytest
import torch

from test_torch_common import randn  # noqa: F401  (caps torch's threads)

from desr_tpu.models import translation_networks as JTT
from desr_tpu_torch import checkpoints as ckpt
from desr_tpu_torch.data import png
from desr_tpu_torch.models import translation_networks as TTT

I2D_SMALL = ["--Imagef_outf", "8", "--Imagef_basef", "8", "--Task_basef", "8"]


@pytest.fixture
def small_translator(monkeypatch):
    for mod in (JTT, TTT):
        full = mod.default_translator_opt
        monkeypatch.setattr(mod, "default_translator_opt",
                            lambda full=full, **kw: full(ngf_img=8, ngf_depth=8, n_blocks=1, **kw))


def _frames(root, n=3, hw=(100, 140), seed=0):
    rng = np.random.default_rng(seed)
    for sub in ("depth", "img"):
        os.makedirs(root / sub)
    for i in range(n):
        png.write_png(root / "depth" / f"d{i}.png",
                      rng.integers(0, 6000, hw).astype(np.uint16))
        png.write_png(root / "img" / f"f{i}.png", rng.integers(0, 255, hw + (3,)).astype(np.uint8))


def _serve_both(tmp_path, mode, net_args, names):
    """The same frames and .pth set through the JAX ``predict.py`` and the
    port's ``predict.main`` (in-process, --device cpu), float32, batches of
    2; returns the two output folders' PNGs, by file name."""
    import predict as jax_predict
    from desr_tpu_torch import predict

    outs = {}
    for pkg, main, extra in (("jax", jax_predict.main, []),
                             ("torch", predict.main, ["--device", "cpu"])):
        out = tmp_path / f"out_{pkg}"
        main(["--name", "x", "--checkpoints_dir", str(tmp_path / "ckpt"), *mode,
              "--input_img", str(tmp_path / "img"), "--output", str(out),
              "--batch_size", "2", "--compute_dtype", "float32", *extra,
              "--net_args", *net_args])
        outs[pkg] = {f: png.read_png(out / f) for f in sorted(os.listdir(out))}
    assert sorted(outs["jax"]) == sorted(outs["torch"]) == names
    return outs


def _assert_pngs_close(outs, hw=(100, 140)):
    """uint16 PNGs of the input's size within 3 mm (1e-3 in [-1, 1] is
    ~2.6 mm at x5100; the bound of tests/test_torch_slice.py)."""
    for f, b in outs["torch"].items():
        a = outs["jax"][f].astype(np.int32)
        assert b.shape == a.shape == hw and b.dtype == np.uint16, (f, b.shape)
        assert np.abs(a - b.astype(np.int32)).max() <= 3, (f, np.abs(a - b).max())
        assert b.max() > 0


@pytest.mark.parametrize("with_depth", [False, True], ids=["image_only", "with_depth"])
def test_predict_i2d_cli_matches_jax_predict(tmp_path, with_depth):
    """``--I2D``: Image_f then Task on the image, padded to /128 (100x140 ->
    128x256) and cropped back. Without --input_depth the stems come from the
    images (f*), with it from the depth frames (d*)."""
    from desr_tpu_torch.models.networks import define_G

    _frames(tmp_path)
    for i, (name, args) in enumerate({"Image_f": (3, 8, 8, "resnet_6blocks"),
                                      "Task": (8, 1, 8, "unet_128")}.items()):
        net = define_G(*args, generator=torch.Generator().manual_seed(30 + i))
        ckpt.save_net(net, ckpt.net_ckpt_path(str(tmp_path / "ckpt"), "x", "latest", name))
    mode = ["--I2D"] + (["--input_depth", str(tmp_path / "depth")] if with_depth else [])
    stem = "d" if with_depth else "f"
    _assert_pngs_close(_serve_both(tmp_path, mode, I2D_SMALL, [f"{stem}{i}.png" for i in range(3)]))


@pytest.mark.parametrize("direction", ["AtoB", "BtoA"])
def test_predict_translate_cli_matches_jax_predict(tmp_path, small_translator, direction):
    """``--translate``: G_A (AtoB) or G_B (BtoA) on each frame's depth and
    image; the two translators get different weights, so a swapped
    direction would not pass."""
    from desr_tpu_torch.models.translation_networks import default_translator_opt, define_Gen

    _frames(tmp_path)
    for i, name in enumerate(("G_A", "G_B")):
        net = define_Gen(default_translator_opt(), "img_depth",
                         generator=torch.Generator().manual_seed(40 + i))
        ckpt.save_net(net, ckpt.net_ckpt_path(str(tmp_path / "ckpt"), "x", "latest", name))
    outs = _serve_both(tmp_path, ["--translate", direction, "--input_depth",
                                  str(tmp_path / "depth")], [], [f"d{i}.png" for i in range(3)])
    _assert_pngs_close(outs)


def test_predict_refuses_what_it_does_not_serve(tmp_path, capsys):
    from desr_tpu_torch import predict

    base = ["--name", "x", "--input_img", str(tmp_path), "--output", str(tmp_path / "o"),
            "--device", "cpu"]
    for extra, msg in ((["--translate", "AtoB"], "--input_depth is required"),
                       (["--I2D", "--SR"], "standalone"),
                       (["--translate", "BtoA", "--I2D"], "standalone"),
                       (["--input_depth", str(tmp_path), "--translate", "AtoB", "--export",
                         str(tmp_path / "x")], "standalone")):
        with pytest.raises((SystemExit, NotImplementedError)) as e:
            predict.main(base + extra)
        text = str(e.value) + capsys.readouterr().err
        assert msg in text, (extra, text)


def test_train_i2d_cli_runs_an_epoch_on_the_cpu(tmp_path):
    """``main(argv)`` with --model_type I2D --use_D --device cpu: 48x64
    frames jittered, resized to 480x640, rotated and cropped 384x512; two
    train steps with the D step, checkpoints of the three nets and the loss
    log, then a --save_all test pass (512x640, rows [16:-16] written)."""
    from desr_tpu_torch import train

    rng = np.random.default_rng(1)
    root = tmp_path
    for dom in ("A", "B"):
        for sub in ("depth", "img"):
            os.makedirs(root / dom / sub)
        for i in range(2):
            name = f"scene000{i}_00_{i:04d}.png"
            png.write_png(root / dom / "depth" / name,
                          rng.integers(500, 6000, (48, 64)).astype(np.uint16))
            png.write_png(root / dom / "img" / name,
                          rng.integers(0, 256, (48, 64, 3)).astype(np.uint8))
    data = ["--image_and_depth", "--use_scannet"]
    for suffix in ("", "_test"):
        data += [f"--path_A{suffix}", f"{root}/A/depth", f"--path_B{suffix}", f"{root}/B/depth",
                 f"--A_add_paths{suffix}", f"{root}/A/img", f"--B_add_paths{suffix}",
                 f"{root}/B/img"]
    ck = tmp_path / "ck"
    losses = train.main(["--model_type", "I2D", "--use_D", "--do_train", "--do_test", *data,
                         *I2D_SMALL, "--ndf", "8", "--compute_dtype", "float32", "--name", "e",
                         "--checkpoints_dir", str(ck), "--batch_size", "1", "--n_epochs", "1",
                         "--n_epochs_decay", "0", "--print_freq", "1", "--save_epoch_freq", "1",
                         "--save_all", "--save_image_folder", str(tmp_path / "pred"),
                         "--num_threads", "0", "--device", "cpu"])
    assert set(losses) == {"task_syn", "task_real", "D_depth", "G_pred", "G_pred_r"}
    assert all(np.isfinite(list(losses.values())))
    for n in ("Image_f", "Task", "D_depth"):
        assert (ck / "e" / f"latest_net_{n}.pth").exists()
    log = (ck / "e" / "loss_log.txt").read_text()
    assert log.count("(epoch: 1, iters:") == 2 and log.count("D_depth:") == 2
    preds = sorted(os.listdir(tmp_path / "pred"))
    assert preds == ["scene0000_00_0000.png", "scene0001_00_0001.png"]
    arr = png.read_png(tmp_path / "pred" / preds[0])
    assert arr.dtype == np.uint16 and arr.shape == (480, 640)
