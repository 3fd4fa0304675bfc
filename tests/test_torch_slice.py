"""The port's serving slice end to end against the JAX package: MainModel's
real-branch eval forward, the predict CLI, and the PNG codec it runs on."""

import os
import subprocess
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import randn

from desr_tpu_torch.data import png
from desr_tpu_torch.models.main_model import MainModel, NetOptions
from desr_tpu_torch.weights import from_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(ImageDepthf_outf=8, ImageDepthf_basef=8, Depthf_outf=8, Depthf_basef=8,
             I2D_base=8, Task_basef=8)
SMALL_FLAGS = [a for k, v in SMALL.items() for a in (f"--{k}", str(v))]


def _batch(b=2, h=128, w=128, seed=0):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(-0.5, 1, (b, h, w, 1)).astype(np.float32)
    depth[depth < -0.3] = -1.0  # holes
    img = rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32)
    K = np.tile(np.array([[[577.0, 0, 320], [0, 577, 240], [0, 0, 1]]], np.float32), (b, 1, 1))
    crop = np.tile(np.array([[0, h, 0, w]], np.float32), (b, 1))
    return {"A_i": img, "B_i": img, "A_d": depth, "B_d": depth, "K_A": K, "K_B": K,
            "crop_A": crop, "crop_B": crop}


def test_serve_forward_matches_jax_main_model():
    from desr_tpu.models.main_model import MainModel as JaxMainModel
    from desr_tpu.options.train_options import TrainOptions

    opt = TrainOptions().parse([
        "--model_type", "main", "--name", "t_port_slice", "--checkpoints_dir", "/nonexistent",
        "--compute_dtype", "float32", "--use_image_for_trans", "--use_masked",
        "--no_batched_branches", "--crop_size_h", "128", "--crop_size_w", "128",
        *SMALL_FLAGS])
    jm = JaxMainModel(opt)
    jm.init_params(0)
    forward = jm._forward_fn()
    batch = _batch()
    want = jax.jit(lambda p, b: forward(p, b, jax.random.PRNGKey(0), False)["pred_real_depth"])(
        jm.params, {k: jnp.asarray(v) for k, v in batch.items()})

    tm = MainModel(NetOptions(**SMALL), device="cpu", compute_dtype=torch.float32)
    for name, net in tm.nets.items():
        net.load_state_dict(from_jax_params(jm.params[name]), strict=True)
    got = tm.serve_forward(batch)
    assert got.shape == want.shape == (2, 128, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)


def _frames(folder, n=3, hw=(100, 140), seed=0):
    import imageio.v2 as imageio

    rng = np.random.default_rng(seed)
    for sub in ("depth", "img"):
        os.makedirs(folder / sub)
    for i in range(n):
        imageio.imwrite(folder / "depth" / f"f{i}.png",
                        rng.integers(0, 6000, hw).astype(np.uint16))
        imageio.imwrite(folder / "img" / f"f{i}.png",
                        rng.integers(0, 255, hw + (3,)).astype(np.uint8))


def test_predict_cli_matches_jax_predict(tmp_path):
    """The same .pth set and 3-frame folder through predict.py (JAX) and
    ``python -m desr_tpu_torch.predict --device cpu``: PNGs within 3 mm
    (1e-3 in [-1, 1] is ~2.6 mm at x5100)."""
    import imageio.v2 as imageio

    import predict as jax_predict
    from desr_tpu.checkpoints import net_ckpt_path, save_net
    from desr_tpu.models.networks import define_G

    _frames(tmp_path)
    ckdir = tmp_path / "ckpt"
    nets = {"I2D_features": (3, 8, 8, "resnet_6blocks"), "Image2Depth": (8, 1, 8, "unet_128"),
            "Depth_f": (2, 8, 8, "resnet_6blocks"), "Task": (21, 1, 8, "unet_128")}
    for i, (name, args) in enumerate(nets.items()):
        params = jax.jit(define_G(*args).init)(jax.random.PRNGKey(10 + i))
        save_net(params, net_ckpt_path(str(ckdir), "x", "latest", name))
    common = ["--name", "x", "--checkpoints_dir", str(ckdir),
              "--input_depth", str(tmp_path / "depth"), "--input_img", str(tmp_path / "img"),
              "--batch_size", "2", "--compute_dtype", "float32"]
    jax_predict.main(common + ["--output", str(tmp_path / "out_jax"), "--net_args", *SMALL_FLAGS])
    res = subprocess.run(
        [sys.executable, "-m", "desr_tpu_torch.predict", *common, "--device", "cpu",
         "--output", str(tmp_path / "out_torch"), "--net_args", *SMALL_FLAGS],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "loaded" in res.stdout  # the .pth files were read, not the init kept
    files = sorted(os.listdir(tmp_path / "out_jax"))
    assert files == sorted(os.listdir(tmp_path / "out_torch")) == ["f0.png", "f1.png", "f2.png"]
    for f in files:
        a = imageio.imread(tmp_path / "out_jax" / f).astype(np.int32)
        b = png.read_png(tmp_path / "out_torch" / f).astype(np.int32)
        assert b.shape == (100, 140) and png.read_png(tmp_path / "out_torch" / f).dtype == np.uint16
        assert np.abs(a - b).max() <= 3, (f, np.abs(a - b).max())


def test_predict_refuses_to_run_on_the_cpu_unasked(tmp_path, monkeypatch, capsys):
    from desr_tpu_torch import predict, resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    args = ["--name", "x", "--input_depth", str(tmp_path), "--input_img", str(tmp_path),
            "--output", str(tmp_path / "o")]
    with pytest.raises(SystemExit) as e:
        predict.main(args)
    assert e.value.code != 0 and "no CUDA device" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        predict.main(args + ["--device", "cpu", "--spatial_devices", "2"])
    assert e.value.code != 0 and "not yet ported" in capsys.readouterr().err


@pytest.mark.parametrize("arr", [
    np.random.default_rng(1).integers(0, 65536, (7, 9)).astype(np.uint16),
    np.random.default_rng(2).integers(0, 256, (5, 6, 3)).astype(np.uint8),
    np.random.default_rng(3).integers(0, 256, (4, 3, 4)).astype(np.uint8),
    np.random.default_rng(4).integers(0, 256, (3, 5)).astype(np.uint8),
], ids=["u16_grey", "u8_rgb", "u8_rgba", "u8_grey"])
def test_png_round_trip_and_imageio_agree(tmp_path, arr):
    import imageio.v2 as imageio

    png.write_png(tmp_path / "a.png", arr)
    np.testing.assert_array_equal(png.read_png(tmp_path / "a.png"), arr)
    np.testing.assert_array_equal(imageio.imread(tmp_path / "a.png"), arr)
    imageio.imwrite(tmp_path / "b.png", arr)
    got = png.read_png(tmp_path / "b.png")
    assert got.dtype == arr.dtype
    np.testing.assert_array_equal(got, arr)


def _filter_row(ftype, line, prior, bpp):
    """Reference PNG filters (PNG spec section 9.2), one byte at a time."""
    out = bytearray(len(line))
    for i, v in enumerate(line):
        a = line[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        if ftype == 0:
            pred = 0
        elif ftype == 1:
            pred = a
        elif ftype == 2:
            pred = b
        elif ftype == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (v - pred) & 0xFF
    return bytes([ftype]) + bytes(out)


def test_png_decodes_all_five_filters():
    """Every scanline filter, each row with another, on 8-bit RGB and 16-bit grey."""
    import struct

    for arr, ctype, depth in (
            (np.random.default_rng(5).integers(0, 256, (10, 7, 3)).astype(np.uint8), 2, 8),
            (np.random.default_rng(6).integers(0, 65536, (10, 7)).astype(np.uint16), 0, 16)):
        rows = arr.astype(">u2" if depth == 16 else np.uint8).reshape(arr.shape[0], -1)
        rows = rows.view(np.uint8)
        bpp = (3 if ctype == 2 else 1) * depth // 8
        prior = bytes(rows.shape[1])
        raw = b""
        for y, line in enumerate(rows):
            raw += _filter_row(y % 5, line.tobytes(), prior, bpp)
            prior = line.tobytes()

        def chunk(kind, body):
            return struct.pack(">I", len(body)) + kind + body + struct.pack(
                ">I", zlib.crc32(kind + body))

        data = (b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", arr.shape[1], arr.shape[0], depth,
                                             ctype, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
        np.testing.assert_array_equal(png.decode_png(data), arr)


def test_png_decodes_a_pil_photo_like_image(tmp_path):
    """PIL's encoder picks filters per row; a smooth image makes it use them."""
    from PIL import Image

    yy, xx = np.mgrid[0:48, 0:64]
    arr = np.stack([(xx * 4) % 256, (yy * 5) % 256, (xx + yy) % 256], -1).astype(np.uint8)
    arr = (arr + randn(arr.shape, 8, 3.0).astype(np.int16)).clip(0, 255).astype(np.uint8)
    Image.fromarray(arr).save(tmp_path / "p.png")
    np.testing.assert_array_equal(png.read_png(tmp_path / "p.png"), arr)
