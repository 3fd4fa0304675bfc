"""The port's stage-2 data path and CLIs on the CPU: the Lanczos resize against
cv2 and the JAX package's ``transforms.resize``, ``TranslationDataset``'s
items against the JAX dataset's, the ``.jpg`` refusal, and a ``python -m
desr_tpu_torch.train --model_type translation`` epoch whose checkpoints
``predict --translate`` serves, held against the JAX ``predict.py`` on the
same ``.pth`` files.

The translator's hardcoded widths are cut to 8+8 base channels and one
block in both packages here (tests/test_torch_translator.py holds it at full
width)."""

import os
from types import SimpleNamespace

import cv2
import numpy as np
import pytest

from test_torch_common import randn  # noqa: F401  (caps torch's threads)

from desr_tpu.data import transforms as JT
from desr_tpu.models import translation_networks as JTT
from desr_tpu_torch.data import png
from desr_tpu_torch.data import transforms as TT
from desr_tpu_torch.models import translation_networks as TTT


@pytest.mark.parametrize("shape", [(480, 640), (64, 80), (480, 640, 3)])
def test_lanczos_resize_matches_cv2_and_jax(shape):
    """resize(..., interpolation=4) to 320x320: cv2's INTER_LANCZOS4 (8 taps,
    not widened when it shrinks, edge taps clamped) within 1e-5 of cv2 and
    of the JAX package's ``transforms.resize``; cubic (2) stays refused."""
    x = np.random.default_rng(3).uniform(-1, 1, shape).astype(np.float32)
    x[:8] = -1.0  # a flat band and its edge, as a depth map's holes give
    got = TT.resize(x, 320, 320, TT.INTER_LANCZOS4)
    assert got.shape == (320, 320) + shape[2:] and got.dtype == np.float32
    np.testing.assert_allclose(got, cv2.resize(x, (320, 320), interpolation=cv2.INTER_LANCZOS4),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, JT.resize(x, 320, 320, 4), rtol=0, atol=1e-5)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        TT.resize(x, 320, 320, interpolation=2)


def _write_domain(root, n, seed, hw=(64, 80)):
    """n frames of <root>/{img,depth}: uint8 RGB (RGBA for the first) and
    uint16 depth in mm with a band of holes."""
    rng = np.random.default_rng(seed)
    for sub in ("img", "depth"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(n):
        depth = rng.integers(500, 6000, hw).astype(np.uint16)
        depth[:, : hw[1] // 8] = 0
        img = rng.integers(0, 256, hw + ((4,) if i == 0 else (3,))).astype(np.uint8)
        png.write_png(os.path.join(root, "depth", f"f{i:02d}.png"), depth)
        png.write_png(os.path.join(root, "img", f"f{i:02d}.png"), img)


def _write_dataroot(root, n_a, n_b, phases=("train",)):
    for k, phase in enumerate(phases):
        _write_domain(os.path.join(root, f"{phase}A"), n_a, 10 + k)
        _write_domain(os.path.join(root, f"{phase}B"), n_b, 20 + k)


def _opt(root, **kw):
    base = dict(dataroot=str(root), max_distance=5100.0, seed=3, phase="train",
                max_dataset_size=2 ** 31, crop_size_h=64, crop_size_w=48, isTrain=True)
    return SimpleNamespace(**{**base, **kw})


@pytest.mark.parametrize("stage", ["train", "test"])
def test_translation_dataset_matches_jax(tmp_path, stage):
    """Items of 3 A and 2 B frames (so that A comes from its shuffled
    queue), two epochs in order: names equal and maps within 1e-5 of the JAX
    dataset's (Lanczos to 320x320, then at train time a random crop and
    flip drawn per domain; RGBA cut to RGB)."""
    from desr_tpu.data.translation_dataset import TranslationDataset as JaxDataset
    from desr_tpu_torch.data.translation_dataset import TranslationDataset

    _write_dataroot(tmp_path, 3, 2, phases=(stage,))
    opt = _opt(tmp_path)
    got, want = TranslationDataset(opt, stage), JaxDataset(opt, stage)
    assert len(got) == len(want) == 2
    names = []
    for _ in range(2):
        for i in range(len(got)):
            a, b = got[i], want[i]
            assert (a["A_name"], a["B_name"]) == (b["A_name"], b["B_name"])
            names.append(a["A_name"])
            for k in ("A_depth", "A_img", "B_depth", "B_img"):
                assert a[k].shape == b[k].shape and a[k].dtype == np.float32, k
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5, err_msg=k)
    hw = (64, 48) if stage == "train" else (320, 320)
    assert a["A_depth"].shape == hw + (1,) and a["B_img"].shape == hw + (3,)
    assert sorted(names[:3]) == ["f00", "f01", "f02"]  # the first permutation of A


def test_translation_dataset_refuses_jpg(tmp_path):
    """A .jpg frame passes the extension check, as in the JAX dataset, and
    stops the item with an error that names it: the port reads PNG only."""
    from desr_tpu_torch.data.translation_dataset import TranslationDataset

    _write_dataroot(tmp_path, 2, 2)
    bad = tmp_path / "trainA" / "img" / "f00.png"
    os.rename(bad, bad.with_suffix(".jpg"))
    ds = TranslationDataset(_opt(tmp_path), "train")
    with pytest.raises(NotImplementedError, match=r"f00\.jpg.*PNG"):
        ds[0]


def test_translation_dataset_refuses_unpaired_frames(tmp_path):
    """Image and depth lists of a domain pair up by count and by name."""
    from desr_tpu_torch.data.translation_dataset import TranslationDataset

    _write_dataroot(tmp_path, 2, 2)
    os.remove(tmp_path / "trainB" / "depth" / "f01.png")
    with pytest.raises(ValueError, match="not pair img depth"):
        TranslationDataset(_opt(tmp_path), "train")
    os.rename(tmp_path / "trainB" / "img" / "f01.png", tmp_path / "trainB" / "img" / "g01.png")
    png.write_png(tmp_path / "trainB" / "depth" / "f01.png", np.ones((4, 4), np.uint16))
    with pytest.raises(ValueError, match="not pair img depth"):
        TranslationDataset(_opt(tmp_path), "train")[1]


@pytest.fixture
def small_translator(monkeypatch):
    for mod in (JTT, TTT):
        full = mod.default_translator_opt
        monkeypatch.setattr(mod, "default_translator_opt",
                            lambda full=full, **kw: full(ngf_img=8, ngf_depth=8, n_blocks=1, **kw))


NETS = ("G_A", "G_B", "D_A_depth", "D_B_depth", "D_A_normal", "D_B_normal")


@pytest.mark.parametrize("inp_B,direction", [("img_depth", "AtoB"), ("depth", "BtoA")])
def test_train_translation_cli_epoch_then_predict(tmp_path, capsys, small_translator, inp_B,
                                                  direction):
    """``train.main`` with --model_type translation --do_train --do_test
    --device cpu on 2 frames a domain (64x80, Lanczos to 320x320, 64x64
    crops, batch 1): two iterations of 3 G steps and a D step, the six
    ``latest_net_*.pth`` files and the loss log, and the test pass's
    depth_dif_A/B. Then ``predict --translate`` serves the trained
    translator from those files (G_B on depth alone under --inp_B depth),
    and the JAX ``predict.py`` on the same files writes the same PNGs
    within 2 of 65535."""
    import predict as jax_predict
    from desr_tpu_torch import predict, train

    _write_dataroot(tmp_path / "data", 2, 2, phases=("train", "test"))
    ck = tmp_path / "ck"
    losses = train.main(["--model_type", "translation", "--do_train", "--do_test",
                         "--dataroot", str(tmp_path / "data"), "--name", "e",
                         "--checkpoints_dir", str(ck), "--batch_size", "1", "--crop_size_h", "64",
                         "--crop_size_w", "64", "--max_distance", "5100", "--ndf", "8",
                         "--inp_B", inp_B, "--compute_dtype", "float32", "--n_epochs", "1",
                         "--n_epochs_decay", "0", "--print_freq", "1", "--save_epoch_freq", "1",
                         "--num_threads", "0", "--device", "cpu"])
    assert set(losses) == {"G_A", "G_B", "depth_dif_A", "depth_dif_B", "cycle_B", "cycle_n_B",
                           "D_A_depth", "D_B_depth", "D_A_normal", "D_B_normal", "idt_A",
                           "idt_B", "depth_range_A", "depth_range_B"}
    assert all(np.isfinite(list(losses.values())))
    test_pass = capsys.readouterr().out.split("stage:  test")[1]
    assert "'depth_dif_A'" in test_pass and "'depth_dif_B'" in test_pass
    for n in NETS:
        assert (ck / "e" / f"latest_net_{n}.pth").exists(), n
    log = (ck / "e" / "loss_log.txt").read_text()
    assert log.count("(epoch: 1, iters:") == 2 and log.count("D_A_normal:") == 2

    depth, img = tmp_path / "data" / "testB" / "depth", tmp_path / "data" / "testB" / "img"
    outs = {}
    for pkg, main, extra in (("jax", jax_predict.main, []),
                             ("torch", predict.main, ["--device", "cpu"])):
        out = tmp_path / f"out_{pkg}"
        main(["--name", "e", "--checkpoints_dir", str(ck), "--translate", direction,
              "--input_depth", str(depth), "--input_img", str(img), "--output", str(out),
              "--batch_size", "2", "--compute_dtype", "float32", *extra,
              "--net_args", "--inp_B", inp_B])
        outs[pkg] = {f: png.read_png(out / f).astype(np.int64) for f in sorted(os.listdir(out))}
    assert sorted(outs["torch"]) == sorted(outs["jax"]) == ["f00.png", "f01.png"]
    for f, arr in outs["torch"].items():
        assert arr.shape == (64, 80) and arr.max() > 0
        assert np.abs(arr - outs["jax"][f]).max() <= 2, f
