"""The port's quality tool (``desr_tpu_torch/tools/quality_eval.py``) against
the JAX package's (``tools/quality_eval.py``) on the CPU, before any model
runs: the scene model bit for bit, every dataset writer's PNG pixels and
intrinsics files, the offline score, the train argv each stage builds, the
device refusal and the reference arm's albumentations shim.

The JAX tool writes through imageio and resizes with cv2; the port writes
with its stdlib PNG codec and resizes with ``ops/resize.py``'s cv2 float
paths. cv2's INTER_CUBIC hands float images to IPP by default, whose sums
differ from cv2's own float code (ROADMAP.md, "What the port does not
copy"), so the SR writers are compared with IPP off.
"""

import filecmp
import json
import os
import random
import sys

import numpy as np
import pytest

from test_torch_common import randn  # noqa: F401  (caps torch's threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import quality_eval as jqe  # noqa: E402  (the JAX package's tool)

from desr_tpu_torch.options import train_options  # noqa: E402
from desr_tpu_torch.tools import quality_eval as qe  # noqa: E402


def _files(root):
    out = []
    for d, _, names in os.walk(root):
        out += [os.path.relpath(os.path.join(d, n), root) for n in names]
    return sorted(out)


def _pixels(path):
    import imageio.v2 as imageio

    return np.asarray(imageio.imread(path))


def _compare_trees(jax_root, port_root, max_count=0):
    """Same files; PNG pixels equal (within ``max_count`` of uint16/uint8),
    text files byte-equal. Returns {file: pixels that differ}."""
    files = _files(jax_root)
    assert files == _files(port_root) and files
    differing = {}
    for f in files:
        a, b = os.path.join(jax_root, f), os.path.join(port_root, f)
        if not f.endswith(".png"):
            assert filecmp.cmp(a, b, shallow=False), f
            continue
        pa, pb = _pixels(a), _pixels(b)
        # the port's own decoder reads what it wrote
        from desr_tpu_torch.data.native_io import read_image

        assert np.array_equal(read_image(b), pb), f
        assert pa.dtype == pb.dtype and pa.shape == pb.shape, (f, pa.dtype, pb.dtype)
        d = np.abs(pa.astype(np.int64) - pb.astype(np.int64))
        assert d.max() <= max_count, (f, int(d.max()))
        differing[f] = int((d > 0).sum())
    return differing


@pytest.mark.parametrize("seed", [0, 7])
def test_scenes_bit_equal_to_the_jax_tool(seed):
    for h, w, freq in ((64, 80, 1.0), (48, 40, 4.0), (20, 16, 1.0)):
        want = jqe.make_scene(np.random.default_rng(seed), h, w, freq)
        got = qe.make_scene(np.random.default_rng(seed), h, w, freq)
        for a, b in zip(want, got):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    clean = np.random.default_rng(seed).uniform(600, 4800, (24, 30))
    assert np.array_equal(jqe.degrade(np.random.default_rng(seed + 1), clean),
                          qe.degrade(np.random.default_rng(seed + 1), clean))


def test_scene_generator_contracts():
    """The JAX tool's own contract (tests/test_quality_eval.py), on the port's."""
    clean, rgb, noisy = qe.make_scene(np.random.default_rng(0), 64, 80)
    assert clean.dtype == np.uint16 and rgb.dtype == np.uint8
    assert clean.min() >= 600 and clean.max() <= 4800
    holes = noisy == 0
    assert 0.005 < holes.mean() < 0.5
    err = noisy[~holes].astype(np.float64) - clean[~holes]
    assert abs(err.mean()) < 20 and err.std() < 80
    assert rgb.std() > 5


def test_main_and_i2d_writers_equal_the_jax_tool(tmp_path):
    """write_dataset at the main stage's 128x128 and the I2D stage's
    480x640, and write_mean_baseline: same files, same pixels, same
    intrinsics text."""
    for tag, hw, n_train in (("main", (128, 128), 3), ("i2d", (480, 640), 2)):
        roots = {k: str(tmp_path / f"{tag}_{k}") for k in ("jax", "port")}
        jdirs, _ = jqe.write_dataset(roots["jax"], n_train, 2, *hw)
        pdirs, _ = qe.write_dataset(roots["port"], n_train, 2, *hw)
        assert {k: os.path.relpath(v, roots["jax"]) for k, v in jdirs.items()} == \
            {k: os.path.relpath(v, roots["port"]) for k, v in pdirs.items()}
        if tag == "i2d":
            jqe.write_mean_baseline(jdirs, os.path.join(roots["jax"], "mean"))
            qe.write_mean_baseline(pdirs, os.path.join(roots["port"], "mean"))
        differing = _compare_trees(roots["jax"], roots["port"])
        assert not any(differing.values()), differing


def test_translation_writer_equals_the_jax_tool(tmp_path):
    jdirs, _ = jqe.write_dataset_translation(str(tmp_path / "jax"), 2, 2, hw=(96, 80))
    pdirs, _ = qe.write_dataset_translation(str(tmp_path / "port"), 2, 2, hw=(96, 80))
    assert sorted(jdirs) == sorted(pdirs)
    differing = _compare_trees(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert not any(differing.values()), differing
    assert os.path.isdir(tmp_path / "port" / "trainB" / "depth")


def test_sr_writers_equal_the_jax_tool_within_one_count(tmp_path):
    """write_dataset_sr (its x2 INTER_AREA test canvases) and
    write_bicubic_baseline (INTER_CUBIC) within 1 count of the JAX tool's,
    cv2 on its float path (IPP off); the differing pixels are counted."""
    import cv2

    ipp = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        jdirs, _ = jqe.write_dataset_sr(str(tmp_path / "jax"), 1, 1)
        jqe.write_bicubic_baseline(jdirs, str(tmp_path / "jax" / "bicubic"))
    finally:
        cv2.ipp.setUseIPP(ipp)
    pdirs, _ = qe.write_dataset_sr(str(tmp_path / "port"), 1, 1)
    qe.write_bicubic_baseline(pdirs, str(tmp_path / "port" / "bicubic"))
    assert sorted(jdirs) == sorted(pdirs)
    differing = _compare_trees(str(tmp_path / "jax"), str(tmp_path / "port"), max_count=1)
    print("pixels that differ by one count:", json.dumps(differing))
    canvases = [f for f in differing if f.startswith(("test_in_hr", "test_img_hr", "bicubic"))]
    assert len(canvases) == 3
    # each image's shape: the HR canvases and the baseline at 960x1280
    assert _pixels(tmp_path / "port" / canvases[0]).shape[:2] == (960, 1280)


def _predictions(dirs, out, seed):
    """Test ground truth with noise and a zeroed block: a prediction to score."""
    os.makedirs(out, exist_ok=True)
    rng = np.random.default_rng(seed)
    for f in sorted(os.listdir(dirs["test_gt"])):
        gt = _pixels(os.path.join(dirs["test_gt"], f)).astype(np.float64)
        p = gt + rng.normal(0, 40.0, gt.shape)
        p[:8, :12] = 0
        qe._imwrite(os.path.join(out, f), np.clip(p, 0, 65535).astype(np.uint16))
    return out


def test_score_matches_the_jax_tool(tmp_path):
    """score on the JAX tool's folders: the degraded input, a noisy
    prediction and the mean baseline at 128x128, and the SR rule (an LR
    prediction against the HR target) on a 2x upsampled set; within 1e-9."""
    dirs, intr = jqe.write_dataset(str(tmp_path / "main"), 2, 2, 128, 128)
    preds = [dirs["test_in"], _predictions(dirs, str(tmp_path / "noisy"), 0),
             jqe.write_mean_baseline(dirs, str(tmp_path / "mean"))]
    cases = [(dirs, p, intr) for p in preds]
    # the SR rule: an HR target, the LR input as the prediction
    sr = {k: str(tmp_path / "sr" / k) for k in ("test_in", "test_gt")}
    for k in sr.values():
        os.makedirs(k)
    for f in sorted(os.listdir(dirs["test_gt"])):
        gt = _pixels(os.path.join(dirs["test_gt"], f))
        qe._imwrite(os.path.join(sr["test_gt"], f), np.repeat(np.repeat(gt, 2, 0), 2, 1))
        qe._imwrite(os.path.join(sr["test_in"], f),
                    _pixels(os.path.join(dirs["test_in"], f)))
    cases.append((sr, sr["test_in"], intr))
    for d, pred, k in cases:
        want, got = jqe.score(d, pred, k), qe.score(d, pred, k)
        assert sorted(want) == sorted(got) and len(got) == 9
        for name in want:
            assert abs(got[name] - want[name]) <= 1e-9 * max(1.0, abs(want[name])), \
                (pred, name, got[name], want[name])


def _tool_args(tmp_path, stage, width=8, extra=()):
    args = qe.build_parser().parse_args(
        ["--root", str(tmp_path), "--stage", stage, "--device", "cpu", *extra])
    args.ckpt_dir = os.path.join(args.root, "ckpt")
    args.width = width
    return args


@pytest.mark.parametrize("stage", ["main", "sr", "i2d", "translation"])
@pytest.mark.parametrize("handoff", ["", "_shared_init", "_continue_latest"])
def test_train_argv_means_what_the_jax_tools_does(tmp_path, stage, handoff):
    """The port's train argv for each stage parses, with the port's
    options, to the JAX tool's argv plus --device (the same flags and
    values, in whichever order); at width None it holds no width flag and
    the nets take the options' defaults."""
    dirs = {k: str(tmp_path / k) for k in qe._MAIN_DIRS}
    intr = str(tmp_path / "intr")
    extra = ["--i2d_train_features"] if stage == "i2d" else []
    args = _tool_args(tmp_path, stage, extra=extra)
    jargs = _tool_args(tmp_path, stage, extra=extra)
    if stage == "sr":
        args._load_hw = jargs._load_hw = (240, 320)
    if handoff:
        setattr(args, handoff, True)
        setattr(jargs, handoff, True)
    argv = qe._train_argv(dirs, intr, args, "x")
    jargv = jqe._train_argv(dirs, intr, jargs, "x")
    assert argv[argv.index("--device") + 1] == "cpu"
    got = vars(train_options.parse(argv[1:], print_options=False))
    want = vars(train_options.parse(jargv[1:] + ["--device", "cpu"], print_options=False))
    assert got == want
    assert got["device"] == "cpu"
    args.width = None
    argv = qe._train_argv(dirs, intr, args, "x")
    opt = train_options.parse(argv[1:], print_options=False)
    defaults = train_options.parse([], print_options=False)
    for flag in qe.width_flags(8, "i2d" if stage == "i2d" else "main"):
        if flag.startswith("--"):
            assert flag not in argv
            assert getattr(opt, flag[2:]) == getattr(defaults, flag[2:])


def test_width_flags_name_every_width_once():
    assert qe.width_flags(None) == [] and qe.width_flags(None, "i2d") == []
    assert qe.width_flags(8) == jqe.width_flags(8)
    assert qe.width_flags(16, "i2d") == jqe.width_flags(16, "i2d")


def test_the_tool_refuses_to_run_without_a_card(tmp_path, capsys):
    """--device cuda (the default) without a card exits before anything is
    written; so does a device that is neither cuda nor cpu."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    root = tmp_path / "q"
    for argv in (["--root", str(root)], ["--root", str(root), "--device", "mps"]):
        with pytest.raises(SystemExit) as e:
            qe.main(argv)
        assert e.value.code == 2
    assert not root.exists()
    assert "no CUDA device" in capsys.readouterr().err


_SHIM_MODULES = ("albumentations", "torchvision", "torchvision.transforms",
                 "torchvision.transforms.functional")


@pytest.fixture
def clean_shim():
    """sys.modules without the shim's modules, restored afterwards."""
    saved = {n: sys.modules.pop(n, None) for n in _SHIM_MODULES}
    yield
    for n, m in saved.items():
        sys.modules.pop(n, None)
        if m is not None:
            sys.modules[n] = m


def _shim(install):
    for n in _SHIM_MODULES:
        sys.modules.pop(n, None)
    install()
    return sys.modules["albumentations"], sys.modules["torchvision.transforms"]


def test_albu_shim_on_the_port_transforms_equals_the_jax_tools(clean_shim):
    """The reference arm's albumentations shim: one Compose over image and
    depth with the same ``random`` draws through the JAX tool's shim (on
    cv2) and the port's (on ``data/transforms.py``): Resize (INTER_AREA),
    RandomCrop, HorizontalFlip, PadIfNeeded within 1e-5 of the range (cv2's
    INTER_AREA order of sums), Rotate within 1e-4;
    torchvision's ColorJitter on the port's jitter, other transforms inert."""
    from PIL import Image

    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (96, 128, 3)).astype(np.float32)
    depth = rng.uniform(0, 1, (96, 128)).astype(np.float32)
    outs = {}
    for tag, install in (("jax", jqe._install_albu_shim), ("port", qe._install_albu_shim)):
        A, tvt = _shim(install)
        pipes = {
            "exact": A.Compose([A.Resize(80, 112, interpolation=3), A.RandomCrop(64, 64),
                                A.HorizontalFlip(p=0.5), A.PadIfNeeded(72, 80)], p=1,
                               additional_targets={"depth": "image"}),
            "rotate": A.Compose([A.Rotate(limit=(-10, 10), p=1.0)], p=1,
                                additional_targets={"depth": "image"}),
        }
        for name, pipe in pipes.items():
            random.seed(5)
            outs[tag, name] = pipe(image=img, depth=depth)
        random.seed(5)
        jit = tvt.ColorJitter(brightness=0.1, contrast=0.1, saturation=0.1, hue=0.05)
        outs[tag, "jitter"] = np.asarray(jit(Image.fromarray(img.astype(np.uint8))))
        with pytest.raises(NotImplementedError):
            tvt.ToTensor()(img)
        assert not hasattr(sys.modules["torchvision"], "__version__")
    for k in ("image", "depth"):
        a, b = outs["jax", "exact"][k], outs["port", "exact"][k]
        assert a.shape == b.shape == ((72, 80, 3) if k == "image" else (72, 80))
        # cv2's INTER_AREA sums in another order (tests/test_torch_resize.py)
        assert np.abs(a - b).max() <= 1e-5 * max(1.0, float(np.abs(a).max())), k
        a, b = outs["jax", "rotate"][k], outs["port", "rotate"][k]
        assert np.abs(a - b).max() <= 1e-4 * max(1.0, float(np.abs(a).max())), k
    assert outs["port", "jitter"].shape == (96, 128, 3)
    assert np.array_equal(outs["jax", "jitter"], outs["port", "jitter"])


def test_the_tools_host_chain_loads_no_imageio_cv2_or_jax(tmp_path):
    """Writers, baselines and score in a fresh interpreter: the card's
    machine has no imageio, and the port calls no cv2."""
    import subprocess

    code = (
        "import sys\n"
        "from desr_tpu_torch.tools import quality_eval as qe\n"
        f"root = {str(tmp_path)!r}\n"
        "d, i = qe.write_dataset(root + '/m', 1, 1, 64, 64)\n"
        "qe.write_mean_baseline(d, root + '/mean')\n"
        "qe.score(d, d['test_in'], i)\n"
        "d, i = qe.write_dataset_sr(root + '/sr', 0, 1)\n"
        "qe.write_bicubic_baseline(d, root + '/bic')\n"
        "qe.write_dataset_translation(root + '/t', 1, 1, hw=(32, 32))\n"
        "bad = [m for m in ('cv2', 'imageio', 'jax', 'desr_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
