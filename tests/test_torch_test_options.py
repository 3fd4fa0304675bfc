"""The port's test options and ``save_image``'s aspect stretch on the CPU,
against the JAX package's ``TestOptions`` and ``utils/util.save_image``
(PIL's bicubic resize)."""

import numpy as np
import pytest
from PIL import Image

from desr_tpu_torch.data import png
from desr_tpu_torch.options import test_options, train_options
from desr_tpu_torch.utils import util


@pytest.mark.parametrize("extra", [
    [],
    ["--model_type", "main", "--results_dir", "/tmp/r", "--aspect_ratio", "1.5", "--seed", "4"],
    ["--model_type", "translation", "--phase", "val", "--gpu_ids", "0,1"],
    ["--dataset_mode", "template", "--new_dataset_option", "3", "--suffix", "{model_type}"],
])
def test_options_share_jax_values(tmp_path, monkeypatch, extra):
    """On the same argv, every key both parsers know has the same value,
    but ``pallas_conv``: JAX leaves None for its models' per-stage default
    (off in every stage), which the port resolves at parse time. phase
    defaults to test, isTrain is False, and the options block lands in
    <checkpoints_dir>/<name>/<phase>_opt.txt as JAX writes it."""
    from desr_tpu.options.test_options import TestOptions

    monkeypatch.setenv("DESR_COMPILE_CACHE_DIR", "")  # JAX's parse points XLA's cache there
    argv = ["--name", "t", "--checkpoints_dir", str(tmp_path / "ck")] + extra
    want = vars(TestOptions().parse(argv))
    got = vars(test_options.parse(argv + ["--device", "cpu"]))
    assert want.pop("pallas_conv") is None and got.pop("pallas_conv") is False
    shared = set(got) & set(want)
    assert {"results_dir", "aspect_ratio", "phase", "isTrain", "gpu_ids"} <= shared
    assert len(shared) > 150
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
    assert got["isTrain"] is False and (got["phase"] == "test" or "--phase" in extra)
    assert (tmp_path / "ck" / got["name"] / f"{got['phase']}_opt.txt").exists()


def test_train_options_stay_train():
    opt = train_options.parse(["--device", "cpu"], print_options=False)
    assert opt.isTrain is True and opt.phase == "train" and not hasattr(opt, "aspect_ratio")


@pytest.mark.parametrize("aspect_ratio", [0.5, 0.75, 1.5, 2.0, 1.0])
@pytest.mark.parametrize("shape", [(37, 53, 3), (64, 80, 3)])
def test_save_image_stretch_equals_pil(tmp_path, aspect_ratio, shape):
    """save_image(aspect_ratio) stretches the width (> 1) or the height
    (< 1) to the JAX function's size with PIL's Image.BICUBIC, and writes it
    through the port's PNG codec: the decoded pixels byte-equal to the JAX
    function's PIL-written file, flat areas and hard edges included."""
    from desr_tpu.utils.util import save_image as jax_save_image

    rng = np.random.default_rng(int(aspect_ratio * 100))
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    img[:8] = 0
    img[8:12] = 255
    img[:, :5] = 255
    util.save_image(img, tmp_path / "port.png", aspect_ratio)
    jax_save_image(img, str(tmp_path / "jax.png"), aspect_ratio)
    got, want = png.read_png(tmp_path / "port.png"), np.array(Image.open(tmp_path / "jax.png"))
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
