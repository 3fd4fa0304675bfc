"""The port's visuals, gallery and stage-2 metric API against the JAX
package, float32 on the CPU: each model's ``calculate(stage="train")``
visuals (the eval forward, no holes drawn) on the same weights and inputs,
the HTML gallery's files against JAX's ``Visualizer`` on the same values,
``TranslationModel``'s metric API, and the port's own copies of
``utils/util.py`` and ``utils/html.py``.
"""

import os

import numpy as np
import pytest
import torch

import test_torch_i2d as TI
import test_torch_train as TTR
import test_torch_translation as TTL
from desr_tpu_torch.data.png import read_png
from desr_tpu_torch.models.main_model import MainModel
from desr_tpu_torch.options import train_options
from desr_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)


def _assert_visuals(got, want, squeeze=()):
    """Same keys; each value within 1e-4 (float32, p=0). ``squeeze``: keys
    whose JAX value carries a trailing channel of 1 the port's planar one
    does not."""
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.asarray(v)
        if k in squeeze:
            v = v[..., 0]
        g = got[k]
        assert g.shape == v.shape and g.dtype == np.float32, (k, g.shape, v.shape)
        np.testing.assert_allclose(g, v, rtol=0, atol=1e-4, err_msg=k)


@pytest.fixture(scope="module")
def main_pair(tmp_path_factory):
    """JAX's MainModel and the port's on the same weights, each after
    ``calculate(stage="train")`` on the same batch."""
    from desr_tpu.models.main_model import MainModel as JaxMainModel
    from desr_tpu.options.train_options import TrainOptions

    ck = str(tmp_path_factory.mktemp("ck"))
    argv = TTR.STAGE3 + TTR.SMALL + ["--name", "v", "--checkpoints_dir", ck, "--batch_size",
                                     str(TTR.B), "--crop_size_h", str(TTR.H),
                                     "--crop_size_w", str(TTR.W)]
    jm = JaxMainModel(TrainOptions().parse(argv))
    jm.setup()
    tm = MainModel(train_options.parse(argv + ["--device", "cpu"], print_options=False),
                   device="cpu", compute_dtype=torch.float32, is_train=True)
    for n, p in jm.params.items():
        tm.nets[n].load_state_dict(from_jax_params({k: np.array(v) for k, v in p.items()}),
                                   strict=True)
    batch = TTR._batch()
    for m in (jm, tm):
        m.set_input(batch)
        m.calculate(stage="train")
    return jm, tm


def test_main_visuals_match_jax(main_pair):
    """The 13 visuals the main forward has of its 20 names (NHWC images,
    planar depths and masks) within 1e-4."""
    jm, tm = main_pair
    want = jm.get_current_visuals()
    assert len(want) == 13 and set(tm.visual_names) == set(jm.visual_names)
    _assert_visuals(tm.get_current_visuals(), want)


def test_gallery_files_match_jax_visualizer(main_pair, tmp_path):
    """Both Visualizers on the same visuals: the same file names and index
    HTML, and the PNGs decode to the same pixels. The port's is also handed
    the images as NCHW tensors (its models' other layout) and writes the
    same files."""
    from types import SimpleNamespace

    from desr_tpu.utils.visualizer import Visualizer as JaxVisualizer
    from desr_tpu_torch.utils.visualizer import Visualizer

    jm, _ = main_pair
    visuals = jm.get_current_visuals()
    port_visuals = {k: (torch.tensor(v).permute(0, 3, 1, 2) if v.ndim == 4 else torch.tensor(v))
                    for k, v in visuals.items()}
    dirs = {}
    for tag, cls, vis in (("jax", JaxVisualizer, visuals), ("port", Visualizer, visuals),
                          ("port_nchw", Visualizer, port_visuals)):
        opt = SimpleNamespace(name=tag, checkpoints_dir=str(tmp_path))
        cls(opt).display_current_results(vis, 3)
        dirs[tag] = tmp_path / tag / "web"
    names = sorted(os.listdir(dirs["jax"] / "images"))
    assert len(names) == 13 and names[0].startswith("epoch003_")
    want_html = (dirs["jax"] / "index.html").read_text()
    for tag in ("port", "port_nchw"):
        assert sorted(os.listdir(dirs[tag] / "images")) == names
        assert (dirs[tag] / "index.html").read_text() == want_html
        for n in names:
            got, want = read_png(dirs[tag] / "images" / n), read_png(dirs["jax"] / "images" / n)
            assert got.dtype == want.dtype == np.uint8 and got.shape[-1] == 3
            np.testing.assert_array_equal(got, want, err_msg=f"{tag}/{n}")


def test_calculate_keeps_train_metrics_out_of_visuals(main_pair):
    """``calculate`` leaves its metrics in ``metrics`` and the visuals as
    float32 arrays; the loss names read from the metrics only."""
    _, tm = main_pair
    assert set(tm.get_current_losses()) == set(tm.loss_names)
    assert all(isinstance(v, np.ndarray) for v in tm.get_current_visuals().values())


def test_i2d_visuals_match_jax(tmp_path):
    """The six I2D visuals; JAX's predictions keep a channel of 1."""
    jm, tm, _ = TI._pair(tmp_path)
    batch = TI._batch(2)
    for m in (jm, tm):
        m.set_input(batch)
        m.calculate(stage="train")
    _assert_visuals(tm.get_current_visuals(), jm.get_current_visuals(),
                    squeeze=("pred_syn_depth", "pred_real_depth"))


@pytest.fixture(scope="module")
def translation_pair(tmp_path_factory):
    jm, tm, _ = TTL._pair(tmp_path_factory.mktemp("tr"), ["--use_cycle_A"])
    batch = TTL._batch(1)
    for m in (jm, tm):
        m.set_input(batch)
        m.calculate(stage="train")
    return jm, tm


def test_translation_visuals_match_jax(translation_pair):
    """The eight visuals under --use_cycle_A (and the default --use_cycle_B)."""
    jm, tm = translation_pair
    assert tm.visual_names == tuple(jm.visual_names) and len(tm.visual_names) == 8
    _assert_visuals(tm.get_current_visuals(), jm.get_current_visuals())


@pytest.mark.parametrize("name", ["get_L1_loss", "get_L1_loss_syn", "get_L1_loss_cycle",
                                  "get_L1_loss_cycle_syn", "get_dif", "get_dif_syn"])
def test_translation_metric_api_matches_jax(translation_pair, name):
    """Each metric of translation_model.py:550-602 on the same visuals'
    forward, within 1e-5 (meters)."""
    jm, tm = translation_pair
    got, want = getattr(tm, name)(), getattr(jm, name)()
    assert isinstance(got, float) and np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_translation_mask_and_test_loss_match_jax(translation_pair):
    jm, tm = translation_pair
    depth = TTL._batch(1)["B_depth"][..., 0]
    np.testing.assert_array_equal(tm.get_mask(torch.from_numpy(depth)), jm.get_mask(depth))
    for m in (jm, tm):
        m.calc_test_loss()
    np.testing.assert_allclose(tm.test_depth_dif_A, jm.test_depth_dif_A, rtol=1e-5)
    np.testing.assert_allclose(tm.test_depth_dif_B, jm.test_depth_dif_B, rtol=1e-5)


def test_util_helpers_match_jax(tmp_path):
    """tensor2im, data_to_meters, crop_indx, diagnose_network and mkdirs
    against desr_tpu.utils.util; save_image's PNG decodes to the pixels
    PIL writes; an aspect ratio other than 1 is refused."""
    from desr_tpu.utils import util as J
    from desr_tpu_torch.utils import util as T

    rng = np.random.default_rng(0)
    for shape in ((1, 8, 9, 3), (8, 9, 1), (8, 9, 3)):
        a = rng.uniform(-1.2, 1.2, shape).astype(np.float32)
        np.testing.assert_array_equal(T.tensor2im(a), J.tensor2im(a))
    d = rng.uniform(-1, 1, (4, 5)).astype(np.float32)
    np.testing.assert_array_equal(T.data_to_meters(d, 5100), J.data_to_meters(d, 5100))
    assert T.crop_indx("scene0000_00_2_3") == J.crop_indx("scene0000_00_2_3")
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32), "b": np.ones(2, np.float32)}
    assert T.diagnose_network({k: torch.from_numpy(v) for k, v in params.items()}) == \
        pytest.approx(J.diagnose_network(params), rel=1e-6)
    T.mkdirs([str(tmp_path / "x"), str(tmp_path / "y")])
    assert (tmp_path / "x").is_dir() and (tmp_path / "y").is_dir()
    img = T.tensor2im(rng.uniform(-1, 1, (7, 6, 3)).astype(np.float32))
    J.save_image(img, str(tmp_path / "j.png"))
    T.save_image(img, str(tmp_path / "t.png"))
    np.testing.assert_array_equal(read_png(tmp_path / "t.png"), read_png(tmp_path / "j.png"))
    with pytest.raises(NotImplementedError, match="aspect_ratio"):
        T.save_image(img, str(tmp_path / "s.png"), aspect_ratio=2.0)


def test_html_page_matches_jax(tmp_path):
    from desr_tpu.utils.html import HTML as JaxHTML
    from desr_tpu_torch.utils.html import HTML

    pages = {}
    for tag, cls in (("jax", JaxHTML), ("port", HTML)):
        page = cls(str(tmp_path / tag), "gallery", refresh=5)
        assert page.get_image_dir() == str(tmp_path / tag / "images")
        page.add_header("epoch 1")
        page.add_images(["a.png", "b.png"], ["a", "b"], ["a.png", "b.png"], width=128)
        page.save()
        pages[tag] = (tmp_path / tag / "index.html").read_text()
    assert pages["port"] == pages["jax"]


def test_plots_draw_each_panel_or_do_nothing(main_pair):
    """plot_main, plot_I2D and plot_translation draw a figure on the port's
    visuals where matplotlib imports (wandb None: nothing logged), and
    return None where it does not."""
    from unittest import mock

    from desr_tpu_torch.utils import plots

    _, tm = main_pair
    vis = tm.get_current_visuals()
    tr = {"real_img_A": vis["syn_image"], "real_depth_A": vis["syn_depth"],
          "fake_depth_B": vis["pred_syn_depth"], "real_depth_B": vis["real_depth"],
          "fake_depth_A": vis["pred_real_depth"]}
    have_mpl = plots._plt() is not None
    for fn, v in ((plots.plot_main, vis), (plots.plot_I2D, vis), (plots.plot_translation, tr)):
        fig = fn(None, v, 1)
        assert (fig is not None) == have_mpl
    with mock.patch.object(plots, "_plt", lambda: None):
        assert plots.plot_main(None, vis, 1) is None
        assert plots.plot_translation(None, tr, 1) is None
