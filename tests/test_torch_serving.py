"""The port's serving deployment on the CPU: K1/K2 as registered operators,
``desr_tpu_torch/serving.py``'s artifact and ``predict --export /
--from_export / --num_workers``, against the live CLI and the JAX package's
artifact.

Small widths (tests/test_serving_export.py's), float32, 3 frames of
100x140 at batch 2: the last batch holds one frame, so serving from the
artifact pads it to the frozen batch size and writes no extra PNG.
"""

import collections
import json
import os
import shutil

import numpy as np
import pytest
import torch

from desr_tpu_torch import predict
from desr_tpu_torch.data import png
from desr_tpu_torch.models.main_model import MainModel, NetOptions
from desr_tpu_torch.models.main_sr_model import MainSRModel
from desr_tpu_torch.ops import conv3x3 as K
from desr_tpu_torch.serving import export_serving, load_serving

torch.set_num_threads(2)

SMALL = dict(ImageDepthf_outf=8, ImageDepthf_basef=8, Depthf_outf=8, Depthf_basef=8,
             I2D_base=8, Task_basef=8)
NET_ARGS = ["--net_args"] + [a for k, v in SMALL.items() for a in (f"--{k}", str(v))]
FRAMES = ["f0.png", "f1.png", "f2.png"]


def _frames(folder, n=3, hw=(100, 140), seed=0):
    rng = np.random.default_rng(seed)
    for sub in ("depth", "img"):
        os.makedirs(folder / sub, exist_ok=True)
    for i in range(n):
        png.write_png(folder / "depth" / f"f{i}.png",
                      rng.integers(0, 6000, hw).astype(np.uint16))
        png.write_png(folder / "img" / f"f{i}.png",
                      rng.integers(0, 255, hw + (3,)).astype(np.uint8))


def _pngs(folder):
    return {f: png.read_png(folder / f).astype(np.int32) for f in sorted(os.listdir(folder))}


def _base(root):
    return ["--name", "x", "--checkpoints_dir", str(root / "ckpt"),
            "--input_depth", str(root / "depth"), "--input_img", str(root / "img"),
            "--batch_size", "2", "--compute_dtype", "float32", "--device", "cpu"]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Seeded .pth files, the live CLI's PNGs, the port's artifact and the
    PNGs served from it."""
    from desr_tpu_torch import checkpoints as ckpt

    root = tmp_path_factory.mktemp("serving")
    _frames(root)
    model = MainModel(NetOptions(**SMALL), device="cpu", generator=torch.Generator().manual_seed(3))
    for name in model.model_names:
        ckpt.save_net(model.nets[name], ckpt.net_ckpt_path(str(root / "ckpt"), "x", "latest", name))
    predict.main(_base(root) + ["--output", str(root / "live")] + NET_ARGS)
    manifest = predict.main(_base(root) + ["--output", str(root / "unused"),
                                           "--export", str(root / "art")] + NET_ARGS)
    predict.main(["--input_depth", str(root / "depth"), "--input_img", str(root / "img"),
                  "--output", str(root / "exp"), "--from_export", str(root / "art"),
                  "--device", "cpu"])
    return root, manifest


# ------------------------------------------------------------ (a) the operators

@pytest.mark.parametrize("variant", ["prologue_relu_stats", "stats", "no_stats"])
@pytest.mark.parametrize("mode", ["reflect", "replicate", "zeros"])
def test_conv3x3_fused_op_passes_opcheck(mode, variant):
    """Schema, fake (meta) implementation, autograd registration and the
    AOT-dispatch trace of desr::conv3x3_fused."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(2, 5, 6, 4, generator=gen, requires_grad=True)
    w = torch.randn(3, 4, 3, 3, generator=gen, requires_grad=True)
    pro = variant == "prologue_relu_stats"
    sc = (torch.rand(2, 4, generator=gen) + 0.5).requires_grad_(True) if pro else None
    sh = torch.randn(2, 4, generator=gen, requires_grad=True) if pro else None
    torch.library.opcheck(torch.ops.desr.conv3x3_fused.default,
                          (x, w, sc, sh, mode, pro, variant != "no_stats"))


@pytest.mark.parametrize("mode", ["reflect", "replicate", "zeros"])
def test_conv3x3_op_passes_opcheck(mode):
    gen = torch.Generator().manual_seed(6)
    torch.library.opcheck(torch.ops.desr.conv3x3.default,
                          (torch.randn(2, 5, 6, 4, generator=gen, requires_grad=True),
                           torch.randn(3, 4, 3, 3, generator=gen, requires_grad=True), mode))


# ------------------------------------------------------------ (b)-(f) the artifact

def test_artifact_serves_the_live_clis_pngs(served):
    """--export then --from_export: the live CLI's PNGs exactly, three
    frames from two batches of 2 (the tail padded, its extra not written)."""
    root, manifest = served
    assert sorted(os.listdir(root / "art")) == ["manifest.json", "params.npz", "serving.pt2"]
    assert not (root / "unused").exists()  # --export writes no PNGs
    with open(root / "art" / "manifest.json") as f:
        assert json.load(f) == manifest
    assert manifest["batch"] == {"B_d": [[2, 128, 256, 1], "float32"],
                                 "B_i": [[2, 128, 256, 3], "float32"]}
    assert (manifest["output_key"], manifest["sr"], manifest["out_scale"]) == (
        "pred_real_depth", False, 1)
    assert manifest["compute_dtype"] == "float32" and manifest["platforms"] == ["cpu"]
    assert manifest["provenance"]["name"] == "x"
    live, exp = _pngs(root / "live"), _pngs(root / "exp")
    assert sorted(live) == sorted(exp) == FRAMES
    for f in FRAMES:
        assert exp[f].shape == (100, 140)
        np.testing.assert_array_equal(exp[f], live[f], err_msg=f)


def test_artifact_refuses_other_geometries_and_devices(served, tmp_path):
    root, _ = served
    fn, params, _ = load_serving(str(root / "art"))
    with pytest.raises(ValueError, match="does not match the exported geometry"):
        fn(params, {"B_d": np.zeros((2, 128, 128, 1), np.float32),
                    "B_i": np.zeros((2, 128, 128, 3), np.float32)})
    with pytest.raises(ValueError, match="does not match the exported geometry"):
        fn(params, {"B_d": np.zeros((2, 128, 256, 1), np.float64),
                    "B_i": np.zeros((2, 128, 256, 3), np.float32)})
    with pytest.raises(ValueError, match=r"exported on \['cpu'\], not cuda"):
        load_serving(str(root / "art"), device="cuda")
    _frames(tmp_path, n=1, hw=(100, 300))  # wider than the artifact's 256
    with pytest.raises(ValueError, match="exceeds the exported geometry"):
        predict.main(["--input_depth", str(tmp_path / "depth"), "--input_img",
                      str(tmp_path / "img"), "--output", str(tmp_path / "o"),
                      "--from_export", str(root / "art"), "--device", "cpu"])


def test_artifact_serves_the_weights_in_params(served):
    """The program runs with ``params`` swapped in: changing one entry changes
    the prediction, and the unchanged dict gives the CLI's values."""
    root, _ = served
    fn, params, _ = load_serving(str(root / "art"))
    rng = np.random.default_rng(1)
    batch = {"B_d": rng.uniform(-1, 1, (2, 128, 256, 1)).astype(np.float32),
             "B_i": rng.uniform(-1, 1, (2, 128, 256, 3)).astype(np.float32)}
    base = fn(params, batch)
    assert base.shape == (2, 128, 256) and base.dtype == torch.float32
    torch.testing.assert_close(fn(params, batch, seed=7), base, rtol=0, atol=0)
    bumped = {net: dict(sub) for net, sub in params.items()}
    bumped["Task"]["model.model.0.weight"] = bumped["Task"]["model.model.0.weight"] * 1.5
    assert (fn(bumped, batch) - base).abs().max() > 1e-4
    torch.testing.assert_close(fn(params, batch), base, rtol=0, atol=0)


def test_jax_params_npz_serves_from_the_ports_artifact(served, tmp_path):
    """JAX's ``predict.py --export`` on the same widths and frames writes a
    params.npz that the port's artifact serves unchanged; its PNGs are within
    3 mm of JAX's own ``--from_export`` PNGs (the CLI parity bound of
    tests/test_torch_slice.py)."""
    import imageio.v2 as imageio

    import predict as jax_predict

    root, _ = served
    jax_art = tmp_path / "jax_art"
    common = ["--input_depth", str(root / "depth"), "--input_img", str(root / "img")]
    jax_predict.main(["--name", "x", "--checkpoints_dir", str(tmp_path / "none"), *common,
                      "--batch_size", "2", "--compute_dtype", "float32", "--num_devices", "1",
                      "--output", str(tmp_path / "unused"), "--export", str(jax_art)]
                     + NET_ARGS)
    jax_predict.main(["--name", "x", *common, "--output", str(tmp_path / "out_jax"),
                      "--from_export", str(jax_art)])
    art = tmp_path / "art"
    shutil.copytree(root / "art", art)
    shutil.copy(jax_art / "params.npz", art / "params.npz")
    predict.main([*common, "--output", str(tmp_path / "out_port"), "--from_export", str(art),
                  "--device", "cpu"])
    got = _pngs(tmp_path / "out_port")
    assert sorted(got) == FRAMES
    own = _pngs(root / "exp")
    assert any(np.abs(got[f] - own[f]).max() > 3 for f in FRAMES)  # JAX's weights served
    for f in FRAMES:
        want = imageio.imread(tmp_path / "out_jax" / f).astype(np.int32)
        assert np.abs(got[f] - want).max() <= 3, (f, np.abs(got[f] - want).max())


def test_num_workers_writes_the_inline_pngs(served, tmp_path):
    """--num_workers 2 (spawned decode and write workers) against the inline run."""
    root, _ = served
    predict.main(_base(root) + ["--output", str(tmp_path / "w2"), "--num_workers", "2"]
                 + NET_ARGS)
    got, want = _pngs(tmp_path / "w2"), _pngs(root / "live")
    assert sorted(got) == FRAMES
    for f in FRAMES:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


# ------------------------------------------------------------ (g) the graph

@pytest.mark.parametrize("route", ["main", "pallas_conv", "SR"])
def test_exported_graph_has_one_kernel_node_per_resnetblock_conv(route, tmp_path):
    """24 desr::conv3x3_fused nodes (K1; desr::conv3x3, K2, under
    --pallas_conv): I2D_features' and Depth_f's 6 ResnetBlocks, 2 convs
    each; every other conv node is one of the nets' library convs, so no
    plain version stands in for a kernel."""
    opt = NetOptions(**SMALL, pallas_conv=route == "pallas_conv",
                     crop_size_h=128, crop_size_w=128)
    cls = MainSRModel if route == "SR" else MainModel
    model = cls(opt, device="cpu", compute_dtype=torch.float32)
    hw = (256, 256) if route == "SR" else (128, 128)
    batch = {"B_d": np.zeros((1, *hw, 1), np.float32), "B_i": np.zeros((1, *hw, 3), np.float32)}
    export_serving(model, batch, str(tmp_path), model._dump_key)
    program = torch.export.load(str(tmp_path / "serving.pt2"))
    ops = collections.Counter(str(n.target) for n in program.graph.nodes
                              if n.op == "call_function")
    blocks = [m for m in model.serving_module().modules() if hasattr(m, "_convs")]
    assert len(blocks) == 12
    kernel = "desr.conv3x3.default" if route == "pallas_conv" else "desr.conv3x3_fused.default"
    assert ops[kernel] == 2 * len(blocks)
    assert ops["desr.conv3x3.default" if kernel != "desr.conv3x3.default"
               else "desr.conv3x3_fused.default"] == 0
    library = sum(isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))
                  for m in model.serving_module().modules()) - 2 * len(blocks)
    assert sum(v for k, v in ops.items() if k.startswith("aten.conv")) == library
    counts = K.conv3x3_fused.launches, K.conv3x3.launches
    fn, params, _ = load_serving(str(tmp_path))
    got = fn(params, batch)
    assert got.shape == (1, *hw) and bool(torch.isfinite(got).all())
    # on the CPU the operators run their plain versions and launch nothing
    assert (K.conv3x3_fused.launches, K.conv3x3.launches) == counts
    torch.testing.assert_close(got, model.serve_forward(batch), rtol=0, atol=0)


@pytest.mark.parametrize("route", ["main", "pallas_conv", "SR"])
def test_exported_graph_has_one_k4_node_per_norm_and_tail(route, tmp_path):
    """One desr::instance_norm_moments node per InstanceNorm the serving
    nets call as a layer (all but the fused ResnetBlocks' two each; under
    --pallas_conv those too) and one desr::norm_apply node per such norm and
    per fused ResnetBlock's tail; the artifact serves the live forward's
    values, and on the CPU K4 launches nothing."""
    from desr_tpu_torch.models.layers import InstanceNorm2d
    from desr_tpu_torch.ops import instance_norm as IN

    fused = route != "pallas_conv"
    opt = NetOptions(**SMALL, pallas_conv=not fused, crop_size_h=128, crop_size_w=128)
    model = (MainSRModel if route == "SR" else MainModel)(opt, device="cpu",
                                                           compute_dtype=torch.float32)
    hw = (256, 256) if route == "SR" else (128, 128)
    batch = {"B_d": np.zeros((1, *hw, 1), np.float32), "B_i": np.zeros((1, *hw, 3), np.float32)}
    export_serving(model, batch, str(tmp_path), model._dump_key)
    program = torch.export.load(str(tmp_path / "serving.pt2"))
    ops = collections.Counter(str(n.target) for n in program.graph.nodes
                              if n.op == "call_function")
    modules = list(model.serving_module().modules())
    blocks = sum(hasattr(m, "_convs") for m in modules)
    norms = sum(isinstance(m, InstanceNorm2d) for m in modules) - (2 * blocks if fused else 0)
    assert blocks == 12 and norms == (32 if fused else 56)
    assert ops["desr.instance_norm_moments.default"] == norms
    assert ops["desr.norm_apply.default"] == norms + (blocks if fused else 0)
    counts = IN.instance_norm_moments.launches, IN.norm_apply.launches
    fn, params, _ = load_serving(str(tmp_path))
    got = fn(params, batch)
    assert (IN.instance_norm_moments.launches, IN.norm_apply.launches) == counts
    torch.testing.assert_close(got, model.serve_forward(batch), rtol=0, atol=0)
