"""Serving over the spatial mesh axis on the CPU: the four live serving
forwards (main, ``--SR``, ``--I2D``, ``--translate AtoB``) at small widths
over two gloo ranks that split each frame's rows, from one set of JAX
params, against the JAX package's unsharded forward and the port's one
process; ``predict --num_devices 2 --spatial_devices 2`` against
``--num_devices 1``; and the refusals.

The translator's hardcoded widths are cut to 8+8 channels and one block in
both packages. The ranks' functions live in tests/test_torch_spatial_ranks.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_spatial_ranks as R
from test_torch_common import randn  # noqa: F401  (caps torch's threads)

from desr_tpu.models import translation_networks as JTT
from desr_tpu_torch import checkpoints as ckpt
from desr_tpu_torch import parallel
from desr_tpu_torch.data import png

SMALL = ["--ImageDepthf_outf", "8", "--ImageDepthf_basef", "8", "--Depthf_outf", "8",
         "--Depthf_basef", "8", "--I2D_base", "8", "--Task_basef", "8",
         "--Imagef_outf", "8", "--Imagef_basef", "8"]
HW = {"main": 128, "sr": 256, "i2d": 128, "translate": 128}  # square frames


def _batch(h, seed):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(-0.5, 1, (2, h, h, 1)).astype(np.float32)
    depth[depth < -0.3] = -1.0  # holes
    img = rng.uniform(-1, 1, (2, h, h, 3)).astype(np.float32)
    K = np.tile(np.array([[[577.0, 0, 320], [0, 577, 240], [0, 0, 1]]], np.float32), (2, 1, 1))
    crop = np.tile(np.array([[0, h, 0, h]], np.float32), (2, 1))
    return {"A_i": img, "B_i": img, "A_d": depth, "B_d": depth, "K_A": K, "K_B": K,
            "crop_A": crop, "crop_B": crop}


def _jax_forwards():
    """{mode: (params as numpy, the unsharded JAX prediction)}."""
    from desr_tpu.models.i2d_model import I2DModel
    from desr_tpu.models.main_model import MainModel
    from desr_tpu.models.main_sr_model import MainSRModel
    from desr_tpu.models.translation_model import TranslationModel
    from desr_tpu.options.train_options import TrainOptions

    base = ["--name", "t", "--checkpoints_dir", "/nonexistent", "--compute_dtype", "float32",
            "--use_image_for_trans", "--use_masked", "--no_batched_branches", *SMALL]
    setups = {
        "main": (MainModel, ["--model_type", "main", "--crop_size_h", "128",
                             "--crop_size_w", "128"], "pred_real_depth"),
        "sr": (MainSRModel, ["--model_type", "main", "--SR", "--crop_size_h", "128",
                             "--crop_size_w", "128"], "pred_real_depth_hr"),
        "i2d": (I2DModel, ["--model_type", "I2D"], None),
        "translate": (TranslationModel, ["--model_type", "translation"], "fake_depth_B"),
    }
    out = {}
    for seed, (mode, (cls, argv, key)) in enumerate(setups.items()):
        jm = cls(TrainOptions().parse(base + argv))
        jm.init_params(seed)
        batch = {k: jnp.asarray(v) for k, v in _batch(HW[mode], seed).items()}
        if mode == "translate":
            fwd = jm._forward_fns()
            remap = {"A_depth": batch["A_d"], "A_img": batch["A_i"],
                     "B_depth": batch["B_d"], "B_img": batch["B_i"]}
            pred = jax.jit(lambda p, b: fwd(p, b, jax.random.PRNGKey(0), False)[key])(
                jm.params, remap)
        elif mode == "i2d":
            fwd = jm._forward_fn()
            pred = jax.jit(lambda p, b: fwd(p, b, jax.random.PRNGKey(0), False)[3][..., 0])(
                jm.params, batch)
        else:
            fwd = jm._forward_fn()
            pred = jax.jit(lambda p, b: fwd(p, b, jax.random.PRNGKey(0), False)[key])(
                jm.params, batch)
        params = {n: {k: np.asarray(v) for k, v in p.items()} for n, p in jm.params.items()}
        out[mode] = (params, np.asarray(pred))
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The JAX forwards, then one launch of two ranks (one spatial group)
    and one process, each serving the four modes from the same params."""
    with pytest.MonkeyPatch.context() as mp:
        full = JTT.default_translator_opt
        mp.setattr(JTT, "default_translator_opt",
                   lambda **kw: full(**dict(dict(ngf_img=8, ngf_depth=8, n_blocks=1), **kw)))
        jax_out = _jax_forwards()
    params = {m: p for m, (p, _) in jax_out.items()}
    batches = {m: _batch(HW[m], seed) for seed, m in enumerate(HW)}
    ranks = parallel.launch(R.serve_models, ["cpu", "cpu"], args=(params, batches), spatial=2,
                            workdir=tmp_path_factory.mktemp("ranks"))
    one = R.serve_models(parallel.make_mesh(["cpu"]), params, batches)
    return {m: w for m, (_, w) in jax_out.items()}, ranks, one


@pytest.mark.parametrize("mode", list(HW))
def test_spatial_forward_matches_jax_and_one_process(served, mode):
    """The two ranks' rows of the prediction, concatenated: within 1e-3 of
    the JAX package's unsharded forward (tests/test_torch_slice.py's bound)
    and within 1e-5 of the port's one-process forward, float32."""
    jax_pred, ranks, (one, _) = served
    got = np.concatenate([ranks[r][0][mode] for r in range(2)], axis=1)
    assert got.shape == jax_pred[mode].shape == one[mode].shape == (2, HW[mode], HW[mode])
    np.testing.assert_allclose(got, one[mode], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, jax_pred[mode], rtol=0, atol=1e-3)


@pytest.mark.parametrize("mode", list(HW))
def test_spatial_forward_launches_k1_with_halo_rows(served, mode):
    """Each rank launches K1 as often as one process, every launch with a
    halo row (the bands of its ResnetBlocks), and both ranks issue the same
    collectives; one process issues none."""
    _, ranks, (_, one) = served
    c0, c1 = ranks[0][1][mode], ranks[1][1][mode]
    assert c0 == c1
    assert c0["K1"] == one[mode]["K1"] > 0 and c0["K1_halo"] == c0["K1"]
    assert c0["exchange"] > 0 and c0["all_reduce"] > 0
    assert one[mode]["exchange"] == one[mode]["all_reduce"] == one[mode]["gather"] == 0


# ----------------------------------------------------------------- the CLI

def _frames_and_checkpoints(root):
    from desr_tpu_torch.models.main_model import MainModel, NetOptions

    small = dict(zip(SMALL[::2], map(int, SMALL[1::2])))
    small = {k[2:]: v for k, v in small.items()}
    rng = np.random.default_rng(0)
    for sub in ("depth", "img"):
        os.makedirs(root / sub)
    for i in range(3):
        png.write_png(root / "depth" / f"f{i}.png",
                      rng.integers(0, 6000, (100, 140)).astype(np.uint16))
        png.write_png(root / "img" / f"f{i}.png",
                      rng.integers(0, 255, (100, 140, 3)).astype(np.uint8))
    model = MainModel(NetOptions(**small), device="cpu", generator=torch.Generator().manual_seed(3))
    for name in model.model_names:
        ckpt.save_net(model.nets[name], ckpt.net_ckpt_path(str(root / "ck"), "x", "latest", name))
    return ["--name", "x", "--checkpoints_dir", str(root / "ck"),
            "--input_depth", str(root / "depth"), "--input_img", str(root / "img"),
            "--batch_size", "2", "--compute_dtype", "float32", "--device", "cpu",
            "--net_args", *SMALL[:12]]


def test_predict_spatial_devices_2_matches_one_device(tmp_path):
    """``predict --device cpu --num_devices 2 --spatial_devices 2``: 3 frames
    of 100x140 (padded to 128x256, 64 rows a rank) at batch 2: the PNGs
    within one uint16 step of ``--num_devices 1``'s."""
    from desr_tpu_torch import predict

    argv = _frames_and_checkpoints(tmp_path)
    outs = {}
    for n, extra in ((1, []), (2, ["--spatial_devices", "2"])):
        out = tmp_path / f"out{n}"
        flags = ["--output", str(out), "--num_devices", str(n), *extra]
        assert predict.main(flags + argv) == 3
        outs[n] = {f: png.read_png(out / f) for f in sorted(os.listdir(out))}
    assert sorted(outs[2]) == ["f0.png", "f1.png", "f2.png"]
    for f, a in outs[1].items():
        b = outs[2][f]
        assert a.shape == b.shape == (100, 140)
        assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1, f


# the --num_workers case keeps the id it had while it was refused: it now
# parses (msg None; tests/test_torch_spatial_last.py serves with it)
@pytest.mark.parametrize("flags,msg", [
    (["--export", "x"], "not with --spatial_devices"),
    (["--from_export", "x"], "not with --spatial_devices"),
    pytest.param(["--num_workers", "2"], None, id="flags2-not yet ported"),
    (["--num_devices", "3"], "does not divide by --spatial_devices 2"),
])
def test_predict_spatial_refusals(tmp_path, capsys, flags, msg):
    from desr_tpu_torch import predict

    argv = ["--name", "x", "--input_depth", str(tmp_path), "--input_img", str(tmp_path),
            "--output", str(tmp_path / "o"), "--device", "cpu", "--spatial_devices", "2"]
    if msg is None:
        args, _ = predict._parse(argv + flags)
        assert (args.num_workers, args.spatial_devices) == (2, 2)
        return
    with pytest.raises(SystemExit) as e:
        predict.main(argv + flags)
    assert e.value.code != 0 and msg in capsys.readouterr().err
