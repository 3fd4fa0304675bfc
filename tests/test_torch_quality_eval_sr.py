"""``--stage sr`` of the port's quality tool on the CPU: the x2 SR chain at
its fixed geometry (480x640 sensor frames, 960x1280 HR canvases padded to
1024x1280), served through each package's exported artifact (``predict
--SR --export`` then ``--from_export``).

As in tests/test_torch_quality_eval_main.py: one set of the port's seeded
weights (width 8, float32) is served and scored by both tools, since the
hole sampler's RNG streams differ and trained trajectories cannot match bit
for bit; then ``--framework ours`` end to end (one main-stage pretrain, the
SR fine-tune at lr / 10 from its ``latest`` checkpoints), and ``both``,
which skips without the reference checkout.
"""

import json
import os

import numpy as np
import pytest

from test_torch_common import (check_result, ours_only, quality_tools,  # noqa: F401
                               reference_root, serve_and_score_both)

jqe, qe = quality_tools()


def _crop_sr_set(dirs, root, hr=256):
    """The SR set's test frames cut to an ``hr`` x ``hr`` HR corner (the
    LR input and image to half of it): the same chain at a 128x128 LR grid."""
    from desr_tpu_torch.data.native_io import read_image

    out = dict(dirs)
    for key, side in (("test_in_hr", hr), ("test_img_hr", hr), ("test_gt", hr),
                      ("test_in", hr // 2), ("test_img", hr // 2)):
        out[key] = os.path.join(root, key)
        os.makedirs(out[key])
        for f in sorted(os.listdir(dirs[key])):
            qe._imwrite(os.path.join(out[key], f), read_image(os.path.join(dirs[key], f))[:side, :side])
    return out


def test_sr_chain_serves_the_artifact_and_scores_as_the_jax_tool(tmp_path):
    """Both packages export, serve from their artifact and score (the
    degraded LR input by the metric's SR rule): rmse and mae within 3 mm,
    every PNG within 3 mm, on the SR set's test frames cut to 256x256 HR
    (see the next test for the full 960x1280 canvas)."""
    dirs, intr = qe.write_dataset_sr(str(tmp_path / "data"), 0, 2)
    small = _crop_sr_set(dirs, str(tmp_path / "small"))
    scores, gaps, outs = serve_and_score_both(tmp_path, "sr", small, intr)
    print("sr: max |d| mm by frame", gaps, json.dumps(scores))
    assert max(gaps.values()) <= 3, gaps
    for k in ("rmse", "mae"):
        assert abs(scores["port"][k] - scores["jax"][k]) <= 3.0, (k, scores)
    for tag in ("jax", "port"):  # each served through its own artifact
        assert os.path.isdir(os.path.join(os.path.dirname(outs[tag]), "export_qeval"))
    baseline = {t: tool.score(small, small["test_in"], intr) for t, tool in (("jax", jqe), ("port", qe))}
    for k, want in baseline["jax"].items():  # nan where a corner has no hole
        got = baseline["port"][k]
        assert (np.isnan(got) and np.isnan(want)) or abs(got - want) <= 1e-9 * max(1, abs(want))


def test_depth_f_at_the_sr_canvas_is_nearer_float64_than_jax():
    """At the SR chain's 1024x1280 HR canvas the JAX package's float32
    ``Depth_f`` (width 8, ``resnet_6blocks``) drifts from a float64 run of the
    same weights by ~3e-4 (tanh output), the port's by ~2e-6: the JAX side's
    float32 InstanceNorm statistics over 1.3M pixels. That is why the full
    canvases' PNGs differ by tens of mm between the two CLIs (the mean of a
    frame by well under 1 mm), and why the chain above is held at 256x256."""
    import jax
    import jax.numpy as jnp
    import torch

    from test_torch_common import jax_params, nchw_to_nhwc, nhwc_to_nchw, randn

    from desr_tpu.models import layers as JL
    from desr_tpu.models import networks as JN
    from desr_tpu_torch.models import networks as TN

    args = (2, 8, 8, "resnet_6blocks")
    jnet = JN.define_G(*args)
    params = jax_params(jnet, seed=4)
    x = randn((1, 1024, 1280, 2), 7)
    want = np.asarray(jax.jit(lambda p, v: jnet.apply(p, v, JL.Ctx(dtype=jnp.float32)))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x)))
    state = {k: torch.from_numpy(v) for k, v in params.items()}
    gaps = {}
    with torch.no_grad():
        t64 = TN.define_G(*args).eval().double()
        t64.load_state_dict({k: v.double() for k, v in state.items()})
        ref = nchw_to_nhwc(t64(nhwc_to_nchw(x).double()))
        tnet = TN.define_G(*args).eval()
        tnet.load_state_dict(state)
        gaps["port"] = float(np.abs(nchw_to_nhwc(tnet(nhwc_to_nchw(x))) - ref).max())
    gaps["jax"] = float(np.abs(want - ref).max())
    print("Depth_f at 1024x1280, max |d| from float64:", gaps)
    assert gaps["port"] <= 1e-5 and gaps["port"] < gaps["jax"] / 10, gaps


def test_sr_chain_ours_on_the_cpu(tmp_path, ours_only):  # noqa: F811
    res = qe.main([
        "--root", str(tmp_path), "--epochs", "1", "--n_train", "2",
        "--n_test", "1", "--batch_size", "2", "--width", "8",
        "--hw", "128", "128", "--device", "cpu", "--stage", "sr",
    ])
    assert res["stage"] == "sr" and res["shared_init"] is False
    check_result(res, ("baseline", "baseline_bicubic", "trained"), 1, tmp_path)
    # the handoff: the fine-tune continued from the pretrain's latest files,
    # then served through the artifact
    assert os.path.exists(tmp_path / "ckpt" / "qeval" / "latest_net_Task.pth")
    assert os.path.exists(tmp_path / "export_qeval" / "manifest.json")
    assert len(os.listdir(tmp_path / "bicubic")) == 1


@pytest.mark.parametrize("framework", ["both", "reference"])
def test_sr_chain_with_the_reference(tmp_path, framework):
    root = reference_root()
    res = qe.main([
        "--root", str(tmp_path), "--epochs", "1", "--n_train", "2",
        "--n_test", "1", "--batch_size", "2", "--width", "8", "--hw", "128", "128",
        "--device", "cpu", "--stage", "sr", "--framework", framework,
        "--reference_root", root,
    ])
    arms = ["pred_qeval_ref"] + (["pred_qeval"] if framework == "both" else [])
    check_result(res, ["baseline", "baseline_bicubic", "reference"], 1, tmp_path, arms)
    assert os.path.exists(tmp_path / "ckpt" / "qeval_ref" / "latest_net_Task.pth")
