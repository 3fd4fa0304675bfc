"""``--stage i2d`` of the port's quality tool on the CPU: stage 1's depth
from RGB at its fixed 480x640 geometry, served through ``predict --I2D``
from the test RGB alone, with the constant train-mean baseline.

As in tests/test_torch_quality_eval_main.py: one set of the port's seeded
weights (width 8, float32) served and scored by both tools (the trained
trajectories' RNG streams differ), ``--framework ours`` end to end, and
``both``, which skips without the reference checkout.
"""

import json
import os

import pytest

from test_torch_common import (check_result, ours_only, quality_tools,  # noqa: F401
                               reference_root, serve_and_score_both)

jqe, qe = quality_tools()


def test_i2d_chain_serves_and_scores_as_the_jax_tool(tmp_path):
    dirs, intr = qe.write_dataset(str(tmp_path / "data"), 0, 2, 480, 640)
    scores, gaps, _ = serve_and_score_both(tmp_path, "i2d", dirs, intr)
    print("i2d: max |d| mm by frame", gaps, json.dumps(scores))
    assert max(gaps.values()) <= 3, gaps
    for k in ("rmse", "mae"):
        assert abs(scores["port"][k] - scores["jax"][k]) <= 3.0, (k, scores)


def test_i2d_chain_ours_on_the_cpu(tmp_path, ours_only):  # noqa: F811
    res = qe.main([
        "--root", str(tmp_path), "--epochs", "1", "--n_train", "2",
        "--n_test", "2", "--batch_size", "2", "--width", "8",
        "--device", "cpu", "--stage", "i2d",
    ])
    assert res["stage"] == "i2d" and res["hw"] == [480, 640]
    check_result(res, ("baseline", "baseline_mean", "trained"), 2, tmp_path)
    # the mean baseline has no holes: its hole rows score the constant
    assert res["baseline_mean"]["rmse_h"] < res["baseline"]["rmse_h"]


@pytest.mark.parametrize("framework", ["both", "reference"])
def test_i2d_chain_with_the_reference(tmp_path, framework):
    root = reference_root()
    res = qe.main([
        "--root", str(tmp_path), "--epochs", "1", "--n_train", "2",
        "--n_test", "2", "--batch_size", "2", "--width", "8", "--device", "cpu",
        "--stage", "i2d", "--framework", framework, "--reference_root", root,
    ])
    arms = ["pred_qeval_ref"] + (["pred_qeval"] if framework == "both" else [])
    check_result(res, ["baseline", "baseline_mean", "reference"], 2, tmp_path, arms)
    assert os.path.exists(tmp_path / "ckpt" / "qeval_ref" / "init_net_Task.pth")
