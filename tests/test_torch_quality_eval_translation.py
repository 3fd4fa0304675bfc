"""``--stage translation`` of the port's quality tool on the CPU: stage 2's
G_B (LQ -> HQ) served through ``predict --translate BtoA`` and scored
per pixel against the paired clean ground truth.

As in tests/test_torch_quality_eval_main.py: one set of the port's seeded
weights (float32; the translator's widths are hardcoded) served and scored
by both tools (the trained trajectories' RNG streams differ), ``--framework
ours`` end to end, and ``both``, which skips without the reference checkout.
"""

import json
import os

import pytest

from test_torch_common import (check_result, ours_only, quality_tools,  # noqa: F401
                               reference_root, serve_and_score_both)

jqe, qe = quality_tools()


def test_translation_chain_serves_and_scores_as_the_jax_tool(tmp_path):
    dirs, intr = qe.write_dataset_translation(str(tmp_path / "data"), 0, 2, hw=(128, 128))
    scores, gaps, _ = serve_and_score_both(tmp_path, "translation", dirs, intr,
                                           "--hw", "128", "128")
    print("translation: max |d| mm by frame", gaps, json.dumps(scores))
    assert max(gaps.values()) <= 3, gaps
    for k in ("rmse", "mae"):
        assert abs(scores["port"][k] - scores["jax"][k]) <= 3.0, (k, scores)


def test_translation_chain_ours_on_the_cpu(tmp_path, ours_only):  # noqa: F811
    res = qe.main([
        "--root", str(tmp_path), "--epochs", "1", "--n_train", "2",
        "--n_test", "2", "--batch_size", "2", "--width", "8",
        "--hw", "128", "128", "--crop_size", "64",
        "--device", "cpu", "--stage", "translation",
    ])
    assert res["stage"] == "translation" and res["hw"] == [128, 128]
    check_result(res, ("baseline", "trained"), 2, tmp_path)
    assert os.path.exists(tmp_path / "ckpt" / "qeval" / "latest_net_G_B.pth")


@pytest.mark.parametrize("framework", ["both", "reference"])
def test_translation_chain_with_the_reference(tmp_path, framework):
    root = reference_root()
    res = qe.main([
        "--root", str(tmp_path), "--epochs", "1", "--n_train", "2",
        "--n_test", "2", "--batch_size", "2", "--width", "8",
        "--hw", "128", "128", "--crop_size", "64", "--device", "cpu",
        "--stage", "translation", "--framework", framework, "--reference_root", root,
    ])
    arms = ["pred_qeval_ref"] + (["pred_qeval"] if framework == "both" else [])
    check_result(res, ["baseline", "reference"], 2, tmp_path, arms)
    assert os.path.exists(tmp_path / "ckpt" / "qeval_ref" / "init_net_G_B.pth")
