"""``--stage main`` of the port's quality tool on the CPU
(``python -m desr_tpu_torch.tools.quality_eval``).

The chain against the JAX tool (``tools/quality_eval.py``): one set of the
port's seeded weights (width 8, float32) goes as ``latest`` into both
tools' checkpoint folders; each tool serves the 128x128 test frames through
its package's serving CLI and scores them. Trained trajectories are not
compared bit for bit: the train-time hole sampler draws from torch's RNG in
the port and from ``jax.random`` in the JAX package (ROADMAP.md, "How
parity is held"), so the chains are held together where they are
deterministic, serve and score. Then ``--framework ours`` end to end with
the JAX tool test's assertions (tests/test_quality_eval.py), and ``both``,
which needs the original reference checkout and skips without it.
"""

import json
import os

import numpy as np
import pytest

from test_torch_common import (check_result, ours_only, quality_args,  # noqa: F401
                               quality_tools, reference_root, serve_and_score_both)

jqe, qe = quality_tools()


def test_main_chain_serves_and_scores_as_the_jax_tool(tmp_path):
    """Within 3 mm: rmse and mae, and every predicted PNG (the CLIs' bound)."""
    dirs, intr = qe.write_dataset(str(tmp_path / "data"), 0, 2, 128, 128)
    scores, gaps, _ = serve_and_score_both(tmp_path, "main", dirs, intr)
    print("main: max |d| mm by frame", gaps, json.dumps(scores))
    assert max(gaps.values()) <= 3, gaps
    for k in ("rmse", "mae"):
        assert abs(scores["port"][k] - scores["jax"][k]) <= 3.0, (k, scores)


def test_main_chain_ours_on_the_cpu(tmp_path, capsys, ours_only):  # noqa: F811
    res = qe.main([
        "--root", str(tmp_path), "--epochs", "1", "--n_train", "4",
        "--n_test", "2", "--batch_size", "2", "--width", "8",
        "--hw", "128", "128", "--device", "cpu",
    ])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == json.loads(json.dumps(res))
    assert res["steps"] == 2 and res["framework"] == "ours" and res["shared_init"] is False
    check_result(res, ("baseline", "trained"), 2, tmp_path)
    assert res["baseline"]["rmse_h"] > 500  # the task exists
    assert os.path.exists(tmp_path / "ckpt" / "qeval" / "latest_net_Task.pth")


@pytest.mark.parametrize("framework", ["both", "reference"])
def test_main_chain_with_the_reference(tmp_path, framework):
    """Both arms from the same init checkpoints (tests/test_quality_eval.py's
    ``--framework both`` chain)."""
    root = reference_root()
    res = qe.main([
        "--root", str(tmp_path), "--epochs", "1", "--n_train", "4",
        "--n_test", "2", "--batch_size", "2", "--width", "8", "--hw", "128", "128",
        "--device", "cpu", "--framework", framework, "--reference_root", root,
    ])
    arms = ["pred_qeval_ref"] + (["pred_qeval"] if framework == "both" else [])
    splits = ["baseline", "reference"] + (["trained"] if framework == "both" else [])
    check_result(res, splits, 2, tmp_path, arms)
    assert res["shared_init"] is True
    assert os.path.exists(tmp_path / "ckpt" / "qeval_ref" / "init_net_Task.pth")
    if framework == "both":
        for v in res["ours_vs_reference_rel"].values():
            assert np.isfinite(v)


def test_main_argv_is_the_train_clis(tmp_path):
    """The stage's argv, as the tool hands it to the train CLI, builds the
    main model at width 8 on the CPU."""
    from desr_tpu_torch.options import train_options

    args = quality_args(tmp_path, "main")
    dirs = {k: str(tmp_path / k) for k in qe._MAIN_DIRS}
    opt = train_options.parse(qe._train_argv(dirs, "intr", args, "x")[1:], print_options=False)
    assert (opt.model_type, opt.SR, opt.Depthf_basef, opt.Task_basef) == ("main", False, 8, 8)
    assert (opt.crop_size_h, opt.load_size_h, opt.num_threads) == (128, 128, 1)
