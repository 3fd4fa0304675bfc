"""``python -m desr_tpu_torch.bench`` on the CPU: its batch against the root
``bench.py``'s, one small train step's rate, and the one stdout line. The
translator's hardcoded widths are cut to 8+8 channels and one block, the
other nets to 8 channels, and the crop to 128x128 (HR 256x256)."""

import json
import math
import os

import numpy as np
import pytest

from test_torch_common import randn  # noqa: F401  (caps torch's threads)

import bench as jax_bench
from desr_tpu_torch import bench
from desr_tpu_torch.models import translation_networks as TTT

SMALL = ["--ImageDepthf_outf", "8", "--ImageDepthf_basef", "8", "--Depthf_outf", "8",
         "--Depthf_basef", "8", "--I2D_base", "8", "--Task_basef", "8"]


@pytest.fixture(scope="module")
def small_run():
    with pytest.MonkeyPatch.context() as mp:
        full = TTT.default_translator_opt
        mp.setattr(TTT, "default_translator_opt",
                   lambda full=full: full(ngf_img=8, ngf_depth=8, n_blocks=1))
        return bench.run(device="cpu", lr_hw=(128, 128), warmup=1, steps=1, extra_argv=SMALL)


def test_metric_and_unit_are_bench_py_s():
    with open(jax_bench.__file__) as f:
        src = f.read()
    assert f'"metric": "{bench.METRIC}"' in src and f'"unit": "{bench.UNIT}"' in src


def test_make_batch_is_bench_py_s():
    """The port's copy of make_batch is bit-equal to the root bench.py's."""
    for args in ((1, 512, 640), (2, 64, 48)):
        got, want = bench.make_batch(*args), jax_bench.make_batch(*args)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_bench_argv_is_bench_py_s():
    """bench.py:62-70's flags (with --remat never added)."""
    argv = bench.bench_argv("/ck")
    for flag in ("--SR", "--use_image_for_trans", "--use_masked", "--norm_loss",
                 "--use_smooth_loss"):
        assert flag in argv
    pairs = {argv[i]: argv[i + 1] for i in range(len(argv) - 1)}
    assert (pairs["--batch_size"], pairs["--crop_size_h"], pairs["--crop_size_w"],
            pairs["--lr"], pairs["--w_syn_norm"]) == ("1", "512", "640", "2e-5", "0.05")
    assert "--remat" not in argv and "--compute_dtype" not in argv


def test_run_gives_a_finite_rate(small_run):
    assert math.isfinite(small_run["pairs_per_sec"]) and small_run["pairs_per_sec"] > 0
    assert small_run["event_ms"] is None and small_run["peak_gib"] is None  # no card
    assert all(math.isfinite(v) for v in small_run["losses"].values())


def test_main_prints_one_line_with_four_keys(tmp_path, monkeypatch, capsys, small_run):
    """stdout holds one JSON line with bench.py's four keys; vs_baseline is
    the rate over the baseline file's value, 1.0 without the file, which the
    bench never writes."""
    shipped = bench.BASELINE_FILE
    shipped_state = (os.path.exists(shipped) and os.path.getmtime(shipped))
    monkeypatch.setattr(bench, "run", lambda device: small_run)
    base = tmp_path / "bench_baseline.json"
    monkeypatch.setattr(bench, "BASELINE_FILE", str(base))
    for baseline, want_vs in ((None, 1.0), (small_run["pairs_per_sec"] / 2, 2.0)):
        if baseline is not None:
            base.write_text(json.dumps({"value": baseline, "desc": "test"}))
        assert bench.main(["--device", "cpu"]) == 0
        lines = capsys.readouterr().out.splitlines()
        assert len(lines) == 1
        out = json.loads(lines[0])
        assert sorted(out) == ["metric", "unit", "value", "vs_baseline"]
        assert out["metric"] == "sr_train_pairs_per_sec_per_chip"
        assert out["unit"] == bench.UNIT
        assert isinstance(out["value"], float) and out["value"] > 0
        assert out["vs_baseline"] == pytest.approx(want_vs, rel=1e-3)
        if baseline is None:
            assert not base.exists()
    assert (os.path.exists(shipped) and os.path.getmtime(shipped)) == shipped_state


def test_without_a_card_it_raises_unless_cpu_is_asked():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
