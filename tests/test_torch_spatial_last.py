"""The flags that ran beside ``--spatial_devices`` 1 only until now:
``train --steps_per_call``, ``train --device_aug`` and ``predict
--num_workers``, over two gloo ranks that form one spatial group, on the
CPU, tiny widths.

In one launch of the two ranks: a main step group at ``--steps_per_call 2``
at float64 against one process's group and its two single steps; each
rank's first ``--device_aug`` batch of the main, SR and I2D loaders against
its band of one process's finished batch; one ``--device_aug`` main step at
float64 against one process's; the serving CLI's rank at ``--num_workers
0``. Then ``predict --num_workers 2`` over two spatial ranks, a CLI
process of its own, against those PNGs.

The ranks' functions live in tests/test_torch_spatial_last_ranks.py, which
imports no JAX.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_spatial_last_ranks as R
import test_torch_spatial_train_ranks as STR
from test_torch_common import randn  # noqa: F401  (caps torch's threads)
from test_torch_device_aug import I2D as I2D_FLAGS
from test_torch_device_aug import SMALL, STAGE3, _data_flags, _write_folder
from test_torch_parallel_steps import ONE, _assert_terms, _ranks_agree
from test_torch_spatial_serve import _frames_and_checkpoints
from test_torch_spatial_train import _main_argv
from test_torch_train import _batch

from desr_tpu_torch import parallel
from desr_tpu_torch.data import png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUG = ["--device_aug", "--batch_size", "2", "--num_threads", "0"]


def _aug_argvs(root):
    common = [*_data_flags(root), "--checkpoints_dir", str(root / "ck"), *AUG]
    main = [*STAGE3, *SMALL, "--name", "m", *common, "--load_size_h", "160",
            "--load_size_w", "192", "--crop_size_h", "128", "--crop_size_w", "128"]
    return {"main": main,
            "SR": [*STAGE3, *SMALL, "--SR", "--name", "s", *common, "--crop_size_h", "64",
                   "--crop_size_w", "64"],
            "I2D": [*I2D_FLAGS, "--name", "i", *common]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One launch of two gloo ranks, one spatial group (``R.last_refusals``),
    and the same runs in one process."""
    tmp = tmp_path_factory.mktemp("spatial_last")
    _write_folder(str(tmp), n=2, hw=(48, 64))
    argvs = _aug_argvs(tmp)
    group_args = (_main_argv(tmp), [_batch(0), _batch(1)])
    aug_args = (argvs, argvs["main"])
    serve = tmp / "serve"
    serve.mkdir()
    serve_argv = ["--output", str(serve / "o0"), *_frames_and_checkpoints(serve)]
    ranks = parallel.launch(R.last_refusals, ["cpu", "cpu"], spatial=2,
                            args=(group_args, aug_args, serve_argv), workdir=tmp)
    one = {"grouped": R.grouped_steps(ONE, *group_args), "serve": serve_argv,
           "single": R.grouped_steps(ONE, *group_args, grouped=False),
           "batches": {k: R.first_batch(v)[0] for k, v in argvs.items()}}
    _, batch = R.first_batch(argvs["main"])
    one["step"] = STR.main_step(ONE, argvs["main"], batch, dtype=torch.float64)
    return ranks, one


def _assert_float64_grads(got, want, what):
    """Each weight gradient within 1e-9 relative L2 of ``want``'s; one at the
    noise floor (largest entry under 1e-4 of its net's) within 1e-9 of the
    net's largest entry."""
    for n, tensors in want.items():
        assert set(got[n]) == set(tensors), (what, n)
        net_max = max(np.abs(v).max() for v in tensors.values())
        for k, v in tensors.items():
            assert v.dtype == np.float64, (what, n, k)
            g = got[n][k]
            if np.abs(v).max() < 1e-4 * net_max:
                np.testing.assert_allclose(g, v, rtol=0, atol=1e-9 * net_max,
                                           err_msg=f"{what}: {n}.{k}")
            else:
                rel = np.linalg.norm(g - v) / np.linalg.norm(v)
                assert rel <= 1e-9, (what, f"{n}.{k}", rel)


@pytest.mark.parametrize("reference", ["grouped", "single"])
def test_step_group_over_two_spatial_ranks_at_float64_equals_one_process(runs, reference):
    """``--steps_per_call 2`` on the main model (two batches staged, then
    two steps, each batch entering its own split-or-whole layout): the
    ranks hold the same metrics and gradients; the last step's weight
    gradients are one process's group's, and its two single steps', within
    1e-9 relative L2 (``_assert_float64_grads``), the loss terms within
    1e-6 relative (the metrics are reduced as float32) and the trained
    weights within two Adam steps' sign flips at the noise floor (2 x 2
    lr)."""
    ranks, one = runs
    got = [r["grouped"] for r in ranks]
    for key in ("metrics", "grads"):
        _ranks_agree(got, key)
    assert got[0]["layouts"] == [(False, True), (False, True)]
    assert got[0]["counts"]["exchange"] > got[0]["counts"]["exchange_bwd"] > 0
    want = one[reference]
    assert want["layouts"] == [(False, False), (False, False)]
    _assert_terms(got[0]["metrics"], want["metrics"], 1e-6, reference)
    _assert_float64_grads(got[0]["grads"], want["grads"], reference)
    for n, tensors in want["state"].items():
        for k, v in tensors.items():
            np.testing.assert_allclose(got[0]["state"][n][k], v, rtol=0, atol=2 * 2 * 2e-4,
                                       err_msg=f"{n}.{k}")


def test_one_process_group_equals_its_single_steps(runs):
    """One process's ``optimize_parameters_multi`` group and the same steps
    taken one at a time: bit-equal metrics, gradients and weights."""
    _, one = runs
    for key in ("metrics", "grads", "state"):
        _ranks_agree([one["grouped"], one["single"]], key)


@pytest.mark.parametrize("stage", ["main", "SR", "I2D"])
def test_device_aug_batch_is_the_band_of_one_process(runs, stage):
    """Each rank's first ``--device_aug`` batch: the data group's whole
    frames finished (the warp reads rows from anywhere in a frame), then
    the rank's band of each image value's rows (``split_h``: by its own
    height under --SR, HR canvas and LR inputs alike), bit-equal to its
    band of one process's finished batch, each tensor contiguous (the
    kernels take no other); K and the crop boxes whole."""
    ranks, one = runs
    want = one["batches"][stage]
    for r, rank in enumerate(ranks):
        got = rank["device_aug"][stage]
        assert got["rows"] == (0, 2, 2) and got["contiguous"]
        assert set(got["arrays"]) == set(want), stage
        for k, v in want.items():
            if v.ndim == 4:
                h = v.shape[1] // 2
                v = v[:, r * h:(r + 1) * h]
            np.testing.assert_array_equal(got["arrays"][k], v, err_msg=f"{stage} {k}")
        h = want["A_i"].shape[1]
        assert got["h_rows"] == (r * h // 2, (r + 1) * h // 2, h)


def test_device_aug_step_over_two_spatial_ranks_at_float64_equals_one_process(runs):
    """One ``--device_aug`` main step on those batches at float64 (holes
    drawn from the model's generator, each rank keeping its band of the
    whole frames' draw): one process's weight gradients within 1e-9
    relative L2, its loss terms within 1e-6 relative."""
    ranks, one = runs
    got = [r["device_aug"]["step"] for r in ranks]
    _ranks_agree(got, "grads")
    assert all(g["h_split"] for g in got) and not one["step"]["h_split"]
    _assert_terms(got[0]["metrics"], one["step"]["metrics"], 1e-6, "device_aug")
    _assert_float64_grads(got[0]["grads"], one["step"]["grads"], "device_aug")


def test_predict_num_workers_over_two_spatial_ranks(runs, tmp_path):
    """``python -m desr_tpu_torch.predict --device cpu --num_devices 2
    --spatial_devices 2 --num_workers 2`` (each rank's pool decoding its
    frames, rank 0's writing the PNGs) returns within its time limit, with
    every rank's pool closed before its process group ends, and writes the
    PNGs that the CLI's ranks wrote at ``--num_workers 0`` on the same mesh
    (the fixture's launch) bit for bit."""
    ranks, one = runs
    assert [r["served"] for r in ranks] == [3, 3]
    argv = one["serve"][2:]
    o0 = one["serve"][1]
    res = subprocess.run(
        [sys.executable, "-m", "desr_tpu_torch.predict", "--num_devices", "2",
         "--spatial_devices", "2", "--num_workers", "2", "--output", str(tmp_path / "o2"),
         *argv], cwd=ROOT, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, OMP_NUM_THREADS="2"))  # the launch's ranks' threads
    assert res.returncode == 0, res.stderr[-2000:]
    assert "wrote 3 predictions" in res.stdout
    names = sorted(os.listdir(o0))
    assert names == sorted(os.listdir(tmp_path / "o2")) == ["f0.png", "f1.png", "f2.png"]
    for f in names:
        np.testing.assert_array_equal(png.read_png(tmp_path / "o2" / f),
                                      png.read_png(os.path.join(o0, f)), err_msg=f)
