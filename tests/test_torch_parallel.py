"""The port's data mesh (``desr_tpu_torch/parallel``) on the CPU: the batch
layout against ``desr_tpu.parallel.mesh`` on the conftest's 8 virtual
devices, the global reductions over two gloo ranks against one process,
``replicate`` and the rank-0 checkpoint writes, the rank loaders' rows,
``predict --num_devices 2`` and ``train --num_devices 2``, and the
refusals.

Two ranks are two spawned processes (``parallel.launch``) over a file
rendezvous under the test's ``tmp_path``, so that xdist's workers never
share a port; their functions live in tests/test_torch_parallel_ranks.py,
which imports no JAX. The model steps over two ranks are in
tests/test_torch_parallel_steps.py.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import test_torch_parallel_ranks as R
from test_torch_common import randn  # noqa: F401  (caps torch's threads)

from desr_tpu.parallel import mesh as JM
from desr_tpu_torch import parallel
from desr_tpu_torch.data import png
from desr_tpu_torch.parallel.mesh import Mesh, Shard, shard_batch, shard_batch_steps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU2 = ["cpu", "cpu"]


# ----------------------------------------------------------------- layout

def _layout_batch(b, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((b, 4, 6, 1)).astype(np.float32),
            "K": rng.standard_normal((b, 3, 3)).astype(np.float32),
            "paths": [f"p{i}.png" for i in range(b)]}


def _jax_rows(arr, mesh):
    """Each device's block of a sharded jax.Array, in the mesh's device order."""
    by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    return [by_dev[d] for d in mesh.devices.flat]


@pytest.mark.parametrize("n,b", [(2, 6), (4, 8), (8, 8), (4, 6), (8, 3)])
def test_shard_batch_rows_match_jax(n, b):
    """Rank r's rows are the block JAX's ('data',) mesh of n devices puts on
    its device r: r*b/n .. (r+1)*b/n when n divides b, else the whole batch
    (JAX replicates it); a list of paths is split the same way."""
    batch = _layout_batch(b)
    jmesh = JM.make_mesh(jax.devices()[:n])
    want = JM.shard_batch(batch, jmesh)
    for r in range(n):
        got = shard_batch(batch, Mesh(tuple(["cpu"] * n), r))
        assert isinstance(got, Shard) and got.split == (b % n == 0)
        for k in ("x", "K"):
            np.testing.assert_array_equal(got[k], _jax_rows(want[k], jmesh)[r], err_msg=k)
        lo, hi, total = got.rows
        assert total == b and got["paths"] == batch["paths"][lo:hi]
        assert shard_batch(got, Mesh(tuple(["cpu"] * n), 1 - r % 2)) is got


@pytest.mark.parametrize("n,b", [(2, 4), (4, 6)])
def test_shard_batch_steps_rows_match_jax(n, b):
    """A --steps_per_call group: each step's rows are those of JAX's stacked
    [steps, B, ...] array on the device."""
    batches = [_layout_batch(b, seed) for seed in range(3)]
    jmesh = JM.make_mesh(jax.devices()[:n])
    want = JM.shard_batch_steps(batches, jmesh)
    for r in range(n):
        got = shard_batch_steps(batches, Mesh(tuple(["cpu"] * n), r))
        for k in ("x", "K"):
            np.testing.assert_array_equal(np.stack([g[k] for g in got]),
                                          _jax_rows(want[k], jmesh)[r], err_msg=k)


# ----------------------------------------------------------------- reductions

@pytest.fixture(scope="module")
def prims(tmp_path_factory):
    """``R.primitives`` over two gloo ranks and in one process, on a batch
    of 4 whose two halves hold unequal mask counts."""
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (4, 12, 10)).astype(np.float32)
    y = rng.uniform(-1, 1, (4, 12, 10)).astype(np.float32)
    mask = np.zeros((4, 12, 10), np.float32)
    mask[:2, :10] = 1.0   # rank 0: 200 pixels
    mask[2:, :3] = 1.0    # rank 1: 60
    img = rng.uniform(-1, 1, (4, 3, 12, 10)).astype(np.float32)
    bn_in = (rng.standard_normal((4, 5, 6, 7)) * 2 + 1).astype(np.float32)
    bn_cot = rng.standard_normal((4, 5, 6, 7)).astype(np.float32)
    args = (x, y, mask, img, bn_in, bn_cot)
    ranks = parallel.launch(R.primitives, CPU2, args=args,
                            workdir=tmp_path_factory.mktemp("prims"))
    return ranks, R.primitives(parallel.make_mesh(["cpu"]), *args)


@pytest.mark.parametrize("name", ["masked_l1", "masked_cos", "tv"])
def test_global_loss_over_two_ranks_equals_one_process(prims, name):
    """The loss over two ranks (the mean of the ranks' terms) is the whole
    batch's within 1e-6 relative, and each rank's x gradient is N times the
    whole batch's on its rows (the ranks' mean gradient is the global one)."""
    ranks, one = prims
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[name], one[name], rtol=1e-6, err_msg=name)
        np.testing.assert_allclose(got[name + "_dx"] / 2, one[name + "_dx"][2 * r:2 * r + 2],
                                   rtol=1e-5, atol=1e-9, err_msg=name)


@pytest.mark.parametrize("name", ["masked_l1", "masked_cos"])
def test_a_mean_of_per_rank_masked_means_is_not_the_global_one(prims, name):
    """The fault the global denominators fix: with 200 mask pixels on one
    rank and 60 on the other, the mean of the ranks' own masked means is
    not the global masked mean."""
    ranks, one = prims
    naive = np.mean([r[name + "_rows_alone"] for r in ranks])
    assert abs(naive - one[name]) > 1e-3 * abs(one[name]), (naive, one[name])


def test_batch_norm_moments_over_two_ranks_are_the_global_ones(prims):
    """BatchNorm2d in train mode over two ranks: each rank's output and
    input gradient are the one-process rows (1e-5), the weight gradients sum
    to the one-process one, and the running statistics (the unbiased
    variance from the global count) are the one-process ones."""
    ranks, one = prims
    for r, got in enumerate(ranks):
        rows = slice(2 * r, 2 * r + 2)
        np.testing.assert_allclose(got["bn_out"], one["bn_out"][rows], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["bn_dx"], one["bn_dx"][rows], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["bn_running_mean"], one["bn_running_mean"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got["bn_running_var"], one["bn_running_var"], rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["bn_weight_grad"] + ranks[1]["bn_weight_grad"],
                               one["bn_weight_grad"], rtol=1e-4, atol=1e-4)


def test_gather_and_gradient_average(prims):
    ranks, one = prims
    for got in ranks:
        np.testing.assert_array_equal(got["gathered"], one["gathered"])
        np.testing.assert_array_equal(got["mean_grad"], np.full(3, 1.5, np.float32))
    np.testing.assert_array_equal(one["mean_grad"], np.ones(3, np.float32))


def test_replicate_makes_the_ranks_agree(tmp_path):
    """Nets drawn from different seeds on the two ranks hold rank 0's state
    after ``replicate``, buffers too."""
    a, b = parallel.launch(R.replicated_nets, CPU2, args=(3,), workdir=tmp_path)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert np.any(a["1.running_mean"] != 0)


def test_only_rank_0_writes_checkpoints(tmp_path):
    got = parallel.launch(R.save_from_each_rank, CPU2, args=(str(tmp_path / "ck"),),
                          workdir=tmp_path)
    assert got == [["latest_net_Image_f.pth", "latest_net_Task.pth"], []]


# ----------------------------------------------------------------- devices

def test_num_devices_resolves_and_refuses(monkeypatch):
    """0 on the CPU is one rank (no process group: today's path); N CPU
    ranks when asked; on cards 0 is every visible card, and more than
    those raises where JAX's ``jax.devices()[:n]`` takes fewer."""
    assert parallel.resolve_devices("cpu", 0) == [torch.device("cpu")]
    assert parallel.resolve_devices("cpu", 3) == [torch.device("cpu")] * 3
    assert parallel.default_backend(["cpu"]) == "gloo"
    mesh = parallel.make_mesh(["cpu"])
    assert mesh.size == 1 and mesh.group is None and not torch.distributed.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert parallel.resolve_devices(None, 0) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert parallel.resolve_devices("cuda", 1) == [torch.device("cuda")]
    assert parallel.default_backend(parallel.resolve_devices("cuda", 2)) == "nccl"
    with pytest.raises(ValueError, match="only 2 CUDA"):
        parallel.resolve_devices("cuda", 3)
    with pytest.raises(ValueError, match="not divisible by spatial=2"):
        parallel.make_mesh(["cpu"], spatial=2)
    with pytest.raises(RuntimeError, match="process group"):
        parallel.make_mesh(CPU2)


def test_train_cli_refuses_more_devices_than_visible(tmp_path, monkeypatch, capsys):
    from desr_tpu_torch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit) as e:
        train.main(["--model_type", "I2D", "--checkpoints_dir", str(tmp_path),
                    "--num_devices", "2"])
    assert e.value.code != 0 and "only 1 CUDA device" in capsys.readouterr().err


# ----------------------------------------------------------------- the loader

def _i2d_frames(root, n, hw=(48, 64), seed=1):
    rng = np.random.default_rng(seed)
    for dom in ("A", "B"):
        for sub in ("depth", "img"):
            os.makedirs(root / dom / sub)
        for i in range(n):
            name = f"scene{i:04d}_00_{i:04d}.png"
            png.write_png(root / dom / "depth" / name,
                          rng.integers(500, 6000, hw).astype(np.uint16))
            png.write_png(root / dom / "img" / name,
                          rng.integers(0, 256, hw + (3,)).astype(np.uint8))
    flags = ["--image_and_depth", "--use_scannet"]
    for suffix in ("", "_test"):
        flags += [f"--path_A{suffix}", f"{root}/A/depth", f"--path_B{suffix}", f"{root}/B/depth",
                  f"--A_add_paths{suffix}", f"{root}/A/img", f"--B_add_paths{suffix}",
                  f"{root}/B/img"]
    return flags


@pytest.mark.parametrize("extra", [[], ["--serial_batches"]])
def test_rank_loaders_make_up_the_one_process_batches(tmp_path, extra):
    """5 items at batch 2: each rank's loader yields its rows of each of the
    one-process loader's batches (the same shuffle from --seed), and the
    last batch, of 1, whole on both, each as a Shard with the global rows.
    The items are told by their B paths, which the index picks (an item's
    A frame is a random draw of its own)."""
    from desr_tpu_torch.data.i2d_dataset import I2DDataset
    from desr_tpu_torch.data.loader import create_dataset
    from desr_tpu_torch.options import train_options

    flags = _i2d_frames(tmp_path, 5)
    opt = train_options.parse(["--model_type", "I2D", *flags, "--batch_size", "2",
                               "--num_threads", "0", "--device", "cpu", "--seed", "3", *extra],
                              print_options=False)
    one = [b["B_paths"] for b in create_dataset(opt, I2DDataset)]
    assert len(one) == 3 and [len(p) for p in one] == [2, 2, 1]
    per_rank = []
    for r in range(2):
        loader = create_dataset(opt, I2DDataset, mesh=Mesh(("cpu", "cpu"), r))
        batches = list(loader)
        assert len(loader) == 3 and all(isinstance(b, Shard) for b in batches)
        assert [b.rows for b in batches] == [(r, r + 1, 2), (r, r + 1, 2), (0, 1, 1)]
        assert batches[0]["A_i"].shape[0] == 1
        per_rank.append([b["B_paths"] for b in batches])
    for k, paths in enumerate(one):
        if len(paths) == 2:
            assert per_rank[0][k] + per_rank[1][k] == paths
        else:
            assert per_rank[0][k] == per_rank[1][k] == paths


# ----------------------------------------------------------------- serving

def test_predict_num_devices_2_is_bit_equal_to_one_device(tmp_path):
    """``predict --num_devices 2 --device cpu``: a replica a device, 3 frames
    at batch 2 (a batch split 1 + 1, then one frame on the first device):
    the PNGs bit-equal to one device's; --spatial_devices 2 refuses --export."""
    from desr_tpu_torch import checkpoints as ckpt
    from desr_tpu_torch import predict
    from desr_tpu_torch.models.main_model import MainModel, NetOptions

    small = dict(ImageDepthf_outf=8, ImageDepthf_basef=8, Depthf_outf=8, Depthf_basef=8,
                 I2D_base=8, Task_basef=8)
    rng = np.random.default_rng(0)
    for sub in ("depth", "img"):
        os.makedirs(tmp_path / sub)
    for i in range(3):
        png.write_png(tmp_path / "depth" / f"f{i}.png",
                      rng.integers(0, 6000, (100, 140)).astype(np.uint16))
        png.write_png(tmp_path / "img" / f"f{i}.png",
                      rng.integers(0, 255, (100, 140, 3)).astype(np.uint8))
    model = MainModel(NetOptions(**small), device="cpu", generator=torch.Generator().manual_seed(3))
    for name in model.model_names:
        ckpt.save_net(model.nets[name], ckpt.net_ckpt_path(str(tmp_path / "ck"), "x", "latest",
                                                           name))
    base = ["--name", "x", "--checkpoints_dir", str(tmp_path / "ck"),
            "--input_depth", str(tmp_path / "depth"), "--input_img", str(tmp_path / "img"),
            "--batch_size", "2", "--compute_dtype", "float32", "--device", "cpu"]
    net_args = ["--net_args"] + [a for k, v in small.items() for a in (f"--{k}", str(v))]
    outs = {}
    for n in (1, 2):
        out = tmp_path / f"out{n}"
        predict.main(base + ["--output", str(out), "--num_devices", str(n)] + net_args)
        outs[n] = {f: png.read_png(out / f) for f in sorted(os.listdir(out))}
    with pytest.raises(SystemExit) as e:
        predict.main(base + ["--output", str(tmp_path / "o"), "--spatial_devices", "2",
                             "--export", str(tmp_path / "art")])
    assert e.value.code != 0
    assert sorted(outs[2]) == ["f0.png", "f1.png", "f2.png"]
    for f, a in outs[1].items():
        np.testing.assert_array_equal(outs[2][f], a, err_msg=f)


def test_serve_on_devices_splits_and_gathers_in_order():
    from desr_tpu_torch.predict import serve_on_devices

    calls = []

    def replica(r):
        def fwd(batch):
            calls.append((r, batch["B_d"][:, 0, 0, 0].tolist()))
            return torch.as_tensor(batch["B_d"][..., 0]) * 10
        return fwd

    batch = {"B_d": np.arange(4, dtype=np.float32).reshape(4, 1, 1, 1),
             "B_i": np.zeros((4, 1, 1, 3), np.float32)}
    out = serve_on_devices([replica(0), replica(1)], CPU2, batch)
    assert calls == [(0, [0.0, 1.0]), (1, [2.0, 3.0])]
    np.testing.assert_array_equal(out[:, 0, 0].numpy(), [0, 10, 20, 30])
    calls.clear()
    serve_on_devices([replica(0), replica(1)], CPU2, {k: v[:3] for k, v in batch.items()})
    assert calls == [(0, [0.0, 1.0, 2.0])]


# ----------------------------------------------------------------- the train CLI

def test_train_cli_num_devices_2_runs_an_epoch(tmp_path):
    """``python -m desr_tpu_torch.train --num_devices 2 --device cpu``: an I2D
    --use_D epoch of 2 global batches of 2 over two gloo ranks, and a split
    --save_all test pass: the checkpoints, one loss log with one line a step
    (rank 0's alone), both ranks' rows of predictions; with
    --spatial_devices 2 and --steps_per_call 2 the same epoch runs (I2D
    --use_D takes its steps one at a time, as the JAX package's scan rule
    says), one loss line a step."""
    flags = _i2d_frames(tmp_path, 4)
    ck = tmp_path / "ck"
    argv = [sys.executable, "-m", "desr_tpu_torch.train", "--model_type", "I2D", "--use_D",
            "--do_train", "--do_test", *flags, "--Imagef_outf", "8", "--Imagef_basef", "8",
            "--Task_basef", "8", "--ndf", "8", "--compute_dtype", "float32", "--name", "e",
            "--checkpoints_dir", str(ck), "--batch_size", "2", "--batch_size_val", "2",
            "--n_epochs", "1", "--n_epochs_decay", "0", "--print_freq", "2",
            "--save_epoch_freq", "1", "--save_all", "--save_image_folder",
            str(tmp_path / "pred"), "--num_threads", "0", "--device", "cpu",
            "--num_devices", "2"]
    env = dict(os.environ, TMPDIR=str(tmp_path), OMP_NUM_THREADS="2")
    res = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    for n in ("Image_f", "Task", "D_depth"):
        assert (ck / "e" / f"latest_net_{n}.pth").exists()
    log = (ck / "e" / "loss_log.txt").read_text()
    assert log.count("(epoch: 1, iters:") == 2 and log.count("D_depth:") == 2
    assert res.stdout.count("saving the model at the end of epoch 1") == 1
    assert sorted(os.listdir(tmp_path / "pred")) == [f"scene{i:04d}_00_{i:04d}.png"
                                                     for i in range(4)]
    argv[argv.index("--name") + 1] = "e2"
    res = subprocess.run(argv + ["--spatial_devices", "2", "--steps_per_call", "2"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert (ck / "e2" / "loss_log.txt").read_text().count("(epoch: 1, iters:") == 2
