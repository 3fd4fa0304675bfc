"""The train CLI's single-card surface in the port against the JAX package,
on the CPU: the plateau LR rule, ``--steps_per_call`` (bit-equal to single
steps), the training loop's print / save / display iterations against ``main.py``,
the train state's resume, the options, ``--init_type``, zoo A under
``--norm batch`` and ``--norm none``, and ``python -m desr_tpu_torch.train``
runs that write the HTML gallery. Mirrors tests/test_multi_step.py and
tests/test_bf16_and_plateau.py.
"""

import os
import sys
from types import SimpleNamespace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_i2d as TI
import test_torch_train as TTR
from test_torch_common import jax_params, nhwc_to_nchw, randn
from desr_tpu_torch import checkpoints as ckpt
from desr_tpu_torch.data.png import read_png
from desr_tpu_torch.models import layers as TL
from desr_tpu_torch.models import networks as TN
from desr_tpu_torch.models import translation_networks as TT
from desr_tpu_torch.models.base_model import BaseModel
from desr_tpu_torch.models.i2d_model import I2DModel
from desr_tpu_torch.models.main_model import MainModel
from desr_tpu_torch.models.translation_model import TranslationModel
from desr_tpu_torch.options import train_options
from desr_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)

_DEFAULT_TRANSLATOR = TT.default_translator_opt


def _small_translator(**kw):
    return _DEFAULT_TRANSLATOR(**dict(dict(ngf_img=8, ngf_depth=8, n_blocks=1), **kw))


def _parse(*flags):
    return train_options.parse(["--device", "cpu", *flags], print_options=False)


# ----------------------------------------------------------------- plateau

PLATEAU_SERIES = [1.0, 0.9, 0.8, 0.7, 0.6, 0.5, 0.4, 0.3] + [0.3] * 8 + [0.31, 0.2, 0.29] \
    + [0.25] * 9 + [None, 0.1, 0.1]


def test_plateau_lr_sequence_matches_jax():
    """The LR after each epoch of a fixed metric series (improving, stalled,
    noisy, stalled again, a missing metric) equals the JAX rule's exactly,
    and reaches every Adam; the other policies still read the epoch."""
    from desr_tpu.models.base_model import BaseModel as JaxBaseModel

    opt = SimpleNamespace(lr_policy="plateau", lr=1e-3, n_epochs=10, n_epochs_decay=10,
                          epoch_count=1, lr_decay_iters=50, compute_dtype="float32")
    jm = JaxBaseModel.__new__(JaxBaseModel)
    jm.opt, jm.lr = opt, opt.lr
    tm = BaseModel(opt, device="cpu")
    p = torch.nn.Parameter(torch.zeros(3))
    tm.optimizers = [torch.optim.Adam([p], lr=opt.lr)]
    got, want = [], []
    for e, v in enumerate(PLATEAU_SERIES):
        want.append(jm.update_learning_rate(e, metric=v))
        got.append(tm.update_learning_rate(e, metric=v))
        assert tm.optimizers[0].param_groups[0]["lr"] == got[-1]
    assert got == want
    assert len(set(got)) == 3  # two decays: x0.2, then x0.2 again
    assert tm.plateau_history == jm._plateau_history


def test_plateau_policy_steps_on_stalled_metric():
    """tests/test_bf16_and_plateau.py:70-97 for the port."""
    opt = SimpleNamespace(lr_policy="plateau", lr=1e-3, n_epochs=10, n_epochs_decay=10)
    m = BaseModel(opt, device="cpu")
    for e, v in enumerate([1.0, 0.9, 0.8, 0.7, 0.6, 0.5, 0.4, 0.3]):
        m.update_learning_rate(e, metric=v)
    assert m.lr == pytest.approx(1e-3)
    for e in range(8):
        m.update_learning_rate(e, metric=0.3)
    assert m.lr == pytest.approx(1e-3 * 0.2)
    lr_before = m.lr
    m.update_learning_rate(99, metric=None)
    assert m.lr == lr_before


# ----------------------------------------------------------------- bf16

def test_i2d_bf16_matches_f32_within_tolerance(tmp_path):
    """tests/test_bf16_and_plateau.py:17-43 for the port: the eval losses in
    bf16 within 5e-2 relative (1e-3 absolute) of float32's on the same
    weights, and three bf16 steps lower G."""
    def model(dtype):
        opt = train_options.parse(TI._argv(tmp_path, []) + ["--device", "cpu"],
                                  print_options=False)
        return I2DModel(opt, device="cpu", compute_dtype=dtype, is_train=True,
                        generator=torch.Generator().manual_seed(5))

    batch = TI._batch(4)
    m32, m16 = model(torch.float32), model(torch.bfloat16)
    for m in (m32, m16):
        m.set_input(batch)
        m.calculate(stage="test")
    for k in ("task_syn", "task_real", "G"):
        np.testing.assert_allclose(float(m16.metrics[k]), float(m32.metrics[k]), rtol=5e-2,
                                   atol=1e-3, err_msg=k)
    g = []
    for it in range(3):
        m16.set_input(batch)
        m16.optimize_parameters(it + 1)
        g.append(float(m16.metrics["G"]))
    assert np.isfinite(g).all() and g[-1] < g[0]


def test_main_bf16_eval_matches_f32():
    """tests/test_bf16_and_plateau.py:46-67 for the port: G within 8e-2
    relative (2e-3 absolute), three terms within 1e-1 (2e-3)."""
    m32 = _main_model()
    opt16 = _parse(*TTR.STAGE3, *TTR.SMALL, "--compute_dtype", "bfloat16")
    with mock.patch.object(TT, "default_translator_opt", _small_translator):
        m16 = MainModel(opt16, device="cpu", compute_dtype=torch.bfloat16, is_train=True,
                        generator=torch.Generator().manual_seed(3))
    for m in (m32, m16):
        m.set_input(BATCHES[0])
        m.calculate(stage="test")
    np.testing.assert_allclose(float(m16.metrics["G"]), float(m32.metrics["G"]), rtol=8e-2,
                               atol=2e-3)
    for k in ("task_syn", "task_real_by_depth", "holes_syn"):
        np.testing.assert_allclose(float(m16.metrics[k]), float(m32.metrics[k]), rtol=1e-1,
                                   atol=2e-3, err_msg=k)


# ----------------------------------------------------------------- --steps_per_call

def _main_model(extra=(), seed=3):
    opt = _parse(*TTR.STAGE3, *TTR.SMALL, *extra)
    with mock.patch.object(TT, "default_translator_opt", _small_translator):
        return MainModel(opt, device="cpu", compute_dtype=torch.float32, is_train=True,
                         generator=torch.Generator().manual_seed(seed),
                         hole_generator=torch.Generator().manual_seed(4))


def _weights(model):
    return {f"{n}.{k}": v.clone() for n in model.model_names
            for k, v in model.nets[n].state_dict().items()}


def _assert_bit_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


BATCHES = [TTR._batch(s) for s in range(4)]


def test_steps_per_call_equals_single_steps():
    """Two groups of two (optimize_parameters_multi) against four single
    steps from the same seed: every weight bit-equal, and the metrics kept
    are the group's last step's, bit-equal to the fourth single step's."""
    single, multi = _main_model(), _main_model()
    assert single.supports_multi_step() and multi.supports_multi_step()
    for i, b in enumerate(BATCHES):
        single.set_input(b)
        single.optimize_parameters(2 * (i + 1))
    multi.optimize_parameters_multi(BATCHES[:2], 4)
    multi.optimize_parameters_multi(BATCHES[2:], 8)
    _assert_bit_equal(_weights(multi), _weights(single))
    assert set(multi.metrics) == set(single.metrics)
    for k in single.metrics:
        assert torch.equal(multi.metrics[k], single.metrics[k]), k
    # the group's last batch stays staged (the gallery's forward reads it)
    assert torch.equal(multi._batch["A_d"], torch.from_numpy(BATCHES[3]["A_d"]))


def test_i2d_steps_per_call_and_which_models_group(tmp_path):
    """I2D without --use_D groups steps (bit-equal to single ones); I2D with
    --use_D and the translation model do not (i2d_model.py:190-194)."""
    def model(extra=()):
        opt = train_options.parse(TI._argv(tmp_path, list(extra)) + ["--device", "cpu"],
                                  print_options=False)
        return I2DModel(opt, device="cpu", compute_dtype=torch.float32, is_train=True,
                        generator=torch.Generator().manual_seed(5))

    single, multi = model(), model()
    batches = [TI._batch(s) for s in range(3)]
    for i, b in enumerate(batches):
        single.set_input(b)
        single.optimize_parameters(i + 1)
    multi.optimize_parameters_multi(batches, 3)
    _assert_bit_equal(_weights(multi), _weights(single))
    assert not model(["--use_D"]).supports_multi_step()
    assert not TranslationModel.supports_multi_step(TranslationModel.__new__(TranslationModel))


# ----------------------------------------------------------------- the training loop

class _StubModel:
    """Records the training loop's calls: steps (their iteration count and
    batches), the gallery's forwards and the checkpoint writes."""

    loss_names = ["a"]

    def __init__(self, log, multi=True):
        self.log, self.multi, self.iters = log, multi, 0
        self.metrics, self.visuals = {"a": 1.0}, {}

    # the JAX and the port's surface alike
    def setup(self, opt=None):
        pass

    def _train(self):
        pass

    def shard(self, batch):
        return batch

    def eval(self):
        pass

    def supports_multi_step(self):
        return self.multi

    def set_input(self, data):
        self.staged = data

    def optimize_parameters(self, iters, fr=1):
        self.iters = iters
        self.log.append(("step", iters, 1))

    def optimize_parameters_multi(self, batches, iters):
        self.iters = iters
        self.staged = batches[-1]
        self.log.append(("step", iters, len(batches)))

    def calculate(self, stage="test"):
        self.metrics = {"a": 2.0}
        self.log.append(("display", self.iters, self.staged))

    def get_current_visuals(self):
        return {}

    def get_current_losses(self):
        return {"a": float(self.metrics["a"])}

    def save_networks(self, suffix):
        self.log.append(("save", self.iters, str(suffix)))

    def update_learning_rate(self, epoch=None, metric=None):
        self.log.append(("lr", epoch, metric))


class _Batches(list):
    @property
    def dataset(self):
        return self


def _flags(tmp, spc):
    return ["--model_type", "main", "--use_image_for_trans", "--name", "s",
            "--checkpoints_dir", str(tmp), "--do_train", "--batch_size", "2",
            "--n_epochs", "2", "--n_epochs_decay", "0", "--print_freq", "4",
            "--display_freq", "6", "--save_latest_freq", "3", "--save_epoch_freq", "1",
            "--steps_per_call", str(spc)]


def _run_jax_main(tmp, spc, data):
    import main as jax_main
    from desr_tpu.utils.visualizer import Visualizer

    log = []
    model = _StubModel(log)
    with mock.patch.object(jax_main, "create_model", lambda opt: model), \
            mock.patch.object(jax_main, "create_dataset", lambda *a, **k: data), \
            mock.patch.object(jax_main, "dataset_for_model", lambda opt: None), \
            mock.patch.object(Visualizer, "print_current_losses",
                              lambda self, e, it, *a: log.append(("print", it, e))), \
            mock.patch.object(sys, "argv", ["main.py", *_flags(tmp / "jax", spc)]):
        jax_main.main()
    return log


def _run_port(tmp, spc, data):
    from desr_tpu_torch import train
    from desr_tpu_torch.data import loader
    from desr_tpu_torch.models import main_model, main_sr_model  # noqa: F401  (before the patch)
    from desr_tpu_torch.utils.visualizer import Visualizer

    log = []
    with mock.patch.object(main_model, "MainModel", lambda *a, **k: _StubModel(log)), \
            mock.patch.object(loader, "create_dataset", lambda *a, **k: data), \
            mock.patch.object(loader, "dataset_for_model", lambda opt: None), \
            mock.patch.object(Visualizer, "print_current_losses",
                              lambda self, e, it, *a: log.append(("print", it, e))):
        train.main(_flags(tmp / "port", spc) + ["--device", "cpu"])
    return log


@pytest.mark.parametrize("spc", [1, 2, 3])
def test_train_loop_iterations_match_main_py(tmp_path, spc):
    """main.py and the port's training loop over 2 epochs of 7 batches (batch 2):
    the same steps and groups (the epoch's short tail too), the same
    iterations at which the losses print, the gallery's forward runs (on
    the same staged batch) and the checkpoints are written, and the same
    plateau feed (at_freq, main.py:80-82)."""
    data = _Batches({"i": i} for i in range(7))
    want, got = _run_jax_main(tmp_path, spc, data), _run_port(tmp_path, spc, data)
    assert got == want
    kinds = {k for k, *_ in got}
    assert kinds == {"step", "print", "display", "save", "lr"}


# ----------------------------------------------------------------- the train state

def test_train_state_resume_is_bit_equal(tmp_path):
    """save_train_state after step 2, load_train_state into a fresh model
    that has taken a step of its own (so its trained nets, Adam and hole
    generator all differ; its frozen nets are the run's, as their .pth
    files give them): step 3 (its holes drawn from the restored generator,
    Adam from the restored moments) bit-equal to the uninterrupted run's;
    the LR and the plateau history come back too; step=None takes the
    largest state."""
    run = _main_model(["--lr_policy", "plateau"])
    for i, b in enumerate(BATCHES[:2]):
        run.set_input(b)
        run.optimize_parameters(i + 1)
    run.lr, run.plateau_history = 1.5e-4, [0.3, 0.2]
    for o in run.optimizers:
        for g in o.param_groups:
            g["lr"] = run.lr
    ckpt.save_train_state(run, str(tmp_path), 1)
    path = ckpt.save_train_state(run, str(tmp_path), 2)
    assert path.endswith("state_2") and os.path.exists(path)
    run.set_input(BATCHES[2])
    run.optimize_parameters(3)

    resumed = _main_model(["--lr_policy", "plateau"])
    resumed.set_input(BATCHES[3])
    resumed.optimize_parameters(1)
    assert ckpt.load_train_state(resumed, str(tmp_path)) == 2
    assert resumed.lr == 1.5e-4 and resumed.plateau_history == [0.3, 0.2]
    resumed.set_input(BATCHES[2])
    resumed.optimize_parameters(3)
    _assert_bit_equal(_weights(resumed), _weights(run))
    for k in run.metrics:
        assert torch.equal(resumed.metrics[k], run.metrics[k]), k
    with pytest.raises(FileNotFoundError):
        ckpt.load_train_state(resumed, str(tmp_path / "none"))


# ----------------------------------------------------------------- options

@pytest.mark.parametrize("flags,attr,value", [
    (["--steps_per_call", "4"], "steps_per_call", 4),
    (["--remat"], "remat", True), (["--remat_blocks"], "remat_blocks", True),
    (["--remat_tails"], "remat_tails", True), (["--no_remat_tails"], "remat_tails", False),
    ([], "remat_tails", None), (["--use_wandb"], "use_wandb", True),
    (["--lr_policy", "plateau"], "lr_policy", "plateau"), (["--norm", "batch"], "norm", "batch"),
    (["--norm", "none"], "norm", "none"), (["--init_type", "orthogonal"], "init_type", "orthogonal"),
])
def test_newly_accepted_flags_parse(flags, attr, value):
    assert getattr(_parse(*flags), attr) == value


# the first two cases keep the ids they had while every --spatial_devices > 1
# refused: translation still does, and one device does not divide by S = 2
@pytest.mark.parametrize("flags,msg", [
    pytest.param(["--num_devices", "2", "--spatial_devices", "2", "--model_type", "translation"],
                 "not yet ported", id="flags0-not yet ported"),
    pytest.param(["--spatial_devices", "2"], "--num_devices 1 does not divide by "
                 "--spatial_devices 2", id="flags1-not yet ported"),
    (["--compiler_option", "xla_tpu_scoped_vmem_limit_kib=65536"], "steers XLA"),
    (["--no_donate"], "steers XLA"), (["--compile_cache_dir", "/x"], "steers XLA"),
])
def test_mesh_flags_and_xla_switches_still_refuse(flags, msg, capsys):
    with pytest.raises(SystemExit) as e:
        _parse(*flags)
    assert e.value.code != 0 and msg in capsys.readouterr().err


# ----------------------------------------------------------------- --init_type

@pytest.mark.parametrize("init_type", ["normal", "xavier", "kaiming", "orthogonal"])
@pytest.mark.parametrize("shape", [(128, 64, 3, 3), (64, 32, 4, 4), (96, 576, 1, 1)])
def test_init_weight_std_matches_jax(init_type, shape):
    """The empirical std of a drawn weight within 3% of JAX's init_weight
    on the same shape (pix2pix gain 0.02, and the translation lineage's
    sqrt(2)); orthogonal: W Wt (rows <= cols) or Wt W within 1e-5 of
    gain^2 I."""
    from desr_tpu.models.layers import InitCfg, init_weight

    for gain, cfg in ((0.02, InitCfg(init_type=init_type, init_gain=0.02)),
                      (np.sqrt(2.0), InitCfg(init_type=init_type, gain_from_nonlinearity=True))):
        want = np.asarray(init_weight(jax.random.PRNGKey(0), shape, cfg))
        w = torch.empty(shape)
        std = 0.02 if init_type == "normal" else gain
        TN.init_weight_(w, init_type, 0.02, std, torch.Generator().manual_seed(1))
        assert abs(float(w.std()) / float(want.std()) - 1) < 0.03, (gain, float(w.std()),
                                                                    float(want.std()))
        if init_type == "orthogonal":
            m = w.reshape(shape[0], -1).double() / gain
            gram = m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m
            np.testing.assert_allclose(gram.numpy(), np.eye(gram.shape[0]), rtol=0, atol=1e-5)


def test_init_types_reach_every_net():
    """define_G / define_D / define_Gen take each init: a conv's std sets
    by the type and lineage (translation G: gain sqrt(2); D: leaky 0.2);
    BatchNorm weights ~ N(1, init_gain)."""
    g = TN.define_G(3, 1, 8, "resnet_6blocks", init_type="kaiming", norm="batch",
                    init_gain=0.05)
    conv = g.model[10].conv_block[1]  # 32 -> 32, 3x3
    assert abs(float(conv.weight.std()) / np.sqrt(2 / (32 * 9)) - 1) < 0.05
    bn_w = torch.cat([m.weight for m in g.modules() if isinstance(m, TL.BatchNorm2d)])
    assert abs(float(bn_w.std()) / 0.05 - 1) < 0.2 and abs(float(bn_w.mean()) - 1) < 0.02
    gen = TT.define_Gen(_small_translator(init_type="orthogonal"), "img_depth")
    w = gen.bottlenec.model[0].conv_block[0].weight  # 64 -> 64, 3x3
    w = w.reshape(w.shape[0], -1)
    np.testing.assert_allclose((w @ w.T).detach().numpy(), 2.0 * np.eye(64), atol=1e-4)
    d = TT.define_D(SimpleNamespace(netD="basic", norm_d="none", ndf=8, init_type="xavier",
                                    use_spnorm=False, n_layers_D=3))
    w0 = d.model[0].weight  # 1 -> 8, 4x4
    gain = np.sqrt(2 / (1 + 0.04))
    assert abs(float(w0.std()) / (gain * np.sqrt(2 / (16 + 128))) - 1) < 0.2
    with pytest.raises(NotImplementedError, match="not implemented"):
        TN.define_G(3, 1, 8, "resnet_6blocks", init_type="bogus")


# ----------------------------------------------------------------- --norm batch / none

def _jax_apply(net, params, x, train, stats=None):
    from desr_tpu.models.layers import Ctx

    return np.asarray(net.apply({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
                                Ctx(train=train, dtype=jnp.float32, stats=stats)))


NORM_NETS = [("G", "resnet_6blocks", "batch", 32), ("G", "resnet_6blocks", "none", 32),
             ("G", "unet_128", "batch", 128), ("G", "unet_128", "none", 128),
             ("D", "basic", "batch", 64), ("D", "pixel", "batch", 32)]


@pytest.mark.parametrize("kind,name,norm,size", NORM_NETS)
def test_zoo_a_norms_match_jax(kind, name, norm, size):
    """define_G / define_D under --norm batch and --norm none against JAX's
    on the same params and input, float32, within 1e-5: the train-mode
    forward (the batch's moments), the eval forward (running statistics,
    set to random values first), and the running statistics after two
    tracked train forwards (JAX's stats sink, chained)."""
    from desr_tpu.models import networks as JN

    if kind == "G":
        jnet, tnet = JN.define_G(3, 4, 8, name, norm=norm), TN.define_G(3, 4, 8, name, norm=norm)
        nin = 3
    else:
        jnet, tnet = JN.define_D(4, 8, name, norm=norm), TN.define_D(4, 8, name, norm=norm)
        nin = 4
    params = jax_params(jnet, seed=2)
    rng = np.random.default_rng(3)
    for k in params:
        if k.endswith("running_mean"):
            params[k] = rng.normal(0, 0.1, params[k].shape).astype(np.float32)
        elif k.endswith("running_var"):
            params[k] = rng.uniform(0.5, 2.0, params[k].shape).astype(np.float32)
    tnet.load_state_dict(from_jax_params(params), strict=True)
    x = randn((2, size, size, nin), 4)
    y = randn((2, size, size, nin), 5)
    with torch.no_grad():
        for train in (True, False):
            want = _jax_apply(jnet, params, x, train)
            with TL.batch_norm_mode(train):
                got = tnet(nhwc_to_nchw(x)).permute(0, 2, 3, 1).numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=f"train={train}")
        stats = {}
        _jax_apply(jnet, params, x, True, stats)
        _jax_apply(jnet, params, y, True, stats)
        with TL.batch_norm_mode(True, track=True):
            tnet(nhwc_to_nchw(x))
            tnet(nhwc_to_nchw(y))
    state = tnet.state_dict()
    assert (len(stats) > 0) == (norm == "batch")
    for k, v in stats.items():
        np.testing.assert_allclose(state[k].numpy(), np.asarray(v), rtol=0, atol=1e-5, err_msg=k)


def test_batch_norm_resnet_block_routes_agree():
    """A --norm batch ResnetBlock through K2 (--pallas_conv) and through its
    layers (cuDNN's convs) agree within 1e-5 in both modes."""
    block = TN.ResnetBlock(16, "reflect", TL.BatchNorm2d, False, False)
    TN.init_weights(block, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(randn((2, 16, 12, 10), 6))
    for train in (True, False):
        with torch.no_grad(), TL.batch_norm_mode(train):
            block.fused = True
            plain = block(x)
            block.fused = False
            k2 = block(x)
        torch.testing.assert_close(k2, plain, rtol=0, atol=1e-5)


def test_main_step_under_norm_batch_moves_no_running_stats():
    """The main stage's train step normalises with the batch's moments in
    every net (the frozen ones too) and moves no running statistics, as
    JAX's step passes no stats sink; its eval forward uses them."""
    m = _main_model(["--norm", "batch"])
    before = _weights(m)
    m.set_input(BATCHES[0])
    m.optimize_parameters(1)
    after = _weights(m)
    stats = [k for k in before if "running_" in k or "num_batches" in k]
    assert stats and all(torch.equal(after[k], before[k]) for k in stats)
    assert np.isfinite(float(m.metrics["G"]))
    m.calculate(stage="train")
    assert all(np.isfinite(v).all() for v in m.get_current_visuals().values())


def test_main_step_under_norm_batch_matches_jax(tmp_path):
    """One main train step under --norm batch (every zoo-A net on its batch
    moments, the real and synthetic branches in one batch-2B call), the same
    params, batch and holes through JAX's value_and_grad and the port's
    compute_grads, float32, the translator cut to 8+8 channels and one block
    in both: loss terms within 1e-4 relative (1e-6 absolute near 0), each
    weight gradient of Depth_f and Task within 3e-2 relative L2 and each
    bias within 1e-3 of the net's largest entry, the bounds of
    tests/test_torch_train.py::test_train_step_grads_match_jax."""
    from desr_tpu.models import translation_networks as JTT
    from desr_tpu.models.main_model import MainModel as JaxMainModel
    from desr_tpu.options.train_options import TrainOptions

    argv = TTR.STAGE3 + TTR.SMALL + [
        "--norm", "batch", "--name", "nb", "--checkpoints_dir", str(tmp_path),
        "--batch_size", str(TTR.B), "--crop_size_h", str(TTR.H), "--crop_size_w", str(TTR.W)]
    inject = TTR._InjectHoles()
    batch = TTR._batch()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TTR.JDPT, "random_rect_holes", inject.jax)
        mp.setattr(TTR.TDPT, "random_rect_holes", inject.torch)
        full = JTT.default_translator_opt
        mp.setattr(JTT, "default_translator_opt",
                   lambda full=full: full(ngf_img=8, ngf_depth=8, n_blocks=1))
        mp.setattr(TT, "default_translator_opt", _small_translator)
        jm = JaxMainModel(TrainOptions().parse(argv))
        jm.init_params(0)
        forward, losses = jm._forward_fn(), jm._losses_fn()
        jb = {k: jnp.asarray(v) for k, v in batch.items()}

        def loss_fn(g_train, params):
            merged = dict(params, **{n: dict(params[n], **g) for n, g in g_train.items()})
            return losses(forward(merged, jb, jax.random.PRNGKey(0), True), jb)

        # the float leaves (BatchNorm's int64 batch counters take no gradient)
        g_train = {n: {k: v for k, v in jm.params[n].items()
                       if jnp.issubdtype(v.dtype, jnp.floating)} for n in ("Depth_f", "Task")}
        (_, jmetrics), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            g_train, jm.params)
        tm = MainModel(_parse(*argv), device="cpu", compute_dtype=torch.float32, is_train=True)
        for n, p in jm.params.items():
            tm.nets[n].load_state_dict(from_jax_params({k: np.array(v) for k, v in p.items()}),
                                       strict=True)
        tm.set_input(batch)
        tmetrics = {k: float(v) for k, v in tm.compute_grads().items()}
    assert any("running_mean" in k for k in tm.nets["Depth_f"].state_dict())
    for k in jm.loss_names + ["G"]:
        np.testing.assert_allclose(tmetrics[k], float(jmetrics[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    for n in ("Depth_f", "Task"):
        want = {k: np.asarray(v) for k, v in jgrads[n].items()}
        got = {k: p.grad.numpy() for k, p in tm.nets[n].named_parameters()}
        assert set(got) <= set(want)  # JAX's float leaves also hold the running stats
        net_max = max(np.abs(want[k]).max() for k in got)
        for k, g in got.items():
            if k.endswith("bias"):
                np.testing.assert_allclose(g, want[k], rtol=0, atol=1e-3 * net_max,
                                           err_msg=f"{n}.{k}")
            else:
                rel = np.linalg.norm(g - want[k]) / np.linalg.norm(want[k])
                assert rel <= 3e-2, (f"{n}.{k}", rel)


def test_i2d_d_step_under_norm_batch_moves_only_d_stats(tmp_path):
    """I2D with --use_D --norm batch: the D step moves D_depth's running
    statistics (twice a step, chained, as JAX's sink); Image_f's and Task's
    stay (JAX's G step has no sink)."""
    opt = train_options.parse(TI._argv(tmp_path, ["--use_D", "--norm", "batch"])
                              + ["--device", "cpu"], print_options=False)
    m = I2DModel(opt, device="cpu", compute_dtype=torch.float32, is_train=True)
    before = _weights(m)
    m.set_input(TI._batch(1))
    m.optimize_parameters(1)
    after = _weights(m)
    for k in before:
        if "num_batches_tracked" in k:
            assert int(after[k]) - int(before[k]) == (2 if k.startswith("D_depth") else 0), k
    assert all(np.isfinite(float(v)) for v in m.metrics.values())


# ----------------------------------------------------------------- the CLI

@pytest.mark.parametrize("extra", [
    ["--steps_per_call", "2", "--lr_policy", "plateau", "--remat", "--use_wandb",
     "--init_type", "xavier"],
    ["--remat_tails", "--norm", "batch", "--init_type", "kaiming"],
    ["--remat_blocks", "--norm", "none", "--init_type", "orthogonal", "--pallas_conv"],
], ids=["spc2-plateau-remat-wandb-xavier", "tails-batch-kaiming", "blocks-none-orthogonal-k2"])
def test_train_cli_writes_the_gallery(tmp_path, monkeypatch, capsys, extra):
    """train.main --device cpu on 3 frames a domain at batch 1, a gallery
    every batch: each flag set is accepted, the losses are finite, the
    gallery holds the 13 visuals' PNGs (decodable, 64x80 RGB) and an index
    naming them; --use_wandb falls back to the console without wandb."""
    from desr_tpu_torch import train

    monkeypatch.setattr(TT, "default_translator_opt", _small_translator)
    root = str(tmp_path)
    TTR._write_folder(root, n=3, hw=(64, 80))
    ck = tmp_path / "ck"
    losses = train.main([*TTR.STAGE3, *TTR.SMALL, *TTR._data_flags(root, hw=(64, 80)),
                         "--name", "g", "--checkpoints_dir", str(ck), "--do_train",
                         "--batch_size", "1", "--n_epochs", "1", "--n_epochs_decay", "0",
                         "--print_freq", "1", "--display_freq", "1", "--num_threads", "0",
                         "--crop_size_h", "128", "--crop_size_w", "128",
                         "--device", "cpu", *extra])
    out = capsys.readouterr().out
    assert losses and all(np.isfinite(v) for v in losses.values())
    web = ck / "g" / "web"
    names = sorted(os.listdir(web / "images"))
    assert len(names) == 13 and all(n.startswith("epoch001_") for n in names)
    index = (web / "index.html").read_text()
    assert all(f"images/{n}" in index for n in names)
    for n in names:
        img = read_png(web / "images" / n)
        assert img.dtype == np.uint8 and img.shape == (512, 640, 3), (n, img.shape)
    if "--use_wandb" in extra:
        assert "wandb not available; falling back to console logging" in out


def test_i2d_cli_groups_steps_and_writes_the_gallery(tmp_path):
    """train --model_type I2D --steps_per_call 2 over 3 frames at batch 1
    (a group of 2 and the tail of 1), its six visuals in the gallery."""
    from desr_tpu_torch import train

    root = str(tmp_path)
    TTR._write_folder(root, n=3, hw=(64, 80))
    flags = TTR._data_flags(root, hw=(64, 80))
    ck = tmp_path / "ck"
    losses = train.main(["--model_type", "I2D", *TI.SMALL, *flags[:16], "--image_and_depth",
                         "--use_scannet", "--name", "i", "--checkpoints_dir", str(ck),
                         "--do_train", "--batch_size", "1", "--n_epochs", "1",
                         "--n_epochs_decay", "0", "--display_freq", "2", "--print_freq", "2",
                         "--steps_per_call", "2", "--num_threads", "0", "--compute_dtype",
                         "float32", "--device", "cpu"])
    assert losses and all(np.isfinite(v) for v in losses.values())
    names = sorted(os.listdir(ck / "i" / "web" / "images"))
    assert names == [f"epoch001_{k}.png" for k in sorted(I2DModel.visual_names)]
