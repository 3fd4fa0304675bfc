"""--remat, --remat_blocks and --remat_tails in the port (torch.utils.checkpoint),
float32 on the CPU: each flag's step equals the step without it (the same
loss terms and gradients within 1e-6 relative; in practice bit-equal) in the
main, I2D and stage-2 models; the K1 calls a main step makes under each
(the recompute of --remat and --remat_blocks adds Depth_f's; the selective
policy of --remat_tails keeps K1's outputs); the policy keeps every conv
output; a BatchNorm stays outside every checkpoint. Mirrors
tests/test_remat_blocks.py and tests/test_remat_tails.py.
"""

from unittest import mock

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import test_torch_i2d as TI
import test_torch_train as TTR
import test_torch_translation as TTL
from desr_tpu_torch.models import layers as TL
from desr_tpu_torch.models import networks as TN
from desr_tpu_torch.models import translation_networks as TT
from desr_tpu_torch.models.i2d_model import I2DModel
from desr_tpu_torch.models.main_model import MainModel
from desr_tpu_torch.models.translation_model import TranslationModel
from desr_tpu_torch.ops import conv3x3 as K
from desr_tpu_torch.options import train_options

torch.set_num_threads(2)

REMAT = {"none": [], "remat": ["--remat"], "remat_blocks": ["--remat_blocks"],
         "remat_tails": ["--remat_tails"]}


_DEFAULT_TRANSLATOR = TT.default_translator_opt


def _small_translator(**kw):
    return _DEFAULT_TRANSLATOR(**dict(dict(ngf_img=8, ngf_depth=8, n_blocks=1), **kw))


class _CountK1:
    """Counts K1's forward calls (its plain version, on the CPU)."""

    def __init__(self):
        self.n = 0
        self._orig = K._fused_forward

    def __call__(self, *args):
        self.n += 1
        return self._orig(*args)


def _close(got, want, what):
    """Within 1e-6 relative of each tensor's largest entry (bit-equal on
    this CPU so far)."""
    scale = max(float(want.abs().max()), 1e-12)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6 * scale,
                               err_msg=what)


def _main_step(flags, argv_extra=()):
    """One main step's (loss terms, grads, K1 calls) at small widths, the
    translator cut to 8+8 channels and one block, the same weights and
    holes for every flag."""
    opt = train_options.parse(TTR.STAGE3 + TTR.SMALL + list(flags) + list(argv_extra)
                              + ["--device", "cpu"], print_options=False)
    count = _CountK1()
    with mock.patch.object(TT, "default_translator_opt", _small_translator), \
            mock.patch.object(K, "_fused_forward", count):
        m = MainModel(opt, device="cpu", compute_dtype=torch.float32, is_train=True,
                      generator=torch.Generator().manual_seed(3),
                      hole_generator=torch.Generator().manual_seed(4))
        m.set_input(TTR._batch(5))
        count.n = 0
        metrics = m.compute_grads()
    grads = {f"{n}.{k}": p.grad.clone() for n in m.trainable_nets
             for k, p in m.nets[n].named_parameters()}
    return metrics, grads, count.n


@pytest.fixture(scope="module")
def main_plain():
    return _main_step([])


@pytest.mark.parametrize("flag", ["remat", "remat_blocks", "remat_tails"])
def test_main_step_under_remat_equals_plain(main_plain, flag):
    """Loss terms and Depth_f / Task gradients of the step within 1e-6 of
    the plain step's."""
    m0, g0, _ = main_plain
    m1, g1, _ = _main_step(REMAT[flag])
    assert set(m1) == set(m0) and set(g1) == set(g0)
    for k in m0:
        _close(m1[k], m0[k], k)
    for k in g0:
        _close(g1[k], g0[k], k)


@pytest.mark.parametrize("flag,extra", [("none", 0), ("remat", 12), ("remat_blocks", 12),
                                        ("remat_tails", 0)])
def test_main_step_k1_calls_under_remat(main_plain, flag, extra):
    """K1 calls a step: G_A_d 2 (one block here), I2D_features 12, Depth_f
    12; the recompute of --remat and --remat_blocks calls Depth_f's 12 again
    in the backward, the --remat_tails policy keeps them (the frozen nets
    run under no_grad and are never recomputed)."""
    n = main_plain[2] if flag == "none" else _main_step(REMAT[flag])[2]
    assert n == 26 + extra


def test_main_step_under_remat_and_batch_norm_equals_plain():
    """--norm batch with --remat and --remat_blocks together: the
    checkpointed nets' BatchNorms normalise with the batch's moments in the
    recompute too (the whole-net checkpoint re-enters the train mode)."""
    m0, g0, _ = _main_step([], ["--norm", "batch"])
    m1, g1, _ = _main_step(["--remat", "--remat_blocks"], ["--norm", "batch"])
    for k in m0:
        _close(m1[k], m0[k], k)
    for k in g0:
        _close(g1[k], g0[k], k)


def _i2d_run(tmp, flags, steps=3):
    """``steps`` I2D train steps from the same init on one batch: G after
    each, Task's weights after them."""
    opt = train_options.parse(TI._argv(tmp, list(flags)) + ["--device", "cpu"],
                              print_options=False)
    m = I2DModel(opt, device="cpu", compute_dtype=torch.float32, is_train=True,
                 generator=torch.Generator().manual_seed(6))
    batch = TI._batch(3)
    g = []
    for it in range(steps):
        m.set_input(batch)
        m.optimize_parameters(it + 1)
        g.append(m.metrics["G"])
    m.calculate(stage="test")
    return g, m.metrics, {k: v.clone() for k, v in m.nets["Task"].state_dict().items()}


@pytest.mark.parametrize("flag", ["remat_tails", "remat_blocks"])
def test_i2d_steps_under_remat_equal_plain(tmp_path, flag):
    """tests/test_remat_tails.py / test_remat_blocks.py for the port: three
    steps' G, the eval losses and Task's weights after them equal the plain
    run's (within 1e-6 relative)."""
    g0, e0, p0 = _i2d_run(tmp_path, [])
    g1, e1, p1 = _i2d_run(tmp_path, REMAT[flag])
    for a, b in zip(g1, g0):
        _close(a, b, "G")
    for k in ("task_syn", "task_real", "G"):
        _close(e1[k], e0[k], k)
    for k in p0:
        _close(p1[k], p0[k], k)


def _translation_iteration(tmp, flags):
    opt = train_options.parse(TTL._argv(tmp, list(flags)) + ["--device", "cpu"],
                              print_options=False)
    with mock.patch.object(TT, "default_translator_opt", TTL._small):
        m = TranslationModel(opt, device="cpu", compute_dtype=torch.float32, is_train=True,
                             generator=torch.Generator().manual_seed(7))
    m.set_input(TTL._batch(2))
    m.optimize_parameters(1)
    return m.metrics, {f"{n}.{k}": v.clone() for n in m.model_names
                       for k, v in m.nets[n].state_dict().items()}


def test_translation_iteration_under_remat_tails_equals_plain(tmp_path):
    """One stage-2 iteration (2 G steps, 1 D step) under --remat_tails
    (the translators' ResnetBlockT chains and encoder/decoder runs): the
    terms and every net's weights after it equal the plain iteration's."""
    m0, p0 = _translation_iteration(tmp_path, [])
    m1, p1 = _translation_iteration(tmp_path, ["--remat_tails"])
    for k in m0:
        _close(m1[k], m0[k], k)
    for k in p0:
        _close(p1[k].float(), p0[k].float(), k)


class _ConvCalls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.convolution.default, torch.ops.desr.conv3x3_fused.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("netG", ["resnet_6blocks", "unet_128"])
def test_net_grads_and_conv_calls_under_each_mode(netG):
    """A zoo-A generator's loss and gradients under "blocks" and "tails"
    equal the plain ones (tests/test_remat_blocks.py:45-73); the forward
    convolutions run again in the backward under "blocks" only (the
    policy keeps their outputs under "tails")."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 3, 128, 128))
                         .astype(np.float32))
    out = {}
    for mode in (None, "blocks", "tails"):
        net = TL.set_remat(TN.define_G(3, 1, 8, netG, generator=torch.Generator().manual_seed(1)),
                           mode)
        calls = _ConvCalls()
        with calls:
            loss = net(x).square().sum()
            grads = torch.autograd.grad(loss, list(net.parameters()))
        out[mode] = (loss.detach(), grads, calls.n)
    for mode in ("blocks", "tails"):
        _close(out[mode][0], out[None][0], f"{mode} loss")
        for a, b in zip(out[mode][1], out[None][1]):
            _close(a, b, f"{mode} grad")
    n_plain = out[None][2]
    assert out["tails"][2] == n_plain
    assert out["blocks"][2] > n_plain


def test_batch_norm_stays_outside_the_checkpoints():
    """Under "blocks" and "tails" with --norm batch tracking its statistics,
    each BatchNorm moves them once a forward (a BatchNorm inside a
    checkpoint would move them again in the recompute), and the running
    statistics equal the plain run's."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 3, 64, 64))
                         .astype(np.float32))
    stats = {}
    for mode in (None, "blocks", "tails"):
        net = TL.set_remat(TN.define_G(3, 4, 8, "resnet_6blocks", norm="batch",
                                       generator=torch.Generator().manual_seed(2)), mode)
        with TL.batch_norm_mode(True, track=True):
            net(x).square().sum().backward()
        bns = [m for m in net.modules() if isinstance(m, TL.BatchNorm2d)]
        assert all(int(m.num_batches_tracked) == 1 for m in bns)
        stats[mode] = torch.cat([torch.cat([m.running_mean, m.running_var]) for m in bns])
    for mode in ("blocks", "tails"):
        _close(stats[mode], stats[None], mode)


def test_remat_modes_from_options():
    """--remat_blocks takes precedence over --remat_tails; --remat_tails'
    default (None, the JAX per-stage default) is off in the port."""
    from desr_tpu_torch.models.base_model import remat_modes

    def modes(*flags):
        return remat_modes(train_options.parse(["--device", "cpu", *flags], print_options=False))

    assert modes() == (False, None)
    assert modes("--remat") == (True, None)
    assert modes("--remat_tails") == (False, "tails")
    assert modes("--no_remat_tails") == (False, None)
    assert modes("--remat_tails", "--remat_blocks") == (False, "blocks")
