"""The rank side of the port's stage-2 and remat tests on a spatial mesh
(tests/test_torch_spatial_gan.py, tests/test_torch_spatial_remat.py):
functions that ``desr_tpu_torch.parallel.launch`` runs in each spawned rank
of a ``--spatial_devices`` mesh, and that the tests also call in one
process on whole frames. This module imports torch and the port alone, so
that a spawned rank starts quickly; it holds no tests.

Every function returns host values (numpy arrays, floats, ints).
"""

from unittest import mock

import numpy as np
import torch

import test_torch_spatial_ranks as SR
import test_torch_spatial_train_ranks as STR
from desr_tpu_torch.models import layers as TL
from desr_tpu_torch.models import translation_networks as TT
from desr_tpu_torch.parallel import spatial as S
from desr_tpu_torch.weights import from_jax_params

TB, TH = 2, 128  # stage 2's batch and frame: the bottleneck's 32 rows split over two ranks


def translation_batch(seed=3, n=TB, hw=TH):
    """A stage-2 batch: A's depth in [-0.5, 1], B's with holes at -1."""
    rng = np.random.default_rng(seed)
    da = rng.uniform(-0.5, 1, (n, hw, hw, 1)).astype(np.float32)
    db = rng.uniform(-0.5, 1, (n, hw, hw, 1)).astype(np.float32)
    db[db < -0.3] = -1.0
    return {"A_depth": da, "A_img": rng.uniform(-1, 1, (n, hw, hw, 3)).astype(np.float32),
            "B_depth": db, "B_img": rng.uniform(-1, 1, (n, hw, hw, 3)).astype(np.float32)}


class Jitter(STR.Jitter):
    """``STR.Jitter``'s noise, and the GroupNorms' outputs times (1 + 1e-6
    N(0, 1)): the translators normalise by GroupNorm, whose moments a band
    sums in another order too."""

    def __init__(self, seed=12):
        super().__init__(seed)
        self.group_norm = TL.GroupNorm.forward

    def patches(self):
        j = self
        return super().patches() + (mock.patch.object(
            TL.GroupNorm, "forward", lambda gn, x: j._noise(j.group_norm(gn, x))),)


def _maybe_jitter(jitter):
    """``Jitter(jitter)``'s patches (``jitter`` a seed), or none for None."""
    import contextlib

    stack = contextlib.ExitStack()
    for patch in () if jitter is None else Jitter(jitter).patches():
        stack.enter_context(patch)
    return stack


def translation_iteration(mesh, argv, batch, params0=None, jitter=None, dtype=torch.float32):
    """One TranslationModel iteration (the G steps, then the D steps) on
    ``batch``, the translators cut to 8+8 channels and one block, from
    ``params0`` (JAX param dicts) or the seeded init; ``jitter`` a seed of
    ``Jitter``'s noise, or None; ``dtype`` as ``STR.main_step``'s. Returns the metrics, the G and D
    gradients of the iteration's last G and D step, every net's state,
    whether the frames were split and the collectives issued."""
    from desr_tpu_torch.models.translation_model import TranslationModel

    torch.set_num_threads(2)
    with mock.patch.object(TT, "default_translator_opt", SR.small_translator), \
            _maybe_jitter(jitter), STR._precision(dtype):
        model = TranslationModel(STR._opt(argv), device="cpu", compute_dtype=dtype,
                                 is_train=True, mesh=mesh).to(dtype)
        for n, p in (params0 or {}).items():
            model.nets[n].load_state_dict(from_jax_params(p), strict=True)
        model.set_input(batch)
        STR._reset()
        model.optimize_parameters(len(batch["A_depth"]))
        counts = STR._counts()
    return dict(metrics=STR._host(model.metrics), grads=STR._grads(model, model.optimized_nets),
                state=STR._state(model, model.model_names), h_split=bool(model._batch.h_split),
                counts=counts)


def translation_runs(mesh, argv, batch, params0=None, patchgan=False):
    """``translation_iteration`` at float32 and at float64 (its float32
    weights cast) on this rank, and with ``patchgan`` the
    ``spnorm_patchgan`` of this rank's band, in one launch."""
    out = {"f32": translation_iteration(mesh, argv, batch, params0),
           "f64": translation_iteration(mesh, argv, batch, params0, dtype=torch.float64)}
    if patchgan:
        out["patchgan"] = spnorm_patchgan(S.from_mesh(mesh), mesh.size)
    return out


def spnorm_patchgan(spatial=None, size=1):
    """A ``--use_spnorm`` PatchGAN (the translation lineage's, instance norm)
    on two seeded frames, whole (``spatial`` None) or this rank's band: the
    whole logits, the input's gradient (this rank's rows) and the weights'
    gradients of a seeded scalar of the logits, and the collectives."""
    import types

    opt = types.SimpleNamespace(netD="basic", n_layers_D=3, norm_d="instance", ndf=4,
                                use_spnorm=True, init_type="normal")
    net = S.set_spatial_group(TT.define_D(opt, "normal", torch.Generator().manual_seed(5)),
                              spatial)
    x = STR._seeded_like((2, 3, 64, 32), 8)
    v = STR._band(x, spatial).clone().requires_grad_(True)
    S.reset_counts()
    y = net(v)
    (y * STR._seeded_like(tuple(y.shape), 9)).sum().div(size).backward()
    return dict(out=y.detach().numpy(), dx=v.grad.numpy(), grads=STR._grads_of(net),
                counts=dict(S.COUNTS))


# ----------------------------------------------------------------- remat

def remat_step(mesh, kind, argv, args, dtype=torch.float32):
    """One step of ``kind`` ("main", "sr", "i2d" or "translation") under
    ``argv`` (its remat flag among them) on this rank: ``STR.main_step``,
    ``STR.i2d_steps`` (one step) or ``translation_iteration`` on ``args``
    (the batch, and the main step's covers). Each result holds the
    weight gradients and the collectives issued."""
    if kind == "translation":
        return translation_iteration(mesh, argv, *args, dtype=dtype)
    if kind == "i2d":
        return STR.i2d_steps(mesh, argv, *args, 1, dtype=dtype)
    return STR.main_step(mesh, argv, *args, sr=kind == "sr", dtype=dtype)


def remat_steps(mesh, cases):
    """``remat_step`` of each (name, kind, argv, args, dtype) of ``cases``
    on this rank, in one launch: {name: result}."""
    torch.set_num_threads(2)
    return {name: remat_step(mesh, kind, argv, args, dtype)
            for name, kind, argv, args, dtype in cases}

