"""The rank side of the port's spatial training tests
(tests/test_torch_spatial_train.py): functions that
``desr_tpu_torch.parallel.launch`` runs in each spawned rank of a
``--spatial_devices`` mesh, and that the tests also call in one process on
whole frames. This module imports torch and the port alone, so that a
spawned rank starts quickly; it holds no tests.

Every function returns host values (numpy arrays, floats, ints).
"""

from unittest import mock

import numpy as np
import torch

import desr_tpu_torch.ops.depth as TDPT
import test_torch_spatial_ranks as SR
from desr_tpu_torch.models import layers as TL
from desr_tpu_torch.models import networks as TN
from desr_tpu_torch.models import translation_networks as TT
from desr_tpu_torch.ops import conv3x3 as K
from desr_tpu_torch.ops import instance_norm as IN
from desr_tpu_torch.ops import losses as L
from desr_tpu_torch.ops import masked_loss as K3
from desr_tpu_torch.ops import normals as NRM
from desr_tpu_torch.options import train_options
from desr_tpu_torch.parallel import mesh as M
from desr_tpu_torch.parallel import spatial as S
from desr_tpu_torch.weights import from_jax_params


def _band(t, sp, dim=2):
    return t if sp is None else S.take_h(t, sp, dim)


def _seeded_like(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _ops():
    """{name: (fn(input, sp, group) -> output, kind, planar input)}: the
    loss-side ops of the train steps. ``kind``: "band" (the rank's rows of
    the output), "whole" (the whole output, alike on every rank) or "loss"
    (a scalar, N times the rank's share of the global value)."""
    Kmat = torch.tensor([[[577.0, 0, 320], [0, 577, 240], [0, 0, 1]]]).repeat(2, 1, 1)
    crop = torch.tensor([[8.0, 72, 2, 22]]).repeat(2, 1)

    def depth(x):
        return torch.tanh(x[:, 0])

    def normals_k(x, sp):
        return NRM.surface_normals_from_K_planar(depth(x), Kmat, crop, spatial=sp)

    def mask(x):  # a fixed (B, H, W) mask of the input's rows
        return (x[:, 1].detach() > -0.3).float()

    def hole_means(x, sp, g):
        d = depth(x)
        t0, t1, t2 = K3.fused_hole_means(d, torch.cos(x[:, 2].detach()), mask(x),
                                         (x[:, 3].detach() > 0.5).float())
        return 0.7 * t0 - 1.3 * t1 + 0.4 * t2

    resizes = {f"{name}{sfx}": ((lambda x, sp, g, fn=fn, hw=(oh, ow), p=bool(sfx):
                                  fn(x[:, 0] if p else x, hw, sp)), "band")
               for name, (fn, oh, ow) in SR.RESIZES.items() for sfx in ("", "_planar")}
    return {
        **resizes,
        "np_gradient": (lambda x, sp, g: NRM.np_gradient(depth(x), 1, sp), "band"),
        "normals": (lambda x, sp, g: NRM.surface_normals_planar(depth(x), spatial=sp), "band"),
        "normals_from_K": (lambda x, sp, g: normals_k(x, sp), "band"),
        "valid_mask": (lambda x, sp, g: TDPT.valid_mask(depth(x).detach() - 0.8, spatial=sp),
                       "band"),
        "tv_loss": (lambda x, sp, g: L.tv_loss_planar(normals_k(x, sp), g, sp), "loss"),
        "tv_norm": (lambda x, sp, g: L.tv_norm_planar(x, sp), "loss"),
        "smooth": (lambda x, sp, g: L.smooth_weight_loss_planar(depth(x), x[:, 4:7], 3, sp),
                   "loss"),
        "masked_l1": (lambda x, sp, g: L.masked_l1_loss(depth(x), x[:, 5].detach(), mask(x),
                                                        group=g), "loss"),
        "masked_cos": (lambda x, sp, g: L.masked_cos_sim_loss_planar(
            normals_k(x, sp), x[:, 5:8].detach(), mask(x)[:, None].expand(-1, 3, -1, -1),
            group=g), "loss"),
        "hole_means_k3": (hole_means, "loss"),
    }


def _nets():
    """{name: (module, input channels)}: the PatchGANs (instance and batch
    norm, the latter in train mode with its statistics tracked) and a
    BatchNorm alone."""
    c = SR.FRAME[1]
    return {
        "patchgan": (TN.define_D(c, 4, "basic", norm="instance"), c),
        "patchgan_batch": (TN.define_D(c, 4, "basic", norm="batch"), c),
        "batch_norm": (TL.BatchNorm2d(c), c),
    }


def _grads_of(module):
    return {k: p.grad.numpy().copy() for k, p in module.named_parameters() if p.grad is not None}


def layer_grads(spatial=None, group=None, size=1):
    """Each layer of the spatial serving list (tests/test_torch_spatial_ranks.py),
    each loss-side op of the train steps and the PatchGANs, on the whole
    frame (``spatial`` None) or on this rank's band: the output (this
    rank's rows), the input's gradient (its rows) and the parameters'
    gradients (this rank's) of a seeded scalar of the output, which
    summed over the ``size`` ranks is the one-process scalar; and the
    BatchNorms' running statistics."""
    x_whole, u_whole = SR.layer_inputs()
    d_whole = _seeded_like((2, SR.FRAME[1], 64, 32), 7)  # the PatchGANs' (W/8 - 2 >= 2)
    out = {}
    layers = dict(SR._layers(), **_nets())
    S.reset_counts()
    for i, (name, (module, _)) in enumerate(layers.items()):
        module = S.set_spatial_group(SR._seeded(module, i), spatial)
        TL.set_batch_norm_group(module, group)
        v = u_whole if name == "unet" else d_whole if name in _nets() else x_whole
        v = _band(v, spatial).clone().requires_grad_(True)
        with TL.batch_norm_mode(True, track=True):
            y = module(v)
        whole_out = name.startswith("patchgan")
        if name == "replicate_pad":
            # the rank's band and 2 rows each side: the scalar takes the rows
            # this rank owns of the padded frame (its band, and the pad at the
            # frame's edge), each once over the ranks
            h = v.shape[2]
            r = 0 if spatial is None else spatial.rank
            cot = _seeded_like((2, 8, h * size + 4, y.shape[3]), 100 + i)
            own = cot[:, :, r * h:r * h + h + 4].clone()
            if r > 0:
                own[:, :, :2] = 0
            if r < size - 1:
                own[:, :, -2:] = 0
            scalar = (y * own).sum()
        elif whole_out:
            cot = _seeded_like(tuple(y.shape), 100 + i)
            scalar = (y * cot).sum() / size
        else:
            shape = (y.shape[0], y.shape[1], y.shape[2] * size, y.shape[3])
            scalar = (y * _band(_seeded_like(shape, 100 + i), spatial)).sum()
        scalar.backward()
        out[name] = {"out": y.detach().numpy(), "dx": v.grad.numpy(), "grads": _grads_of(module),
                     "stats": {k: b.numpy().copy() for k, b in module.state_dict().items()
                               if "running" in k}}
    for i, (name, (fn, kind)) in enumerate(_ops().items()):
        v = _band(x_whole, spatial).clone().requires_grad_(True)
        y = fn(v, spatial, group)
        if kind == "loss":
            scalar = y / size
        else:
            shape = (*y.shape[:-2], y.shape[-2] * size, y.shape[-1])
            scalar = (y * _band(_seeded_like(shape, 200 + i), spatial, y.dim() - 2)).sum()
        if y.requires_grad:
            scalar.backward()
        out[name] = {"out": y.detach().numpy(),
                     "dx": None if v.grad is None else v.grad.numpy(), "grads": {}, "stats": {}}
    return out, dict(S.COUNTS)


def spatial_layer_grads(mesh):
    """``layer_grads`` on this rank's band (the launch's ranks form one
    spatial group, which is also the losses' group)."""
    torch.set_num_threads(2)
    return layer_grads(S.from_mesh(mesh), mesh.group, mesh.size)


# ----------------------------------------------------------------- train steps

class InjectHoles:
    """``random_rect_holes`` stand-in: call k of a forward (real, then syn)
    punches cover k % 2, the rank's rows of B and of H of it, where the base
    mask is valid."""

    def __init__(self, covers):
        self.covers, self.calls = covers, 0

    def __call__(self, base, rows=None, h_rows=None, **kw):
        cover = self.covers[self.calls % 2]
        self.calls += 1
        lo, hi, _ = rows if rows is not None else (0, len(base), len(base))
        y0, y1, _ = h_rows if h_rows is not None else (0, base.shape[1], base.shape[1])
        c = torch.from_numpy(np.ascontiguousarray(cover[lo:hi, y0:y1])).to(base.device)
        return torch.where((base > 0.05) & c, 0.0, 1.0).to(base.dtype)


def _host(metrics):
    return {k: float(v) for k, v in metrics.items()}


def _grads(model, names):
    return {n: {k: p.grad.numpy().copy() for k, p in model.nets[n].named_parameters()
                if p.grad is not None} for n in names}


def _state(model, names):
    return {n: {k: v.numpy().copy() for k, v in model.nets[n].state_dict().items()}
            for n in names}


def _opt(argv):
    return train_options.parse(list(argv) + ["--device", "cpu"], print_options=False)


def _counts():
    return dict(S.COUNTS, **M.COUNTS, K1_backwards_halo=K.conv3x3_fused.backwards_halo)


def _reset():
    S.reset_counts()
    for k in M.COUNTS:
        M.COUNTS[k] = 0
    K.conv3x3_fused.backwards_halo = 0


class Jitter:
    """K1's outputs, the InstanceNorms' moments and the BatchNorms' outputs
    times (1 + 1e-6 N(0, 1)), from a seeded generator: the scale of the
    float32 rounding that summing a band's moments in another order leaves
    (chip_smoke.py's phase (q) yardstick, which jitters K1 alone)."""

    def __init__(self, seed=12):
        self.run, self.moments = K._fused_forward, IN.instance_norm_moments
        self.batch_norm = TL.BatchNorm2d.forward
        self.gen = torch.Generator().manual_seed(seed)

    def _noise(self, t):
        return t * (1 + 1e-6 * torch.randn(t.shape, generator=self.gen))

    def conv(self, *args):
        res = self.run(*args)
        if isinstance(res, tuple):
            return (self._noise(res[0]), *res[1:])
        return self._noise(res)

    def norm_moments(self, x):
        return tuple(self._noise(t) for t in self.moments(x))

    def patches(self):
        j = self
        return (mock.patch.object(K, "_fused_forward", self.conv),
                mock.patch.object(IN, "instance_norm_moments", self.norm_moments),
                mock.patch.object(TL.BatchNorm2d, "forward",
                                  lambda bn, x: j._noise(j.batch_norm(bn, x))))


def _maybe_jitter(jitter):
    """``Jitter(jitter)``'s patches (``jitter`` a seed), or none for None."""
    import contextlib

    if jitter is None:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    for patch in Jitter(jitter).patches():
        stack.enter_context(patch)
    return stack


def _float64():
    """The port's float32 step run at float64, for a comparison whose
    rounding is float64's: new tensors float64 by default, and the casts
    that pin float32 (``Tensor.float``, float32 arrays through
    ``torch.from_numpy``) giving float64, the cached interpolation
    matrices made anew on entry and on exit. The caller builds its model at
    compute dtype float64 and casts its weights. K3's sums and the logged
    metrics (``mean_over_ranks``' vector) stay float32."""
    import contextlib

    from desr_tpu_torch.ops import resize as RS

    def clear_caches():
        for fn in (L._align_corners_tensor, RS._resize_matrix_on):
            fn.cache_clear()

    clear_caches()
    stack = contextlib.ExitStack()
    stack.callback(clear_caches)
    from_numpy = torch.from_numpy
    stack.enter_context(mock.patch.object(torch.Tensor, "float",
                                          lambda t, *a, **k: t.to(torch.float64)))
    stack.enter_context(mock.patch.object(
        torch, "from_numpy",
        lambda a: from_numpy(a).double() if a.dtype == np.float32 else from_numpy(a)))
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    stack.callback(torch.set_default_dtype, default)
    return stack


def _precision(dtype):
    import contextlib

    return _float64() if dtype == torch.float64 else contextlib.nullcontext()


def main_step(mesh, argv, batch, covers=None, params0=None, sr=False, jitter=None,
              dtype=torch.float32):
    """One MainModel (``sr``: MainSRModel) train step (forward, backward,
    gradient average, Adam) on ``batch``, the translator cut to one block,
    from ``params0`` (JAX param dicts) or the seeded init; holes drawn from
    the model's generator, or ``covers`` injected; ``jitter``: a seed of
    ``Jitter``'s noise, or None; ``dtype`` float32, or float64
    (``_float64``). Returns the metrics, the
    trainable nets' gradients, every net's running statistics and
    weights, whether the step was split and the collectives it issued."""
    from desr_tpu_torch.models.main_model import MainModel
    from desr_tpu_torch.models.main_sr_model import MainSRModel

    torch.set_num_threads(2)
    inject = InjectHoles(covers) if covers is not None else TDPT.random_rect_holes
    with mock.patch.object(TT, "default_translator_opt", SR.small_translator), \
            mock.patch.object(TDPT, "random_rect_holes", inject), _maybe_jitter(jitter), \
            _precision(dtype):
        model = (MainSRModel if sr else MainModel)(
            _opt(argv), device="cpu", compute_dtype=dtype, is_train=True, mesh=mesh).to(dtype)
        for n, p in (params0 or {}).items():
            model.nets[n].load_state_dict(from_jax_params(p), strict=True)
        model.set_input(batch)
        _reset()
        model.optimize_parameters(1)
        counts = _counts()
    return dict(metrics=_host(model.metrics), grads=_grads(model, model.trainable_nets),
                state=_state(model, model.trainable_nets),
                split=model.step_group is not None, h_split=bool(model._batch.h_split),
                counts=counts)


def i2d_steps(mesh, argv, batch, steps, jitter=None, dtype=torch.float32):
    """``steps`` I2DModel --use_D steps on ``batch`` from the seeded init
    (``jitter`` as ``main_step``'s): the last metrics, the G and D
    gradients of the first step (later ones start from weights that Adam's
    sign flips at the noise floor already moved), the replay pool and the
    trained nets' states."""
    from desr_tpu_torch.models.i2d_model import I2DModel

    torch.set_num_threads(2)
    with _precision(dtype):
        model = I2DModel(_opt(argv), device="cpu", compute_dtype=dtype, is_train=True,
                         mesh=mesh).to(dtype)
        model.setup()
    names = tuple(model.optimized_nets)
    with _maybe_jitter(jitter), _precision(dtype):
        for it in range(1, steps + 1):
            model.set_input(batch)
            _reset()
            model.optimize_parameters(it * len(batch["A_i"]))
            if it == 1:
                grads = _grads(model, names)
    pool = model.fake_depth_pool
    return dict(metrics=_host(model.metrics), grads=grads, split=model.step_group is not None,
                h_split=bool(model._batch.h_split),
                pool=torch.stack(pool.images).numpy(), pool_rng=pool.rng.getstate(),
                state=_state(model, names), counts=_counts())


def steps(mesh, main_args, sr_args, i2d_args, jitter=None, dtype=torch.float32):
    """The main, SR and I2D --use_D steps on this rank, in one launch."""
    return {"main": main_step(mesh, *main_args, jitter=jitter, dtype=dtype),
            "sr": main_step(mesh, *sr_args, sr=True, jitter=jitter, dtype=dtype),
            "i2d": i2d_steps(mesh, *i2d_args, jitter=jitter, dtype=dtype)}


def float64_steps(mesh, main_args, sr_args, i2d_args):
    """``steps`` at float64 (``_float64``)."""
    return steps(mesh, main_args, sr_args, i2d_args, dtype=torch.float64)


def spatial_steps(mesh, main_args, sr_args, i2d_args):
    """``layer_grads`` and ``steps`` on this rank: one launch for both."""
    return {"layers": spatial_layer_grads(mesh), "steps": steps(mesh, main_args, sr_args,
                                                                 i2d_args)}


def norm_batch_steps(mesh, main_args, i2d_args, jitter=None):
    """The ``--norm batch`` main step and I2D --use_D steps on this rank."""
    return {"main": main_step(mesh, *main_args, jitter=jitter),
            "i2d": i2d_steps(mesh, *i2d_args, jitter=jitter)}
