"""The rank side of the port's data-parallel tests (tests/test_torch_parallel*.py):
functions that ``desr_tpu_torch.parallel.launch`` runs in each spawned rank,
and that the tests also call in one process on the whole batch. This module
imports torch and the port alone, so that a spawned rank starts quickly; it
holds no tests.

Every function returns host values (floats, numpy arrays).
"""

from unittest import mock

import torch

import desr_tpu_torch.ops.depth as TDPT
from desr_tpu_torch.models import translation_networks as TT
from desr_tpu_torch.options import train_options
from desr_tpu_torch.parallel import mesh as M
from desr_tpu_torch.weights import from_jax_params

_DEFAULT_TRANSLATOR = TT.default_translator_opt


def small_translator(n_blocks):
    """The hardcoded translator cut to 8+8 channels and ``n_blocks`` blocks."""
    return lambda **kw: _DEFAULT_TRANSLATOR(ngf_img=8, ngf_depth=8, n_blocks=n_blocks, **kw)


class InjectHoles:
    """``random_rect_holes`` stand-in: call k of a forward (real, then syn)
    punches cover k % 2, the rank's rows of it, where the base mask is valid."""

    def __init__(self, covers):
        self.covers, self.calls = covers, 0

    def __call__(self, base, rows=None, **kw):
        cover = self.covers[self.calls % 2]
        self.calls += 1
        lo, hi, _ = rows if rows is not None else (0, len(base), len(base))
        c = torch.from_numpy(cover[lo:hi]).to(base.device)
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


def main_step(mesh, argv, params0, batch, covers=None):
    """One MainModel train step (forward, backward, gradient average, Adam)
    on ``batch``, from ``params0`` (JAX param dicts), the translator cut to
    one block; holes drawn from the model's generator, or ``covers``
    injected. Returns the metrics and the trainable nets' gradients."""
    from desr_tpu_torch.models.main_model import MainModel

    torch.set_num_threads(2)
    inject = InjectHoles(covers) if covers is not None else TDPT.random_rect_holes
    with mock.patch.object(TT, "default_translator_opt", small_translator(1)), \
            mock.patch.object(TDPT, "random_rect_holes", inject):
        model = MainModel(_opt(argv), device="cpu", compute_dtype=torch.float32,
                          is_train=True, mesh=mesh)
        for n, p in params0.items():
            model.nets[n].load_state_dict(from_jax_params(p), strict=True)
        model.set_input(batch)
        model.optimize_parameters(1)
    return dict(metrics=_host(model.metrics), grads=_grads(model, model.trainable_nets),
                split=model.step_group is not None)


def translation_iteration(mesh, argv, overrides, params0, batch):
    """One TranslationModel iteration (the G steps, then the D step) from
    ``params0``, the translators cut to 8+8 channels and 2 blocks. Returns
    the metrics and every net's state."""
    from desr_tpu_torch.models.translation_model import TranslationModel

    torch.set_num_threads(2)
    opt = _opt(argv)
    opt.__dict__.update(overrides)
    with mock.patch.object(TT, "default_translator_opt", small_translator(2)):
        model = TranslationModel(opt, device="cpu", compute_dtype=torch.float32,
                                 is_train=True, mesh=mesh)
    for n, p in params0.items():
        model.nets[n].load_state_dict(from_jax_params(p), strict=True)
    model.set_input(batch)
    model.optimize_parameters(len(batch["A_depth"]))
    return dict(metrics=_host(model.metrics), state=_state(model, model.model_names))


def i2d_steps(mesh, argv, batch, steps):
    """``steps`` I2DModel --use_D steps on ``batch`` from the seeded init.
    Returns the last metrics, the replay pool (its images and its
    generator's state) and the trained nets' states."""
    from desr_tpu_torch.models.i2d_model import I2DModel

    torch.set_num_threads(2)
    model = I2DModel(_opt(argv), device="cpu", compute_dtype=torch.float32, is_train=True,
                     mesh=mesh)
    model.setup()
    for it in range(1, steps + 1):
        model.set_input(batch)
        model.optimize_parameters(it * len(batch["A_i"]))
    pool = model.fake_depth_pool
    return dict(metrics=_host(model.metrics), pool=torch.stack(pool.images).numpy(),
                pool_rng=pool.rng.getstate(), state=_state(model, ("Task", "D_depth")))


def primitives(mesh, x, y, mask, img, bn_in, bn_cot):
    """The global reductions on this rank's rows of global inputs: the
    masked L1, the masked cosine and the TV sum (the global value, the x
    gradient of this rank's loss, and the value of its rows alone), a
    BatchNorm's train-mode output, input and weight gradients and running
    statistics, the gathered rows, a gradient average and a metric's mean.
    Run in one process, ``mesh`` is one device and all is the whole batch's."""
    from desr_tpu_torch.models.layers import BatchNorm2d, set_batch_norm_group
    from desr_tpu_torch.ops import losses as L

    torch.set_num_threads(2)
    lo, hi = mesh.rows(len(x))
    group = mesh.group if mesh.size > 1 else None
    x, y, mask, img = (torch.from_numpy(a[lo:hi]) for a in (x, y, mask, img))
    mask3 = mask[:, None].expand(-1, 3, -1, -1)
    losses = {
        "masked_l1": lambda t, g: L.masked_l1_loss(t, y, mask, group=g),
        "masked_cos": lambda t, g: L.masked_cos_sim_loss_planar(t[:, None] * img, img, mask3,
                                                                group=g),
        "tv": lambda t, g: L.tv_loss_planar(t, g),
    }
    out = {}
    for name, fn in losses.items():
        t = x.clone().requires_grad_(True)
        loss = fn(t, group)
        loss.backward()
        out[name] = float(M.mean_over_ranks({"v": loss.detach()}, group, "cpu")["v"])
        out[name + "_dx"] = t.grad.numpy()
        out[name + "_rows_alone"] = float(fn(x, None))
    bn = BatchNorm2d(bn_in.shape[1])
    set_batch_norm_group(bn, group)
    xin = torch.from_numpy(bn_in[lo:hi]).requires_grad_(True)
    yout = bn(xin)
    (yout * torch.from_numpy(bn_cot[lo:hi])).sum().backward()
    out.update(bn_out=yout.detach().numpy(), bn_dx=xin.grad.numpy(),
               bn_weight_grad=bn.weight.grad.numpy(),
               bn_running_mean=bn.running_mean.numpy(), bn_running_var=bn.running_var.numpy())
    out["gathered"] = M.all_gather_rows(x, group).numpy()
    w = torch.nn.Parameter(torch.zeros(3))
    w.grad = torch.full((3,), float(mesh.rank + 1))
    M.reduce_grads([w], mesh)
    out["mean_grad"] = w.grad.numpy()
    return out


def replicated_nets(mesh, seed):
    """A net built from a seed of the rank's own, then ``replicate``d: the
    state the rank holds."""
    torch.manual_seed(seed + mesh.rank)
    net = torch.nn.Sequential(torch.nn.Conv2d(2, 3, 3), torch.nn.BatchNorm2d(3))
    torch.nn.init.normal_(net[1].running_mean)
    M.replicate(net, mesh)
    return {k: v.numpy().copy() for k, v in net.state_dict().items()}


def save_from_each_rank(mesh, root):
    """Each rank's model saves into ``root/rank<r>``: only rank 0 writes."""
    import os

    from desr_tpu_torch.models.i2d_model import I2DModel
    from desr_tpu_torch.models.main_model import NetOptions

    opt = NetOptions(Imagef_outf=8, Imagef_basef=8, Task_basef=8)
    opt.checkpoints_dir, opt.name = os.path.join(root, f"rank{mesh.rank}"), "x"
    model = I2DModel(opt, device="cpu", mesh=mesh)
    model.save_networks("latest")
    folder = os.path.join(opt.checkpoints_dir, "x")
    return sorted(os.listdir(folder)) if os.path.isdir(folder) else []
