"""The trainer-facing contract of the stage models (counterpart of
``desr_tpu/models/base_model.py``): ``setup``, ``save_networks`` /
``load_networks``, ``update_learning_rate`` (the plateau rule too),
``get_current_losses`` / ``get_current_visuals``,
``optimize_parameters_multi`` and the trainable/frozen split.

A model holds its nets in ``self.nets`` (an ``nn.ModuleDict`` keyed by the
reference's net names), float32 parameters on ``self.device``. Only the nets
in ``trainable_nets`` have ``requires_grad``; the frozen ones run under
``torch.no_grad()`` in the forward. A step leaves its metrics as tensors in
``self.metrics``, and ``calculate`` its visuals in ``self.visuals``; they are
read to the host only when asked for.

The remat flags (``remat_modes``): ``--remat`` checkpoints each trained
net's whole call (``run_net``, the JAX ``_maybe_remat``,
main_model.py:47-56), ``--remat_blocks`` and ``--remat_tails`` the runs of
layers inside every net (``layers.set_remat``). A frozen net runs under
no_grad and keeps no activations, so a checkpoint there would change
nothing: ``remat_call`` makes it the plain call. On a spatial mesh a
checkpoint's recompute re-enters the spatial state of its forward
(``parallel/spatial.py:replay``) and issues its collectives again.

A model owns its data mesh (``self.mesh``, ``desr_tpu_torch/parallel``; one
device unless the caller passes the mesh of its rank). ``set_input`` and
``optimize_parameters_multi`` take global batches and stage this rank's
rows of each (``shard``); while the staged batch is split over the ranks,
``step_group`` is their process group, over which BatchNorm takes its
moments and the losses their denominators, and the metrics are averaged
(``global_metrics``). ``reduce_grads`` averages the trained nets'
gradients between each backward and its Adam step. Checkpoints are written
by rank 0 and read by every rank. On a mesh with a spatial axis
(``--spatial_devices``) ``serve_forward`` takes this rank's band of each
frame's rows and returns its rows of the prediction (``serving_layout``),
and a train step runs on the rank's band (``step_layout``): where the
staged batch's frames are split along H, ``step_group`` is every rank of
the mesh (data x spatial); where they stay whole, the ranks that split B.
The visuals and dumped predictions are gathered along H
(``whole_frames``).
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
import torch.nn as nn

from desr_tpu_torch import checkpoints as ckpt
from desr_tpu_torch import resolve_device, tracing
from desr_tpu_torch.models.layers import (
    Dropout,
    remat_call,
    set_batch_norm_group,
    set_dropout_key,
    set_remat,
    with_batch_norm_mode,
)
from desr_tpu_torch.ops import optim
from desr_tpu_torch.parallel import mesh as M
from desr_tpu_torch.parallel import spatial as S


def remat_modes(opt):
    """(``--remat``, the inner mode): "blocks" under ``--remat_blocks`` (it
    takes precedence, as in the JAX package), "tails" under
    ``--remat_tails``, else None. The JAX per-stage default of
    ``--remat_tails`` (None: on for SR, I2D and translation,
    base_model.py:82-95) came from TPU A/B runs; the port reads None as off.
    """
    inner = ("blocks" if getattr(opt, "remat_blocks", False)
             else "tails" if getattr(opt, "remat_tails", None) else None)
    return bool(getattr(opt, "remat", False)), inner


class BaseModel(nn.Module):
    model_names: tuple = ()
    trainable_nets: tuple = ()
    visual_names: tuple = ()
    _dump_rows = 16  # the rows --save_all crops off each side
    _multi_step = True  # optimize_parameters_multi may group steps

    def __init__(self, opt, device=None, compute_dtype=torch.bfloat16, mesh=None):
        super().__init__()
        self.opt = opt
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else M.make_mesh([self.device])
        self.spatial = S.from_mesh(self.mesh)  # this rank's Spatial, or None
        self._nets_tagged = False
        self.step_group = None
        self._bn_groups = (None, None)
        self.compute_dtype = compute_dtype
        self.loss_names = []
        self.metrics = {}
        self.visuals = {}
        self.optimizer = None
        self.optimizers = []
        self.optimized_nets = []  # the nets an optimizer trains, in order
        self.lr = getattr(opt, "lr", 2e-4)
        self.plateau_history = []
        self.remat_nets, self.remat_inner = remat_modes(opt)
        self.batches_used = 0  # the step of the Dropouts' masks
        self._has_dropout = None

    def apply_remat(self):
        """Set the inner remat mode on every net (after they are built)."""
        for net in self.nets.values():
            set_remat(net, self.remat_inner)

    def run_net(self, name, *args, train=True):
        """``self.nets[name](*args)``; under ``--remat`` with a gradient
        recorded, one checkpoint over the whole call (its recompute
        normalises as ``train`` says, see ``layers.with_batch_norm_mode``)."""
        net = self.nets[name]
        with tracing.span("net." + name):
            if not self.remat_nets:
                return net(*args)
            return remat_call(with_batch_norm_mode(net, train), "net", *args)

    def split_trainable(self, betas=(0.9, 0.999), weight_decay=0.0):
        """Freeze every net, then give ``requires_grad`` back to the trainable
        ones and build the generator's Adam over them, torch's default betas
        and no decay unless told otherwise (main_model.py:386-388,
        i2d_model.py:178-179, translation_model.py:372-374)."""
        self.requires_grad_(False)
        self.optimizers = []
        self.optimized_nets = []
        self.optimizer = self.add_optimizer(self.trainable_nets, betas, weight_decay)

    def add_optimizer(self, net_names, betas, weight_decay=0.0):
        """An Adam over the nets ``net_names`` (a discriminator's, beside the
        generator's), at the model's LR; ``update_learning_rate`` steps it too.
        Gives the nets ``requires_grad``."""
        params = []
        for name in net_names:
            self.nets[name].requires_grad_(True)
            params += list(self.nets[name].parameters())
            self.optimized_nets.append(name)
        optimizer = optim.adam(params, self.lr, betas=betas, weight_decay=weight_decay)
        self.optimizers.append(optimizer)
        return optimizer

    # --direction BtoA swaps the syn and real domains: the image and depth
    # tensors only; intrinsics, crop boxes and paths keep their keys
    # (base_model.py:161-176)
    _DIRECTION_SWAP = {"A_i": "B_i", "B_i": "A_i", "A_d": "B_d", "B_d": "A_d"}

    def apply_direction(self, batch):
        if getattr(self.opt, "direction", "AtoB") == "AtoB":
            return batch
        out = dict(batch)
        for dst, src in self._DIRECTION_SWAP.items():
            if src in batch:
                out[dst] = batch[src]
        return out

    def pretrained_nets(self):
        """The nets a new run loads from earlier stages' ``.pth`` files:
        here every net it does not train."""
        return [n for n in self.model_names if n not in self.trainable_nets]

    # -- lifecycle ---------------------------------------------------------

    def setup(self, opt=None):
        """Load the checkpoints a run starts from (base_model.py:106-116).

        The weights were drawn from ``--seed`` when the nets were built. The
        frozen nets come from the earlier stages' ``.pth`` files under
        ``--checkpoints_dir/--name``; with ``--continue_train`` (or outside
        training) the trainable nets load too.
        """
        opt = opt or self.opt
        load_iter = getattr(opt, "load_iter", 0)
        suffix = f"iter_{load_iter}" if load_iter > 0 else getattr(opt, "epoch", "latest")
        if getattr(opt, "continue_train", False) or not getattr(opt, "isTrain", True):
            names = self.model_names
        else:
            names = self.pretrained_nets()
        self.load_networks(opt.checkpoints_dir, opt.name, suffix, names)
        M.replicate(self.nets, self.mesh)
        self.print_networks(getattr(opt, "verbose", False))

    def save_networks(self, epoch):
        """``<epoch>_net_<Net>.pth`` of every net, written by rank 0 alone."""
        if self.mesh.rank != 0:
            return
        for name in self.model_names:
            ckpt.save_net(self.nets[name],
                          ckpt.net_ckpt_path(self.opt.checkpoints_dir, self.opt.name, epoch, name))

    def load_networks(self, checkpoints_dir, name, epoch="latest", names=None, verbose=True):
        """Tolerant load of ``<checkpoints_dir>/<name>/<epoch>_net_<Net>.pth``
        for each net in ``names`` (all of ``model_names`` when None)."""
        for net_name in names if names is not None else self.model_names:
            ckpt.load_net(self.nets[net_name],
                          ckpt.net_ckpt_path(checkpoints_dir, name, epoch, net_name),
                          verbose=verbose)

    def print_networks(self, verbose=False):
        print("---------- Networks initialized -------------")
        for name in self.model_names:
            net = self.nets[name]
            if verbose:
                for k, v in net.state_dict().items():
                    print(f"  {k}: {tuple(v.shape)}")
            n = sum(p.numel() for p in net.parameters())
            print(f"[Network {name}] Total number of parameters : {n / 1e6:.3f} M")
        print("-----------------------------------------------")

    # -- schedule and metrics ----------------------------------------------

    def update_learning_rate(self, epoch, metric=None):
        """The LR after ``epoch`` (base_model.py:268-285), set into every Adam.

        ``--lr_policy plateau`` reads ``metric`` instead (the trainer feeds
        the epoch's mean test loss, or its last train loss): appended to the
        history, and when the history is longer than 6 and the minimum of
        its last 6 is above 0.99 times the minimum before them, the LR is
        multiplied by 0.2 and the history restarts. No metric, no change.
        """
        opt = self.opt
        if opt.lr_policy == "plateau":
            if metric is not None:
                h = self.plateau_history
                h.append(metric)
                if len(h) > 6 and min(h[-6:]) > min(h[:-6]) * 0.99:
                    self.lr *= 0.2
                    self.plateau_history = []
        else:
            self.lr = optim.lr_schedule(opt.lr_policy, epoch, opt.lr, opt.n_epochs,
                                        opt.n_epochs_decay, epoch_count=opt.epoch_count,
                                        lr_decay_iters=opt.lr_decay_iters)
        for optimizer in self.optimizers:
            optim.set_lr(optimizer, self.lr)
        return self.lr

    # -- steps -------------------------------------------------------------

    def supports_multi_step(self):
        """Whether the trainer may hand ``--steps_per_call`` batches to
        ``optimize_parameters_multi`` (main, SR and I2D without --use_D, as
        the JAX package builds its scan, base_model.py:178-197)."""
        return self._multi_step

    def shard(self, batch):
        """This rank's rows of a global host batch (``parallel.shard_batch``:
        a ``Shard`` holding its ``rows``; a rank loader's batch as it is)."""
        return M.shard_batch(batch, self.mesh)

    def stage(self, batch):
        """(a ``Shard`` of device tensors, paths): what ``set_input`` stages
        for this rank's rows of ``batch``."""
        raise NotImplementedError

    def set_input(self, batch):
        """Stage this rank's rows of a host batch on the device (``stage``)."""
        with tracing.span("step.stage"):
            self.use_batch(*self.stage(batch))

    def use_batch(self, batch, paths):
        """Make a staged batch the current one. ``step_group`` is the process
        group of the ranks that hold distinct parts of it: the mesh's where
        its frames are split along H, else the ranks that split it along B
        (``Mesh.batch_group``: on a spatial mesh the S ranks of a data group
        hold the same whole frames and count once), else None (a single
        rank, or every rank holding the whole batch, JAX's replicated case).
        Every BatchNorm takes its moments over ``step_group`` on a band and
        over the B-splitting ranks on a tensor that the spatial ranks hold
        whole. On a spatial mesh the nets are tagged with this rank's
        ``Spatial``. Each ``Dropout`` of the nets draws its masks from
        ``--seed``, the count of batches used so far and the batch's rows
        (``layers.set_dropout_key``; no shipped net has one)."""
        self._batch, self._paths = batch, paths
        self.batches_used += 1
        if self._has_dropout is None:
            self._has_dropout = any(isinstance(m, Dropout) for m in self.nets.modules())
        if self._has_dropout:
            set_dropout_key(self.nets, getattr(self.opt, "seed", 0), self.batches_used,
                            getattr(batch, "rows", None))
        if self.spatial is not None and not self._nets_tagged:
            S.set_spatial_group(self.nets, self.spatial)
            self._nets_tagged = True
        whole = self.mesh.batch_group if batch.split else None
        group = self.mesh.group if batch.h_split else whole
        if (group, whole) != self._bn_groups:
            set_batch_norm_group(self.nets, group, whole)
            self._bn_groups = (group, whole)
        self.step_group = group

    def step_layout(self, batch):
        """The context a train step or an eval forward of a staged ``Shard``
        runs in: ``spatial.whole()`` where the mesh has a spatial axis and
        the batch's frames are whole (``Shard.h_split`` false: H not
        divisible by S or under 32 rows, or a batch the data axis does not
        divide), as on one process; else a null context (the tagged nets
        and the model's ops then work on the rank's band)."""
        if self.spatial is None or batch.h_split:
            return contextlib.nullcontext()
        return S.whole()

    def whole_frames(self, tensors):
        """``tensors`` (a dict of (B, H, ...) maps and NHWC images) with each
        frame whole along H on every rank of the spatial group, where the
        staged batch splits H (one gather each, in the dict's order); else
        as they are."""
        if self.spatial is None or not self._batch.h_split:
            return tensors
        return {k: S.gather_h(v, self.spatial, 1) for k, v in tensors.items()}

    def serving_layout(self, batch, module):
        """The context ``module`` (nets of this model) serves a ``Shard`` in.
        On a spatial mesh the module's layers are tagged with this rank's
        spatial group, and a batch whose frames the mesh leaves whole
        (``Shard.h_split`` false: H not divisible by S or under 32 rows, or
        a batch the data axis does not divide) runs under
        ``spatial.whole()``, as on one process. Elsewhere a null context."""
        sp = S.from_mesh(self.mesh)
        if sp is None:
            return contextlib.nullcontext()
        S.set_spatial_group(module, sp)
        return contextlib.nullcontext() if batch.h_split else S.whole()

    def reduce_grads(self, net_names):
        """Average the gradients of the nets ``net_names`` over the ranks
        (``parallel.reduce_grads``; nothing on one rank)."""
        M.reduce_grads([p for n in net_names for p in self.nets[n].parameters()], self.mesh)

    def global_metrics(self, metrics):
        """The metrics of the step as global values (``parallel.mean_over_ranks``
        over ``step_group``)."""
        return M.mean_over_ranks(metrics, self.step_group, self.device)

    def optimize_parameters_multi(self, batches, iters):
        """``len(batches)`` train steps back to back: every batch is uploaded
        first, then the steps are queued with nothing read from the device
        between them (a blocking upload in between would wait for the last
        step). The same trajectory as ``set_input`` + ``optimize_parameters``
        per batch; the metrics kept are the last step's, as the JAX scan's.
        ``iters`` is the iteration count after the group. The last batch
        stays staged."""
        with tracing.span("step.stage"):
            staged = [self.stage(b) for b in batches]
        for batch, paths in staged:
            self.use_batch(batch, paths)
            self.optimize_parameters(iters)

    def _dump_predictions(self, pred):
        """uint16 PNG dump of ``pred`` (B, H, W), x5100, rows [r:-r] with
        r = ``_dump_rows`` (main and I2D: 16, main_model.py:453-462,
        i2d_model.py:268-278; SR: 32 of the HR prediction), one file per
        B path's stem under ``--save_image_folder``. Under a split H the
        frames are gathered first. Each data group's first spatial rank
        writes its rows of a split batch; rank 0 alone a batch every rank
        holds whole."""
        from desr_tpu_torch.utils.util import save_uint16_png

        pred = self.whole_frames({"pred": pred})["pred"]
        if self.mesh.spatial_rank or (self.mesh.rank and not self._batch.split):
            return

        os.makedirs(self.opt.save_image_folder, exist_ok=True)
        pred = pred.float().cpu().numpy()
        r = self._dump_rows
        for i, path in enumerate(self._paths.get("B_paths") or []):
            stem = str(path).split("/")[-1].split(".")[0]
            out = np.clip((pred[i, r:-r, :] + 1) / 2, 0, 1)
            save_uint16_png(out, os.path.join(self.opt.save_image_folder, f"{stem}.png"))

    def get_current_losses(self):
        return {k: float(v) for k, v in self.metrics.items() if k in self.loss_names}

    def get_current_visuals(self):
        """The last ``calculate``'s visuals as float32 numpy arrays in the
        port's layouts (planar depth maps, NHWC or NCHW images)."""
        from desr_tpu_torch.utils.util import to_numpy

        return {k: to_numpy(v) for k, v in self.visuals.items()}
