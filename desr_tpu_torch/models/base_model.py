"""The trainer-facing contract of the stage models (counterpart of
``desr_tpu/models/base_model.py``): ``setup``, ``save_networks`` /
``load_networks``, ``update_learning_rate``, ``get_current_losses`` and the
trainable/frozen split.

A model holds its nets in ``self.nets`` (an ``nn.ModuleDict`` keyed by the
reference's net names), float32 parameters on ``self.device``. Only the nets
in ``trainable_nets`` have ``requires_grad``; the frozen ones run under
``torch.no_grad()`` in the forward. A step leaves its metrics as tensors in
``self.metrics``; they are read to the host only when asked for.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn as nn

from desr_tpu_torch import checkpoints as ckpt
from desr_tpu_torch import resolve_device
from desr_tpu_torch.ops import optim


class BaseModel(nn.Module):
    model_names: tuple = ()
    trainable_nets: tuple = ()
    _dump_rows = 16  # the rows --save_all crops off each side

    def __init__(self, opt, device=None, compute_dtype=torch.bfloat16):
        super().__init__()
        self.opt = opt
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.loss_names = []
        self.metrics = {}
        self.optimizer = None
        self.optimizers = []
        self.lr = getattr(opt, "lr", 2e-4)

    def split_trainable(self, betas=(0.9, 0.999), weight_decay=0.0):
        """Freeze every net, then give ``requires_grad`` back to the trainable
        ones and build the generator's Adam over them, torch's default betas
        and no decay unless told otherwise (main_model.py:386-388,
        i2d_model.py:178-179, translation_model.py:372-374)."""
        self.requires_grad_(False)
        self.optimizers = []
        self.optimizer = self.add_optimizer(self.trainable_nets, betas, weight_decay)

    def add_optimizer(self, net_names, betas, weight_decay=0.0):
        """An Adam over the nets ``net_names`` (a discriminator's, beside the
        generator's), at the model's LR; ``update_learning_rate`` steps it too.
        Gives the nets ``requires_grad``."""
        params = []
        for name in net_names:
            self.nets[name].requires_grad_(True)
            params += list(self.nets[name].parameters())
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
        self.print_networks(getattr(opt, "verbose", False))

    def save_networks(self, epoch):
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

    def update_learning_rate(self, epoch):
        """The LR after ``epoch`` (base_model.py:268-285), set into Adam."""
        opt = self.opt
        self.lr = optim.lr_schedule(opt.lr_policy, epoch, opt.lr, opt.n_epochs,
                                    opt.n_epochs_decay, epoch_count=opt.epoch_count,
                                    lr_decay_iters=opt.lr_decay_iters)
        for optimizer in self.optimizers:
            optim.set_lr(optimizer, self.lr)
        return self.lr

    def _dump_predictions(self, pred):
        """uint16 PNG dump of ``pred`` (B, H, W), x5100, rows [r:-r] with
        r = ``_dump_rows`` (main and I2D: 16, main_model.py:453-462,
        i2d_model.py:268-278; SR: 32 of the HR prediction), one file per
        B path's stem under ``--save_image_folder``."""
        from desr_tpu_torch.utils.util import save_uint16_png

        os.makedirs(self.opt.save_image_folder, exist_ok=True)
        pred = pred.float().cpu().numpy()
        r = self._dump_rows
        for i, path in enumerate(self._paths.get("B_paths") or []):
            stem = str(path).split("/")[-1].split(".")[0]
            out = np.clip((pred[i, r:-r, :] + 1) / 2, 0, 1)
            save_uint16_png(out, os.path.join(self.opt.save_image_folder, f"{stem}.png"))

    def get_current_losses(self):
        return {k: float(v) for k, v in self.metrics.items() if k in self.loss_names}
