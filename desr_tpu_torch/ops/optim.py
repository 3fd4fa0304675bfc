"""Adam and the per-epoch learning-rate schedule (counterpart of
``desr_tpu/ops/optim.py``).

The JAX package writes Adam out (``adam_update``, optim.py:36-68) to copy
``torch.optim.Adam``: weight decay into the raw gradient, bias-corrected
moments, ``p -= lr * m_hat / (sqrt(v_hat) + eps)``. The port therefore uses
``torch.optim.Adam`` itself; the learning rate lives in its param groups and
changes per epoch through ``set_lr``.
"""

from __future__ import annotations

import math

import torch


def adam(params, lr, betas, weight_decay=0.0):
    """torch.optim.Adam over ``params``, eps 1e-8. The main stage passes betas
    (0.9, 0.999), torch's defaults (main_model.py:386-388); stage 2's G passes
    (--beta1, 0.999) and ``weight_decay`` --w_decay_G, which torch adds to the
    raw gradient as ``adam_update`` does (optim.py:51-52)."""
    return torch.optim.Adam(params, lr=lr, betas=betas, weight_decay=weight_decay)


def set_lr(optimizer, lr):
    for group in optimizer.param_groups:
        group["lr"] = lr


def lr_schedule(policy, epoch, base_lr, n_epochs, n_epochs_decay, epoch_count=1,
                lr_decay_iters=50):
    """Per-epoch LR (optim.py:71-88, networks.py get_scheduler of the reference).

    linear: flat for n_epochs, then linear decay to 0 over n_epochs_decay + 1;
    step: x0.1 every lr_decay_iters epochs; cosine: CosineAnnealingLR with
    T_max = n_epochs. plateau needs a metric feed, so it is not a function
    of the epoch: ``models/base_model.py:BaseModel.update_learning_rate``
    applies it.
    """
    if policy == "linear":
        return base_lr * (1.0 - max(0, epoch + epoch_count - n_epochs) / float(n_epochs_decay + 1))
    if policy == "step":
        return base_lr * (0.1 ** (epoch // lr_decay_iters))
    if policy == "cosine":
        return base_lr * (1 + math.cos(math.pi * epoch / n_epochs)) / 2
    raise NotImplementedError(f"lr policy {policy!r}: not a policy of the epoch "
                              "(linear, step or cosine)")
