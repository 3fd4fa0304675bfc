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


def adam(params, lr, betas):
    """torch.optim.Adam over ``params``, eps 1e-8, no weight decay; the main
    stage passes betas (0.9, 0.999), torch's defaults (main_model.py:386-388)."""
    return torch.optim.Adam(params, lr=lr, betas=betas)


def set_lr(optimizer, lr):
    for group in optimizer.param_groups:
        group["lr"] = lr


def lr_schedule(policy, epoch, base_lr, n_epochs, n_epochs_decay, epoch_count=1,
                lr_decay_iters=50):
    """Per-epoch LR (optim.py:71-88, networks.py get_scheduler of the reference).

    linear: flat for n_epochs, then linear decay to 0 over n_epochs_decay + 1;
    step: x0.1 every lr_decay_iters epochs; cosine: CosineAnnealingLR with
    T_max = n_epochs. (plateau needs a metric feed and is not ported.)
    """
    if policy == "linear":
        return base_lr * (1.0 - max(0, epoch + epoch_count - n_epochs) / float(n_epochs_decay + 1))
    if policy == "step":
        return base_lr * (0.1 ** (epoch // lr_decay_iters))
    if policy == "cosine":
        return base_lr * (1 + math.cos(math.pi * epoch / n_epochs)) / 2
    raise NotImplementedError(f"lr policy {policy!r}: not yet ported")
