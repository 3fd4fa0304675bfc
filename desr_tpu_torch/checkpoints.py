"""Tolerant ``.pth`` load and save with the reference's on-disk contract
(counterpart of ``desr_tpu/checkpoints.py:40-128``).

One file per net, ``<checkpoints_dir>/<name>/<epoch>_net_<NetName>.pth``, holding
a flat state_dict. Loading merges the entries whose key and shape match into
the net's current state, after unwrapping the legacy nested ``{'netG_B': ...}``
format and stripping a DataParallel ``module.`` prefix; a missing or
unreadable file keeps the current weights with a warning.

``save_train_state`` / ``load_train_state`` keep a whole train state to
resume from (the trained nets, the optimizers, the LR and its plateau
history, the hole generator); the training CLI never calls them, as
``main.py`` does not.
"""

from __future__ import annotations

import os
import warnings

import torch


def net_ckpt_path(checkpoints_dir: str, name: str, epoch, net_name: str) -> str:
    return os.path.join(checkpoints_dir, name, f"{epoch}_net_{net_name}.pth")


def save_net(net: torch.nn.Module, path: str):
    """Write a net's state_dict (on the CPU, keys sorted) as a .pth file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    state = {k: v.detach().cpu() for k, v in sorted(net.state_dict().items())}
    torch.save(state, path)


def merge_state(current: dict, state: dict) -> tuple:
    """(merged state_dict, number of entries taken from ``state``)."""
    if "netG_B" in state and not any(k in current for k in state):
        state = state["netG_B"]
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    out = dict(current)
    n_loaded = 0
    for k, v in state.items():
        k2 = k[len("module."):] if k.startswith("module.") else k
        if k2 not in out or not torch.is_tensor(v) or tuple(v.shape) != tuple(out[k2].shape):
            continue
        out[k2] = v.detach().to(device=out[k2].device, dtype=out[k2].dtype)
        n_loaded += 1
    return out, n_loaded


def load_net(net: torch.nn.Module, path: str, verbose: bool = True) -> int:
    """Tolerant partial load of ``path`` into ``net``; returns the entries taken."""
    if not os.path.exists(path):
        warnings.warn(f"checkpoint {path} not found; keeping initialization")
        return 0
    try:
        # full unpickling, as the reference's loader: legacy files hold
        # whole-model objects. Load only checkpoints you trust.
        state = torch.load(path, map_location="cpu", weights_only=False)
    except Exception as e:  # noqa: BLE001 — mirror the reference's tolerance
        warnings.warn(f"failed to load {path}: {e}; keeping initialization")
        return 0
    merged, n_loaded = merge_state(net.state_dict(), state)
    net.load_state_dict(merged, strict=True)
    if verbose:
        print(f"loaded {n_loaded}/{len(merged)} tensors from {path}")
    return n_loaded


def save_train_state(model, directory: str, step: int) -> str:
    """``torch.save`` the train state of ``model`` as ``<directory>/state_<step>``.

    The state: the state_dict of each net an optimizer trains (its running
    statistics too), each optimizer's state_dict (Adam's moments and step
    counts), the LR, the plateau history and the hole generator's state
    (``model.hole_generator``, where the model draws holes): a resumed run
    draws the same holes as an uninterrupted one. The JAX package writes an
    Orbax directory under the same name; neither package reads the other's.
    Not kept: an I2D replay pool's images and draws.
    """
    os.makedirs(directory, exist_ok=True)
    gen = getattr(model, "hole_generator", None)
    state = {
        "nets": {n: {k: v.detach().cpu() for k, v in model.nets[n].state_dict().items()}
                 for n in model.optimized_nets},
        "optimizers": [o.state_dict() for o in model.optimizers],
        "lr": model.lr,
        "plateau_history": list(model.plateau_history),
        "hole_generator": None if gen is None else gen.get_state(),
    }
    path = os.path.abspath(os.path.join(directory, f"state_{step}"))
    torch.save(state, path)
    return path


def load_train_state(model, directory: str, step=None) -> int:
    """Restore ``save_train_state``'s file into ``model`` (built with the same
    options); ``step`` None takes the largest under ``directory``. Returns
    the step."""
    if step is None:
        cands = [d for d in os.listdir(directory) if d.startswith("state_")]
        if not cands:
            raise FileNotFoundError(f"no train state under {directory}")
        step = max(int(d.split("_")[1]) for d in cands)
    state = torch.load(os.path.join(directory, f"state_{step}"), map_location="cpu",
                       weights_only=True)
    for n, sd in state["nets"].items():
        model.nets[n].load_state_dict(sd, strict=True)
    for o, sd in zip(model.optimizers, state["optimizers"], strict=True):
        o.load_state_dict(sd)
    model.lr = state["lr"]
    for o in model.optimizers:
        for group in o.param_groups:
            group["lr"] = model.lr
    model.plateau_history = list(state["plateau_history"])
    if state["hole_generator"] is not None:
        model.hole_generator.set_state(state["hole_generator"])
    return step
