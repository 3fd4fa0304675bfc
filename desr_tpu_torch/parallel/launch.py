"""Starting the ranks of a data mesh (``--num_devices``).

``resolve_devices`` reads ``--device`` and ``--num_devices`` as the JAX
package reads ``--num_devices`` (0: every device there is), and ``launch``
runs a function once a device, each call in a process of its own, joined in
one ``torch.distributed`` process group over a file rendezvous: NCCL on the
card, gloo on the CPU unless told otherwise. One rank is no process group at
all: the caller runs its function in its own process.
"""

from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing

from desr_tpu_torch import resolve_device
from desr_tpu_torch.parallel.mesh import make_mesh


def resolve_devices(device=None, num_devices=0):
    """The devices ``--num_devices`` N gives on ``--device``'s type, one a
    rank: the first N cards (N <= 0: every visible card), or under ``--device
    cpu`` N ranks on the CPU (N <= 0: one). One device is ``device`` itself.

    Raises where there is no card (``resolve_device``) and where N is more
    than the cards visible; the JAX package's ``jax.devices()[:n]`` would take
    fewer without a word.
    """
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * max(num_devices, 1)
    visible = torch.cuda.device_count()
    n = num_devices if num_devices > 0 else visible
    if n > visible:
        raise ValueError(f"--num_devices {n}: only {visible} CUDA device(s) are visible")
    return [dev] if n == 1 else [torch.device("cuda", i) for i in range(n)]


def default_backend(devices):
    """NCCL for cards, gloo for the CPU."""
    return "nccl" if torch.device(devices[0]).type == "cuda" else "gloo"


def launch(fn, devices, backend=None, args=(), workdir=None):
    """Run ``fn(mesh, *args)`` on ``len(devices)`` ranks: spawned processes
    joined in a process group of ``backend`` (``default_backend`` when None)
    over a file store in a temporary directory under ``workdir``; rank r runs
    on ``devices[r]`` (``torch.cuda.set_device`` for a card). ``fn`` is
    pickled by name, so it lives at a module's top level. Returns every
    rank's return value, in rank order, copied to the host (``torch.save``).
    A rank that raises, a failed collective among them, fails the launch
    (``torch.multiprocessing.ProcessRaisedException``)."""
    devices = [torch.device(d) for d in devices]
    backend = backend or default_backend(devices)
    with tempfile.TemporaryDirectory(prefix="desr_ranks_", dir=workdir) as tmp:
        torch.multiprocessing.spawn(_rank_main, args=(fn, devices, backend, tmp, args),
                                    nprocs=len(devices), join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), map_location="cpu",
                           weights_only=False)
                for r in range(len(devices))]


def _rank_main(rank, fn, devices, backend, tmp, args):
    if devices[rank].type == "cuda":
        torch.cuda.set_device(devices[rank])
    dist.init_process_group(backend, init_method="file://" + os.path.join(tmp, "store"),
                            rank=rank, world_size=len(devices))
    try:
        out = fn(make_mesh(devices), *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
