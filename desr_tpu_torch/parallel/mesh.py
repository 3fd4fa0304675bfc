"""Data-parallel ranks (counterpart of ``desr_tpu/parallel/mesh.py``).

The JAX package builds a 1-D ('data',) mesh over ``--num_devices`` chips and
lets GSPMD put the collectives into its one jitted step. The port runs one
process a rank (``parallel.launch``), each a single-device program on its
rows of the global batch, and makes each reduction explicit:

- the parameters start equal on every rank (``replicate`` broadcasts rank 0's);
- ``shard_batch`` gives a rank its contiguous rows of each global batch, in
  JAX's order;
- BatchNorm's moments and the losses' data-dependent denominators are summed
  over the ranks by ``all_reduce_sum``, whose backward all-reduces the
  cotangent, so that they are the global batch's (QUIRKS #35: global
  moments, not the reference DataParallel's per-replica ones);
- ``reduce_grads`` averages the trained nets' gradients in one all_reduce,
  and ``mean_over_ranks`` the logged metrics.

The convention that makes the average the global gradient: each rank's loss
is N times its share of the global loss. A mean over equal shards already is;
a masked mean divides its rank's sum by the global mask count and is scaled
by N, and an unnormalised sum is scaled by N (``ops/losses.py``).

Every rank runs its kernels (K1, K3) on its own shard: the JAX package's
guard that turns its Pallas routes off under a mesh larger than one device
(``pallas_call`` has no partitioning rule) has no counterpart here.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of a data mesh: ``devices`` (one a rank, in rank order), this
    process's ``rank`` and the process group (None for one rank)."""

    devices: tuple
    rank: int = 0
    group: object = None

    @property
    def size(self):
        return len(self.devices)

    @property
    def device(self):
        return self.devices[self.rank]

    def rows(self, n):
        """(lo, hi): this rank's rows of a leading axis of ``n``. Rank r takes
        rows r*n/N .. (r+1)*n/N; when N does not divide n every rank takes
        all n, as the JAX package replicates such an array
        (desr_tpu/parallel/mesh.py:73-79)."""
        if n % self.size:
            return 0, n
        k = n // self.size
        return self.rank * k, (self.rank + 1) * k


def make_mesh(devices, spatial=1):
    """The mesh over ``devices``, one a rank: a single device needs no process
    group; N > 1 devices need the N ranks of an initialised one
    (``parallel.launch`` starts them), and this process is its rank."""
    if spatial > 1:
        raise NotImplementedError(
            "--spatial_devices > 1 (the image-H axis of the mesh) is not yet ported "
            "to desr_tpu_torch (shard it with the JAX package)")
    devices = tuple(torch.device(d) for d in devices)
    if len(devices) == 1:
        return Mesh(devices)
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() != len(devices):
        raise RuntimeError(
            f"a mesh of {len(devices)} devices needs a process group of {len(devices)} "
            "ranks; start them with desr_tpu_torch.parallel.launch")
    return Mesh(devices, dist.get_rank(), dist.group.WORLD)


class Shard(dict):
    """A batch dict that holds one rank's rows of a global batch:
    ``rows`` = (lo, hi, n), rows lo..hi of n. ``shard_batch`` hands it back
    unchanged (a rank's loader yields its rows already)."""

    def __init__(self, items, rows):
        super().__init__(items)
        self.rows = tuple(rows)

    @property
    def split(self):
        """Whether the ranks share the batch (each holds fewer than all rows)."""
        lo, hi, n = self.rows
        return hi - lo < n


def _length(v):
    if isinstance(v, (list, tuple)):
        return len(v)
    shape = getattr(v, "shape", ())
    return shape[0] if len(shape) else None


def shard_batch(batch, mesh):
    """This rank's rows of each value of a global batch (numpy arrays,
    tensors, lists of paths): its contiguous share of a leading axis that N
    divides, the whole value otherwise (``Mesh.rows``). Nothing is copied to
    a device. Returns a ``Shard`` whose ``rows`` are the batch's, taken from
    its first value with a leading axis."""
    if isinstance(batch, Shard):
        return batch
    n = next((length for length in map(_length, batch.values()) if length), 0)
    out = {}
    for k, v in batch.items():
        length = _length(v)
        if mesh.size > 1 and length:
            lo, hi = mesh.rows(length)
            v = v[lo:hi]
        out[k] = v
    return Shard(out, (*mesh.rows(n), n) if n else (0, 0, 0))


def shard_batch_steps(batches, mesh):
    """``shard_batch`` of each of a ``--steps_per_call`` group's batches (the
    port queues the steps; the JAX package stacks them for its scan)."""
    return [shard_batch(b, mesh) for b in batches]


def replicate(module, mesh):
    """Rank 0's parameters and buffers broadcast into every rank's ``module``
    (in place); a single rank keeps its own. Returns the module."""
    if mesh.size > 1:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=0, group=mesh.group)
    return module


def reduce_grads(params, mesh):
    """Average the ``.grad`` of ``params`` over the ranks in one all_reduce
    (the trained nets' gradients, flattened into one bucket). Parameters
    without a gradient are left out, alike on every rank."""
    if mesh.size == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    flat /= mesh.size
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x, group):
    """The sum of ``x`` over the ranks of ``group`` (``x`` itself when None),
    differentiable: the backward sums the ranks' cotangents, which is the
    gradient of the sum of every rank's loss."""
    return x if group is None else _AllReduceSum.apply(x, group)


def group_size(group):
    """The ranks ``group`` spans (1 for None)."""
    return 1 if group is None else dist.get_world_size(group)


def all_gather_rows(x, group):
    """The global batch of a split one: every rank's rows of ``x`` (equal
    shares), concatenated in rank order."""
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, 0)


def mean_over_ranks(metrics, group, device):
    """The logged metrics as global values: each the mean over the ranks of
    ``group`` (each rank's term is N times its share, see the module's
    convention), in one all_reduce. None: the metrics as they are."""
    if group is None or not metrics:
        return metrics
    keys = list(metrics)
    vec = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32, device=device).reshape(())
                       for k in keys])
    dist.all_reduce(vec, group=group)
    vec /= dist.get_world_size(group)
    return dict(zip(keys, vec.unbind(0)))
