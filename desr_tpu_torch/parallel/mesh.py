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

``--spatial_devices`` S makes the mesh 2-D, ('data', 'spatial'), in JAX's
layout (desr_tpu/parallel/mesh.py:41-43): rank = d * S + s, so the S ranks
of a data group d are consecutive. A data group's ranks split each frame's
H axis (``shard_batch``'s H rule); GSPMD's halo exchanges become explicit
collectives over the spatial group (``parallel/spatial.py``). The rule
above then reads over all N = D x S ranks: a mean over a rank's equal band
is N times its share, and so is a mean over a whole tensor that every rank
of a data group computes alike (a U-Net level the group does not split).
A sum or a count over such a whole tensor is taken over ``batch_group``, the
ranks that hold distinct frames, so that its S copies count once. Serving
and training (main, ``--SR``, I2D) run on such a mesh.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

# all_reduce_sum calls since the last reset (forward, and their adjoints in
# the backward): BatchNorm's moments, the losses' counts, the norms' moments
COUNTS = {"all_reduce_sum": 0, "all_reduce_sum_bwd": 0}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of a mesh: ``devices`` (one a rank, in rank order), this
    process's ``rank`` and the process group (None for one rank). With
    ``spatial`` S > 1 the ranks form a (N / S, S) grid, rank = data_rank * S
    + spatial_rank; ``spatial_group`` holds this rank's data group's S ranks
    (which split a frame's H axis) and ``data_group`` the N / S ranks of its
    spatial position (None where that is one rank)."""

    devices: tuple
    rank: int = 0
    group: object = None
    spatial: int = 1
    spatial_group: object = None
    data_group: object = None

    @property
    def size(self):
        return len(self.devices)

    @property
    def device(self):
        return self.devices[self.rank]

    @property
    def data_size(self):
        """The mesh's data axis: the ranks that split the batch axis."""
        return self.size // self.spatial

    @property
    def data_rank(self):
        return self.rank // self.spatial

    @property
    def spatial_rank(self):
        return self.rank % self.spatial

    @property
    def batch_group(self):
        """The process group of the ranks that split the batch axis: every
        rank without a spatial axis, else this rank's data group (None
        where that is this rank alone)."""
        return self.group if self.spatial == 1 else self.data_group

    def rows(self, n):
        """(lo, hi): this rank's rows of a leading axis of ``n``, split over
        the data axis. Data rank d takes rows d*n/D .. (d+1)*n/D; when D does
        not divide n every rank takes all n, as the JAX package replicates
        such an array (desr_tpu/parallel/mesh.py:73-79)."""
        if n % self.data_size:
            return 0, n
        k = n // self.data_size
        return self.data_rank * k, (self.data_rank + 1) * k

    def h_rows(self, h):
        """(lo, hi): this rank's rows of an image's H axis of ``h`` under
        JAX's rule (desr_tpu/parallel/mesh.py:72-74): split over the spatial
        group when S divides h and h >= 32, else all h."""
        if self.spatial == 1 or h % self.spatial or h < 32:
            return 0, h
        k = h // self.spatial
        return self.spatial_rank * k, (self.spatial_rank + 1) * k


def make_mesh(devices, spatial=1):
    """The mesh over ``devices``, one a rank: a single device needs no process
    group; N > 1 devices need the N ranks of an initialised one
    (``parallel.launch`` starts them), and this process is its rank. With
    ``spatial`` S > 1, S must divide N (desr_tpu/parallel/mesh.py:39-40);
    every rank creates the groups of every row and column of the grid, in
    the same order, as ``dist.new_group`` requires."""
    devices = tuple(torch.device(d) for d in devices)
    n = len(devices)
    if spatial < 1 or n % spatial:
        raise ValueError(f"{n} devices not divisible by spatial={spatial}")
    if n == 1:
        return Mesh(devices)
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() != n:
        raise RuntimeError(
            f"a mesh of {n} devices needs a process group of {n} "
            "ranks; start them with desr_tpu_torch.parallel.launch")
    rank = dist.get_rank()
    if spatial == 1:
        return Mesh(devices, rank, dist.group.WORLD)
    d, s = divmod(rank, spatial)
    spatial_groups = [dist.new_group(list(range(i * spatial, (i + 1) * spatial)))
                      for i in range(n // spatial)]
    data_groups = ([dist.new_group(list(range(j, n, spatial))) for j in range(spatial)]
                   if n > spatial else [None] * spatial)
    return Mesh(devices, rank, dist.group.WORLD, spatial, spatial_groups[d], data_groups[s])


class Shard(dict):
    """A batch dict that holds one rank's rows of a global batch:
    ``rows`` = (lo, hi, n), rows lo..hi of n, and under a spatial mesh
    ``h_rows`` = (lo, hi, h), the image rows lo..hi of h that each of its
    image values holds (0, h, h: whole frames). ``shard_batch`` hands it
    back unchanged (a rank's loader yields its rows already)."""

    def __init__(self, items, rows, h_rows=None):
        super().__init__(items)
        self.rows = tuple(rows)
        self.h_rows = None if h_rows is None else tuple(h_rows)

    @property
    def split(self):
        """Whether the ranks share the batch (each holds fewer than all rows)."""
        lo, hi, n = self.rows
        return hi - lo < n

    @property
    def h_split(self):
        """Whether the frames' H axis is split over the spatial group."""
        return self.h_rows is not None and self.h_rows[1] - self.h_rows[0] < self.h_rows[2]


def _length(v):
    if isinstance(v, (list, tuple)):
        return len(v)
    shape = getattr(v, "shape", ())
    return shape[0] if len(shape) else None


def _is_image(v):
    """An image-like value, whose axis 1 is H: numeric, ndim >= 3
    (desr_tpu/parallel/mesh.py:66-73; NHWC images and planar depths)."""
    shape = getattr(v, "shape", ())
    return len(shape) >= 3 and not isinstance(v, (list, tuple))


def shard_batch(batch, mesh):
    """This rank's rows of each value of a global batch (numpy arrays,
    tensors, lists of paths): its contiguous share of a leading axis that
    the data axis divides, the whole value otherwise (``Mesh.rows``); then,
    on a spatial mesh, its rows of each image value's H axis (``split_h``).
    Nothing is copied to a device. Returns a ``Shard`` whose ``rows`` are
    the batch's, taken from its first value with a leading axis."""
    if isinstance(batch, Shard):
        return batch
    n = next((length for length in map(_length, batch.values()) if length), 0)
    out = {}
    for k, v in batch.items():
        length = _length(v)
        if mesh.data_size > 1 and length:
            lo, hi = mesh.rows(length)
            v = v[lo:hi]
        out[k] = v
    return split_h(out, mesh, (*mesh.rows(n), n) if n else (0, 0, 0))


def split_h(batch, mesh, rows):
    """A ``Shard`` of a data group's ``batch`` (its ``rows`` = (lo, hi, n)
    of the global batch): on a spatial mesh each image value keeps this
    rank's rows of its H axis (``Mesh.h_rows``: split when S divides H and
    H >= 32, else whole); ``h_rows`` records the tallest image value's. As in
    JAX, a batch that the data axis does not divide is whole on every rank,
    H too. Without a spatial axis the values stay as they are."""
    if mesh.spatial == 1 or rows[2] % mesh.data_size:
        return Shard(batch, rows)
    out, h_rows = {}, None
    for k, v in batch.items():
        if _is_image(v):
            h = v.shape[1]
            lo, hi = mesh.h_rows(h)
            v = v[:, lo:hi]
            if h_rows is None or h > h_rows[2]:
                h_rows = (lo, hi, h)
        out[k] = v
    return Shard(out, rows, h_rows)


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
        ctx.set_materialize_grads(True)
        ctx.group = group
        COUNTS["all_reduce_sum"] += 1
        out = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        COUNTS["all_reduce_sum_bwd"] += 1
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
