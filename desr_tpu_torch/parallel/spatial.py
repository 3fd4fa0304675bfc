"""Row primitives of the mesh's spatial axis (``--spatial_devices`` S).

The JAX package shards a frame's H axis over S chips and lets GSPMD insert
the halo exchanges each conv needs (desr_tpu/parallel/mesh.py:27-43). The
port runs one process a rank, each on its band of rows, and makes every
exchange explicit:

- ``exchange_rows`` gives a rank's tensor the rows its neighbours hold
  above and below it (a halo), none at the frame's edges;
- ``gather_h`` / ``take_h`` make a tensor whole along H on every rank of the
  group and take a rank's band back;
- ``reduce_sum`` sums a norm's moments over the group.

Whether a tensor is split or whole is decided from its global H alone
(``Spatial.sharded``, the rule of JAX's ``spatial_anchor``,
desr_tpu/models/layers.py:100-126), so every rank takes the same branch and
issues the same collectives in the same order: a branch that differed
between ranks would deadlock. Inside ``whole()`` every layer runs as on one
process (a U-Net level too small to split, or a frame the mesh leaves
whole).

The collectives are ``dist.all_gather`` of each rank's edge rows, the call
that gloo also takes for CUDA tensors (two ranks on one card), and
``dist.all_reduce``. Each has its adjoint, for training:

- an exchange's backward sends the cotangents of the halo rows a rank
  received back to the neighbour that owns those rows, which adds them to
  its edge rows (one ``all_gather`` of each rank's two halo cotangents;
  none cross the frame's edges);
- a gather's backward sums every rank's cotangent of the whole tensor over
  the group (one ``all_reduce``) and keeps the rank's band of it;
- ``reduce_sum``'s backward all-reduces the cotangent
  (``parallel/mesh.py:all_reduce_sum``).

Every rank issues the same backward collectives in the same order: the
backward of each is unconditional, and a cotangent that autograd leaves
undefined arrives as zeros (``set_materialize_grads``), so no rank skips a
collective that its neighbours wait in.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist

from desr_tpu_torch.parallel.mesh import all_reduce_sum

MIN_ROWS = 16  # rows a rank at least holds of a split tensor (spatial_anchor's)

# collectives issued since the last ``reset_counts``: halo exchanges, gathers
# along H and moment all-reduces in the forward, and the exchanges' and
# gathers' adjoints in the backward (``reduce_sum``'s backward is
# ``parallel/mesh.py``'s, counted there)
COUNTS = {"exchange": 0, "gather": 0, "all_reduce": 0, "exchange_bwd": 0, "gather_bwd": 0}


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0


@dataclasses.dataclass(frozen=True)
class Spatial:
    """A rank's place on the spatial axis: its ``group`` of ``size`` ranks,
    which hold a frame's rows in rank order, and its ``rank`` among them."""

    group: object
    size: int
    rank: int

    @property
    def first(self):
        """Whether this rank holds the frame's top rows."""
        return self.rank == 0

    @property
    def last(self):
        """Whether this rank holds the frame's bottom rows."""
        return self.rank == self.size - 1

    def sharded(self, h):
        """Whether a tensor of global H ``h`` is split over the group: S
        divides h and each rank holds at least ``MIN_ROWS`` rows."""
        return h % self.size == 0 and h >= MIN_ROWS * self.size


def from_mesh(mesh):
    """The ``Spatial`` of this rank of ``mesh`` (None without a spatial axis)."""
    if mesh.spatial == 1:
        return None
    return Spatial(mesh.spatial_group, mesh.spatial, mesh.spatial_rank)


_WHOLE = []  # one entry a ``whole()`` context entered


@contextlib.contextmanager
def whole():
    """Every layer called inside runs on whole tensors, as on one process."""
    _WHOLE.append(True)
    try:
        yield
    finally:
        _WHOLE.pop()


def active(sp):
    """``sp`` where a layer tagged with it splits rows now, else None."""
    return None if sp is None or _WHOLE else sp


def set_spatial_group(module, spatial):
    """Tag every layer of ``module`` that reads a ``spatial`` attribute with
    ``spatial`` (a ``Spatial``, a mesh, or None to untag); returns ``module``."""
    if spatial is not None and not isinstance(spatial, Spatial):
        spatial = from_mesh(spatial)
    for m in module.modules():
        if hasattr(m, "spatial"):
            m.spatial = spatial
    return module


def _all_gather(x, sp):
    x = x.contiguous()  # the collective moves dense row-major buffers
    parts = [torch.empty_like(x) for _ in range(sp.size)]
    dist.all_gather(parts, x, group=sp.group)
    return parts


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, top, bottom, sp, dim):
        ctx.set_materialize_grads(True)
        ctx.top, ctx.bottom, ctx.sp, ctx.dim = top, bottom, sp, dim
        h = x.shape[dim]
        edge = torch.cat([x.narrow(dim, 0, bottom), x.narrow(dim, h - top, top)], dim)
        parts = _all_gather(edge, sp)
        pieces = [x]
        if not sp.first:
            pieces.insert(0, parts[sp.rank - 1].narrow(dim, bottom, top))
        if not sp.last:
            pieces.append(parts[sp.rank + 1].narrow(dim, 0, bottom))
        return torch.cat(pieces, dim)

    @staticmethod
    def backward(ctx, grad):
        top, bottom, sp, dim = ctx.top, ctx.bottom, ctx.sp, ctx.dim
        ht, hb = (0 if sp.first else top), (0 if sp.last else bottom)
        h = grad.shape[dim] - ht - hb
        COUNTS["exchange_bwd"] += 1

        def halo(lo, n, rows):  # a halo's cotangent; zeros where the frame ends
            if n:
                return grad.narrow(dim, lo, n)
            shape = list(grad.shape)
            shape[dim] = rows
            return grad.new_zeros(shape)

        # what this rank owes: the rows above to the rank above (its last
        # ``top`` rows), the rows below to the rank below (its first ``bottom``)
        parts = _all_gather(torch.cat([halo(0, ht, top), halo(ht + h, hb, bottom)], dim), sp)
        dx = grad.narrow(dim, ht, h).clone(memory_format=torch.contiguous_format)
        if not sp.last:
            dx.narrow(dim, h - top, top).add_(parts[sp.rank + 1].narrow(dim, 0, top))
        if not sp.first:
            dx.narrow(dim, 0, bottom).add_(parts[sp.rank - 1].narrow(dim, top, bottom))
        return dx, None, None, None, None


def exchange_rows(x, top, bottom, sp, dim=2):
    """(x with ``top`` rows of the rank above before its own and ``bottom``
    rows of the rank below after them, along ``dim``; the rows added above;
    the rows added below). The frame's first rank gets none above and its
    last none below. One all_gather over the group, when any row moves."""
    h = x.shape[dim]
    if max(top, bottom) > h:
        raise ValueError(f"a halo of {top} + {bottom} rows from ranks holding {h} rows")
    if top == bottom == 0:
        return x, 0, 0
    COUNTS["exchange"] += 1
    out = _Exchange.apply(x, top, bottom, sp, dim)
    return out, 0 if sp.first else top, 0 if sp.last else bottom


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp, dim):
        ctx.set_materialize_grads(True)
        ctx.sp, ctx.dim = sp, dim
        return torch.cat(_all_gather(x, sp), dim)

    @staticmethod
    def backward(ctx, grad):
        # every rank read the whole tensor: the sum of their cotangents, cut
        # to this rank's band (all_reduce then take_h; whether gloo takes
        # reduce_scatter for CUDA tensors is not established)
        COUNTS["gather_bwd"] += 1
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.sp.group)
        return take_h(grad, ctx.sp, ctx.dim).contiguous(), None, None


def gather_h(x, sp, dim=2):
    """The whole tensor along ``dim`` on every rank: the ranks' bands,
    concatenated in rank order (one all_gather)."""
    COUNTS["gather"] += 1
    return _Gather.apply(x, sp, dim)


def take_h(x, sp, dim=2):
    """This rank's band of a whole tensor along ``dim`` (S divides it)."""
    h = x.shape[dim]
    if h % sp.size:
        raise ValueError(f"{h} rows do not split over {sp.size} ranks")
    k = h // sp.size
    return x.narrow(dim, sp.rank * k, k)


def reduce_sum(x, sp):
    """The sum of ``x`` over the group (one all_reduce; differentiable)."""
    COUNTS["all_reduce"] += 1
    return all_reduce_sum(x, sp.group)
