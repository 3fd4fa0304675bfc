"""Depth hole masks and the train-time hole sampler (counterpart of
``desr_tpu/ops/depth.py``). Depth maps are planar (B, H, W) tensors in [-1, 1].
Under ``--spatial_devices`` a map is a rank's band of each frame's rows:
``valid_mask`` reads one row of each neighbour, and ``random_rect_holes``
draws the whole global batch's masks at the frame's H and keeps the rank's
rows of B and of H.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from desr_tpu_torch.parallel import spatial as S


def hole_mask(depth, border=-0.97):
    """1.0 where depth is a hole (depth <= border), else 0.0 (depth.py:52)."""
    return (depth <= border).to(depth.dtype)


def valid_mask(depth, border=-0.97, spatial=None):
    """1.0 where no hole lies in the 3x3 neighbourhood, else 0.0 (depth.py:61).

    A 3x3 max-pool dilation of the hole mask (the border counts as no hole),
    then logical-not. On a rank's band (an active ``spatial``) the rows at a
    seam come from the neighbours; a border row pads with 0, no hole, as the
    pool's own padding reads.
    """
    holes = hole_mask(depth, border)[:, None]
    sp = S.active(spatial)
    if sp is None:
        return 1.0 - F.max_pool2d(holes, 3, stride=1, padding=1)[:, 0]
    holes, top, bottom = S.exchange_rows(holes, 1, 1, sp)
    holes = F.pad(holes, (1, 1, 1 - top, 1 - bottom))
    return 1.0 - F.max_pool2d(holes, 3, stride=1)[:, 0]


def random_rect_holes(base_valid_mask, *, n_max=60, n_min=10, p=0.90,
                      min_frac=150, max_frac=8, generator=None, rows=None, h_rows=None):
    """Per-sample random rectangle hole masks (depth.py:84-164), planar (B, H, W).

    0 where a rectangle covers a pixel that ``base_valid_mask`` marks valid
    (> 0.05), 1 elsewhere. Per sample: ``number`` ~ U{n_min..n_max-1}
    rectangles, corners ~ U over the grid (with replacement, as the JAX
    package), sizes ~ U{W//min_frac .. W//max_frac-1} (rows likewise), each
    axis's sizes times ONE Bernoulli(p) draw shared by all rectangles of the
    sample. With p=0 every rectangle has size 0 and the mask is all ones
    (depth.py:117-126): the eval and serving case, which draws nothing.
    ``generator``: a ``torch.Generator`` on the mask's device (its default
    generator when None). ``rows`` = (lo, hi, n): the mask holds rows lo..hi
    of a global batch of n (a data-parallel rank's share); the draws are
    then the whole batch's and the rank keeps its rows, so that every world
    size punches the same holes. ``h_rows`` = (lo, hi, h): the mask holds
    image rows lo..hi of frames of h rows (a spatial rank's band); the
    draws are the whole frames' and the rank keeps its rows of H too.
    """
    if p == 0.0:
        return torch.ones_like(base_valid_mask)
    _, h, w = base_valid_mask.shape
    y0, y1, h = h_rows if h_rows is not None else (0, h, h)
    r0, r1, b = rows if rows is not None else (0, len(base_valid_mask), len(base_valid_mask))
    dev = base_valid_mask.device
    n_rect = n_max - 1 if n_max > n_min else n_min

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=generator, device=dev)

    number = randint(n_min, max(n_max, n_min + 1), (b, 1))
    active = torch.arange(n_rect, device=dev)[None, :] < number  # (B, R)
    xs = randint(0, w, (b, n_rect))
    ys = randint(0, h, (b, n_rect))
    sizes_x = randint(w // min_frac, max(w // max_frac, w // min_frac + 1), (b, n_rect))
    sizes_y = randint(h // min_frac, max(h // max_frac, h // min_frac + 1), (b, n_rect))
    bern = (torch.rand((b, 2), generator=generator, device=dev) < p).long()
    sizes_x = sizes_x * bern[:, :1]
    sizes_y = sizes_y * bern[:, 1:]
    active, xs, ys, sizes_x, sizes_y = (t[r0:r1] for t in (active, xs, ys, sizes_x, sizes_y))
    # covered[b, y, x] = OR_r (row_in[b, r, y] AND col_in[b, r, x]): one
    # (H, R) x (R, W) product per sample, no (B, R, H, W) broadcast
    yy = torch.arange(y0, y1, device=dev)[None, None, :]
    xx = torch.arange(w, device=dev)[None, None, :]
    row_in = ((yy >= ys[..., None]) & (yy < (ys + sizes_y)[..., None])
              & active[..., None]).float()
    col_in = ((xx >= xs[..., None]) & (xx < (xs + sizes_x)[..., None])).float()
    covered = torch.einsum("brh,brw->bhw", row_in, col_in) > 0.5
    punched = (base_valid_mask > 0.05) & covered
    return torch.where(punched, 0.0, 1.0).to(base_valid_mask.dtype)


def punch_holes(depth, gt_mask, fill=-1.0):
    """Masked pixels (gt_mask < 0.05) become ``fill`` (depth.py:167)."""
    return torch.where(gt_mask < 0.05, torch.full_like(depth, fill), depth)
