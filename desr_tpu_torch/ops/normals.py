"""Surface normals of the stage-3 loss tail, planar (counterpart of
``desr_tpu/ops/normals.py``): depth maps are (B, H, W), normals (B, 3, H, W).

- ``surface_normals_planar``: image-space normals from np.gradient-style
  central differences (normals.py:56);
- ``surface_normals_from_K_planar``: intrinsics-based normals of the
  K-unprojected point cloud (normals.py:192), in float32 by default as in the
  JAX package;
- ``surface_normals_fov_planar``: the translation stage's fixed-60-degree-FOV
  camera-grid normals (normals.py:97).

Under ``--spatial_devices`` the first two take ``spatial`` (a rank's
``Spatial``, or None): the depth is the rank's band of the frame's rows, a
difference along H at a seam between ranks is central, from one row of each
neighbour (``exchange_rows``), one-sided only at the frame's edges, and the
band's pixel rows are the frame's (``depth_to_points_planar``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from desr_tpu_torch.parallel import spatial as S


def safe_norm(x, dim=-1, keepdim=True):
    """L2 norm with a zero (not NaN) gradient at x == 0 (normals.py:28)."""
    sq = (x * x).sum(dim=dim, keepdim=keepdim)
    pos = sq > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, sq, torch.ones_like(sq))),
                       torch.zeros_like(sq))


def np_gradient(f, dim, spatial=None):
    """np.gradient with unit spacing along ``dim``: central differences inside,
    one-sided at the two edges (normals.py:42). With an active ``spatial``
    ``dim`` is H and f a rank's band of it: a row beside a seam takes the
    neighbour's row (one exchange), and only the frame's edges are
    one-sided."""
    sp = S.active(spatial)
    top = bottom = 0
    if sp is not None:
        f, top, bottom = S.exchange_rows(f, 1, 1, sp, dim=dim)
    f = f.movedim(dim, 0)
    parts = [(f[2:] - f[:-2]) / 2.0]
    if not top:
        parts.insert(0, (f[1] - f[0])[None])
    if not bottom:
        parts.append((f[-1] - f[-2])[None])
    return torch.cat(parts, 0).movedim(0, dim)


def surface_normals_planar(depth_bhw, eps=1e-6, spatial=None):
    """normalize([-dD/drow, -dD/dcol, 1]): (B, H, W) -> (B, 3, H, W) (normals.py:56)."""
    n = torch.stack([-np_gradient(depth_bhw, 1, spatial), -np_gradient(depth_bhw, 2),
                     torch.ones_like(depth_bhw)], dim=1)
    return n / (safe_norm(n, dim=1) + eps)


def _inv3x3(K):
    """Closed-form batched 3x3 inverse, adjugate over determinant (normals.py:126)."""
    a, b, c = K[..., 0, 0], K[..., 0, 1], K[..., 0, 2]
    d, e, f = K[..., 1, 0], K[..., 1, 1], K[..., 1, 2]
    g, h, i = K[..., 2, 0], K[..., 2, 1], K[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


def depth_to_points_planar(depth01_bhw, K, crop, shift=0.5, spatial=None):
    """Camera-space points (B, 3, H, W) of [0, 1] depth under intrinsics K
    (B, 3, 3) and crop boxes (B, 4) = [h0, h1, w0, w1] (normals.py:146).
    With an active ``spatial`` the depth is the rank's band of equal bands
    in rank order, whose first row is the frame's ``rank x h``."""
    b, h, w = depth01_bhw.shape
    dt, dev = depth01_bhw.dtype, depth01_bhw.device
    K, crop = K.to(dt), crop.to(dt)
    sp = S.active(spatial)
    lo = 0 if sp is None else sp.rank * h
    v = crop[:, 0:1] + torch.arange(lo, lo + h, dtype=dt, device=dev)[None, :] + shift  # (B, H)
    u = crop[:, 2:3] + torch.arange(w, dtype=dt, device=dev)[None, :] + shift  # (B, W)
    vv = v[:, :, None].expand(b, h, w)
    uu = u[:, None, :].expand(b, h, w)
    pix = torch.stack([uu, vv, torch.ones_like(vv)], dim=1)
    pts = torch.einsum("blk,bkhw->blhw", _inv3x3(K), pix)
    pts = pts / pts[:, 2:3]  # orthogonal depth convention
    return pts * depth01_bhw[:, None]


def points_to_normals_planar(coords, eps=1e-12, spatial=None):
    """First-order normals of a planar point cloud (normals.py:169), divided by
    max(|n|, eps) as torch.nn.functional.normalize does. The three
    coordinates' differences along each axis are taken together (one
    exchange along H under ``spatial``)."""
    du, dv = np_gradient(coords, 3), np_gradient(coords, 2, spatial)
    dxdu, dydu, dzdu = du.unbind(1)
    dxdv, dydv, dzdv = dv.unbind(1)
    n = torch.stack([dydv * dzdu - dydu * dzdv,
                     dzdv * dxdu - dzdu * dxdv,
                     dxdv * dydu - dxdu * dydv], dim=1)
    return n / torch.clamp(safe_norm(n, dim=1), min=eps)


def surface_normals_from_K_planar(depth_bhw, K, crop, shift=0.5, dtype=torch.float32,
                                  spatial=None):
    """Intrinsics-based normals (normals.py:192): [-1, 1] depth (B, H, W) ->
    (B, 3, H, W) float32, computed in ``dtype``; on a rank's band under
    ``spatial``."""
    d = (depth_bhw.to(dtype) + 1.0) / 2.0
    pts = depth_to_points_planar(d, K, crop, shift, spatial)
    return points_to_normals_planar(pts, spatial=spatial).float()


def _fov_grid(h, w, fov_deg, dtype, device):
    """The fixed camera grid (H, W, 3) of normals.py:80-89."""
    t = math.tan(fov_deg / 2.0 / 180.0 * math.pi)
    x = (torch.arange(1, w + 1, dtype=dtype, device=device) - (w + 1) / 2.0) / (w / 2.0) * t
    y = -(torch.arange(1, h + 1, dtype=dtype, device=device) - (h + 1) / 2.0) / (h / 2.0) \
        * t * (h / w)
    return torch.stack([x[None, :].expand(h, w), y[:, None].expand(h, w),
                        torch.ones((h, w), dtype=dtype, device=device)], dim=-1)


def surface_normals_fov_planar(depth_bhw, fov_deg=60.0, canvas_hw=(482, 642), eps=1e-8):
    """Fixed-FOV normals of the translation stage: (B, H, W) -> (B, 3, H, W)
    (normals.py:92-117), with the as-shipped quirks: the crop into the
    482x642 canvas starts at ``p + 1``, one past centre, and the two
    difference windows over the reflect pad are offset by one row (gx) and one
    column (gy), so the first gy row is exactly zero (``safe_norm`` keeps its
    gradient finite)."""
    b, h, w = depth_bhw.shape
    ch, cw = canvas_hw
    grid = _fov_grid(ch, cw, fov_deg, depth_bhw.dtype, depth_bhw.device)
    ph, pw = (ch - h) // 2, (cw - w) // 2
    grid = grid[ph + 1:ph + 1 + h, pw + 1:pw + 1 + w].permute(2, 0, 1)
    pv = F.pad(depth_bhw[:, None] * grid[None], (1, 1, 1, 1), mode="reflect")
    gx = (pv[:, :, 0:h, 0:w] - pv[:, :, 0:h, 2:2 + w]) / 2.0
    gy = (pv[:, :, 2:2 + h, 0:w] - pv[:, :, 0:h, 0:w]) / 2.0
    crs = torch.linalg.cross(gx, gy, dim=1)
    return -crs / torch.clamp(safe_norm(crs, dim=1), min=eps)
