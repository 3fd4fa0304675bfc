"""Surface normals of the stage-3 loss tail, planar (counterpart of
``desr_tpu/ops/normals.py``): depth maps are (B, H, W), normals (B, 3, H, W).

- ``surface_normals_planar``: image-space normals from np.gradient-style
  central differences (normals.py:56);
- ``surface_normals_from_K_planar``: intrinsics-based normals of the
  K-unprojected point cloud (normals.py:192), in float32 by default as in the
  JAX package;
- ``surface_normals_fov_planar``: the translation stage's fixed-60-degree-FOV
  camera-grid normals (normals.py:97).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def safe_norm(x, dim=-1, keepdim=True):
    """L2 norm with a zero (not NaN) gradient at x == 0 (normals.py:28)."""
    sq = (x * x).sum(dim=dim, keepdim=keepdim)
    pos = sq > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, sq, torch.ones_like(sq))),
                       torch.zeros_like(sq))


def np_gradient(f, dim):
    """np.gradient with unit spacing along ``dim``: central differences inside,
    one-sided at the two edges (normals.py:42)."""
    f = f.movedim(dim, 0)
    out = torch.cat([(f[1] - f[0])[None], (f[2:] - f[:-2]) / 2.0, (f[-1] - f[-2])[None]], 0)
    return out.movedim(0, dim)


def surface_normals_planar(depth_bhw, eps=1e-6):
    """normalize([-dD/drow, -dD/dcol, 1]): (B, H, W) -> (B, 3, H, W) (normals.py:56)."""
    n = torch.stack([-np_gradient(depth_bhw, 1), -np_gradient(depth_bhw, 2),
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


def depth_to_points_planar(depth01_bhw, K, crop, shift=0.5):
    """Camera-space points (B, 3, H, W) of [0, 1] depth under intrinsics K
    (B, 3, 3) and crop boxes (B, 4) = [h0, h1, w0, w1] (normals.py:146)."""
    b, h, w = depth01_bhw.shape
    dt, dev = depth01_bhw.dtype, depth01_bhw.device
    K, crop = K.to(dt), crop.to(dt)
    v = crop[:, 0:1] + torch.arange(h, dtype=dt, device=dev)[None, :] + shift  # (B, H)
    u = crop[:, 2:3] + torch.arange(w, dtype=dt, device=dev)[None, :] + shift  # (B, W)
    vv = v[:, :, None].expand(b, h, w)
    uu = u[:, None, :].expand(b, h, w)
    pix = torch.stack([uu, vv, torch.ones_like(vv)], dim=1)
    pts = torch.einsum("blk,bkhw->blhw", _inv3x3(K), pix)
    pts = pts / pts[:, 2:3]  # orthogonal depth convention
    return pts * depth01_bhw[:, None]


def points_to_normals_planar(coords, eps=1e-12):
    """First-order normals of a planar point cloud (normals.py:169), divided by
    max(|n|, eps) as torch.nn.functional.normalize does."""
    x, y, z = coords[:, 0], coords[:, 1], coords[:, 2]
    dxdu, dydu, dzdu = np_gradient(x, 2), np_gradient(y, 2), np_gradient(z, 2)
    dxdv, dydv, dzdv = np_gradient(x, 1), np_gradient(y, 1), np_gradient(z, 1)
    n = torch.stack([dydv * dzdu - dydu * dzdv,
                     dzdv * dxdu - dzdu * dxdv,
                     dxdv * dydu - dxdu * dydv], dim=1)
    return n / torch.clamp(safe_norm(n, dim=1), min=eps)


def surface_normals_from_K_planar(depth_bhw, K, crop, shift=0.5, dtype=torch.float32):
    """Intrinsics-based normals (normals.py:192): [-1, 1] depth (B, H, W) ->
    (B, 3, H, W) float32, computed in ``dtype``."""
    d = (depth_bhw.to(dtype) + 1.0) / 2.0
    return points_to_normals_planar(depth_to_points_planar(d, K, crop, shift)).float()


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
