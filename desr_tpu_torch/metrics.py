"""Offline evaluation metrics (counterpart of ``desr_tpu/metrics.py``; the
reference's new_metrics.py).

    python -m desr_tpu_torch.metrics --input_path ... --pred_path ... \
        --target_path ... [--max_depth 5100] [--n_cpus 10] [--intr_root DIR]

Nine metrics over saved uint16 PNG predictions: rmse, mae, psnr, ssim (the
scipy formula), rmse_h / mae_h (the input's holes only), rmse_d / mae_d
(where input and target are both valid) and mse_v (MSE of the K-unprojected
surface normals, the target's holes dilated by one pixel). As the JAX
package: holes below 50 mm (new_metrics.py:15), depths clipped to
``max_depth``, the target subsampled [0::2, 0::2] when it is twice the
prediction (the SR rule, :224-225), the input resized to the target's grid
for its hole map (:227) and K read per scene from
``<intr_root>/<scene>/intrinsic/intrinsic_depth.txt`` (without
``--intr_root`` mse_v is left out).

A host tool on numpy and scipy with no tensors, as its counterpart, so it
has no ``--device``; ``--n_cpus`` > 1 spreads the frames over a spawned
pool. PNGs are read with the package's codec (``data/png.py``) and the
resize is a numpy copy of cv2's float INTER_LINEAR (``resize_linear``): the
card's machine has neither imageio nor cv2.
"""

from __future__ import annotations

import functools
import multiprocessing
import os
from glob import glob

import numpy as np
from scipy import signal

from desr_tpu_torch.data.png import read_png

HOLES_THRESHOLD = 50


def filter_basename(path):
    return os.path.splitext(os.path.basename(path))[0]


def _linear_taps(src_size, dst_size):
    """(lower source index, its weight, the upper one's) of each output
    position, as cv2 5.0's resize builds them for INTER_LINEAR on float64
    images: the source coordinate (d + 0.5) * src / dst - 0.5, edge-clamped
    with weights (1, 0), all in float64."""
    f = (np.arange(dst_size) + 0.5) * (1.0 / (dst_size / src_size)) - 0.5
    s = np.floor(f).astype(np.int64)
    f = f - s
    low, high = s < 0, s >= src_size - 1
    f[low | high] = 0.0
    s[low], s[high] = 0, src_size - 1
    return s, 1.0 - f, f


def resize_linear(img, hw):
    """cv2.resize(img, (hw[1], hw[0]), interpolation=cv2.INTER_LINEAR) of a
    float64 (H, W) array: columns first, then rows, each a two-tap sum."""
    img = np.asarray(img, np.float64)
    sx, ax0, ax1 = _linear_taps(img.shape[1], hw[1])
    rows = img[:, sx] * ax0 + img[:, np.minimum(sx + 1, img.shape[1] - 1)] * ax1
    sy, ay0, ay1 = _linear_taps(img.shape[0], hw[0])
    return (rows[sy] * ay0[:, None]
            + rows[np.minimum(sy + 1, img.shape[0] - 1)] * ay1[:, None])


def coords_to_normals(coords):
    """First-order normals from a (3, H, W) point cloud (new_metrics.py:19-46):
    forward differences along each image axis, edge-replicated, crossed (row
    tangent x column tangent) and unit-normalised."""
    along_w = np.diff(coords, axis=2)
    along_h = np.diff(coords, axis=1)
    along_w = np.concatenate([along_w, along_w[:, :, -1:]], axis=2)
    along_h = np.concatenate([along_h, along_h[:, -1:, :]], axis=1)
    normals = np.cross(along_h, along_w, axis=0)
    length = np.linalg.norm(normals, axis=0, keepdims=True)
    return normals / np.maximum(length, 1e-12)


def depth_to_absolute_coordinates(depth, depth_type, K, shift=0.5):
    """Unproject a depth map through K into a (3, H, W) point cloud
    (new_metrics.py:48-68; the eval convention is "orthogonal": z = depth)."""
    h, w = depth.shape[-2:]
    K = np.asarray(K, dtype=np.float64)
    cols = np.arange(w, dtype=np.float64) + shift
    rows = np.arange(h, dtype=np.float64) + shift
    homog = np.stack([np.broadcast_to(cols[None, :], (h, w)),
                      np.broadcast_to(rows[:, None], (h, w)),
                      np.ones((h, w))], axis=0)
    rays = np.tensordot(np.linalg.inv(K), homog, axes=1)
    if depth_type == "orthogonal":
        return rays / rays[2:3] * depth
    if depth_type == "perspective":
        return rays / np.linalg.norm(rays, axis=0, keepdims=True) * depth
    raise ValueError(f"Unknown type {depth_type}")


def fspecial_gauss(size, sigma):
    x, y = np.mgrid[-size // 2 + 1: size // 2 + 1, -size // 2 + 1: size // 2 + 1]
    g = np.exp(-((x ** 2 + y ** 2) / (2.0 * sigma ** 2)))
    return g / g.sum()


def _ssim(img1, img2, L=1):
    """scipy fftconvolve SSIM (new_metrics.py:86-111)."""
    window = fspecial_gauss(11, 1.5)
    C1, C2 = (0.01 * L) ** 2, (0.03 * L) ** 2
    mu1 = signal.fftconvolve(window, img1, mode="valid")
    mu2 = signal.fftconvolve(window, img2, mode="valid")
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = signal.fftconvolve(window, img1 * img1, mode="valid") - mu1_sq
    s2 = signal.fftconvolve(window, img2 * img2, mode="valid") - mu2_sq
    s12 = signal.fftconvolve(window, img1 * img2, mode="valid") - mu1_mu2
    return np.mean(((2 * mu1_mu2 + C1) * (2 * s12 + C2))
                   / ((mu1_sq + mu2_sq + C1) * (s1 + s2 + C2)))


def _mse(pred, target):
    return np.mean(np.square(target - pred))


def _psnr(pred, target, max_value=1):
    mse = _mse(pred, target)
    if mse == 0:
        raise NotImplementedError("Same img")
    return 20.0 * np.log10(max_value) - 10 * np.log10(mse)


def calc_rmse(pred, target, hole_map, target_hole_map, K, max_depth):
    return float(np.sqrt(_mse(pred[~target_hole_map], target[~target_hole_map])))


def calc_mae(pred, target, hole_map, target_hole_map, K, max_depth):
    return float(np.mean(np.abs(target[~target_hole_map] - pred[~target_hole_map])))


def calc_psnr(pred, target, hole_map, target_hole_map, K, max_depth):
    return float(_psnr(pred[~target_hole_map] / max_depth, target[~target_hole_map] / max_depth))


def calc_ssim(pred, target, hole_map, target_hole_map, K, max_depth):
    return float(_ssim(~target_hole_map * pred / max_depth,
                       ~target_hole_map * target / max_depth))


def calc_mae_h(pred, target, hole_map, target_hole_map, K, max_depth):
    sel = ~target_hole_map * hole_map
    return float(np.mean(np.abs(pred[sel] - target[sel]))) if np.any(sel) else np.nan


def calc_rmse_h(pred, target, hole_map, target_hole_map, K, max_depth):
    sel = ~target_hole_map * hole_map
    return float(np.sqrt(np.mean(np.square(pred[sel] - target[sel])))) if np.any(sel) else np.nan


def calc_mae_d(pred, target, hole_map, target_hole_map, K, max_depth):
    union = hole_map + target_hole_map
    return float(np.mean(np.abs(pred[~union] - target[~union]))) if not np.all(union) else np.nan


def calc_rmse_d(pred, target, hole_map, target_hole_map, K, max_depth):
    union = hole_map + target_hole_map
    if np.all(union):
        return np.nan
    return float(np.sqrt(np.mean(np.square(pred[~union] - target[~union]))))


def calc_msev(pred, target, hole_map, target_hole_map, K, max_depth,
              depth_type="orthogonal", shift=0.5):
    target_n = coords_to_normals(depth_to_absolute_coordinates(target, depth_type, K, shift))
    pred_n = coords_to_normals(depth_to_absolute_coordinates(pred, depth_type, K, shift))
    t = target_hole_map.copy()
    t[:, 1:] += target_hole_map[:, :-1]
    t[:, :-1] += target_hole_map[:, 1:]
    t[1:, :] += target_hole_map[:-1, :]
    t[:-1, :] += target_hole_map[1:, :]
    t = np.broadcast_to(t, pred_n.shape)
    return float(_mse(pred_n[~t], target_n[~t]))


METRIC_BY_NAME = {
    "mae": calc_mae, "rmse": calc_rmse, "psnr": calc_psnr, "ssim": calc_ssim,
    "rmse_h": calc_rmse_h, "rmse_d": calc_rmse_d, "mae_h": calc_mae_h,
    "mae_d": calc_mae_d, "mse_v": calc_msev,
}

DEFAULT_METRICS = ["rmse", "mae", "rmse_h", "rmse_d", "psnr", "ssim", "mae_h", "mae_d", "mse_v"]


def calc_metrics(pred, target, hole_map, target_hole_map, K, max_depth, metric_names):
    return {name: METRIC_BY_NAME[name](pred, target, hole_map, target_hole_map, K, max_depth)
            for name in metric_names}


def calc_metrics_for_path(path_args, metric_names, max_depth):
    input_path, pred_path, target_path, intrinsic_path = path_args
    input_orig = read_png(input_path).astype(np.float64)
    pred = read_png(pred_path).astype(np.float64).clip(0, max_depth)
    target = read_png(target_path).astype(np.float64).clip(0, max_depth)
    h_pred, _ = pred.shape
    h_target, _ = target.shape
    if 2 * h_pred == h_target:  # SR rule (new_metrics.py:224-225)
        target = target[0::2, 0::2]
    input_orig = resize_linear(input_orig, target.shape)
    hole_map = input_orig < HOLES_THRESHOLD
    target_hole_map = target < HOLES_THRESHOLD
    K = np.loadtxt(intrinsic_path)[:3, :3] if intrinsic_path is not None else None
    return calc_metrics(pred, target, hole_map, target_hole_map, K, max_depth, metric_names)


def calculate_given_paths(input_names, pred_names, target_names, metric_names,
                          max_depth, n_cpus, intr_root=None):
    if intr_root:
        intrinsic_names = [
            os.path.join(intr_root, filter_basename(n)[:12], "intrinsic", "intrinsic_depth.txt")
            for n in input_names]
    else:
        intrinsic_names = [None] * len(input_names)
        metric_names = [m for m in metric_names if m != "mse_v"]
    fn = functools.partial(calc_metrics_for_path, metric_names=metric_names, max_depth=max_depth)
    paths = list(zip(input_names, pred_names, target_names, intrinsic_names))
    if n_cpus > 1:
        with multiprocessing.get_context("spawn").Pool(n_cpus) as p:
            res = list(p.imap(fn, paths))
    else:
        res = [fn(p) for p in paths]
    out = {}
    for name in metric_names:
        vals = np.asarray([r[name] for r in res])
        out[name] = float(np.mean(vals[~np.isnan(vals)]))
    return out


def main(argv=None):
    from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser

    parser = ArgumentParser(prog="python -m desr_tpu_torch.metrics",
                            formatter_class=ArgumentDefaultsHelpFormatter)
    parser.add_argument("--input_path", type=str, required=True)
    parser.add_argument("--pred_path", type=str, required=True)
    parser.add_argument("--target_path", type=str, required=True)
    parser.add_argument("--max_depth", type=int, default=5100)
    parser.add_argument("--n_cpus", type=int, default=10)
    parser.add_argument("--intr_root", type=str, default=None,
                        help="ScanNet intrinsics root (omit to skip mse_v)")
    args = parser.parse_args(argv)
    input_names = sorted(glob(os.path.join(args.input_path, "*.png")))
    pred_names = sorted(glob(os.path.join(args.pred_path, "*.png")))
    target_names = sorted(glob(os.path.join(args.target_path, "*.png")))
    print(len(input_names), len(pred_names), len(target_names))
    out = calculate_given_paths(input_names, pred_names, target_names,
                                DEFAULT_METRICS, args.max_depth, args.n_cpus,
                                intr_root=args.intr_root)
    print(out)
    return out


if __name__ == "__main__":
    main()
