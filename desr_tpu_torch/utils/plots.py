"""wandb matplotlib panels (counterpart of ``desr_tpu/utils/plots.py``).

``plot_main`` (a 5-column grid of syn/real images, depths, masks and
normals, RdYlBu colormap), ``plot_I2D`` (3 columns) and ``plot_translation``
(4 columns and a row of mid-row depth profiles in meters). They take the
port's visuals (``utils/visualizer.py:image_hwc`` reads their layouts) and
log one figure to ``wandb``. Each returns None, doing nothing, when
matplotlib cannot be imported (the card's machine has none).
"""

from __future__ import annotations

import numpy as np

from desr_tpu_torch.utils.visualizer import image_hwc


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


def tensor2im_depth(arr, max_distance=5100.0):
    """[-1, 1] depth -> meters for display (plots.py:183-201)."""
    return (arr * (max_distance / 2) + max_distance / 2) / 1000.0


def _show(ax, image, depth_cmap):
    arr = image_hwc(image)
    if arr is None:
        return
    if arr.shape[-1] == 3:
        ax.imshow(np.clip((arr + 1) / 2, 0, 1))
    else:
        ax.imshow(tensor2im_depth(arr[..., 0]), cmap=depth_cmap)


def _figure(plt, n, ncols, extra_rows=0):
    nrows = (n + ncols - 1) // ncols + extra_rows
    fig, axes = plt.subplots(nrows, ncols, figsize=(4 * ncols, 3 * nrows), squeeze=False)
    for ax in axes.ravel():
        ax.axis("off")
    return fig, axes


def _grid(wandb, image_dict, step, keys, ncols, title, stage, depth_cmap="RdYlBu"):
    plt = _plt()
    if plt is None:
        return None
    keys = [k for k in keys if k in image_dict]
    fig, axes = _figure(plt, len(keys), ncols)
    for i, k in enumerate(keys):
        ax = axes[i // ncols][i % ncols]
        _show(ax, image_dict[k], depth_cmap)
        ax.set_title(k)
    if wandb is not None:
        wandb.log({f"{stage}/{title}": wandb.Image(fig)}, step=step)
    plt.close(fig)
    return fig


def plot_main(wandb, image_dict, step, depth=False, stage="train"):
    keys = ["syn_image", "syn_depth", "syn2real_depth", "syn_mask", "pred_syn_depth",
            "mask_syn_add_holes", "syn_depth_by_image", "real_image", "real_depth",
            "real_depth_by_image", "pred_real_depth", "real_mask", "depth_masked",
            "syn2real_depth_masked", "norm_syn", "norm_syn_pred", "norm_real",
            "norm_real_pred", "norm_syn2real"]
    return _grid(wandb, image_dict, step, keys, 5, "main", stage)


def plot_I2D(wandb, image_dict, step, depth=False, stage="train"):
    keys = ["syn_image", "syn_depth", "pred_syn_depth",
            "real_image", "real_depth", "pred_real_depth"]
    return _grid(wandb, image_dict, step, keys, 3, "I2D", stage)


def plot_translation(wandb, image_dict, step, depth=False, stage="train"):
    """The translation grid and a row of mid-row depth profiles (meters) of
    real, fake and rec per domain (plots.py:203-280)."""
    plt = _plt()
    if plt is None:
        return None
    keys = ["real_img_A", "real_depth_A", "fake_depth_B", "rec_depth_A",
            "real_img_B", "real_depth_B", "fake_depth_A", "rec_depth_B"]
    keys = [k for k in keys if k in image_dict]
    ncols = 4
    fig, axes = _figure(plt, len(keys), ncols, extra_rows=1)
    for i, k in enumerate(keys):
        ax = axes[i // ncols][i % ncols]
        _show(ax, image_dict[k], "RdYlBu")
        ax.set_title(k)
    for col, group in enumerate([("real_depth_A", "fake_depth_B", "rec_depth_A"),
                                 ("real_depth_B", "fake_depth_A", "rec_depth_B")]):
        ax = axes[-1][col]
        ax.axis("on")
        for k in group:
            if k in image_dict:
                d = tensor2im_depth(image_hwc(image_dict[k])[..., 0])
                ax.plot(d[d.shape[0] // 2, :], label=k, linewidth=0.8)
        ax.set_title("mid-row depth (m)")
        ax.legend(fontsize=6)
    if wandb is not None:
        wandb.log({f"{stage}/translation": wandb.Image(fig)}, step=step)
    plt.close(fig)
    return fig
