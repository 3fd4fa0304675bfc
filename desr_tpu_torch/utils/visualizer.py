"""Console and ``loss_log.txt`` logging and the HTML gallery (counterpart of
``desr_tpu/utils/visualizer.py``).

The gallery lands in ``<checkpoints_dir>/<name>/web``: one PNG a visual,
``images/epoch%03d_<label>.png``, and an ``index.html`` over the last epoch's
labels, with the JAX package's names and HTML. The visuals are the port's
tensors or arrays: planar (B, H, W) depth maps and masks, NCHW or NHWC images
and normals, any float dtype; the first sample of each is written, as
``tensor2im`` maps [-1, 1] to uint8.
"""

from __future__ import annotations

import os
import time

from desr_tpu_torch.utils.util import save_image, tensor2im, to_numpy


def image_hwc(image):
    """The first sample of a visual as an (H, W, 1|3) array, or None when it
    is no image (visualizer.py:45-57): (B, H, W, C) and (B, C, H, W) batches,
    planar (C, H, W) normals and (B, H, W) depth batches, (H, W) maps."""
    arr = to_numpy(image)
    if arr.ndim == 4:
        arr = arr[0]
    if arr.ndim == 3 and arr.shape[0] == 3 and arr.shape[-1] not in (1, 3):
        arr = arr.transpose(1, 2, 0)  # planar (C, H, W) normals
    elif arr.ndim == 3 and arr.shape[-1] not in (1, 3):
        arr = arr[0]  # planar (B, H, W) depth batch
    if arr.ndim == 2:
        arr = arr[..., None]  # planar (H, W) depth map
    if arr.ndim != 3 or arr.shape[-1] not in (1, 3):
        return None
    return arr


class Visualizer:
    def __init__(self, opt):
        self.opt = opt
        self.name = opt.name
        self.saved = False
        self.web_dir = os.path.join(opt.checkpoints_dir, opt.name, "web")
        self.img_dir = os.path.join(self.web_dir, "images")
        os.makedirs(self.img_dir, exist_ok=True)
        self.log_name = os.path.join(opt.checkpoints_dir, opt.name, "loss_log.txt")
        with open(self.log_name, "a") as log_file:
            now = time.strftime("%c")
            log_file.write(f"================ Training Loss ({now}) ================\n")

    def reset(self):
        self.saved = False

    def print_current_losses(self, epoch, iters, losses, t_comp, t_data):
        """Console + loss_log.txt (util/visualizer.py:204-222)."""
        message = "(epoch: %d, iters: %d, time: %.3f, data: %.3f) " % (epoch, iters, t_comp, t_data)
        for k, v in losses.items():
            message += "%s: %.3f " % (k, v)
        print(message)
        with open(self.log_name, "a") as log_file:
            log_file.write(f"{message}\n")

    def display_current_results(self, visuals, epoch, save_result=True):
        """Save each visual that is an image into the gallery and rewrite its
        index (util/visualizer.py:157-175)."""
        for label, image in visuals.items():
            arr = image_hwc(image)
            if arr is None:
                continue
            save_image(tensor2im(arr), os.path.join(self.img_dir, f"epoch{epoch:03d}_{label}.png"))
        self._write_index(epoch, list(visuals.keys()))

    def _write_index(self, epoch, labels):
        rows = "".join(
            f'<td><p>{l}</p><img src="images/epoch{epoch:03d}_{l}.png" width="256"></td>'
            for l in labels)
        html = f"<html><body><h3>epoch {epoch}</h3><table><tr>{rows}</tr></table></body></html>"
        with open(os.path.join(self.web_dir, "index.html"), "w") as f:
            f.write(html)

    def save_images(self, visuals, image_path):
        """``images/<stem of image_path>_<label>.png`` for each visual that is
        an image."""
        short = os.path.splitext(os.path.basename(str(image_path)))[0]
        for label, im_data in visuals.items():
            arr = image_hwc(im_data)
            if arr is not None:
                save_image(tensor2im(arr), os.path.join(self.img_dir, f"{short}_{label}.png"))
