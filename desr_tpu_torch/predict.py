"""Serving CLI: enhance (or x2-SR) a folder of RGB-D frames on the GPU, or
serve the stage-1 and stage-2 nets on it.

Counterpart of the repository's ``predict.py`` in its modes main (the
default), ``--SR``, ``--I2D`` and ``--translate AtoB|BtoA``:

- loads ``<epoch>_net_<Net>.pth`` from ``--checkpoints_dir/--name`` through
  the tolerant loader: main and ``--SR`` the stage-3 nets
  ``I2D_features, Image2Depth, Depth_f, Task``; ``--I2D`` ``Image_f, Task``;
  ``--translate`` ``G_A, G_B``;
- reads ``--input_depth`` / ``--input_img`` (uint16-mm depth and RGB PNGs),
  reflect-pads each frame to the U-Net's /128 grid (/256 under ``--SR``,
  whose guidance runs at half size), runs the real-branch forward in batches
  of ``--batch_size`` and crops the padding back off. ``--SR`` predicts
  ``pred_real_depth_hr`` on the input grid, so the pad offsets map 1:1 onto
  it (predict.py:280-286); its LR grid is half the first frame's padded size
  unless ``--net_args`` names ``--crop_size_h/_w`` (predict.py:226-236).
  ``--I2D`` predicts depth from the image alone: ``--input_depth`` may be
  left out, and the output names then come from the images. ``--translate``
  writes ``fake_depth_B`` = G_A(depth, image) (AtoB) or ``fake_depth_A`` =
  G_B(depth, image) (BtoA), G_B(depth) under ``--net_args --inp_B depth``
  (predict.py:241-263);
- writes ``<stem>.png``, ``clip((p + 1) / 2)`` as x5100 uint16 PNGs.

Usage:
    python -m desr_tpu_torch.predict --name <exp> --checkpoints_dir checkpoints \
        --input_depth .../depth --input_img .../img --output out/ \
        [--SR | --I2D | --translate AtoB] [--batch_size 8] [--compute_dtype bfloat16] \
        [--device cuda] [--net_args --Task_basef 64 ...]

``--export`` and ``--from_export`` are not yet ported and exit with an error.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
NOT_PORTED = ("export", "from_export")


def pad_to_multiple(arr, mult, axes=(0, 1)):
    """Reflect-pad ``axes`` up to a multiple of ``mult``, split top/bottom (predict.py:37-43)."""
    pads = [(0, 0)] * arr.ndim
    for ax in axes:
        target = -(-arr.shape[ax] // mult) * mult
        extra = target - arr.shape[ax]
        pads[ax] = (extra // 2, extra - extra // 2)
    return np.pad(arr, pads, mode="reflect"), pads


def parse_net_args(argv):
    """The net-width flags of TrainOptions -> NetOptions (unknown flags error)."""
    from desr_tpu_torch.models.main_model import NetOptions

    p = argparse.ArgumentParser(prog="--net_args")
    for f in NetOptions.__dataclass_fields__.values():
        if f.type in (bool, "bool"):
            p.add_argument(f"--{f.name}", action="store_true")
        else:
            typ = {"int": int, "float": float, "str": str}.get(f.type, f.type)
            p.add_argument(f"--{f.name}", type=typ, default=f.default)
    return NetOptions(**vars(p.parse_args(argv)))


def decode_frame(depth_path, img_path, max_distance, mult=128):
    """(depth [H, W, 1], image [H, W, 3], pads) normalised and padded to
    /mult; with no ``depth_path`` (``--I2D``) the depth is zeros."""
    from desr_tpu_torch.data.base_dataset import load_depth_png, load_image
    from desr_tpu_torch.data.transforms import normalize_depth_np, normalize_image_np

    im = normalize_image_np(load_image(img_path)[..., :3].astype(np.float32))
    if depth_path is None:
        d = np.zeros(im.shape[:2], np.float32)
    else:
        d = normalize_depth_np(load_depth_png(depth_path), max_distance)
    d, pads = pad_to_multiple(d, mult)
    im, _ = pad_to_multiple(im, mult)
    return d[..., None], im, pads


def _to_host(t):
    """(host tensor, CUDA event that marks it filled, or None on the CPU)."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    return host, ready


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m desr_tpu_torch.predict")
    parser.add_argument("--name", required=True, help="experiment name under --checkpoints_dir")
    parser.add_argument("--checkpoints_dir", default="./checkpoints")
    parser.add_argument("--epoch", default="latest")
    parser.add_argument("--input_depth", default=None,
                        help="depth frames folder (required except --I2D, which predicts "
                             "from the image alone)")
    parser.add_argument("--input_img", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--batch_size", type=int, default=8, help="frames per forward")
    parser.add_argument("--max_distance", type=float, default=5100.0)
    parser.add_argument("--compute_dtype", default="bfloat16", choices=sorted(DTYPES))
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; without a GPU, cpu must be asked for")
    parser.add_argument("--SR", action="store_true",
                        help="serve the x2 SR model (MainSRModel): frames padded to /256")
    parser.add_argument("--I2D", action="store_true",
                        help="serve the stage-1 nets (Image_f, Task): depth from RGB alone")
    parser.add_argument("--translate", default=None, choices=["AtoB", "BtoA"],
                        help="serve a stage-2 translator: AtoB applies G_A, BtoA G_B")
    for flag in NOT_PORTED:
        parser.add_argument(f"--{flag}", default=None, nargs="?", const=True,
                            help="not yet ported")
    parser.add_argument("--net_args", nargs=argparse.REMAINDER, default=[],
                        help="net-width flags (--Task_basef 64 ...; see NetOptions)")
    args = parser.parse_args(argv)
    for flag in NOT_PORTED:
        if getattr(args, flag) is not None:
            parser.error(f"--{flag} is not yet ported to desr_tpu_torch "
                         "(serve it with the JAX predict.py)")
    if args.I2D and args.SR:
        parser.error("--I2D is a standalone mode (no --SR)")
    if args.translate and (args.SR or args.I2D):
        parser.error("--translate is a standalone mode (no --SR/--I2D)")
    if args.input_depth is None and not args.I2D:
        parser.error("--input_depth is required (omit only with --I2D)")

    from desr_tpu_torch import resolve_device
    from desr_tpu_torch.data.base_dataset import load_depth_png
    from desr_tpu_torch.models.i2d_model import I2DModel
    from desr_tpu_torch.models.main_model import MainModel
    from desr_tpu_torch.models.main_sr_model import MainSRModel
    from desr_tpu_torch.models.translation_model import TranslationModel
    from desr_tpu_torch.utils.util import save_uint16_png

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        parser.error(str(e))
    img_paths = sorted(glob.glob(os.path.join(args.input_img, "*")))
    if args.input_depth is None:  # --I2D from RGB alone: stems from the images
        depth_paths = img_paths
    else:
        depth_paths = sorted(glob.glob(os.path.join(args.input_depth, "*")))
    if len(depth_paths) != len(img_paths):
        parser.error(f"depth/img folder size mismatch: {len(depth_paths)} vs {len(img_paths)}")
    mult = 256 if args.SR else 128
    net_args = list(args.net_args)
    if args.SR and "--crop_size_h" not in net_args and depth_paths:
        # the LR grid is half the padded input (predict.py:226-236)
        h, w = load_depth_png(depth_paths[0]).shape[:2]
        net_args += ["--crop_size_h", str(-(-h // mult) * mult // 2),
                     "--crop_size_w", str(-(-w // mult) * mult // 2)]
    kw = dict(device=device, compute_dtype=DTYPES[args.compute_dtype])
    if args.translate:
        model = TranslationModel(parse_net_args(net_args), direction=args.translate, **kw)
    else:
        model_cls = I2DModel if args.I2D else MainSRModel if args.SR else MainModel
        model = model_cls(parse_net_args(net_args), **kw)
    model.load_networks(args.checkpoints_dir, args.name, args.epoch)
    # --I2D reads no depth: the forward does not use it
    read_depth = not args.I2D
    os.makedirs(args.output, exist_ok=True)

    def write(preds, ready, pad_infos, stems):
        if ready is not None:
            ready.synchronize()
        for p, ((t, bpad), (l, rpad)), stem in zip(preds.numpy(), pad_infos, stems):
            p = p[t:p.shape[0] - bpad, l:p.shape[1] - rpad]
            save_uint16_png(np.clip((p + 1) / 2, 0, 1), os.path.join(args.output, f"{stem}.png"))

    # one batch in flight: batch i is decoded while the device runs batch
    # i-1, and batch i-1's PNGs are written while the device runs batch i.
    # Each result is copied to pinned host memory right behind its forward,
    # so waiting for it never waits for the forward queued after it.
    pending = None
    for i in range(0, len(depth_paths), args.batch_size):
        pairs = list(zip(depth_paths[i:i + args.batch_size], img_paths[i:i + args.batch_size]))
        frames = [decode_frame(dp if read_depth else None, ip, args.max_distance, mult)
                  for dp, ip in pairs]
        batch = {"B_d": np.stack([f[0] for f in frames]), "B_i": np.stack([f[1] for f in frames])}
        stems = [os.path.splitext(os.path.basename(dp))[0] for dp, _ in pairs]
        preds = model.serve_forward(batch)
        if pending is not None:
            write(*pending)
        pending = (*_to_host(preds), [f[2] for f in frames], stems)
        print(f"{min(i + args.batch_size, len(depth_paths))}/{len(depth_paths)} frames",
              file=sys.stderr)
    if pending is not None:
        write(*pending)
    print(f"wrote {len(depth_paths)} predictions to {args.output}")
    return len(depth_paths)


if __name__ == "__main__":
    main()
