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
- writes ``<stem>.png``, ``clip((p + 1) / 2)`` as x5100 uint16 PNGs;
- ``--num_workers N`` (N > 1) starts a pool of N spawned host processes
  before the card is touched: PNG decode, normalisation and padding run
  there, 2 batches ahead of the card, and so do the PNG writes, at most
  2N in flight (predict.py:143-151,336-371). The workers import numpy and
  the PNG codec, not torch.

Deployment (``desr_tpu_torch/serving.py``; main and ``--SR``):
``--export DIR`` traces the serving forward at the first batch's padded
geometry and the model's dtype and writes the artifact (``serving.pt2``,
``params.npz``, ``manifest.json``) instead of predicting;
``--from_export DIR`` serves such an artifact without ``--name``, the model
classes or the ``.pth`` files: at its batch size (the tail batch padded,
the extras not written) and its geometry (a larger frame is refused).

Usage:
    python -m desr_tpu_torch.predict --name <exp> --checkpoints_dir checkpoints \
        --input_depth .../depth --input_img .../img --output out/ \
        [--SR | --I2D | --translate AtoB] [--batch_size 8] [--compute_dtype bfloat16] \
        [--num_workers 4] [--export DIR | --from_export DIR] [--device cuda] \
        [--net_args --Task_basef 64 ...]

``--num_devices`` and ``--spatial_devices`` are not yet ported and exit with
an error.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import sys

import numpy as np

from desr_tpu_torch.utils.util import save_uint16_png

# torch is imported in main: the --num_workers pool's spawned workers import
# this module for decode_frame and save_uint16_png alone
DTYPES = ("bfloat16", "float32")
NOT_PORTED = ("num_devices", "spatial_devices")


def pad_to_shape(arr, hw):
    """Reflect-pad axes 0 and 1 up to ``hw``, split top/bottom
    (predict.py:37-43); a frame larger than ``hw`` (an artifact's geometry)
    raises (predict.py:64-80)."""
    pads = [(0, 0)] * arr.ndim
    for ax, target in enumerate(hw):
        extra = target - arr.shape[ax]
        if extra < 0:
            raise ValueError(
                f"frame {arr.shape[:2]} exceeds the exported geometry "
                f"({hw[0]}x{hw[1]}); re-export for this size")
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


def decode_frame(depth_path, img_path, max_distance, mult=128, shape=None):
    """(depth [H, W, 1], image [H, W, 3], pads) normalised and padded to
    /mult, or to ``shape`` (an artifact's (H, W)) when given; with no
    ``depth_path`` (``--I2D``) the depth is zeros."""
    from desr_tpu_torch.data.base_dataset import load_depth_png, load_image
    from desr_tpu_torch.data.transforms import normalize_depth_np, normalize_image_np

    im = normalize_image_np(load_image(img_path)[..., :3].astype(np.float32))
    if depth_path is None:
        d = np.zeros(im.shape[:2], np.float32)
    else:
        d = normalize_depth_np(load_depth_png(depth_path), max_distance)
    if shape is None:  # the /mult grid
        shape = [-(-n // mult) * mult for n in d.shape]
    d, pads = pad_to_shape(d, shape)
    im, _ = pad_to_shape(im, shape)
    return d[..., None], im, pads


def _to_host(t):
    """(host tensor, CUDA event that marks it filled, or None on the CPU)."""
    import torch

    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    return host, ready


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m desr_tpu_torch.predict")
    parser.add_argument("--name", default=None,
                        help="experiment name under --checkpoints_dir "
                             "(required unless --from_export)")
    parser.add_argument("--checkpoints_dir", default="./checkpoints")
    parser.add_argument("--epoch", default="latest")
    parser.add_argument("--input_depth", default=None,
                        help="depth frames folder (required except --I2D, which predicts "
                             "from the image alone)")
    parser.add_argument("--input_img", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--batch_size", type=int, default=8, help="frames per forward")
    parser.add_argument("--max_distance", type=float, default=5100.0)
    parser.add_argument("--num_workers", type=int, default=0,
                        help="spawn this many host workers (> 1): PNG decode, normalise "
                             "and pad and the uint16 PNG writes run in the pool, 2 "
                             "batches decoded ahead of the card; 0 or 1: inline")
    parser.add_argument("--compute_dtype", default="bfloat16", choices=DTYPES)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; without a GPU, cpu must be asked for")
    parser.add_argument("--SR", action="store_true",
                        help="serve the x2 SR model (MainSRModel): frames padded to /256")
    parser.add_argument("--I2D", action="store_true",
                        help="serve the stage-1 nets (Image_f, Task): depth from RGB alone")
    parser.add_argument("--translate", default=None, choices=["AtoB", "BtoA"],
                        help="serve a stage-2 translator: AtoB applies G_A, BtoA G_B")
    parser.add_argument("--export", default=None, metavar="DIR",
                        help="export the serving forward and weights at the first batch's "
                             "geometry to DIR (a torch.export artifact; see "
                             "desr_tpu_torch/serving.py) instead of predicting")
    parser.add_argument("--from_export", default=None, metavar="DIR",
                        help="serve from an exported artifact: no model classes, options "
                             "or .pth files, just the saved program and params.npz")
    for flag in NOT_PORTED:
        parser.add_argument(f"--{flag}", default=None, type=int, help="not yet ported")
    parser.add_argument("--net_args", nargs=argparse.REMAINDER, default=[],
                        help="net-width flags (--Task_basef 64 ...; see NetOptions)")
    args = parser.parse_args(argv)
    for flag in NOT_PORTED:
        if getattr(args, flag) is not None:
            parser.error(f"--{flag} is not yet ported to desr_tpu_torch "
                         "(serve it with the JAX predict.py)")
    if args.name is None and not args.from_export:
        parser.error("--name is required unless serving --from_export")
    if args.export and args.from_export:
        parser.error("--export and --from_export exclude each other")
    if args.I2D and (args.SR or args.export or args.from_export):
        parser.error("--I2D is a standalone mode (no --SR/--export/--from_export)")
    if args.translate and (args.SR or args.I2D or args.export or args.from_export):
        parser.error("--translate is a standalone mode (no --SR/--I2D/--export/--from_export)")
    if args.input_depth is None and not args.I2D:
        parser.error("--input_depth is required (omit only with --I2D)")

    from desr_tpu_torch.data import native_io

    # builds the decode library here, before any worker is spawned
    print("image decode route: %s (%s)" % native_io.route())
    pool = None
    if args.num_workers > 1:
        # before torch touches the card; spawned, so no CUDA state is inherited
        import multiprocessing

        pool = multiprocessing.get_context("spawn").Pool(args.num_workers)
    try:
        return _serve(args, parser, pool)
    finally:
        if pool is not None:
            pool.terminate()
            pool.join()


def _serve(args, parser, pool):
    import torch

    from desr_tpu_torch import resolve_device
    from desr_tpu_torch.data.base_dataset import load_depth_png

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

    shape = None
    if args.from_export:
        from desr_tpu_torch.serving import load_serving

        try:
            exp_fn, exp_params, manifest = load_serving(args.from_export, device)
        except (RuntimeError, ValueError) as e:
            parser.error(str(e))
        args.SR = manifest["sr"]
        exp_b, exp_h, exp_w = manifest["batch"]["B_d"][0][:3]
        shape = (exp_h, exp_w)
        if args.batch_size != exp_b:
            print(f"[from_export] batch_size -> {exp_b} (artifact geometry)", file=sys.stderr)
            args.batch_size = exp_b

        def run(batch):
            return exp_fn(exp_params, batch, 0)
    else:
        from desr_tpu_torch.models.i2d_model import I2DModel
        from desr_tpu_torch.models.main_model import MainModel
        from desr_tpu_torch.models.main_sr_model import MainSRModel
        from desr_tpu_torch.models.translation_model import TranslationModel

        net_args = list(args.net_args)
        if args.SR and "--crop_size_h" not in net_args and depth_paths:
            # the LR grid is half the input padded to /256 (predict.py:226-236)
            h, w = load_depth_png(depth_paths[0]).shape[:2]
            net_args += ["--crop_size_h", str(-(-h // 256) * 128),
                         "--crop_size_w", str(-(-w // 256) * 128)]
        kw = dict(device=device, compute_dtype=getattr(torch, args.compute_dtype))
        if args.translate:
            model = TranslationModel(parse_net_args(net_args), direction=args.translate, **kw)
        else:
            model_cls = I2DModel if args.I2D else MainSRModel if args.SR else MainModel
            model = model_cls(parse_net_args(net_args), **kw)
        model.load_networks(args.checkpoints_dir, args.name, args.epoch)
        run = model.serve_forward
    mult = 256 if args.SR else 128  # the padding of a live batch
    # --I2D reads no depth: the forward does not use it
    read_depth = not args.I2D

    def pairs(i):
        return [(dp if read_depth else None, ip, args.max_distance, mult, shape)
                for dp, ip in zip(depth_paths[i:i + args.batch_size],
                                  img_paths[i:i + args.batch_size])]

    def assemble(frames, i):
        stems = [os.path.splitext(os.path.basename(dp))[0]
                 for dp in depth_paths[i:i + args.batch_size]]
        pads = [f[2] for f in frames]
        # an artifact's batch size is frozen: the tail batch repeats its last
        # frame, whose extra predictions are not written
        frames = frames + frames[-1:] * (args.batch_size - len(frames) if shape else 0)
        batch = {"B_d": np.stack([f[0] for f in frames]), "B_i": np.stack([f[1] for f in frames])}
        return batch, pads, stems

    def batches():
        starts = range(0, len(depth_paths), args.batch_size)
        if pool is None:
            for i in starts:
                yield assemble([decode_frame(*p) for p in pairs(i)], i)
            return
        ahead = collections.deque()  # 2 batches decoding ahead of the card
        for i in starts:
            ahead.append((pool.starmap_async(decode_frame, pairs(i)), i))
            if len(ahead) > 2:
                fut, j = ahead.popleft()
                yield assemble(fut.get(), j)
        while ahead:
            fut, j = ahead.popleft()
            yield assemble(fut.get(), j)

    if args.export:
        from desr_tpu_torch.serving import export_serving

        batch, _, _ = next(batches())
        manifest = export_serving(
            model, batch, args.export, model._dump_key,
            provenance={"name": args.name, "epoch": str(args.epoch),
                        "net_args": list(args.net_args)})
        print(f"exported serving artifact to {args.export}: {json.dumps(manifest['batch'])}")
        return manifest

    os.makedirs(args.output, exist_ok=True)
    writes = collections.deque()

    def save(out01, path):
        if pool is None:
            save_uint16_png(out01, path)
            return
        # at most 2 writes a worker in flight: wait on the oldest rather
        # than queue full-resolution frames without bound
        while len(writes) >= 2 * args.num_workers:
            writes.popleft().get()
        writes.append(pool.apply_async(save_uint16_png, (out01, path)))

    def write(preds, ready, pad_infos, stems):
        if ready is not None:
            ready.synchronize()
        for p, ((t, bpad), (l, rpad)), stem in zip(preds.numpy(), pad_infos, stems):
            p = p[t:p.shape[0] - bpad, l:p.shape[1] - rpad]
            save(np.clip((p + 1) / 2, 0, 1), os.path.join(args.output, f"{stem}.png"))

    # one batch in flight: batch i is decoded while the device runs batch
    # i-1, and batch i-1's PNGs are written while the device runs batch i.
    # Each result is copied to pinned host memory right behind its forward,
    # so waiting for it never waits for the forward queued after it.
    pending = None
    n_done = 0
    for batch, pad_infos, stems in batches():
        preds = run(batch)
        if pending is not None:
            write(*pending)
        pending = (*_to_host(preds), pad_infos, stems)
        n_done += len(stems)
        print(f"{n_done}/{len(depth_paths)} frames", file=sys.stderr)
    if pending is not None:
        write(*pending)
    while writes:
        writes.popleft().get()  # surface a worker's write error
    print(f"wrote {len(depth_paths)} predictions to {args.output}")
    return len(depth_paths)


if __name__ == "__main__":
    main()
