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

``--num_devices N`` (0: every visible card; under ``--device cpu`` N CPU
replicas, 0: one) serves live on N cards from one process: a replica of the
serving forward a card, each request's batch split into N contiguous shards
(when N does not divide it, the first card serves it whole, where the JAX
mesh replicates it), each shard launched on its card and the predictions
gathered in order (predict.py:269). ``--export`` records one device, as the
JAX CLI forces (predict.py:218-219), and ``--from_export`` serves on one.
More devices than the visible cards raise.

``--spatial_devices S`` (S > 1; every live mode) makes the N ranks of
``--num_devices`` a mesh of N / S data groups by S spatial ranks, as the JAX
CLI's mesh (predict.py:156,217): N processes (``parallel.launch``; NCCL on
cards, gloo under ``--device cpu``), each decoding the frames of its data
group's share of a batch and serving its band of each frame's rows, with
halo rows from its neighbours (``desr_tpu_torch/parallel/spatial.py``). The
predictions are gathered to rank 0, which alone writes the PNGs; the other
ranks print nothing. A frame that S does not divide (padding to /128
divides it for S = 2 or 4) is served whole on every rank, as in JAX. N must
divide by S; ``--export`` and ``--from_export`` are refused with it. With
``--num_workers`` N (> 1) each rank starts its own pool of N spawned
workers, which decodes its data group's frames 2 batches ahead; rank 0's
pool also writes the PNGs, at most 2N in flight. Every rank closes its pool
before its process group ends.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import glob
import json
import os
import sys

import numpy as np

from desr_tpu_torch.utils.util import save_uint16_png

# torch is imported in main: the --num_workers pool's spawned workers import
# this module for decode_frame and save_uint16_png alone
DTYPES = ("bfloat16", "float32")


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


def _parse(argv):
    """(args, parser) of the CLI, the flags' combinations checked."""
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
    parser.add_argument("--num_devices", type=int, default=0,
                        help="serve on this many cards, one replica a card, each batch split "
                             "over them (0: every visible card; --device cpu: CPU replicas, "
                             "0: one); --export and --from_export use one")
    parser.add_argument("--spatial_devices", type=int, default=1,
                        help="the image-H axis of the mesh: each frame's rows split over "
                             "this many of the --num_devices ranks, one process a rank "
                             "(--num_devices must divide by it)")
    parser.add_argument("--net_args", nargs=argparse.REMAINDER, default=[],
                        help="net-width flags (--Task_basef 64 ...; see NetOptions)")
    args = parser.parse_args(argv)
    if args.spatial_devices < 1:
        parser.error("--spatial_devices must be at least 1")
    if args.spatial_devices > 1 and (args.export or args.from_export):
        parser.error("--export and --from_export run on one device (as the JAX CLI forces): "
                     "not with --spatial_devices > 1")
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
    return args, parser


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args, parser = _parse(argv)
    from desr_tpu_torch.data import native_io

    # builds the decode library here, before any worker or rank is spawned
    print("image decode route: %s (%s)" % native_io.route())
    if args.spatial_devices > 1:
        from desr_tpu_torch.parallel import resolve_devices

        try:
            devices = resolve_devices(args.device, args.num_devices)
        except (RuntimeError, ValueError) as e:
            parser.error(str(e))
        if len(devices) % args.spatial_devices:
            parser.error(f"--num_devices {len(devices)} does not divide by --spatial_devices "
                         f"{args.spatial_devices}")
        return serve_ranks(argv, devices)
    with _worker_pool(args.num_workers) as pool:
        return _serve(args, parser, pool)


@contextlib.contextmanager
def _worker_pool(n):
    """A pool of ``n`` spawned host workers (None for ``n`` <= 1), ended on
    exit: spawned, so no CUDA state is inherited; a rank ends its pool
    before its process group, as a pool left beside gloo ranks keeps the
    process from exiting."""
    if n <= 1:
        yield None
        return
    import multiprocessing

    pool = multiprocessing.get_context("spawn").Pool(n)
    try:
        yield pool
    finally:
        pool.terminate()
        pool.join()


def serve_ranks(argv, devices, backend=None):
    """The CLI's ``argv`` (``--spatial_devices`` S > 1) served over
    ``len(devices)`` ranks, rank r on ``devices[r]``, joined by ``backend``
    (``parallel.default_backend`` when None; two gloo ranks may share one
    card). Returns rank 0's result: the number of frames written."""
    from desr_tpu_torch import parallel

    args, _ = _parse(argv)
    return parallel.launch(_rank_serve, devices, backend, args=(list(argv),),
                           spatial=args.spatial_devices)[0]


def _rank_serve(mesh, argv):
    """One rank of ``serve_ranks``: ``_serve`` on its device, with its own
    pool under ``--num_workers`` N > 1 (ended before it returns); the ranks
    after 0 print nothing."""
    args, parser = _parse(argv)
    with contextlib.ExitStack() as stack:
        if mesh.rank:
            stack.enter_context(contextlib.redirect_stdout(
                stack.enter_context(open(os.devnull, "w"))))
        pool = stack.enter_context(_worker_pool(args.num_workers))
        return _serve(args, parser, pool, mesh)


def gather_predictions(pred, items, shard, mesh):
    """The global batch's predictions and per-frame ``items`` (a list, one a
    frame of this rank's rows) on every rank of ``mesh``, from each rank's
    ``pred`` (its ``shard``'s rows): one all_gather of the predictions,
    each data group's bands joined along H, the groups along the batch."""
    import torch
    import torch.distributed as dist

    pred = pred.contiguous()
    parts = [torch.empty_like(pred) for _ in range(mesh.size)]
    dist.all_gather(parts, pred, group=mesh.group)
    objs = [None] * mesh.size
    dist.all_gather_object(objs, items, group=mesh.group)
    s = mesh.spatial
    groups = range(mesh.data_size) if shard.split else range(1)
    preds = [torch.cat(parts[d * s:(d + 1) * s], 1) if shard.h_split else parts[d * s]
             for d in groups]
    return torch.cat(preds, 0), [item for d in groups for item in objs[d * s]]


def serve_on_devices(forwards, devices, batch):
    """One request over the replicas ``forwards``, one on each of
    ``devices``: the batch's rows split as ``parallel.shard_batch`` splits
    them over so many ranks, each shard's forward launched on its device,
    the predictions gathered in order on the first. A batch that the count
    does not divide goes whole to the first device."""
    import torch

    from desr_tpu_torch.parallel.mesh import Mesh, shard_batch

    shards = [shard_batch(batch, Mesh(tuple(devices), r)) for r in range(len(devices))]
    if not shards[0].split:
        return forwards[0](batch)
    preds = [fwd(shard) for fwd, shard in zip(forwards, shards)]
    return torch.cat([p.to(preds[0].device) for p in preds])


def _serve(args, parser, pool, mesh=None):
    """Serve the folder; ``mesh``: this rank's under ``--spatial_devices``
    (``serve_ranks``), None for one process."""
    import functools

    import torch

    from desr_tpu_torch.data.base_dataset import load_depth_png
    from desr_tpu_torch.parallel import mesh as M
    from desr_tpu_torch.parallel import resolve_devices

    if mesh is not None:
        devices = [mesh.device]
    else:
        try:
            devices = resolve_devices(args.device, 1 if args.export or args.from_export
                                      else args.num_devices)
        except (RuntimeError, ValueError) as e:
            parser.error(str(e))
    device = devices[0]
    lead = mesh is None or mesh.rank == 0
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
        def replica(dev):
            kw = dict(device=dev, compute_dtype=getattr(torch, args.compute_dtype), mesh=mesh)
            if args.translate:
                m = TranslationModel(parse_net_args(net_args), direction=args.translate, **kw)
            else:
                model_cls = I2DModel if args.I2D else MainSRModel if args.SR else MainModel
                m = model_cls(parse_net_args(net_args), **kw)
            m.load_networks(args.checkpoints_dir, args.name, args.epoch)
            return m

        models = [replica(d) for d in devices]
        model = models[0]
        run = (model.serve_forward if len(models) == 1 else
               functools.partial(serve_on_devices, [m.serve_forward for m in models], devices))
    mult = 256 if args.SR else 128  # the padding of a live batch
    # --I2D reads no depth: the forward does not use it
    read_depth = not args.I2D

    def rows(i):
        """(lo, hi, n): the frames of batch i this process decodes (a rank:
        its data group's, ``Mesh.rows``)."""
        n = len(depth_paths[i:i + args.batch_size])
        return (*(mesh.rows(n) if mesh is not None else (0, n)), n)

    def pairs(i):
        lo, hi, _ = rows(i)
        return [(dp if read_depth else None, ip, args.max_distance, mult, shape)
                for dp, ip in zip(depth_paths[i + lo:i + hi], img_paths[i + lo:i + hi])]

    def assemble(frames, i):
        stems = [os.path.splitext(os.path.basename(dp))[0]
                 for dp in depth_paths[i:i + args.batch_size]]
        pads = [f[2] for f in frames]
        # an artifact's batch size is frozen: the tail batch repeats its last
        # frame, whose extra predictions are not written
        frames = frames + frames[-1:] * (args.batch_size - len(frames) if shape else 0)
        batch = {"B_d": np.stack([f[0] for f in frames]), "B_i": np.stack([f[1] for f in frames])}
        if mesh is not None:  # this rank's rows of its data group's frames
            batch = M.split_h(batch, mesh, rows(i))
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
        if mesh is not None:
            preds, pad_infos = gather_predictions(preds, pad_infos, batch, mesh)
        if pending is not None:
            write(*pending)
        pending = (*_to_host(preds), pad_infos, stems) if lead else None
        n_done += len(stems)
        if lead:
            print(f"{n_done}/{len(depth_paths)} frames", file=sys.stderr)
    if pending is not None:
        write(*pending)
    while writes:
        writes.popleft().get()  # surface a worker's write error
    print(f"wrote {len(depth_paths)} predictions to {args.output}")
    return len(depth_paths)


if __name__ == "__main__":
    main()
