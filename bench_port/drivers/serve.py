"""A closed loop of serving requests through ``MainModel.serve_forward``
(``MainSRModel``'s for an SR configuration).

A request is ``batch`` frames drawn by the seed from a pool of ``pool``
seeded frames (float32 host arrays in [-1, 1]), each reflect-padded by the
program's ``predict.pad_to_shape`` to the nets' grid (/128, /256 under SR)
and stacked: ``batches`` such requests are assembled at set-up, as the
predict CLI's decode workers assemble its batches ahead of the card, and the
window cycles through them. ``serve_forward`` runs a request; the
predictions come back into a pinned host buffer (as the CLI copies them) and
the padding is cropped off. One caller waits for each response before it
sends the next.

The check: a sample of the window's requests drawn from the seed (one in
``keep_one_in``, the first and the last always), each frame of each against
the plain reference's prediction for the same frame, computed after the
window in float32 on the card. Compared: the largest mean absolute gap of a
frame, and the largest gap of a pixel.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from bench_port import data as D
from bench_port import harness as H
from bench_port.reference import stage3 as R


def grids(cell):
    """(frame (H, W), padded (H, W), LR grid or None) of the cell."""
    h, w = cell.traffic["frame_hw"]
    mult = 256 if cell.cfg["stage"] == "sr" else 128
    ph, pw = -(-h // mult) * mult, -(-w // mult) * mult
    return (h, w), (ph, pw), ((ph // 2, pw // 2) if cell.cfg["stage"] == "sr" else None)


def build_model(cell, device, seed, torch):
    """The program's serving model with the seeded weights."""
    from desr_tpu_torch.models.main_model import MainModel, NetOptions
    from desr_tpu_torch.models.main_sr_model import MainSRModel

    _, _, lr_hw = grids(cell)
    opt = NetOptions(**cell.cfg["widths"])
    cls = MainModel
    if lr_hw is not None:
        opt.crop_size_h, opt.crop_size_w = lr_hw
        cls = MainSRModel
    model = cls(opt, device=device, compute_dtype=getattr(torch, cell.cfg["compute_dtype"]),
                is_train=False, generator=torch.Generator().manual_seed(0))
    weights = D.weights(R.param_shapes(cell.cfg, R.SERVING_NETS), seed, device)
    for name in R.SERVING_NETS:
        model.nets[name].load_state_dict(weights[name], strict=True)
    return model


def run(cell, seed, seconds, trace, device, t0, serve_fn=None):
    """Set-up, window, optional profile, then the check. ``serve_fn(model,
    batch)`` replaces ``model.serve_forward`` (the tests' broken paths)."""
    import torch

    t = cell.traffic
    b, pool_n = t["batch"], t["pool"]
    (h, w), padded, lr_hw = grids(cell)
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    H.phase("torch imported", t0)
    depth, image = D.frames(seed, pool_n, (h, w), dev)
    pool_d, pool_i = depth.cpu().numpy(), image.cpu().numpy()
    del depth, image
    H.phase("frames made", t0)
    model = build_model(cell, dev, seed, torch)
    H.phase("model built, weights loaded", t0)
    serve = serve_fn or (lambda m, batch: m.serve_forward(batch))
    keep = np.random.default_rng(D.sub_seed(seed, "keep"))
    request = Requester(model, pool_d, pool_i, padded, b, seed, serve, t["batches"])
    H.phase("requests assembled", t0)

    for i in range(t["warmup_calls"]):
        request()
        sync()
        H.phase(f"warm-up request {i + 1}", t0)
    res = H.Run(kind="serve", batch=b)
    peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    kept = []
    start = time.perf_counter()
    res.setup_s = start - t0
    while True:
        t1 = time.perf_counter()
        idx, out = request(res.host_call_s)
        res.latencies_s.append(time.perf_counter() - t1)
        res.attempted += 1
        done = time.perf_counter() - start >= seconds
        if res.attempted == 1 or done or keep.random() * t["keep_one_in"] < 1.0:
            kept.append((idx, [o.copy() for o in out]))
        if done:
            break
    sync()
    res.window_s = time.perf_counter() - start
    res.units = res.attempted * b
    if cuda:
        res.peak_window_bytes = torch.cuda.max_memory_allocated()
        res.peak_bytes = max(peak_setup, res.peak_window_bytes)
    if trace:
        from bench_port import trace as T
        from bench_port.reference import work

        res.trace = T.profile(lambda i: request(), t["profile_calls"], sync)
        res.work = work.serve_work(cell.cfg, b, padded, lr_hw)
    del model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    res.checks = check(cell, seed, dev, pool_d, pool_i, kept, padded, lr_hw)
    return res


def request_order(seed, pool_n, batch, n):
    """The pool indices of the seed's ``n`` requests."""
    order = np.random.default_rng(D.sub_seed(seed, "order"))
    return [order.choice(pool_n, batch, replace=False) for _ in range(n)]


class Requester:
    """The seed's requests, assembled host batches; ``request(record, copy)``
    serves the next (cycling) and returns (its pool indices, its cropped host
    predictions: views of the shared host buffer unless ``copy``); ``record``
    gets the host seconds of the program's call, up to its return."""

    def __init__(self, model, pool_d, pool_i, padded, batch, seed, serve, n):
        import torch

        from desr_tpu_torch.predict import pad_to_shape

        depth = [pad_to_shape(f, padded) for f in pool_d]
        image = [pad_to_shape(f, padded)[0] for f in pool_i]
        self.requests = [(idx, {"B_d": np.stack([depth[i][0] for i in idx]),
                                "B_i": np.stack([image[i] for i in idx])},
                          [depth[i][1] for i in idx])
                         for idx in request_order(seed, len(pool_d), batch, n)]
        self.model, self.serve, self.count = model, serve, 0
        pinned = torch.cuda.is_available() and model is not None and model.device.type == "cuda"
        self.host = torch.empty((batch, *padded), dtype=torch.float32, pin_memory=pinned)

    def __call__(self, record=None, copy=False):
        idx, batch, pads = self.requests[self.count % len(self.requests)]
        self.count += 1
        t_call = time.perf_counter()
        pred = self.serve(self.model, batch)
        if record is not None:
            record.append(time.perf_counter() - t_call)
        self.host.copy_(pred)
        out = [p[top:p.shape[0] - bot, lft:p.shape[1] - rgt]
               for p, ((top, bot), (lft, rgt), *_) in zip(self.host.numpy(), pads)]
        return idx, [o.copy() for o in out] if copy else out


def reference_outputs(cell, seed, dev, pool_d, pool_i, frames, padded, lr_hw, precision="f32"):
    """{pool index: the reference's prediction (H, W) float32 numpy} for the
    pool frames ``frames``, ``batch`` at a time, padded as the request pads."""
    import torch
    import torch.nn.functional as F

    from bench_port.reference import nets as N

    b = cell.traffic["batch"]
    (h, w) = pool_d.shape[1:3]
    top, lft = (padded[0] - h) // 2, (padded[1] - w) // 2
    pads = (lft, padded[1] - w - lft, top, padded[0] - h - top)
    weights = D.weights(R.param_shapes(cell.cfg, R.SERVING_NETS), seed, dev)
    with torch.device(dev):
        nets = R.build_nets(cell.cfg, R.SERVING_NETS)
    for name, net in nets.items():
        net.load_state_dict(weights[name])
        N.set_precision(net, precision)
    del weights
    out = {}
    frames = sorted(frames)
    with H.no_tf32(), torch.no_grad():
        for i in range(0, len(frames), b):
            part = frames[i:i + b]
            d = torch.from_numpy(pool_d[part]).to(dev).permute(0, 3, 1, 2)
            im = torch.from_numpy(pool_i[part]).to(dev).permute(0, 3, 1, 2)
            d = F.pad(d, pads, mode="reflect").permute(0, 2, 3, 1)
            im = F.pad(im, pads, mode="reflect").permute(0, 2, 3, 1)
            pred = R.serve(nets, d, im, lr_hw)[:, top:top + h, lft:lft + w]
            for j, k in enumerate(part):
                out[k] = pred[j].float().cpu().numpy()
    return out


def gaps(kept, ref):
    """(largest mean |gap| of a frame, largest |gap| of a pixel)."""
    frame_mean = pixel_max = 0.0
    for idx, out in kept:
        for k, pred in zip(idx, out):
            g = np.abs(pred.astype(np.float64) - ref[int(k)])
            if not np.all(np.isfinite(g)) or g.shape != ref[int(k)].shape:
                return float("inf"), float("inf")
            frame_mean = max(frame_mean, float(g.mean()))
            pixel_max = max(pixel_max, float(g.max()))
    return frame_mean, pixel_max


def check(cell, seed, dev, pool_d, pool_i, kept, padded, lr_hw):
    frames = {int(k) for idx, _ in kept for k in idx}
    ref = reference_outputs(cell, seed, dev, pool_d, pool_i, frames, padded, lr_hw)
    frame_mean, pixel_max = gaps(kept, ref)
    lim = cell.limits
    return [("frame_mean_gap", frame_mean, lim["frame_mean_gap"]),
            ("pixel_max_gap", pixel_max, lim["pixel_max_gap"])]
