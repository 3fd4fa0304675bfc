"""The work a call does, counted from the reference at the cell's shapes on
the ``meta`` device (no data, no time):

- ``flops``: convolution and matrix-product FLOPs of one call, as
  ``torch.utils.flop_counter.FlopCounterMode`` counts them (forward, and
  the backward of a train step);
- K1's operations and bytes (the program's hand-written 3x3 kernel over
  the ResNet blocks' convolutions): 2 * 9 * C_in * C_out * B * H * W
  operations a launch; bytes the bf16 input and output once and the
  weights once, 2 * (B * H * W * (C_in + C_out) + 9 * C_in * C_out);
- K3's bytes (the fused masked-loss sums and their backward): 16 bytes a
  value for the sums (four float32 inputs read once) and 20 for the
  backward (the same four read, one float32 gradient written).

These are the formulas of PERF.md's kernel table. Peaks: NVIDIA's H100 SXM
data sheet, dense bf16 and HBM3.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_port.reference import nets as N
from bench_port.reference import stage3 as R

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
K3_SUMS_BYTES, K3_GRADS_BYTES = 16, 20


def k1_ops(b, cin, cout, h, w):
    return 2 * 9 * cin * cout * b * h * w


def k1_bytes(b, cin, cout, h, w):
    return 2 * (b * h * w * (cin + cout) + 9 * cin * cout)


def _meta_nets(cfg, names):
    with torch.device("meta"):
        return R.build_nets(cfg, names)


def _k1_hooks(nets, shapes):
    handles = []
    for net in nets.values():
        for m in net.modules():
            if isinstance(m, N.Conv2d) and m.k1:
                def hook(mod, args, out):
                    b, cout, h, w = out.shape
                    shapes.append((b, mod.in_channels, cout, h, w))
                handles.append(m.register_forward_hook(hook))
    return handles


def _count(run):
    """(flops, K1 launch shapes, K3 values) of ``run(k3_log)`` on meta."""
    shapes, k3 = [], []
    with FlopCounterMode(display=False) as counter:
        run(shapes, k3)
    return counter.get_total_flops(), shapes, k3


def _summary(flops, shapes, k3_sums, k3_grads):
    return {
        "flops_per_call": flops,
        "k1_launches_per_call": len(shapes),
        "k1_ops_per_call": sum(k1_ops(*s) for s in shapes),
        "k1_bytes_per_call": sum(k1_bytes(*s) for s in shapes),
        # the least time a launch can take: its operations at the bf16 peak
        # or its bytes at HBM's, whichever is longer
        "k1_bound_s_per_call": sum(max(k1_ops(*s) / PEAK_BF16_FLOPS,
                                       k1_bytes(*s) / PEAK_HBM_BYTES) for s in shapes),
        "k3_launches_per_call": len(k3_sums) + len(k3_grads),
        "k3_bytes_per_call": K3_SUMS_BYTES * sum(k3_sums) + K3_GRADS_BYTES * sum(k3_grads),
        "k3_bound_s_per_call": (K3_SUMS_BYTES * sum(k3_sums)
                                + K3_GRADS_BYTES * sum(k3_grads)) / PEAK_HBM_BYTES,
    }


def serve_work(cfg, batch, padded_hw, lr_hw=None):
    """The work of one served request of ``batch`` frames on the padded grid."""
    nets = _meta_nets(cfg, R.SERVING_NETS)

    def run(shapes, k3):
        handles = _k1_hooks(nets, shapes)
        h, w = padded_hw
        with torch.no_grad():
            R.serve(nets, torch.empty(batch, h, w, 1, device="meta"),
                    torch.empty(batch, h, w, 3, device="meta"), lr_hw)
        for hd in handles:
            hd.remove()

    flops, shapes, _ = _count(run)
    return _summary(flops, shapes, [], [])


def train_work(cfg, batch, hr_hw, lr_hw=None):
    """The work of one train step on ``batch`` HR (``lr_hw``: SR) pairs."""
    names = ("G_A_d",) + R.SERVING_NETS
    nets = _meta_nets(cfg, names)
    for n in R.TRAINED_NETS:
        nets[n].requires_grad_(True)
    for n in set(names) - set(R.TRAINED_NETS):
        nets[n].requires_grad_(False)
    h, w = hr_hw

    def run(shapes, k3_log):
        handles = _k1_hooks(nets, shapes)
        meta = dict(device="meta")
        b = {"A_i": torch.empty(batch, h, w, 3, **meta), "B_i": torch.empty(batch, h, w, 3, **meta),
             "A_d": torch.empty(batch, h, w, 1, **meta), "B_d": torch.empty(batch, h, w, 1, **meta),
             "K_A": torch.empty(batch, 3, 3, **meta), "K_B": torch.empty(batch, 3, 3, **meta),
             "crop_A": torch.empty(batch, 4, **meta), "crop_B": torch.empty(batch, 4, **meta)}
        f = R.forward_train(nets, b, cfg, None, lr_hw)
        for hd in handles:  # K1 runs in the forward alone
            hd.remove()
        loss, _ = (R.losses_sr if lr_hw is not None else R.losses_main)(f, b, cfg, k3_log)
        loss.backward()

    flops, shapes, k3_sums = _count(run)
    # every masked mean is differentiable in pred: one backward launch each
    return _summary(flops, shapes, k3_sums, k3_sums)
