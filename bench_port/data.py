"""Inputs and weights made from ``--seed``, the same for the program and the
reference.

The frames follow ``desr_tpu_torch/bench.py:make_batch``: depth uniform on
[-0.5, 1] with the values under -0.3 made holes (-1, about 13% of the
pixels) on the real side, images uniform on [-1, 1], ScanNet-like
intrinsics (fx = fy = 1154, the principal point at (640, 480)). They are
drawn on the run's device by a ``torch.Generator`` seeded from the run's
seed and a label, in a few large calls.
"""

from __future__ import annotations

import hashlib

import torch

K_SCANNET = ((1154.0, 0.0, 640.0), (0.0, 1154.0, 480.0), (0.0, 0.0, 1.0))


def sub_seed(seed, label):
    """A 63-bit seed of (seed, label): any whole number seeds every label
    apart."""
    digest = hashlib.sha256(f"{int(seed)}/{label}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed, label, device):
    return torch.Generator(device=device).manual_seed(sub_seed(seed, label))


def _uniform(g, shape, lo, hi, device):
    return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo


def depth_map(g, shape, holes, device):
    d = _uniform(g, shape, -0.5, 1.0, device)
    return torch.where(d < -0.3, torch.full_like(d, -1.0), d) if holes else d


def frames(seed, n, hw, device):
    """(depth (n, H, W, 1), image (n, H, W, 3)) real frames with holes."""
    g = generator(seed, "frames", device)
    h, w = hw
    return depth_map(g, (n, h, w, 1), True, device), _uniform(g, (n, h, w, 3), -1.0, 1.0, device)


def train_batch(seed, index, b, lr_hw, device):
    """One SR / main train batch of ``b`` HR pairs (twice ``lr_hw``) as
    make_batch builds it: synthetic ``A`` without holes, real ``B`` with,
    crop boxes of the HR grid for A and of the LR grid for B."""
    g = generator(seed, f"batch{index}", device)
    ch, cw = lr_hw
    h, w = 2 * ch, 2 * cw
    K = torch.tensor(K_SCANNET, device=device).expand(b, 3, 3).contiguous()
    return {
        "A_i": _uniform(g, (b, h, w, 3), -1.0, 1.0, device),
        "B_i": _uniform(g, (b, h, w, 3), -1.0, 1.0, device),
        "A_d": depth_map(g, (b, h, w, 1), False, device),
        "B_d": depth_map(g, (b, h, w, 1), True, device),
        "K_A": K, "K_B": K.clone(),
        "crop_A": torch.tensor([[0.0, h, 0.0, w]], device=device).expand(b, 4).contiguous(),
        "crop_B": torch.tensor([[0.0, ch, 0.0, cw]], device=device).expand(b, 4).contiguous(),
    }


def weights(shapes, seed, device):
    """Seeded float32 weights for ``shapes`` ({net: {key: shape}}), drawn as
    one standard-normal vector on ``device``: 4-D conv weights N(0, 0.02),
    1-D norm weights N(1, 0.02), biases N(0, 0.02)."""
    sizes = [torch.Size(s).numel() for net in shapes.values() for s in net.values()]
    flat = torch.randn(sum(sizes), generator=generator(seed, "weights", device), device=device)
    out, at = {}, 0
    for net, keys in shapes.items():
        out[net] = {}
        for key, shape in keys.items():
            n = torch.Size(shape).numel()
            v = flat[at:at + n].view(shape) * 0.02
            if key.endswith("weight") and len(shape) == 1:
                v = v + 1.0
            out[net][key] = v
            at += n
    return out
