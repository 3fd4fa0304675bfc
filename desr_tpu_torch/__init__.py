"""desr_tpu_torch — the PyTorch/CUDA port of desr_tpu for one NVIDIA H100.

The JAX package ``desr_tpu`` stays the reference; this package keeps its module
layout so each counterpart is found under the same path:

- ``desr_tpu_torch.ops``     — the hand-written Hopper kernels (``ops/conv3x3.py``
                               over ``csrc/conv3x3.cu``, ``ops/masked_loss.py``
                               over ``csrc/masked_loss.cu``) beside their plain
                               PyTorch versions; depth masks, normals, losses,
                               Adam and the LR schedule.
- ``desr_tpu_torch.models``  — ``nn.Module`` layers and nets whose
                               ``state_dict`` keys and shapes equal the JAX
                               ``Net.init`` param dicts, and ``MainModel``'s
                               serving forward and train step.
- ``desr_tpu_torch.data``    — host I/O: a stdlib PNG codec, frame loaders,
                               the main dataset and its loader.
- ``desr_tpu_torch.options`` — the train CLI's flags (the JAX names and defaults).
- ``desr_tpu_torch.predict`` — ``python -m desr_tpu_torch.predict``.
- ``desr_tpu_torch.serving`` — the exported serving artifact (``--export``,
                               ``--from_export``).
- ``desr_tpu_torch.metrics`` — ``python -m desr_tpu_torch.metrics``.
- ``desr_tpu_torch.train``   — ``python -m desr_tpu_torch.train``.
- ``desr_tpu_torch.parallel`` — the ``--num_devices`` data mesh: the ranks'
                               launch, batch split and reductions.

The package imports nothing of ``desr_tpu`` and nothing of JAX. Entry points
run on the card unless the caller passes ``device="cpu"``; without a card they
raise instead of carrying on on the CPU.
"""

from __future__ import annotations

# torch is imported where it is used: the serving CLI's and the metrics'
# spawned workers import this package for its host modules alone


def resolve_device(device=None):
    """The device an entry point runs on: ``cuda`` unless ``"cpu"`` is asked for.

    Raises RuntimeError when a CUDA device is asked for (the default) and
    none is present, so that nothing silently runs on the CPU.
    """
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; desr_tpu_torch runs on the GPU "
            "unless device='cpu' (--device cpu) is passed explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
