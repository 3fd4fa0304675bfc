"""Serving export: the pruned serving forward as a portable artifact
(counterpart of ``desr_tpu/serving.py``).

``export_serving`` traces the real branch of the eval forward (the model's
``serving_module()``: the four serving nets, ``forward(B_d, B_i)``) with
``torch.export`` at one batch geometry and writes one directory:

    serving.pt2    ``torch.export.save`` of that program, in the model's
                   compute dtype. Each ResnetBlock conv is one
                   ``desr::conv3x3_fused`` node (K1; ``desr::conv3x3``, K2,
                   under ``--pallas_conv``), so the saved program launches the
                   kernels, as live serving does.
    params.npz     flat weights keyed ``<net>/<torch state_dict key>``, as the
                   JAX package writes them: its file for the same nets loads
                   here unchanged.
    manifest.json  the batch contract (``[shape, dtype]`` of B_d and B_i), the
                   output key, out_scale, sr, compute_dtype, the device type
                   the program was exported on (``platforms``), the torch
                   version and the provenance.

``load_serving`` reads it back without the model classes or the options
system: it imports the operators (``desr_tpu_torch.ops.conv3x3``), which
must be registered before the program is loaded, and the weights bridge.
The program holds tensors and device arguments of the device it was traced
on, so an artifact serves only on that device type; loading it for another
raises. Shapes are static, as in the JAX artifact: serving pads every batch
to the frozen geometry (``predict.py --from_export``).
"""

from __future__ import annotations

import json
import os

import numpy as np

MANIFEST = "manifest.json"
GRAPH = "serving.pt2"
WEIGHTS = "params.npz"
BATCH_KEYS = ("B_d", "B_i")  # the program's inputs, in its argument order

_SEP = "/"  # npz key separator: <net>/<torch key> (torch keys contain dots)


def _spec(v):
    """[shape, dtype name] of an array or tensor (the manifest's batch entry)."""
    dtype = v.dtype if hasattr(v, "dtype") else np.asarray(v).dtype
    return [list(np.shape(v)), str(dtype).removeprefix("torch.")]


def _upload(v, device):
    import torch

    t = v if torch.is_tensor(v) else torch.from_numpy(np.ascontiguousarray(v))
    return t.to(device)


def export_serving(model, batch, out_dir, output_key, provenance=None):
    """Trace the serving forward at ``batch``'s geometry and write the artifact.

    ``model``: a MainModel or MainSRModel with its weights loaded; ``batch``:
    "B_d" and "B_i" as ``predict.py`` builds them (numpy arrays or tensors;
    other keys are ignored); ``output_key``: the model's output,
    "pred_real_depth" (main) or "pred_real_depth_hr" (SR). Returns the
    manifest dict.
    """
    import torch

    if output_key != model._dump_key:
        raise ValueError(f"{type(model).__name__} serves {model._dump_key!r}, not {output_key!r}")
    module = model.serving_module()
    inputs = tuple(_upload(batch[k], model.device) for k in BATCH_KEYS)
    with torch.no_grad():
        program = torch.export.export(module, inputs)
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, os.path.join(out_dir, GRAPH))
    np.savez(os.path.join(out_dir, WEIGHTS),
             **{k.replace(".", _SEP, 1): v.detach().cpu().numpy()
                for k, v in module.state_dict().items()})
    manifest = {
        "output_key": output_key,
        "batch": {k: _spec(batch[k]) for k in BATCH_KEYS},
        "out_scale": 2 if output_key.endswith("_hr") else 1,
        "sr": output_key.endswith("_hr"),
        "compute_dtype": str(model.compute_dtype).removeprefix("torch."),
        "platforms": [model.device.type],
        "torch_version": torch.__version__,
        "provenance": provenance or {},
    }
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    return manifest


def load_serving(artifact_dir, device=None):
    """Load an exported artifact: returns ``(fn, params, manifest)``.

    ``device``: where to serve, the manifest's platform by default; another
    device type raises ValueError, and a CUDA one without a card
    RuntimeError. ``params`` is ``{net: {torch key: tensor on the device}}``
    from ``params.npz``; nets the program does not run (the translator
    ``G_A_d`` in a JAX package's file) are loaded and left unused. ``fn(params, batch, seed=0)`` runs the program with
    ``params`` in place of the weights it was traced with and returns the
    (B, H, W) float32 prediction on the device. ``batch`` must match the
    manifest's geometry exactly (checked, with a readable error); its
    arrays are uploaded. ``seed`` is the JAX signature's: the eval branch
    draws no holes, so nothing consumes it.
    """
    import torch

    from desr_tpu_torch import resolve_device
    from desr_tpu_torch.ops import conv3x3  # noqa: F401  (registers desr::conv3x3*)
    from desr_tpu_torch.weights import from_jax_params

    with open(os.path.join(artifact_dir, MANIFEST)) as f:
        manifest = json.load(f)
    platforms = manifest["platforms"]
    dev = torch.device(device if device is not None else platforms[0])
    if dev.type not in platforms:
        raise ValueError(
            f"the artifact in {artifact_dir} was exported on {platforms}, not {dev.type}: "
            f"its program holds that device's tensors; export it again on {dev.type}")
    dev = resolve_device(dev)
    program = torch.export.load(os.path.join(artifact_dir, GRAPH))
    module = program.module()
    with np.load(os.path.join(artifact_dir, WEIGHTS)) as z:
        flat = from_jax_params({k: z[k] for k in z.files}, dev)
    params = {}
    for kk, v in flat.items():
        net, _, k = kk.partition(_SEP)
        params.setdefault(net, {})[k] = v
    names = set(program.state_dict)  # parameters and buffers, <net>.<torch key>
    spec = manifest["batch"]

    def fn(p, batch, seed=0):
        got = {k: _spec(v) for k, v in batch.items()}
        if got != spec:
            diff = {k: (got.get(k), spec.get(k))
                    for k in set(got) | set(spec) if got.get(k) != spec.get(k)}
            raise ValueError(
                f"batch does not match the exported geometry: {diff}. "
                f"The artifact is compiled for fixed shapes; re-export for "
                f"this geometry or pad/batch to match.")
        weights = {f"{net}.{k}": v for net, sub in p.items() for k, v in sub.items()}
        weights = {k: v for k, v in weights.items() if k in names}
        if len(weights) != len(names):
            raise KeyError(f"params lack the program's weights "
                           f"{sorted(names - set(weights))[:5]}")
        with torch.no_grad():
            return torch.func.functional_call(
                module, weights, tuple(_upload(batch[k], dev) for k in BATCH_KEYS))

    return fn, params, manifest
