"""The port stands alone: no JAX and nothing of desr_tpu in desr_tpu_torch or chip_smoke.py."""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = re.compile(r"^\s*(import jax|from jax|import desr_tpu\b|from desr_tpu[. ])")


def _sources():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "desr_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_jax_or_desr_tpu_import_lines():
    bad = []
    for path in _sources():
        with open(path) as fh:
            for i, line in enumerate(fh, 1):
                if FORBIDDEN.match(line):
                    bad.append(f"{os.path.relpath(path, ROOT)}:{i}: {line.strip()}")
    assert not bad, "\n".join(bad)


def test_importing_the_port_loads_neither_jax_nor_desr_tpu():
    """Every module of the package imported in a fresh interpreter."""
    mods = sorted(os.path.relpath(p, ROOT)[:-3].replace(os.sep, ".").removesuffix(".__init__")
                  for p in _sources() if p.endswith(".py") and "desr_tpu_torch" in p)
    assert {"desr_tpu_torch.models.main_sr_model", "desr_tpu_torch.ops.resize",
            "desr_tpu_torch.models.i2d_model", "desr_tpu_torch.models.translation_model",
            "desr_tpu_torch.data.i2d_dataset", "desr_tpu_torch.utils.image_pool",
            "desr_tpu_torch.data.translation_dataset", "desr_tpu_torch.serving",
            "desr_tpu_torch.metrics", "desr_tpu_torch.ops.ssim", "desr_tpu_torch.bench",
            "desr_tpu_torch.data.native_io", "desr_tpu_torch.data.legacy_datasets",
            "desr_tpu_torch.options.test_options",
            "desr_tpu_torch.tools.quality_eval", "desr_tpu_torch.parallel",
            "desr_tpu_torch.parallel.mesh", "desr_tpu_torch.parallel.launch"} <= set(mods)
    code = (f"import importlib, sys; [importlib.import_module(m) for m in {mods!r}]; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'desr_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_load_serving_and_the_host_workers_import_little(tmp_path):
    """``load_serving`` loads neither the model classes nor the options (the
    artifact serves without them); the modules the serving CLI's and the
    metrics' spawned workers import load no torch."""
    import numpy as np
    import torch

    from desr_tpu_torch.models.main_model import MainModel, NetOptions
    from desr_tpu_torch.serving import export_serving

    model = MainModel(NetOptions(ImageDepthf_outf=8, ImageDepthf_basef=8, Depthf_outf=8,
                                 Depthf_basef=8, I2D_base=8, Task_basef=8),
                      device="cpu", compute_dtype=torch.float32)
    export_serving(model, {"B_d": np.zeros((1, 128, 128, 1), np.float32),
                           "B_i": np.zeros((1, 128, 128, 3), np.float32)},
                   str(tmp_path), "pred_real_depth")
    code = ("import sys; import desr_tpu_torch.predict, desr_tpu_torch.metrics; "
            "assert 'torch' not in sys.modules, 'torch'; "
            "from desr_tpu_torch.serving import load_serving; "
            "fn, params, manifest = load_serving(sys.argv[1]); "
            "bad = sorted(m for m in sys.modules if m.startswith(('desr_tpu_torch.models', "
            "'desr_tpu_torch.options'))); print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
