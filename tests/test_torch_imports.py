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
            "desr_tpu_torch.data.translation_dataset"} <= set(mods)
    code = (f"import importlib, sys; [importlib.import_module(m) for m in {mods!r}]; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'desr_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
