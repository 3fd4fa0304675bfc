"""Source variants of a package kernel for the A/B tools (conv3x3_ab.py,
masked_loss_ab.py) and chip_smoke.py: text substitutions on a source, and an
nvcc build of each variant into its own library under
``desr_tpu_torch/_build/ab/``.
"""

from __future__ import annotations

import os
import subprocess


def variant_source(spec, base):
    """``base`` with ``spec`` applied: ``OLD=>NEW`` pairs joined by ``@@``,
    or ``@PATH`` for a whole source file."""
    if spec.startswith("@"):
        with open(spec[1:]) as f:
            return f.read()
    src = base
    for pair in filter(None, spec.split("@@")):
        old, new = pair.split("=>", 1)
        if old not in src:
            raise SystemExit(f"substitution not found in the source: {old!r}")
        src = src.replace(old, new)
    return src


def build_variant(name, src):
    """Compile ``src`` with the package's nvcc flags into
    ``_build/ab/lib<name>.so``. Returns the library's path (None when nvcc
    failed) and ptxas's register, C7520 and error lines."""
    from desr_tpu_torch.ops import _build

    out_dir = os.path.join(_build.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    cu, so = os.path.join(out_dir, f"{name}.cu"), os.path.join(out_dir, f"lib{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    res = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                          "-o", so, cu], capture_output=True, text=True)
    keep = [ln.strip() for ln in res.stderr.splitlines()
            if "registers" in ln or "C7520" in ln or "error" in ln]
    return (so if res.returncode == 0 else None), keep
