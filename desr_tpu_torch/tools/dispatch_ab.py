"""K1's dispatch cost, one checkout of the repository against another, on one card.

    python3 desr_tpu_torch/tools/dispatch_ab.py ROOT_A ROOT_B [--rounds 1]

Each ROOT is a checkout (an unpacked ``git archive`` of a commit); each builds
its kernels into its own ``desr_tpu_torch/_build/``. Runs go A, B, B, A per
round, each in a fresh process that imports that checkout's package and its
``chip_smoke.py`` helpers, so the two versions of ``conv3x3_fused`` (an
``autograd.Function`` before the ``desr::`` operators, the operators after)
meet the same card in one call. The timers are this checkout's
``chip_smoke.py`` helpers. A run measures, bf16, TF32 off:

- ``k1_host_ms``: the wrapper's host time a call at a launch of a few
  microseconds (B=1, 8x16, 64->64, normalise+ReLU+stats, replicate), 500
  calls then one sync (``chip_smoke.host_ms``), without and with inputs
  that need a gradient (``k1_host_ms_grad``: the autograd graph recorded);
- ``k1_issue_ms``: the same at stage 2's shape (B=6, 64x64, 256->256), calls
  queued behind each other, timed before the sync (``chip_smoke.issue_ms``);
- ``stage2_iter_ms``: stage 2's iteration (3 G steps, 1 D step; batch 6 of
  256x256, the README's flags), CUDA events over 10 after 3
  (``chip_smoke.cuda_ms``, as phase (k) times it), on a seeded random batch.

Prints one JSON line a run, then one with each side's medians.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _run(root):
    """One run in this process, on ``root``'s package: a dict of the times."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    # the timers of this checkout, whatever ``root`` holds
    spec = importlib.util.spec_from_file_location("smoke_timers", os.path.join(ROOT, "chip_smoke.py"))
    S = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(S)
    from desr_tpu_torch.models.translation_model import TranslationModel
    from desr_tpu_torch.ops import conv3x3 as K
    from desr_tpu_torch.options import train_options

    if not os.path.abspath(K.__file__).startswith(os.path.abspath(root)):
        raise RuntimeError(f"{K.__file__} is not under {root}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"root": root}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for tag, shape, timer in (("k1_host_ms", (1, 8, 16, 64), S.host_ms),
                              ("k1_issue_ms", (6, 64, 64, 256), S.issue_ms)):
        b, c = shape[0], shape[-1]
        x = torch.randn(shape, device="cuda", generator=gen).bfloat16()
        w = 0.05 * torch.randn((c, c, 3, 3), device="cuda", generator=gen)
        sc = torch.rand((b, c), device="cuda", generator=gen) + 0.5
        sh = torch.randn((b, c), device="cuda", generator=gen)
        out[tag] = timer(lambda: K.conv3x3_fused(x, w, sc, sh, "replicate", True, True))
        if tag == "k1_host_ms":
            ins = [t.detach().requires_grad_(True) for t in (x, w, sc, sh)]
            out["k1_host_ms_grad"] = timer(
                lambda: K.conv3x3_fused(*ins, "replicate", True, True))
    with tempfile.TemporaryDirectory() as tmp:
        opt = train_options.parse(S._translation_argv(tmp, "ab"), print_options=False)
    model = TranslationModel(opt, device="cuda", compute_dtype=torch.bfloat16, is_train=True,
                             generator=torch.Generator().manual_seed(9))
    rng = np.random.default_rng(0)
    model.set_input({k: rng.uniform(-1, 1, (6, 256, 256, 3 if k.endswith("img") else 1))
                     .astype(np.float32) for k in ("A_depth", "A_img", "B_depth", "B_img")})
    out["stage2_iter_ms"] = S.cuda_ms(model.optimize_parameters, iters=10, warmup=3)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs=2, metavar="ROOT", help="checkouts A and B")
    ap.add_argument("--rounds", type=int, default=1, help="rounds of A, B, B, A")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(_run(args.roots[0])))
        return 0
    runs = {r: [] for r in args.roots}
    a, b = args.roots
    for root in [a, b, b, a] * args.rounds:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), root, root, "--worker"],
                             cwd=root, capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        line = json.loads(res.stdout.strip().splitlines()[-1])
        runs[root].append(line)
        print(json.dumps(line), flush=True)
    print(json.dumps({root: {k: statistics.median(r[k] for r in rs) for k in rs[0] if k != "root"}
                      for root, rs in runs.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
