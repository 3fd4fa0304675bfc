"""A/B of source variants of the conv3x3 kernel on one card, in one process.

    python3 desr_tpu_torch/tools/conv3x3_ab.py [NAME=SPEC ...]

Each SPEC is a list of text substitutions on ``desr_tpu_torch/csrc/conv3x3.cu``,
``OLD=>NEW`` pairs joined by ``@@``, or ``@PATH`` for a whole source file.
Every variant (and "base", the source as it is) is built with the package's
nvcc flags into its own library under ``desr_tpu_torch/_build/ab/`` (one
nvcc each, in parallel); ptxas's register, spill and warning lines are
printed (``tools/variants.py``). Then, at the serving shape (B=8, 128x160, 128->128, reflect) and
the translator's (B=6, 128x160, 256->256, replicate), bf16, each library in
turn runs K1 (norm+relu+stats) and K2 through the package's wrappers: the
output is checked against the plain version (``ok``, chip_smoke.py's bf16
bound) and the kernel's device time per call is the torch.profiler median
with L2 flushed (chip_smoke.device_ms). A variant may break results (a
timing probe); ``ok`` says so. A variant that changes the bf16 tiling of
N = 128 passes ``--th128 ROWS``. ``--probes`` adds the variants of PROBES
(PERF.md's breakdown of the body's time).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_NO_LOADS = ("    for (int e = tid; e < C::HP * 8; e += NTHREADS) {\n      const int sp"
             "=>    for (int e = tid + (1 << 28); e < C::HP * 8; e += NTHREADS) {\n      const int sp")
_NO_PROLOGUE = ("    for (int e = tid; e < C::HP * 8; e += NTHREADS) {\n      const int p = e >> 3;"
                "=>    for (int e = tid + (1 << 28); e < C::HP * 8; e += NTHREADS) {\n"
                "      const int p = e >> 3;")
_NO_EPILOGUE = ("  if (psum != nullptr) {\n    float* red=>  if (false) {\n    float* red"
                "@@if (psum != nullptr && tid < NT=>if (false && tid < NT"
                "@@for (int e = tid; e < C::TH * TW * (NT / 8); e += NTHREADS) {"
                "=>for (int e = tid + (1 << 28); e < C::TH * TW * (NT / 8); e += NTHREADS) {")
_QUARTER_WEIGHTS = (
    "      mbar_expect_tx(full_u + 8 * j, C::WS_BYTES);"
    "=>      mbar_expect_tx(full_u + 8 * j, C::WS_BYTES / 4);"
    "@@C::WS_BYTES,\n                full_u + 8 * j);=>C::WS_BYTES / 4,\n                full_u + 8 * j);"
    "@@        mbar_expect_tx(full_u + 8 * s, C::WS_BYTES);"
    "=>        mbar_expect_tx(full_u + 8 * s, C::WS_BYTES / 4);"
    "@@                  C::WS_BYTES, full_u + 8 * s);=>                  C::WS_BYTES / 4, full_u + 8 * s);")
# --probes: (spec, tile rows of N = 128). The first three are timing probes
# whose results are wrong by design; one_block is the alternative tiling
# of N = 128 (two m64 tiles per warpgroup, 16 rows, one block per SM).
PROBES = {
    "no_mma": ("wgmma_tile<NT>(acc[mt], a[mt][ks], desc + 2 * ks);=>(void)desc;", None),
    "mma_only": ("@@".join([_NO_LOADS, _NO_PROLOGUE, _NO_EPILOGUE]), None),
    "mma_only_qw": ("@@".join([_NO_LOADS, _NO_PROLOGUE, _NO_EPILOGUE, _QUARTER_WEIGHTS]), None),
    "one_block": ("static constexpr int MW = NT > 64 ? 1 : 2;=>static constexpr int MW = NT > 128 ? 1 : 2;"
                  "@@static constexpr int MIN_BLOCKS = NT == 128 ? 2 : 1;"
                  "=>static constexpr int MIN_BLOCKS = 1;", 16),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", help="NAME=SPEC")
    ap.add_argument("--th128", type=int, default=None,
                    help="tile rows of the N = 128 tiling in the NAME=SPEC variants")
    ap.add_argument("--probes", action="store_true",
                    help="add the PROBES variants (the time breakdown in PERF.md)")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as S
    from desr_tpu_torch.ops import _build
    from desr_tpu_torch.ops import conv3x3 as K
    from desr_tpu_torch.tools.variants import build_variant, variant_source

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    with open(os.path.join(_build.CSRC_DIR, "conv3x3.cu")) as f:
        base = f.read()
    variants, th128 = {"base": base}, {}
    for v in args.variants:
        name, _, spec = v.partition("=")
        variants[name], th128[name] = variant_source(spec, base), args.th128
    for name, (spec, rows) in (PROBES.items() if args.probes else ()):
        variants[name], th128[name] = variant_source(spec, base), rows

    libs = {}
    with ThreadPoolExecutor(len(variants)) as pool:
        for name, (so, log) in zip(variants, pool.map(build_variant, variants,
                                                      variants.values())):
            print(f"== {name}: {'built' if so else 'BUILD FAILED'}")
            for ln in log:
                print("   " + ln[:160])
            if so:
                lib = ctypes.CDLL(so)
                vp, ci = ctypes.c_void_p, ctypes.c_int
                lib.desr_conv3x3_bf16.argtypes = [vp] * 7 + [ci] * 11 + [vp]
                lib.desr_conv3x3_bf16.restype = ci
                libs[name] = lib
    tiling = K.bf16_tiling
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    for shape, mode in ((S.SERVE_SHAPE, "reflect"), (S.TRANS_SHAPE, "replicate")):
        x, w, sc, sh = S._inputs(torch.bfloat16, seed=1, shape=shape)
        want = K.conv3x3_fused_plain(x, w, sc, sh, mode, True, True)[0].float()
        for name, lib in libs.items():
            K._library = lambda lib=lib: lib
            rows = th128.get(name)
            K.bf16_tiling = (tiling if rows is None else
                             lambda o, rows=rows: (128, rows) if tiling(o)[0] == 128 else tiling(o))
            d = (K.conv3x3_fused(x, w, sc, sh, mode, True, True)[0].float() - want).abs()
            ok = bool((d <= 1e-3 + 2 ** -7 * want.abs()).all())
            k1 = S.device_ms(lambda: K.conv3x3_fused(x, w, sc, sh, mode, True, True), "conv3x3")
            k2 = S.device_ms(lambda: K.conv3x3(x, w, mode), "conv3x3")
            print(f"{'x'.join(map(str, shape))} {mode:9s} {name:10s} ok={ok!s:5s} "
                  f"K1 {k1['median']:.4f} ms (least {k1['min']:.4f})  K2 {k2['median']:.4f} ms")
        del x, w, sc, sh
    return 0


if __name__ == "__main__":
    sys.exit(main())
