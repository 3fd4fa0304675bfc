"""A/B of source variants of the masked-loss sums kernel (K3) on one card, in one process.

    python3 desr_tpu_torch/tools/masked_loss_ab.py [--probes] [NAME=SPEC ...]

Each SPEC is a list of text substitutions on ``desr_tpu_torch/csrc/masked_loss.cu``,
``OLD=>NEW`` pairs joined by ``@@``, or ``@PATH`` for a whole source file with
the same C interface (``tools/variants.py``). ``--probes`` adds the variants
of PROBES (PERF.md's breakdown of the sums' time). Every variant, "base" (the
source as it is) and "two_launch" (the earlier two-launch design,
``masked_loss_two_launch.cu``) is built with the package's nvcc flags into
its own library under ``desr_tpu_torch/_build/ab/`` (one nvcc each, in
parallel). Then, at the main train step's shape (6, 512, 640) and the SR
step's HR one (1, 1024, 1280), f32 pred/target and masks, each library runs
the sums in turns (A, B, ..., B, A). Each time is ``chip_smoke.device_ms`` of
the kernels a call launches, with L2 flushed before each call (``flushed``,
chip_smoke.py's phase (d) reading) and back to back (``warm``: the 21-31 MB
of inputs stay in the 50 MB L2); ``ok`` says whether the sums agree with the
plain version within 1e-5 (a probe may break them). The rows are printed and
written to ``desr_tpu_torch/_build/ab/masked_loss_ab.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TWO_LAUNCH_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "masked_loss_two_launch.cu")

# timing probes: results wrong by design
PROBES = {
    # no cross-block finish: each block writes its partials, nothing sums them
    "no_finish": "    prior = ticket_add(ticket);  // releases the partials above=>    prior = 0u;",
}
SHAPES = ((6, 512, 640), (1, 1024, 1280))
FLUSHES = {"flushed": True, "warm": False}


class NewLib:
    """A library with the one-launch interface: the sums kernel's plan comes
    from ``ops/masked_loss.py:launch_plan``."""

    def __init__(self, path):
        import torch

        from desr_tpu_torch.ops import masked_loss as K3

        self.K3, self.lib = K3, ctypes.CDLL(path)
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        self.lib.desr_masked_loss_occupancy.argtypes = [ci, ci, ctypes.POINTER(ci)]
        self.lib.desr_masked_loss_sums.argtypes = [vp] * 6 + [ll] * 3 + [ci] * 4 + [vp]
        occ = (ctypes.c_int * 2)()
        assert self.lib.desr_masked_loss_occupancy(0, 0, occ) == 0
        self.sms, self.resident = occ
        self.scratch = torch.zeros(4 + 3 * self.sms * K3.MAX_BLOCKS_PER_SM, dtype=torch.int32,
                                   device="cuda")

    def call(self, ins, out):
        import torch

        addrs = [v.data_ptr() for v in ins]
        plan = self.K3.launch_plan(ins[0].numel(), addrs, [4] * 4, self.sms, self.resident)
        err = self.lib.desr_masked_loss_sums(
            *addrs, self.scratch.data_ptr(), out.data_ptr(), plan.n, plan.head, plan.units,
            plan.unit, plan.grid, 0, 0, torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return plan.grid


class TwoLaunch:
    """The two-launch design (``masked_loss_two_launch.cu``) on f32 inputs
    aligned for vector loads: partials per block, then a one-block finish."""

    def __init__(self, path):
        self.lib = ctypes.CDLL(path)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        self.lib.desr_masked_loss_sums.argtypes = [vp] * 6 + [ctypes.c_longlong] + [ci] * 3 + [vp]
        self.lib.desr_masked_loss_blocks.argtypes = [ctypes.c_longlong]
        self.partials = {}

    def call(self, ins, out):
        import torch

        n = ins[0].numel()
        blocks = self.lib.desr_masked_loss_blocks(n)
        if n not in self.partials:
            self.partials[n] = torch.empty(blocks * 3, dtype=torch.float32, device="cuda")
        err = self.lib.desr_masked_loss_sums(
            *(v.data_ptr() for v in ins), self.partials[n].data_ptr(), out.data_ptr(), n, 0, 0, 1,
            torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return blocks


def build_two_launch():
    """Build ``masked_loss_two_launch.cu``; the library's path."""
    from desr_tpu_torch.tools.variants import build_variant

    with open(TWO_LAUNCH_SOURCE) as f:
        so, log = build_variant("two_launch", f.read())
    if so is None:
        raise RuntimeError("nvcc failed for masked_loss_two_launch.cu:\n" + "\n".join(log))
    return so


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", help="NAME=SPEC")
    ap.add_argument("--probes", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as S
    from desr_tpu_torch.ops import _build as B
    from desr_tpu_torch.ops import masked_loss as K3
    from desr_tpu_torch.tools.variants import build_variant, variant_source

    with open(os.path.join(B.CSRC_DIR, "masked_loss.cu")) as f:
        base = f.read()
    specs = {"base": None, **(PROBES if args.probes else {})}
    specs.update(dict(v.split("=", 1) for v in args.variants))
    srcs = {n: base if s is None else variant_source(s, base) for n, s in specs.items()}
    with open(TWO_LAUNCH_SOURCE) as f:
        srcs["two_launch"] = f.read()
    with ThreadPoolExecutor(len(srcs)) as pool:
        built = dict(zip(srcs, pool.map(build_variant, srcs, srcs.values())))
    for name, (so, log) in built.items():
        print(f"[ab] {name}: {'built' if so else 'BUILD FAILED'}; " + "; ".join(log))
        if so is None:
            raise SystemExit(f"nvcc failed for {name}")
    libs = {n: (TwoLaunch if n == "two_launch" else NewLib)(so) for n, (so, _) in built.items()}

    runs = list(libs)
    results = []
    for shape in SHAPES:
        ins = S._loss_inputs(shape, torch.float32, seed=2)
        want = K3.masked_loss_sums_plain(*ins)
        times = {r: {f: [] for f in FLUSHES} for r in runs}
        grids, ok = {}, {}
        for order in (runs, runs[::-1]):  # A, B, ..., B, A
            for name in order:
                out = torch.full((3,), float("nan"), device="cuda")
                grids[name] = libs[name].call(ins, out)
                torch.cuda.synchronize()
                ok[name] = bool(((out - want).abs() <= 1e-5 * want.abs() + 1e-6).all())
                for flush, flush_l2 in FLUSHES.items():
                    t = S.device_ms(lambda: libs[name].call(ins, torch.empty(3, device="cuda")),
                                    "masked_loss", flush_l2=flush_l2)
                    times[name][flush].append(t["median"])
        bound = 16 * ins[0].numel() / S.PEAK_HBM * 1e3
        for name, t in times.items():
            row = {"shape": shape, "variant": name, "grid": grids[name], "ok": ok[name],
                   "bound_ms": bound, **{f"{k}_ms": statistics.mean(v) for k, v in t.items()},
                   **{f"{k}_ms_runs": v for k, v in t.items()}}
            results.append(row)
            print(f"[ab] {'x'.join(map(str, shape))} {name:>12} grid {row['grid']:4d} "
                  f"ok {row['ok']!s:5}  flushed {row['flushed_ms']:.5f}  warm {row['warm_ms']:.5f}"
                  f" ms (bound {bound:.5f}, share {bound / row['flushed_ms']:.3f})")
        del ins
    with open(os.path.join(B.BUILD_DIR, "ab", "masked_loss_ab.json"), "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
