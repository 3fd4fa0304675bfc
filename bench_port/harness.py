"""What every cell shares: the cell's files found by name, the run's record,
the metrics' readers, the result line and the import check.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``: its configuration
is the file that the ``configs`` entry of that name gives, its traffic
``bench_port/traffic/<traffic>.json``, the limits of its output check
``bench_port/limits/<cell>.json``, and its driver ``bench_port/drivers/
<driver>.py``, the ``driver`` key of the traffic file. A metric is read by
``bench_port/metrics/<metric>.py``. So a cell or a metric is added with files
and entries, and no file here changes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
FORBIDDEN = ("jax", "jaxlib", "flax", "desr_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    traffic: dict
    limits: dict


@dataclasses.dataclass
class Run:
    """What a run measured. ``kind``: the driver ("serve", "train"); a
    call is a request or a step, a unit a frame or a pair."""

    kind: str
    batch: int
    attempted: int = 0
    failed: int = 0
    units: int = 0
    window_s: float = 0.0
    latencies_s: list = dataclasses.field(default_factory=list)
    host_call_s: list = dataclasses.field(default_factory=list)
    setup_s: float = 0.0
    peak_window_bytes: int = 0
    peak_bytes: int = 0
    trace: dict | None = None
    work: dict | None = None
    checks: list = dataclasses.field(default_factory=list)  # (name, value, limit)

    @property
    def calls_per_s(self):
        return self.attempted / self.window_s

    @property
    def correct(self):
        return bool(self.checks) and all(
            math.isfinite(v) and v <= lim for _, v, lim in self.checks)


@contextlib.contextmanager
def no_tf32():
    """TF32 off for cuDNN and matmuls inside, as the float32 reference needs."""
    import torch

    bk = torch.backends
    saved = bk.cudnn.allow_tf32, bk.cuda.matmul.allow_tf32
    bk.cudnn.allow_tf32 = bk.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        bk.cudnn.allow_tf32, bk.cuda.matmul.allow_tf32 = saved


def phase(name, t0):
    """A line on stderr: the seconds since the process started at ``name``."""
    print(f"[setup] {name}: {time.perf_counter() - t0:.3f} s", file=sys.stderr, flush=True)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return load_json(os.path.join(root, "BENCHMARK.json"))


def find_cell(bench, name, root=ROOT):
    """The ``Cell`` of workload ``name``; KeyError if the benchmark has none."""
    work = {w["name"]: w for w in bench["workloads"]}[name]
    config = {c["name"]: c for c in bench["configs"]}[work["config"]]
    return Cell(
        name=name, chips=work["chips"],
        cfg=load_json(os.path.join(root, config["file"])),
        traffic=load_json(os.path.join(PKG, "traffic", f"{work['traffic']}.json")),
        limits=load_json(os.path.join(PKG, "limits", f"{name}.json")))


def driver(cell):
    return importlib.import_module(f"bench_port.drivers.{cell.traffic['driver']}")


def cell_metrics(bench, cell_name, trace):
    """The metric entries a run of the cell reads: its end-to-end ones, or
    with ``trace`` its per-layer ones. An entry with ``workloads`` applies
    to those cells, one without to every cell (its reader stays silent where
    the cell has nothing for it)."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if cell_name in m.get("workloads", (cell_name,))]


def reader(name):
    """``read(run) -> float | None`` of ``metrics/<name>.py``."""
    path = os.path.join(PKG, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_port_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(entries, run):
    """{name: {"value", "unit"}} of the entries whose reader finds a value."""
    out = {}
    for m in entries:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``desr_tpu_torch`` is not ``desr_tpu``)."""
    modules = sys.modules if modules is None else modules
    return sorted(n for n in modules if n.split(".")[0] in FORBIDDEN)


def result_line(run, metrics, device, breakdown=None):
    """The last stdout line; ``checks`` (each compared number and its limit)
    comes last."""
    line = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in run.checks}
    return line


def window_summary(run):
    """One stderr line on the window: calls, seconds, call times' quantiles."""
    def q(values):
        if not values:
            return "-"
        v = sorted(values)
        parts = [f"p{int(f * 100)} {v[min(len(v) - 1, int(f * len(v)))] * 1e3:.2f}"
                 for f in (0.1, 0.5, 0.9, 0.95, 0.99)]
        return " ".join(parts + [f"max {v[-1] * 1e3:.2f}"])
    return (f"window: {run.attempted} calls in {run.window_s:.3f} s; "
            f"latency ms {q(run.latencies_s)}; host call ms {q(run.host_call_s)}")


def check_lines(run):
    """The compared numbers beside their limits, for the end of stderr."""
    lines = [f"check {n}: {v!r} (limit {lim!r}) {'ok' if math.isfinite(v) and v <= lim else 'FAIL'}"
             for n, v, lim in run.checks]
    return lines + [f"correct: {run.correct}"]
