"""Cells of the benchmark at sizes a CPU test holds: the configurations'
files with their widths cut (``tiny``) or whole, on small frames."""

import copy

from bench_port import harness as H

TINY_WIDTHS = {"ImageDepthf_outf": 16, "ImageDepthf_basef": 4, "I2D_base": 8,
               "Depthf_outf": 16, "Depthf_basef": 4, "Task_basef": 8}


def cell(name, tiny=True, compute_dtype=None, **traffic):
    """The cell ``name`` of BENCHMARK.json, widths cut when ``tiny``, its
    traffic overridden by ``traffic``."""
    c = copy.deepcopy(H.find_cell(H.benchmark(), name))
    if tiny:
        c.cfg["widths"].update(TINY_WIDTHS)
    if compute_dtype:
        c.cfg["compute_dtype"] = compute_dtype
    c.traffic.update(traffic)
    return c


def serve_cell(**kw):
    kw.setdefault("batch", 2)
    kw.setdefault("frame_hw", [120, 160])
    kw.setdefault("pool", 4)
    kw.setdefault("warmup_calls", 1)
    kw.setdefault("batches", 3)
    return cell("main.serve.b8", **kw)


def train_cell(**kw):
    kw.setdefault("lr_hw", [128, 128])
    kw.setdefault("pool", 4)
    kw.setdefault("warmup_steps", 1)
    return cell("sr.train.b1", **kw)
