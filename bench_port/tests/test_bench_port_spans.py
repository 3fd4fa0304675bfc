"""The attribution of device ops and idle time to the program's spans
(``bench_port/spans.py``) on synthetic records, and the spanned sub-window
of both cells rehearsed on the CPU at small sizes (host activity: no device
ops there)."""

import math

import pytest

from bench_port import spans as SP
from bench_port.tests import small

MAIN, AUTOGRAD = 11, 22
COPY = "Memcpy DtoH (Device -> Pinned)"


def _rec(ops, spans=None):
    """A spanned record on a 0 offset and 0 base (perf ns / 1000 = trace
    us). Spans: ``step`` [0, 100] us holding ``step.forward`` [10, 40]
    (``net.Task`` [20, 30] inside) and ``step.backward`` [50, 90]."""
    if spans is None:
        spans = [["step", 0, 0, None, MAIN, 0, 100_000],
                 ["step.forward", 1, 0, 0, MAIN, 10_000, 40_000],
                 ["net.Task", 2, 0, 1, MAIN, 20_000, 30_000],
                 ["step.backward", 3, 0, 0, MAIN, 50_000, 90_000]]
    launches = {corr: [t, tid] for corr, (t, tid) in ops.items() if t is not None}
    return {"window_s": 120e-6, "calls": 1, "spans": spans, "offset_ns": 0, "base_ns": 0,
            "launches": launches, "notes": [],
            "ops": [(name, ts, dur, corr) for corr, (name, ts, dur) in OPS.items()
                    if corr in ops]}


# correlation: (op, device ts, dur) / (launch host ts, thread)
OPS = {1: ("k1", 30.0, 10.0), 2: ("k2", 70.0, 20.0), 3: ("k3", 100.0, 5.0),
       4: (COPY, 110.0, 5.0)}
LAUNCHES = {1: (25.0, MAIN), 2: (60.0, AUTOGRAD), 3: (95.0, MAIN), 4: (105.0, MAIN)}


@pytest.fixture
def attr():
    return SP.attribute(_rec(LAUNCHES))


def test_device_ms_is_inclusive_and_self_leaves_children_out(attr):
    s = attr["spans"]
    assert math.isclose(s["net.Task"]["self_device_ms"], 0.010)
    assert math.isclose(s["step.forward"]["device_ms"], 0.010)
    assert s["step.forward"]["self_device_ms"] == 0.0
    assert math.isclose(s["step"]["device_ms"], 0.035)
    assert math.isclose(s["step"]["self_device_ms"], 0.005)
    assert (s["step"]["ops"], s["step"]["self_ops"]) == (3, 1)
    assert math.isclose(s[SP.CALLER]["device_ms"], 0.005)
    assert math.isclose(s["step.forward"]["host_ms"], 0.030)
    assert math.isclose(s[SP.CALLER]["host_ms"], 0.020)
    assert attr["span_ops"][0] == ["step.backward| k2", pytest.approx(20e-6)]


def test_a_launch_from_another_thread_goes_to_the_main_threads_open_span(attr):
    assert math.isclose(attr["spans"]["step.backward"]["self_device_ms"], 0.020)
    assert attr["launch_threads"] == {"spans' thread": 3, str(AUTOGRAD): 1}
    assert attr["placement"]["kernel| step.backward| step"] == 1
    assert attr["placement"][f"DtoH| {SP.CALLER}| {SP.CALLER}"] == 1


def test_idle_is_cut_at_span_edges_and_named_span_first(attr):
    """Gaps [40, 70] (step, then step.backward from 50), [90, 100] (step)
    and [105, 110] (outside every span: caller)."""
    gaps = dict((k, v) for k, v in attr["idle_gaps"])
    assert gaps == pytest.approx({"step.backward| before k2": 20e-6,
                                  "step| before k2": 10e-6, "step| before k3": 10e-6,
                                  f"{SP.CALLER}| before {COPY}": 5e-6})
    s = attr["spans"]
    assert math.isclose(s["step.backward"]["idle_ms"], 0.020)
    assert math.isclose(s["step"]["self_idle_ms"], 0.020)
    assert math.isclose(s["step"]["idle_ms"], 0.040)
    assert math.isclose(s[SP.CALLER]["idle_ms"], 0.005)
    assert all(name.split("| ")[0] in s for name, _ in attr["idle_gaps"])


def test_the_readers_count_launches_and_sum_their_spans(attr):
    assert SP.read(attr, "train", "launches.train") == 3
    assert math.isclose(SP.read(attr, "train", "backward_ms.train"), 0.020)
    assert math.isclose(SP.read(attr, "train", "forward_host_ms.train"), 0.030)
    assert SP.read(attr, "train", "adam_ms.train") is None  # no step.optimizer span


def test_an_op_without_its_launch_is_counted_apart():
    attr = SP.attribute(_rec({**LAUNCHES, 3: (None, MAIN)}))
    assert attr["launch_threads"] == {"spans' thread": 2, str(AUTOGRAD): 1, SP.UNMATCHED: 1}
    assert SP.read(attr, "train", "launches.train") == 2


@pytest.mark.parametrize("name", sorted(SP.METRICS))
def test_the_readers_return_none_without_spans(name):
    kind = SP.METRICS[name][0]
    assert SP.read(None, kind, name) is None
    assert SP.read(SP.attribute(_rec(LAUNCHES, spans=[])), kind, name) is None
    other = "train" if kind == "serve" else "serve"
    assert SP.read(SP.attribute(_rec(LAUNCHES)), other, name) is None


@pytest.mark.parametrize("which", ["serve", "train"])
def test_spanned_sub_window_rehearsed_on_the_cpu(which):
    """The tool's calls at small sizes: the spans of two calls come back,
    their mapped times within 5 ms of their record_function events."""
    import torch

    if which == "serve":
        cell = small.serve_cell()
        call, host = SP.serve_call(cell, 5, torch.device("cpu"))
        roots = ["serve"]
    else:
        cell = small.train_cell()
        call, host = SP.train_call(cell, 5, torch.device("cpu"))
        roots = ["step.stage", "step"]
    rec = SP.profile_spanned(call, 2, lambda: None, cpu=True)
    attr = SP.attribute(rec)
    names = [s[0] for s in rec["spans"] if s[3] is None]
    assert names == 2 * roots and len(host) == 2
    m = SP.mapping(rec)
    assert m["spans"] == len(rec["spans"]) and max(map(abs, m["start_gap_us"])) < 5000
    assert attr["spans"][roots[-1]]["host_ms"] > 0
