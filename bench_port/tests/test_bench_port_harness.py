"""The harness finds every cell's files and every metric's reader by name,
the work formulas give the known counts, and the last line has its schema."""

import json
import math
import os

import pytest

from bench_port import harness as H
from bench_port import trace as T
from bench_port.reference import work

BENCH = H.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_finds_its_configuration_traffic_limits_and_driver(name):
    cell = H.find_cell(BENCH, name)
    assert cell.cfg["name"] == [w for w in BENCH["workloads"] if w["name"] == name][0]["config"]
    assert H.driver(cell).run
    assert cell.limits


@pytest.mark.parametrize("name", METRICS)
def test_each_metric_has_a_reader(name):
    assert callable(H.reader(name))


def test_cell_metrics_follow_the_workloads_keys():
    serve = {m["name"] for m in H.cell_metrics(BENCH, "main.serve.b8", False)}
    assert serve == {"frames_per_s", "request_p95_ms", "peak_mem_gib", "setup_s"}
    train_layers = {m["name"] for m in H.cell_metrics(BENCH, "sr.train.b1", True)}
    assert train_layers == {"host_call_ms.train", "mfu.train", "k1_roofline.train",
                            "k3_roofline.train", "device_idle.train"}


def test_a_metric_without_workloads_goes_to_every_cell():
    bench = json.loads(json.dumps(BENCH))
    bench["per_layer"].append({"name": "x", "moves": "pairs_per_s"})
    for cell in CELLS:
        assert "x" in {m["name"] for m in H.cell_metrics(bench, cell, True)}


def test_benchmark_json_names_files_under_its_paths():
    for c in BENCH["configs"]:
        assert c["file"].startswith("bench_port/")
        assert os.path.exists(os.path.join(H.ROOT, c["file"]))
    assert BENCH["paths"] == ["bench_port"]


def test_k1_and_k3_formulas_give_the_kernel_tables_counts():
    # B=8 128x160 128->128: 48.3 GFLOP a launch, 0.04886 ms at 989 TFLOP/s
    ops = work.k1_ops(8, 128, 128, 128, 160)
    assert ops == 48_318_382_080
    assert math.isclose(ops / work.PEAK_BF16_FLOPS * 1e3, 0.04886, rel_tol=1e-3)
    assert work.k1_bytes(8, 128, 128, 128, 160) == 2 * (8 * 128 * 160 * 256 + 9 * 128 * 128)
    # K3 at 1x1024x1280: 16 B a value for the sums (0.00626 ms), 20 for the backward
    n = 1024 * 1280
    assert math.isclose(16 * n / work.PEAK_HBM_BYTES * 1e3, 0.00626, rel_tol=1e-3)
    assert math.isclose(20 * n / work.PEAK_HBM_BYTES * 1e3, 0.007825, rel_tol=1e-3)


def test_serving_work_counts_24_k1_launches_a_request():
    cell = H.find_cell(BENCH, "main.serve.b8")
    w = work.serve_work(cell.cfg, 8, (512, 640))
    assert w["k1_launches_per_call"] == 24
    assert w["k1_ops_per_call"] == 24 * work.k1_ops(8, 128, 128, 128, 160)
    assert w["k3_launches_per_call"] == 0
    assert w["flops_per_call"] > w["k1_ops_per_call"]


def test_sr_step_work_counts_42_k1_and_4_k3_launches():
    cell = H.find_cell(BENCH, "sr.train.b1")
    w = work.train_work(cell.cfg, 1, (1024, 1280), (512, 640))
    assert w["k1_launches_per_call"] == 42
    assert w["k3_launches_per_call"] == 4
    n = 1024 * 1280 + 512 * 640
    assert w["k3_bytes_per_call"] == 16 * n + 20 * n


def test_trace_summary_takes_the_union_of_device_intervals():
    events = [("a", 0.0, 10.0), ("b", 5.0, 10.0), ("a", 30.0, 5.0), ("c", 40.0, 1.0)]
    s = T.summarize(events, 100e-6, 2)
    assert math.isclose(s["busy_s"], 21e-6)
    assert s["by_name"]["a"][0] == 2 and math.isclose(s["by_name"]["a"][1], 15e-6)
    n, secs = T.kernel_time(s, ("a", "c"))
    assert n == 3 and math.isclose(secs, 16e-6)
    gaps = dict(s["gaps"])
    assert math.isclose(gaps["before a"], 15e-6) and math.isclose(gaps["before c"], 5e-6)
    b = T.breakdown(s)
    assert b["device_ops"][0][0] == "a" and len(b["idle_gaps"]) == 2


def test_result_line_has_the_driver_keys_and_checks_last():
    run = H.Run(kind="serve", batch=8, attempted=10, units=80, window_s=2.0,
                checks=[("frame_mean_gap", 0.01, 0.035), ("pixel_max_gap", 0.1, 0.27)])
    metrics = H.read_metrics(H.cell_metrics(BENCH, "main.serve.b8", False), run)
    assert metrics["frames_per_s"] == {"value": 40.0, "unit": "frames/s"}
    line = H.result_line(run, metrics, {"platform": "gpu", "kind": "x", "count": 1,
                                        "memory_peak_bytes": 1}, {"device_ops": [],
                                                                  "idle_gaps": []})
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "checks"]
    assert line["correct"] is True
    assert line["checks"]["pixel_max_gap"] == {"value": 0.1, "limit": 0.27}
    json.dumps(line)


@pytest.mark.parametrize("value,correct", [(0.01, True), (0.035, True), (0.036, False),
                                           (float("nan"), False), (float("inf"), False)])
def test_correct_holds_each_number_to_its_limit(value, correct):
    run = H.Run(kind="serve", batch=8, checks=[("frame_mean_gap", value, 0.035)])
    assert run.correct is correct
    assert ("FAIL" in H.check_lines(run)[0]) is not correct


def test_a_run_without_checks_is_not_correct():
    assert H.Run(kind="train", batch=1).correct is False


def test_readers_stay_silent_where_there_is_nothing_to_read():
    run = H.Run(kind="serve", batch=8, attempted=10, units=80, window_s=2.0)
    for name in ("pairs_per_s", "host_call_ms.train", "mfu.serve", "k1_roofline.serve",
                 "device_idle.serve", "k3_roofline.train"):
        assert H.reader(name)(run) is None, name


def test_roofline_is_silent_where_the_launch_count_differs():
    run = H.Run(kind="train", batch=1, attempted=5, window_s=1.0,
                work={"k3_launches_per_call": 4, "k3_bound_s_per_call": 1e-5},
                trace=T.summarize([("masked_loss_sums_kernel", 0.0, 5.0)] * 3, 1.0, 1))
    assert H.reader("k3_roofline.train")(run) is None
    run.trace = T.summarize([("masked_loss_sums_kernel", 0.0, 5.0)] * 4, 1.0, 1)
    assert math.isclose(H.reader("k3_roofline.train")(run), 1e-5 / 20e-6 * 100)
