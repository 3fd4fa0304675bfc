"""The calibration tools run end to end on the CPU at a small width:
``calibrate.py`` gives the program's, the controls' and the faults' readings
under their keys, and ``sets.py`` the spreads the bounds are set from."""

import statistics

import pytest
import torch

from bench_port import calibrate as C
from bench_port import sets
from bench_port.tests import small

DEV = torch.device("cpu")


def test_serving_readings_name_program_controls_and_faults():
    rows = list(C.serve_readings(small.serve_cell(), [5], [5], ["fp8", "fp8_operands"], [5],
                                 ["half_left_out", "swapped"], DEV))
    (row,) = rows
    assert {"program", "control.fp8", "control.fp8_operands", "fault.half_left_out",
            "fault.swapped"} <= set(row)
    assert row["program"][0] < row["fault.half_left_out"][0]
    assert row["program"][0] < row["fault.swapped"][0]


def test_training_readings_name_program_control_and_fault():
    cell = small.train_cell()
    (row,) = list(C.train_readings(cell, [5], [5], ["fp8_operands"], [5], ["state_unchanged"],
                                   DEV))
    assert len(row["program"]) == len(row["names"]) == 4
    assert row["fault.state_unchanged"][2] == pytest.approx(1.0)
    assert row["program"][2] < 1.0


def test_spread_is_the_quartile_distance_over_the_median():
    values = [100.0, 101.0, 102.0, 103.0, 104.0, 105.0]
    q1, _, q3 = statistics.quantiles(values, n=4)
    assert sets.spread(values) == pytest.approx((q3 - q1) / 102.5)


def test_sets_summary_takes_the_widest_spread_and_leaves_out_the_first_setup():
    def line(fps, setup):
        return {"metrics": {"frames_per_s": {"value": fps}, "setup_s": {"value": setup}}}

    a = [line(v, s) for v, s in zip([100, 101, 102, 103, 104, 105], [60, 10, 10, 10, 10, 10])]
    b = [line(v, 10) for v in [100, 110, 120, 130, 140, 150]]
    s = sets.summarize([a, b])
    assert s["frames_per_s"]["widest"] == pytest.approx(sets.spread([100, 110, 120, 130, 140,
                                                                     150]))
    assert s["setup_s"]["spreads"][0] == 0.0
    assert s["frames_per_s"]["five_times"] == pytest.approx(5 * s["frames_per_s"]["widest"])
