"""A run with the timed path broken underneath comes out not correct: the
harness's drivers run on the CPU (past the look for a card), at a small
width, with the cells' own limits, and each fault of ``bench_port/faults.py``
planted (``calibrate.py --faults`` reads them at the cells' own sizes)."""

import time

import pytest

from bench_port import faults as F
from bench_port import harness as H
from bench_port.tests import small

SEED = 2 ** 31 + 101


def run_serve(serve_fn=None):
    cell = small.serve_cell()
    return H.driver(cell).run(cell, SEED, 0.5, False, "cpu", time.perf_counter(),
                              serve_fn=serve_fn)


def test_sound_serving_is_correct():
    run = run_serve()
    assert run.correct, run.checks
    assert run.attempted >= 1 and run.units == run.attempted * 2


@pytest.mark.parametrize("fault", [F.half_left_out, F.swapped])
def test_broken_serving_is_not_correct(fault):
    run = run_serve(fault)
    assert not run.correct, run.checks
    assert run.checks[0][1] > run.checks[0][2]  # the frame mean gap fails


def test_a_step_that_leaves_the_state_unchanged_is_not_correct():
    cell = small.train_cell()
    run = H.driver(cell).run(cell, SEED, 0.5, False, "cpu", time.perf_counter(),
                             step_fn=F.state_unchanged)
    checks = {n: (v, lim) for n, v, lim in run.checks}
    assert not run.correct
    assert checks["change_gap"][0] == pytest.approx(1.0)
    assert checks["change_gap"][0] > checks["change_gap"][1]
