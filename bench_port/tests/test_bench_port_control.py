"""The control, the reference computed in float8 and put in the program's
place, fails each cell's check: on the CPU at the cells' widths on small
frames here, and on the card at the cells' own sizes (``cuda``), where the
float8 of the convolutions' operands alone fails it too."""

import pytest
import torch

from bench_port import data as D
from bench_port.drivers import serve as S
from bench_port.drivers import train as T
from bench_port.tests import small


def serve_control(cell, seed, dev, precision="fp8"):
    (h, w), padded, lr_hw = S.grids(cell)
    depth, image = D.frames(seed, cell.traffic["pool"], (h, w), dev)
    pool_d, pool_i = depth.cpu().numpy(), image.cpu().numpy()
    frames = range(cell.traffic["pool"])
    ref = S.reference_outputs(cell, seed, dev, pool_d, pool_i, frames, padded, lr_hw)
    ctrl = S.reference_outputs(cell, seed, dev, pool_d, pool_i, frames, padded, lr_hw, precision)
    b = cell.traffic["batch"]
    kept = [(list(range(i, i + b)), [ctrl[k] for k in range(i, i + b)])
            for i in range(0, len(frames), b)]
    return dict(zip(("frame_mean_gap", "pixel_max_gap"), S.gaps(kept, ref)))


def train_control(cell, seed, dev, precision="fp8"):
    ref = T.reference_steps(cell, seed, dev, cell.traffic["checked_steps"])
    ctrl = T.reference_steps(cell, seed, dev, cell.traffic["checked_steps"], precision)
    return dict(zip(T.NAMES, T.readings(ctrl, ref)))


def failed(readings, limits):
    return [n for n, v in readings.items() if not v <= limits[n]]


def test_serving_control_fails():
    cell = small.serve_cell(tiny=False)
    assert failed(serve_control(cell, 3, torch.device("cpu")), cell.limits)


def test_training_control_fails():
    cell = small.train_cell(tiny=False)
    assert failed(train_control(cell, 3, torch.device("cpu")), cell.limits)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp8", "fp8_operands"])
@pytest.mark.parametrize("seed", [11, 2 ** 31 + 12, 3 * 10 ** 9 + 13])
def test_control_fails_at_the_cells_own_sizes(cuda_device, seed, precision):
    for name in ("main.serve.b8", "sr.train.b1"):
        cell = small.cell(name, tiny=False)
        control = serve_control if cell.traffic["driver"] == "serve" else train_control
        assert failed(control(cell, seed, cuda_device, precision), cell.limits), name


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [21, 2 ** 31 + 22, 3 * 10 ** 9 + 23])
def test_faults_fail_at_the_cells_own_sizes(cuda_device, seed):
    from bench_port import calibrate as C

    cell = small.cell("main.serve.b8", tiny=False)
    (row,) = C.serve_readings(cell, [], [], [], [seed], ["half_left_out", "swapped"],
                              cuda_device)
    for fault in ("half_left_out", "swapped"):
        assert failed(dict(zip(row["names"], row[f"fault.{fault}"])), cell.limits), fault
    cell = small.cell("sr.train.b1", tiny=False)
    (row,) = C.train_readings(cell, [], [], [], [seed], ["state_unchanged"], cuda_device)
    assert failed(dict(zip(row["names"], row["fault.state_unchanged"])), cell.limits)
