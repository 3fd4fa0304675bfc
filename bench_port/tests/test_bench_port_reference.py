"""The plain reference agrees with the program under test on the CPU, at a
small width and in float32 (the program's bf16 path is what the card's
runs hold to the limits)."""

import numpy as np
import pytest
import torch

from bench_port import data as D
from bench_port.drivers import serve as S
from bench_port.drivers import train as T
from bench_port.tests import small


@pytest.mark.parametrize("stage", ["main", "sr"])
def test_serving_forward_matches_the_program(stage):
    cell = small.serve_cell(compute_dtype="float32")
    if stage == "sr":
        cell.cfg["stage"] = "sr"
        cell.traffic["frame_hw"] = [240, 256]
    dev = torch.device("cpu")
    (h, w), padded, lr_hw = S.grids(cell)
    depth, image = D.frames(7, cell.traffic["pool"], (h, w), dev)
    pool_d, pool_i = depth.numpy(), image.numpy()
    model = S.build_model(cell, dev, 7, torch)
    request = S.Requester(model, pool_d, pool_i, padded, cell.traffic["batch"], 7,
                          lambda m, b: m.serve_forward(b), 3)
    kept = [request(copy=True) for _ in range(3)]
    ref = S.reference_outputs(cell, 7, dev, pool_d, pool_i, range(cell.traffic["pool"]),
                              padded, lr_hw)
    frame_mean, pixel_max = S.gaps(kept, ref)
    assert kept[0][1][0].shape == (h, w)
    assert pixel_max < 2e-4, (frame_mean, pixel_max)


@pytest.mark.parametrize("stage", ["sr", "main"])
def test_train_steps_match_the_program(stage):
    cell = small.train_cell(compute_dtype="float32")
    if stage == "main":
        # the main configuration's step on the train traffic's HR grid (128x128)
        cell.cfg = small.cell("main.serve.b8", compute_dtype="float32").cfg
        cell.traffic["lr_hw"] = [64, 64]
    dev = torch.device("cpu")
    model, w0 = T.build_model(cell, 5, dev, T.hole_generator(5, dev), torch)
    pool = [D.train_batch(5, i, 1, T.lr_hw_of(cell), dev) for i in range(3)]

    def step(m, i):
        m.set_input(pool[i])
        m.optimize_parameters(i + 1)

    prog = T.checked_steps(model, step, 3, w0, cell.cfg["adam"]["betas"][0])
    ref = T.reference_steps(cell, 5, dev, 3)
    loss_gap, grad_gap, change_gap, pred_gap = T.readings(prog, ref)
    # step 1 agrees to ~1e-7; Adam's first steps move every weight by about
    # lr whatever its gradient's size, so the float32 round-off of the
    # smallest gradients' signs reaches steps 2 and 3 (~5e-5 at lr 2e-4)
    assert loss_gap < 2e-4 and grad_gap < 2e-3 and change_gap < 2e-2, (loss_gap, grad_gap,
                                                                      change_gap)
    assert pred_gap < 2e-4 and prog["pred"].shape == (2, *T.hr_hw_of(cell)), pred_gap
    assert abs(prog["losses"][0] - ref["losses"][0]) < 1e-5 * abs(ref["losses"][0])
    assert np.isfinite(prog["losses"]).all()
