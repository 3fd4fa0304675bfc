"""The faults each cell's check must catch, planted in the timed path: the
benchmark's tests run a cell with each (``tests/test_bench_port_faults.py``)
and ``calibrate.py --faults`` reads each at the cell's own sizes on the card.

Serving: half of a request's frames left out (the rest get the mean of the
served ones), and an answer altered where it is produced (two frames' depth
maps swapped). Training at batch 1 on one chip: a step that leaves the
model's state unchanged (forward, loss and backward, no Adam update); half of
a batch and the exchange between chips do not exist there.
"""

from __future__ import annotations


def half_left_out(model, batch):
    """``serve_fn``: the first half of the frames served; the rest get the
    mean of theirs."""
    import torch

    n = len(batch["B_d"]) // 2
    pred = model.serve_forward({k: v[:n] for k, v in batch.items()})
    return torch.cat([pred, pred.mean(0, keepdim=True).expand(len(batch["B_d"]) - n,
                                                              *pred.shape[1:])])


def swapped(model, batch):
    """``serve_fn``: the first two frames' predictions swapped."""
    import torch

    pred = model.serve_forward(batch).clone()
    return pred[torch.tensor([1, 0] + list(range(2, len(pred))), device=pred.device)]


def state_unchanged(model, batch, i):
    """``step_fn``: forward, loss and backward, and no Adam update."""
    model.set_input(batch)
    model.metrics = model.compute_grads()


SERVE = {"half_left_out": half_left_out, "swapped": swapped}
TRAIN = {"state_unchanged": state_unchanged}
