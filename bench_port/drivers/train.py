"""Train steps back to back through ``MainSRModel`` (``MainModel`` for a
main configuration): ``set_input`` of a batch staged on the card, then
``optimize_parameters``, from a pool of ``pool`` seeded batches.

Set-up builds one model, loads the seeded weights and hands it the seeded
generator of its hole draws; its first ``checked_steps`` steps run on
batches 0, 1, 2 (all different) through the window's own call and are the
ones the check reads: each step's loss, the norm of each trained leaf's
first gradient (Adam's first moment after step 1 over 1 - beta1), and the
norm of each leaf's change after the checked steps. Then warm-up steps and
the window, which goes on with the same model.

The check: the plain reference, in float32 on the card after the window,
runs the same steps from the same weights, batches and hole draws. Compared,
each against the reference (``limits/<cell>.json``):
- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: the largest gap between the program's and the reference's
  norm of a leaf's first gradient, over the larger of the reference's norm
  of that leaf and of the median leaf;
- ``change_gap``: the same for the change after the checked steps;
both over the leaves whose reference gradient is at least a thousandth of
the median leaf's (the others, as a conv bias before an instance norm, have
a gradient of round-off alone, and move by it);
- ``nonfinite_losses``: the steps of the window whose loss is not finite
  (the last step's is read; 0 allowed).
"""

from __future__ import annotations

import gc
import math
import statistics
import tempfile
import time

from bench_port import data as D
from bench_port import harness as H
from bench_port.reference import stage3 as R

ALL_NETS = ("G_A_d",) + R.SERVING_NETS


def lr_hw_of(cell):
    return tuple(cell.traffic["lr_hw"])


def sr_lr_hw(cell):
    """The LR grid of an SR configuration's step, None for the main stage's."""
    return lr_hw_of(cell) if cell.cfg["stage"] == "sr" else None


def hr_hw_of(cell):
    h, w = lr_hw_of(cell)
    return 2 * h, 2 * w


def argv(cell, seed, device, checkpoints_dir):
    """The train CLI's flags of the configuration at the cell's batch and crop."""
    cfg, t = cell.cfg, cell.traffic
    out = list(cfg["flags"])
    for k, v in list(cfg["widths"].items()) + list(cfg["loss"].items()):
        out += [f"--{k}", str(v)]
    h, w = sr_lr_hw(cell) or hr_hw_of(cell)
    return out + ["--batch_size", str(t["batch"]), "--crop_size_h", str(h),
                  "--crop_size_w", str(w), "--lr", str(cfg["adam"]["lr"]),
                  "--compute_dtype", cfg["compute_dtype"], "--seed", str(D.sub_seed(seed, "opt")),
                  "--name", "bench", "--checkpoints_dir", checkpoints_dir, "--device", device]


def build_model(cell, seed, dev, hole_gen, torch):
    from desr_tpu_torch.models.main_model import MainModel
    from desr_tpu_torch.models.main_sr_model import MainSRModel
    from desr_tpu_torch.options import train_options

    with tempfile.TemporaryDirectory() as ckpt:
        opt = train_options.parse(argv(cell, seed, dev.type, ckpt), print_options=False)
    cls = MainSRModel if cell.cfg["stage"] == "sr" else MainModel
    model = cls(opt, device=dev, compute_dtype=getattr(torch, cell.cfg["compute_dtype"]),
                is_train=True, generator=torch.Generator().manual_seed(0),
                hole_generator=hole_gen)
    weights = D.weights(R.param_shapes(cell.cfg, ALL_NETS), seed, dev)
    for name in ALL_NETS:
        model.nets[name].load_state_dict(weights[name], strict=True)
    return model, weights


def leaves(nets):
    """[(name, parameter)] of the trained nets, in Adam's order."""
    return [(f"{n}.{k}", p) for n in R.TRAINED_NETS for k, p in nets[n].named_parameters()]


def norms(tensors):
    import torch

    return [float(v) for v in torch.stack([t.float().norm() for t in tensors]).cpu()]


def checked_steps(model, step, n, w0, beta1, t0=None):
    """{"losses", "grads", "changes"} of the model's first ``n`` steps
    (``step(model, i)``) from the weights ``w0``: each step's loss, each
    trained leaf's first gradient norm (from Adam's first moment), each
    leaf's change norm after the n steps."""
    import torch

    named = leaves(model.nets)
    losses, grads, preds = [], None, []
    hook = model.nets["Task"].register_forward_hook(
        lambda mod, args, out: preds.append(out.detach()[:, 0].float().cpu()))
    for i in range(n):
        step(model, i)
        losses.append(float(model.metrics["G"]))
        if t0 is not None:
            H.phase(f"checked step {i + 1}", t0)
        if i == 0:
            hook.remove()
            state = model.optimizer.state
            grads = norms([state[p]["exp_avg"] / (1 - beta1) if p in state
                           else torch.zeros_like(p) for _, p in named])
    changes = norms([p.detach() - w0[k.split(".", 1)[0]][k.split(".", 1)[1]] for k, p in named])
    return {"losses": losses, "grads": grads, "changes": changes,
            "pred": torch.cat(preds) if preds else None}


def hole_generator(seed, dev):
    return D.generator(seed, "holes", dev)


def run(cell, seed, seconds, trace, device, t0, step_fn=None):
    """Set-up (with the checked steps), window, optional profile, then the
    check. ``step_fn(model, batch, i)`` replaces the step (the tests' broken
    paths)."""
    import torch

    t = cell.traffic
    b, pool_n, n_check = t["batch"], t["pool"], t["checked_steps"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    H.phase("torch imported", t0)
    model, w0 = build_model(cell, seed, dev, hole_generator(seed, dev), torch)
    H.phase("model built, weights loaded", t0)
    pool = [D.train_batch(seed, i, b, lr_hw_of(cell), dev) for i in range(pool_n)]

    def default_step(m, batch, i):
        m.set_input(batch)
        m.optimize_parameters(i + 1)

    def step(m, i):
        (step_fn or default_step)(m, pool[i % pool_n], i)

    prog = checked_steps(model, step, n_check, w0, cell.cfg["adam"]["betas"][0], t0)
    del w0
    for i in range(n_check, n_check + t["warmup_steps"]):
        step(model, i)
    sync()
    H.phase("warm-up steps", t0)
    res = H.Run(kind="train", batch=b)
    peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    i = n_check + t["warmup_steps"]
    start = time.perf_counter()
    res.setup_s = start - t0
    while time.perf_counter() - start < seconds:
        t1 = time.perf_counter()
        step(model, i)
        res.host_call_s.append(time.perf_counter() - t1)
        res.attempted += 1
        i += 1
    sync()
    res.window_s = time.perf_counter() - start
    res.units = res.attempted * b
    last_loss = float(model.metrics["G"])
    if cuda:
        res.peak_window_bytes = torch.cuda.max_memory_allocated()
        res.peak_bytes = max(peak_setup, res.peak_window_bytes)
    if trace:
        from bench_port import trace as T
        from bench_port.reference import work

        res.trace = T.profile(lambda k: step(model, i + k), t["profile_calls"], sync)
        res.work = work.train_work(cell.cfg, b, hr_hw_of(cell), sr_lr_hw(cell))
    del model, pool
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = reference_steps(cell, seed, dev, n_check)
    res.checks = compare(cell, prog, ref)
    res.checks.append(("nonfinite_losses", 0.0 if math.isfinite(last_loss) else 1.0,
                       cell.limits["nonfinite_losses"]))
    return res


def reference_steps(cell, seed, dev, n_steps, precision="f32"):
    """{"losses", "grads", "changes"} of the reference's first ``n_steps``
    steps from the seeded weights, batches and hole draws; ``precision`` of
    its nets ("fp8": the control)."""
    import torch

    from bench_port.reference import nets as N

    b = cell.traffic["batch"]
    weights = D.weights(R.param_shapes(cell.cfg, ALL_NETS), seed, dev)
    with torch.device(dev):
        nets = R.build_nets(cell.cfg, ALL_NETS)
    for name, net in nets.items():
        net.load_state_dict(weights[name])
        N.set_precision(net, precision)
        net.requires_grad_(name in R.TRAINED_NETS)
    named = leaves(nets)
    adam = cell.cfg["adam"]
    opt = R.Adam([p for _, p in named], adam["lr"], tuple(adam["betas"]), adam["eps"])
    gen = hole_generator(seed, dev)
    lr_hw = sr_lr_hw(cell)
    losses, grads = [], None
    with H.no_tf32():
        for i in range(n_steps):
            batch = D.train_batch(seed, i, b, lr_hw_of(cell), dev)
            loss, g, pred = R.train_step(nets, batch, cell.cfg, gen, opt, lr_hw)
            losses.append(float(loss))
            if i == 0:
                grads, first_pred = norms(g), pred.float().cpu()
            del batch, g, pred
    changes = norms([p.detach() - weights[k.split(".", 1)[0]][k.split(".", 1)[1]]
                     for k, p in named])
    return {"losses": losses, "grads": grads, "changes": changes, "pred": first_pred}


def leaf_gap(prog, ref, keep=None):
    """The largest |prog - ref| of a leaf over max(ref, the median leaf's ref)."""
    med = statistics.median(ref)
    idx = range(len(ref)) if keep is None else keep
    return max((abs(prog[i] - ref[i]) / max(ref[i], med, 1e-30) for i in idx), default=0.0)


def moving_leaves(ref_grads):
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    med = statistics.median(ref_grads)
    return [i for i, g in enumerate(ref_grads) if g >= 1e-3 * med]


def pred_gap(prog, ref):
    """The largest mean |gap| of a frame of the first step's prediction."""
    p, r = prog["pred"], ref["pred"]
    if p is None or p.shape != r.shape:
        return math.inf
    return float((p.double() - r.double()).abs().mean(dim=(1, 2)).max())


def readings(prog, ref):
    """(loss_gap, grad_gap, change_gap, pred_gap) of a program's (or the
    control's) readings against the reference's."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    moving = moving_leaves(ref["grads"])
    return (loss_gap, leaf_gap(prog["grads"], ref["grads"], moving),
            leaf_gap(prog["changes"], ref["changes"], moving), pred_gap(prog, ref))


NAMES = ("loss_gap", "grad_gap", "change_gap", "pred_gap")


def compare(cell, prog, ref):
    values = [v if math.isfinite(v) else math.inf for v in readings(prog, ref)]
    return [(name, v, cell.limits[name]) for name, v in zip(NAMES, values)]
