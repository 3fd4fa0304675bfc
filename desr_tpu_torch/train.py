"""Training CLI for the stage-1 I2D model, the stage-2 translation model, the
stage-3 main model and its x2 SR fine-tune on the GPU (counterpart of the
repository's ``main.py`` for ``--model_type I2D``, ``translation`` and ``main``).

    python -m desr_tpu_torch.train --model_type I2D --do_train --do_test \
        --image_and_depth --use_scannet --batch_size 12 --lr 2e-4 [--use_D] \
        --path_A .../depth --A_add_paths .../img --path_B ... --B_add_paths ...

    python -m desr_tpu_torch.train --model_type main --do_train --do_test \
        --continue_train --use_image_for_trans --use_masked --norm_loss \
        --use_smooth_loss --batch_size 6 --name <exp> \
        --path_A .../depth --A_add_paths .../img --path_B ... --B_add_paths ... \
        --path_to_intr <scannet root> [--compute_dtype bfloat16] [--device cuda]

With ``--SR`` (e.g. ``--batch_size 1 --crop_size_h 512 --crop_size_w 640
--lr 2e-5``) it trains ``MainSRModel`` on ``NaiveSRDataset``'s HR crops
(models/__init__.py:18-20).

``--model_type I2D`` trains ``I2DModel`` on ``I2DDataset``'s jittered,
rotated 384x512 crops (models/__init__.py:12-15, data/__init__.py:34-37).

``--model_type translation`` trains ``TranslationModel`` on
``TranslationDataset``'s ``<dataroot>/train{A,B}/{img,depth}`` PNG or JPEG frames
(Lanczos to 320x320, random crops); the README's stage-2 command:

    python -m desr_tpu_torch.train --model_type translation --do_train --do_test \
        --dataroot <root> --name <exp> --batch_size 6 --crop_size_h 256 \
        --crop_size_w 256 --max_distance 5100

The epoch loop of main.py:72-178: with ``--do_train`` each batch takes one
step (``optimize_parameters(total_iters, --update_ratio)``), or with
``--steps_per_call N`` (main, SR, I2D without --use_D) each group of N
batches takes N steps queued back to back (``optimize_parameters_multi``;
the epoch's short tail is a group too, and the print, save and gallery
checks fire in the group whose window holds their iteration); the losses
print every ``--print_freq`` images (and go to ``loss_log.txt``), an HTML
gallery of the visuals is written every ``--display_freq`` images unless
``--no_html`` (an extra ``calculate(stage="train")`` on the last batch, the
train metrics restored after it; ``<checkpoints_dir>/<name>/web``),
``latest`` checkpoints are written every ``--save_latest_freq`` batches and
at each ``--save_epoch_freq``-th epoch end, and the LR steps per epoch
(``--lr_policy plateau`` on the mean test loss, or without ``--do_test`` the
last train loss); with ``--do_test`` an eval pass averages the test losses.
``--use_wandb`` logs the losses and matplotlib panels (``utils/plots.py``)
to wandb instead of the gallery, and falls back to the console when wandb
cannot be imported. ``--remat``, ``--remat_blocks`` and ``--remat_tails``
checkpoint the trained nets (``models/base_model.py``), on one card or
beside ``--spatial_devices``.

``--device_aug`` (main without ``--no_aug``, ``--SR``, I2D; no effect on
translation, as in JAX) moves the train augmentation onto the card: the
loader's workers decode, resize and draw the parameters, and the trainer's
process uploads each batch and warps it there (``data/loader.py:
DeviceLoader``, ``ops/device_aug.py``). Rotations follow the JAX package's
three-shear map, not cv2's warp. ``--profile_dir <dir>`` records the
epoch loop with ``torch.profiler`` and writes ``<dir>/trace.json`` (Chrome
trace format), with a ``train_step`` span around each step and a
``device_finish`` span around each batch's upload and warp (main.py:43-47,
180-184), and the model's spans inside them (``desr_tpu_torch/tracing.py``,
on for the profiled window). Still refused: the XLA-only switches.

``--num_devices N`` (N > 1; 0: every visible card) trains data-parallel
(``desr_tpu_torch/parallel``): N spawned ranks, NCCL on the cards (rank r on
``cuda:r``) or gloo under ``--device cpu``, each on its rows of every global
batch of ``--batch_size``, computing the step one process would compute on
the whole batch. Rank 0 alone prints, writes the loss log, the gallery, the
checkpoints and the profiler trace, and runs wandb; every rank loads.

``--spatial_devices S`` (S > 1, dividing N; every stage) makes
the N ranks N / S data groups of S ranks, JAX's 2-D mesh
(desr_tpu/parallel/mesh.py:27-43): the S ranks of a group decode the same
items with the same draws and each trains on its band of every frame's
rows, with halo rows from its neighbours
(``desr_tpu_torch/parallel/spatial.py``); the averaged gradient is the
one-process step's. ``--steps_per_call`` groups the steps there too, each
staged batch split or whole by its own rows, and under ``--device_aug``
the S ranks finish the whole frames on their cards (the warp reads rows
from anywhere in a frame) and each keeps its band, as the JAX package
augments first and shards after (main.py:53-57). The gallery and
``--save_image_folder`` take the frames gathered along H; rank 0 writes
them.

    python -m desr_tpu_torch.train --model_type main --SR ... --batch_size 1 \
        --num_devices 2 --spatial_devices 2
    python -m desr_tpu_torch.train --model_type translation ... --batch_size 6 \
        --crop_size_h 256 --crop_size_w 256 --num_devices 2 --spatial_devices 2
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from collections import OrderedDict


def sum_of_dicts(dict1, dict2, n):
    return OrderedDict([(k, dict1.get(k, 0.0) + dict2[k] / n) for k in dict2])


def at_freq(total_iters, start_iter, freq, spc, batch_size):
    """main.py:80-82: whether a check every ``freq`` images fires after the
    step (group) that ended at ``total_iters``: exactly on the multiple with
    one step a call, anywhere in the group's window with ``spc`` > 1."""
    d = (total_iters - start_iter) % freq
    return d == 0 if spc == 1 else d < batch_size * spc


def _wandb(opt, lead=True):
    """The wandb module under ``--use_wandb``, initialised on the ``lead``
    rank; None (console logging) without it or when it cannot be imported
    (main.py:33-41)."""
    if not opt.use_wandb:
        return None
    try:
        import wandb
    except ImportError:
        print("wandb not available; falling back to console logging")
        return None
    if lead:
        wandb.init(project="translation_compare")
        wandb.config.update(vars(opt))
    return wandb


def create_model(opt, device, mesh=None):
    """The model ``opt`` trains (models/__init__.py:create_model): ``I2DModel``,
    ``TranslationModel``, ``MainModel`` or under ``--SR`` ``MainSRModel``, in
    ``--compute_dtype``, its nets' weights drawn from ``--seed``, on this
    rank's ``mesh`` (one device when None)."""
    import torch

    from desr_tpu_torch.models.i2d_model import I2DModel
    from desr_tpu_torch.models.main_model import MainModel
    from desr_tpu_torch.models.main_sr_model import MainSRModel
    from desr_tpu_torch.models.translation_model import TranslationModel

    dtype = torch.float32 if opt.compute_dtype in ("float32", "f32") else torch.bfloat16
    model_cls = {"I2D": I2DModel, "translation": TranslationModel}.get(
        opt.model_type, MainSRModel if opt.SR else MainModel)
    return model_cls(opt, device=device, compute_dtype=dtype, is_train=True, mesh=mesh)


def main(argv=None):
    """Run the CLI; returns the last step's losses (the mean test losses when
    only ``--do_test`` is given; rank 0's under ``--num_devices`` N > 1)."""
    from desr_tpu_torch import parallel
    from desr_tpu_torch.options import train_options

    argv = sys.argv[1:] if argv is None else list(argv)
    opt = train_options.parse(argv)
    try:
        devices = parallel.resolve_devices(opt.device, opt.num_devices)
    except (RuntimeError, ValueError) as e:
        train_options.build_parser().error(str(e))
    train_options.check_spatial(train_options.build_parser(), opt, len(devices))
    if len(devices) > 1:
        return parallel.launch(_rank_main, devices, args=(argv,),
                               spatial=opt.spatial_devices)[0]
    return train(opt, devices[0])


def _rank_main(mesh, argv):
    """One rank of ``--num_devices`` N: ``train`` on the rank's device; the
    ranks after 0 print nothing."""
    from desr_tpu_torch.options import train_options

    opt = train_options.parse(argv, print_options=False)
    if mesh.rank == 0:
        return train(opt, mesh.device, mesh)
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        return train(opt, mesh.device, mesh)


def train(opt, device, mesh=None):
    """The epoch loop on ``device``, as rank ``mesh.rank`` of ``mesh`` (one
    process when None); returns ``main``'s losses."""
    import torch

    from desr_tpu_torch import tracing
    from desr_tpu_torch.data import native_io
    from desr_tpu_torch.data.loader import create_dataset, dataset_for_model

    # builds the decode library here, before the loader spawns its workers
    print("image decode route: %s (%s)" % native_io.route())
    model = create_model(opt, device, mesh)
    lead = mesh is None or mesh.rank == 0
    print(f"model [{type(model).__name__}] was created")
    dataset_cls = dataset_for_model(opt)
    dataset = (create_dataset(opt, dataset_cls, device=device, mesh=mesh)
               if opt.do_train else None)
    test_dataset = (create_dataset(opt, dataset_cls, stage="test", mesh=mesh)
                    if opt.do_test else None)
    if dataset is not None:
        print("The number of training images = %d" % len(dataset.dataset))
    model.setup(opt)
    from desr_tpu_torch.utils.visualizer import Visualizer

    visualizer = Visualizer(opt) if lead else None
    wandb = _wandb(opt, lead)

    profiler = None
    if opt.profile_dir and lead:
        from torch.profiler import ProfilerActivity, profile

        profiler = profile(activities=[ProfilerActivity.CPU]
                           + ([ProfilerActivity.CUDA] if device.type == "cuda" else []))
        profiler.start()
        tracing.enable()
    total_iters = opt.start_iter
    losses = {}
    plateau_metric = None
    spc = max(1, opt.steps_per_call) if model.supports_multi_step() else 1
    for epoch in range(opt.epoch_count, opt.n_epochs + opt.n_epochs_decay + opt.epoch_count):
        epoch_start = time.time()
        if opt.do_train:
            group = []
            iter_data_time = time.time()
            for data in dataset:
                iter_start = time.time()
                t_data = iter_start - iter_data_time
                if spc > 1:
                    group.append(data)
                    if len(group) < spc:
                        iter_data_time = time.time()
                        continue
                total_iters += opt.batch_size * max(len(group), 1)
                with tracing.span("train_step"):
                    if spc > 1:
                        model.optimize_parameters_multi(group, total_iters)
                        group = []
                    else:
                        model.set_input(data)
                        model.optimize_parameters(total_iters, opt.update_ratio)

                def due(freq):
                    return at_freq(total_iters, opt.start_iter, freq, spc, opt.batch_size)

                if due(opt.display_freq) and (wandb or not opt.no_html):
                    display(model, opt, visualizer, wandb, epoch, total_iters)
                if due(opt.print_freq):
                    losses = model.get_current_losses()
                    t_comp = (time.time() - iter_start) / (opt.batch_size * spc)
                    if lead:
                        visualizer.print_current_losses(epoch, total_iters, losses, t_comp,
                                                        t_data)
                    if wandb and lead:
                        wandb.log(losses, step=total_iters)
                if due(opt.save_latest_freq * opt.batch_size):
                    print("saving the latest model (epoch %d, total_iters %d)"
                          % (epoch, total_iters))
                    model.save_networks("iter_%d" % total_iters if opt.save_by_iter
                                        else "latest")
                iter_data_time = time.time()
            if group:  # the epoch's tail, shorter than --steps_per_call
                total_iters += opt.batch_size * len(group)
                with tracing.span("train_step"):
                    model.optimize_parameters_multi(group, total_iters)
            if epoch % opt.save_epoch_freq == 0:
                print("saving the model at the end of epoch %d, iters %d" % (epoch, total_iters))
                model.save_networks("latest")
                model.save_networks(epoch)
            print("End of epoch %d / %d \t Time Taken: %d sec"
                  % (epoch, opt.n_epochs + opt.n_epochs_decay, time.time() - epoch_start))
            losses = model.get_current_losses()
            if not opt.do_test and losses:
                plateau_metric = float(next(iter(losses.values())))
            model.update_learning_rate(epoch, metric=plateau_metric)

        if opt.do_test:
            mean_losses = OrderedDict()
            n = max(len(test_dataset.dataset), 1)
            for data in test_dataset:
                model.set_input(data)
                model.calculate(stage="test")
                mean_losses = sum_of_dicts(mean_losses, model.get_current_losses(),
                                           n / max(opt.batch_size_val, 1))
            if mean_losses:  # the plateau policy's metric: the mean test loss
                plateau_metric = float(next(iter(mean_losses.values())))
            if wandb and lead:
                wandb.log({"test": dict(mean_losses)}, step=total_iters)
            print("stage:  test")
            print(dict(mean_losses))
            print("=" * 85)
            if not opt.do_train:
                losses = dict(mean_losses)
        if not opt.do_train:
            break
    if profiler is not None:
        tracing.disable()
        tracing.drain()
        profiler.stop()
        os.makedirs(opt.profile_dir, exist_ok=True)
        trace = os.path.join(opt.profile_dir, "trace.json")
        profiler.export_chrome_trace(trace)
        print(f"profiler trace written to {trace}")
    return losses


def display(model, opt, visualizer, wandb, epoch, total_iters):
    """The image panels of main.py:95-120: an extra eval forward
    (``calculate(stage="train")``) on the staged batch (with
    ``--steps_per_call`` the group's last), its visuals to the wandb panels
    or the HTML gallery; the train step's metrics are restored after it.
    Every rank runs the forward (its reductions are collectives); rank 0,
    the one with a ``visualizer``, writes its rows' panels."""
    train_metrics = model.metrics
    model.calculate(stage="train")
    model.metrics = train_metrics
    if visualizer is None:
        return
    visuals = model.get_current_visuals()
    if wandb:
        from desr_tpu_torch.utils import plots

        plot_fn = {"I2D": plots.plot_I2D, "main": plots.plot_main,
                   "translation": plots.plot_translation}[opt.model_type]
        plot_fn(wandb, visuals, total_iters, stage="train")
    else:
        visualizer.display_current_results(visuals, epoch)


if __name__ == "__main__":
    main(sys.argv[1:])
