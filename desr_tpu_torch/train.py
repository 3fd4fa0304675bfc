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
``TranslationDataset``'s ``<dataroot>/train{A,B}/{img,depth}`` PNG frames
(Lanczos to 320x320, random crops); the README's stage-2 command:

    python -m desr_tpu_torch.train --model_type translation --do_train --do_test \
        --dataroot <root> --name <exp> --batch_size 6 --crop_size_h 256 \
        --crop_size_w 256 --max_distance 5100

The epoch loop of main.py:72-178: with ``--do_train`` each batch takes one
step (``optimize_parameters(total_iters, --update_ratio)``), the losses
print every ``--print_freq`` images (and go to ``loss_log.txt``), ``latest``
checkpoints are written every ``--save_latest_freq`` batches and at each
``--save_epoch_freq``-th epoch end, and the LR steps per epoch; with
``--do_test`` an eval pass averages the test losses. Not yet ported: wandb,
the HTML gallery, the profiler and ``--steps_per_call``
(options/train_options.py lists what stops the run).
"""

from __future__ import annotations

import os
import sys
import time
from collections import OrderedDict


def sum_of_dicts(dict1, dict2, n):
    return OrderedDict([(k, dict1.get(k, 0.0) + dict2[k] / n) for k in dict2])


def print_current_losses(log_name, epoch, iters, losses, t_comp, t_data):
    """Console + loss_log.txt (visualizer.py:34-41)."""
    message = "(epoch: %d, iters: %d, time: %.3f, data: %.3f) " % (epoch, iters, t_comp, t_data)
    for k, v in losses.items():
        message += "%s: %.3f " % (k, v)
    print(message)
    with open(log_name, "a") as f:
        f.write(f"{message}\n")


def main(argv=None):
    """Run the CLI; returns the last step's losses (the mean test losses when
    only ``--do_test`` is given)."""
    import torch

    from desr_tpu_torch import resolve_device
    from desr_tpu_torch.data.loader import create_dataset, dataset_for_model
    from desr_tpu_torch.models.i2d_model import I2DModel
    from desr_tpu_torch.models.main_model import MainModel
    from desr_tpu_torch.models.main_sr_model import MainSRModel
    from desr_tpu_torch.models.translation_model import TranslationModel
    from desr_tpu_torch.options import train_options

    opt = train_options.parse(argv)
    try:
        device = resolve_device(opt.device)
    except RuntimeError as e:
        train_options.build_parser().error(str(e))
    dtype = torch.float32 if opt.compute_dtype in ("float32", "f32") else torch.bfloat16
    model_cls = {"I2D": I2DModel, "translation": TranslationModel}.get(
        opt.model_type, MainSRModel if opt.SR else MainModel)
    model = model_cls(opt, device=device, compute_dtype=dtype, is_train=True)
    print(f"model [{model_cls.__name__}] was created")
    dataset_cls = dataset_for_model(opt)
    dataset = create_dataset(opt, dataset_cls) if opt.do_train else None
    test_dataset = create_dataset(opt, dataset_cls, stage="test") if opt.do_test else None
    if dataset is not None:
        print("The number of training images = %d" % len(dataset.dataset))
    model.setup(opt)
    log_name = os.path.join(opt.checkpoints_dir, opt.name, "loss_log.txt")
    with open(log_name, "a") as f:
        f.write(f"================ Training Loss ({time.strftime('%c')}) ================\n")

    total_iters = opt.start_iter
    losses = {}
    for epoch in range(opt.epoch_count, opt.n_epochs + opt.n_epochs_decay + opt.epoch_count):
        epoch_start = time.time()
        if opt.do_train:
            iter_data_time = time.time()
            for data in dataset:
                iter_start = time.time()
                t_data = iter_start - iter_data_time
                total_iters += opt.batch_size
                model.set_input(data)
                model.optimize_parameters(total_iters, opt.update_ratio)
                if (total_iters - opt.start_iter) % opt.print_freq == 0:
                    losses = model.get_current_losses()
                    t_comp = (time.time() - iter_start) / opt.batch_size
                    print_current_losses(log_name, epoch, total_iters, losses, t_comp, t_data)
                if (total_iters - opt.start_iter) % (opt.save_latest_freq * opt.batch_size) == 0:
                    print("saving the latest model (epoch %d, total_iters %d)"
                          % (epoch, total_iters))
                    model.save_networks("iter_%d" % total_iters if opt.save_by_iter
                                        else "latest")
                iter_data_time = time.time()
            if epoch % opt.save_epoch_freq == 0:
                print("saving the model at the end of epoch %d, iters %d" % (epoch, total_iters))
                model.save_networks("latest")
                model.save_networks(epoch)
            print("End of epoch %d / %d \t Time Taken: %d sec"
                  % (epoch, opt.n_epochs + opt.n_epochs_decay, time.time() - epoch_start))
            losses = model.get_current_losses()
            model.update_learning_rate(epoch)

        if opt.do_test:
            mean_losses = OrderedDict()
            n = max(len(test_dataset.dataset), 1)
            for data in test_dataset:
                model.set_input(data)
                model.calculate(stage="test")
                mean_losses = sum_of_dicts(mean_losses, model.get_current_losses(),
                                           n / max(opt.batch_size_val, 1))
            print("stage:  test")
            print(dict(mean_losses))
            print("=" * 85)
            if not opt.do_train:
                losses = dict(mean_losses)
        if not opt.do_train:
            break
    return losses


if __name__ == "__main__":
    main(sys.argv[1:])
