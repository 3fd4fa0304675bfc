"""The rank side of tests/test_torch_spatial_last.py: functions that
``desr_tpu_torch.parallel.launch`` runs in each spawned rank of a
``--spatial_devices`` mesh, and that the tests also call in one process.
This module imports torch and the port alone (no JAX), so that a spawned
rank starts quickly; it holds no tests.

Every function returns host values (numpy arrays, floats, ints).
"""

from unittest import mock

import torch

import test_torch_spatial_ranks as SR
import test_torch_spatial_train_ranks as STR
from desr_tpu_torch.data.loader import create_dataset, dataset_for_model
from desr_tpu_torch.models import translation_networks as TT
from desr_tpu_torch.models.main_model import MainModel


def grouped_steps(mesh, argv, batches, grouped=True, dtype=torch.float64):
    """``len(batches)`` MainModel train steps at ``dtype`` from the seeded
    init, the translator cut to one block, holes drawn from the model's
    generator: one ``optimize_parameters_multi`` group (``--steps_per_call``
    N) when ``grouped``, else ``set_input`` + ``optimize_parameters`` per
    batch. Returns the last step's metrics and gradients, the trained
    nets' weights, each staged batch's split and h_split, and the
    collectives."""
    torch.set_num_threads(2)
    with mock.patch.object(TT, "default_translator_opt", SR.small_translator), \
            STR._precision(dtype):
        model = MainModel(STR._opt(argv), device="cpu", compute_dtype=dtype, is_train=True,
                          mesh=mesh).to(dtype)
        layouts = []
        use = model.use_batch
        model.use_batch = lambda b, p: layouts.append((b.split, b.h_split)) or use(b, p)
        STR._reset()
        if grouped:
            model.optimize_parameters_multi(batches, len(batches))
        else:
            for batch in batches:
                model.set_input(batch)
                model.optimize_parameters(1)
        counts = STR._counts()
    return dict(metrics=STR._host(model.metrics), grads=STR._grads(model, model.trainable_nets),
                state=STR._state(model, model.trainable_nets), layouts=layouts, counts=counts)


def first_batch(argv, mesh=None):
    """The first train batch of ``--device_aug`` ``argv``'s loader (inline,
    finished on the CPU): this rank's ``Shard`` over a mesh, else the whole
    batch, with the S ranks' draws (``shared_draws``) in one process too.
    Returns (the batch's tensors as numpy arrays, the batch)."""
    opt = STR._opt(argv)
    loader = create_dataset(opt, dataset_for_model(opt), device="cpu", mesh=mesh)
    loader.dataset.shared_draws = True
    batch = next(iter(loader))
    return {k: v.numpy().copy() for k, v in batch.items() if torch.is_tensor(v)}, batch


def device_aug_runs(mesh, argvs, step_argv):
    """For each ``--device_aug`` argv of ``argvs`` (a stage's), this rank's
    first finished batch, its rows and h_rows; then one main step at
    float64 on ``step_argv``'s first batch (``STR.main_step``)."""
    torch.set_num_threads(2)
    out = {}
    for name, argv in argvs.items():
        arrays, batch = first_batch(argv, mesh)
        out[name] = dict(arrays=arrays, rows=batch.rows, h_rows=batch.h_rows,
                         contiguous=all(v.is_contiguous() for v in batch.values()
                                        if torch.is_tensor(v)))
    _, batch = first_batch(step_argv, mesh)
    out["step"] = STR.main_step(mesh, step_argv, batch, dtype=torch.float64)
    return out


def last_refusals(mesh, group_args, aug_args, serve_argv):
    """``grouped_steps`` and ``device_aug_runs`` on this rank, then the
    serving CLI's rank (``predict._rank_serve``) on ``serve_argv``: one
    launch."""
    from desr_tpu_torch import predict

    out = {"grouped": grouped_steps(mesh, *group_args),
           "device_aug": device_aug_runs(mesh, *aug_args)}
    out["served"] = predict._rank_serve(mesh, serve_argv)
    return out

