"""The data loader (counterpart of ``desr_tpu/data/loader.py``): a
``torch.utils.data.DataLoader`` whose batches are numpy arrays.

``--num_threads`` maps to ``num_workers``: decode and augmentation are numpy
work under the GIL. Workers are spawned (the trainer's process has threads,
so it does not fork) and persist across epochs; with ``num_threads <= 1``
loading is inline. The shuffle draws from a generator seeded with ``--seed``.

Under ``--device_aug`` (loader.py:50-66,144-165) the train loader is a
``DeviceLoader``: the spawned workers have no CUDA context, so the trainer's
process hands each collated batch, in pinned memory, to the dataset's
``device_finish``, which uploads it without blocking (the copy and the warp
queue behind the running step) and augments it there. The model's ``set_input``
then takes the tensors where they lie.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.data import DataLoader, Subset


def collate(samples):
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals, axis=0)
        elif isinstance(vals[0], (int, float)):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals  # strings (paths)
    return out


def collate_tensors(samples):
    """``collate`` with the arrays as tensors, which the loader can pin."""
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in collate(samples).items()}


def to_device(batch, device):
    """The batch's tensors on ``device``; from pinned memory the copies do not
    block the host."""
    return {k: v.to(device, non_blocking=True) if torch.is_tensor(v) else v
            for k, v in batch.items()}


class DeviceLoader:
    """Iterates ``loader`` and finishes each batch on ``device`` in this
    process with ``finish`` (a dataset's ``device_finish``), which uploads
    the batch and augments it there."""

    def __init__(self, loader, finish, device):
        self.loader, self.finish, self.device = loader, finish, device
        self.dataset = loader.dataset

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for batch in self.loader:
            with torch.profiler.record_function("device_finish"):
                batch = self.finish(batch, self.device)
            yield batch


def dataset_for_model(opt):
    """The dataset class of ``--model_type`` (data/__init__.py:34-42):
    I2DDataset for I2D, TranslationDataset for translation; for main,
    NaiveSRDataset under --SR, else MainDataset."""
    from desr_tpu_torch.data.i2d_dataset import I2DDataset
    from desr_tpu_torch.data.main_dataset import MainDataset
    from desr_tpu_torch.data.sr_dataset import NaiveSRDataset
    from desr_tpu_torch.data.translation_dataset import TranslationDataset

    if opt.model_type == "I2D":
        return I2DDataset
    if opt.model_type == "translation":
        return TranslationDataset
    return NaiveSRDataset if getattr(opt, "SR", False) else MainDataset


def create_dataset(opt, dataset_cls, stage="train", device=None):
    """The loader of ``dataset_cls(opt, stage)`` (loader.py:144-165), at most
    ``--max_dataset_size`` items; ``len(loader.dataset)`` is their number.
    When the dataset ships ``--device_aug`` halves, a ``DeviceLoader`` that
    finishes each batch on ``device``."""
    dataset = dataset_cls(opt, stage=stage)
    print(f"dataset [{type(dataset).__name__}] was created")
    finish = None
    if getattr(dataset, "device_aug_active", lambda: False)():
        if device is None:
            raise ValueError("--device_aug: create_dataset needs the device the batches go to")
        finish = dataset.device_finish
    n = min(len(dataset), getattr(opt, "max_dataset_size", 2 ** 31))
    if n < len(dataset):
        dataset = Subset(dataset, range(n))
    workers = int(opt.num_threads) if int(opt.num_threads) > 1 else 0
    loader = DataLoader(dataset,
                        batch_size=opt.batch_size if stage == "train" else opt.batch_size_val,
                        shuffle=not opt.serial_batches,
                        collate_fn=collate if finish is None else collate_tensors,
                        num_workers=workers,
                        generator=torch.Generator().manual_seed(getattr(opt, "seed", 0)),
                        multiprocessing_context="spawn" if workers else None,
                        persistent_workers=workers > 0,
                        pin_memory=finish is not None and torch.device(device).type == "cuda")
    return loader if finish is None else DeviceLoader(loader, finish, device)
