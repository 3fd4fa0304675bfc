"""The data loader (counterpart of ``desr_tpu/data/loader.py``): a
``torch.utils.data.DataLoader`` whose batches are numpy arrays.

``--num_threads`` maps to ``num_workers``: decode and augmentation are numpy
work under the GIL. Workers are spawned (the trainer's process has threads,
so it does not fork) and persist across epochs; with ``num_threads <= 1``
loading is inline. The shuffle draws from a generator seeded with ``--seed``.
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


def create_dataset(opt, dataset_cls, stage="train"):
    """The loader of ``dataset_cls(opt, stage)`` (loader.py:144-165), at most
    ``--max_dataset_size`` items; ``len(loader.dataset)`` is their number."""
    dataset = dataset_cls(opt, stage=stage)
    print(f"dataset [{type(dataset).__name__}] was created")
    n = min(len(dataset), getattr(opt, "max_dataset_size", 2 ** 31))
    if n < len(dataset):
        dataset = Subset(dataset, range(n))
    workers = int(opt.num_threads) if int(opt.num_threads) > 1 else 0
    return DataLoader(dataset,
                      batch_size=opt.batch_size if stage == "train" else opt.batch_size_val,
                      shuffle=not opt.serial_batches, collate_fn=collate, num_workers=workers,
                      generator=torch.Generator().manual_seed(getattr(opt, "seed", 0)),
                      multiprocessing_context="spawn" if workers else None,
                      persistent_workers=workers > 0)
