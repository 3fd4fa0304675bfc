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

Over a data mesh of N ranks (``--num_devices``) each rank's loader draws the
same global order from ``--seed`` and decodes only its rows of each global
batch (``RankBatchSampler``); its batches come as ``parallel.Shard``s that
carry the global batch's rows (``RankLoader``). ``--num_threads`` workers
run per rank. Under ``--spatial_devices`` the S ranks of a data group
decode the same items (the data axis alone splits the batch), with the
same augmentation (``item_rng(index)``), and each keeps its band of the
frames' rows (``parallel.split_h``), which its ``Shard`` records.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.data import BatchSampler, DataLoader, RandomSampler, SequentialSampler, Subset

from desr_tpu_torch.parallel.mesh import split_h


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


class RankBatchSampler:
    """A rank's rows (``Mesh.rows``) of each index batch of ``batch_sampler``."""

    def __init__(self, batch_sampler, mesh):
        self.batch_sampler, self.mesh = batch_sampler, mesh

    def __len__(self):
        return len(self.batch_sampler)

    def __iter__(self):
        for idx in self.batch_sampler:
            lo, hi = self.mesh.rows(len(idx))
            yield idx[lo:hi]


class RankLoader:
    """Iterates a rank's ``loader`` (over a ``RankBatchSampler``) and hands
    each batch on as a ``Shard`` of the global batch of ``batch_size`` (the
    last one shorter) of which it holds the rows, and on a spatial mesh
    its band of each image value's rows (``split_h``)."""

    def __init__(self, loader, batch_size, mesh):
        self.loader, self.batch_size, self.mesh = loader, batch_size, mesh
        self.dataset = loader.dataset

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        n = len(self.dataset)
        for k, batch in enumerate(self.loader):
            size = min(self.batch_size, n - k * self.batch_size)
            yield split_h(batch, self.mesh, (*self.mesh.rows(size), size))


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


def create_dataset(opt, dataset_cls, stage="train", device=None, mesh=None):
    """The loader of ``dataset_cls(opt, stage)`` (loader.py:144-165), at most
    ``--max_dataset_size`` items; ``len(loader.dataset)`` is their number.
    When the dataset ships ``--device_aug`` halves, a ``DeviceLoader`` that
    finishes each batch on ``device``. Over a ``mesh`` of more than one rank,
    a ``RankLoader`` of this rank's rows."""
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
    batch_size = opt.batch_size if stage == "train" else opt.batch_size_val
    generator = torch.Generator().manual_seed(getattr(opt, "seed", 0))
    ranks = mesh is not None and mesh.size > 1
    if ranks:  # the sampler DataLoader builds for shuffle, over the same generator
        sampler = (SequentialSampler(dataset) if opt.serial_batches
                   else RandomSampler(dataset, generator=generator))
        split = dict(batch_sampler=RankBatchSampler(BatchSampler(sampler, batch_size, False), mesh))
    else:
        split = dict(batch_size=batch_size, shuffle=not opt.serial_batches)
    loader = DataLoader(dataset, **split,
                        collate_fn=collate if finish is None else collate_tensors,
                        num_workers=workers,
                        generator=generator,
                        multiprocessing_context="spawn" if workers else None,
                        persistent_workers=workers > 0,
                        pin_memory=finish is not None and torch.device(device).type == "cuda")
    if finish is not None:
        loader = DeviceLoader(loader, finish, device)
    return RankLoader(loader, batch_size, mesh) if ranks else loader
