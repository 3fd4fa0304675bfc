"""Host I/O: image decode, frame loaders, the datasets and their loader.

``find_dataset_using_name`` and ``get_option_setter`` are the
``--dataset_mode`` registry (counterpart of ``desr_tpu/data/__init__.py`` and
``legacy_datasets.py:277-298``). The dataset modules are imported when a name
is looked up: the serving CLI's spawned workers import this package for its
decoders alone.
"""

from __future__ import annotations


def find_dataset_using_name(dataset_mode):
    """The dataset class ``--dataset_mode`` names (reference data/__init__.py:19-39)."""
    from desr_tpu_torch.data.i2d_dataset import I2DDataset
    from desr_tpu_torch.data.legacy_datasets import (AlignedDataset, SingleDataset,
                                                     TemplateDataset, UnalignedDataset)
    from desr_tpu_torch.data.main_dataset import MainDataset
    from desr_tpu_torch.data.sr_dataset import NaiveSRDataset
    from desr_tpu_torch.data.translation_dataset import TranslationDataset

    registry = {
        "unaligned": UnalignedDataset,
        "aligned": AlignedDataset,
        "single": SingleDataset,
        "template": TemplateDataset,
        "my_i2d": I2DDataset,
        "my_main": MainDataset,
        "my_naive_sr": NaiveSRDataset,
        "translation": TranslationDataset,
    }
    if dataset_mode not in registry:
        raise NotImplementedError(
            f"dataset mode [{dataset_mode}] is not registered; "
            f"available: {sorted(registry)}")
    return registry[dataset_mode]


def get_option_setter(dataset_mode):
    """The dataset's flag hook, ``setter(parser, is_train) -> parser``
    (reference data/__init__.py:42-45): the class's
    ``modify_commandline_options`` where it has one. An unknown mode adds no
    flags, as in the JAX parser, whose stages pick their dataset by
    ``--model_type``; a hook whose flags clash with the parser's raises."""
    try:
        cls = find_dataset_using_name(dataset_mode)
    except NotImplementedError:
        cls = None
    if cls is None or not hasattr(cls, "modify_commandline_options"):
        return lambda parser, is_train: parser
    return cls.modify_commandline_options
