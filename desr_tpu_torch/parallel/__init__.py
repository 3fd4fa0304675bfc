"""Data-parallel training and serving over ``--num_devices`` ranks
(counterpart of ``desr_tpu/parallel``): ``mesh`` holds the rank record, the
batch split and the reductions, ``launch`` starts the ranks."""

from desr_tpu_torch.parallel.launch import default_backend, launch, resolve_devices  # noqa: F401
from desr_tpu_torch.parallel.mesh import (  # noqa: F401
    Shard,
    make_mesh,
    mean_over_ranks,
    reduce_grads,
    shard_batch,
)
