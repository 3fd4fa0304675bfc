"""The 50%-replay image buffer of the discriminator step (counterpart of
``desr_tpu/utils/image_pool.py``, reference util/image_pool.py:5-54).

The JAX package keeps the pool as host numpy arrays; here it keeps detached
copies of the tensors it is given, on their device, so a query moves nothing
to the host. Its draws come from a ``random.Random`` the caller seeds
(``--seed``), not from Python's global generator.
"""

from __future__ import annotations

import random

import torch


class ImagePool:
    def __init__(self, pool_size=50, rng=None):
        self.pool_size = pool_size
        self.rng = rng if rng is not None else random.Random(0)
        self.images = []

    def query(self, images):
        """images: a (B, ...) tensor. Returns a batch of the same shape: while
        the pool fills, the images themselves; then each image, with
        probability 1/2, swapped for a stored one that it replaces."""
        if self.pool_size == 0:
            return images
        images = images.detach()
        out = []
        for image in images:
            if len(self.images) < self.pool_size:
                self.images.append(image.clone())
                out.append(image)
            elif self.rng.uniform(0, 1) > 0.5:
                idx = self.rng.randint(0, self.pool_size - 1)
                out.append(self.images[idx])
                self.images[idx] = image.clone()
            else:
                out.append(image)
        return torch.stack(out, dim=0)
