"""Plain PyTorch reference of the stage-3 pipeline and the work counts. It
imports nothing of ``desr_tpu_torch``, ``desr_tpu`` or ``jax``."""
