"""The benchmark of ``desr_tpu_torch`` on one NVIDIA H100: the cells of
``BENCHMARK.json`` at the repository's root, run by ``python3 -m
bench_port.run``. It never imports ``jax`` or ``desr_tpu``."""
