"""PyTorch/CUDA port of the ``repro`` simulation sweep (runs on an NVIDIA H100).

The JAX package ``repro`` is the reference; this package is its port, one
slice at a time. This slice covers the paper's Phase II sweep end to end:
the bit-exact threefry PRNG (:mod:`repro_torch.core.prng`), the
neighborhood engine with its hand-written CUDA kernel
(:mod:`repro_torch.core.neighbors`, :mod:`repro_torch.kernels`), the four
scenarios, the batched physics step, the chunk planner and runner, the
aggregation, and the launcher ``python -m repro_torch.launch.sweep``.

Entry points run on ``cuda`` unless given ``device="cpu"``. The package
imports ``torch`` and numpy only: never ``jax``, never ``repro``.
"""
