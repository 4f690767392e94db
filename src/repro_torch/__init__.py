"""PyTorch/CUDA port of ``repro`` (runs on an NVIDIA H100).

The JAX package ``repro`` is the reference; this package is its port, one
slice at a time. Ported so far:

* the paper's Phase II sweep end to end: the bit-exact threefry PRNG
  (:mod:`repro_torch.core.prng`), the neighborhood engine with its
  hand-written CUDA kernel (:mod:`repro_torch.core.neighbors`,
  :mod:`repro_torch.kernels`), the four scenarios, the batched physics
  step, the chunk planner and runner, the aggregation, and the launcher
  ``python -m repro_torch.launch.sweep``;
* LM serving for the dense GQA families (gemma2-2b, qwen1.5-0.5b): the
  configs (:mod:`repro_torch.config`, :mod:`repro_torch.configs`), the
  model stack (:mod:`repro_torch.models`) whose every full-sequence
  attention runs the hand-written flash attention kernel, the
  continuous-batching engine (:mod:`repro_torch.serve`) and the launcher
  ``python -m repro_torch.launch.serve``.

Entry points run on ``cuda`` unless given ``device="cpu"``. The package
imports ``torch`` and numpy only: never ``jax``, never ``repro``.
"""
