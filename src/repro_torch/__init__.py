"""PyTorch/CUDA port of ``repro`` (runs on an NVIDIA H100).

The JAX package ``repro`` is the reference; this package is its port, one
slice at a time. Ported so far:

* the paper's Phase II sweep end to end: the bit-exact threefry PRNG
  (:mod:`repro_torch.core.prng`), the neighborhood engine with its
  hand-written CUDA kernel (:mod:`repro_torch.core.neighbors`,
  :mod:`repro_torch.kernels`), the four scenarios, the batched physics
  step, the chunk planner and runner (with per-device blocks), the
  aggregation, and the launcher ``python -m repro_torch.launch.sweep``;
* the Phase III pipeline around it: trajectory recording, the sharded
  dataset, crash-atomic checkpoints (:mod:`repro_torch.ckpt`), injected
  faults, the supervised loop with pipelined host I/O, the process
  controller ``python -m repro_torch.launch.controller``, and the token
  data path from shards to LM batches (:mod:`repro_torch.data`);
* LM serving for every architecture of the reference (the dense,
  recurrent, rwkv, MoE, MLA and M-RoPE decoder-only families and the
  whisper encoder-decoder): the configs (:mod:`repro_torch.config`,
  :mod:`repro_torch.configs`), the model stack (:mod:`repro_torch.models`)
  whose full-sequence attention and prefill recurrences run hand-written
  CUDA kernels, the stub frontends, the continuous-batching engine and
  ``greedy_generate`` (:mod:`repro_torch.serve`) and ``python -m
  repro_torch.launch.serve``;
* LM training (:mod:`repro_torch.train`): AdamW, schedules, clipping,
  microbatching, remat and the checkpointed trainer, through the plain
  attention and recurrence paths as the reference trains through XLA, and
  ``python -m repro_torch.launch.train``.

Entry points run on ``cuda`` unless given ``device="cpu"``. The package
imports ``torch`` and numpy only: never ``jax``, never ``repro``.
"""
