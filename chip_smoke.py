#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. card   — ``nvidia-smi`` name and power limit, ``torch.cuda`` device name;
2. build  — compile ``src/repro_torch/kernels/csrc/{idm,flash_attention,
   rglru,wkv6}.cu`` with nvcc, one ``build.load`` per source, all four
   started together; phase 3 starts once ``idm.cu`` is built, and the
   other three are joined after it;
3. kernels — hold each sweep kernel against its plain PyTorch version
   on the card (``neighbor_kernel`` bit-exact on all six outputs;
   ``idm_accel_kernel`` within rtol = atol = 1e-6, because its IDM epilogue
   divides, takes a square root and sums in an order the compiler may
   schedule differently from PyTorch's element-wise kernels), at the sweep's
   own shapes (table builds in rows mode, row q asking for lane q, and the
   own-lane query), random query lanes, larger shapes, 65536 instances and
   8193 slots (past the sort's 8192, where the all-pairs kernel answers),
   and time kernel, plain version and bound beside the card's launch floor
   (a one-element in-place add, timed alike); the main table build's line
   carries its bar of 0.008 ms and target of 0.004 ms. ``idm_accel_kernel``
   (which sorts and searches up to 8192 slots) must also equal its
   all-pairs form (``idm._idm_accel_wide``) bit for bit at every shape,
   B 256/1024 x N 128, 48 x 512, 65536 x 16, 2 x 8192 and 2 x 8193, and
   each line up to 8192 slots times both forms; both bounds count the
   comparisons a sort and binary searches need, not all-pairs tests;
4. sweep  — the port's launcher in-process at full width (1024 instances,
   128 slots, the four-scenario mix, grouped dispatch, ``--neighbor-impl
   cuda``, ``--devices 1``) for 400 steps in chunks of 200 (the full 1200
   steps run in 7b): completion must reach 1.0 and the neighbor kernel's
   launch count must equal 2 x chunk_steps x the batched chunk calls made;
5. reference — a small sweep on the card (``cuda`` impl) against the same
   sweep on the CPU (``sort`` impl): integer counters equal, floats close;
6. parity — 64 instances, 200 steps: the ``cuda`` and ``sort`` impls on the
   card must give a bit-identical final ``SweepState``;
6a. blocks — phase 6's sweep through 2 and 4 blocks on one card
   (``devices=[cuda:0] * k``, a stream each) and, where there are as many
   cards, on distinct cards: each final ``SweepState`` must equal phase
   6's bit for bit and the neighbor launches must equal 2 x chunk_steps x
   the batched calls made; then phase 4's sweep at full width through 2
   blocks on one card for one chunk of 50 steps, its instance-steps/s and
   vehicle-steps/s beside phase 4's;
7. profile — host ms per step of one sweep group (5 steps), and under
   ``torch.profiler`` (device activity only) the device's busy time, its
   share of the profiled wall time and of the unprofiled step, and the
   heaviest kernels;
7a. record — the recording sweep in-process on the card (64 instances, 128
   slots, 200 steps in chunks of 50, the four-scenario mix, grouped,
   ``cuda`` neighbors, a row every 10 steps, 8 recorded slots): a
   fault-free ``run_supervised`` with a ``DatasetWriter`` and checkpoints
   (neighbor launches = 2 x chunk_steps x its batched chunk calls), and the
   same sweep under ``FaultModel.random_model`` (crashes, hangs,
   stragglers, one poison instance; 8 workers) killed after its third
   chunk, before its last (asserted), and resumed from its checkpoint and
   journal, its journal holding every fault kind (asserted); the final
   states and every
   array of every shard must agree, bit for bit (or, where the card gives
   other bits, naming the field, within the CPU sweep tests' tolerance),
   on every instance but the poison one, which must be quarantined; and
   recording off (phase 6's ``cuda`` run of the same sweep) must give the
   same final state as recording on; both runs once more pipelined (the
   fault-free one through 2 blocks on one card): states, every shard
   array and the faulted run's journal bit-equal to the synchronous runs';
7b. pipeline — the gate: ``python -m repro_torch.launch.controller
   --chaos-kills 2`` over the full-size recording sweep, through the
   launcher's default pipelined I/O and ``--devices 1`` (1024 instances,
   128 slots, 1200 steps in chunks of 200, the four-scenario mix, grouped,
   ``cuda`` neighbors, 8 workers, crash 0.1, hang 0.05, straggler 0.05,
   one poison instance, a row every 10 steps, 8 slots, shards of 64): the
   controller must exit 0 with eligible completion 1.0, ``verify_shards``
   must repair nothing, the dataset must hold the 1023 other instances
   once each, and the final worker's neighbor launches must equal 2 x
   chunk_steps x its batched chunk calls; prints the wall time and the
   instance-steps/s beside phase 4's, chunks, restarts, faults by kind, the host seconds of each
   chunk's checkpoint save, shard drain and whole commit on the I/O
   thread and the loop's wait for it, and the dataset's bytes;
7c. tokens — 7b's dataset as LM inputs: its token corpus
   (``shard_token_corpus``) and 4 ``sim_token_batches`` of 8 x 1024 on the
   card for gemma2-2b; prints their shape and vocabulary;
7d. train — training through the plain attention and recurrence paths,
   every hand kernel's launch count 0 in each part: (a) qwen1.5-0.5b,
   gemma2-2b, recurrentgemma-2b, rwkv6-3b, olmoe-1b-7b, minicpm3-4b,
   deepseek-v2-236b, whisper-large-v3 (batches with frames) and
   qwen2-vl-2b (batches with the vision stub's M-RoPE positions) reduced,
   on the card and on the CPU from the same seeded weights and batch: the loss's gradient
   (the MoE aux loss in it), leaf by leaf, in f32 within rtol 1e-4 plus
   3e-5 of the leaf's largest entry and in bf16 within rtol 2^-6 plus
   2^-5 of it and an L2 error of 2^-5 (an MoE arch's bf16 gradient on the
   card with the CPU run's routing, ``moe_routes(replay=)``: the two
   devices round bf16 apart and break near ties apart; the tokens routed
   otherwise on their own are printed), every parameter's gradient
   nonzero on the card (through the
   logits product's own backward); then 2 f32 steps (4 x 64 in 2
   microbatches, weight decay 0.1) from the same weights and batches: the
   loss within rtol 1e-5, the gradient norm within 1e-4, the first moments
   after step 1 as the f32 gradient; (b) the
   reduced qwen (bf16) on the card: two straight 4-step runs, then 2
   steps, a checkpoint, a new ``Trainer`` restoring it and 2 more, bit for
   bit equal to the straight runs if those agree bit for bit, else within
   their printed difference; (c) qwen1.5-0.5b at full width (bf16, f32
   moments) through ``python -m repro_torch.launch.train``'s ``main`` on
   7b's dataset: 4 steps of 8 x 4096 in 4 microbatches, ``--remat full``,
   a checkpoint; every loss finite, step 4's below step 1's; prints per
   step the seconds, tokens/s, loss and model FLOPs share
   (``launch/roofline.py::model_flops``, 6 x the active non-embedding
   parameters x tokens/s, over the bf16 dense peak; the share by all
   parameters beside it), the peak memory, the checkpoint's bytes and
   save seconds, and one more step under ``torch.profiler`` (device busy
   share, heaviest kernels), each with the card's name and power limit;
8. attention — ``flash_attention`` against ``ref_attention`` at gemma2-2b's
   prefill shapes (B 1, H 8, K 4, D 256, S 37/512/6000, global and local
   window 4096, softcap 50), once more at S 512 with q scaled by 20 so that
   the scores reach the cap, at qwen1.5-0.5b's (H = K = 16, D 64) and at
   recurrentgemma-2b's local layers (H 10, K 1, D 256, window 2048, no
   softcap, S 512/2100/6000; 2100 puts the window edge off the tile grid),
   in bf16 (the wgmma kernel; rtol 2e-2, atol 8e-3) and f32 (the CUDA-core
   kernel; rtol 2e-3, atol 2e-4), the tolerances of
   ``tests/test_kernels.py``; kernel (with its TFLOP/s, 4·D per live pair
   per head, and its share of the bound in bf16), plain version, bound and
   the library call timed:
   ``scaled_dot_product_attention`` for the causal shapes without softcap,
   compiled ``flex_attention`` (softcap ``score_mod``, causal/window block
   mask, GQA) for the other shapes in bf16 at S 6000 only (two compiles;
   each held against ``ref_attention`` first; the port never calls
   either); then 64 seeded
   q x 20 draws at gemma2-2b's global S 512 shape in bf16: none may cross
   the bf16 tolerance; prints the largest ratio of error to tolerance, and
   the same for a plain attention that rounds p to bf16 before
   normalising (where the first Hopper build rounded it); then the MLA
   route (``models/attention.py::mla_attention``) at minicpm3-4b's shape
   (H = K = 40, q/k 96 and v 64 zero-padded to 128, S 512/2048/6000) and
   deepseek-v2-236b's (H = K = 128, q/k 192 and v 128 padded to 256, S
   512/2048), bf16 and f32: the sliced context against ``ref_attention``
   on the unpadded tensors at the same tolerances; the kernel timed on
   the padded tensors, its bound from the unpadded work (2·(dn + dr) +
   2·dv flops a live pair), the plain version and SDPA on the unpadded
   tensors (minicpm3-4b also at S 2048, its served prompts' length); then
   the shapes the encoder-decoder and M-RoPE families give the kernel
   (``FLASH_NEW_SHAPES``): whisper's non-causal encoder (B 1 and 4, S
   1500, H 20, D 64), its decoder's causal prompt (B 4, S 224), its cross
   attention (B 4, Sq 224 over Sk 1500) and its decode step's (B 4, one
   query row over 1500 keys), qwen2-vl's causal S 6000 (and B 4, S 2048)
   with 12 heads over 2 KV heads of 128, olmoe-1b-7b's S 2048 (H 16, D
   128) and gemma2-9b's S 5000 (H 16 over 8 of 256, softcap 50, global and
   local window 4096): bf16 and f32 at the same tolerances (bf16 only at
   the three shapes timed to price bf16 launches: the B 4 encoder, the
   decoder prompt, the M-RoPE streams), one launch each, with bound,
   plain version and SDPA (none with a softcap); then the head dims of
   the reduced configs (16) and of the Pallas kernel's tests (32)
   (``FLASH_SMALL_D_SHAPES``, bf16 and f32, the same tolerances): the
   reduced gemma2 prompt (B 1, S 9, H = K = 4, window 16, softcap 50), a
   ragged S 300 with window, softcap and GQA 2:1, a causal S 1000 with
   GQA 2:1, and B 4, S 2048, H 8 over K 2, each with bound, plain
   version and SDPA where it computes the same function;
9. recurrences — ``rglru_linear_scan`` against ``ref_rglru`` (B 1 and 4,
   W 2560, S 37/512/6000 with mild decays and at B 1, S 6000 strong ones
   with exact zeros and ones; ys rtol 2e-2 atol 2e-3 in bf16, 1e-5 in f32,
   h_final 1e-4; each line with its share of the bound, the main shape's
   with its bar of 0.20 ms and target of 0.110 ms) and ``wkv6`` against
   ``ref_wkv6`` (B 1, H 40, K = V = 64,
   S 37/512/4096/6000 with mild decays and S 6000 with strong ones that
   include exact zeros and ones; 5e-2 in bf16, 1e-4 in f32, the state 1e-3),
   x or r/k/v in bf16 and f32, the tolerances of ``tests/test_kernels.py``;
   two chunks through ``h0``/``s0`` equal one; kernel and bound timed, and
   the plain version (a Python loop over S) at S ≤ 1024 and, in one
   trial, on each main shape's line (B 1, S 6000, mild decays, f32); each
   wkv6 line with its share of the bound and the main shape's with its bar
   of 1.0 ms and target of 0.30 ms (no single PyTorch call computes either
   recurrence);

then, for each served model in turn (gemma2-2b, recurrentgemma-2b,
rwkv6-3b, then olmoe-1b-7b and minicpm3-4b at ``SERVE_MOE_MLA``'s shorter
traffic), freeing each before the next:

10. serve — the model at full width (bf16, seeded random weights) through
   the serve launcher: 8 requests (prompt lengths 16..7999 drawn from
   seed 0) through 4 slots, max_seq 8192, 32 new tokens each; every
   request must complete with 32 tokens, and each kernel must have
   launched once per layer of its kind per prefill (flash_attention per
   attention layer, rglru_linear_scan per Griffin block, wkv6 per rwkv
   layer; the counts set to 0 just before and read just after); prints
   time to first token and prefill/decode tokens/s;
11. serve vs plain — one long prompt's (longer than the model's local
   window) last-position prefill logits through the kernels against the plain path (``attention_impl("xla")``
   and ``recurrence_impl("plain")``), full width: in f32 within rtol =
   atol = 1e-3; in bf16 the kernels' distance to the f32 logits at most
   1.25x the plain path's (``serve_vs_plain`` says why the bf16 paths are
   not held to 3e-2 of each other);
12. serve profile — one 6000-token prefill and 2 decode steps at 4 slots
   under ``torch.profiler`` (device activity only): device busy time and
   share, each kernel's time and share, the heaviest kernels;
13. engine = greedy — the model at full width in f32: the engine's tokens
   (6 requests through 4 slots) equal per-request greedy prefill + decode.

olmoe-1b-7b and minicpm3-4b run 10-13 with 4 requests (prompts 16..2047
from seed 0) of 16 new tokens, max_seq 4096, phases 11 and 12 at 2048
tokens and 13 with 3 requests; flash launches once per attention layer
per prefill (16 and 62). olmoe prints the MoE choices dropped past
capacity per prefill and per decode step (and in 13's engine run); phase
11 prints, per MoE layer, the tokens whose experts differ between the
kernel and plain paths, holds f32 as above with each path routing on its
own, and holds bf16 with the plain paths routed as the bf16 kernel path
(near ties break apart in bf16, and a moved choice moves who is dropped
after it), printing the distances of the paths routing on their own
beside it. Then deepseek-v2-236b at its published widths cut to 2 layers
(the dense first layer and one MoE layer; 5.36 B parameters) runs phase
11 at 2048 tokens: flash launched once per layer in each kernel prefill.

Then whisper-large-v3 at full width (bf16, seeded random weights) through
``greedy_generate(..., extras={"frames": ...})`` (``WHISPER``: 4 requests,
frames [4, 1500, 1280] from the audio stub, 224-token prompts, 32 new
tokens; the engine serves token requests only, as the reference's):
flash launched 3 x 32 in the prefill and 32 a decode step; the encoder's,
the prefill's (time to first token) and the decode steps' host seconds,
the peak memory; phase 11 on one request's prefill, phase 12 (one
prefill, one decode step), and the f32 model's tokens through the
kernels equal to the plain path's. qwen2-vl-2b runs phases 10-13 as the
dense models (text through the engine: plain RoPE, as the reference's
engine serves it; phase 11 at 6000 tokens) and its M-RoPE path: 4 vision
streams of 2048 tokens from the vision stub through ``greedy_generate``
with their positions (flash once per layer; the logits moved from plain
RoPE's), with phase 11 on that prefill. gemma2-9b at its published widths
cut to one local and one global layer runs phase 11 at 5000 tokens. The
script prints these phases' seconds.

14. dryrun — the dry-run tooling (``launch/{costing,dryrun,roofline}.py``,
   ``sharding``) held against the card (``DRYRUN``, ``dryrun_phase``):
   (a) building qwen1.5-0.5b's bf16 parameters and f32 AdamW state asks
   the allocator for the one-card plan's bytes (``plan_bytes``) within
   512 bytes a tensor; (b) the costing's ``meta`` FLOPs equal
   ``FlopCounterMode``'s on the card exactly, for one 2 x 4096 microbatch
   of 7d(c)'s step (forward and backward, plain attention, remat full) and
   for gemma2-2b's 6000-token prefill through the kernels (the card's
   aten count plus the flash formula for each of its 26 launches); (c)
   prints the roofline terms and bound of 7d(c)'s step and of phase 12's
   prefills at the H100's rates beside their measured times
   (``roofline_mfu``, the bound over the time), the model FLOPs shares and
   7d(c)'s predicted and measured peak memory; (d) prints
   deepseek-v2-236b's serving plan at its 60 layers on meshes of 1, 4 and
   8 cards. The ``meta`` counts (``dryrun_counts``, ~40 s of host time)
   run in a spawned process of their own from phase 5 on.
15. serve defaults — ``python -m repro_torch.launch.serve`` with no flags
   (``serve_defaults_phase``): the reduced qwen1.5-0.5b, head dim 16, 8
   requests of 16 tokens through 4 slots; every request must complete and
   flash_attention must launch once per layer per prefill;
16. examples — every ``examples_torch`` example on the card at its own
   widths (``examples_phase``; ``EXAMPLE_CUTS`` and ``MERGE_STEPS`` cut
   steps and are printed; each example's output goes to
   ``build/chip_smoke_run/examples/``): serve_lm (reduced gemma2-2b, D 16:
   flash once per layer per prefill, the prompt's logits through the
   kernel against ``attention_impl("xla")`` within the bf16 tolerance,
   the greedy tokens that differ printed), quickstart (completion 1.0,
   its aggregate equal to the same example's on the CPU), scenario_zoo
   (completion 1.0 in every sweep), merge_study (``run_points``: 20
   (point, seed) rows in one batched rollout; throughput and merges
   positive), phase3_dataset
   (completion 1.0, every instance in the dataset, ce falls) and train_lm
   (losses finite); each example's seconds.

The script prints every phase's seconds, then the kernels JSON and the
``nvidia-smi`` line; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N_LANES = 4                       # 3 main lanes + ramp, as the sweep
# phase 4: the sweep at full width for 400 steps in two chunks of 200 (7b's
# chunks; every chunk steps all instances, so its rate is the sweep's); the
# sweep's full depth of 1200 steps runs recorded, faulted and gated in 7b
SWEEP = dict(instances=1024, slots=128, steps=400, chunk_steps=200)
# phase 6: the cuda = sort parity sweep, which phase 6a replays through
# blocks and phase 7a records. Its depth sets the time of all three phases,
# gates over host-bound sweeps: at 200 steps every gate holds, and 7a's
# faulted run (four chunks of 50, killed after the third) still draws a
# crash, a hang, a straggler and the poison instance's failures, which 7a
# asserts
PARITY = dict(instances=64, steps=200)
# phase 7a: a fault-free and a faulted, killed and resumed recording sweep
RECORD = dict(instances=PARITY["instances"], slots=128,
              steps=PARITY["steps"], chunk_steps=50,
              record_every=10, k_slots=8, workers=8, shard_size=16, poison=37)
# phase 7b: the controller over the full-size recording sweep, chunks of 200
# steps (six chunks, so both chaos kills land mid-run), 8 workers (the
# paper's instances per node)
PIPELINE = dict(instances=1024, slots=128, steps=1200, chunk_steps=200,
                workers=8, fail_prob=0.1, hang_prob=0.05, straggler_prob=0.05,
                poison=517, record_every=10, record_slots=8, shard_size=64,
                chaos_kills=2, timeout_s=900)
# phase 7c: LM batches of phase 7b's dataset
TOKENS = dict(batch=8, seq=1024, batches=4)
# phase 7d: training. (a) the seven archs reduced, 2 steps on the card and on
# the CPU from the same weights and batches (f32), and a bf16 gradient on
# the card; (b) the reduced qwen resumed from a checkpoint; (c) qwen1.5-0.5b
# at full width on phase 7b's dataset through the launcher (sequences of
# 4096, the reference's train_4k shape, in 4 microbatches of 2)
TRAIN_ARCHS = ("qwen1.5-0.5b", "gemma2-2b", "recurrentgemma-2b", "rwkv6-3b",
               "olmoe-1b-7b", "minicpm3-4b", "deepseek-v2-236b",
               "whisper-large-v3", "qwen2-vl-2b")
TRAIN_SMALL = dict(steps=2, batch=4, seq=64, microbatches=2, lr=1e-3,
                   weight_decay=0.1)
# card against CPU gradients, leaf by leaf (``grads_close``): f32 at the
# parity tests' rtol 1e-4 with an atol of a fraction of each leaf's largest
# entry (rwkv6-3b's, through the plain WKV6 loop over S, differ most;
# phase 7d prints each arch's largest difference); bf16 as
# tests/test_torch_train_parity.py holds bf16 against the reference (rtol
# 2^-6, atol 2^-5 of the largest entry, L2 error 2^-5)
TRAIN_GRAD_TOL = {"float32": dict(rtol=1e-4, atol_frac=3e-5),
                  "bfloat16": dict(rtol=2.0**-6, atol_frac=2.0**-5,
                                   l2=2.0**-5)}
TRAIN_FULL = dict(arch="qwen1.5-0.5b", steps=4, batch=8, seq=4096,
                  microbatches=4, remat="full")
# phase 6a: phase 4's sweep at full width timed through 2 blocks on one card
# for one chunk of 50 steps (every chunk of phase 4 steps all instances, so
# one chunk's rate is the sweep's; the short chunk keeps the script inside
# its time limit on slower hosts)
BLOCKS_FULL = dict(instances=1024, steps=50)
WORK = ROOT / "build" / "chip_smoke_run"  # checkpoints, datasets, journals
SOURCE = "src/repro_torch/kernels/csrc/idm.cu"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
RGLRU_SOURCE = "src/repro_torch/kernels/csrc/rglru.cu"
WKV6_SOURCE = "src/repro_torch/kernels/csrc/wkv6.cu"
FLASH_TOL = {"bfloat16": dict(rtol=2e-2, atol=8e-3),
             "float32": dict(rtol=2e-3, atol=2e-4)}
FLASH_MARGIN_DRAWS = 64
SERVE = dict(requests=8, slots=4, max_seq=8192, max_new=32, min_prompt=16,
             max_prompt=8000)
# (arch, prompt length of the serve-vs-plain phase): longer than each local
# window (gemma2 4096, recurrentgemma 2048), so the window masks keys; the
# plain WKV6 is a Python loop over the sequence, hence rwkv6's shorter prompt
SERVE_ARCHS = (("gemma2-2b", 5000), ("recurrentgemma-2b", 3000),
               ("rwkv6-3b", 2048))
# the MoE and MLA families at full width: 4 requests (prompts 16..2047) of 16
# new tokens through 4 slots, phases 11-12 at 2048 tokens, phase 13 with 3
# requests; shorter than the others' so that the two models and deepseek's
# phase 11 add at most ~90 s to the script
SERVE_MOE_MLA = dict(requests=4, slots=4, max_seq=4096, max_new=16,
                     min_prompt=16, max_prompt=2048)
MOE_MLA_ARCHS = ("olmoe-1b-7b", "minicpm3-4b")
MOE_MLA_PROMPT = 2048
ENGINE_REQUESTS = {"olmoe-1b-7b": 3, "minicpm3-4b": 3}
# deepseek-v2-236b (472 GB of bf16 weights at 60 layers) at its published
# widths cut to its dense first layer and one MoE layer: phase 11 only
DEEPSEEK = dict(arch="deepseek-v2-236b", n_layers=2, prompt=2048)
# gemma2-9b at its published widths cut from 42 layers to one local and one
# global: phase 11 only, the prompt past the 4096 window
GEMMA9 = dict(arch="gemma2-9b", n_layers=2, prompt=5000)
# whisper-large-v3 at full width through greedy_generate (the engine takes
# token requests only): 4 requests, frames [4, 1500, 1280] from the audio
# stub at seed 0, decoder prompts of 224 tokens (half of the decoder's 448
# positions) from seed 0, 32 new tokens, max_seq 256
WHISPER = dict(arch="whisper-large-v3", batch=4, frames=1500, prompt=224,
               new=32, max_seq=256)
# qwen2-vl-2b at full width: (a) phases 10-13 with SERVE's traffic, as text
# through the engine (plain RoPE, as the reference's engine serves it),
# phase 11 at 6000 tokens; (b) 4 vision streams of 2048 tokens (a 22 x 22
# patch grid, then text) through greedy_generate with their M-RoPE
# positions, 16 new tokens, phase 11 on that prefill
QWEN_VL = dict(arch="qwen2-vl-2b", plain_n=6000, streams=4, stream_len=2048,
               new=16)
# phase 14: the dry-run tooling held against the card. (a) the sharding
# plan's one-card bytes of qwen1.5-0.5b's parameters and AdamW state
# against what building them asks of the allocator; (b) the costing's meta count of one
# microbatch of 7d(c)'s step and of gemma2-2b's 6000-token prefill against
# FlopCounterMode on the card; (c) the roofline beside 7d(c)'s step and
# phase 12's prefills; (d) deepseek-v2-236b's serving plan at its 60 layers
# (4 slots of 4096 tokens) on meshes of 1, 4 and 8 cards. The meta counts
# take ~40 s of host time, so a process of their own computes them while
# the card runs phases 5-13 (``dryrun_counts``)
DRYRUN = dict(arch="qwen1.5-0.5b", microbatch=2, prefill_arch="gemma2-2b",
              prefill=6000, plan_arch="deepseek-v2-236b", serve_batch=4,
              serve_seq=4096,
              meshes=((1, 1), (1, 4), (4, 1), (1, 8), (8, 1)))
# phase 14(a)'s tolerance a tensor: the caching allocator's size unit
ALLOC_ROUND = 512
# phase 8 at the shapes the encoder-decoder and qwen2-vl give the kernel (the
# encoder at B 1 and at WHISPER's 4 rows, the decoder's prompt, its cross
# attention and its decode step's; qwen2-vl's longest prompts and its M-RoPE
# streams), at olmoe-1b-7b's at its served prompts' length and at gemma2-9b's
# phase-11 prompt (16 heads over 8 of 256, softcap 50; local window 4096):
# (label, B, Sq, Sk, H, K, D, causal, window, softcap, dtypes): the shapes
# served only in bf16 and timed to price their launches run in bf16 alone
BOTH, BF16 = ("bfloat16", "float32"), ("bfloat16",)
FLASH_NEW_SHAPES = [
    ("whisper-large-v3 encoder S=1500", 1, 1500, 1500, 20, 20, 64, False, 0,
     0.0, BOTH),
    ("whisper-large-v3 encoder B=4 S=1500", 4, 1500, 1500, 20, 20, 64,
     False, 0, 0.0, BF16),
    ("whisper-large-v3 decoder S=224", 4, 224, 224, 20, 20, 64, True, 0,
     0.0, BF16),
    ("whisper-large-v3 cross Sq=224 Sk=1500", 4, 224, 1500, 20, 20, 64,
     False, 0, 0.0, BOTH),
    ("whisper-large-v3 decode cross Sq=1 Sk=1500", 4, 1, 1500, 20, 20, 64,
     False, 0, 0.0, BOTH),
    ("qwen2-vl-2b S=6000", 1, 6000, 6000, 12, 2, 128, True, 0, 0.0, BOTH),
    ("qwen2-vl-2b M-RoPE B=4 S=2048", 4, 2048, 2048, 12, 2, 128, True, 0,
     0.0, BF16),
    ("olmoe-1b-7b S=2048", 1, 2048, 2048, 16, 16, 128, True, 0, 0.0, BOTH),
    ("gemma2-9b global S=5000", 1, 5000, 5000, 16, 8, 256, True, 0, 50.0,
     BOTH),
    ("gemma2-9b local S=5000", 1, 5000, 5000, 16, 8, 256, True, 4096, 50.0,
     BOTH),
]
# phase 8 at the head dims of the reduced configs (16; every arch's
# ``reduced()``) and of the Pallas kernel's tests (32), bf16 and f32, in
# FLASH_NEW_SHAPES' form: the reduced gemma2 prompt served by serve_lm (B 1,
# S 9, H = K = 4, window 16, softcap 50), a ragged S 300 with a window, the
# softcap and GQA 2:1 (B 2), a ragged causal S 1000 with GQA 2:1, and the
# timed shape B 4, S 2048, H 8 over K 2 (causal, SDPA beside it)
FLASH_SMALL_D_SHAPES = [
    shape for d in (16, 32) for shape in (
        (f"D {d} reduced serve S=9", 1, 9, 9, 4, 4, d, True, 16, 50.0, BOTH),
        (f"D {d} window softcap GQA 2:1 S=300", 2, 300, 300, 8, 4, d, True,
         96, 50.0, BOTH),
        (f"D {d} causal GQA 2:1 S=1000", 1, 1000, 1000, 8, 4, d, True, 0,
         0.0, BOTH),
        (f"D {d} B=4 S=2048", 4, 2048, 2048, 8, 2, d, True, 0, 0.0, BOTH))
]
# phase 15: the serve launcher on its defaults (reduced qwen1.5-0.5b, head
# dim 16: refused by the kernel before it took D 16)
SERVE_DEFAULTS = dict(requests=8, max_new=16)
# phase 16: every examples_torch example on the card, at its own widths.
# The cuts (steps only: a module constant's value, or flags) keep the phase
# near 100 s: a small sweep's step is host-bound, 25-70 ms on an H100's
# host (scenario_zoo took 89.5 s at 300 steps and 55.7 s at 100 on two
# hosts, merge_study 24.0 s at 900; PERF.md). merge_study runs its
# run_points at MERGE_STEPS in place of main's 900 steps. Each example's
# output goes to build/chip_smoke_run/examples/<name>.log
EXAMPLES = ("serve_lm", "quickstart", "scenario_zoo", "merge_study",
            "phase3_dataset", "train_lm")
EXAMPLE_CUTS = {"scenario_zoo": dict(STEPS=50),
                "phase3_dataset": ["--quick"],
                "train_lm": ["--steps", "40"]}
MERGE_STEPS = 400
# the kernel each layer kind's prefill launches
KERNEL_OF_KIND = {"global": "flash_attention", "local": "flash_attention",
                  "recurrent": "rglru_linear_scan", "rwkv": "wkv6"}
# device-kernel names of the hand-written serving kernels in a profile
PROFILE_NAMES = {"flash_attention": "flash_fwd",
                 "rglru_linear_scan": "rglru_chunk", "wkv6": "wkv6_fwd"}
RGLRU_TOL = {"bfloat16": dict(rtol=2e-2, atol=2e-3),
             "float32": dict(rtol=1e-5, atol=1e-5)}
WKV6_TOL = {"bfloat16": dict(rtol=5e-2, atol=5e-2),
            "float32": dict(rtol=1e-4, atol=1e-4)}
# (S, decays) of phase 9's wkv6 draws: mild decays U(0.8, 0.999) as the
# reference's tests draw them, and at the main length strong ones,
# exp(-exp(U(-8, 5))) with one entry in 16 exactly 0 and one in 16 exactly 1
WKV6_DRAWS = ((37, "mild"), (512, "mild"), (4096, "mild"), (6000, "mild"),
              (6000, "strong"))
# trials of the plain recurrences (Python loops over S, 10^3-10^4 times the
# kernels' time) at S > 1024: each trial waits out a sleep as long as the
# loop's enqueue, so one trial there, on the main shape's line only (the
# others at S > 1024 are not timed), keeps phase 9 inside the time limit
PLAIN_LOOP_TRIALS = 1
# the main shape's f32 time that the chunked kernel must and should reach
WKV6_BAR_MS, WKV6_TARGET_MS = 1.0, 0.30
# the same for the neighbor kernel's table build at the sweep's shape (B 256,
# N 128, Q 4 rows) and for RG-LRU at B 1, S 6000, W 2560, f32
NEIGHBOR_BAR_MS, NEIGHBOR_TARGET_MS = 0.008, 0.004
# the most slots idm_accel_kernel sorts; past it the all-pairs form answers
IDM_SORT_SLOTS = 8192
RGLRU_BAR_MS, RGLRU_TARGET_MS = 0.20, 0.110


T_START = time.perf_counter()


def log(msg: str) -> None:
    """Print one line, stamped with the seconds since the script started."""
    print(f"[chip_smoke +{time.perf_counter() - T_START:.1f}s] {msg}",
          flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, reps: int = 10, trials: int = 21,
              warmup: int = 3) -> float:
    """Device time of one ``fn()`` call in ms: the median over ``trials``
    CUDA-event timings, each over ``reps`` back-to-back calls, after
    ``warmup`` calls (one is enough for a plain Python loop over S, whose
    first steps warm every kernel it runs).

    The stream is first held busy with ``torch.cuda._sleep`` for longer
    than the host takes to enqueue the timed launches, so the events
    bracket launches that run back to back on the device and the host's
    launch overhead stays out of the reading.
    """
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(max(host_s, 1e-3) * 3 * 2.0e9)
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def rand_world(gen, b: int, n: int, p_act: float = 0.8):
    """Random worlds with forced exact position ties and inactive slots
    (the tie-break edge cases of the neighbor contract)."""
    import torch

    dev = gen.device
    pos = torch.rand((b, n), generator=gen, device=dev) * 900.0
    lane = torch.randint(0, N_LANES, (b, n), generator=gen, device=dev,
                         dtype=torch.int32)
    if n > 4:
        pos[:, 1] = pos[:, 0]
        pos[:, 4] = pos[:, 0]
        lane[:, 1] = lane[:, 0]
        lane[:, 4] = lane[:, 0]
    active = torch.rand((b, n), generator=gen, device=dev) < p_act
    return pos, lane, active


def query_rows(gen, mode: str, b: int, q: int, n: int, lane):
    """The query rows of one ``neighbor_kernel`` call: ``rows`` (a table
    build, row q asking for lane q: no query-lane tensor, as the sweep
    calls it), ``own`` (the vehicles' own lanes, Q 1, the sweep's single
    query) or ``lanes`` (random lanes per vehicle). Returns the
    ``query_lanes`` argument (None for rows)."""
    import torch

    if mode == "rows":
        return None
    if mode == "own":
        return lane[:, None, :].contiguous()
    return torch.randint(0, N_LANES, (b, q, n), generator=gen,
                         device=lane.device, dtype=torch.int32)


def kernel_phase(torch, idm, ref):
    from repro_torch.launch.costing import bound, idm_accel_cost, neighbor_cost

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    b_main = SWEEP["instances"] // 4
    n_main = SWEEP["slots"]
    # the launch floor: one one-element in-place add, timed as the kernels
    # are (no kernel can take less; the neighbor bound lies below it)
    one = torch.zeros(1, device="cuda")
    floor_ms = device_ms(lambda: one.add_(1.0))
    log(f"launch floor: a one-element in-place add takes {floor_ms:.5f} ms")
    shapes = [
        (b_main, n_main, 4, "rows"), (b_main, n_main, 3, "rows"),
        (b_main, n_main, 1, "own"), (b_main, n_main, 4, "lanes"),
        (1024, 128, 4, "rows"), (1024, 128, 1, "own"), (48, 512, 4, "rows"),
        (65536, 16, 4, "rows"), (65536, 16, 1, "own"), (2, 8193, 4, "rows"),
        (2, 8193, 2, "lanes"),
    ]
    results = []
    for b, n, q, mode in shapes:
        pos, lane, active = rand_world(gen, b, n)
        ql = query_rows(gen, mode, b, q, n, lane)
        n_rows = q if ql is None else None
        got = idm.neighbor_kernel(pos, lane, active, ql, n_rows=n_rows,
                                  veh_len=4.5)
        want = ref.ref_neighbor_mq(pos, lane, active, ql, 4.5, n_rows=n_rows)
        torch.cuda.synchronize()
        for name, g, w in zip(("lead_idx", "lead_gap", "has_lead", "foll_idx",
                               "foll_gap", "has_foll"), got, want):
            if not torch.equal(g, w):
                bad = int((g != w).sum())
                raise AssertionError(
                    f"neighbor_kernel != ref_neighbor_mq on {name} at "
                    f"B={b} N={n} Q={q} {mode} ({bad} elements differ)")
        err = max(float((g.float() - w.float()).abs().max()) for g, w in
                  zip(got, want))
        ms = device_ms(lambda: idm.neighbor_kernel(pos, lane, active, ql,
                                                   n_rows=n_rows, veh_len=4.5))
        plain_ms = device_ms(lambda: ref.ref_neighbor_mq(
            pos, lane, active, ql, 4.5, n_rows=n_rows), reps=2)
        ops, bytes_moved = neighbor_cost(b, n, q, ql is not None)
        bound_ms, bound_by = bound(bytes_moved, ops)
        results.append(dict(B=b, N=n, Q=q, rows=mode, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, floor_ms=floor_ms))
        bar = (f"; the bar {NEIGHBOR_BAR_MS} ms, the target "
               f"{NEIGHBOR_TARGET_MS} ms" if (b, n, q, mode) ==
               (b_main, n_main, 4, "rows") else "")
        log(f"neighbor_kernel B={b} N={n} Q={q} {mode}: bit-exact; kernel "
            f"{ms:.5f} ms, plain {plain_ms:.5f} ms, bound {bound_ms:.5f} ms "
            f"({bound_by}), launch floor {floor_ms:.5f} ms{bar}")

    idm_results = []
    for b, n in ((b_main, n_main), (1024, 128), (48, 512), (65536, 16),
                 (2, 8192), (2, 8193)):
        pos, lane, active = rand_world(gen, b, n)

        def rnd(lo, hi):
            return torch.rand((b, n), generator=gen, device="cuda") * (hi - lo) + lo

        vel, v0, T = rnd(0.0, 35.0), rnd(20.0, 35.0), rnd(0.8, 1.8)
        a_max, b_comf, s0 = rnd(1.0, 2.5), rnd(1.5, 3.0), rnd(1.0, 2.5)
        args = (pos, vel, lane, active, v0, T, a_max, b_comf, s0)
        got = idm.idm_accel_kernel(*args, veh_len=4.5)
        wide = idm._idm_accel_wide(*args, veh_len=4.5)
        want = ref.ref_idm_accel(*args, 4.5)
        torch.cuda.synchronize()
        if not torch.equal(got, wide):
            raise AssertionError(
                f"idm_accel_kernel != its all-pairs form at B={b} N={n} "
                f"({int((got != wide).sum())} elements differ)")
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        err = float((got - want).abs().max())
        ms = device_ms(lambda: idm.idm_accel_kernel(*args, veh_len=4.5))
        form = "sort" if n <= IDM_SORT_SLOTS else "all-pairs"
        # past the sort's slots the kernel is the all-pairs form: one timing
        wide_ms = (device_ms(lambda: idm._idm_accel_wide(*args, veh_len=4.5))
                   if form == "sort" else ms)
        plain_ms = device_ms(lambda: ref.ref_idm_accel(*args, 4.5), reps=2)
        ops, bytes_moved = idm_accel_cost(b, n)
        bound_ms, bound_by = bound(bytes_moved, ops)
        idm_results.append(dict(B=b, N=n, form=form, max_abs_err=err, ms=ms,
                                all_pairs_ms=wide_ms, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by,
                                floor_ms=floor_ms))
        log(f"idm_accel_kernel B={b} N={n} ({form}): bit-equal to the "
            f"all-pairs form, max |err| {err:.3g} (tol 1e-6); kernel "
            f"{ms:.5f} ms, all-pairs {wide_ms:.5f} ms, plain {plain_ms:.5f} "
            f"ms, bound {bound_ms:.5f} ms ({bound_by}), launch floor "
            f"{floor_ms:.5f} ms")
    return results, idm_results


def device_events(prof) -> list[tuple[str, float, int]]:
    """(name, device µs, count) of a profile's device events (kernels,
    copies, memsets), heaviest first, summed by name straight from the
    profiler's raw events: ``key_averages`` first builds a Python event
    tree of every host and device event, which for a train step's ~67,000
    kernels takes longer than the step."""
    from torch.autograd import DeviceType

    totals: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.duration_ns() <= 0:
            continue
        acc = totals.setdefault(e.name(), [0.0, 0])
        acc[0] += e.duration_ns() / 1e3
        acc[1] += 1
    return sorted(((k, us, n) for k, (us, n) in totals.items()),
                  key=lambda e: e[1], reverse=True)


def profile_phase(torch) -> dict:
    """Where a group call's time goes: host time per step without the
    profiler, then a ``torch.profiler`` window over the same steps for the
    device's busy share and its heaviest kernels (one highway_merge group
    of the sweep: B = instances / 4, N = slots, after 100 warm-up steps).
    The profiler records device activity only: the host ops of the
    window's ~7,000 kernels would take longer to digest than to run."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.scenario import SimConfig
    from repro_torch.core.simulator import rollout_chunk
    from repro_torch.core.sweep import SweepConfig, SweepRunner

    steps = 5
    cfg = SweepConfig(n_instances=SWEEP["instances"] // 4,
                      steps_per_instance=10**6, chunk_steps=steps,
                      sim=SimConfig(n_slots=SWEEP["slots"],
                                    neighbor_impl="cuda"))
    state = SweepRunner(cfg, device="cuda").init()
    sp, h = state.params, state.horizon
    sim, m = rollout_chunk(state.sim, state.metrics, sp, h, cfg.sim, 100)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim, m = rollout_chunk(sim, m, sp, h, cfg.sim, steps)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rollout_chunk(sim, m, sp, h, cfg.sim, steps)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    events = device_events(prof)
    busy_us = sum(us for _, us, _ in events)
    launches = sum(count for _, _, count in events)
    device_ms = busy_us / steps / 1e3
    # two shares of one busy time: over the profiled window's own wall
    # time (the profiler slows the host, so this understates the share),
    # and over the unprofiled step measured just before (two windows of
    # the same 5 steps; the device's work per step is the same in both)
    out = dict(host_ms_per_step=host_ms,
               profiled_wall_ms_per_step=wall_us / steps / 1e3,
               device_ms_per_step=device_ms,
               device_busy_share=busy_us / wall_us if busy_us else None,
               device_share_of_unprofiled_step=(device_ms / host_ms
                                                if busy_us else None),
               device_kernels_per_step=launches / steps,
               top=[(key[:60], us / steps / 1e3)
                    for key, us, _ in events[:6]])
    if busy_us:
        log(f"profile: highway_merge group B={cfg.n_instances} N="
            f"{SWEEP['slots']}: {host_ms:.3f} ms/step unprofiled; under the "
            f"profiler {out['profiled_wall_ms_per_step']:.3f} ms/step wall, "
            f"device busy {device_ms:.4f} ms/step = "
            f"{100 * out['device_busy_share']:.2f}% of the profiled wall, "
            f"{100 * out['device_share_of_unprofiled_step']:.2f}% of the "
            f"unprofiled step (idle {100 - 100 * out['device_share_of_unprofiled_step']:.2f}%), "
            f"{out['device_kernels_per_step']:.0f} device kernels/step")
        for name, ms in out["top"]:
            log(f"profile:   {ms:.5f} ms/step  {name}")
    else:
        log(f"profile: {host_ms:.3f} ms/step unprofiled; the profiler "
            "recorded no device time: device busy share not measured")
    return out


def rows_equal(torch, a, b, keep, what: str) -> list[str]:
    """Hold every ``[N]`` leaf of two states (or shard row dicts) equal on
    the rows ``keep``: bit for bit, or, where the card gives other bits,
    within the CPU sweep tests' tolerance (rtol 1e-5; atol 1e-3 for
    positions, 1e-4 otherwise) for floats, and exactly for everything
    else. Returns the leaves that were not bit-equal."""
    from repro_torch.ckpt.io import flatten_with_paths

    la, lb = flatten_with_paths(a), flatten_with_paths(b)
    pa, pb = [p for p, _ in la], [p for p, _ in lb]
    if pa != pb:
        raise AssertionError(f"{what}: leaves differ: {sorted(set(pa) ^ set(pb))}"
                             f" ({len(pa)} against {len(pb)})")
    loose = []
    for (path, x), (_, y) in zip(la, lb):
        if x.dim() == 0:
            continue
        x, y = x[keep], y[keep]
        if torch.equal(x, y):
            continue
        loose.append(path)
        if not x.is_floating_point():
            raise AssertionError(f"{what}: {path} differs")
        torch.testing.assert_close(
            x, y, rtol=1e-5, atol=1e-3 if path.endswith("pos") else 1e-4,
            msg=lambda m: f"{what}: {path}: {m}")
    if loose:
        log(f"{what}: not bit-equal, held within the CPU tolerance: {loose}")
    return loose


def shard_rows(torch, root) -> dict:
    """Every instance's row of every array of a dataset, by instance id."""
    from repro_torch.data.shards import ShardedDataset

    rows = {}
    for z in ShardedDataset.load(str(root)).iter_shards():
        for j, i in enumerate(z["instance"]):
            rows[int(i)] = {k: torch.from_numpy(v[j:j + 1])
                            for k, v in z.items()}
    return rows


def record_phase(torch, idm, plain) -> dict:
    """Phase 7a: the recording, checkpointed, supervised sweep in-process.

    A fault-free ``run_supervised`` with a ``DatasetWriter`` and
    checkpoints, and the same sweep under ``FaultModel.random_model``
    (crashes, hangs, stragglers, one poison instance) killed after chunk
    2, before its last (asserted), and resumed from its checkpoint and
    journal, which must hold every fault kind: their final states and
    every array of every shard must agree on every instance that the
    faulted run did not quarantine, and the poison instance must be
    reported quarantined. Recording on and off must give the same final
    simulator state, bit for bit: ``plain`` is phase 6's ``cuda`` run of
    the same sweep without recording (in one chunk of all its steps; the
    chunk size changes no bit). Both runs go once more pipelined (the fault-free
    one through 2 blocks on one card, 2 x 4 workers): their final states,
    every shard array and the faulted run's journal must equal the
    synchronous runs' bit for bit."""
    import shutil

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.core.fault import FaultModel
    from repro_torch.core.fleet import RetryPolicy, RunJournal, run_supervised
    from repro_torch.core.record import RecordConfig
    from repro_torch.core.scenario import SimConfig
    from repro_torch.core.scenarios import list_scenarios
    from repro_torch.core.sweep import SweepConfig, SweepRunner
    from repro_torch.data.shards import DatasetWriter

    r = RECORD
    work = WORK / "record"
    shutil.rmtree(work, ignore_errors=True)
    cfg = SweepConfig(
        n_instances=r["instances"], steps_per_instance=r["steps"],
        chunk_steps=r["chunk_steps"], seed=0,
        sim=SimConfig(n_slots=r["slots"], neighbor_impl="cuda"),
        scenario_mix=tuple(list_scenarios()), dispatch="grouped",
        record=RecordConfig(record_every=r["record_every"],
                            k_slots=r["k_slots"]))
    n_chunks = r["steps"] // r["chunk_steps"] * 3
    one = [torch.device("cuda", 0)]

    def runner(devices=one):
        return SweepRunner(cfg, devices=devices,
                           workers_per_device=r["workers"] // len(devices))

    def writer(name):
        return DatasetWriter(str(work / name), cfg,
                             shard_size=r["shard_size"])

    # the first seed whose schedule crashes, hangs and straggles a worker
    # in chunk 0, where every instance runs (a fault on a worker whose
    # instances are all held or done leaves no event)
    for seed in range(1000):
        fm = FaultModel.random_model(
            r["workers"], n_chunks, 0.1, hang_prob=0.05, straggler_prob=0.05,
            poison_instances=(r["poison"],), seed=seed)
        if fm.plan.get(0) and fm.hangs.get(0) and fm.stragglers.get(0):
            break
    policy = RetryPolicy(max_retries=2)

    def clean_run(name, pipeline, devices=one):
        idm.reset_launches()
        t0 = time.perf_counter()
        run = runner(devices)
        w = writer(name + "_ds")
        state, info = run_supervised(
            run, ckpt=CheckpointManager(str(work / (name + "_ck"))),
            writer=w, pipeline=pipeline)
        w.finalize(fault_info=info)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = idm.launches["neighbor_kernel"]
        want = 2 * r["chunk_steps"] * run.group_calls
        if launches != want or info["completion_rate"] != 1.0:
            raise AssertionError(f"{name} recording run: completion "
                                 f"{info['completion_rate']}, neighbor_kernel "
                                 f"launched {launches} times, expected {want}")
        return state, info, wall, launches, run.group_calls

    def faulted_run(name, pipeline):
        t0 = time.perf_counter()
        ck = CheckpointManager(str(work / (name + "_ck")))
        jr = RunJournal(str(work / (name + "_ck") / "journal.jsonl"))
        w = writer(name + "_ds")
        _, first = run_supervised(runner(), fm, policy, ckpt=ck, writer=w,
                                  journal=jr, max_chunks=3, pipeline=pipeline)
        del w  # the kill: buffered instances are lost with the process
        w = writer(name + "_ds")
        state, info = run_supervised(runner(), fm, policy, ckpt=ck, writer=w,
                                     journal=jr, pipeline=pipeline)
        w.finalize(fault_info=info)
        torch.cuda.synchronize()
        events = [{k: v for k, v in e.items() if k != "time"}
                  for e in RunJournal.read(jr.path)]
        return state, info, first, time.perf_counter() - t0, events

    clean, info, clean_s, launches, calls = clean_run("clean", False)
    faulted, info_f, first, fault_s, events = faulted_run("fault", False)
    if first["completion_rate"] >= 1.0:
        raise AssertionError("faulted recording run: the kill after "
                             f"{first['chunks_run']} chunks came after its "
                             "last chunk")
    kinds = [e.get("fault", e["kind"]) for e in events]
    for kind in ("crash", "hang", "straggler", "poison", "quarantine",
                 "resume"):
        if kind not in kinds:
            raise AssertionError(f"faulted recording run: no {kind} event")
    if (info_f["quarantined"] != [r["poison"]]
            or info_f["eligible_completion_rate"] != 1.0):
        raise AssertionError(f"faulted run: quarantined "
                             f"{info_f['quarantined']}, eligible completion "
                             f"{info_f['eligible_completion_rate']}")
    keep = torch.ones(r["instances"], dtype=torch.bool, device="cuda")
    keep[r["poison"]] = False
    loose = rows_equal(torch, clean, faulted, keep, "record: final state")

    a, b = shard_rows(torch, work / "clean_ds"), shard_rows(torch, work / "fault_ds")
    ids = sorted(set(range(r["instances"])) - {r["poison"]})
    if sorted(a) != list(range(r["instances"])) or sorted(b) != ids:
        raise AssertionError(f"datasets hold {len(a)} and {len(b)} instances")
    for i in ids:
        loose += rows_equal(torch, a[i], b[i], slice(None), f"record: shard row {i}")

    if (plain.horizon.shape != clean.horizon.shape
            or not torch.equal(plain.horizon, clean.horizon)):
        raise AssertionError("phase 6's sweep is not this phase's sweep")
    states_equal(torch, plain.sim, clean.sim)
    states_equal(torch, plain.metrics, clean.metrics)

    # the same two runs pipelined: bit-equal to the synchronous ones
    two = [torch.device("cuda", 0)] * 2
    clean_p, _, clean_ps, launches_p, calls_p = clean_run("clean_pipe", True,
                                                          two)
    faulted_p, info_fp, _, fault_ps, events_p = faulted_run("fault_pipe", True)
    states_equal(torch, clean, clean_p, "record: pipelined 2-block state")
    states_equal(torch, faulted, faulted_p, "record: pipelined faulted state")
    if events_p != events or info_fp["quarantined"] != info_f["quarantined"]:
        raise AssertionError("record: the pipelined faulted run's journal "
                             "differs from the synchronous run's")
    for sync_name, pipe_name in (("clean", "clean_pipe"),
                                 ("fault", "fault_pipe")):
        x = shard_rows(torch, work / f"{sync_name}_ds")
        y = shard_rows(torch, work / f"{pipe_name}_ds")
        if sorted(x) != sorted(y):
            raise AssertionError(f"record: {pipe_name} holds other instances")
        for i in x:
            if list(x[i]) != list(y[i]) or not all(
                    torch.equal(x[i][k], y[i][k]) for k in x[i]):
                raise AssertionError(f"record: {pipe_name} shard row {i} "
                                     "differs from the synchronous run's")
    log(f"record: {r['instances']} instances x {r['steps']} steps, "
        f"{r['slots']} slots, chunks of {r['chunk_steps']}, 4-scenario mix, "
        f"grouped, cuda impl, every {r['record_every']} steps, "
        f"{r['k_slots']} slots: fault-free run {clean_s:.3f} s "
        f"({info['chunks_run']} chunks, neighbor_kernel launches {launches} "
        f"= 2 x {r['chunk_steps']} x {calls}); faulted run (fault "
        f"seed {seed}: {kinds.count('crash')} crash, {kinds.count('hang')} "
        f"hang, {kinds.count('straggler')} straggler, {kinds.count('poison')}"
        f" poison events; killed after {first['chunks_run']} chunks, "
        f"resumed for {info_f['chunks_run']}) {fault_s:.3f} s; final state "
        f"and every shard array of the {len(ids)} non-quarantined instances "
        f"{'bit-equal' if not loose else 'within tolerance'}, instance "
        f"{r['poison']} quarantined; recording off (phase 6) = on bit for "
        f"bit")
    log(f"record: pipelined: fault-free through 2 blocks on one card "
        f"{clean_ps:.3f} s (neighbor_kernel launches {launches_p} = 2 x "
        f"{r['chunk_steps']} x {calls_p}), faulted, killed and resumed "
        f"{fault_ps:.3f} s: states, every shard array and the journal "
        f"({len(events)} events) equal the synchronous runs' bit for bit")
    return dict(clean_s=clean_s, fault_s=fault_s, clean_pipe_s=clean_ps,
                fault_pipe_s=fault_ps, launches=launches, group_calls=calls,
                launches_pipe=launches_p, group_calls_pipe=calls_p,
                fault_seed=seed, loose=sorted(set(loose)),
                quarantined=info_f["quarantined"])


def blocks_phase(torch, idm, plain, sweep: dict) -> dict:
    """Phase 6a: the block executor. Phase 6's sweep (``PARITY``, one
    chunk, ``cuda`` neighbors) through 2 and 4 blocks on one
    card (``devices=[cuda:0] * k``: k streams, enqueued in turn) and,
    where there are as many cards, on distinct cards: each final
    ``SweepState`` must equal phase 6's bit for bit, and the neighbor
    launches must equal 2 x chunk_steps x the batched calls made (the
    counts set to 0 just before each run). Then phase 4's sweep at full
    width through 2 blocks on one card for one chunk (``BLOCKS_FULL``), its
    rates beside phase 4's."""
    from repro_torch.core.fleet import run_supervised
    from repro_torch.core.scenario import SimConfig
    from repro_torch.core.scenarios import list_scenarios
    from repro_torch.core.sweep import SweepConfig, SweepRunner
    from repro_torch.launch.mesh import sweep_devices

    def cfg(n, steps, chunk):
        return SweepConfig(n_instances=n, steps_per_instance=steps,
                           chunk_steps=chunk, seed=0,
                           sim=SimConfig(n_slots=SWEEP["slots"],
                                         neighbor_impl="cuda"),
                           scenario_mix=tuple(list_scenarios()),
                           dispatch="grouped")

    def run(c, devices):
        runner = SweepRunner(c, devices=devices)
        state = runner.init()
        torch.cuda.synchronize()
        idm.reset_launches()
        t0 = time.perf_counter()
        state, info = run_supervised(runner, state=state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = idm.launches["neighbor_kernel"]
        want = 2 * c.chunk_steps * runner.group_calls
        if launches != want or info["completion_rate"] != 1.0:
            raise AssertionError(
                f"{len(devices)} blocks on {sorted(set(map(str, devices)))}: "
                f"completion {info['completion_rate']}, neighbor_kernel "
                f"launched {launches} times, expected 2 x {c.chunk_steps} x "
                f"{runner.group_calls} = {want}")
        return state, wall, launches, runner.group_calls

    n_par, steps_par = PARITY["instances"], PARITY["steps"]
    small = cfg(n_par, steps_par, steps_par)
    layouts = [("one card", k, [torch.device("cuda", 0)] * k) for k in (2, 4)]
    for k in (2, 4):
        if torch.cuda.device_count() >= k:
            layouts.append(("distinct cards", k, sweep_devices(k, "cuda:0")))
    out = dict(parity=[], launches=0)
    for where, k, devices in layouts:
        state, wall, launches, calls = run(small, devices)
        states_equal(torch, plain, state)
        out["parity"].append(dict(where=where, blocks=k, wall_s=wall,
                                  group_calls=calls, launches=launches))
        out["launches"] += launches
        log(f"blocks: phase 6's sweep through {k} blocks on {where}: "
            f"final SweepState = phase 6's bit for bit; wall {wall:.3f} s, "
            f"{n_par * steps_par / wall:.1f} instance-steps/s, "
            f"neighbor_kernel launches {launches} = 2 x {steps_par} x {calls}")
    if torch.cuda.device_count() < 2:
        log("blocks: one card visible: the distinct-card layouts not run")

    n, steps = BLOCKS_FULL["instances"], BLOCKS_FULL["steps"]
    full = cfg(n, steps, steps)
    state, wall, launches, calls = run(full, [torch.device("cuda", 0)] * 2)
    out["launches"] += launches
    m = state.metrics
    veh_steps = float(m.speed_count.sum())
    if not bool((m.steps == steps).all()):
        raise AssertionError("blocks: some instance did not run every step")
    out["full"] = dict(instances=n, steps=steps, wall_s=wall,
                       instance_steps_per_s=n * steps / wall,
                       vehicle_steps_per_s=veh_steps / wall,
                       group_calls=calls, launches=launches)
    log(f"blocks: phase 4's sweep at full width ({n} instances, "
        f"{SWEEP['slots']} slots), one chunk of {steps} steps, through 2 "
        f"blocks on one card: wall {wall:.3f} s, "
        f"{n * steps / wall:.1f} instance-steps/s, "
        f"{veh_steps / wall:.1f} vehicle-steps/s; phase 4 through one "
        f"device: {sweep['wall_s']:.3f} s, "
        f"{sweep['instance_steps_per_s']:.1f} instance-steps/s, "
        f"{sweep['vehicle_steps_per_s']:.1f} vehicle-steps/s")
    return out


def pipeline_phase(torch, sweep: dict) -> dict:
    """Phase 7b, the gate: the port's controller over the full-size
    recording sweep with injected crashes, hangs, stragglers, one poison
    instance and two SIGKILLs. The controller must exit 0 with eligible
    completion 1.0, the port's ``verify_shards`` must find nothing to
    repair, the dataset must hold every non-quarantined instance once, and
    the final worker's neighbor launches must equal 2 x chunk_steps x its
    batched chunk calls."""
    import os
    import re
    import shutil
    import signal

    from repro_torch.core.fleet import RunJournal
    from repro_torch.core.record import RecordConfig
    from repro_torch.core.scenario import SimConfig
    from repro_torch.core.scenarios import list_scenarios
    from repro_torch.core.sweep import SweepConfig
    from repro_torch.data.shards import DatasetWriter, ShardedDataset

    p = PIPELINE
    work = WORK / "pipeline"
    shutil.rmtree(work, ignore_errors=True)
    run_dir, ds = work / "run", work / "ds"
    worker = [
        "--instances", str(p["instances"]), "--slots", str(p["slots"]),
        "--steps", str(p["steps"]), "--chunk-steps", str(p["chunk_steps"]),
        "--scenario-mix", "all", "--dispatch", "grouped",
        "--neighbor-impl", "cuda", "--workers", str(p["workers"]),
        "--fail-prob", str(p["fail_prob"]), "--hang-prob", str(p["hang_prob"]),
        "--straggler-prob", str(p["straggler_prob"]),
        "--poison", str(p["poison"]), "--record-every", str(p["record_every"]),
        "--record-slots", str(p["record_slots"]),
        "--shard-size", str(p["shard_size"]), "--dataset-dir", str(ds),
        "--device", "cuda", "--devices", "1",
    ]
    cmd = [sys.executable, "-m", "repro_torch.launch.controller",
           "--ckpt-dir", str(run_dir), "--chaos-kills", str(p["chaos_kills"]),
           "--heartbeat-timeout", "600", "--poll", "0.5", "--", *worker]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, cwd=str(ROOT), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=p["timeout_s"])
    finally:
        if proc.poll() is None:  # the controller and its worker, on timeout
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    wall = time.perf_counter() - t0
    (work / "controller.log").write_text(out)
    if proc.returncode != 0:
        raise AssertionError(f"controller exited {proc.returncode}:\n"
                             f"{out[-4000:]}")
    result = json.loads((run_dir / "result.json").read_text())
    info = result["fault_info"]
    if info["eligible_completion_rate"] != 1.0:
        raise AssertionError(f"eligible completion "
                             f"{info['eligible_completion_rate']}")
    cfg = SweepConfig(
        n_instances=p["instances"], steps_per_instance=p["steps"],
        chunk_steps=p["chunk_steps"],
        sim=SimConfig(n_slots=p["slots"], neighbor_impl="cuda"),
        scenario_mix=tuple(list_scenarios()), dispatch="grouped",
        record=RecordConfig(record_every=p["record_every"],
                            k_slots=p["record_slots"]))
    audit = DatasetWriter(str(ds), cfg, shard_size=p["shard_size"])
    if audit.repaired or audit.verify_shards():
        raise AssertionError(f"verify_shards repaired {audit.repaired}")
    data = ShardedDataset.load(str(ds))
    ids = [i for s in data.manifest["shards"] for i in s["instances"]]
    want_ids = sorted(set(range(p["instances"])) - {p["poison"]})
    if sorted(ids) != want_ids or data.n_instances != len(want_ids):
        raise AssertionError(f"dataset holds {len(ids)} instance rows "
                             f"({len(set(ids))} distinct), expected "
                             f"{len(want_ids)}")
    if info["quarantined"] != [p["poison"]]:
        raise AssertionError(f"quarantined {info['quarantined']}")
    runs = [json.loads(line[len("[sweep] run: "):])
            for line in out.splitlines() if line.startswith("[sweep] run: ")]
    if not runs or not runs[-1]["pipeline"]:
        raise AssertionError("the final worker printed no pipelined run line")
    stats = runs[-1]
    launches = stats["launches"]["neighbor_kernel"]
    want = 2 * p["chunk_steps"] * stats["group_calls"]
    if launches != want:
        raise AssertionError(f"final worker: neighbor_kernel launched "
                             f"{launches} times, expected 2 x "
                             f"{p['chunk_steps']} x {stats['group_calls']}")

    ctl = RunJournal.read(str(run_dir / "controller.jsonl"))
    jr = RunJournal.read(str(run_dir / "journal.jsonl"))
    kills = sum(e["kind"] == "worker_kill" for e in ctl)
    spawns = sum(e["kind"] == "spawn" for e in ctl)
    faults: dict[str, int] = {}
    for e in jr:
        kind = e.get("fault") or e["kind"]
        if e["kind"] in ("failure", "straggler", "quarantine",
                         "corrupt_ckpt", "corrupt_shard", "shard_repair"):
            faults[kind] = faults.get(kind, 0) + 1
    committed = sum(e["kind"] == "chunk" for e in jr)
    timing = [(int(c), *(float(x) for x in t)) for c, *t in re.findall(
        r"chunk ([0-9]+) host seconds: chunk ([0-9.]+), checkpoint save "
        r"([0-9.]+), shard drain ([0-9.]+), commit ([0-9.]+), waited "
        r"([0-9.]+)", out)]
    ds_bytes = sum(f.stat().st_size for f in ds.iterdir())
    ck_bytes = sum(f.stat().st_size for f in run_dir.rglob("arrays.npz"))
    if kills != p["chaos_kills"]:
        raise AssertionError(f"{kills} chaos kills, expected {p['chaos_kills']}")
    log(f"pipeline: controller over {p['instances']} instances x "
        f"{p['steps']} steps, {p['slots']} slots, chunks of "
        f"{p['chunk_steps']}, {p['workers']} workers, recording every "
        f"{p['record_every']} steps, pipelined I/O: wall {wall:.3f} s "
        f"(commits {sum(t[4] for t in timing):.3f} s on the I/O thread, the "
        f"loop waited {sum(t[5] for t in timing):.3f} s), "
        f"{p['instances'] * p['steps'] / wall:.1f} instance-steps/s (phase "
        f"4's sweep {sweep['instance_steps_per_s']:.1f}); {committed} chunks "
        f"committed over {spawns} "
        f"worker attempts ({kills} SIGKILLs, {spawns - 1} restarts); faults "
        f"{faults}; eligible completion 1.0, completion "
        f"{info['completion_rate']:.6f}, quarantined {info['quarantined']}; "
        f"dataset {data.n_instances} instances once each, verify_shards "
        f"repaired nothing, {ds_bytes} bytes; checkpoints {ck_bytes} bytes "
        f"on disk; final worker's neighbor_kernel launches {launches} = 2 x "
        f"{p['chunk_steps']} x {stats['group_calls']}")
    for c, chunk_s, ckpt_s, drain_s, commit_s, wait_s in timing:
        log(f"pipeline:   chunk {c}: host seconds: chunk {chunk_s:.4f}, "
            f"checkpoint save {ckpt_s:.4f}, shard drain {drain_s:.4f}, "
            f"commit {commit_s:.4f}, waited {wait_s:.4f}")
    return dict(dataset=ds, wall_s=wall,
                instance_steps_per_s=p["instances"] * p["steps"] / wall,
                chunks=committed,
                spawns=spawns, kills=kills, faults=faults,
                completion_rate=info["completion_rate"],
                dataset_bytes=ds_bytes, checkpoint_bytes=ck_bytes,
                launches_final_worker=launches, timing=timing)


def tokens_phase(torch, ds) -> dict:
    """Phase 7c: the LM inputs of phase 7b's dataset. Its token corpus
    (``shard_token_corpus``, the vocabulary from its manifest) and a few
    ``sim_token_batches`` on the card at gemma2-2b's vocabulary: i32
    ``[batch, seq]`` tensors on ``cuda``, labels the tokens shifted by
    one, every token inside the sim vocabulary, the first row the
    corpus's first window."""
    from repro_torch.config.base import get_arch
    from repro_torch.core.scenario import SimConfig
    from repro_torch.core.tokens import vocab_size
    from repro_torch.data.sim_dataset import shard_token_corpus, sim_token_batches

    t = TOKENS
    t0 = time.perf_counter()
    corpus, vocab = shard_token_corpus(str(ds))
    corpus_s = time.perf_counter() - t0
    want_vocab = vocab_size(SimConfig(n_slots=PIPELINE["slots"]))
    if vocab != want_vocab or corpus.min() < 0 or corpus.max() >= vocab:
        raise AssertionError(f"tokens: vocab {vocab} (expected {want_vocab}),"
                             f" corpus in [{corpus.min()}, {corpus.max()}]")
    cfg = get_arch("gemma2-2b")
    it = sim_token_batches(cfg, SimConfig(n_slots=PIPELINE["slots"]),
                           t["batch"], t["seq"], shard_dir=str(ds),
                           device="cuda")
    t0 = time.perf_counter()
    batches = [next(it) for _ in range(t["batches"])]
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    shape = (t["batch"], t["seq"])
    for b in batches:
        tok, lab = b["tokens"], b["labels"]
        if (tok.device.type != "cuda" or tok.dtype != torch.int32
                or tuple(tok.shape) != shape or tuple(lab.shape) != shape
                or not torch.equal(tok[:, 1:], lab[:, :-1])
                or int(tok.max()) >= vocab or int(tok.min()) < 0):
            raise AssertionError(f"tokens: a batch of {tok.dtype} "
                                 f"{tuple(tok.shape)} on {tok.device} is not "
                                 f"a shifted i32 {shape} window of the corpus")
    first = torch.from_numpy(corpus[:t["seq"]].astype("int32")).cuda()
    if not torch.equal(batches[0]["tokens"][0], first):
        raise AssertionError("tokens: the first row is not the corpus's start")
    log(f"tokens: phase 7b's dataset: corpus {corpus.size} tokens, "
        f"vocabulary {vocab} (manifest), read in {corpus_s:.3f} s; "
        f"{len(batches)} sim_token_batches on the card for gemma2-2b "
        f"(vocabulary {cfg.vocab_size}): tokens and labels i32 {shape}, "
        f"{batch_s:.4f} s")
    return dict(corpus_tokens=int(corpus.size), vocab=vocab,
                batches=len(batches), shape=list(shape), corpus_s=corpus_s,
                batch_s=batch_s)


def batch_on(batch: dict, cfg, dev) -> dict:
    """A batch moved to ``dev``, its float tensors (an encoder-decoder's
    frames) cast to the model's type."""
    from repro_torch.models.common import cdtype

    return {k: v.to(dev, cdtype(cfg) if v.is_floating_point() else v.dtype)
            for k, v in batch.items()}


def train_extras(torch, cfg, batch: int, seq: int, rng) -> dict:
    """The extras of 7d(a)'s batches: frames ``[batch, enc_ctx, d]`` (f32,
    from ``rng``) for an encoder-decoder, the vision stub's M-RoPE positions
    ``[3, batch, seq]`` for an M-RoPE config."""
    from repro_torch.core import prng
    from repro_torch.models.frontends import vision_stream_stub

    out = {}
    if cfg.is_encdec:
        out["frames"] = torch.from_numpy(rng.normal(
            size=(batch, cfg.enc_ctx, cfg.d_model)).astype("float32"))
    if cfg.mrope_sections:
        out["mrope_pos"] = vision_stream_stub(prng.key(0, "cpu"), cfg, batch,
                                              seq)[1]
    return out


def small_train_run(torch, cfg, params, batches, dev: str):
    """``TRAIN_SMALL``'s steps of ``make_train_step`` on ``dev`` from
    ``params``: (host copies of the first moments m after the first step,
    each step's metrics)."""
    from repro_torch.config.base import TrainConfig
    from repro_torch.models.registry import build_model
    from repro_torch.train import adamw_init, make_train_step

    t = TRAIN_SMALL
    tc = TrainConfig(learning_rate=t["lr"], warmup_steps=1, total_steps=10,
                     weight_decay=t["weight_decay"],
                     microbatches=t["microbatches"])
    step = make_train_step(build_model(cfg, dev), tc)
    state = adamw_init(dict(params.named_parameters()))
    metrics, m1 = [], None
    for b in batches:
        params, state, m = step(params, state, batch_on(b, cfg, dev))
        metrics.append({k: float(v) for k, v in m.items()})
        if m1 is None:
            m1 = {k: v.cpu().clone() for k, v in state.m.items()}
    return m1, metrics


def loss_grads(torch, model, params, batch: dict) -> dict:
    """Host copies of the gradient of the loss at ``batch``, by parameter
    name, through the training path's plain attention and recurrences."""
    from repro_torch.config.base import TrainConfig
    from repro_torch.models.attention import attention_impl
    from repro_torch.models.recurrent import recurrence_impl
    from repro_torch.train.step import make_loss_fn

    params.requires_grad_(True)
    names = [k for k, _ in params.named_parameters()]
    dev = batch_on(batch, model.cfg, model.device)
    with attention_impl("xla"), recurrence_impl("plain"):
        loss, _ = make_loss_fn(model, TrainConfig())(params, dev)
        grads = torch.autograd.grad(loss, list(params.parameters()))
    return {k: g.detach().float().cpu() for k, g in zip(names, grads)}


def grads_close(got: dict, want: dict, what: str, rtol: float,
                atol_frac: float, l2: float | None = None) -> float:
    """Hold two gradients (or first moments) leaf by leaf: every element
    within ``rtol`` of ``want`` plus ``atol_frac`` of the leaf's largest
    entry, and where ``l2`` is given each leaf's relative L2 error within
    it (a NaN or an infinity fails). Returns the largest difference over
    its leaf's largest entry."""
    worst = 0.0
    for k, w in want.items():
        g, scale = got[k], float(w.abs().max())
        diff = (g - w).abs()
        ok = bool((diff <= rtol * w.abs() + atol_frac * scale).all())
        if l2 is not None:
            ok = ok and float((g - w).norm()) <= l2 * float(w.norm())
        if not ok:
            raise AssertionError(
                f"train: {what}: {k}: largest difference "
                f"{float(diff.max()):.3g}, the leaf's largest entry "
                f"{scale:.3g} (rtol {rtol}, atol {atol_frac} of it"
                + (f", L2 {l2}" if l2 is not None else "") + ")")
        worst = max(worst, float(diff.max()) / scale if scale else 0.0)
    return worst


def kernel_kind(name: str) -> str:
    """A device kernel's kind, by its name: the f32 and the 16-bit GEMMs,
    element-wise kernels, reductions, the rest."""
    low = name.lower()
    if "gemm" in low or "nvjet" in low or "cutlass" in low:
        return "f32 GEMM" if "f32f32_f32f32" in low else "bf16 GEMM"
    if "elementwise" in low:
        return "element-wise"
    if "reduce" in low:
        return "reductions"
    return "other"


def train_phase(torch, ds, counters) -> dict:
    """Phase 7d: training through the plain attention and recurrence paths
    (the hand kernels have no backward; every kernel's launch count must
    stay 0, counted from just before each part to just after).

    (a) each of ``TRAIN_ARCHS`` reduced, on the card and on the CPU from
    the same seeded weights and batches: the loss's gradient in f32 and in
    bf16, held leaf by leaf as ``TRAIN_GRAD_TOL`` says, every parameter's
    gradient nonzero on the card (the logits' bf16 product has its own
    backward there); then ``TRAIN_SMALL``'s steps in f32: the loss within
    rtol 1e-5, the gradient norm within 1e-4 and the first moments after
    step 1 (0.1 of the clipped, microbatch-accumulated gradient) as the
    f32 gradient. The parameters are not compared: AdamW's first step
    moves an element by about ±lr wherever the two sides' gradients differ
    near eps, so they would hold nothing the gradients do not.
    (b) the reduced qwen (bf16) on the card for 4 steps, twice, then 2
    steps, a checkpoint, a new Trainer that restores it and 2 more: if the
    two straight runs agree bit for bit the resumed one must too; else it
    prints the leaf that differs most and holds the resumed run to that
    difference. (c) ``TRAIN_FULL`` through ``launch.train.main`` on phase
    7b's dataset: every loss finite and the last below the first; per step
    the seconds, tokens/s, loss and model FLOPs share, then the peak
    memory, the checkpoint's bytes and save seconds, and one more step
    under ``torch.profiler``."""
    import copy
    import dataclasses
    import shutil

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config.base import ShapeConfig, TrainConfig, get_arch
    from repro_torch.data.synthetic import synthetic_batches
    from repro_torch.launch import train as train_launcher
    from repro_torch.launch.roofline import PEAK_FLOPS, model_flops
    from repro_torch.models.registry import build_model
    from repro_torch.train.trainer import Trainer

    smi = nvidia_smi()
    work = WORK / "train"
    shutil.rmtree(work, ignore_errors=True)
    launches = {n: 0 for c in counters for n in c.launches}

    def counted(what: str) -> None:
        torch.cuda.synchronize()
        now = {n: v for c in counters for n, v in c.launches.items()}
        for n, v in now.items():
            launches[n] += v
        if any(now.values()):
            raise AssertionError(f"train: {what} launched hand kernels {now}")
        for c in counters:
            c.reset_launches()

    for c in counters:
        c.reset_launches()
    # (a) card against CPU: the loss's gradient in f32 and in bf16, then
    # two train steps in f32
    t = TRAIN_SMALL
    rng = np.random.default_rng(7)
    small, flipped = {}, {}
    for arch in TRAIN_ARCHS:
        t_arch = time.perf_counter()
        batches = []
        for _ in range(t["steps"]):
            reduced = get_arch(arch).reduced()
            toks = torch.from_numpy(rng.integers(
                0, reduced.vocab_size, (t["batch"], t["seq"] + 1)))
            batches.append({"tokens": toks[:, :-1], "labels": toks[:, 1:],
                            **train_extras(torch, reduced, t["batch"],
                                           t["seq"], rng)})
        worst, f32 = {}, None
        for dtype, tol in TRAIN_GRAD_TOL.items():
            cfg = dataclasses.replace(get_arch(arch).reduced(), dtype=dtype)
            gen = torch.Generator()
            gen.manual_seed(0)
            cpu_params = build_model(cfg, "cpu").init(gen)
            card_params = copy.deepcopy(cpu_params).to("cuda")
            with moe_routes(experts=True) as card_routes:
                card_g = loss_grads(torch, build_model(cfg, "cuda"),
                                    card_params, batches[0])
            counted(f"{arch} {dtype} gradient")
            with moe_routes(experts=True) as cpu_routes:
                cpu_g = loss_grads(torch, build_model(cfg, "cpu"), cpu_params,
                                   batches[0])
            if cpu_routes and dtype == "bfloat16":
                # bf16 on the card and on the CPU round apart, and an MoE
                # breaks near ties (and who is dropped after them) on that
                # rounding: hold the gradients with the CPU's routing
                flipped[arch] = sum(experts_differ(card_routes, cpu_routes))
                with moe_routes(replay=cpu_routes):
                    card_g = loss_grads(torch, build_model(cfg, "cuda"),
                                        card_params, batches[0])
                counted(f"{arch} {dtype} gradient, routed as on the CPU")
            # the card's bf16 logits product has its own backward
            # (models/common.py): every parameter must get a gradient
            dead = [k for k, g in card_g.items() if not bool(g.any())]
            if dead:
                raise AssertionError(f"train: {arch} {dtype} on the card: no "
                                     f"nonzero gradient reaches {dead}")
            worst[dtype] = grads_close(card_g, cpu_g,
                                       f"{arch} {dtype} gradient", **tol)
            if dtype == "float32":
                f32 = (cfg, cpu_params, card_params)
        cfg, cpu_params, card_params = f32
        t0 = time.perf_counter()
        card_m1, card_m = small_train_run(torch, cfg, card_params, batches,
                                          "cuda")
        counted(f"{arch} f32 steps")
        card_s = time.perf_counter() - t0
        m1, cpu_m = small_train_run(torch, cfg, cpu_params, batches, "cpu")
        for i, (x, y) in enumerate(zip(card_m, cpu_m)):
            np.testing.assert_allclose(x["loss"], y["loss"], rtol=1e-5,
                                       err_msg=f"{arch} step {i + 1} loss")
            np.testing.assert_allclose(x["grad_norm"], y["grad_norm"],
                                       rtol=1e-4,
                                       err_msg=f"{arch} step {i + 1} gnorm")
        worst["m1"] = grads_close(card_m1, m1, f"{arch} m after step 1",
                                  **TRAIN_GRAD_TOL["float32"])
        small[arch] = dict(loss=[m["loss"] for m in card_m],
                           cpu_loss=[m["loss"] for m in cpu_m],
                           grad_norm=[m["grad_norm"] for m in card_m],
                           worst_over_leaf_max=worst, params=len(card_g),
                           card_s=card_s, arch_s=time.perf_counter() - t_arch,
                           bf16_expert_sets_differ=flipped.get(arch))
        routed = ("" if arch not in flipped else
                  f" (bf16 with the CPU's MoE routing: on its own the card "
                  f"routed {flipped[arch]} token-layers to other experts)")
        log(f"train: {arch} reduced, card vs CPU: the loss's gradient, "
            f"every leaf, f32 within {worst['float32']:.3g} and bf16 within "
            f"{worst['bfloat16']:.3g} of the leaf's largest entry{routed}; "
            f"{t['steps']} f32 steps of {t['batch']} x {t['seq']} in "
            f"{t['microbatches']} microbatches: loss "
            f"{card_m[-1]['loss']:.7f} vs {cpu_m[-1]['loss']:.7f}, grad norm "
            f"{card_m[-1]['grad_norm']:.6f} vs {cpu_m[-1]['grad_norm']:.6f}, "
            f"m after step 1 within {worst['m1']:.3g}; all {len(card_g)} "
            f"parameters get a nonzero gradient in both types; hand-kernel "
            f"launches 0 (card steps {card_s:.2f} s) | {smi}")
        del f32, card_params, cpu_params, card_g, cpu_g
    # (b) resume on the card
    cfg = get_arch("qwen1.5-0.5b").reduced()
    model = build_model(cfg, "cuda")
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=4)

    def run(ckpt, start: int, steps: int):
        data = synthetic_batches(cfg, t["batch"], t["seq"], seed=1,
                                 start_step=start, device="cuda")
        tr = Trainer(model, tc, data, ckpt_dir=ckpt, log_every=1,
                     log_fn=lambda s: None)
        p, st = tr.run(steps=steps)
        leaves = {f"params.{k}": v.detach() for k, v in p.named_parameters()}
        leaves.update({f"m.{k}": v for k, v in st.m.items()})
        leaves.update({f"v.{k}": v for k, v in st.v.items()})
        return tr, leaves

    _, a = run(None, 0, 4)
    _, b = run(None, 0, 4)
    run(str(work / "resume"), 0, 2)
    tr, r = run(str(work / "resume"), 2, 4)
    counted("the resume runs")
    if [h["step"] for h in tr.history] != [3, 4]:
        raise AssertionError(f"train: resumed at {tr.history}")
    spread = {k: float((a[k].float() - b[k].float()).abs().max()) for k in a}
    worst_leaf = max(spread, key=spread.get)
    limit = spread[worst_leaf]
    off = {k: float((r[k].float() - a[k].float()).abs().max()) for k in a}
    if limit == 0.0:
        bad = [k for k in a if not torch.equal(a[k], r[k])]
        if bad:
            raise AssertionError(f"train: two straight runs agree bit for bit "
                                 f"but the resumed run differs in {bad}")
        log("train: resume: two straight 4-step runs of the reduced qwen on "
            "the card agree bit for bit, and 2 steps + checkpoint + restore "
            "+ 2 steps equals them bit for bit (parameters, m, v)")
    else:
        if max(off.values()) > limit:
            raise AssertionError(f"train: resumed run off by "
                                 f"{max(off.values())}, straight runs by "
                                 f"{limit} ({worst_leaf})")
        log(f"train: resume: two straight runs differ, most in {worst_leaf} "
            f"(largest difference {limit:.3g}); the resumed run within it "
            f"({max(off.values()):.3g})")
    resume = dict(bit_equal=limit == 0.0, straight_spread=limit,
                  spread_leaf=worst_leaf, resumed_off=max(off.values()))
    del model, a, b, r, tr

    # (c) full width on phase 7b's dataset
    f = TRAIN_FULL
    argv = ["--arch", f["arch"], "--full-size", "--steps", str(f["steps"]),
            "--batch", str(f["batch"]), "--seq", str(f["seq"]),
            "--microbatches", str(f["microbatches"]), "--remat", f["remat"],
            "--data", "sim", "--shard-dir", str(ds), "--ckpt-dir",
            str(work / "full"), "--log-every", "1", "--device", "cuda"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = train_launcher.main(argv)
    counted("the full-width run")
    peak = torch.cuda.max_memory_allocated()
    tr, params, opt = out["trainer"], out["params"], out["opt_state"]
    hist = tr.history
    losses = [h["loss"] for h in hist]
    if len(hist) != f["steps"] or not all(np.isfinite(losses)):
        raise AssertionError(f"train: full width: history {hist}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: full width: loss {losses} does not fall")
    n_params = sum(p.numel() for p in params.parameters())
    tokens = f["batch"] * f["seq"]
    elapsed = [h["step"] / h["steps_per_s"] for h in hist]
    step_s = [elapsed[0]] + [y - x for x, y in zip(elapsed, elapsed[1:])]
    # the model's FLOPs a step: 6 x the active non-embedding parameters x
    # tokens (launch/roofline.py::model_flops); the share by all parameters,
    # the tied embedding table included, is printed beside it
    step_flops = model_flops(get_arch(f["arch"]),
                             ShapeConfig("train", f["seq"], f["batch"], "train"))
    all_params_flops = 6 * n_params * tokens
    steps = []
    for h, sec in zip(hist, step_s):
        share = step_flops / sec / PEAK_FLOPS
        steps.append(dict(step=h["step"], seconds=sec, tokens_per_s=tokens / sec,
                          loss=h["loss"], grad_norm=h["grad_norm"],
                          flops_share=share))
        log(f"train: {f['arch']} full width, step {h['step']}: {sec:.3f} s, "
            f"{tokens / sec:.1f} tokens/s, loss {h['loss']:.4f}, grad norm "
            f"{h['grad_norm']:.3f}, model FLOPs share {100 * share:.3f}% | "
            f"{smi}")
    steady = step_s[1:]
    mean_s = sum(steady) / len(steady)
    ck = work / "full" / f"step_{f['steps']:09d}"
    ck_bytes = sum(p.stat().st_size for p in ck.iterdir())
    save = tr.saves[-1]
    # one more step under the profiler, device activity only (the host
    # ops of a step's ~67,000 kernels would take longer to digest than
    # the step)
    batch = next(tr.data)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        params, opt, _ = tr.step_fn(params, opt, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    events = device_events(prof)
    profile_s = time.perf_counter() - t0
    counted("the profiled step")
    busy_ms = sum(e[1] for e in events) / 1e3
    kinds = {}
    for name, us, _ in events:
        kinds[kernel_kind(name)] = kinds.get(kernel_kind(name), 0.0) + us / 1e3
    full = dict(arch=f["arch"], params=n_params, batch=f["batch"],
                seq=f["seq"], microbatches=f["microbatches"],
                remat=f["remat"], steps=steps, steady_step_s=mean_s,
                steady_tokens_per_s=tokens / mean_s,
                steady_flops_share=step_flops / mean_s / PEAK_FLOPS,
                steady_all_params_share=all_params_flops / mean_s / PEAK_FLOPS,
                peak_memory_bytes=peak, checkpoint_bytes=ck_bytes,
                checkpoint_copy_s=save["copy_s"],
                checkpoint_write_wait_s=save["wait_s"],
                profiled_wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_busy_share=busy_ms / wall_ms if busy_ms else None,
                device_kernels=sum(e[2] for e in events),
                device_ms_by_kind=kinds, profile_s=profile_s,
                top=[(k[:100], us / 1e3) for k, us, _ in events[:8]])
    log(f"train: {f['arch']} full width ({n_params:,} parameters, bf16, f32 "
        f"moments), {f['batch']} x {f['seq']} a step in "
        f"{f['microbatches']} microbatches, remat {f['remat']}, phase 7b's "
        f"dataset: loss {losses[0]:.4f} -> {losses[-1]:.4f}; steps 2-"
        f"{f['steps']} {mean_s:.3f} s a step, {tokens / mean_s:.1f} "
        f"tokens/s, model FLOPs share {100 * full['steady_flops_share']:.3f}% "
        f"(model_flops: 6 x {step_flops / 6 / tokens:,.0f} active "
        f"non-embedding parameters x tokens/s over {PEAK_FLOPS / 1e12:.0f} "
        f"TFLOP/s, the H100 SXM's dense bf16 peak from NVIDIA's data sheet; "
        f"by all {n_params:,} parameters, as before, "
        f"{100 * full['steady_all_params_share']:.3f}%); peak memory "
        f"{peak / 2**30:.2f} GiB; checkpoint {ck_bytes:,} bytes, host copy "
        f"{save['copy_s']:.3f} s, write waited {save['wait_s']:.3f} s; "
        f"hand-kernel launches 0 | {smi}")
    if busy_ms:
        log(f"train profile: one step: wall {wall_ms:.1f} ms under the "
            f"profiler, device busy {busy_ms:.1f} ms "
            f"({100 * full['device_busy_share']:.2f}%), "
            f"{full['device_kernels']} device kernels; by kind: " + ", ".join(
                f"{k} {v:.1f} ms ({100 * v / busy_ms:.1f}%)"
                for k, v in sorted(kinds.items(), key=lambda kv: -kv[1]))
            + f" (the profile took {profile_s:.1f} s) | {smi}")
        for name, ms in full["top"]:
            log(f"train profile:   {ms:.3f} ms  {name} | {smi}")
    else:
        log("train profile: the profiler recorded no device time: device "
            "busy share not measured")
    del out, params, opt, tr, prof
    torch.cuda.empty_cache()
    return dict(launches=launches, small=small, resume=resume, full=full)


# (label, B, S, H, K, D, window, softcap, q scale): gemma2-2b's prefill
# shapes (global and local layers) and qwen1.5-0.5b's; at unit scores a
# softcap of 50 moves the output by about 1e-4, inside the tolerance, so
# one more shape scales q by 20 (scores of about N(0, 20^2)) to reach it
FLASH_SHAPES = [
    (f"{arch} S={s}", 1, s, h, kh, d, window, cap, 1.0)
    for s in (37, 512, 6000)
    for arch, h, kh, d, window, cap in (
        ("gemma2-2b global", 8, 4, 256, 0, 50.0),
        ("gemma2-2b local", 8, 4, 256, 4096, 50.0),
        ("qwen1.5-0.5b", 16, 16, 64, 0, 0.0))
] + [("gemma2-2b global S=512 q x 20", 1, 512, 8, 4, 256, 0, 50.0, 20.0)] + [
    (f"recurrentgemma-2b local S={s}", 1, s, 10, 1, 256, 2048, 0.0, 1.0)
    for s in (512, 2100, 6000)  # 2100: the window edge off the tile grid
]

_FLEX: dict = {}  # the compiled flex_attention and its mods, made once
# the one length at which flex_attention is compiled and timed: a compile
# per length and variant takes ~10-40 s of the script's time limit
FLEX_S = 6000


def flex_call(torch, q, k, v, window: int, cap: float):
    """One PyTorch call that computes the kernel's function with a softcap
    or a window: compiled ``flex_attention`` with ``cap * tanh(s / cap)``
    as its ``score_mod`` (none at cap 0), the causal (and window) mask as a
    block mask, and GQA. Timed as the library yardstick only; the port
    never calls it.

    The cap and the window are 0-d tensors that the mods capture, so the
    compiled graph does not depend on their values: it is compiled once
    with a softcap and once without, called at one length (``FLEX_S``).
    Called in bf16 only: its Triton compile for f32 at D 256 takes most of
    the script's time limit on an H100.
    """
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    if not _FLEX:
        cap_t = torch.zeros((), device="cuda")
        window_t = torch.zeros((), dtype=torch.int64, device="cuda")

        def score_mod(score, b, h, qi, ki):
            return cap_t * torch.tanh(score / cap_t)

        def mask_mod(b, h, qi, ki):
            return (qi >= ki) & (qi - ki < window_t)

        _FLEX.update(fn=torch.compile(flex_attention), cap=cap_t,
                     window=window_t, score_mod=score_mod, mask_mod=mask_mod)
    _FLEX["cap"].fill_(cap)
    _FLEX["window"].fill_(window if window > 0 else 2**30)
    s = q.shape[1]
    block_mask = create_block_mask(_FLEX["mask_mod"], None, None, s, s,
                                   device="cuda")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    score_mod = _FLEX["score_mod"] if cap > 0 else None
    return lambda: _FLEX["fn"](qt, kt, vt, score_mod=score_mod,
                               block_mask=block_mask, enable_gqa=True)


def flash_phase(torch, fa, ref) -> list[dict]:
    """``flash_attention`` against ``ref_attention`` on the card, timed
    beside its bound and the one PyTorch call that computes the same
    function: ``scaled_dot_product_attention`` for causal attention without
    softcap or window, compiled ``flex_attention`` (bf16 only) with a
    softcap or a window, SDPA with the window as a dense mask in f32."""
    import torch.nn.functional as F

    from repro_torch.launch.costing import TENSOR_OPS_PER_S, bound, flash_cost

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    results = []
    for label, b, s, h, kh, d, window, cap, q_scale in FLASH_SHAPES:
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                       for shape in ((b, s, h, d), (b, s, kh, d),
                                     (b, s, kh, d)))
            q, k, v = (q * q_scale).to(dt), k.to(dt), v.to(dt)
            kw = dict(causal=True, window=window, softcap=cap)
            got = fa.flash_attention(q, k, v, **kw)
            want = ref.ref_attention(q, k, v, True, window, cap)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(),
                                       **FLASH_TOL[dtype])
            if q_scale != 1.0:
                # the cap must move this output by far more than the
                # tolerance, or the shape would not test it
                moved = float((ref.ref_attention(q, k, v, True, window, 0.0)
                               .float() - want.float()).abs().max())
                if moved <= 50 * FLASH_TOL[dtype]["atol"]:
                    raise AssertionError(
                        f"{label}: the softcap moves the output by only "
                        f"{moved:.3g}")
            err = float((got.float() - want.float()).abs().max())
            reps, trials = (2, 5) if s > 1024 else (10, 21)
            ms = device_ms(lambda: fa.flash_attention(q, k, v, **kw), reps,
                           trials)
            plain_ms = device_ms(
                lambda: ref.ref_attention(q, k, v, True, window, cap), 1,
                trials)
            if dtype == "bfloat16" and (cap > 0.0 or window > 0):
                # compiled once with a softcap and once without, at S 6000
                library = "flex_attention"
                lib = flex_call(torch, q, k, v, window, cap) \
                    if s == FLEX_S else None
            elif cap == 0.0:
                library = "sdpa"
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                mask = None
                if window > 0:
                    i = torch.arange(s, device="cuda")
                    mask = (i[:, None] >= i[None]) & (i[:, None] - i[None]
                                                      < window)

                def lib():
                    return F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=mask, is_causal=mask is None,
                        enable_gqa=True)
            else:
                library = lib = None
            library_ms = None
            if lib is not None:
                torch.testing.assert_close(lib().transpose(1, 2).float(),
                                           want.float(), **FLASH_TOL[dtype])
                library_ms = device_ms(lib, reps, trials)
            flops, bytes_moved = flash_cost(b, s, s, h, kh, d, True, window,
                                            q.element_size())
            bound_ms, bound_by = bound(bytes_moved, flops,
                                       TENSOR_OPS_PER_S[dtype])
            tflops = flops / ms / 1e9
            results.append(dict(shape=label, B=b, S=s, H=h, K=kh, D=d,
                                window=window, softcap=cap, q_scale=q_scale,
                                dtype=dtype, max_abs_err=err, ms=ms,
                                plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=bound_by, tflops=tflops,
                                bound_share=bound_ms / ms, library=library,
                                library_ms=library_ms))
            lib_txt = (f"{library} {library_ms:.5f} ms" if lib is not None
                       else f"flex_attention not timed (only at S {FLEX_S} "
                       "in bf16)")
            rate = (f", {tflops:.1f} TFLOP/s, {100 * bound_ms / ms:.2f}% of "
                    "its bound" if dtype == "bfloat16" else "")
            log(f"flash_attention {label} {dtype}: max |err| {err:.3g} "
                f"(tol {FLASH_TOL[dtype]}); kernel {ms:.5f} ms{rate}, plain "
                f"{plain_ms:.5f} ms, bound {bound_ms:.5f} ms ({bound_by}), "
                f"{lib_txt}")
            del q, k, v, got, want
    return results


# (label, B, S, H, q/k head dim dn + dr, v head dim dv): the MLA layers'
# prefill shapes of minicpm3-4b (q/k 64 + 32, v 64) and deepseek-v2-236b
# (128 + 64, v 128); H = K, no window, no softcap
MLA_SHAPES = [
    (f"{arch} MLA S={s}", 1, s, h, dqk, dv)
    for arch, h, dqk, dv, lengths in (("minicpm3-4b", 40, 96, 64,
                                       (512, 2048, 6000)),
                                      ("deepseek-v2-236b", 128, 192, 128,
                                       (512, 2048)))
    for s in lengths
]


def mla_flash_phase(torch, fa, ref) -> list[dict]:
    """The MLA route's kernel calls: q and k (head dim dn + dr) and v (dv)
    zero-padded to the kernel head dim that holds them
    (``models/attention.py::mla_attention``: 96 → 128, 192 → 256), the
    kernel's context sliced back to dv and held against ``ref_attention``
    on the unpadded tensors at ``FLASH_TOL``; the kernel timed on the padded
    tensors, the plain version and ``scaled_dot_product_attention`` on the
    unpadded ones. The bound counts the unpadded work: each input and the
    output once, and 2·(dn + dr) + 2·dv flops a live pair a head."""
    import torch.nn.functional as F

    from repro_torch.launch.costing import TENSOR_OPS_PER_S, bound, flash_cost

    from repro_torch.models.attention import mla_attention, mla_head_dim

    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    results = []
    for label, b, s, h, dqk, dv in MLA_SHAPES:
        hd = mla_head_dim(max(dqk, dv))
        scale = dqk ** -0.5
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            q, k = (torch.randn((b, s, h, dqk), generator=gen,
                                device="cuda").to(dt) for _ in range(2))
            v = torch.randn((b, s, h, dv), generator=gen, device="cuda").to(dt)
            n0 = fa.launches["flash_attention"]
            got = mla_attention(q, k, v, scale)
            if fa.launches["flash_attention"] != n0 + 1 or got.shape != (
                    b, s, h, dv):
                raise AssertionError(f"{label}: the MLA route did not launch "
                                     "the kernel once")
            want = ref.ref_attention(q, k, v, True, 0, 0.0, scale)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(),
                                       **FLASH_TOL[dtype])
            err = float((got.float() - want.float()).abs().max())
            qp, kp, vp = (F.pad(t, (0, hd - t.shape[-1])) for t in (q, k, v))
            reps, trials = (2, 5) if s > 1024 else (10, 21)
            ms = device_ms(lambda: fa.flash_attention(
                qp, kp, vp, causal=True, scale=scale), reps, trials)
            plain_ms = device_ms(lambda: ref.ref_attention(
                q, k, v, True, 0, 0.0, scale), 1, trials)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

            def lib():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True,
                                                      scale=scale)
            torch.testing.assert_close(lib().transpose(1, 2).float(),
                                       want.float(), **FLASH_TOL[dtype])
            library_ms = device_ms(lib, reps, trials)
            flops, bytes_moved = flash_cost(b, s, s, h, h, hd, True, 0,
                                            q.element_size(), (dqk, dv))
            bound_ms, bound_by = bound(bytes_moved, flops,
                                       TENSOR_OPS_PER_S[dtype])
            results.append(dict(shape=label, B=b, S=s, H=h, K=h, D=hd,
                                D_qk=dqk, D_v=dv, window=0, softcap=0.0,
                                q_scale=1.0, dtype=dtype, max_abs_err=err,
                                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=bound_by,
                                tflops=flops / ms / 1e9,
                                bound_share=bound_ms / ms, library="sdpa",
                                library_ms=library_ms))
            log(f"flash_attention {label} {dtype}: q/k {dqk} and v {dv} "
                f"padded to {hd}: max |err| {err:.3g} against the unpadded "
                f"plain version (tol {FLASH_TOL[dtype]}); kernel {ms:.5f} ms "
                f"({flops / ms / 1e9:.1f} TFLOP/s of unpadded work, "
                f"{100 * bound_ms / ms:.2f}% of its bound), plain "
                f"{plain_ms:.5f} ms, bound {bound_ms:.5f} ms ({bound_by}), "
                f"sdpa (unpadded) {library_ms:.5f} ms")
            del q, k, v, qp, kp, vp, got, want
    return results


def flash_new_phase(torch, fa, ref, shapes=FLASH_NEW_SHAPES,
                    seed: int = 12) -> list[dict]:
    """``flash_attention`` at ``shapes``: ``FLASH_NEW_SHAPES`` (non-causal
    self- and cross-attention with Sq != Sk and a single query row (the
    whisper decode step's cross attention), GQA 6:1 at D 128, olmoe-1b-7b's
    at S 2048, gemma2-9b's at S 5000) or ``FLASH_SMALL_D_SHAPES`` (D 16
    and 32); in each shape's types (bf16 and f32, or bf16 alone) against
    ``ref_attention`` at ``FLASH_TOL``, one launch each; kernel, plain
    version, bound and SDPA (``is_causal`` only where Sq = Sk;
    ``enable_gqa``) timed, SDPA where it computes the same function (no
    softcap, no window)."""
    import torch.nn.functional as F

    from repro_torch.launch.costing import TENSOR_OPS_PER_S, bound, flash_cost

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    results = []
    for (label, b, sq, sk, h, kh, d, causal, window, cap,
         dtypes) in shapes:
        kw = dict(causal=causal, window=window, softcap=cap)
        for dtype in dtypes:
            dt = getattr(torch, dtype)
            q = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(dt)
            k, v = (torch.randn((b, sk, kh, d), generator=gen,
                                device="cuda").to(dt) for _ in range(2))
            n0 = fa.launches["flash_attention"]
            got = fa.flash_attention(q, k, v, **kw)
            if fa.launches["flash_attention"] != n0 + 1:
                raise AssertionError(f"{label}: the kernel did not launch once")
            want = ref.ref_attention(q, k, v, causal, window, cap)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(),
                                       **FLASH_TOL[dtype])
            err = float((got.float() - want.float()).abs().max())
            reps, trials = (2, 5) if max(sq, sk) > 2048 else (10, 21)
            ms = device_ms(lambda: fa.flash_attention(q, k, v, **kw), reps,
                           trials)
            plain_ms = device_ms(
                lambda: ref.ref_attention(q, k, v, causal, window, cap), 1,
                trials)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

            def lib():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True)
            library_ms = None
            if cap == 0.0 and window == 0:
                torch.testing.assert_close(lib().transpose(1, 2).float(),
                                           want.float(), **FLASH_TOL[dtype])
                library_ms = device_ms(lib, reps, trials)
            flops, bytes_moved = flash_cost(b, sq, sk, h, kh, d, causal,
                                            window, q.element_size())
            bound_ms, bound_by = bound(bytes_moved, flops,
                                       TENSOR_OPS_PER_S[dtype])
            tflops = flops / ms / 1e9
            results.append(dict(shape=label, B=b, S=sq, Sq=sq, Sk=sk, H=h,
                                K=kh, D=d, causal=causal, window=window,
                                softcap=cap, q_scale=1.0, dtype=dtype,
                                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by,
                                tflops=tflops, bound_share=bound_ms / ms,
                                library="sdpa" if library_ms else None,
                                library_ms=library_ms))
            lib_txt = (f"sdpa {library_ms:.5f} ms" if library_ms else
                       "no SDPA call computes a softcap or a window")
            log(f"flash_attention {label} (B {b}, H {h}, K {kh}, D {d}, "
                f"{'causal' if causal else 'not causal'}, window {window}, "
                f"softcap {cap}) {dtype}: max |err| {err:.3g} (tol "
                f"{FLASH_TOL[dtype]}); kernel {ms:.5f} ms ({tflops:.1f} "
                f"TFLOP/s, {100 * bound_ms / ms:.2f}% of its bound), plain "
                f"{plain_ms:.5f} ms, bound {bound_ms:.5f} ms ({bound_by}), "
                f"{lib_txt}")
            del q, k, v, got, want
    return results


def rounded_before_normalising(torch, q, k, v, cap: float, tile: int = 64):
    """Causal softcapped attention with p rounded to bf16 before it is
    normalised: the online softmax over ``tile``-key tiles with a running
    max, p = exp(s - m) rounded to bf16 for its product with v, the row sum
    in f32 (the first Hopper build's placement of the rounding, and
    ``flash_xla``'s). Plain PyTorch, the diagnosis of phase 8's margin."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    sc = torch.einsum("bqkgd,bskd->bkgqs", q.reshape(b, s, kh, h // kh, d)
                      .float(), k.float()) * d**-0.5
    sc = cap * torch.tanh(sc / cap)
    i = torch.arange(s, device=q.device)
    sc = torch.where(i[:, None] >= i[None], sc, -2.0**30)
    m = torch.full(sc.shape[:-1] + (1,), -2.0**30, device=q.device)
    l, acc = torch.zeros_like(m), None
    for k0 in range(0, s, tile):
        t = sc[..., k0:k0 + tile]
        m_new = torch.maximum(m, t.amax(-1, keepdim=True))
        alpha, p = torch.exp(m - m_new), torch.exp(t - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        pv = torch.einsum("bkgqs,bskd->bkgqd", p.bfloat16().float(),
                          v[:, k0:k0 + tile].float())
        acc = pv if acc is None else acc * alpha + pv
        m = m_new
    return (acc / l).permute(0, 3, 1, 2, 4).reshape(b, s, h, d)


def flash_margin(torch, fa, ref, draws: int = FLASH_MARGIN_DRAWS) -> dict:
    """How close the bf16 kernel comes to its tolerance on large scores:
    ``draws`` seeded draws of gemma2-2b's global shape at S 512 with q x 20
    (scores of about N(0, 20^2), past the softcap of 50), each held
    against ``ref_attention``. Reports the draws that cross rtol 2e-2,
    atol 8e-3 and the largest ratio of |err| to the tolerance (``main``
    fails on a crossing), and the same for the plain
    :func:`rounded_before_normalising`, which rounds p where the first
    build of the kernel did."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    b, s, h, kh, d, cap = 1, 512, 8, 4, 256, 50.0
    tol = FLASH_TOL["bfloat16"]
    crossed, worst, crossed_b, worst_b = 0, 0.0, 0, 0.0

    def ratio(got, want):
        return float(((got - want).abs()
                      / (tol["atol"] + tol["rtol"] * want.abs())).max())

    for _ in range(draws):
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d)))
        q, k, v = (q * 20.0).bfloat16(), k.bfloat16(), v.bfloat16()
        got = fa.flash_attention(q, k, v, causal=True, softcap=cap).float()
        want = ref.ref_attention(q, k, v, True, 0, cap).float()
        r = ratio(got, want)
        crossed += r > 1.0
        worst = max(worst, r)
        r = ratio(rounded_before_normalising(torch, q, k, v, cap), want)
        crossed_b += r > 1.0
        worst_b = max(worst_b, r)
    log(f"flash_attention bf16 margin: {draws} draws of gemma2-2b global "
        f"S={s} q x 20 (softcap {cap}): the kernel crosses the tolerance "
        f"{tol} on {crossed}, the largest |err| / tolerance is {worst:.4f}; "
        f"p rounded to bf16 before normalising (plain) crosses on "
        f"{crossed_b}, largest {worst_b:.4f}")
    return dict(draws=draws, crossed=crossed, max_ratio=worst,
                rounded_before_normalising=dict(crossed=crossed_b,
                                                max_ratio=worst_b))


def plain_text(ms) -> str:
    return "not timed" if ms is None else f"{ms:.5f} ms"


def rglru_decays(torch, gen, shape, decay: str):
    """RG-LRU decays: ``mild`` U(0.7, 0.999) as the reference's tests draw
    them, or ``strong`` exp(-exp(U(-8, 5))) with one entry in 16 exactly 0
    and one in 16 exactly 1."""
    if decay == "mild":
        return torch.rand(shape, generator=gen, device="cuda") * 0.299 + 0.7
    a = torch.exp(-torch.exp(torch.rand(shape, generator=gen, device="cuda")
                             * 13 - 8))
    pick = torch.rand(shape, generator=gen, device="cuda")
    return torch.where(pick < 1 / 16, 0.0, torch.where(pick > 15 / 16, 1.0, a))


def recurrence_phase(torch, rg, rw, ref) -> tuple[list[dict], list[dict]]:
    """``rglru_linear_scan`` and ``wkv6`` against their plain versions on the
    card at recurrentgemma-2b's and rwkv6-3b's widths, two chunks against
    one, and each timed beside its plain version and its bound (bytes read
    once and written once over 3.35 TB/s; the recurrence's f32 operations
    over 67 TFLOP/s: 2 per RG-LRU element; per WKV6 step, 5 per state entry
    (the read-out ``r·S`` 2, the update ``w·S + k·v`` 3) and the bonus
    ``(Σ_k r_k u_k k_k) v`` at 3 per key and 2 per value)."""
    from repro_torch.launch.costing import bound, rglru_cost, wkv6_cost

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    rg_results = []
    w = 2560
    for b, s, decay in ((1, 37, "mild"), (1, 512, "mild"), (1, 6000, "mild"),
                        (1, 6000, "strong"), (4, 37, "mild"),
                        (4, 512, "mild"), (4, 6000, "mild")):
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            a = rglru_decays(torch, gen, (b, s, w), decay)
            x = torch.randn((b, s, w), generator=gen, device="cuda").to(dt)
            h0 = torch.randn((b, w), generator=gen, device="cuda")
            ys, hf = rg.rglru_linear_scan(a, x, h0)
            want_ys, want_h = ref.ref_rglru(a, x, h0)
            torch.cuda.synchronize()
            torch.testing.assert_close(ys.float(), want_ys,
                                       **RGLRU_TOL[dtype])
            torch.testing.assert_close(hf, want_h, rtol=1e-4, atol=1e-4)
            err = max(float((ys.float() - want_ys).abs().max()),
                      float((hf - want_h).abs().max()))
            trials = 5 if s > 1024 else 21
            ms = device_ms(lambda: rg.rglru_linear_scan(a, x, h0), 10, trials)
            main = (b, s, decay, dtype) == (1, 6000, "mild", "float32")
            plain_ms = (device_ms(lambda: ref.ref_rglru(a, x, h0), 1,
                                  PLAIN_LOOP_TRIALS if s > 1024 else 5,
                                  warmup=1)
                        if main or s <= 1024 else None)
            ops, bytes_moved = rglru_cost(b, s, w, x.element_size())
            bound_ms, bound_by = bound(bytes_moved, ops)
            rg_results.append(dict(B=b, S=s, W=w, dtype=dtype, decay=decay,
                                   max_abs_err=err, ms=ms,
                                   plain_ms=plain_ms, bound_ms=bound_ms,
                                   bound_by=bound_by,
                                   bound_share=bound_ms / ms))
            bar = (f"; the bar {RGLRU_BAR_MS} ms, the target "
                   f"{RGLRU_TARGET_MS} ms" if main else "")
            log(f"rglru_linear_scan B={b} S={s} W={w} {dtype} {decay} decays:"
                f" max |err| {err:.3g} (tol {RGLRU_TOL[dtype]}, h_final "
                f"1e-4); kernel {ms:.5f} ms, {100 * bound_ms / ms:.2f}% of "
                f"its bound, plain {plain_text(plain_ms)}, bound "
                f"{bound_ms:.5f} ms ({bound_by}){bar}")
    for decay in ("mild", "strong"):
        a = rglru_decays(torch, gen, (1, 512, 2560), decay)
        x = torch.randn((1, 512, 2560), generator=gen, device="cuda")
        h0 = torch.zeros((1, 2560), device="cuda")
        y_all, h_all = rg.rglru_linear_scan(a, x, h0)
        y1, h1 = rg.rglru_linear_scan(a[:, :200].contiguous(),
                                      x[:, :200].contiguous(), h0)
        y2, h2 = rg.rglru_linear_scan(a[:, 200:].contiguous(),
                                      x[:, 200:].contiguous(), h1)
        torch.testing.assert_close(torch.cat([y1, y2], 1), y_all, rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(h2, h_all, rtol=1e-5, atol=1e-5)
    log("rglru_linear_scan: S 512 in chunks of 200 and 312 through h0 equals "
        "one scan (1e-5), mild and strong decays")

    rw_results = []
    b, h, kd, vd = 1, 40, 64, 64
    for s, decay in WKV6_DRAWS:
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            r, k = (torch.randn((b, s, h, kd), generator=gen,
                                device="cuda").to(dt) for _ in range(2))
            v = torch.randn((b, s, h, vd), generator=gen, device="cuda").to(dt)
            if decay == "strong":
                w = torch.exp(-torch.exp(torch.rand(
                    (b, s, h, kd), generator=gen, device="cuda") * 13 - 8))
                pick = torch.rand((b, s, h, kd), generator=gen, device="cuda")
                w = torch.where(pick < 1 / 16, 0.0,
                                torch.where(pick > 15 / 16, 1.0, w))
            else:
                w = torch.rand((b, s, h, kd), generator=gen, device="cuda") \
                    * 0.199 + 0.8
            u = torch.randn((h, kd), generator=gen, device="cuda")
            s0 = torch.randn((b, h, kd, vd), generator=gen, device="cuda")
            args = (r, k, v, w, u, s0)
            y, sf = rw.wkv6(*args)
            want_y, want_s = ref.ref_wkv6(*args)
            torch.cuda.synchronize()
            torch.testing.assert_close(y.float(), want_y, **WKV6_TOL[dtype])
            torch.testing.assert_close(sf, want_s, rtol=1e-3, atol=1e-3)
            err = max(float((y.float() - want_y).abs().max()),
                      float((sf - want_s).abs().max()))
            trials = 5 if s > 1024 else 21
            ms = device_ms(lambda: rw.wkv6(*args), 2 if s > 1024 else 10,
                           trials)
            main = (s, decay, dtype) == (6000, "mild", "float32")
            plain_ms = (device_ms(lambda: ref.ref_wkv6(*args), 1,
                                  PLAIN_LOOP_TRIALS if s > 1024 else 5,
                                  warmup=1)
                        if main or s <= 1024 else None)
            ops, bytes_moved = wkv6_cost(b, s, h, kd, vd, v.element_size())
            bound_ms, bound_by = bound(bytes_moved, ops)
            rw_results.append(dict(B=b, S=s, H=h, K=kd, V=vd, dtype=dtype,
                                   decay=decay, max_abs_err=err, ms=ms,
                                   plain_ms=plain_ms, bound_ms=bound_ms,
                                   bound_by=bound_by,
                                   bound_share=bound_ms / ms))
            bar = (f"; the bar {WKV6_BAR_MS} ms, the target "
                   f"{WKV6_TARGET_MS} ms" if main else "")
            log(f"wkv6 B={b} S={s} H={h} K={kd} V={vd} {dtype} {decay} "
                f"decays: max |err| {err:.3g} (tol {WKV6_TOL[dtype]}, state "
                f"1e-3); kernel {ms:.5f} ms, {100 * bound_ms / ms:.2f}% of "
                f"its bound, plain {plain_text(plain_ms)}, bound "
                f"{bound_ms:.5f} ms ({bound_by}){bar}")
            del r, k, v, w, args, y, want_y
    r, k, v = (torch.randn((1, 512, h, kd), generator=gen, device="cuda")
               for _ in range(3))
    w = torch.rand((1, 512, h, kd), generator=gen, device="cuda") * 0.2 + 0.8
    s0 = torch.zeros((1, h, kd, vd), device="cuda")
    y_all, s_all = rw.wkv6(r, k, v, w, u, s0)
    y1, s1 = rw.wkv6(*(z[:, :200].contiguous() for z in (r, k, v, w)), u, s0)
    y2, s2 = rw.wkv6(*(z[:, 200:].contiguous() for z in (r, k, v, w)), u, s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_all, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(s2, s_all, rtol=1e-4, atol=1e-4)
    log("wkv6: S 512 in chunks of 200 and 312 through s0 equals one scan "
        "(1e-4)")
    return rg_results, rw_results


def kernels_per_prefill(cfg) -> dict[str, int]:
    """How many times one prefill launches each serving kernel: once per
    layer of the kind that calls it."""
    from repro_torch.models.lm import layer_plan

    counts = {name: 0 for name in PROFILE_NAMES}
    for kind, _, _ in layer_plan(cfg):
        counts[KERNEL_OF_KIND[kind]] += 1
    return counts


@contextlib.contextmanager
def moe_routes(experts: bool = False, replay: list | None = None):
    """Record every MoE call's routing while the block runs: a list of
    ``{"tokens", "dropped"[, "route"]}``, one entry per MoE layer per
    model call, in call order (``dropped``: the choices past capacity, a
    device tensor, so that recording adds no synchronisation; ``route``:
    the experts, ranks and keep mask, with ``experts``). The port's
    ``moe_route`` is wrapped for the block's duration and restored.

    With ``replay`` (such a recording, with routes, of the same model on
    the same tokens) each MoE call takes the recorded experts, ranks and
    keep mask in place of its own, and its gates from its own router
    probabilities at those experts: two runs then make the same discrete
    choices, so that what differs between them is arithmetic."""
    from repro_torch.models import ffn

    calls = []
    route = ffn.moe_route

    def recording(cfg, p, xt):
        out = route(cfg, p, xt)
        if replay is not None:
            probs, cap = out[0], out[5]
            expert, ranks, keep = (t.to(xt.device)
                                   for t in replay[len(calls)]["route"])
            gate = probs.gather(1, expert)
            gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
            out = (probs, gate, expert, ranks, keep, cap)
        calls.append(dict(tokens=xt.shape[0], dropped=(~out[4]).sum(),
                          route=out[2:5] if experts else None))
        return out

    ffn.moe_route = recording
    try:
        yield calls
    finally:
        ffn.moe_route = route


def experts_differ(a: list[dict], b: list[dict]) -> list[int]:
    """Per MoE layer, the tokens whose set of experts differs between two
    recordings (with routes) of the same model on the same tokens."""
    return [int((x["route"][0].sort(-1).values.cpu()
                 != y["route"][0].sort(-1).values.cpu()).any(-1).sum())
            for x, y in zip(a, b)]


def drops_per_call(torch, calls: list[dict],
                   n_moe: int) -> list[tuple[int, int]]:
    """(tokens, dropped choices) of each model call: ``calls`` grouped into
    runs of ``n_moe`` layers."""
    if len(calls) % n_moe:
        raise AssertionError(f"{len(calls)} MoE calls for {n_moe} layers")
    dropped = torch.stack([c["dropped"] for c in calls]).tolist()
    return [(calls[i]["tokens"], sum(dropped[i:i + n_moe]))
            for i in range(0, len(calls), n_moe)]


def serve_phase(torch, arch: str, counters, serve: dict = SERVE) -> dict:
    """``arch`` at full width through the serve launcher; the launch counts
    of every serving kernel (``counters``: the wrapper modules) are set to 0
    just before and read just after. An MoE model also prints the choices
    dropped past capacity in each prefill and each decode step."""
    from repro_torch.config.base import get_arch
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.models.lm import layer_plan

    argv = ["--arch", arch, "--full-width", "--seed", "0", "--device", "cuda"]
    for key, val in serve.items():
        argv += ["--" + key.replace("_", "-"), str(val)]
    torch.cuda.reset_peak_memory_stats()
    for mod in counters:
        mod.reset_launches()
    with moe_routes() as calls:
        res = serve_launcher.main(argv)
    launches = {name: n for mod in counters for name, n in mod.launches.items()}
    cfg, st = res["model"].cfg, res["stats"]
    lens = [len(p) for p in res["prompts"]]
    if "local" in cfg.layer_pattern and max(lens) <= cfg.window:
        raise AssertionError(f"no prompt longer than the window: {lens}")
    if sorted(res["results"]) != list(range(serve["requests"])):
        raise AssertionError(f"requests completed: {sorted(res['results'])}")
    for rid, toks in res["results"].items():
        if len(toks) != serve["max_new"] or not all(
                0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"request {rid} returned {toks}")
    per = kernels_per_prefill(cfg)
    want = {name: n * st["prefills"] for name, n in per.items()}
    if st["prefills"] != serve["requests"] or launches != want:
        raise AssertionError(
            f"{arch}: kernels launched {launches} for {st['prefills']} "
            f"prefills, expected {want} ({per} per prefill)")
    ttft = sorted(st["first_token_s"].values())
    out = dict(arch=arch, prompt_lens=lens, launches=launches,
               launches_per_prefill=per,
               ttft_median_s=ttft[len(ttft) // 2], ttft_max_s=ttft[-1],
               prefill_tokens=st["prefill_tokens"], prefill_s=st["prefill_s"],
               prefill_tokens_per_s=st["prefill_tokens"] / st["prefill_s"],
               decode_tokens=st["decode_tokens"],
               decode_steps=st["decode_steps"], decode_s=st["decode_s"],
               decode_tokens_per_s=st["decode_tokens"] / st["decode_s"],
               wall_s=res["seconds"],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    counted = ", ".join(f"{name} {n} = {per[name]} x {st['prefills']}"
                        for name, n in launches.items() if per[name])
    log(f"serve: {arch} full width bf16, {serve['requests']} requests "
        f"through {serve['slots']} slots, prompt lengths {lens}, "
        f"{serve['max_new']} new tokens each: wall {out['wall_s']:.3f} s; "
        f"time to first token median {out['ttft_median_s']:.4f} s, max "
        f"{out['ttft_max_s']:.4f} s; prefill {out['prefill_tokens']} tokens, "
        f"{out['prefill_tokens_per_s']:.1f} tokens/s; decode "
        f"{out['decode_tokens']} tokens in {out['decode_steps']} steps, "
        f"{out['decode_tokens_per_s']:.1f} tokens/s; launches {counted} "
        f"prefills; peak memory {out['peak_gb']:.2f} GB")
    n_moe = sum(moe for _, moe, _ in layer_plan(cfg))
    if n_moe:
        per_call = drops_per_call(torch, calls, n_moe)
        pre = [d for t, d in per_call if t != serve["slots"]]
        dec = [d for t, d in per_call if t == serve["slots"]]
        if len(pre) != st["prefills"] or len(dec) != st["decode_steps"]:
            raise AssertionError(f"{arch}: {len(per_call)} MoE calls for "
                                 f"{st['prefills']} prefills and "
                                 f"{st['decode_steps']} decode steps")
        out["dropped"] = dict(per_prefill=pre, per_decode_step=dec,
                              choices_per_prefill=[
                                  n * cfg.top_k * n_moe for n in lens])
        log(f"serve: {arch} MoE choices dropped past capacity (capacity "
            f"factor {get_arch(arch).capacity_factor}, {n_moe} MoE layers): "
            f"per prefill {pre} of {out['dropped']['choices_per_prefill']}; "
            f"per decode step at {serve['slots']} slots (idle ones "
            f"included) {dec}")
    out["model"], out["params"] = res["model"], res["params"]
    return out


def serve_profile(torch, model, params, n: int = 6000, steps: int = 2,
                  extras: dict | None = None) -> dict:
    """Where serving's time goes: one n-token prefill and ``steps`` decode
    steps at 4 live slots under ``torch.profiler`` (device activity only):
    wall time, device busy time, each hand-written kernel's time and share,
    the heaviest kernels. ``extras`` (one row each, batch axis 0: an
    encoder-decoder's frames) join every prefill's batch."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, model.cfg.vocab_size, (1, n))).cuda()
    extras = extras or {}
    rows4 = {k: v.expand(4, *v.shape[1:]) for k, v in extras.items()}
    out = {}
    with torch.inference_mode():
        model.prefill(params, model.init_cache(1, n),
                      {"tokens": toks[:, :64], **extras})
        cache = model.init_cache(4, n + steps + 1)
        batch = {"tokens": toks.expand(4, n), **rows4}
        model.prefill(params, cache, batch)  # fill 4 rows for the decode
        tok = torch.zeros(4, dtype=torch.int64, device="cuda")
        for phase in ("prefill", "decode"):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                if phase == "prefill":
                    model.prefill(params, model.init_cache(1, n),
                                  {"tokens": toks, **extras})
                else:
                    for i in range(steps):
                        pos = torch.full((4,), n + i, dtype=torch.int32,
                                         device="cuda")
                        logits, cache = model.decode(params, cache, tok, pos)
                        tok = logits.argmax(-1)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            events = device_events(prof)
            busy_ms = sum(e[1] for e in events) / 1e3
            per = steps if phase == "decode" else 1
            kernel_ms = {
                name: sum(e[1] for e in events if sym in e[0]) / 1e3 / per
                for name, sym in PROFILE_NAMES.items()}
            out[phase] = dict(
                wall_ms=wall_ms / per, device_busy_ms=busy_ms / per,
                busy_share=busy_ms / wall_ms if wall_ms else None,
                kernel_ms=kernel_ms,
                kernel_share={k: v * per / busy_ms if busy_ms else None
                              for k, v in kernel_ms.items()},
                device_kernels=sum(e[2] for e in events) / per,
                top=[(k[:60], us / 1e3 / per) for k, us, _ in events[:6]])
            o = out[phase]
            what = (f"one {n}-token prefill" if phase == "prefill" else
                    f"per decode step at 4 slots (cache {n + steps + 1})")
            mine = ", ".join(
                f"{k} {v:.3f} ms ({100 * (o['kernel_share'][k] or 0):.2f}%)"
                for k, v in kernel_ms.items() if v)
            log(f"serve profile, {model.cfg.name}, {what}: wall "
                f"{o['wall_ms']:.3f} ms under the profiler, device busy "
                f"{o['device_busy_ms']:.3f} ms "
                f"({100 * (o['busy_share'] or 0):.2f}%), "
                f"{mine or 'no hand-written kernel'}, "
                f"{o['device_kernels']:.0f} device kernels")
            for name, ms in o["top"]:
                log(f"serve profile:   {ms:.4f} ms  {name}")
    return out


def serve_vs_plain(torch, model, params, n: int, batch: dict | None = None):
    """Last-position prefill logits of one ``n``-token prompt through the
    kernels and through the plain path (``attention_impl("xla")`` and
    ``recurrence_impl("plain")``), at full width, in bf16 and in f32 (the
    same weights, widened exactly). ``batch`` (one row, on the card) is the
    prefill's batch where it is more than seeded tokens (an
    encoder-decoder's frames, M-RoPE positions); its float tensors are
    cast to each model's type.

    Checks: (1) in f32 the two paths agree within rtol = atol = 1e-3 (the
    same f32 arithmetic, summed in other orders); (2) in bf16 the kernels'
    logits are no further from the f32 logits than 1.25x the plain path's
    (the kernels are at least as accurate as the reference's algorithm).
    The bf16 kernel-vs-plain distance is printed against rtol = atol =
    3e-2, the reduced-model bound of ``tests/test_kernels_integration.py``,
    but not enforced: over 26 layers at d_model 2304 two bf16 paths that
    round at other places drift further apart than over 4 layers at
    d_model 64 (PERF.md). In an MoE model it also prints, per MoE layer,
    the tokens whose set of experts differs between the two paths in each
    type (a near tie that the paths' rounding breaks either way); in f32
    each path routes on its own, but in bf16 the paths route many tokens
    differently, and a choice that moves moves who is dropped past
    capacity after it, so check (2) runs the plain paths (bf16 and the f32
    truth) with the bf16 kernel path's routing (``moe_routes(replay=)``)
    and prints the distances of the paths routing on their own beside it.
    Returns the f32 model and weights for the next phase.
    """
    import dataclasses

    import numpy as np

    from repro_torch.models.attention import attention_impl
    from repro_torch.models.recurrent import recurrence_impl
    from repro_torch.models.registry import build_model, params_module

    if "local" in model.cfg.layer_pattern and n <= model.cfg.window:
        raise AssertionError(f"prompt of {n} within the window "
                             f"{model.cfg.window}: no key is masked by it")
    if batch is None:
        toks = np.random.default_rng(1).integers(0, model.cfg.vocab_size,
                                                 (1, n))
        batch = {"tokens": torch.from_numpy(toks).cuda()}
    model32 = build_model(dataclasses.replace(model.cfg, dtype="float32"),
                          "cuda")
    params32 = params_module(model32.cfg, model32.device)
    params32.load_state_dict(params.state_dict())
    logits, routes = {}, {}
    with torch.inference_mode():
        for name, m, p in (("bf16", model, params), ("f32", model32,
                                                     params32)):
            batch = batch_on(batch, m.cfg, "cuda")
            with moe_routes(experts=True) as routes[name, "kernel"]:
                logits[name, "kernel"], _ = m.prefill(p, m.init_cache(1, n),
                                                      batch)
            with attention_impl("xla"), recurrence_impl("plain"), \
                    moe_routes(experts=True) as routes[name, "plain"]:
                logits[name, "plain"], _ = m.prefill(p, m.init_cache(1, n),
                                                     batch)
        flips = {name: experts_differ(routes[name, "kernel"],
                                      routes[name, "plain"])
                 for name in ("bf16", "f32")}
        if routes["bf16", "kernel"]:
            # the plain paths once more, with the bf16 kernel path's routing
            for name, m, p in (("bf16", model, params),
                               ("f32", model32, params32)):
                batch = batch_on(batch, m.cfg, "cuda")
                with attention_impl("xla"), recurrence_impl("plain"), \
                        moe_routes(replay=routes["bf16", "kernel"]):
                    logits[name, "plain, routed alike"], _ = m.prefill(
                        p, m.init_cache(1, n), batch)
    truth = logits["f32", "plain"]

    def dist(a, b):
        return float((a - b).abs().max())

    kern, plain = logits["bf16", "kernel"], logits["bf16", "plain"]
    moe = ("f32", "plain, routed alike") in logits
    if moe:
        # an MoE model's bf16 paths break near ties, and with them who is
        # dropped past capacity, in other ways (the counts printed below):
        # the accuracy rule compares the paths with one routing
        truth = logits["f32", "plain, routed alike"]
        plain = logits["bf16", "plain, routed alike"]
    tol = 3e-2 + 3e-2 * plain.abs()
    out = dict(n=n, max_abs_logit=float(truth.abs().max()),
               bf16_kernel_vs_plain=dist(kern, plain),
               bf16_outside_3e2=int(((kern - plain).abs() > tol).sum()),
               f32_kernel_vs_plain=dist(logits["f32", "kernel"],
                                        logits["f32", "plain"]),
               bf16_kernel_vs_f32=dist(kern, truth),
               bf16_plain_vs_f32=dist(plain, truth),
               same_argmax=bool(kern.argmax() == plain.argmax()
                                == truth.argmax()),
               expert_sets_differ=flips if moe else None)
    if moe:
        out["natural_routing"] = dict(
            bf16_kernel_vs_f32=dist(kern, logits["f32", "plain"]),
            bf16_plain_vs_f32=dist(logits["bf16", "plain"],
                                   logits["f32", "plain"]))
    log(f"serve vs plain: {model.cfg.name}, {n}-token prompt, last-position "
        f"logits (max "
        f"|logit| {out['max_abs_logit']:.4g}): f32 kernel vs plain max |err| "
        f"{out['f32_kernel_vs_plain']:.4g} (tol rtol = atol = 1e-3); bf16 "
        f"kernel vs f32 {out['bf16_kernel_vs_f32']:.4g}, bf16 plain vs f32 "
        f"{out['bf16_plain_vs_f32']:.4g} (the kernel's must be <= 1.25x); "
        f"bf16 kernel vs plain {out['bf16_kernel_vs_plain']:.4g}, "
        f"{out['bf16_outside_3e2']} of {plain.numel()} outside rtol = atol "
        f"= 3e-2 (reported); same argmax {out['same_argmax']}")
    if moe:
        nat = out["natural_routing"]
        log(f"serve vs plain: {model.cfg.name}, tokens (of {n}) whose expert "
            f"set differs between the kernel and plain paths, per MoE layer: "
            f"f32 {flips['f32']}, bf16 {flips['bf16']}; the bf16 distances "
            f"above are with the plain paths (bf16 and f32) routed as the "
            f"bf16 kernel path; each path routing on its own: bf16 kernel vs "
            f"f32 {nat['bf16_kernel_vs_f32']:.4g}, bf16 plain vs f32 "
            f"{nat['bf16_plain_vs_f32']:.4g} (reported)")
    torch.testing.assert_close(logits["f32", "kernel"], logits["f32", "plain"],
                               rtol=1e-3, atol=1e-3)
    if out["bf16_kernel_vs_f32"] > 1.25 * out["bf16_plain_vs_f32"]:
        raise AssertionError(f"{model.cfg.name}: the bf16 kernel path is "
                             "further from the f32 logits than 1.25x the "
                             "bf16 plain path")
    return out, model32, params32


def engine_vs_greedy(torch, model, params, n_requests: int = 6) -> dict:
    """The model at full width in f32: the engine's tokens (more requests
    than slots, or as many) equal per-request greedy prefill and decode.
    In an MoE model this holds while no choice is dropped past capacity,
    which couples a call's tokens: the choices dropped in the engine's run
    are printed (prefills on one row, as greedy's, drop alike)."""
    import numpy as np

    from repro_torch.config.base import ServeConfig
    from repro_torch.serve.engine import ServeEngine

    cfg = model.cfg
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=rng.integers(4, 40))
               for _ in range(n_requests)]
    n_new, max_seq = 8, 64
    refs, margins = [], []
    with torch.inference_mode():
        for pr in prompts:
            cache = model.init_cache(1, max_seq)
            logits, cache = model.prefill(
                params, cache, {"tokens": torch.from_numpy(pr[None]).cuda()})
            toks, marg = [], []
            for t in range(n_new):
                top = logits[0].topk(2).values
                toks.append(int(logits[0].argmax()))
                marg.append(float(top[0] - top[1]))
                if t < n_new - 1:
                    pos = torch.tensor([len(pr) + t], dtype=torch.int32,
                                       device="cuda")
                    logits, cache = model.decode(
                        params, cache, torch.tensor([toks[-1]], device="cuda"),
                        pos)
            refs.append(toks)
            margins.append(marg)
    eng = ServeEngine(model, params, ServeConfig(max_batch=4, max_seq=max_seq))
    rids = [eng.submit(pr, max_new=n_new) for pr in prompts]
    with moe_routes() as calls:
        results = eng.run()
    dropped = (int(torch.stack([c["dropped"] for c in calls]).sum())
               if calls else None)
    for rid, ref_toks, marg in zip(rids, refs, margins):
        got = results[rid]
        if got != ref_toks:
            step = next(i for i, (a, b) in enumerate(zip(got, ref_toks))
                        if a != b)
            raise AssertionError(
                f"engine != greedy for request {rid} at step {step}: "
                f"{got} vs {ref_toks}; the reference's top-2 logit margin "
                f"there is {marg[step]:.3g}")
    out = dict(requests=len(prompts), slots=4, new_tokens=n_new,
               min_margin=min(min(m) for m in margins), dropped=dropped)
    drops = ("" if dropped is None else
             f"; MoE choices dropped past capacity in the engine's run: "
             f"{dropped}")
    log(f"engine = greedy: {cfg.name} full width f32, {len(prompts)} requests "
        f"through 4 slots, {n_new} tokens each: equal (smallest top-2 logit "
        f"margin {out['min_margin']:.3g}){drops}")
    return out


def cut_model_phase(torch, fa, arch: str, n_layers: int, prompt: int) -> dict:
    """Phase 11 for ``arch`` at its published widths cut to ``n_layers``
    layers (deepseek-v2-236b: the dense first layer of width 12288 and one
    MoE layer of 160 experts and 2 shared, MLA with 128 heads, q/k 192
    padded to 256; gemma2-9b: one local and one global layer, 16 heads
    over 8 KV heads of 256, softcap 50): the model built through the
    registry with seeded weights, and ``serve_vs_plain`` at ``prompt``
    tokens. The flash kernel must launch once per layer in each of the
    phase's two kernel-route prefills (bf16 and f32)."""
    import dataclasses

    from repro_torch.config.base import get_arch
    from repro_torch.models.registry import build_model

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_arch(arch), n_layers=n_layers)
    model = build_model(cfg, "cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = model.init(gen)
    n_params = sum(p.numel() for p in params.parameters())
    fa.reset_launches()
    out, model32, params32 = serve_vs_plain(torch, model, params, prompt)
    launches = fa.launches["flash_attention"]
    if launches != 2 * cfg.n_layers:
        raise AssertionError(f"{arch}: flash_attention launched {launches} "
                             f"times in 2 kernel prefills of {cfg.n_layers} "
                             "layers")
    del model, params, model32, params32
    torch.cuda.empty_cache()
    out.update(n_layers=cfg.n_layers, params=n_params, launches=launches,
               phase_s=time.perf_counter() - t0)
    log(f"serve vs plain: {cfg.name} cut to {cfg.n_layers} layers at its "
        f"published widths ({n_params} parameters): flash_attention "
        f"launched {launches} = {cfg.n_layers} x 2 prefills; phase "
        f"{out['phase_s']:.1f} s")
    return out


def whisper_phase(torch, fa) -> dict:
    """whisper-large-v3 at full width (bf16, seeded random weights) through
    ``greedy_generate(..., extras={"frames": ...})``, ``WHISPER``'s
    traffic. The flash kernel must launch 3 x 32 times in the prefill (the
    encoder's non-causal self-attention, the decoder's causal self- and
    its cross attention) and 32 times a decode step (cross attention, one
    query row), the counts set to 0 just before and read just after; every
    token in the vocabulary. Timed on the host clock, each step ending in
    a copy of its tokens to the host: the encoder alone, the prefill (time
    to first token: encoder, decoder prompt, first token), the decode
    steps; the peak memory. Then phase 11 on one request's prefill, phase
    12 (one prefill and one decode step at 4 rows) and, for want of an
    engine path (the reference's engine cannot serve it either), the f32
    model's generated tokens through the kernels equal to the plain
    path's."""
    import numpy as np

    from repro_torch.config.base import get_arch
    from repro_torch.core import prng
    from repro_torch.models.attention import attention_impl
    from repro_torch.models.encdec import encode
    from repro_torch.models.frontends import audio_frames_stub
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import greedy_generate

    t0 = time.perf_counter()
    w = WHISPER
    b, s0, new = w["batch"], w["prompt"], w["new"]
    cfg = get_arch(w["arch"])
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, "cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = model.init(gen)
    n_params = sum(p.numel() for p in params.parameters())
    frames = audio_frames_stub(prng.key(0, "cuda"), cfg, b, w["frames"])
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s0))).cuda()
    extras = {"frames": frames}
    torch.cuda.synchronize()
    fa.reset_launches()
    t = time.perf_counter()
    toks = greedy_generate(model, params, prompt, new, w["max_seq"],
                           extras=extras).cpu()
    generate_s = time.perf_counter() - t
    launches = fa.launches["flash_attention"]
    want = 3 * cfg.n_layers + cfg.n_layers * new
    if launches != want:
        raise AssertionError(f"whisper: flash_attention launched {launches} "
                             f"times, expected 3 x {cfg.n_layers} + "
                             f"{cfg.n_layers} x {new} decode steps = {want}")
    if toks.shape != (b, new) or not bool(((toks >= 0)
                                           & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"whisper: generated {tuple(toks.shape)} tokens "
                             "or some outside the vocabulary")
    with torch.inference_mode():
        torch.cuda.synchronize()
        t = time.perf_counter()
        encode(params, cfg, frames)
        torch.cuda.synchronize()
        encode_s = time.perf_counter() - t
        cache = model.init_cache(b, w["max_seq"])
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = model.prefill(params, cache,
                                      {"tokens": prompt, **extras})
        tok = logits.argmax(-1)
        host = [tok.tolist()]
        ttft_s = time.perf_counter() - t
        t = time.perf_counter()
        for i in range(new - 1):
            pos = torch.full((b,), s0 + i, dtype=torch.int32, device="cuda")
            logits, cache = model.decode(params, cache, tok, pos)
            tok = logits.argmax(-1)
            host.append(tok.tolist())
        decode_s = time.perf_counter() - t
    del cache
    same = bool((torch.tensor(host).T == toks).all())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    out = dict(arch=cfg.name, params=n_params, launches=launches,
               launches_per_prefill=3 * cfg.n_layers,
               launches_per_decode_step=cfg.n_layers,
               generate_s=generate_s, encode_s=encode_s, ttft_s=ttft_s,
               prefill_tokens=b * s0, frames=b * w["frames"],
               prefill_tokens_per_s=b * s0 / ttft_s,
               decode_tokens=b * (new - 1), decode_s=decode_s,
               decode_tokens_per_s=b * (new - 1) / decode_s,
               timed_equal_generate=same, peak_gb=peak_gb)
    log(f"serve: whisper-large-v3 full width bf16 ({n_params} parameters), "
        f"{b} requests in one greedy_generate batch, frames [{b}, "
        f"{w['frames']}, {cfg.d_model}], prompts of {s0} tokens, {new} new "
        f"tokens: generate {generate_s:.3f} s; encoder {encode_s:.4f} s; "
        f"time to first token (encoder, prompt, first token) {ttft_s:.4f} s, "
        f"{out['prefill_tokens_per_s']:.1f} prompt tokens/s beside "
        f"{b * w['frames'] / ttft_s:.1f} frames/s; decode {b * (new - 1)} "
        f"tokens in {new - 1} steps, {decode_s:.4f} s = "
        f"{out['decode_tokens_per_s']:.1f} tokens/s (host clock, each step "
        f"ending in a copy to the host; its tokens equal generate's: "
        f"{same}); flash_attention {launches} = 3 x {cfg.n_layers} + "
        f"{cfg.n_layers} x {new}; peak memory {peak_gb:.2f} GB")
    one = {"tokens": prompt[:1], "frames": frames[:1]}
    out["vs_plain"], model32, params32 = serve_vs_plain(torch, model, params,
                                                        s0, batch=one)
    out["profile"] = serve_profile(torch, model, params, s0, steps=1,
                                   extras={"frames": frames[:1]})
    del model, params
    torch.cuda.empty_cache()
    ex32 = {"frames": frames.float()}
    kern = greedy_generate(model32, params32, prompt, new, w["max_seq"],
                           extras=ex32).cpu()
    with attention_impl("xla"):
        plain = greedy_generate(model32, params32, prompt, new, w["max_seq"],
                                extras=ex32).cpu()
    if not torch.equal(kern, plain):
        row, step = (int(x[0]) for x in torch.nonzero(kern != plain)[:1].T)
        raise AssertionError(f"whisper f32: the kernel path's tokens differ "
                             f"from the plain path's at request {row}, step "
                             f"{step}")
    del model32, params32
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    log(f"serve: whisper-large-v3 full width f32, the same {b} requests: the "
        f"{new} tokens through the kernels equal the plain path's; phase "
        f"{out['phase_s']:.1f} s")
    return out


def mrope_phase(torch, fa, model, params) -> dict:
    """qwen2-vl-2b's M-RoPE path (``QWEN_VL`` (b)): the vision stub's
    streams through ``greedy_generate(..., extras={"mrope_pos": ...})``;
    the flash kernel must launch once per layer in the prefill (decode
    attends through ``sdpa``, with plain RoPE positions as the
    reference's); the last-position logits with M-RoPE must differ from
    plain RoPE's on the same tokens; phase 11 on one stream's prefill."""
    from repro_torch.core import prng
    from repro_torch.models.frontends import vision_stream_stub
    from repro_torch.serve.engine import greedy_generate

    t0 = time.perf_counter()
    q = QWEN_VL
    cfg = model.cfg
    tokens, mrope = vision_stream_stub(prng.key(0, "cuda"), cfg, q["streams"],
                                       q["stream_len"])
    torch.cuda.synchronize()
    fa.reset_launches()
    t = time.perf_counter()
    toks = greedy_generate(model, params, tokens, q["new"],
                           extras={"mrope_pos": mrope}).cpu()
    generate_s = time.perf_counter() - t
    launches = fa.launches["flash_attention"]
    if launches != cfg.n_layers:
        raise AssertionError(f"qwen2-vl M-RoPE: flash_attention launched "
                             f"{launches} times, expected {cfg.n_layers}")
    if toks.shape != (q["streams"], q["new"]) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError("qwen2-vl M-RoPE: bad generated tokens")
    one = {"tokens": tokens[:1], "mrope_pos": mrope[:, :1]}
    with torch.inference_mode():
        with_m, _ = model.prefill(params, model.init_cache(1, q["stream_len"]),
                                  one)
        plain_rope, _ = model.prefill(params,
                                      model.init_cache(1, q["stream_len"]),
                                      {"tokens": tokens[:1]})
    moved = float((with_m - plain_rope).abs().max())
    if moved <= 1e-2:
        raise AssertionError(f"qwen2-vl: M-RoPE moves the logits by only "
                             f"{moved:.3g}")
    vs_plain, model32, params32 = serve_vs_plain(torch, model, params,
                                                 q["stream_len"], batch=one)
    del model32, params32
    torch.cuda.empty_cache()
    out = dict(launches=launches, generate_s=generate_s,
               mrope_moves_logits=moved, vs_plain=vs_plain,
               phase_s=time.perf_counter() - t0)
    log(f"serve: qwen2-vl-2b M-RoPE, {q['streams']} vision streams of "
        f"{q['stream_len']} tokens ({int((q['stream_len'] // 4) ** 0.5)}^2 "
        f"patch grid, then text), {q['new']} new tokens through "
        f"greedy_generate: {generate_s:.3f} s, flash_attention {launches} = "
        f"{cfg.n_layers} x 1 prefill; M-RoPE moves the last-position logits "
        f"by {moved:.4g} from plain RoPE's; phase {out['phase_s']:.1f} s")
    return out


def phase12_prefills() -> list[tuple[str, int]]:
    """(arch, tokens) of phase 12's profiled prefills."""
    return ([(arch, 6000) for arch, _ in SERVE_ARCHS]
            + [(arch, MOE_MLA_PROMPT) for arch in MOE_MLA_ARCHS]
            + [(QWEN_VL["arch"], 6000)])


def dryrun_counts() -> dict:
    """Phase 14's counts on the ``meta`` device (no card; run in a process
    of its own): one microbatch of 7d(c)'s step (2 x 4096, remat full, no
    accumulation), the whole step (8 x 4096 in 4 microbatches), and each
    of phase 12's prefills (one row)."""
    from repro_torch.config.base import ShapeConfig, TrainConfig, get_arch
    from repro_torch.launch.costing import cell_costs

    t0 = time.perf_counter()
    f, d = TRAIN_FULL, DRYRUN
    cfg = get_arch(f["arch"])
    out = {
        "microbatch": cell_costs(
            cfg, ShapeConfig("train", f["seq"], d["microbatch"], "train"),
            TrainConfig(microbatches=1, remat=f["remat"])),
        "step": cell_costs(
            cfg, ShapeConfig("train", f["seq"], f["batch"], "train"),
            TrainConfig(microbatches=f["microbatches"], remat=f["remat"])),
        "prefill": {arch: cell_costs(get_arch(arch),
                                     ShapeConfig("prefill", n, 1, "prefill"))
                    for arch, n in phase12_prefills()},
    }
    out["seconds"] = time.perf_counter() - t0
    return out


def dryrun_phase(torch, fa, counts: dict, train: dict, served: dict,
                 smi: str) -> dict:
    """Phase 14: the dry-run tooling held against the card (``DRYRUN``).

    (a) gate: building qwen1.5-0.5b's parameters (bf16) and AdamW state
    (f32) as 7d(c) does asks the caching allocator for the one-card plan's
    bytes within ``ALLOC_ROUND`` a tensor (its ``requested_bytes``; the
    growth of ``memory_allocated()``, which counts whole blocks, up to
    1 MB more a large tensor, is printed beside it); (b) gate: the
    costing's meta FLOPs (``counts``, from :func:`dryrun_counts`) equal
    FlopCounterMode's on the card, exactly, for one microbatch of 7d(c)'s
    step through the plain attention (forward and backward, remat full)
    and for gemma2-2b's prefill through the kernel route, where the card's
    count is FlopCounterMode's aten part plus the flash kernel's formula
    for each layer's launch; (c) prints the roofline terms and bound of
    7d(c)'s step and of phase 12's prefills beside their measured times,
    the model FLOPs shares and 7d(c)'s predicted and measured peak memory;
    (d) prints deepseek-v2-236b's serving plan at 60 layers."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.config.base import ShapeConfig, TrainConfig, get_arch
    from repro_torch.launch import costing
    from repro_torch.launch.dryrun import memory_plan
    from repro_torch.launch.mesh import make_abstract_mesh
    from repro_torch.launch.roofline import (PEAK_FLOPS, model_flops,
                                             roofline_report)
    from repro_torch.models.lm import layer_plan
    from repro_torch.models.registry import Model, build_model
    from repro_torch.sharding import opt_state_specs, param_specs, plan_bytes
    from repro_torch.train.optim import adamw_init
    from repro_torch.train.step import abstract_train_state
    from repro_torch.utils.tree import tree_leaves

    d, f = DRYRUN, TRAIN_FULL
    out: dict = {"counts_s": counts["seconds"]}

    # (a) the plan's bytes against the allocator
    cfg = get_arch(d["arch"])
    tc = TrainConfig()
    one = make_abstract_mesh((1, 1), ("data", "model"))
    p_meta, o_meta = abstract_train_state(Model(cfg, torch.device("meta")),
                                          tc)
    plan = (plan_bytes(p_meta, param_specs(cfg, p_meta, one), one)
            + plan_bytes(o_meta, opt_state_specs(cfg, o_meta, p_meta, one),
                         one))
    n_tensors = len(tree_leaves(p_meta)) + len(tree_leaves(o_meta))
    def allocator():
        torch.cuda.synchronize()
        stats = torch.cuda.memory_stats()
        return (stats["requested_bytes.all.current"],
                torch.cuda.memory_allocated())

    torch.cuda.empty_cache()
    before = allocator()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(tc.seed)
    params = build_model(cfg, "cuda").init(gen)
    opt = adamw_init(dict(params.named_parameters()), tc.opt_state_dtype)
    requested, grown = (x - y for x, y in zip(allocator(), before))
    del params, opt
    torch.cuda.empty_cache()
    if abs(requested - plan) > ALLOC_ROUND * n_tensors:
        raise AssertionError(f"dryrun: the plan says {plan:,} bytes of "
                             f"parameters and AdamW state, the card's "
                             f"allocator was asked for {requested:,} "
                             f"({n_tensors} tensors)")
    out["plan"] = dict(plan_bytes=plan, requested=requested,
                       allocated=grown, tensors=n_tensors)
    log(f"dryrun: {d['arch']} parameters (bf16) and AdamW state (f32): the "
        f"one-card plan {plan:,} bytes; the card's allocator was asked for "
        f"{requested:,} ({requested - plan:+,}; {n_tensors} tensors, within "
        f"{ALLOC_ROUND} bytes each) and its allocated bytes grew by "
        f"{grown:,} (its blocks' rounding and unsplit remainders) | {smi}")

    # (b) the costing's FLOPs against FlopCounterMode on the card
    mb = ShapeConfig("train", f["seq"], d["microbatch"], "train")
    fa.reset_launches()
    with FlopCounterMode(display=False) as counter:
        costing.run_cell(cfg, mb, TrainConfig(microbatches=1,
                                              remat=f["remat"]),
                         device="cuda")
    torch.cuda.synchronize()
    card = counter.get_total_flops()
    meta = counts["microbatch"]
    if (card != meta["aten_flops"] or meta["kernel_flops"]
            or fa.launches["flash_attention"]):
        raise AssertionError(f"dryrun: one microbatch of the step: meta "
                             f"{meta['aten_flops']:,} FLOPs, the card "
                             f"{card:,}, flash launches {fa.launches}")
    torch.cuda.empty_cache()
    g = get_arch(d["prefill_arch"])
    n = d["prefill"]
    fa.reset_launches()
    with FlopCounterMode(display=False) as counter:
        costing.run_cell(g, ShapeConfig("prefill", n, 1, "prefill"),
                         device="cuda")
    torch.cuda.synchronize()
    attn = [kind for kind, _, _ in layer_plan(g) if kind in ("global",
                                                             "local")]
    kernel = sum(costing.flash_cost(
        1, n, n, g.n_heads, g.n_kv_heads, g.head_dim, True,
        g.window if kind == "local" else 0, 2)[0] for kind in attn)
    pre = counts["prefill"][d["prefill_arch"]]
    card_pre = counter.get_total_flops() + kernel
    if (fa.launches["flash_attention"] != len(attn)
            or pre["kernel_calls"] != {"flash_attention": len(attn)}
            or card_pre != pre["flops_per_device"]
            or counter.get_total_flops() != pre["aten_flops"]):
        raise AssertionError(
            f"dryrun: {d['prefill_arch']} prefill: meta {pre['aten_flops']:,}"
            f" + {pre['kernel_flops']:,} FLOPs over {pre['kernel_calls']}, "
            f"the card {counter.get_total_flops():,} + {kernel:,} over "
            f"{fa.launches['flash_attention']} launches")
    torch.cuda.empty_cache()
    out["flops"] = dict(microbatch=card, prefill_aten=card_pre - kernel,
                        prefill_kernel=kernel)
    log(f"dryrun: FLOPs on meta = FlopCounterMode on the card, exactly: one "
        f"{d['microbatch']} x {f['seq']} microbatch of 7d(c)'s step "
        f"(forward, backward, remat {f['remat']}, plain attention) "
        f"{card:,}; {d['prefill_arch']}'s {n}-token prefill {card_pre:,} "
        f"(aten {card_pre - kernel:,} + flash {kernel:,} over "
        f"{len(attn)} launches) | {smi}")

    # (c) the roofline beside the measured times
    def roofline(c, mf, measured_s):
        rep = roofline_report(flops_per_device=c["flops_per_device"],
                              bytes_per_device=c["bytes_per_device"],
                              wire_bytes_per_device=0, n_devices=1,
                              model_flops_global=mf)
        bound_s = max(rep["compute_s"], rep["memory_s"])
        return dict(compute_s=rep["compute_s"], memory_s=rep["memory_s"],
                    dominant=rep["dominant"], bound_s=bound_s,
                    measured_s=measured_s, roofline_mfu=bound_s / measured_s,
                    model_flops_share=mf / measured_s / PEAK_FLOPS)

    full = train["full"]
    step = counts["step"]
    r = roofline(step, model_flops(cfg, ShapeConfig(
        "train", f["seq"], f["batch"], "train")), full["steady_step_s"])
    out["step"] = dict(r, predicted_peak_bytes=step["peak_bytes"],
                       measured_peak_bytes=full["peak_memory_bytes"])
    log(f"dryrun: 7d(c)'s step ({f['batch']} x {f['seq']}, "
        f"{f['microbatches']} microbatches, remat {f['remat']}): "
        f"{step['flops_per_device']:.4e} FLOPs, {step['bytes_per_device']:.4e}"
        f" bytes; compute {r['compute_s']:.4f} s, memory {r['memory_s']:.4f}"
        f" s at {PEAK_FLOPS / 1e12:.0f} TFLOP/s and "
        f"{costing.MEM_BYTES_PER_S / 1e12:.2f} TB/s: bound {r['bound_s']:.4f}"
        f" s ({r['dominant']}) beside the measured {r['measured_s']:.4f} s: "
        f"roofline_mfu {100 * r['roofline_mfu']:.2f}%; model FLOPs share "
        f"{100 * r['model_flops_share']:.3f}%; peak memory predicted "
        f"{step['peak_bytes'] / 2**30:.2f} GiB, measured "
        f"{full['peak_memory_bytes'] / 2**30:.2f} GiB | {smi}")
    out["prefill"] = {}
    for arch, n in phase12_prefills():
        prof = served[arch]["profile"]["prefill"]
        r = roofline(counts["prefill"][arch], model_flops(
            get_arch(arch), ShapeConfig("prefill", n, 1, "prefill")),
            prof["wall_ms"] / 1e3)
        r["busy_share_of_bound"] = r["bound_s"] / (prof["device_busy_ms"]
                                                   / 1e3)
        out["prefill"][arch] = r
        log(f"dryrun: {arch} {n}-token prefill: compute "
            f"{1e3 * r['compute_s']:.3f} ms, memory "
            f"{1e3 * r['memory_s']:.3f} ms: bound {1e3 * r['bound_s']:.3f} "
            f"ms ({r['dominant']}) beside phase 12's wall "
            f"{prof['wall_ms']:.3f} ms (roofline_mfu "
            f"{100 * r['roofline_mfu']:.2f}%) and busy "
            f"{prof['device_busy_ms']:.3f} ms "
            f"({100 * r['busy_share_of_bound']:.2f}%); model FLOPs share "
            f"{100 * r['model_flops_share']:.2f}% | {smi}")

    # (d) deepseek-v2-236b's serving plan at its full depth
    big = get_arch(d["plan_arch"])
    serve = ShapeConfig("serve", d["serve_seq"], d["serve_batch"], "decode")
    out["plan_deepseek"] = {}
    for shape in d["meshes"]:
        m = make_abstract_mesh(shape, ("data", "model"))
        mp = memory_plan(big, serve, m, None)
        name = "x".join(map(str, shape))
        out["plan_deepseek"][name] = mp
        log(f"dryrun: {d['plan_arch']} ({big.n_layers} layers) serving "
            f"{d['serve_batch']} slots of {d['serve_seq']} tokens on a "
            f"{name} (data x model) mesh: {mp['params'] / 1e9:.2f} GB of "
            f"parameters, {mp['cache'] / 1e9:.3f} GB of cache a card, "
            f"{mp['total'] / 1e9:.2f} GB in all: "
            f"{'fits' if mp['fits_80GB'] else 'does not fit'} in 80 GB")
    return out


def serve_defaults_phase(torch, fa) -> dict:
    """Phase 15: ``repro_torch.launch.serve.main([])`` on the card with its
    defaults (the reduced qwen1.5-0.5b, head dim 16, bf16); the flash
    launch count set to 0 just before and read just after. Every request
    must complete with its ``--max-new`` tokens and the kernel must have
    launched once per attention layer per prefill."""
    from repro_torch.launch import serve as serve_launcher

    t0 = time.perf_counter()
    fa.reset_launches()
    res = serve_launcher.main([])
    launches = fa.launches["flash_attention"]
    cfg, st = res["model"].cfg, res["stats"]
    if sorted(res["results"]) != list(range(SERVE_DEFAULTS["requests"])) or \
            any(len(t) != SERVE_DEFAULTS["max_new"]
                for t in res["results"].values()):
        raise AssertionError(f"serve defaults: results {res['results']}")
    per = kernels_per_prefill(cfg)["flash_attention"]
    if cfg.head_dim != 16 or launches != per * st["prefills"]:
        raise AssertionError(
            f"serve defaults: {cfg.name} (head dim {cfg.head_dim}) launched "
            f"flash_attention {launches} times for {st['prefills']} "
            f"prefills, expected {per} a prefill")
    out = dict(arch=cfg.name, head_dim=cfg.head_dim, launches=launches,
               prefills=st["prefills"], wall_s=res["seconds"],
               phase_s=time.perf_counter() - t0)
    log(f"serve defaults: python -m repro_torch.launch.serve on the card: "
        f"{cfg.name}, head dim {cfg.head_dim}, {len(res['results'])}/"
        f"{SERVE_DEFAULTS['requests']} requests of "
        f"{SERVE_DEFAULTS['max_new']} tokens; flash_attention {launches} = {per} x {st['prefills']} "
        f"prefills; wall {res['seconds']:.3f} s")
    return out


def load_example(name: str):
    """``examples_torch/<name>.py`` as a fresh module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(name: str, argv: list[str], device: str = "cuda"):
    """Run one example's ``main`` with ``argv`` on ``device``, cut as
    ``EXAMPLE_CUTS`` says (a dict sets module constants, a list adds
    flags), its output into ``build/chip_smoke_run/examples/<name>[-cpu]
    .log``; (result, seconds)."""
    mod = load_example(name)
    cut = EXAMPLE_CUTS.get(name, [])
    if isinstance(cut, dict):
        for key, val in cut.items():
            setattr(mod, key, val)
    else:
        argv = [*argv, *cut]
    logs = WORK / "examples"
    logs.mkdir(parents=True, exist_ok=True)
    suffix = "" if device == "cuda" else f"-{device}"
    t0 = time.perf_counter()
    with open(logs / f"{name}{suffix}.log", "w") as f, \
            contextlib.redirect_stdout(f):
        out = mod.main([*argv, "--device", device])
    return out, time.perf_counter() - t0


def examples_phase(torch, fa, ref) -> dict:
    """Phase 16: every ``examples_torch`` example on the card at its own
    widths (the steps cut by ``EXAMPLE_CUTS``, printed), each with its
    gates and seconds:

    * serve_lm (reduced gemma2-2b, head dim 16, bf16): flash launched once
      per layer in the ``greedy_generate`` prefill and in each engine
      prefill (the counts set to 0 just before ``main`` and read just
      after); the prompt's logits through the kernel against
      ``attention_impl("xla")`` within phase 8's bf16 tolerance, and the
      greedy tokens of the two routes, the count that differ printed;
    * quickstart: completion 1.0, the aggregate equal to the same example's
      on the CPU (integers exact, floats within rtol 1e-5, phase 5's
      tolerance), every loss finite;
    * scenario_zoo: completion 1.0 in every sweep (``sweep_one`` asserts
      it) and in the mixed one;
    * merge_study: every point's numbers finite, throughput and merges
      positive;
    * phase3_dataset: completion 1.0, the dataset covers every instance,
      ce falls, losses finite;
    * train_lm: losses finite.
    """
    import numpy as np

    from repro_torch.models.attention import attention_impl
    from repro_torch.serve.engine import greedy_generate

    out = {}
    for name, cut in EXAMPLE_CUTS.items():
        log(f"examples: {name} cut: {cut}")
    log(f"examples: merge_study cut: run_points(P_CAVS, steps={MERGE_STEPS}) "
        "in place of main()'s 900 steps")

    fa.reset_launches()
    res, sec = run_example("serve_lm", [])
    launches = fa.launches["flash_attention"]
    model, params, prompt = res["model"], res["params"], res["prompt"]
    per = kernels_per_prefill(model.cfg)["flash_attention"]
    prefills = 1 + res["stats"]["prefills"]
    if model.cfg.head_dim != 16 or launches != per * prefills:
        raise AssertionError(
            f"serve_lm: flash_attention launched {launches} times, expected "
            f"{per} x {prefills} prefills (head dim {model.cfg.head_dim})")
    if sorted(len(t) for t in res["results"].values()) != [12] * 6:
        raise AssertionError(f"serve_lm: results {res['results']}")
    with torch.inference_mode():
        kern, _ = model.apply(params, {"tokens": prompt})
        with attention_impl("xla"):
            plain, _ = model.apply(params, {"tokens": prompt})
            plain_tokens = greedy_generate(model, params, prompt, steps=8)
    torch.testing.assert_close(kern.float(), plain.float(),
                               **FLASH_TOL["bfloat16"])
    logit_err = float((kern.float() - plain.float()).abs().max())
    differ = int((plain_tokens != res["greedy"]).sum())
    out["serve_lm"] = dict(seconds=sec, launches=launches, prefills=prefills,
                           logits_max_abs_err=logit_err,
                           greedy_tokens_differ=differ,
                           greedy_tokens=res["greedy"].numel())
    log(f"examples: serve_lm {model.cfg.name} (head dim "
        f"{model.cfg.head_dim}, window {model.cfg.window}, softcap "
        f"{model.cfg.attn_logit_softcap}) in {sec:.1f} s: flash_attention "
        f"{launches} = {per} x {prefills} prefills; prompt logits through the "
        f"kernel vs attention_impl('xla') max |err| {logit_err:.3g} (tol "
        f"{FLASH_TOL['bfloat16']}); greedy tokens differing between the two "
        f"routes: {differ} of {res['greedy'].numel()}")
    del model, params, res

    res, sec = run_example("quickstart", [])
    cpu, cpu_sec = run_example("quickstart", [], device="cpu")
    if res["completion"] != 1.0 or cpu["completion"] != 1.0:
        raise AssertionError("quickstart: completion below 1.0")

    def flat(d, prefix=""):
        items = {}
        for k, v in d.items():
            items.update(flat(v, f"{prefix}{k}.") if isinstance(v, dict)
                         else {prefix + k: v})
        return items

    got, want = flat(res["summary"]), flat(cpu["summary"])
    if list(got) != list(want):
        raise AssertionError("quickstart: the aggregates' keys differ")
    for k, v in want.items():
        if isinstance(v, int):
            if got[k] != v:
                raise AssertionError(f"quickstart: {k} {got[k]} != {v}")
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
    ces = [h["ce"] for h in res["trainer"].history]
    if not np.isfinite(ces).all():
        raise AssertionError(f"quickstart: losses {ces}")
    out["quickstart"] = dict(seconds=sec, cpu_seconds=cpu_sec, ce=ces)
    log(f"examples: quickstart in {sec:.1f} s (the CPU run {cpu_sec:.1f} s): "
        f"completion 1.0, the aggregate equal to the CPU's ({len(want)} "
        f"fields; throughput {got['total_throughput']}, merges "
        f"{got['total_merges']}); ce {ces[0]:.3f} -> {ces[-1]:.3f}")

    res, sec = run_example("scenario_zoo", [])
    if res["completion"] != 1.0:
        raise AssertionError(f"scenario_zoo: completion {res['completion']}")
    out["scenario_zoo"] = dict(seconds=sec, scenarios=len(res["zoo"]))
    log(f"examples: scenario_zoo in {sec:.1f} s: {len(res['zoo'])} sweeps "
        "and the mixed one, each at completion 1.0")

    mod = load_example("merge_study")
    t0 = time.perf_counter()
    rows = np.asarray(mod.run_points(mod.P_CAVS, steps=MERGE_STEPS,
                                     device="cuda"), dtype=np.float64)
    sec = time.perf_counter() - t0
    if not np.isfinite(rows).all() or not (rows[:, :2] > 0).all():
        raise AssertionError(f"merge_study: rows {rows.tolist()}")
    out["merge_study"] = dict(seconds=sec, steps=MERGE_STEPS,
                              p_cav=list(mod.P_CAVS), rows=rows.tolist())
    log(f"examples: merge_study in {sec:.1f} s: {len(mod.P_CAVS)} points x 4 "
        f"seeds in one batched rollout of {MERGE_STEPS} steps; (throughput, "
        f"merges, ramp_blocked, mean_speed) at p_cav {list(mod.P_CAVS)}: "
        f"{np.round(rows, 3).tolist()}")

    import shutil

    shutil.rmtree(WORK / "phase3", ignore_errors=True)
    res, sec = run_example("phase3_dataset", ["--dataset-dir",
                                              str(WORK / "phase3")])
    ds, tr = res["dataset"], res["trainer"]
    ces = [h["ce"] for h in tr.history]
    if res["info"]["completion_rate"] != 1.0 or ds.n_instances != 8 or \
            not np.isfinite(ces).all() or not ces[-1] < ces[0]:
        raise AssertionError(f"phase3_dataset: completion "
                             f"{res['info']['completion_rate']}, "
                             f"{ds.n_instances} instances, ce {ces}")
    out["phase3_dataset"] = dict(seconds=sec, instances=ds.n_instances,
                                 corpus_tokens=int(res["corpus"].shape[0]),
                                 ce=ces)
    log(f"examples: phase3_dataset in {sec:.1f} s: completion 1.0 with "
        f"{len(res['info']['failure_events'])} failure event(s), "
        f"{ds.n_instances} instances in {len(ds.manifest['shards'])} shards, "
        f"corpus {res['corpus'].shape[0]} tokens; ce {ces[0]:.3f} -> "
        f"{ces[-1]:.3f}")

    res, sec = run_example("train_lm", [])
    ces = [h["ce"] for h in res["trainer"].history]
    if not np.isfinite(ces).all():
        raise AssertionError(f"train_lm: losses {ces}")
    hist = res["trainer"].history[-1]
    out["train_lm"] = dict(seconds=sec, ce=ces,
                           params=res["params_count"]["total_with_emb"],
                           steps_per_s=hist["steps_per_s"])
    log(f"examples: train_lm {res['cfg'].name} "
        f"({res['params_count']['total_with_emb'] / 1e6:.1f}M parameters) in "
        f"{sec:.1f} s: ce {ces[0]:.3f} -> {ces[-1]:.3f}, "
        f"{hist['steps_per_s']:.2f} steps/s (host clock)")
    out["seconds"] = {name: out[name]["seconds"] for name in EXAMPLES}
    log("examples: seconds " + ", ".join(
        f"{k} {v:.1f}" for k, v in out["seconds"].items())
        + f" (quickstart's CPU run {out['quickstart']['cpu_seconds']:.1f})")
    return out


def states_equal(torch, a, b, path="state") -> None:
    if a is None and b is None:
        return
    if isinstance(a, torch.Tensor):
        if not torch.equal(a, b):
            raise AssertionError(f"{path} differs")
        return
    for name, x, y in zip(a._fields, a, b):
        states_equal(torch, x, y, f"{path}.{name}")


def main() -> None:
    from concurrent.futures import ThreadPoolExecutor

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("[chip_smoke] torch.cuda.is_available() is False: "
                         "this script needs an NVIDIA GPU")
    from repro_torch.convert import to_numpy
    from repro_torch.kernels import build, idm, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import rwkv6 as rw
    from repro_torch.launch import sweep as launcher

    # seconds of each phase, printed at the end
    phase_s: dict[str, float] = {}
    t_mark = [time.perf_counter()]

    def phase_done(name: str) -> None:
        now = time.perf_counter()
        phase_s[name] = now - t_mark[0]
        t_mark[0] = now

    # 1. card
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {kind}")

    # f32 products in full f32 (the engine = greedy phase compares tokens)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build: one nvcc per source, started together; phase 3 needs only
    # idm.cu, so it runs while the other three finish (its timings are
    # device times), and they are joined before phase 4's host-clock sweep
    t0 = time.perf_counter()
    pool = ThreadPoolExecutor(4)
    builds = {n: pool.submit(build.load, n)
              for n in ("idm", "flash_attention", "rglru", "wkv6")}
    builds["idm"].result()
    log(f"built {SOURCE} for sm_90a in {time.perf_counter() - t0:.2f} s")
    phase_done("1-2 card, build idm.cu")

    # 3. kernels against their plain versions
    nb_results, idm_results = kernel_phase(torch, idm, ref)
    for done in builds.values():
        done.result()
    pool.shutdown()
    log(f"built {FLASH_SOURCE}, {RGLRU_SOURCE} and {WKV6_SOURCE} for sm_90a "
        f"while phase 3 ran: all four ready {time.perf_counter() - t0:.2f} s "
        "after the build started")
    phase_done("3 kernels")

    # 4. the sweep at full size through the launcher
    argv = [
        "--instances", str(SWEEP["instances"]), "--slots", str(SWEEP["slots"]),
        "--steps", str(SWEEP["steps"]), "--chunk-steps",
        str(SWEEP["chunk_steps"]), "--scenario-mix", "all",
        "--dispatch", "grouped", "--neighbor-impl", "cuda", "--seed", "0",
        "--device", "cuda", "--devices", "1",
    ]
    idm.reset_launches()
    res = launcher.main(argv)
    counts = dict(idm.launches)
    state = res["state"]
    done = float(state.done.float().mean())
    if done != 1.0:
        raise AssertionError(f"sweep completion {done}, expected 1.0")
    want = 2 * SWEEP["chunk_steps"] * res["group_calls"]
    if counts["neighbor_kernel"] != want:
        raise AssertionError(
            f"neighbor_kernel launched {counts['neighbor_kernel']} times, "
            f"expected 2 x {SWEEP['chunk_steps']} x {res['group_calls']} = {want}")
    m = to_numpy(state.metrics)
    for name in m._fields:
        x = getattr(m, name)
        if x.shape != (SWEEP["instances"],):
            raise AssertionError(f"metrics.{name} has shape {x.shape}")
        if x.dtype.kind == "f" and not (x[x < 1e9] >= 0).all():
            raise AssertionError(f"metrics.{name} has negative values")
    import numpy as np

    if not all(np.isfinite(getattr(m, f)).all() for f in m._fields):
        raise AssertionError("non-finite sweep metrics")
    if not (m.steps == SWEEP["steps"]).all():
        raise AssertionError("some instance did not run every step")
    inst_steps = SWEEP["instances"] * SWEEP["steps"]
    veh_steps = float(m.speed_count.sum())
    wall = res["seconds"]
    sweep = dict(wall_s=wall, instance_steps_per_s=inst_steps / wall,
                 vehicle_steps_per_s=veh_steps / wall)
    log(f"sweep: {SWEEP['instances']} instances x {SWEEP['steps']} steps, "
        f"{SWEEP['slots']} slots, 4-scenario mix, grouped, cuda impl: "
        f"wall {wall:.3f} s, {inst_steps / wall:.1f} instance-steps/s, "
        f"{veh_steps / wall:.1f} vehicle-steps/s ({veh_steps:.0f} active "
        f"vehicle-steps), neighbor_kernel launches {counts['neighbor_kernel']}"
        f" = 2 x {SWEEP['chunk_steps']} x {res['group_calls']} group calls")
    phase_done("4 sweep")

    # 14's meta counts, in a process of their own while the card runs 5-13
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    counter_pool = ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    counts_future = counter_pool.submit(dryrun_counts)

    # 5. a small sweep on the card against the same sweep on the CPU
    small = ["--instances", "8", "--slots", "16", "--steps", "120",
             "--chunk-steps", "40", "--scenario-mix", "all", "--seed", "0"]
    with contextlib.redirect_stdout(io.StringIO()):
        gpu = launcher.main(small + ["--neighbor-impl", "cuda", "--device", "cuda"])
        cpu = launcher.main(small + ["--neighbor-impl", "sort", "--device", "cpu"])
    g, c = to_numpy(gpu["state"].metrics), to_numpy(cpu["state"].metrics)
    for name, x, y in zip(g._fields, g, c):
        if x.dtype.kind == "f":
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-3,
                                       err_msg=f"metrics.{name}")
        else:
            np.testing.assert_array_equal(x, y, err_msg=f"metrics.{name}")
    log("reference: 8-instance sweep on the card (cuda impl) matches the CPU "
        "(sort impl): counters equal, floats within rtol 1e-5")
    phase_done("5 reference")

    # 6. cuda == sort on the card, bit for bit
    parity = ["--instances", str(PARITY["instances"]), "--slots",
              str(SWEEP["slots"]), "--steps", str(PARITY["steps"]),
              "--chunk-steps", str(PARITY["steps"]), "--scenario-mix", "all",
              "--dispatch", "grouped", "--seed", "0", "--device", "cuda"]
    with contextlib.redirect_stdout(io.StringIO()):
        a = launcher.main(parity + ["--neighbor-impl", "cuda"])
        b = launcher.main(parity + ["--neighbor-impl", "sort"])
    states_equal(torch, a["state"], b["state"])
    log("parity: cuda and sort give a bit-identical final SweepState "
        f"({PARITY['instances']} instances, {PARITY['steps']} steps)")
    phase_done("6 parity")

    # 6a. the same sweep through blocks, and phase 4's through 2 blocks
    blocks = blocks_phase(torch, idm, a["state"], sweep)
    phase_done("6a blocks")

    # 7. where a group call's time goes
    profile_phase(torch)
    phase_done("7 profile")

    # 7a. the recording, checkpointed, supervised sweep in-process; 7b. the
    # controller over the full-size recording sweep (the gate)
    record = record_phase(torch, idm, a["state"])
    phase_done("7a record")
    pipeline = pipeline_phase(torch, sweep)
    phase_done("7b pipeline")
    # 7c. the LM inputs of 7b's dataset; 7d. training on it
    tokens_phase(torch, pipeline["dataset"])
    phase_done("7c tokens")
    train = train_phase(torch, pipeline["dataset"], (idm, fa, rg, rw))
    phase_done("7d train")

    main_nb = nb_results[0]
    main_idm = idm_results[0]
    kernels = [
        dict(name="neighbor_kernel", route="cuda", source=SOURCE,
             replaces="src/repro/kernels/idm.py:242",
             launches=counts["neighbor_kernel"],
             launches_by_path={"sweep": counts["neighbor_kernel"],
                               "blocks": blocks["launches"],
                               "record": record["launches"],
                               "record pipelined, 2 blocks":
                                   record["launches_pipe"],
                               "pipeline (final worker)":
                                   pipeline["launches_final_worker"],
                               "train": train["launches"]["neighbor_kernel"]},
             max_abs_err=max(r["max_abs_err"] for r in nb_results),
             ms=main_nb["ms"], plain_ms=main_nb["plain_ms"],
             bound_ms=main_nb["bound_ms"], bound_by=main_nb["bound_by"],
             library_ms=None, shapes=nb_results),
        dict(name="idm_accel_kernel", route="cuda", source=SOURCE,
             replaces="src/repro/kernels/idm.py:130",
             launches=counts["idm_accel_kernel"],
             launches_by_path={"sweep": counts["idm_accel_kernel"],
                               "train": train["launches"]["idm_accel_kernel"]},
             max_abs_err=max(r["max_abs_err"] for r in idm_results),
             ms=main_idm["ms"], all_pairs_ms=main_idm["all_pairs_ms"],
             plain_ms=main_idm["plain_ms"], bound_ms=main_idm["bound_ms"],
             bound_by=main_idm["bound_by"], library_ms=None,
             shapes=idm_results),
    ]

    # 8. flash attention against its plain version
    fl_results = flash_phase(torch, fa, ref)
    fl_results += mla_flash_phase(torch, fa, ref)
    t_flash_new = time.perf_counter()
    fl_new = flash_new_phase(torch, fa, ref)
    fl_results += fl_new
    flash_new_s = time.perf_counter() - t_flash_new
    t_small = time.perf_counter()
    fl_small = flash_new_phase(torch, fa, ref, FLASH_SMALL_D_SHAPES, seed=13)
    fl_results += fl_small
    flash_small_s = time.perf_counter() - t_small
    margin = flash_margin(torch, fa, ref)
    if margin["crossed"]:
        raise AssertionError(f"flash_attention bf16: {margin['crossed']} of "
                             f"{margin['draws']} q x 20 draws cross the "
                             "tolerance")
    phase_done("8 attention")

    # 9. the recurrence kernels against their plain versions
    rg_results, rw_results = recurrence_phase(torch, rg, rw, ref)
    phase_done("9 recurrences")

    # 10-13 for each served model: serve, serve vs plain, profile,
    # engine = greedy; each model is freed before the next
    served = {}
    for arch, plain_n in SERVE_ARCHS:
        out = serve_phase(torch, arch, (fa, rg, rw))
        model, params = out.pop("model"), out.pop("params")
        out["vs_plain"], model32, params32 = serve_vs_plain(
            torch, model, params, plain_n)
        out["profile"] = serve_profile(torch, model, params)
        del model, params
        torch.cuda.empty_cache()
        out["engine_vs_greedy"] = engine_vs_greedy(torch, model32, params32)
        del model32, params32
        torch.cuda.empty_cache()
        served[arch] = out
    phase_done("10-13 gemma2-2b, recurrentgemma-2b, rwkv6-3b")
    # the same for the MoE and MLA families, shorter (SERVE_MOE_MLA), then
    # deepseek-v2-236b cut to 2 layers through phase 11
    t_new = time.perf_counter()
    for arch in MOE_MLA_ARCHS:
        t0 = time.perf_counter()
        out = serve_phase(torch, arch, (fa, rg, rw), SERVE_MOE_MLA)
        model, params = out.pop("model"), out.pop("params")
        out["vs_plain"], model32, params32 = serve_vs_plain(
            torch, model, params, MOE_MLA_PROMPT)
        out["profile"] = serve_profile(torch, model, params, MOE_MLA_PROMPT)
        del model, params
        torch.cuda.empty_cache()
        out["engine_vs_greedy"] = engine_vs_greedy(
            torch, model32, params32, ENGINE_REQUESTS[arch])
        del model32, params32
        torch.cuda.empty_cache()
        out["phase_s"] = time.perf_counter() - t0
        log(f"serve: {arch}, phases 10-13 in {out['phase_s']:.1f} s")
        served[arch] = out
    deepseek = cut_model_phase(torch, fa, **DEEPSEEK)
    log(f"serve: the MoE and MLA families (phases 10-13 and deepseek's 11) "
        f"in {time.perf_counter() - t_new:.1f} s")
    phase_done("10-13 olmoe-1b-7b, minicpm3-4b, deepseek-v2-236b")
    # the encoder-decoder and M-RoPE families, then gemma2-9b cut to 2
    # layers through phase 11
    whisper = whisper_phase(torch, fa)
    t0 = time.perf_counter()
    out = serve_phase(torch, QWEN_VL["arch"], (fa, rg, rw))
    model, params = out.pop("model"), out.pop("params")
    out["vs_plain"], model32, params32 = serve_vs_plain(
        torch, model, params, QWEN_VL["plain_n"])
    out["profile"] = serve_profile(torch, model, params)
    out["mrope"] = mrope_phase(torch, fa, model, params)
    del model, params
    torch.cuda.empty_cache()
    out["engine_vs_greedy"] = engine_vs_greedy(torch, model32, params32)
    del model32, params32
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    log(f"serve: {QWEN_VL['arch']}, phases 10-13 and the M-RoPE path in "
        f"{out['phase_s']:.1f} s")
    served[QWEN_VL["arch"]] = out
    gemma9 = cut_model_phase(torch, fa, **GEMMA9)
    phase_done("whisper-large-v3, qwen2-vl-2b, gemma2-9b")

    # 14. the dry-run tooling against the card
    counts = counts_future.result()
    counter_pool.shutdown()
    dryrun_phase(torch, fa, counts, train, served, smi)
    phase_done("14 dryrun")

    # 15. the serve launcher on its defaults (head dim 16); 16. the examples
    serve_defaults = serve_defaults_phase(torch, fa)
    phase_done("15 serve defaults")
    examples = examples_phase(torch, fa, ref)
    phase_done("16 examples")
    small_s = {"phase 8 D 16/32": flash_small_s,
               "15 serve defaults": phase_s["15 serve defaults"],
               "16 examples": phase_s["16 examples"]}
    log("the head-dim repair and the examples: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in small_s.items())
        + f"; {sum(small_s.values()):.1f} s in all")
    train_new_s = sum(train["small"][a]["arch_s"]
                      for a in ("whisper-large-v3", "qwen2-vl-2b"))
    new_s = {"phase 8 new shapes": flash_new_s, "whisper-large-v3":
             whisper["phase_s"], "qwen2-vl-2b": out["phase_s"],
             "gemma2-9b (2 layers)": gemma9["phase_s"],
             "7d(a) whisper and qwen2-vl": train_new_s}
    log("the encoder-decoder, M-RoPE and gemma2-9b work: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in new_s.items())
        + f"; {sum(new_s.values()):.1f} s in all")

    def launched(name):
        return sum(out["launches"][name] for out in served.values())

    main_fl = next(r for r in fl_results if r["dtype"] == "bfloat16" and
                   r["S"] == 6000 and r["window"] == 0 and r["D"] == 256
                   and "D_qk" not in r)
    main_rg = next(r for r in rg_results if r["dtype"] == "float32" and
                   r["S"] == 6000 and r["B"] == 1 and r["decay"] == "mild")
    main_rw = next(r for r in rw_results if r["dtype"] == "float32" and
                   r["S"] == 6000 and r["decay"] == "mild")
    mrope = served[QWEN_VL["arch"]]["mrope"]
    kernels.append(dict(
        name="flash_attention", route="cuda", source=FLASH_SOURCE,
        replaces="src/repro/kernels/flash_attention.py:135",
        launches=launched("flash_attention") + whisper["launches"]
        + mrope["launches"] + serve_defaults["launches"]
        + examples["serve_lm"]["launches"],
        launches_by_path={**{arch: out["launches"]["flash_attention"]
                             for arch, out in served.items()},
                          "whisper-large-v3": whisper["launches"],
                          "qwen2-vl-2b (M-RoPE)": mrope["launches"],
                          "serve launcher defaults (D 16)":
                              serve_defaults["launches"],
                          "examples_torch/serve_lm.py (D 16)":
                              examples["serve_lm"]["launches"],
                          "deepseek-v2-236b (2 layers, phase 11)":
                              deepseek["launches"],
                          "gemma2-9b (2 layers, phase 11)":
                              gemma9["launches"],
                          "train": train["launches"]["flash_attention"]},
        max_abs_err=max(r["max_abs_err"] for r in fl_results),
        ms=main_fl["ms"], plain_ms=main_fl["plain_ms"],
        bound_ms=main_fl["bound_ms"], bound_by=main_fl["bound_by"],
        library=main_fl["library"], library_ms=main_fl["library_ms"],
        shapes=fl_results, bf16_margin=margin,
        serve=served["gemma2-2b"], deepseek_vs_plain=deepseek,
        gemma2_9b_vs_plain=gemma9, whisper=whisper, new_work_s=new_s,
        small_head_dims=fl_small, serve_defaults=serve_defaults,
        examples=examples))
    for name, source, replaces, main_row, rows, arch in (
            ("rglru_linear_scan", RGLRU_SOURCE,
             "src/repro/kernels/rglru.py:74", main_rg, rg_results,
             "recurrentgemma-2b"),
            ("wkv6", WKV6_SOURCE, "src/repro/kernels/rwkv6.py:79", main_rw,
             rw_results, "rwkv6-3b")):
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launched(name),
            launches_by_path={arch: served[arch]["launches"][name],
                              "train": train["launches"][name]},
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=main_row["ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=None, shapes=rows, serve=served[arch]))

    log("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                      for k, v in phase_s.items())
        + f"; the script {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
