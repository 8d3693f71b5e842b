"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Builds the eight CUDA sources of the port from this checkout, one
``nvcc`` each, all started together: ``flash_pair_fwd`` and
``flash_pair_bwd`` (flash attention over packed qkv, with in-kernel
dropout; also ``kernels.flash_attention_qkv_packed``, the packed-qkv call
for heads of 128), ``flash_attention_fwd`` and ``flash_attention_bwd``
(flash attention on ``[B, L, H, D]`` with grouped-query attention,
per-sequence key lengths, segment ids and in-kernel dropout),
``dq_ordered_sum`` (the backwards' last step: dq summed over their kv
tiles' partial slabs in kv-tile order), ``dropout_fwd`` (dropout, forward
and backward) and
``fused_add_dropout_ln_fwd`` / ``_bwd`` (BERT's residual epilogue
``LayerNorm(x + dropout(sub))``); the build fails on a wgmma that ptxas
serialises (its note C7520). It times both attention forwards and both
backwards against the parent commit's wrappers and kernels
(``[parent-fwd]``, ``[parent-bwd]``: an unpacked ``git archive`` of it in
``smoke_checkout/parent/`` or ``PARENT_TREE``; without one the phases say
so), in turns, and fails a case only beyond the timing noise (a backward
also beyond ``BWD_ORDER_SLACK``, what the fixed dq order may cost; a body
redesigned by the change also below its asked speed-up, ``FWD_SPEEDUP``
and ``BWD_SPEEDUP``: none in this tree),
beside sdpa and the bound; it holds each kernel against its plain PyTorch
version at
the shapes the main paths give it and at every head size the kernels are
built for (64, 80, 96, 128, 256, 72 on zero-padded heads, and above 256:
320, 384, 448, 512, 1024 (fp32: two column slices), and 300 on
zero-padded heads; the bf16 wide-head kernels at their headline shape,
``[compare-wide]``, the fp32 ones and the fp32 forward and backward at
heads up to 256 at theirs beside the parent's and sdpa's,
``[fp32-bodies]``, the plain versions' times at the other shapes of
PERF.md's kernel table, ``[plain-times]``, and the
bodies each launcher runs by the profiler's kernel names and the body
counters, ``[wide-route]``; every backward body's dq, dk and dv bit for
bit over three launches at the model shapes and at one shape per head
size, and the ordered dq sum bit for bit against its plain version,
``[bwd-order]``; every dropout mask for mask:
each is one Philox function of the seed and the element, and the attention
masks are read back with probe inputs), then drives the main paths through
the user entry points, random weights from a seed:

* GPT-medium (vocab 50304, hidden 1024, 16 blocks, 8 heads of 128)
  serving: the scoring forward and the paged DecodeEngine answering 8
  requests at the ``bench.py decode --paged`` geometry with its steps run
  eagerly ([engine], the reference), then a cross-check of the engine's
  tokens against the uncached forward; then the serving engine's captured
  programs (CUDA graphs; no flash kernel on these paths): the same
  requests graphed ([engine-graph]: tokens identical to [engine]'s,
  compile_count 2 after a warm-up request and no capture in the drain,
  tokens/s and peak memory beside the eager reading), with whole-prompt
  bucketed prefill ([engine-buckets]), sampling at T 0.8, top_k 50
  ([engine-sample]: a seed reproduces, another differs, top_k 1 is
  greedy) and ``generate()`` at 8 x 128 + 64 ([generate]: eager then
  graphed, identical), both held to the uncached forward; the scoring
  time and a profiled serving run, eager and graphed; then the engine's
  other modes on the same requests: the row cache (``paged=False``,
  buckets 64 and 128: [engine-row], eager then graphed, compile_count 3),
  speculative decoding with the three drafters of ``bench.py decode
  --spec`` (prompt lookup; a draft GPT of 4 blocks at hidden 512; early
  exit through every other block; window 64, k 4: [engine-spec-*],
  tokens identical to [engine-graph]'s or, where they first differ, a
  near-tie, then held to the uncached forward), the drafters' programs
  against their plain attention with the flash launches counted inside
  the replays ([draft-kernel-*]), int8 weight-only serving
  ([engine-int8], the model's Linear layers swapped in place) and
  ``Int8Linear`` on the card against the CPU ([int8-linear]);
* GPT-medium training: ``TrainStep`` + ``AdamW(1e-4, wd 0.01,
  multi_precision=True)`` at the ``bench.py`` train geometry (batch 16 x
  seq 1024, dropout 0 as ``bench.py`` builds it), 1 warm-up and 6 timed
  steps, a profiled step, the same steps with attention in its plain
  versions, then the slice against the plain CPU path on the same weights
  (loss and every leaf's gradient), and again at dropout 0.1; then
  checkpointing on the same recipe: 4 steps straight against 2 steps, an
  async ``save_checkpoint``, a fresh model from another seed,
  ``load_checkpoint`` and 2 steps, bit for bit (losses, parameters,
  moments, masters, step count; the snapshot's bytes, the stall at
  ``save()``, the background write, the load and a ``block=True`` save
  timed: [ckpt-resume]), and SIGTERM under a ``PreemptionWatcher`` taking
  a ``block=True`` save at the next step boundary, resumed bit for bit,
  the handler restored ([ckpt-preempt]);
* BERT-base (vocab 30528, hidden 768, 12 layers of 12 heads of 64, FFN
  3072, dropout 0.1; BASELINE.md config 2) pretraining at batch 64 x 512
  (MLM on 15% of positions + NSP), 1 warm-up and 6 timed steps, a profiled
  step, the eval scoring forward at [64, 512], the same steps with every
  kernel in its plain version, then 2 layers in fp32 against the plain CPU
  path at dropout 0.1: once on the packed path (unpadded batches, the pair
  kernels) and once on padded batches (``seq_lens``; lengths uniform in
  [32, 512] from a seed: the flat kernels with the lengths), where the
  padded route at full lengths is also held to the packed route; the
  token-type gradient the same in 60 identical backwards ([type-order]:
  the model's one-hot product, torch's lookup counted beside it) before
  the captured step is held bit for bit to the eager one;
* row 6's direct call: ``kernels.flash_attention_qkv_packed`` (the pair
  kernels) under
  autograd at [2, 2048, 3*16*128] (no model reaches it);
* LLaMA-7B (vocab 32000, hidden 4096, FFN 11008, 32 blocks of 32 heads of
  128, built on the card) serving: the scoring forward at [2, 2048] and
  the engine answering 8 requests eagerly, a cross-check against the
  uncached forward, the same requests graphed ([llama-engine-graph], as
  [engine-graph]), ``generate()`` at 2 x 128 + 32 ([llama-generate]) held
  to the uncached forward, a profiled graphed serving run, the scoring
  time, the row cache and the early-exit drafter (16 of the 32 blocks
  draft: [llama-engine-row], [llama-engine-spec], [draft-kernel-llama]),
  and the graphed engine run and cross-check in fp32 at 2 blocks
  with GQA (32 q heads on 8 KV heads), where the tokens must agree, with
  the early-exit drafter too ([llama-engine-spec-fp32]: identical tokens
  but at a near-tie of 1e-4);
* GPT-medium training's features: activation recompute, one forward and
  backward at 16 x 1024 without it (twice: the two runs bit for bit) and
  under "dots", "selective" and "full" (every leaf of the gradient bit for
  bit, the attention forward launched twice a block, peak memory falling:
  [train-recompute]), then ``bench.py``'s ``--recompute`` lane
  (selective, batch 24 x 1024, 3 timed steps: [recompute-lane]); "full"
  at dropout 0.1 on 4 blocks against no recompute from the same
  generator state (rows 1, 2 and 8 replay their masks:
  [train-recompute-dropout]); ``accumulate_steps`` 2 x 8 against one step
  of 16 and the peak memory of 4 x 4 ([train-accum]); a ``GradScaler``
  with ``ClipGradByGlobalNorm(1.0)``, clean and with an inf gradient
  ([train-amp]); ``auto_cast`` O1 on the fp32 model and ``decorate`` + O2
  at 4 x 1024 against the uncast fp32 step and the bf16 model
  ([train-amp-cast]);
* the monitor (``paddle_tpu_torch.monitor``) on GPT-medium: [train]'s
  recipe under ``monitor.enable(path, trace=True)`` with a health sample
  every 2 steps, 6 steps on and 6 off in blocks of 3 (the overhead must
  stay within [train]'s spread), the ledger's MFU and HFU against the
  H100 peak, the measured and analytic FLOPs a token, one ``recompile``
  record, the goodput gauges summing to the wall, the shared tools
  reading the files ([monitor-train]); ``PADDLE_HEALTH_FAULT=nan@param:3``
  at 4 blocks tripping at the next sample with one WARN and one flight
  dump ([monitor-health-fault]); and [engine-graph]'s requests through a
  graphed engine with monitor and tracer on (a trace a request, queue /
  prefill / decode; ``serve_compile`` = ``compile_count`` 2, none in the
  drain; tokens/s beside [engine-graph]'s; a prompt-lookup run reaching
  ``serve_spec_step``: [monitor-engine]); the files land in
  ``smoke_checkout/monitor/``;
* the serving guardrails and the fleet on the graphed GPT-medium engine
  (last, on the model built again from seed 0):
  a ``PADDLE_SERVE_FAULT`` schedule (injected allocation and admission
  failures, slow chunk and decode calls) with a queue deadline and a
  cancel, every request terminal, invariants after every step,
  compile_count 2, done requests with [engine-graph]'s tokens
  ([guard-chaos]); the watchdog against a slow call (WARN, flight dump,
  ``EngineHangError``, the engine reused) and against a sleep enqueued on
  the card before the decode replay, and tokens/s armed against unarmed
  ([guard-hang]); SIGTERM drain under a ``PreemptionWatcher``
  ([guard-drain]); two engines (8 slots, block 16, chunk 32) behind the
  ``Router`` under affinity and round-robin, a killed engine's tickets
  requeued, a rolling restart ([fleet-router]); a cold engine adopting a
  warm one's exported prefix blocks from the pool, with the tokens of the
  same engine without it ([fleet-pool]); and two worker processes on the
  card (this script with ``--fleet-worker``; GPT-medium at 4 blocks)
  behind HTTP doors registered on the port's ``KVServer``, this process
  the router, one SIGKILLed, with the fleet collector's stream read on
  rank 0 ([fleet-http]; files in ``smoke_checkout/fleet/``);
* LLaMA-7B training at full width and 4 blocks (32 would not fit: 16 bytes
  a parameter), batch 4 x seq 2048, the recipe of GPT's, 1 warm-up and 4
  timed steps, a profiled step, the same steps with attention in its plain
  versions, then the slice in fp32 at 2 blocks with GQA against the plain
  CPU path, and "selective" recompute against none
  ([llama-train-recompute]);
* the Paddle dygraph surface (``import paddle_tpu_torch as paddle``) at
  BERT-base width: ``nn.Embedding(30522, 768)``, ``nn.TransformerEncoder``
  of 12 ``nn.TransformerEncoderLayer(768, 12, 3072, dropout=0.1,
  activation="gelu")``, ``nn.LayerNorm``, an ``nn.Linear`` head over every
  token and ``F.cross_entropy``, cast with ``Layer.to(dtype="bfloat16")``,
  ``paddle.optimizer.AdamW(multi_precision=True)``, batch 64 x 512: the
  stack at 2 layers of width 256 in fp32 on the card against the CPU
  from one seed ([api-check]); the eager Paddle loop ``loss.backward();
  opt.step(); opt.clear_grad()``, 1 warm-up and 4 timed steps, a profiled
  step and the dispatcher's host cost ([api-train]); the same model under
  ``TrainStep`` captured, bit for bit with the eager ``TrainStep``, timed
  ([api-graph]); two steps with every kernel in its plain version
  ([api-plain]).
* convolution, pooling and the batch norms on the Paddle surface and
  ``vision.models.resnet50`` (slice 20; torch / cuDNN ops, no hand kernel:
  every launch count stays 0 on these paths): each new functional on the
  card against the CPU in fp32 and bf16, outputs and gradients
  ([conv-check]); ResNet-50 (10 classes) in fp32 at 8 x 32 x 32, three
  ``Momentum(0.1, 0.9)`` steps of the Paddle loop from one shared state
  on the card, the CPU and the CPU in fp64 (loss and ``_mean`` /
  ``_variance`` against the CPU's, every update against fp64's:
  [resnet-check]) and its eval forward ([resnet-eval]); BASELINE config
  1's rows on seeded 32 x 32 images: the eager Paddle loop at batch 32 in
  fp32 and under ``auto_cast()`` ([resnet-train]), ``TrainStep`` captured
  against ``fast_path=False`` at batch 64, bit for bit with the buffers,
  ``num_compiles`` 1 ([resnet-graph]); 20 identical backwards one result
  under ``FLAGS_cudnn_deterministic`` ([resnet-order]); one card's share of
  config 3: 1000 classes at 224 x 224, batch 64, captured, under
  ``auto_cast()`` ([resnet-224]); images/s, ms a step over windows, peak
  memory and the busy share.
* hapi and io (slice 21): recompute over a batch norm, captured, bit for
  bit the run without it, the running statistics moved once
  ([recompute-bn], F12); ``paddle.Model`` on ResNet-50 at config 1's
  geometry fed by the ``io.DataLoader`` (shuffled, worker threads):
  ``fit`` eager with ``metric.Accuracy`` bit for bit a hand loop
  ([hapi-fit]); ``prepare(jit_compile=True)`` through the
  ``io.DeviceLoader`` as ``fit``, ``fit(metric_lag=2)`` and a hand
  ``TrainStep`` loop, bit for bit and timed ([hapi-graph]);
  ``evaluate`` and ``predict`` against the hand eval ([hapi-eval]);
  ``AutoCheckpoint`` with SIGTERM at step 12, resumed bit for bit, the
  stall of each ``save()`` ([hapi-ckpt]); and the Paddle-API encoder at
  BERT-base width accumulating 4 microbatches of 16 x 512 a window
  through ``prepare(accumulate_steps=4)`` over ``DeviceLoader(
  stack_batches=4)``, a hand ``TrainStep`` and ``fleet.
  GradientMergeOptimizer``, bit for bit, rows 4, 5 and 8 and the dq sum
  counted a window, the eager merge buffer within its stated tolerance
  ([hapi-accum]).
* The rest of nn and the optimizers (slice 22): the PTB "medium" LSTM
  language model of Zaremba et al. (vocabulary 10,000, 2 x 650, unroll
  35, batch 20, dropout 0.5 through row 8, SGD 1.0 clipped at 5) at
  dropout 0 on the card against the CPU ([lstm-check]), as an eager
  Paddle loop with a cuDNN LSTM yardstick on its weights ([lstm-lm]) and
  captured bit for bit its eager ``TrainStep`` ([lstm-graph]); BERT-base
  at [bert-train]'s geometry under ``Lamb`` (fp32 masters), a 2-layer
  fp32 cut's gradients and Lamb updates on the card against the CPU
  ([bert-lamb-check]), eager and captured bit for bit, rows 1, 2, 7, 8
  and the dq sum each step ([bert-lamb]); every new functional and layer
  and the six new staged rules on the card against the CPU, the rules
  captured bit for bit ([surface-check]).

Each path is driven with the launch counts set to 0 just before it and
read just after; a kernel its path never launched fails the run. A
captured program (a drafter's, a captured training step's) counts the
launches the device ran: its first call's, then one body's worth at each
replay (``core/programs.py``); a speculative path's counts are blocks x
the program's calls (``_replayed``; [draft-kernel-*] checks that number a
replay against the profiler's kernel names). TF32 is
off for matrix products and cuDNN (``allow_tf32 = False``), so fp32 on the
card is fp32. Every phase raises on failure; the script exits non-zero and
prints no result line unless all of them pass. Needs CUDA (exits non-zero
without it) and imports nothing of JAX.

The second line from the end is the ``kernels`` JSON: per kernel, its
launches on the main paths, its error against the plain version, its time,
the plain version's time, the least time the card could take (bound) and
the time of one PyTorch call computing the same function (library_ms, a
yardstick only; the port never calls it); rows 1 and 4 again at the
drafters' windows. The last line is ``{"ok": true,
"device": {...}}``.

    python3 chip_smoke.py --api-only

runs the card's checks, the build and the [api-*] phases alone in a fresh
process (the Paddle surface's numbers without the script's earlier
phases) and prints neither JSON line.

    python3 chip_smoke.py --vision-only

runs the card's checks and the vision phases alone in a fresh process (no
build: no hand kernel lies on their paths) and prints neither JSON line.

    python3 chip_smoke.py --hapi-only

runs the card's checks, the build and the hapi phases alone in a fresh
process and prints neither JSON line.

    python3 chip_smoke.py --surface-only

runs the card's checks, the build and the slice-22 phases alone in a
fresh process and prints neither JSON line; ``--surface-only
--trace-probe N`` then profiles each [wide-route] route N more times and
counts the traces that lost device events.
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# published H100 SXM peaks (dense): bf16 tensor cores, fp32 without them,
# device memory bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

GPT_MEDIUM = dict(vocab_size=50304, hidden_size=1024, num_layers=16,
                  num_heads=8, max_position_embeddings=1024,
                  hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
ENGINE = dict(max_slots=16, max_len=256, block_size=16, prefill_chunk=32)
TRAIN = dict(batch=16, seq=1024, steps=6)       # bench.py's train geometry

# [compare-bwd] limits on the relative Frobenius error of each of dq, dk,
# dv against the plain version: 3x the largest of the first chip readings
# (bf16 2.36e-4, fp32 1.96e-7 on an H100; see phase_compare_bwd)
BWD_REL_LIMIT = {torch.bfloat16: 7e-4, torch.float32: 6e-7}
# [train-check]: fp32 card (kernels) vs fp32 CPU (plain path), per leaf
TRAIN_CHECK_REL_LIMIT = 1e-4
# [train-plain]: largest |loss difference| per step between the bf16
# training run through the kernels and the same run through the plain
# attention. The first reading on an H100 was 1.96e-3, growing with the
# steps (Adam turns noise-level gradient differences into full steps); the
# limit is 10x that and still
# over 10x below the 0.27 rise of the curve the witness explains.
TRAIN_PLAIN_LOSS_LIMIT = 0.02

# LLaMA-7B (models/llama.py llama_7b): served at full depth, trained at 4
# blocks (full width) at batch 4 x seq 2048
LLAMA_7B = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                num_layers=32, num_heads=32)
LLAMA_TRAIN = dict(batch=4, seq=2048, steps=4, layers=4)
# [compare-fa] / [compare-fa-bwd] shapes: (B, Lq, Lk, H, Hkv, D, dtype,
# causal): the scoring shape, the training shape, GQA 32/8, multi-query
# 4/1, and fp32 ragged Lq != Lk at D = 64 (GQA 4/2), causal and not
BF16, FP32 = torch.bfloat16, torch.float32
FA_TRAIN_CASE = (4, 2048, 2048, 32, 32, 128, BF16, True)
FA_CASES = [(2, 2048, 2048, 32, 32, 128, BF16, True), FA_TRAIN_CASE,
            (2, 2048, 2048, 32, 8, 128, BF16, True),
            (2, 2048, 2048, 4, 1, 128, BF16, True),
            (2, 200, 300, 4, 2, 64, FP32, True),
            (2, 200, 300, 4, 2, 64, FP32, False)]
# the head sizes the JAX gate also sends to a kernel: built at 80, 96 and
# 256, and 72 (run at 80 on zero-padded heads), bf16 and fp32, GQA 8/2
FA_CASES += [(2, 1024, 1024, 8, 2, d, BF16, True) for d in (80, 96, 256, 72)]
FA_CASES += [(2, 200, 300, 4, 2, d, FP32, c)
             for d, c in ((80, True), (96, False), (256, True), (72, False))]
# heads above 256 (bf16: csrc/flash_wide_sm90.cuh; fp32:
# csrc/flash_f32_wide.cuh): 320 and 512 in bf16 and fp32, and 300 (run at
# 320 on zero-padded heads), GQA 4/2; 384 and 448 in bf16, 512 multi-query
# 4/1 at a ragged Lq != Lk, and fp32 1024 (GQA 2/1), where the fp32
# kernels split the head's columns into two slices of 512
FA_CASES += [(2, 512, 512, 4, 2, 320, BF16, True),
             (2, 512, 512, 4, 2, 512, BF16, False),
             (2, 256, 256, 4, 2, 300, BF16, True),
             (2, 200, 300, 4, 2, 320, FP32, True),
             (2, 200, 300, 4, 2, 512, FP32, False),
             (2, 512, 512, 4, 2, 384, BF16, True),
             (2, 512, 512, 4, 2, 448, BF16, False),
             (2, 200, 333, 4, 1, 512, BF16, True),
             (1, 256, 256, 2, 1, 1024, FP32, True)]
# [parent-fwd]: where the parent commit's forward kernels are timed beside
# these (an unpacked git archive of it; absent, the phase says so)
PARENT_TREE = os.environ.get("PARENT_TREE", os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "smoke_checkout", "parent"))
# [compare-fa-bwd] limits on the relative Frobenius error of each of dq,
# dk, dv against the plain version: 3x the largest first reading on an
# H100 (bf16 2.76e-4, dv of multi-query 4/1; fp32 2.96e-7)
FA_BWD_REL_LIMIT = {BF16: 8.3e-4, FP32: 9e-7}
# fp32 backwards above D = 256 ([compare-bwd], [compare-fa-bwd],
# [compare-fa-masks], [compare-dropout-attn], [fp32-bodies]): there the
# fp32 plain version on the card sits 3e-6 to 4e-6 from the exact gradient
# (cuBLAS's fp32 products at those depths; 1e-6 at D = 64) and the kernel,
# which sums in 64-column blocks, ~7.7e-7 (the first readings on an H100,
# the first kernels; the FFMA micro-tile kernels of csrc/flash_f32_wide.cuh
# read 0.9e-6 to 1.1e-6). Those cases are held to the exact gradient, the
# plain versions run in fp64 from fp64 inputs (forward included), within
# 3x the first reading.
BIG_D_FP32_REL_LIMIT = 2.3e-6


EXACT_NOTE = ", against the exact gradient"


def _exact(dtype, d):
    """Whether a backward case is held to the exact gradient
    (BIG_D_FP32_REL_LIMIT) rather than to the plain version in its type."""
    return dtype == FP32 and d > 256
# [llama-crosscheck] (bf16, 32 blocks): every position where the engine's
# greedy token is not the uncached forward's argmax must be a near-tie, a
# logit gap <= the limit, and the agreement at least the floor. The first
# reading on an H100: agreement 0.852, largest gap at a miss 0.224. With
# random weights the model's top-1/top-2 gap has a median of 0.24 and a
# 10% quantile of 0.03, and bf16 moves logits between the paged path
# (fp32 softmax) and the kernel (p rounded), so ~15% of positions flip (the
# phase measures the same between two uncached routes as a witness). A
# broken path read 0.18 with gaps up to 5.95 (the decode-row fault found
# with this phase). Gap limit ~2x the reading, floor 0.1 under it.
CROSSCHECK_GAP = {BF16: 0.5, FP32: 1e-3}
CROSSCHECK_FLOOR = {BF16: 0.75, FP32: 0.99}
# [llama-train]: how far the first loss may sit from ln(vocab)
LOSS0_SLACK = 1.5

# BERT-base (models/bert.py bert_base, BASELINE.md config 2): dropout 0.1
# on the embeddings, the attention probabilities and both residuals of
# every layer; pretrained at B=64, S=512, 1 + 6 steps
BERT_BASE = dict(vocab_size=30528, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=3072,
                 max_position_embeddings=512, hidden_dropout_prob=0.1,
                 attention_dropout_prob=0.1)
BERT_TRAIN = dict(batch=64, seq=512, steps=6)
BERT_PAD_SEED = 45       # [bert-pad-train]'s batch; [compare-fa-masks] too
# launches of one BERT-base training step: a pair forward and backward per
# layer, two fused-LN epilogues forward and backward per layer, and the
# embedding dropout forward and backward
BERT_STEP_LAUNCHES = dict(flash_pair_fwd=12, flash_pair_bwd=12,
                          fused_add_dropout_ln_fwd=24,
                          fused_add_dropout_ln_bwd=24, dropout_fwd=2)
# launches of one BERT-base training step on a padded batch: a flat
# forward and backward per layer, the fused-LN epilogues and the embedding
# dropout as on the packed path, and no pair launch
BERT_PAD_STEP_LAUNCHES = dict(flash_attention_fwd=12, flash_attention_bwd=12,
                              fused_add_dropout_ln_fwd=24,
                              fused_add_dropout_ln_bwd=24, dropout_fwd=2)
# [compare-fused-ln] limits on the relative Frobenius error of each of dx,
# d(sub), dw, db against the plain version: 3x the largest first reading on
# an H100 (bf16 1.58e-5, d(sub) at rate 0.1; fp32 2.53e-7, dw at 0.1)
FUSED_BWD_REL_LIMIT = {BF16: 5e-5, FP32: 8e-7}


def log(msg):
    print(msg, flush=True)


def cuda_time_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls,
    measured with CUDA events after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def flash_bound_ms(b, L, h, d, dtype, causal):
    """Least time for the attention forward: the larger of its bytes (qkv
    read once, out and lse written once) over the memory rate and its
    matmul operations (2 products of 2*D per attended (q, k) pair) over
    the peak rate of the input type."""
    esize = torch.finfo(dtype).bits // 8
    nbytes = b * L * 3 * h * d * esize + b * L * h * d * esize + b * h * L * 4
    pairs = L * (L + 1) // 2 if causal else L * L
    flops = 4.0 * d * b * h * pairs
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def flash_bwd_bound_ms(b, L, h, d, dtype, causal):
    """Least time for the attention backward: the larger of its bytes (qkv,
    out, dO and lse read once, d(qkv) written once) over the memory rate
    and its matmul operations (5 products of 2*D per attended pair) over
    the peak rate of the input type."""
    esize = torch.finfo(dtype).bits // 8
    nbytes = (3 + 1 + 1 + 3) * b * L * h * d * esize + b * h * L * 4
    pairs = L * (L + 1) // 2 if causal else L * L
    flops = 10.0 * d * b * h * pairs
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def _grew(before, after):
    """Launches per kernel between two ``launch_counts()`` readings."""
    return {k: after[k] - before[k] for k in after}


def _expect_launches(where, grew, **want):
    """Raise unless ``grew`` launched exactly ``want`` and nothing else;
    every flash backward launches one ordered dq sum behind it, so
    ``dq_ordered_sum`` is expected as often as the two backwards unless
    ``want`` names it."""
    want.setdefault("dq_ordered_sum", want.get("flash_pair_bwd", 0)
                    + want.get("flash_attention_bwd", 0))
    full = {k: want.get(k, 0) for k in grew}
    if grew != full:
        raise AssertionError(f"{where}: launches {grew}, expected {full}")


# the flash kernels' names (csrc/flash_attention.cuh and the headers it
# includes: the forwards, the backwards, the backward's pre-pass; and
# csrc/dq_sum.cu's ordered dq sum), as profiler keys contain them
FLASH_KERNELS = ("flash_fwd_sm90_kernel", "flash_fwd_wide_kernel",
                 "flash_fwd_f32_kernel", "flash_fwd_f32_wide_kernel",
                 "flash_fwd_f32_small_kernel",
                 "flash_bwd_sm90_kernel", "flash_bwd_wide_kernel",
                 "flash_bwd_f32_kernel", "flash_bwd_f32_wide_kernel",
                 "bwd_prepass_kernel", "scale_q_kernel", "dq_sum_kernel")


def _is_flash_kernel(key):
    """A profiler key of the flash kernels (``FLASH_KERNELS``; one family
    runs on each training path)."""
    return any(name in key for name in FLASH_KERNELS)


def rel_err(got, want):
    """Relative Frobenius error ||got - want|| / ||want||, taken in fp64
    (the exact references are fp64)."""
    got, want = got.double(), want.double()
    return ((got - want).norm() / want.norm().clamp_min(1e-300)).item()


def phase_card():
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"[card] {name} x{count}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return name, count, smi


def phase_build():
    """Builds every source; per compiled kernel (an entry function, its
    mangled name cut to the kernel's name and template arguments: type,
    head size, dropout and segment flags), ptxas's registers and spills.
    Beside them, the parent's four flash sources (``_parent_kernels``).
    Returns the parent's kernels package, or None."""
    from concurrent.futures import ThreadPoolExecutor

    from paddle_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        parent = pool.submit(_parent_kernels)
        built = _build.build_all()
        parent_kernels = parent.result()
    log(f"[build] {len(built)} kernel source(s) in "
        f"{time.perf_counter() - t0:.1f} s"
        + ("" if parent_kernels is None else
           " (the parent's four flash sources beside them)"))
    for name, res in built.items():
        _log_registers(f"[build] {name}", res["log"])
    if parent_kernels is not None:
        # the parent's Hopper and big-head kernels, to see where codegen
        # moved
        for name, res in parent_kernels.build_logs.items():
            for only in ("sm90", "big"):
                _log_registers(f"[build] parent {name}", res["log"], only)
    return parent_kernels


def _log_registers(tag, ptxas_log, only=""):
    """Log ptxas's registers and spills per compiled kernel (an entry
    function, its mangled name cut to the kernel's name and template
    arguments) whose name contains ``only``; raise on a serialised wgmma
    (ptxas note C7520: a kernel as written that runs far below its
    design)."""
    entry, spill = "?", ""
    for line in ptxas_log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            m = re.search("(" + "|".join(FLASH_KERNELS)
                          + r"|[a-z_]+kernel)I(.+)", entry)
            if m:
                entry = f"{m.group(1)}<{m.group(2)}>"
        elif "spill" in line:
            spill = line.split(":")[-1].strip()
        elif "Used" in line and "registers" in line and only in entry:
            regs = line.split("Used")[1].split(",")[0].strip()
            log(f"{tag} {entry}: {regs}; {spill}")
        elif "C7520" in line:
            raise AssertionError(f"{tag}: {line.strip()}")


PARENT_SOURCES = ("flash_attention_fwd", "flash_attention_bwd",
                  "flash_pair_fwd", "flash_pair_bwd")


def _parent_kernels():
    """The parent commit's kernel package (``paddle_tpu_torch/kernels`` of
    PARENT_TREE, imported as ``parent_port.kernels``: its wrappers with its
    own build module, sources and build directory, and the sibling modules
    they import, such as its ``monitor``, from the parent's tree; the
    parent's package ``__init__`` is not run) with its four flash sources
    built by its own ``_build`` in parallel, for [parent-fwd] and
    [parent-bwd]; None without a parent tree."""
    import importlib
    import types
    from concurrent.futures import ThreadPoolExecutor
    root = os.path.join(PARENT_TREE, "paddle_tpu_torch")
    if not os.path.isfile(os.path.join(root, "kernels", "__init__.py")):
        return None
    port = types.ModuleType("parent_port")
    port.__path__ = [root]
    sys.modules["parent_port"] = port
    mod = importlib.import_module("parent_port.kernels")
    with ThreadPoolExecutor(len(PARENT_SOURCES)) as pool:
        mod.build_logs = dict(zip(PARENT_SOURCES,
                                  pool.map(mod._build.build, PARENT_SOURCES)))
    return mod


def phase_compare():
    """Kernel vs plain version: the scoring shape, a ragged fp32 D=64
    case, a bidirectional case, the training shape and heads of 256 (bf16
    causal, fp32 bidirectional). Returns the scoring shape's record.

    q and k are drawn N(0, 2^2) and v N(0, 1), so the scores have a spread
    of 4 and a handful of keys carry each row: the outputs are O(1)
    (median |out| about 0.3), and a kernel that loses a kv tile or
    misreads v's rows is off by O(1) on many rows. The bf16 limit allows
    one bf16 ulp of |out| (rtol 1e-2 > 2^-7) plus the spread from rounding
    p to bf16 against a running rather than the final row max (atol
    4e-3). The [compare] line prints the largest error as a share of this
    limit."""
    from paddle_tpu_torch.kernels.flash_pair import (
        flash_pair_fwd, flash_pair_fwd_reference)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    record = None
    cases = [(2, 1024, 8, 128, torch.bfloat16, True),    # the slice's shape
             (2, 300, 4, 64, torch.float32, True),       # ragged L, D=64
             (2, 1024, 8, 128, torch.bfloat16, False),   # bidirectional
             (16, 1024, 8, 128, torch.bfloat16, True),   # the train shape
             (2, 1024, 4, 256, torch.bfloat16, True),    # heads of 256
             (2, 300, 2, 256, torch.float32, False),
             (2, 512, 2, 384, torch.bfloat16, True),     # heads of 384
             (2, 300, 2, 384, torch.float32, False)]
    for b, L, h, d, dtype, causal in cases:
        qkv = torch.randn(b, L, 3, h * d, device="cuda", generator=gen)
        qkv[:, :, :2] *= 2.0
        qkv = qkv.reshape(b, L, 3 * h * d).to(dtype)
        out, lse = flash_pair_fwd(qkv, h, causal)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_pair_fwd_reference(qkv, h, causal)
        atol, rtol = (4e-3, 1e-2) if dtype == torch.bfloat16 else (1e-4,
                                                                    1e-4)
        torch.testing.assert_close(out.float(), ref_out.float(), atol=atol,
                                   rtol=rtol)
        torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-3)
        diff = (out.float() - ref_out.float()).abs()
        err = diff.max().item()
        of_limit = (diff / (atol + rtol * ref_out.float().abs())).max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        ms = cuda_time_ms(lambda: flash_pair_fwd(qkv, h, causal))
        plain_ms = cuda_time_ms(
            lambda: flash_pair_fwd_reference(qkv, h, causal), iters=5)
        q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].view(b, L, h, d)
                   .transpose(1, 2) for i in range(3))
        library_ms = cuda_time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal))
        bound_ms, bound_by = flash_bound_ms(b, L, h, d, dtype, causal)
        log(f"[compare] flash_pair_fwd B={b} L={L} H={h} D={d} "
            f"{str(dtype)[6:]} causal={causal}: max|out err| {err:.3g}, "
            f"{of_limit:.3f} of the limit (atol {atol}, rtol {rtol}); "
            f"max|lse err| {lse_err:.3g}; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by})")
        if record is None:
            record = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=library_ms)
    return record


# The repeated timing of [parent-fwd] and [parent-bwd]: ROUNDS rounds, each
# timing the change and the parent (in turns: change first in even rounds,
# parent first in odd ones) with the same iteration count. A case fails
# only when the change's best time exceeds the parent's best by more than
# the timing noise: the largest relative spread (max - min) / min among
# the two kernels' own repeated timings of that case and NOISE_ROUNDS
# repeated timings of one kernel (``_timing_noise``). A case whose
# parent takes under HOST_BOUND_MS is reported and not judged: a wrapper
# call's host time (Python, ctypes, the allocations; ~30 us) then paces
# the launches, so the timing is the host's (GPT's [2, 1024] pair forward
# at ~0.03 ms read 0.80x in one run and 1.00x in the others).
ROUNDS = 5
NOISE_ROUNDS = 10
HOST_BOUND_MS = 0.1


def _timing_noise():
    """The relative spread (max - min) / min of NOISE_ROUNDS timings of one
    kernel (the [B, L, H, D] forward at LLaMA-7B's training shape, 20 calls
    a round): the floor of the [parent-*] margins."""
    from paddle_tpu_torch.kernels.flash_attention import flash_attention_fwd
    gen = torch.Generator(device="cuda")
    gen.manual_seed(62)
    q, k, v, _ = _fa_inputs(4, 2048, 2048, 32, 32, 128, BF16, gen)
    times = [cuda_time_ms(lambda: flash_attention_fwd(q, k, v, True),
                          iters=20) for _ in range(NOISE_ROUNDS)]
    noise = (max(times) - min(times)) / min(times)
    log(f"[parent-noise] {NOISE_ROUNDS} timings of flash_attention_fwd at "
        f"[4, 2048, 32, 128]: {min(times):.4f}-{max(times):.4f} ms, relative "
        f"spread {noise:.3f} (the floor of the [parent-*] margins)")
    del q, k, v
    torch.cuda.empty_cache()
    return noise


def _timed_pair(ours, parent, iters):
    """Best time and relative spread of ``ours`` and ``parent`` over
    ROUNDS interleaved rounds of ``iters`` calls each (after as many warm-up
    calls, at most 3): ((best, spread), (best, spread))."""
    times = ([], [])
    for r in range(ROUNDS):
        order = (0, 1) if r % 2 == 0 else (1, 0)
        for i in order:
            times[i].append(cuda_time_ms((ours, parent)[i], iters=iters,
                                         warmup=min(3, iters)))
    return tuple((min(t), (max(t) - min(t)) / min(t)) for t in times)


def _judge_parent(tag, where, ours, parent, noise, speedup=None,
                  slack=0.0):
    """Log one [parent-*] case and fail it when the change is slower than
    the parent by more than the noise (``_timed_pair``; ``noise``, from
    ``_timing_noise``, its floor) plus ``slack``, the share of the parent's
    time a change may cost by design; a case under HOST_BOUND_MS is only
    logged. A case whose body this change redesigned must do better:
    ``speedup`` "noise", faster than the parent beyond the noise; a
    number, at least that many times the parent's speed."""
    (ms, sp), (pms, psp) = ours, parent
    margin = max(sp, psp, noise) + slack
    judged = pms >= HOST_BOUND_MS
    want = ("" if speedup is None else
            "; must be faster beyond the noise" if speedup == "noise" else
            f"; must be at least {speedup}x")
    log(f"{tag} {where}: kernel {ms:.4f} ms (spread {sp:.3f}), the "
        f"parent's {pms:.4f} ms (spread {psp:.3f}), {pms / ms:.2f}x; "
        + (f"margin {margin:.3f}{want}" if judged else
           f"not judged (under {HOST_BOUND_MS} ms: host-bound)"))
    if judged and ms > pms * (1.0 + margin):
        raise AssertionError(f"{tag} {where}: slower than the parent's "
                             f"beyond the timing noise")
    if judged and ((speedup == "noise" and ms * (1.0 + margin) >= pms)
                   or (speedup not in (None, "noise")
                       and pms / ms < speedup)):
        raise AssertionError(f"{tag} {where}: not the speed-up asked of a "
                             f"redesigned body{want}")


# [parent-fwd] shapes: (tag, launcher, B, L, H, Hkv, D, causal, rate,
# lengths, calls a round, dtype): the headline shapes (LLaMA-7B's training
# and scoring forwards, GPT-medium's training forward, BERT's packed
# training forward), those of the kernels line's forward records, the
# wide-head kernels' headline shapes (flat D = 512 with GQA 8/2 at rate 0,
# flat D = 320 with GQA 16/4 at rate 0.1, packed D = 384) and the fp32
# wide kernels' (flat D = 512, GQA 8/2, [2, 1024]), where the parent's
# kernels take several to tens of ms a call (3 calls a round), and the
# fp32 forward up to 256 (csrc/flash_f32_wide.cuh
# ``flash_fwd_f32_small_kernel``: flat [2, 1024, 8/2, D] causal at every
# built size, GPT's head on the pair launcher, BERT's check shape at rate
# 0.1 on both launchers, as [parent-bwd]'s fp32 cases)
PARENT_FWD_CASES = [
    ("llama-train", "flat", 4, 2048, 32, 32, 128, True, 0.0, False, 20, BF16),
    ("llama-scoring", "flat", 2, 2048, 32, 32, 128, True, 0.0, False, 20,
     BF16),
    ("gpt-train", "pair", 16, 1024, 8, 8, 128, True, 0.0, False, 20, BF16),
    ("gpt-scoring", "pair", 2, 1024, 8, 8, 128, True, 0.0, False, 20, BF16),
    ("bert-packed", "pair", 64, 512, 12, 12, 64, False, 0.1, False, 20, BF16),
    ("bert-padded", "flat", 64, 512, 12, 12, 64, False, 0.1, True, 20, BF16),
    ("row6", "pair", 2, 2048, 16, 16, 128, True, 0.1, False, 20, BF16),
    ("wide-512", "flat", 2, 2048, 8, 2, 512, True, 0.0, False, 3, BF16),
    ("wide-320", "flat", 2, 2048, 16, 4, 320, True, 0.1, False, 3, BF16),
    ("wide-pair-384", "pair", 2, 2048, 8, 8, 384, True, 0.0, False, 3, BF16),
    ("wide-f32-512", "flat", 2, 1024, 8, 2, 512, True, 0.0, False, 3, FP32),
    ("f32-128", "flat", 2, 1024, 8, 2, 128, True, 0.0, False, 10, FP32),
    ("f32-64", "flat", 2, 1024, 8, 2, 64, True, 0.0, False, 10, FP32),
    ("f32-80", "flat", 2, 1024, 8, 2, 80, True, 0.0, False, 10, FP32),
    ("f32-96", "flat", 2, 1024, 8, 2, 96, True, 0.0, False, 10, FP32),
    ("f32-256", "flat", 2, 1024, 8, 2, 256, True, 0.0, False, 10, FP32),
    ("f32-pair-128", "pair", 2, 1024, 8, 8, 128, True, 0.0, False, 10,
     FP32),
    ("f32-bert-pair", "pair", 2, 512, 12, 12, 64, False, 0.1, False, 10,
     FP32),
    ("f32-bert-flat", "flat", 2, 512, 12, 12, 64, False, 0.1, True, 10,
     FP32)]
# the speed-ups over the parent's bodies a redesigned forward must show
# (``_judge_parent``): none (every forward body is the parent's design;
# each case must be no slower than the parent's beyond the noise)
FWD_SPEEDUP = {}


def phase_parent_fwd(parent, noise):
    """Both forward wrappers against the parent commit's (its kernels
    package, ``_parent_kernels``) on the same inputs, in the same process
    on the same card, timed in turns (``_timed_pair``), beside
    scaled_dot_product_attention on the same inputs (the yardstick) and
    the bound. A case fails when slower than the parent's beyond the
    timing noise, or below its FWD_SPEEDUP (``_judge_parent``). Returns
    {tag: (ms, parent ms, sdpa ms, bound ms)}; the parent's is None
    without a parent tree."""
    from paddle_tpu_torch.kernels import flash_attention, flash_pair
    gen = torch.Generator(device="cuda")
    gen.manual_seed(60)
    out = {}
    for (tag, launcher, b, L, h, hkv, d, causal, rate, lens, iters,
         dtype) in PARENT_FWD_CASES:
        seed = 0x9A4E47 if rate else None
        if launcher == "flat":
            name = "flash_attention_fwd"
            q, k, v, _ = _fa_inputs(b, L, L, h, hkv, d, dtype, gen)
            kw, valid, pairs, kv_rows = {}, None, None, None
            if lens:
                n = _bert_pad_lengths(b, L, BERT_PAD_SEED)
                kw["kv_lens"] = torch.as_tensor(n, dtype=torch.int32,
                                                device="cuda")
                valid = flash_attention._visible(L, L, causal, "cuda",
                                                 kw["kv_lens"])
                pairs = int(valid.sum())
                kv_rows = sum(min(L, x) for x in n)

            def call(mod):
                return lambda: mod.flash_attention_fwd(
                    q, k, v, causal, None, rate, seed=seed, **kw)
            mods = (flash_attention, parent and parent.flash_attention)
            lib_ms = cuda_time_ms(lambda: _sdpa_library(q, k, v, causal,
                                                        valid, rate))
            bound = fa_bound_ms(b, L, L, h, hkv, d, dtype, causal, False,
                                pairs, kv_rows)[0]
        else:
            name = "flash_pair_fwd"
            qkv, _ = _bwd_inputs(b, L, h, d, dtype, gen)

            def call(mod):
                return lambda: mod.flash_pair_fwd(qkv, h, causal, rate, seed)
            mods = (flash_pair, parent and parent.flash_pair)
            lq, lk, lv = (qkv[..., i * h * d:(i + 1) * h * d]
                          .view(b, L, h, d).transpose(1, 2) for i in range(3))
            lib_ms = cuda_time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    lq, lk, lv, dropout_p=rate, is_causal=causal))
            bound = flash_bound_ms(b, L, h, d, dtype, causal)[0]
        where = (f"{tag}: {name} B={b} L={L} H={h} Hkv={hkv} D={d} "
                 f"{str(dtype)[6:]} causal={causal} rate {rate}"
                 f"{' lengths' if lens else ''}")
        if parent is None:
            ms = cuda_time_ms(call(mods[0]), iters=iters,
                              warmup=min(3, iters))
            pms = None
            log(f"[parent-fwd] {where}: kernel {ms:.4f} ms; the parent's not "
                f"measured (no parent tree at {PARENT_TREE}: set PARENT_TREE "
                f"to an unpacked git archive of the parent commit)")
        else:
            ours, theirs = _timed_pair(call(mods[0]), call(mods[1]), iters)
            ms, pms = ours[0], theirs[0]
            _judge_parent("[parent-fwd]", where, ours, theirs, noise,
                          FWD_SPEEDUP.get(tag))
        log(f"[parent-fwd] {tag}: sdpa {lib_ms:.4f} ms ({ms / lib_ms:.2f}x "
            f"the kernel's time), bound {bound:.4f} ms ({ms / bound:.1f}x)")
        out[tag] = (ms, pms, lib_ms, bound)
        torch.cuda.empty_cache()
    return out


# [parent-bwd] shapes: (tag, launcher, B, L, H, Hkv, D, causal, rate,
# lengths, calls a round, dtype): LLaMA-7B's training backward, GQA 32/8
# with lengths (those of [compare-fa-masks]), GPT-medium's training
# backward, BERT's packed and padded training backwards at rate 0.1, row 3
# (L = 4608, where the JAX package runs its split kernels), row 6's call at
# rate 0.1, the wide-head shapes of [parent-fwd] (3 calls a round), the
# D = 256 backward (the wide body), and the bodies of
# csrc/flash_f32_wide.cuh ``flash_bwd_f32_kernel`` (fp32 heads up to 256:
# flat [2, 1024, 8/2, D] causal at every built size, GPT's head on the pair
# launcher, BERT's check shape at rate 0.1 on both launchers) and of
# csrc/flash_bwd_sm90.cuh at 80 and 96 (bf16 on 32-byte swizzle blocks: [2,
# 1024, 8/2, D] and Phi-2's / Phi-3-mini's attention at LLaMA's training
# geometry)
PARENT_BWD_CASES = [
    ("llama-train", "flat", 4, 2048, 32, 32, 128, True, 0.0, None, 10, BF16),
    ("gqa-lengths", "flat", 2, 2048, 32, 8, 128, True, 0.0, [2048, 1111],
     10, BF16),
    ("gpt-train", "pair", 16, 1024, 8, 8, 128, True, 0.0, None, 10, BF16),
    ("bert-packed", "pair", 64, 512, 12, 12, 64, False, 0.1, None, 10, BF16),
    ("bert-padded", "flat", 64, 512, 12, 12, 64, False, 0.1, "bert", 10,
     BF16),
    ("row3", "pair", 1, 4608, 8, 8, 128, True, 0.0, None, 10, BF16),
    ("row6", "pair", 2, 2048, 16, 16, 128, True, 0.1, None, 10, BF16),
    ("wide-512", "flat", 2, 2048, 8, 2, 512, True, 0.0, None, 3, BF16),
    ("wide-320", "flat", 2, 2048, 16, 4, 320, True, 0.1, None, 3, BF16),
    ("wide-pair-384", "pair", 2, 2048, 8, 8, 384, True, 0.0, None, 3, BF16),
    ("d256-bwd", "flat", 2, 2048, 8, 2, 256, True, 0.0, None, 10, BF16),
    ("wide-f32-512", "flat", 2, 1024, 8, 2, 512, True, 0.0, None, 3, FP32),
    ("f32-128", "flat", 2, 1024, 8, 2, 128, True, 0.0, None, 3, FP32),
    ("f32-64", "flat", 2, 1024, 8, 2, 64, True, 0.0, None, 3, FP32),
    ("f32-80", "flat", 2, 1024, 8, 2, 80, True, 0.0, None, 3, FP32),
    ("f32-96", "flat", 2, 1024, 8, 2, 96, True, 0.0, None, 3, FP32),
    ("f32-256", "flat", 2, 1024, 8, 2, 256, True, 0.0, None, 3, FP32),
    ("f32-pair-128", "pair", 2, 1024, 8, 8, 128, True, 0.0, None, 3, FP32),
    ("f32-bert-pair", "pair", 2, 512, 12, 12, 64, False, 0.1, None, 3, FP32),
    ("f32-bert-flat", "flat", 2, 512, 12, 12, 64, False, 0.1, "bert", 3,
     FP32),
    ("wmma-80", "flat", 2, 1024, 8, 2, 80, True, 0.0, None, 10, BF16),
    ("wmma-96", "flat", 2, 1024, 8, 2, 96, True, 0.0, None, 10, BF16),
    ("phi2-80", "flat", 4, 2048, 32, 32, 80, True, 0.0, None, 5, BF16),
    ("phi3-96", "flat", 4, 2048, 32, 32, 96, True, 0.0, None, 5, BF16)]
# the speed-ups over the parent's bodies a redesigned backward must show,
# as FWD_SPEEDUP: none (every backward body is the parent's design)
BWD_SPEEDUP = {}
# What F8's repair may cost a backward beyond the noise, as a share of the
# parent's time: each body now stores dq's partials a kv tile apart and
# dq_sum.cu adds them in kv-tile order behind it, where the parent's
# bodies added them by atomics (reads of every slab a row has: ~0.3 ms at
# LLaMA-7B's training shape against its 1.71 ms backward). None is
# expected above a third; a case slower than that fails.
BWD_ORDER_SLACK = 1.0 / 3.0


def phase_parent_bwd(parent, noise):
    """Both backward wrappers against the parent commit's, as
    [parent-fwd] does, with torch.autograd.grad through
    scaled_dot_product_attention on the same inputs beside them (the
    yardstick) and the bound. No case may be slower than the parent's
    beyond the noise and BWD_ORDER_SLACK (``_judge_parent``). Returns {tag: (ms, parent ms,
    sdpa ms, bound ms)}; the parent's is None without a parent tree."""
    from paddle_tpu_torch.kernels import flash_attention, flash_pair
    gen = torch.Generator(device="cuda")
    gen.manual_seed(61)
    out = {}
    for (tag, launcher, b, L, h, hkv, d, causal, rate, lens, iters,
         dtype) in PARENT_BWD_CASES:
        seed = 0xB4C4 if rate else None
        valid = None
        if launcher == "flat":
            q, k, v, g = _fa_inputs(b, L, L, h, hkv, d, dtype, gen)
            kw = {}
            if lens is not None:
                lens = _bert_pad_lengths(b, L, BERT_PAD_SEED) \
                    if lens == "bert" else lens
                kw["kv_lens"] = torch.as_tensor(lens, dtype=torch.int32,
                                                device="cuda")
                valid = flash_attention._visible(L, L, causal, "cuda",
                                                 kw["kv_lens"])
            o, lse = flash_attention.flash_attention_fwd(
                q, k, v, causal, None, rate, seed=seed, **kw)

            def call(mod):
                return lambda: mod.flash_attention_bwd(
                    q, k, v, o, lse, g, causal, None, rate, seed=seed, **kw)
            mods = (flash_attention, parent and parent.flash_attention)
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            lib_out = _sdpa_library(*leaves, causal, valid, rate)
            grad_out = g.transpose(1, 2)
            pairs = None if valid is None else int(valid.sum())
            kv_rows = None if lens is None else sum(min(L, n) for n in lens)
            bound = fa_bound_ms(b, L, L, h, hkv, d, dtype, causal, True,
                                pairs, kv_rows)[0]
        else:
            qkv, g = _bwd_inputs(b, L, h, d, dtype, gen)
            o, lse = flash_pair.flash_pair_fwd(qkv, h, causal, rate, seed)

            def call(mod):
                return lambda: mod.flash_pair_bwd(qkv, o, lse, g, h, causal,
                                                  rate, seed)
            mods = (flash_pair, parent and parent.flash_pair)
            leaf = qkv.detach().requires_grad_()
            leaves = [leaf]
            lq, lk, lv = (leaf[..., i * h * d:(i + 1) * h * d]
                          .view(b, L, h, d).transpose(1, 2) for i in range(3))
            lib_out = torch.nn.functional.scaled_dot_product_attention(
                lq, lk, lv, dropout_p=rate, is_causal=causal)
            grad_out = g.view(b, L, h, d).transpose(1, 2)
            bound = flash_bwd_bound_ms(b, L, h, d, dtype, causal)[0]
        lib_ms = cuda_time_ms(lambda: torch.autograd.grad(
            lib_out, leaves, grad_out, retain_graph=True), iters=iters,
            warmup=min(3, iters))
        where = (f"{tag}: {mods[0].__name__.split('.')[-1]} B={b} L={L} "
                 f"H={h} Hkv={hkv} D={d} {str(dtype)[6:]} causal={causal} "
                 f"rate {rate}{' lengths' if lens is not None else ''}")
        if parent is None:
            ms = cuda_time_ms(call(mods[0]), iters=iters,
                              warmup=min(3, iters))
            pms = None
            log(f"[parent-bwd] {where}: kernel {ms:.4f} ms; the parent's not "
                f"measured (no parent tree at {PARENT_TREE})")
        else:
            ours, theirs = _timed_pair(call(mods[0]), call(mods[1]), iters)
            ms, pms = ours[0], theirs[0]
            _judge_parent("[parent-bwd]", where, ours, theirs, noise,
                          BWD_SPEEDUP.get(tag), BWD_ORDER_SLACK)
        log(f"[parent-bwd] {tag}: sdpa backward {lib_ms:.4f} ms "
            f"({ms / lib_ms:.2f}x the kernel's time), bound {bound:.4f} ms "
            f"({ms / bound:.1f}x)")
        out[tag] = (ms, pms, lib_ms, bound)
        del leaves, lib_out, o, lse, g
        torch.cuda.empty_cache()
    return out


def _bwd_inputs(b, L, h, d, dtype, gen):
    """qkv with q, k ~ N(0, 2^2) and v ~ N(0, 1), and dO ~ N(0, 1)."""
    qkv = torch.randn(b, L, 3, h * d, device="cuda", generator=gen)
    qkv[:, :, :2] *= 2.0
    qkv = qkv.reshape(b, L, 3 * h * d).to(dtype)
    dout = torch.randn(b, L, h * d, device="cuda", generator=gen).to(dtype)
    return qkv, dout


def _compare_bwd_case(b, L, h, d, dtype, causal, gen):
    """flash_pair_bwd against flash_pair_bwd_reference on the same (qkv,
    out, lse, dO) at one shape. Per part (dq, dk, dv): the relative
    Frobenius error and the largest absolute error. Raises past
    BWD_REL_LIMIT (fp32 above D = 256: BIG_D_FP32_REL_LIMIT against the
    exact gradient) or when d(qkv) differs between two launches (dq sums
    in a fixed order: every part is the same bit for bit).
    Returns the inputs and the largest absolute error."""
    from paddle_tpu_torch.kernels.flash_pair import (
        flash_pair_bwd, flash_pair_bwd_reference, flash_pair_fwd,
        flash_pair_fwd_reference)
    qkv, dout = _bwd_inputs(b, L, h, d, dtype, gen)
    out, lse = flash_pair_fwd(qkv, h, causal)
    got = flash_pair_bwd(qkv, out, lse, dout, h, causal)
    again = flash_pair_bwd(qkv, out, lse, dout, h, causal)
    torch.cuda.synchronize()
    limit = BWD_REL_LIMIT[dtype]
    if _exact(dtype, d):
        q64, g64 = qkv.double(), dout.double()
        o64, l64 = flash_pair_fwd_reference(q64, h, causal)
        want = flash_pair_bwd_reference(q64, o64, l64, g64, h, causal)
        limit = BIG_D_FP32_REL_LIMIT
    else:
        want = flash_pair_bwd_reference(qkv, out, lse, dout, h, causal)
    hd = h * d
    parts, worst_abs = [], 0.0
    for i, part in enumerate(("dq", "dk", "dv")):
        g = got[..., i * hd:(i + 1) * hd]
        w = want[..., i * hd:(i + 1) * hd]
        rel = rel_err(g, w)
        mx = (g.float() - w.float()).abs().max().item()
        worst_abs = max(worst_abs, mx)
        parts.append(f"{part} rel {rel:.3g} max|err| {mx:.3g}")
        if not rel < limit:
            raise AssertionError(
                f"flash_pair_bwd {part} at B={b} L={L} H={h} D={d} "
                f"{dtype} causal={causal}: relative error {rel:.3g} >= "
                f"{limit}")
    if not torch.equal(got, again):
        raise AssertionError("flash_pair_bwd: d(qkv) differs between two "
                             "launches on the same inputs")
    log(f"[compare-bwd] flash_pair_bwd B={b} L={L} H={h} D={d} "
        f"{str(dtype)[6:]} causal={causal}: {'; '.join(parts)} (limit "
        f"rel {limit}{EXACT_NOTE if _exact(dtype, d) else ''}); two "
        f"launches bit for bit")
    return qkv, out, lse, dout, worst_abs


def phase_compare_bwd():
    """Backward kernel vs plain version (``_compare_bwd_case``) at the
    slice's shape, a ragged fp32 D=64 case, a bidirectional case, L = 4608
    (above the TPU's fused-backward cutoff, 4096, where the JAX package
    switches to its split dq/dkv kernels) and the training shape [16, 1024,
    3*8*128]. At L = 4608 and at the training shape it then times the
    kernel beside the plain version, torch.autograd.grad through
    scaled_dot_product_attention (library_ms only) and the bound; the
    training shape's numbers make the record, so every field of it
    describes the shape the training path gives the kernel.

    Limits (BWD_REL_LIMIT): the kernel and the plain version round at the
    same points, so what remains is fp32 summation order, which moves p and
    ds across a bf16 rounding boundary now and then; the limits are about
    3x the first readings on the card. Returns the training shape's
    record."""
    from paddle_tpu_torch.kernels.flash_pair import (
        flash_pair_bwd, flash_pair_bwd_reference)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    for case in [(2, 1024, 8, 128, torch.bfloat16, True),  # the slice's shape
                 (2, 300, 4, 64, torch.float32, True),     # ragged L, D=64
                 (2, 1024, 8, 128, torch.bfloat16, False),  # bidirectional
                 (4, 300, 4, 64, torch.bfloat16, True),    # ragged, D=64
                 (2, 512, 2, 384, torch.bfloat16, True),   # heads of 384
                 (2, 300, 2, 384, torch.float32, False)]:
        _compare_bwd_case(*case, gen)
        torch.cuda.empty_cache()

    def timed(b, L, h, d, where):
        """Compare at [b, L, 3*h*d] bf16 causal, then time the kernel, the
        plain version, autograd through the library call and the bound."""
        qkv, out, lse, dout, err = _compare_bwd_case(b, L, h, d,
                                                     torch.bfloat16, True,
                                                     gen)
        ms = cuda_time_ms(
            lambda: flash_pair_bwd(qkv, out, lse, dout, h, True), iters=10)
        plain_ms = cuda_time_ms(
            lambda: flash_pair_bwd_reference(qkv, out, lse, dout, h, True),
            iters=3, warmup=1)
        leaf = qkv.detach().requires_grad_()
        q, k, v = (leaf[..., i * h * d:(i + 1) * h * d].view(b, L, h, d)
                   .transpose(1, 2) for i in range(3))
        o = torch.nn.functional.scaled_dot_product_attention(q, k, v,
                                                             is_causal=True)
        do = dout.view(b, L, h, d).transpose(1, 2)
        library_ms = cuda_time_ms(
            lambda: torch.autograd.grad(o, leaf, do, retain_graph=True))
        bound_ms, bound_by = flash_bwd_bound_ms(b, L, h, d, torch.bfloat16,
                                                True)
        log(f"[compare-bwd] flash_pair_bwd at {where} B={b} L={L} H={h} "
            f"D={d} bf16 causal: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, sdpa backward {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by})")
        del qkv, dout, out, lse, leaf, q, k, v, o, do
        torch.cuda.empty_cache()
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=library_ms)

    # above the TPU's fused cutoff, where the JAX package runs its split
    # kernels (the table's row 3)
    timed(1, 4608, 8, 128, "L above 4096")
    return timed(TRAIN["batch"], TRAIN["seq"], 8, 128, "the training shape")


def phase_autograd():
    """FlashPairPacked on the card at the slice's shape: qkv.grad after
    .backward(dO) is flash_pair_bwd's output bit for bit, and the forward
    and backward counters each go up by one."""
    from paddle_tpu_torch.kernels import (FlashPairPacked, flash_pair_bwd,
                                          flash_pair_fwd, launch_counts)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    b, L, h, d = 2, 1024, 8, 128
    qkv, dout = _bwd_inputs(b, L, h, d, torch.bfloat16, gen)
    leaf = qkv.clone().requires_grad_()
    before = launch_counts()
    out = FlashPairPacked.apply(leaf, h, True)
    out.backward(dout)
    torch.cuda.synchronize()
    after = launch_counts()
    ref_out, lse = flash_pair_fwd(qkv, h, True)
    want = flash_pair_bwd(qkv, ref_out, lse, dout, h, True)
    if out.grad_fn is None or leaf.grad is None:
        raise AssertionError("no gradient reached qkv through "
                             "FlashPairPacked")
    if not torch.equal(out, ref_out) or not torch.equal(leaf.grad, want):
        raise AssertionError("FlashPairPacked out or d(qkv) differ from the "
                             "kernels called directly")
    grew = _grew(before, after)
    _expect_launches("launches under autograd", grew, flash_pair_fwd=1,
                     flash_pair_bwd=1)
    log(f"[autograd] FlashPairPacked [2, 1024, 3*8*128] bf16: qkv.grad == "
        f"flash_pair_bwd output bit for bit; launches {grew}")


def phase_scoring(model):
    """The uncached scoring forward at [2, 1024]: finite logits of the
    right shape, and one flash launch per block."""
    from paddle_tpu_torch.kernels import launch_counts
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    ids = torch.randint(0, GPT_MEDIUM["vocab_size"], (2, 1024),
                        device="cuda", generator=gen)
    before = launch_counts()["flash_pair_fwd"]
    with torch.no_grad():
        logits = model(ids)
    torch.cuda.synchronize()
    per_forward = launch_counts()["flash_pair_fwd"] - before
    if logits.shape != (2, 1024, GPT_MEDIUM["vocab_size"]):
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite scoring logits")
    if per_forward != GPT_MEDIUM["num_layers"]:
        raise AssertionError(f"{per_forward} flash launches per forward, "
                             f"expected {GPT_MEDIUM['num_layers']}")
    log(f"[scoring] logits {tuple(logits.shape)} finite; {per_forward} "
        f"flash launches per forward")
    return ids


def phase_scoring_time(model, ids):
    """Device time of one scoring forward at [2, 1024] (outside the main
    path's launch count)."""
    with torch.no_grad():
        fwd_ms = cuda_time_ms(lambda: model(ids), iters=5, warmup=1)
    log(f"[scoring] forward [2, 1024]: {fwd_ms:.2f} ms")


def _gpt_requests():
    """[engine]'s 8 requests: a shared 32-token prefix + random tokens,
    64-128 prompt tokens, 32-64 new."""
    gen = torch.Generator()
    gen.manual_seed(2)
    vocab = GPT_MEDIUM["vocab_size"]
    prefix = torch.randint(0, vocab, (32,), generator=gen).tolist()
    prompt_lens = [128, 120, 64, 72, 80, 96, 104, 112]
    new_tokens = [64, 56, 32, 40, 48, 64, 36, 60]
    prompts = [prefix + torch.randint(0, vocab, (n - 32,),
                                      generator=gen).tolist()
               for n in prompt_lens]
    return prompts, new_tokens


def _serve(eng, prompts, new_tokens):
    """The first request alone until it runs (it publishes the shared
    prefix), then the rest; the pager's invariants after every step.
    Returns (requests, steps, wall s, peak allocated GB, peak reserved
    GB), the peaks from the engine's start (weights, pools and, graphed,
    the graphs' pool included)."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reqs = [eng.submit(prompts[0], max_new_tokens=new_tokens[0])]
    steps = 0
    while reqs[0].status in ("queued", "prefilling"):
        eng.step()
        eng.check_invariants()
        steps += 1
    reqs += [eng.submit(p, max_new_tokens=n)
             for p, n in zip(prompts[1:], new_tokens[1:])]
    while eng.queue_depth or eng.active_count:
        eng.step()
        eng.check_invariants()
        steps += 1
        if steps > 2000:
            raise AssertionError("engine did not drain in 2000 steps")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bad = [r for r in reqs if r.status != "done"
           or len(r.tokens) != r.max_new_tokens]
    if bad:
        raise AssertionError(f"requests not done: {bad}")
    return (reqs, steps, wall, torch.cuda.max_memory_allocated() / 1e9,
            torch.cuda.max_memory_reserved() / 1e9)


def phase_engine(model):
    """[engine]'s 8 requests through the paged engine, its steps run
    eagerly (the private switch ``_programs.capture = False``): the
    reference the captured programs are held to."""
    from paddle_tpu_torch.serving import DecodeEngine
    prompts, new_tokens = _gpt_requests()
    torch.cuda.empty_cache()
    eng = DecodeEngine(model, **ENGINE)
    eng._programs.capture = False
    reqs, steps, wall, peak, reserved = _serve(eng, prompts, new_tokens)
    st = eng.stats()
    if st["paged"]["shared_hits"] < 1:
        raise AssertionError(f"prefix sharing was not hit: {st['paged']}")
    rate = st["tokens_generated"] / wall
    log(f"[engine] eager steps: {len(reqs)} requests done in {steps} "
        f"steps, {wall:.3f} s: {st['tokens_generated']} tokens, "
        f"{rate:.1f} tokens/s; "
        f"{st['decode_steps']} decode steps, {st['prefill_calls']} chunk "
        f"calls; shared_hits {st['paged']['shared_hits']}, shared_tokens "
        f"{st['paged']['shared_tokens']}, cow {st['paged']['cow_copies']}; "
        f"peak memory {peak:.2f} GB (reserved {reserved:.2f} GB)")
    return reqs, dict(rate=rate, peak=peak, reserved=reserved)


def phase_engine_graph(model, eager_reqs, eager, requests=_gpt_requests,
                       tag="[engine-graph]"):
    """The same requests through an engine whose steps are captured CUDA
    graphs (the default on the card), after a warm-up request that
    builds both programs: compile_count 2 after it, no capture during the
    drain, and every request's tokens identical to the eager engine's."""
    from paddle_tpu_torch.serving import DecodeEngine
    prompts, new_tokens = requests()
    torch.cuda.empty_cache()
    eng = DecodeEngine(model, **ENGINE)
    gen = torch.Generator()
    gen.manual_seed(99)
    warm = torch.randint(0, model.config.vocab_size, (40,),
                         generator=gen).tolist()
    t0 = time.perf_counter()
    eng.submit(warm, max_new_tokens=2)       # two chunk calls, one decode
    eng.run()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    progs = eng._programs._programs
    if eng.compile_count != 2 or not all(p.captured for p in progs.values()):
        raise AssertionError(f"warm-up built {eng.compile_count} programs "
                             f"({list(progs)}), expected 2 captured")
    reqs, steps, wall, peak, reserved = _serve(eng, prompts, new_tokens)
    if eng.compile_count != 2:
        raise AssertionError(f"{eng.compile_count - 2} captures during the "
                             f"drain")
    diff = [r.id for r, e in zip(reqs, eager_reqs) if r.tokens != e.tokens]
    if diff:
        raise AssertionError(f"graphed tokens differ from the eager "
                             f"engine's in requests {diff}")
    st = eng.stats()
    rate = (st["tokens_generated"] - 2) / wall
    log(f"{tag} {len(reqs)} requests done in {steps} steps, {wall:.3f} s: "
        f"{rate:.1f} tokens/s ({rate / eager['rate']:.2f}x the eager "
        f"engine's {eager['rate']:.1f}); tokens identical to the eager "
        f"engine's; compile_count 2 after the warm-up ({warm_s:.2f} s, "
        f"capture included), 0 captures in the drain; peak memory "
        f"{peak:.2f} GB (eager {eager['peak']:.2f}), reserved "
        f"{reserved:.2f} GB (eager {eager['reserved']:.2f})")
    return reqs, dict(rate=rate, peak=peak, reserved=reserved)


def phase_engine_buckets(model):
    """prefill_chunk=None: each prompt prefills in one call of the bucket
    that holds it whole (graphed), [engine]'s requests, then held to the
    uncached forward by [crosscheck]'s rule at every request."""
    from paddle_tpu_torch.serving import DecodeEngine
    prompts, new_tokens = _gpt_requests()
    eng = DecodeEngine(model, **dict(ENGINE, prefill_chunk=None))
    reqs, steps, wall, peak, _ = _serve(eng, prompts, new_tokens)
    if any(r.prefill_chunks != 1 for r in reqs):
        raise AssertionError("a bucketed prompt took more than one call")
    st = eng.stats()
    log(f"[engine-buckets] buckets {eng.prefill_buckets}: {len(reqs)} "
        f"requests in {steps} steps, {wall:.3f} s (captures included), "
        f"{st['prefill_calls']} chunk calls; compile_count "
        f"{eng.compile_count} (programs "
        f"{sorted(map(str, eng._programs._programs))})")
    return reqs


def phase_engine_sample(model, greedy_reqs):
    """Sampling at T = 0.8, top_k = 50 (graphed) on [engine]'s requests:
    seed 1 twice gives identical tokens, seed 2 others, and top_k = 1 the
    greedy tokens of [engine]."""
    from paddle_tpu_torch.serving import DecodeEngine
    prompts, new_tokens = _gpt_requests()
    runs = {}
    for name, seed, top_k in (("1", 1, 50), ("1 again", 1, 50),
                              ("2", 2, 50), ("top_k 1", 3, 1)):
        eng = DecodeEngine(model, do_sample=True, temperature=0.8,
                           top_k=top_k, seed=seed, **ENGINE)
        reqs = _serve(eng, prompts, new_tokens)[0]
        runs[name] = [r.tokens for r in reqs]
        if eng.compile_count != 2:
            raise AssertionError(f"sampling engine built "
                                 f"{eng.compile_count} programs")
        del eng
    greedy = [r.tokens for r in greedy_reqs]
    same = sum(a == b for a, b in zip(runs["1"], runs["2"]))
    if runs["1"] != runs["1 again"]:
        raise AssertionError("the same seed did not reproduce")
    if same == len(greedy):
        raise AssertionError("seeds 1 and 2 drew the same tokens")
    if runs["top_k 1"] != greedy:
        raise AssertionError("top_k = 1 differs from greedy")
    agree = sum(x == y for a, g in zip(runs["1"], greedy)
                for x, y in zip(a, g)) / sum(map(len, greedy))
    log(f"[engine-sample] T 0.8, top_k 50: seed 1 twice identical, seed 2 "
        f"differs in {len(greedy) - same} of {len(greedy)} requests; "
        f"top_k 1 == greedy; sampled tokens equal to greedy at "
        f"{agree:.3f} of positions")


def _as_rows(ids, out):
    """generate()'s rows as crosscheck records (prompt, tokens, id)."""
    from types import SimpleNamespace
    s0 = ids.shape[1]
    return [SimpleNamespace(id=i, prompt=row[:s0], tokens=row[s0:])
            for i, row in enumerate(out.tolist())]


def _generate_both(model, ids, new, tag):
    """generate() eagerly (the private ``capture = False`` of the model's
    program registry), then graphed twice (the first call captures the
    step): greedy tokens identical each time. Returns the output and the
    timing record."""
    from paddle_tpu_torch.models.gpt import _gen_registry
    model.__dict__.pop("_gen_programs", None)
    _gen_registry(model).capture = False
    t0 = time.perf_counter()
    eager = model.generate(ids, max_new_tokens=new)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    model.__dict__.pop("_gen_programs")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = model.generate(ids, max_new_tokens=new)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = model.generate(ids, max_new_tokens=new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    reg = _gen_registry(model)
    if reg.count != 1 or not all(p.captured
                                 for p in reg._programs.values()):
        raise AssertionError(f"{tag} built {reg.count} step programs")
    if not (torch.equal(first, eager) and torch.equal(out, eager)):
        raise AssertionError(f"{tag} graphed tokens differ from eager")
    b = ids.shape[0]
    if out.shape != (b, ids.shape[1] + new) \
            or not torch.equal(out[:, :ids.shape[1]], ids):
        raise AssertionError(f"{tag} output shape {tuple(out.shape)}")
    log(f"{tag} {b} x {ids.shape[1]} prompts, {new} new tokens: "
        f"{b * new / wall:.1f} tokens/s graphed ({wall:.3f} s; first call "
        f"with the capture {first_s:.3f} s) against {b * new / eager_s:.1f} "
        f"eager ({eager_s:.3f} s); tokens identical; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return out


def phase_generate(model):
    """GPT-medium generate(): 8 x 128 prompts, 64 new tokens."""
    gen = torch.Generator()
    gen.manual_seed(4)
    ids = torch.randint(0, GPT_MEDIUM["vocab_size"], (8, 128),
                        generator=gen).cuda()
    return _as_rows(ids, _generate_both(model, ids, 64, "[generate]"))


def phase_llama_generate(model):
    """LLaMA-7B generate(): 2 x 128 prompts, 32 new tokens."""
    gen = torch.Generator()
    gen.manual_seed(14)
    ids = torch.randint(0, LLAMA_7B["vocab_size"], (2, 128),
                        generator=gen).cuda()
    return _as_rows(ids, _generate_both(model, ids, 32, "[llama-generate]"))


def phase_crosscheck(model, reqs, rows=2, tag="[crosscheck]"):
    """Greedy tokens (the engine's or generate()'s) against the uncached
    forward (through the flash kernel) over prompt + output, for the
    ``rows`` longest requests: the argmax agrees at >= 95% of generated
    positions and every disagreement is a near-tie (bf16 rounds
    differently in the cached path and the kernel)."""
    from paddle_tpu_torch.models.gpt import _lm_head_logits
    longest = sorted(reqs, key=lambda r: -(len(r.prompt) + len(r.tokens)))
    for req in longest[:rows]:
        seq = req.prompt + req.tokens[:-1]
        # right-padded to the kernel's 128-token minimum: causal attention,
        # so the padding changes no earlier position
        seq = seq + [0] * (128 - len(seq))
        ids = torch.tensor([seq], device="cuda")
        with torch.no_grad():
            n = len(req.prompt)
            hidden = model.gpt(ids)[0, n - 1:n - 1 + len(req.tokens)]
            logits = _lm_head_logits(hidden, model.head_weight)
        want = torch.tensor(req.tokens, device="cuda")
        top = logits.argmax(dim=-1)
        agree = (top == want).float().mean().item()
        gaps = (logits.gather(1, top[:, None])
                - logits.gather(1, want[:, None]))[:, 0]
        worst = gaps.max().item()
        log(f"{tag} request {req.id}: {len(req.tokens)} generated "
            f"positions, argmax agreement {agree:.3f}, largest logit gap at "
            f"a disagreement {worst:.4f}")
        if agree < 0.95 or worst > 0.1:
            raise AssertionError("engine tokens disagree with the uncached "
                                 "forward beyond bf16 near-ties")


def phase_profile(model, graphed=False, tag=None):
    """Where a serving run's time goes: 16 requests (64-token prompts, 32
    new tokens) through a fresh engine under torch.profiler, its steps
    eager ([profile]) or captured ([profile-graph], [profile-llama-graph]:
    both programs built by a warm-up request before the profiler starts).
    Reports the host wall time per scheduler step, the device's busy share
    (kernel time over wall time) and the kernels that take the most device
    time. The profiler adds host overhead, so the wall times here are not
    the engine's speed; the [engine] lines are."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.serving import DecodeEngine
    tag = tag or ("[profile-graph]" if graphed else "[profile]")
    vocab = model.config.vocab_size
    gen = torch.Generator()
    gen.manual_seed(3)
    eng = DecodeEngine(model, **ENGINE)
    eng._programs.capture = graphed
    if graphed:
        eng.submit(torch.randint(0, vocab, (40,), generator=gen).tolist(),
                   max_new_tokens=2)
        eng.run()
    prompts = torch.randint(0, vocab, (16, 64), generator=gen).tolist()
    reqs = [eng.submit(p, max_new_tokens=32) for p in prompts]
    st0 = eng.stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(max_steps=500)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if any(r.status != "done" for r in reqs):
        raise AssertionError("profiled requests did not finish")
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    st = eng.stats()
    decode = st["decode_steps"] - st0["decode_steps"]
    chunks = st["prefill_calls"] - st0["prefill_calls"]
    log(f"{tag} 16 requests x 32 tokens: {decode} decode steps + {chunks} "
        f"chunk calls in {wall * 1e3:.1f} ms wall "
        f"({wall * 1e3 / max(decode + chunks, 1):.2f} ms per call, profiler "
        f"on); device busy {busy_us / 1e3:.1f} ms = "
        f"{busy_us / 1e6 / wall:.3f} of wall"
        + ("" if kernels else " (no device event in the trace: not "
           "measured)"))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"{tag}   {e.self_device_time_total / 1e3:8.2f} ms "
            f"x{e.count:5d}  {e.key[:90]}")


def _train_recipe(seed=0):
    """The training recipe of [train] and [train-plain]: GPT-medium (bf16,
    weights from ``seed``), AdamW(1e-4, wd 0.01, multi_precision=True),
    TrainStep, and a fixed random batch of TRAIN["batch"] x TRAIN["seq"]
    tokens (seed 4). Returns (model, optimizer, step, ids)."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    model = GPTForCausalLM(GPTConfig(**GPT_MEDIUM), dtype=torch.bfloat16,
                           seed=seed)
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.parameters(), multi_precision=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    ids = torch.randint(0, GPT_MEDIUM["vocab_size"],
                        (TRAIN["batch"], TRAIN["seq"]), device="cuda",
                        generator=gen)
    return model, opt, TrainStep(model, opt, fast_path=False), ids


TRAIN_WALLS = []          # [train]'s timed steps (s), set by phase_train
BERT_TRAIN_WALLS = []     # [bert-train]'s timed steps (s), [bert-lamb]'s


def phase_train():
    """The training path: the recipe of ``_train_recipe``, 1 warm-up step
    and TRAIN["steps"] timed steps (each synchronised). Every loss is
    finite and the last is below the first (the batch repeats); each step
    launches both flash kernels once per block; masters are fp32 and every
    parameter equals its master cast to bf16. Returns the model, its
    optimizer, the batch and the losses."""
    from paddle_tpu_torch.kernels import launch_counts
    t0 = time.perf_counter()
    model, opt, step, ids = _train_recipe()
    b, L = ids.shape
    log(f"[train] GPT-medium bf16 + AdamW(multi_precision) built in "
        f"{time.perf_counter() - t0:.1f} s; batch {b} x {L}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    blocks = GPT_MEDIUM["num_layers"]
    losses, walls = [], []
    for i in range(1 + TRAIN["steps"]):
        before = launch_counts()
        t0 = time.perf_counter()
        loss = step(ids, ids)
        losses.append(loss.item())              # synchronises
        walls.append(time.perf_counter() - t0)
        grew = _grew(before, launch_counts())
        _expect_launches(f"[train] step {i}", grew, flash_pair_fwd=blocks,
                         flash_pair_bwd=blocks)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall on a repeated batch: "
                             f"{losses}")
    for p in model.parameters():
        master = opt._master_weights[id(p)]
        if master.dtype != torch.float32 or not torch.equal(
                p, master.to(torch.bfloat16)):
            raise AssertionError("a parameter is not its fp32 master cast "
                                 "to bf16")
    timed = walls[1:]
    TRAIN_WALLS[:] = timed                 # [monitor-train] reads the spread
    wall = sum(timed) / len(timed)
    log(f"[train] losses {[round(x, 4) for x in losses]}")
    log(f"[train] {len(timed)} timed steps: wall per step {wall * 1e3:.1f} "
        f"ms (min {min(timed) * 1e3:.1f}, max {max(timed) * 1e3:.1f}; "
        f"warm-up {walls[0] * 1e3:.1f}), {b * L / wall:.0f} tokens/s; "
        f"{blocks} + {blocks} flash launches per step; peak memory "
        f"{peak_gb:.2f} GB")
    return model, opt, ids, losses


class _PlainPairPacked(torch.autograd.Function):
    """``FlashPairPacked`` with both kernels replaced by their plain
    versions (``flash_pair_fwd_reference``, ``flash_pair_bwd_reference``),
    for the kernel-free witness in ``phase_train_plain``."""

    @staticmethod
    def forward(ctx, qkv, num_heads, causal, dropout_rate=0.0, seed=None):
        from paddle_tpu_torch.kernels.flash_pair import (
            flash_pair_fwd_reference)
        out, lse = flash_pair_fwd_reference(qkv, num_heads, causal,
                                            dropout_rate, seed)
        ctx.save_for_backward(qkv, out, lse)
        ctx.num_heads, ctx.causal = num_heads, causal
        ctx.dropout_rate, ctx.seed = dropout_rate, seed
        return out

    @staticmethod
    def backward(ctx, dout):
        from paddle_tpu_torch.kernels.flash_pair import (
            flash_pair_bwd_reference)
        qkv, out, lse = ctx.saved_tensors
        return (flash_pair_bwd_reference(qkv, out, lse, dout.contiguous(),
                                         ctx.num_heads, ctx.causal,
                                         ctx.dropout_rate, ctx.seed),
                None, None, None, None)


def phase_train_plain(losses):
    """A witness for [train]'s loss curve: the same recipe, the same batch
    and as many steps with attention's forward and backward in their plain
    versions (``_PlainPairPacked`` in place of ``FlashPairPacked``; no
    kernel launches). Every step's loss agrees with [train]'s within
    TRAIN_PLAIN_LOSS_LIMIT, so the shape of the curve (where it falls and
    where it rises) comes from the recipe, not from the kernels."""
    from paddle_tpu_torch.kernels import launch_counts
    from paddle_tpu_torch.nn.functional import attention
    model, opt, step, ids = _train_recipe()
    kernel_path = attention.FlashPairPacked
    attention.FlashPairPacked = _PlainPairPacked
    try:
        before = launch_counts()
        plain = [step(ids, ids).item() for _ in losses]
        after = launch_counts()
    finally:
        attention.FlashPairPacked = kernel_path
    if after != before:
        raise AssertionError(f"the plain run launched kernels: {before} -> "
                             f"{after}")
    diff = max(abs(x - y) for x, y in zip(losses, plain))
    log(f"[train-plain] losses {[round(x, 4) for x in plain]}; largest "
        f"|kernel - plain| over the {len(plain)} steps {diff:.3g} (limit "
        f"{TRAIN_PLAIN_LOSS_LIMIT})")
    if not diff < TRAIN_PLAIN_LOSS_LIMIT:
        raise AssertionError("the kernel path's loss curve departs from the "
                             "plain path's on the same recipe")
    del model, opt, step


def phase_train_check():
    """The slice against the plain path on the same weights: GPT-medium
    width with 2 blocks in fp32, B = 2, L = 256, one forward and backward
    on the card (through both flash kernels) and one on the CPU (the plain
    path), ``_card_vs_cpu``."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    cfg = GPTConfig(**dict(GPT_MEDIUM, num_layers=2))
    gen = torch.Generator()
    gen.manual_seed(8)
    ids = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen)
    labels = ids.clone()
    labels[:, :16] = -100
    _card_vs_cpu("[train-check] fp32, 2 blocks, [2, 256]:",
                 lambda dev: GPTForCausalLM(cfg, device=dev, seed=7),
                 (ids, labels), dict(flash_pair_fwd=2, flash_pair_bwd=2))


def _card_vs_cpu(tag, make, inputs, want_launches):
    """One forward and backward of ``make(device)`` on the card (through
    the kernels, exactly ``want_launches``) and on the CPU (the plain
    versions) on the same weights and, where the model drops, the same
    generator state: the loss and every leaf's gradient within
    TRAIN_CHECK_REL_LIMIT relative (Frobenius per leaf). fp32 on both
    sides, so what remains is summation order. Returns {leaf: relative
    error}."""
    from paddle_tpu_torch.kernels import launch_counts
    cpu = make("cpu")
    card = make("cuda")                # the same seed: the same generator
    card.load_state_dict(cpu.state_dict())
    before = launch_counts()
    loss_card = card(*(t.cuda() if t is not None else None for t in inputs))
    if isinstance(loss_card, tuple):
        loss_card = loss_card[-1]
    loss_card.backward()
    torch.cuda.synchronize()
    grew = _grew(before, launch_counts())
    _expect_launches(tag, grew, **want_launches)
    loss_cpu = cpu(*inputs)
    if isinstance(loss_cpu, tuple):
        loss_cpu = loss_cpu[-1]
    loss_cpu.backward()
    loss_rel = abs(loss_card.item() - loss_cpu.item()) / abs(loss_cpu.item())
    rels = {}
    cpu_params = dict(cpu.named_parameters())
    for name, p in card.named_parameters():
        if (p.grad is None) != (cpu_params[name].grad is None):
            raise AssertionError(f"{name}: a gradient on one side only")
        if p.grad is not None:
            rels[name] = rel_err(p.grad.cpu(), cpu_params[name].grad)
    worst_name = max(rels, key=rels.get)
    worst = rels[worst_name]
    log(f"{tag} loss card {loss_card.item():.6f} vs cpu {loss_cpu.item():.6f}"
        f" (rel {loss_rel:.3g}); worst leaf gradient rel {worst:.3g} "
        f"({worst_name}); limit {TRAIN_CHECK_REL_LIMIT}; launches {grew}")
    if not (loss_rel < TRAIN_CHECK_REL_LIMIT
            and worst < TRAIN_CHECK_REL_LIMIT):
        raise AssertionError("the card's loss or gradients disagree with "
                             "the plain CPU path")
    return rels


def phase_profile_train(model, opt, ids):
    """One training step of the [train] model under torch.profiler: the
    device busy share, the six kernels with the most device time, and the
    share of the step taken by the two flash kernels (from the profile)
    and by the fp32 LM head + cross-entropy (forward and backward at the
    step's shape, timed alone with CUDA events)."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import _lm_head_ce
    step = TrainStep(model, opt, fast_path=False)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(ids, ids).item()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    flash_us = sum(e.self_device_time_total for e in kernels
                   if _is_flash_kernel(e.key))
    hidden = torch.randn(ids.shape[0], ids.shape[1] - 1,
                         GPT_MEDIUM["hidden_size"], device="cuda",
                         dtype=torch.bfloat16, requires_grad=True)
    weight = model.head_weight.detach().clone().requires_grad_()

    def head():
        loss = _lm_head_ce(hidden, weight, ids[:, 1:])
        loss.backward()
    head_ms = cuda_time_ms(head, iters=3, warmup=1)
    busy = max(busy_us, 1.0)
    log(f"[profile-train] one step, profiler on: {wall * 1e3:.1f} ms wall, "
        f"device busy {busy_us / 1e3:.1f} ms = {busy_us / 1e6 / wall:.3f} of "
        f"wall; flash kernels {flash_us / 1e3:.1f} ms = "
        f"{flash_us / busy:.3f} of device time, "
        f"{flash_us / 1e6 / wall:.3f} of wall; fp32 head + CE fwd+bwd "
        f"{head_ms:.1f} ms alone = {head_ms * 1e3 / busy:.3f} of device "
        f"time, {head_ms / 1e3 / wall:.3f} of wall")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"[profile-train]   {e.self_device_time_total / 1e3:8.2f} ms "
            f"x{e.count:5d}  {e.key[:90]}")


# ------------------------------------------------- heads above 256 (wide)

# the wide-head kernels' headline shape: flat [2, 2048, 8 q / 2 KV heads,
# 512] bf16 causal (csrc/flash_wide_sm90.cuh both ways)
WIDE_SHAPE = (2, 2048, 8, 2, 512)


def phase_compare_wide():
    """The bf16 wide-head kernels at WIDE_SHAPE against their plain
    versions, at [compare-fa]'s and [compare-fa-bwd]'s limits (out within
    atol 4e-3 times the probability-weighted |v| + rtol 1e-2, lse within
    1e-3, dq/dk/dv within FA_BWD_REL_LIMIT, dk and dv equal between two
    launches), then timed beside the plain versions, sdpa (forward, and
    autograd through it; at D > 256 it has no FlashAttention backend) and
    the bounds. Returns the forward and backward records."""
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_reference,
        flash_attention_fwd, flash_attention_fwd_reference)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(80)
    b, L, h, hkv, d = WIDE_SHAPE
    q, k, v, g = _fa_inputs(b, L, L, h, hkv, d, BF16, gen)
    out, lse = flash_attention_fwd(q, k, v, True)
    got = flash_attention_bwd(q, k, v, out, lse, g, True)
    again = flash_attention_bwd(q, k, v, out, lse, g, True)
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_attention_fwd_reference(q, k, v, True)
    weight = flash_attention_fwd_reference(q, k, v.abs(), True)[0].float()
    diff = (out.float() - ref_out.float()).abs()
    err = diff.max().item()
    of_limit = (diff / (4e-3 * weight.clamp_min(1.0)
                        + 1e-2 * ref_out.float().abs())).max().item()
    lse_ok = bool(((lse - ref_lse).abs() <= 1e-3 + 1e-3 * ref_lse.abs())
                  .all())
    del weight, diff, ref_out, ref_lse
    want = flash_attention_bwd_reference(q, k, v, out, lse, g, True)
    rels = [rel_err(x, y) for x, y in zip(got, want)]
    worst_abs = max((x.float() - y.float()).abs().max().item()
                    for x, y in zip(got, want))
    stable = torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
    del want, again, got
    ms = cuda_time_ms(lambda: flash_attention_fwd(q, k, v, True))
    bwd_ms = cuda_time_ms(lambda: flash_attention_bwd(q, k, v, out, lse, g,
                                                      True), iters=10)
    plain_ms = cuda_time_ms(lambda: flash_attention_fwd_reference(
        q, k, v, True), iters=3, warmup=1)
    plain_bwd_ms = cuda_time_ms(lambda: flash_attention_bwd_reference(
        q, k, v, out, lse, g, True), iters=3, warmup=1)
    lib_ms = cuda_time_ms(lambda: _sdpa_library(q, k, v, True), iters=10)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o = _sdpa_library(*leaves, True)
    lib_bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(
        o, leaves, g.transpose(1, 2), retain_graph=True), iters=10)
    fb = fa_bound_ms(b, L, L, h, hkv, d, BF16, True)
    bb = fa_bound_ms(b, L, L, h, hkv, d, BF16, True, backward=True)
    tag = (f"[compare-wide] flash_attention_fwd/_bwd B={b} L={L} H={h} "
           f"Hkv={hkv} D={d} bf16 causal")
    log(f"{tag}: out {of_limit:.3f} of the limit (max|err| {err:.3g}), lse "
        f"ok {lse_ok}; dq/dk/dv rel {rels[0]:.3g}/{rels[1]:.3g}/"
        f"{rels[2]:.3g} (limit {FA_BWD_REL_LIMIT[BF16]}); dk/dv equal "
        f"between launches {stable}")
    log(f"{tag}: forward {ms:.4f} ms (plain {plain_ms:.4f}, sdpa "
        f"{lib_ms:.4f}, bound {fb[0]:.4f} ms {fb[1]}); backward {bwd_ms:.4f} "
        f"ms (plain {plain_bwd_ms:.4f}, sdpa backward {lib_bwd_ms:.4f}, "
        f"bound {bb[0]:.4f} ms {bb[1]})")
    if not (of_limit <= 1.0 and lse_ok and stable
            and max(rels) < FA_BWD_REL_LIMIT[BF16]):
        raise AssertionError(f"{tag}: the wide kernels disagree with their "
                             f"plain versions")
    del q, k, v, g, out, lse, leaves, o
    torch.cuda.empty_cache()
    return (dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=fb[0],
                 bound_by=fb[1], library_ms=lib_ms),
            dict(max_abs_err=worst_abs, ms=bwd_ms, plain_ms=plain_bwd_ms,
                 bound_ms=bb[0], bound_by=bb[1], library_ms=lib_bwd_ms))


# [wide-route]: (launcher, D, dtype, the forward's and the backward's body
# as the profiler names them, the counter of each launch's body or None:
# "wide", the bf16 wide bodies' (.wide_launches); "f32_wide", the fp32
# ones' (.f32_wide_launches); "f32_fwd" and "f32_bwd", the fp32 forward
# and backward up to 256 (.f32_fwd_launches, .f32_bwd_launches);
# "sw32_bwd", the bf16 backward at 80 and 96 (.sw32_bwd_launches))
WIDE_ROUTES = [
    ("flat", 512, BF16, "flash_fwd_wide_kernel", "flash_bwd_wide_kernel",
     "wide", "wide"),
    ("pair", 384, BF16, "flash_fwd_wide_kernel", "flash_bwd_wide_kernel",
     "wide", "wide"),
    ("flat", 256, BF16, "flash_fwd_sm90_kernel", "flash_bwd_wide_kernel",
     None, "wide"),
    ("pair", 256, BF16, "flash_fwd_sm90_kernel", "flash_bwd_wide_kernel",
     None, "wide"),
    ("flat", 80, BF16, "flash_fwd_sm90_kernel", "flash_bwd_sm90_kernel",
     None, "sw32_bwd"),
    ("flat", 96, BF16, "flash_fwd_sm90_kernel", "flash_bwd_sm90_kernel",
     None, "sw32_bwd"),
    ("flat", 320, FP32, "flash_fwd_f32_wide_kernel",
     "flash_bwd_f32_wide_kernel", "f32_wide", "f32_wide"),
    ("pair", 384, FP32, "flash_fwd_f32_wide_kernel",
     "flash_bwd_f32_wide_kernel", "f32_wide", "f32_wide")]
WIDE_ROUTES += [(launcher, d, FP32, "flash_fwd_f32_small_kernel",
                 "flash_bwd_f32_kernel", "f32_fwd", "f32_bwd")
                for launcher, d in (("flat", 64), ("flat", 80), ("flat", 96),
                                    ("flat", 128), ("flat", 256),
                                    ("pair", 64), ("pair", 128),
                                    ("pair", 256))]


def _wide_route_run(launcher, d, dtype, gen):
    """One forward and one backward of ``launcher`` ("flat" or "pair") at
    [2, 256, 4 heads, ``d``] causal on seeded inputs: (the two wrappers'
    names, the call)."""
    from paddle_tpu_torch.kernels import flash_attention, flash_pair
    b, L, h = 2, 256, 4
    if launcher == "flat":
        q, k, v, g = _fa_inputs(b, L, L, h, 2, d, dtype, gen)

        def run():
            out, lse = flash_attention.flash_attention_fwd(q, k, v, True)
            flash_attention.flash_attention_bwd(q, k, v, out, lse, g, True)
        return ("flash_attention_fwd", "flash_attention_bwd"), run
    qkv, g = _bwd_inputs(b, L, h, d, dtype, gen)

    def run():
        out, lse = flash_pair.flash_pair_fwd(qkv, h, True)
        flash_pair.flash_pair_bwd(qkv, out, lse, g, h, True)
    return ("flash_pair_fwd", "flash_pair_bwd"), run


def _route_want(dtype, fwd_body, bwd_body, ctr_f, ctr_b):
    """The flash kernels a [wide-route] route's forward and backward run."""
    want = {fwd_body, bwd_body, "bwd_prepass_kernel", "dq_sum_kernel"}
    if dtype == BF16 and "wide" in (ctr_f, ctr_b):
        want.add("scale_q_kernel")
    return want


# [trace-probe]'s ways to open a profiled window before the route runs:
# as [wide-route] opens it, after one marker launch and a synchronise,
# and after the marker, a synchronise and a 10 ms wait
TRACE_OPENINGS = ("plain", "marker", "marker+wait")


def _open_window(how):
    """What a profiled window runs before the launches it reads."""
    if how == "plain":
        return
    torch.zeros(1, device="cuda").add_(1.0)
    torch.cuda.synchronize()
    if how == "marker+wait":
        time.sleep(0.01)


def probe_wide_route_traces(reps):
    """[trace-probe]: every [wide-route] route profiled ``reps`` more
    times for each of TRACE_OPENINGS, the launch counters read beside
    each trace: how many traces held every flash kernel the route ran,
    how many held only some (the first few logged with their device
    events in time order and the counters), how many held no device
    event. It checks nothing: it reads how often the profiler loses
    device events of launches the counters saw (ROADMAP Queue 3)."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
    cuda = torch.autograd.DeviceType.CUDA
    gen = torch.Generator(device="cuda")
    gen.manual_seed(81)
    tally = {how: {"whole": 0, "partial": 0, "empty": 0, "lost": {}}
             for how in TRACE_OPENINGS}
    logged = 0
    t0 = time.perf_counter()
    for launcher, d, dtype, fwd_body, bwd_body, ctr_f, ctr_b in WIDE_ROUTES:
        names, run = _wide_route_run(launcher, d, dtype, gen)
        want = _route_want(dtype, fwd_body, bwd_body, ctr_f, ctr_b)
        run()
        torch.cuda.synchronize()
        for rep in range(reps):
            for how in TRACE_OPENINGS:
                reset_launch_counts()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    _open_window(how)
                    run()
                    torch.cuda.synchronize()
                counts = launch_counts()
                dev = sorted((e for e in prof.events()
                              if e.device_type == cuda),
                             key=lambda e: e.time_range.start)
                seen = {n for n in FLASH_KERNELS
                        if any(n in e.name for e in dev)}
                kind = ("empty" if not dev else "whole" if want <= seen
                        else "partial")
                t = tally[how]
                t[kind] += 1
                for n in want - seen:
                    t["lost"][n] = t["lost"].get(n, 0) + 1
                if kind != "whole" and logged < 12:
                    logged += 1
                    log(f"[trace-probe] {how} {launcher} D={d} "
                        f"{str(dtype)[6:]} rep {rep}: {kind} trace, flash "
                        f"kernels {sorted(seen)} of {sorted(want)}; device "
                        f"events in time order "
                        f"{[e.name[:48] for e in dev]}; launches "
                        f"{names[0]} {counts[names[0]]}, {names[1]} "
                        f"{counts[names[1]]}")
        torch.cuda.empty_cache()
    for how, t in tally.items():
        log(f"[trace-probe] {how}: {len(WIDE_ROUTES)} routes x {reps} "
            f"traces: {t}")
    log(f"[trace-probe] {time.perf_counter() - t0:.1f} s")
    return tally


def phase_wide_route():
    """Which body each launcher runs, read from the profiler's kernel names
    and the launch counters (one forward and one backward under
    torch.profiler, counts set to 0 just before): bf16 heads above 256 on
    both launchers run flash_fwd_wide_kernel and flash_bwd_wide_kernel
    (each behind its scale_q_kernel launch); the bf16 D = 256 backward runs
    flash_bwd_wide_kernel; the bf16 backward at 80 and 96 runs
    flash_bwd_sm90_kernel at that head size (its template argument in the
    name); fp32 above 256 runs flash_fwd_f32_wide_kernel and
    flash_bwd_f32_wide_kernel on both launchers, and fp32 at 64, 128 and
    256 on both launchers and 80 and 96 on the flat one
    flash_fwd_f32_small_kernel and flash_bwd_f32_kernel (the SIMT forward,
    flash_fwd_f32_kernel, must not run: it is one of the FLASH_KERNELS
    names read). Each window opens with a marker launch (``_open_window``),
    and a trace that lost device events (it holds only some of the
    route's kernels, or none, and none of another body's) is taken again,
    up to three times: the profiler loses them ([trace-probe], ROADMAP
    Queue 3). The flash kernels seen must be exactly the expected
    ones, and each body counter of the wrappers (bf16 wide, fp32 wide,
    fp32 forward and backward, bf16 80/96 backward) must read 1 where its
    body ran and 0 elsewhere."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.kernels import (f32_bwd_launch_counts,
                                          f32_fwd_launch_counts,
                                          f32_wide_launch_counts,
                                          launch_counts, reset_launch_counts,
                                          sw32_bwd_launch_counts,
                                          wide_launch_counts)
    readers = {"wide": wide_launch_counts, "f32_wide": f32_wide_launch_counts,
               "f32_fwd": f32_fwd_launch_counts,
               "f32_bwd": f32_bwd_launch_counts,
               "sw32_bwd": sw32_bwd_launch_counts}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(81)
    for launcher, d, dtype, fwd_body, bwd_body, ctr_f, ctr_b in WIDE_ROUTES:
        names, run = _wide_route_run(launcher, d, dtype, gen)
        run()                                # built and warm
        torch.cuda.synchronize()
        want = _route_want(dtype, fwd_body, bwd_body, ctr_f, ctr_b)
        for attempt in range(3):
            reset_launch_counts()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                _open_window("marker")
                run()
                torch.cuda.synchronize()
            events = prof.key_averages()
            keys = [e.key for e in events]
            seen = {n for n in FLASH_KERNELS if any(n in key for key in keys)}
            # the profiler loses device events ([trace-probe]: most often
            # the first launches of a window, which the marker takes;
            # 3-4 marker-opened traces in 320 still lost some or all): a
            # trace that holds no kernel of another body but misses some
            # of this route's is taken again; a wrong body is never
            if not seen < want:
                break
            log(f"[wide-route] {launcher} D={d}: the trace lost device "
                f"events ({sorted(want - seen)} missing, attempt "
                f"{attempt + 1}); profiling again")
        counts = launch_counts()
        bodies = {}                          # counter -> {wrapper: count}
        for ctr, reader in readers.items():
            bodies.update({(ctr, n): c for n, c in reader().items()})
        expect = {key: int(key in ((ctr_f, names[0]), (ctr_b, names[1])))
                  for key in bodies}
        sized = bwd_body != "flash_bwd_sm90_kernel" or any(
            f"flash_bwd_sm90_kernel<{d}," in key for key in keys)
        ran = {f"{c}:{n}": x for (c, n), x in bodies.items() if x}
        tag = (f"[wide-route] {launcher} D={d} {str(dtype)[6:]}: flash "
               f"kernels {sorted(seen)}; launches {names[0]} "
               f"{counts[names[0]]}, {names[1]} {counts[names[1]]}; body "
               f"counters {ran}")
        log(tag)
        if not (seen == want and counts[names[0]] == 1
                and counts[names[1]] == 1 and bodies == expect and sized):
            raise AssertionError(f"{tag}: expected the kernels "
                                 f"{sorted(want)} and the counters "
                                 f"{ctr_f}, {ctr_b}")
        torch.cuda.empty_cache()


# [fp32-bodies]: the fp32 wide kernels' headline shapes, (launcher, B, L,
# H, Hkv, D): flat [2, 1024, 8/2, 512] causal (the kernels line's records;
# its parent's times are [parent-*]'s wide-f32-512) and packed [2, 1024,
# 3*8*384] causal
FP32_WIDE_CASES = [("flat", 2, 1024, 8, 2, 512),
                   ("pair", 2, 1024, 8, 8, 384)]


def _sdpa_kernels(fn):
    """The CUDA kernels one call of ``fn`` runs, by the profiler's names
    (the largest device time first)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    events.sort(key=lambda e: -e.self_device_time_total)
    return [e.key[:60] for e in events[:3]]


def phase_fp32_bodies(parent, parent_fwd, parent_bwd):
    """The fp32 bodies beside sdpa in fp32 and the fp32 bound (67 TFLOP/s),
    causal: the FFMA forward and backward up to 256
    (flash_fwd_f32_small_kernel and flash_bwd_f32_kernel of
    csrc/flash_f32_wide.cuh) at [2, 1024, 8/2, 128], and the fp32 wide
    kernels (the same header) at FP32_WIDE_CASES.

    TF32 is off for matrix products (allow_tf32 False, printed), so sdpa
    runs fp32; the phase names the kernels sdpa ran (profiler) and holds
    both to the exact output and gradient (the plain versions in fp64 from
    fp64 inputs): ours within BIG_D_FP32_REL_LIMIT per part, sdpa's
    printed beside. At the wide shapes the forward must also agree with
    its fp32 plain version within [compare-fa]'s limits (out atol = rtol =
    1e-4, lse 1e-3), dk and dv be equal between two launches and, with a
    parent tree, out and lse agree with the parent's kernels within
    atol = rtol = 1e-4 (the parent's gradient, against the same exact one,
    is printed). Times: the flat case's beside its parent's from
    [parent-fwd] / [parent-bwd] (no slower beyond the noise there), the
    packed case's beside its parent's in turns here. At D = 128 the
    forward is held to its fp32 plain version within [compare-fa]'s limits
    and its error against the exact output printed beside sdpa's; the
    backward that follows it to its fp32 plain version within
    FA_BWD_REL_LIMIT[FP32] (its scores are the forward's sums, bit for
    bit), dk and dv equal between launches; their times are [parent-fwd]'s
    and [parent-bwd]'s f32-128, beside the parent's (its forward the SIMT
    body). Returns the wide flat case's forward and backward records and
    the D = 128 backward's and forward's."""
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_reference,
        flash_attention_fwd, flash_attention_fwd_reference)
    from paddle_tpu_torch.kernels.flash_pair import (
        flash_pair_bwd, flash_pair_bwd_reference, flash_pair_fwd,
        flash_pair_fwd_reference)
    log(f"[fp32-bodies] torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32 = "
        f"{torch.backends.cudnn.allow_tf32}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(82)
    b, L, h, hkv, d = 2, 1024, 8, 2, 128
    q, k, v, g = _fa_inputs(b, L, L, h, hkv, d, FP32, gen)
    out, lse = flash_attention_fwd(q, k, v, True)
    got = flash_attention_bwd(q, k, v, out, lse, g, True)
    again = flash_attention_bwd(q, k, v, out, lse, g, True)
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_attention_fwd_reference(q, k, v, True)
    fdiff = (out - ref_out).abs()
    fwd_err = fdiff.max().item()
    fwd_of_limit = (fdiff / (1e-4 + 1e-4 * ref_out.abs())).max().item()
    lse_ok = bool(((lse - ref_lse).abs()
                   <= 1e-3 + 1e-3 * ref_lse.abs()).all())
    want = flash_attention_bwd_reference(q, k, v, out, lse, g, True)
    rels = [rel_err(x, y) for x, y in zip(got, want)]
    worst_abs = max((x - y).abs().max().item() for x, y in zip(got, want))
    stable = torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
    q64, k64, v64, g64 = (t.double() for t in (q, k, v, g))
    o64, l64 = flash_attention_fwd_reference(q64, k64, v64, True)
    exact = flash_attention_bwd_reference(q64, k64, v64, o64, l64, g64, True)
    ours_x = [rel_err(x, y) for x, y in zip(got, exact)]
    plain_x = [rel_err(x, y) for x, y in zip(want, exact)]
    fwd_x = rel_err(out, o64)
    lib_fwd_x = rel_err(_sdpa_library(q, k, v, True).transpose(1, 2), o64)
    del got, again, q64, k64, v64, g64, l64
    ms, pms = parent_fwd["f32-128"][:2]
    bwd_ms, pbwd_ms = parent_bwd["f32-128"][:2]
    plain_ms = cuda_time_ms(lambda: flash_attention_fwd_reference(
        q, k, v, True), iters=3, warmup=1)
    plain_bwd_ms = cuda_time_ms(lambda: flash_attention_bwd_reference(
        q, k, v, out, lse, g, True), iters=3, warmup=1)
    lib_ms = cuda_time_ms(lambda: _sdpa_library(q, k, v, True))
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o = _sdpa_library(*leaves, True)
    lib_bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(
        o, leaves, g.transpose(1, 2), retain_graph=True))
    fb = fa_bound_ms(b, L, L, h, hkv, d, FP32, True)
    bb = fa_bound_ms(b, L, L, h, hkv, d, FP32, True, backward=True)
    tag = f"[fp32-bodies] B={b} L={L} H={h} Hkv={hkv} D={d} fp32 causal"
    log(f"{tag} (flash_fwd_f32_small_kernel): out {fwd_of_limit:.3f} of the "
        f"limit (atol 1e-4, rtol 1e-4; max|err| {fwd_err:.3g}), lse ok "
        f"{lse_ok}; against the exact (fp64) output ours {fwd_x:.3g}, "
        f"sdpa's (fp32, TF32 off) {lib_fwd_x:.3g}")
    log(f"{tag} (flash_bwd_f32_kernel after it): dq/dk/dv rel "
        f"{rels[0]:.3g}/{rels[1]:.3g}/{rels[2]:.3g} (limit "
        f"{FA_BWD_REL_LIMIT[FP32]}); against the exact gradient ours "
        f"{ours_x[0]:.3g}/{ours_x[1]:.3g}/{ours_x[2]:.3g}, the plain "
        f"version's {plain_x[0]:.3g}/{plain_x[1]:.3g}/{plain_x[2]:.3g}; "
        f"dk/dv equal between launches {stable}")

    def beside(mine, theirs, body):
        return ("the parent's not measured" if theirs is None else
                f"the parent's {body}{theirs:.4f} ms, {theirs / mine:.2f}x")
    log(f"{tag}: forward {ms:.4f} ms ({beside(ms, pms, 'SIMT body ')}; sdpa "
        f"{lib_ms:.4f}, {ms / lib_ms:.2f}x its time; plain {plain_ms:.4f}; "
        f"bound {fb[0]:.4f} ms {fb[1]}); backward {bwd_ms:.4f} ms "
        f"({beside(bwd_ms, pbwd_ms, '')}; sdpa backward {lib_bwd_ms:.4f}, "
        f"{bwd_ms / lib_bwd_ms:.2f}x its time; plain {plain_bwd_ms:.4f}; "
        f"bound {bb[0]:.4f} ms {bb[1]})")
    if not (fwd_of_limit <= 1.0 and lse_ok and stable
            and max(rels) < FA_BWD_REL_LIMIT[FP32]):
        raise AssertionError(f"{tag}: the fp32 forward or backward "
                             f"disagrees")
    small_records = (
        dict(max_abs_err=worst_abs, ms=bwd_ms, plain_ms=plain_bwd_ms,
             bound_ms=bb[0], bound_by=bb[1], library_ms=lib_bwd_ms,
             parent_ms=pbwd_ms),
        dict(max_abs_err=fwd_err, ms=ms, plain_ms=plain_ms, bound_ms=fb[0],
             bound_by=fb[1], library_ms=lib_ms, parent_ms=pms))
    del q, k, v, g, out, lse, leaves, o, want, exact, o64, ref_out, ref_lse
    torch.cuda.empty_cache()

    records = None
    for launcher, b, L, h, hkv, d in FP32_WIDE_CASES:
        tag = (f"[fp32-bodies] {launcher} B={b} L={L} H={h} Hkv={hkv} D={d} "
               f"fp32 causal (fp32 wide kernels)")
        if launcher == "flat":
            q, k, v, g = _fa_inputs(b, L, L, h, hkv, d, FP32, gen)
            pmod = parent and parent.flash_attention

            def fwd(mod=None):
                return (mod.flash_attention_fwd if mod else
                        flash_attention_fwd)(q, k, v, True)

            def bwd(o, lse, mod=None):
                return (mod.flash_attention_bwd if mod else
                        flash_attention_bwd)(q, k, v, o, lse, g, True)
            fwd_ref = lambda: flash_attention_fwd_reference(q, k, v, True)
            q64, k64, v64, g64 = (t.double() for t in (q, k, v, g))
            o64, l64 = flash_attention_fwd_reference(q64, k64, v64, True)
            exact = flash_attention_bwd_reference(q64, k64, v64, o64, l64,
                                                  g64, True)
            bwd_ref = lambda o, lse: flash_attention_bwd_reference(
                q, k, v, o, lse, g, True)
            parts = lambda grads: grads
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            sdpa = lambda: _sdpa_library(*leaves, True)
            grad_out = g.transpose(1, 2)
            sdpa_out = lambda o: o.transpose(1, 2)
            fb = fa_bound_ms(b, L, L, h, hkv, d, FP32, True)
            bb = fa_bound_ms(b, L, L, h, hkv, d, FP32, True, backward=True)
        else:
            qkv, g = _bwd_inputs(b, L, h, d, FP32, gen)
            pmod = parent and parent.flash_pair

            def fwd(mod=None):
                return (mod.flash_pair_fwd if mod else
                        flash_pair_fwd)(qkv, h, True)

            def bwd(o, lse, mod=None):
                return (mod.flash_pair_bwd if mod else
                        flash_pair_bwd)(qkv, o, lse, g, h, True)
            fwd_ref = lambda: flash_pair_fwd_reference(qkv, h, True)
            o64, l64 = flash_pair_fwd_reference(qkv.double(), h, True)
            exact = flash_pair_bwd_reference(qkv.double(), o64, l64,
                                             g.double(), h, True)
            bwd_ref = lambda o, lse: flash_pair_bwd_reference(
                qkv, o, lse, g, h, True)
            hd = h * d
            parts = lambda x: [x[..., i * hd:(i + 1) * hd] for i in range(3)]
            leaf = qkv.detach().requires_grad_()
            leaves = [leaf]
            lq, lk, lv = (leaf[..., i * hd:(i + 1) * hd].view(b, L, h, d)
                          .transpose(1, 2) for i in range(3))
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
                lq, lk, lv, is_causal=True)
            grad_out = g.view(b, L, h, d).transpose(1, 2)
            sdpa_out = lambda o: o.transpose(1, 2).reshape(b, L, hd)
            fb = flash_bound_ms(b, L, h, d, FP32, True)
            bb = flash_bwd_bound_ms(b, L, h, d, FP32, True)
        out, lse = fwd()
        got = bwd(out, lse)
        again = bwd(out, lse)
        torch.cuda.synchronize()
        ref_out, ref_lse = fwd_ref()
        diff = (out - ref_out).abs()
        err = diff.max().item()
        of_limit = (diff / (1e-4 + 1e-4 * ref_out.abs())).max().item()
        lse_ok = bool(((lse - ref_lse).abs()
                       <= 1e-3 + 1e-3 * ref_lse.abs()).all())
        rels = [rel_err(x, y) for x, y in zip(parts(got), parts(exact))]
        worst_abs = max((x.double() - y).abs().max().item()
                        for x, y in zip(parts(got), parts(exact)))
        stable = all(torch.equal(x, y) for x, y in
                     zip(parts(got)[1:], parts(again)[1:]))
        out_rel = rel_err(out, o64)
        # sdpa in fp32 against the same exact output and gradient
        lib_o = sdpa()
        lib_grads = torch.autograd.grad(lib_o, leaves, grad_out,
                                        retain_graph=True)
        lib_out_rel = rel_err(sdpa_out(lib_o), o64)
        lib_rels = [rel_err(x, y) for x, y in
                    zip(parts(lib_grads[0]) if launcher == "pair"
                        else lib_grads, parts(exact))]
        lib_fwd_names = _sdpa_kernels(sdpa)
        lib_bwd_names = _sdpa_kernels(lambda: torch.autograd.grad(
            lib_o, leaves, grad_out, retain_graph=True))
        del lib_grads, again
        log(f"{tag}: out {of_limit:.3f} of the limit (atol 1e-4, rtol 1e-4; "
            f"max|err| {err:.3g}), lse ok {lse_ok}; dq/dk/dv rel "
            f"{rels[0]:.3g}/{rels[1]:.3g}/{rels[2]:.3g} (limit "
            f"{BIG_D_FP32_REL_LIMIT}{EXACT_NOTE}); dk/dv equal between "
            f"launches {stable}")
        log(f"{tag}: against the exact (fp64) output and gradient, ours: out "
            f"{out_rel:.3g}, dq/dk/dv {rels[0]:.3g}/{rels[1]:.3g}/"
            f"{rels[2]:.3g}; sdpa's (fp32, TF32 off): out {lib_out_rel:.3g}, "
            f"dq/dk/dv {lib_rels[0]:.3g}/{lib_rels[1]:.3g}/{lib_rels[2]:.3g}; "
            f"sdpa ran {lib_fwd_names} forward, {lib_bwd_names} backward")
        ok = (of_limit <= 1.0 and lse_ok and stable
              and max(rels) < BIG_D_FP32_REL_LIMIT)
        if parent is not None:
            p_out, p_lse = fwd(pmod)
            p_got = bwd(out, lse, pmod)
            same = (torch.allclose(out, p_out, atol=1e-4, rtol=1e-4)
                    and torch.allclose(lse, p_lse, atol=1e-4, rtol=1e-4))
            p_rels = [rel_err(x, y) for x, y in
                      zip(parts(p_got), parts(exact))]
            log(f"{tag}: out, lse within 1e-4 of the parent's {same} "
                f"(max|diff| {(out - p_out).abs().max().item():.3g}, "
                f"{(lse - p_lse).abs().max().item():.3g}); the parent's dq/dk/"
                f"dv rel {p_rels[0]:.3g}/{p_rels[1]:.3g}/{p_rels[2]:.3g}"
                f"{EXACT_NOTE}")
            ok = ok and same
            del p_out, p_lse, p_got
        if not ok:
            raise AssertionError(f"{tag}: the fp32 wide kernels disagree")
        plain_ms = cuda_time_ms(fwd_ref, iters=3, warmup=1)
        plain_bwd_ms = cuda_time_ms(lambda: bwd_ref(out, lse), iters=3,
                                    warmup=1)
        lib_ms = cuda_time_ms(sdpa)
        lib_bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(
            lib_o, leaves, grad_out, retain_graph=True), iters=10)
        if launcher == "flat":
            ms, pms = parent_fwd["wide-f32-512"][:2]
            bwd_ms, pbwd_ms = parent_bwd["wide-f32-512"][:2]
        elif parent is not None:
            (ms, _), (pms, _) = _timed_pair(fwd, lambda: fwd(pmod), 3)
            (bwd_ms, _), (pbwd_ms, _) = _timed_pair(
                lambda: bwd(out, lse), lambda: bwd(out, lse, pmod), 3)
        else:
            ms = cuda_time_ms(fwd, iters=10)
            bwd_ms = cuda_time_ms(lambda: bwd(out, lse), iters=10)
            pms = pbwd_ms = None
        log(f"{tag}: forward {ms:.4f} ms ({beside(ms, pms, '')}; sdpa "
            f"{lib_ms:.4f}, {ms / lib_ms:.2f}x its time; plain {plain_ms:.4f};"
            f" bound {fb[0]:.4f} ms {fb[1]}); backward {bwd_ms:.4f} ms "
            f"({beside(bwd_ms, pbwd_ms, '')}; sdpa backward "
            f"{lib_bwd_ms:.4f}, {bwd_ms / lib_bwd_ms:.2f}x its time; plain "
            f"{plain_bwd_ms:.4f}; "
            f"bound {bb[0]:.4f} ms {bb[1]})")
        if launcher == "flat":
            records = (dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=fb[0], bound_by=fb[1],
                            library_ms=lib_ms, parent_ms=pms),
                       dict(max_abs_err=worst_abs, ms=bwd_ms,
                            plain_ms=plain_bwd_ms, bound_ms=bb[0],
                            bound_by=bb[1], library_ms=lib_bwd_ms,
                            parent_ms=pbwd_ms))
        del out, lse, got, exact, o64, l64, leaves, lib_o, ref_out, ref_lse
        torch.cuda.empty_cache()
    return records + small_records


# [plain-times]: the shapes of PERF.md's kernel table where no other phase
# times the plain version: (tag as in [parent-*], launcher, backward, B, L,
# H, Hkv, D, dtype, causal, rate, BERT's lengths)
PLAIN_CASES = [
    ("wide-pair-384", "pair", False, 2, 2048, 8, 8, 384, BF16, True, 0.0,
     False),
    ("wide-pair-384", "pair", True, 2, 2048, 8, 8, 384, BF16, True, 0.0,
     False),
    ("f32-pair-128", "pair", False, 2, 1024, 8, 8, 128, FP32, True, 0.0,
     False),
    ("f32-pair-128", "pair", True, 2, 1024, 8, 8, 128, FP32, True, 0.0,
     False),
    ("f32-bert-pair", "pair", True, 2, 512, 12, 12, 64, FP32, False, 0.1,
     False),
    ("wide-320", "flat", False, 2, 2048, 16, 4, 320, BF16, True, 0.1, False),
    ("wide-320", "flat", True, 2, 2048, 16, 4, 320, BF16, True, 0.1, False),
    ("d256-bwd", "flat", True, 2, 2048, 8, 2, 256, BF16, True, 0.0, False),
    ("phi2-80", "flat", True, 4, 2048, 32, 32, 80, BF16, True, 0.0, False),
    ("phi3-96", "flat", True, 4, 2048, 32, 32, 96, BF16, True, 0.0, False),
    ("f32-bert-flat", "flat", True, 2, 512, 12, 12, 64, FP32, False, 0.1,
     True)]
PLAIN_CASES += [(f"f32-{d}", "flat", True, 2, 1024, 8, 2, d, FP32, True,
                 0.0, False) for d in (64, 80, 96, 256)]


def phase_plain_times():
    """The plain versions' times (3 calls after 1) at PLAIN_CASES, on
    [parent-*]'s inputs; a backward's plain version takes the kernel
    forward's out and lse."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import flash_pair as fp
    gen = torch.Generator(device="cuda")
    gen.manual_seed(83)
    for (tag, launcher, backward, b, L, h, hkv, d, dtype, causal, rate,
         lens) in PLAIN_CASES:
        seed = 0x9A4E47 if rate else None
        if launcher == "flat":
            q, k, v, g = _fa_inputs(b, L, L, h, hkv, d, dtype, gen)
            kw = {}
            if lens:
                kw["kv_lens"] = torch.as_tensor(
                    _bert_pad_lengths(b, L, BERT_PAD_SEED), dtype=torch.int32,
                    device="cuda")
            o, lse = fa.flash_attention_fwd(q, k, v, causal, None, rate,
                                            seed=seed, **kw)
            fn = (lambda: fa.flash_attention_bwd_reference(
                q, k, v, o, lse, g, causal, None, rate, seed=seed, **kw)) \
                if backward else (lambda: fa.flash_attention_fwd_reference(
                    q, k, v, causal, None, rate, seed=seed, **kw))
        else:
            qkv, g = _bwd_inputs(b, L, h, d, dtype, gen)
            o, lse = fp.flash_pair_fwd(qkv, h, causal, rate, seed)
            fn = (lambda: fp.flash_pair_bwd_reference(
                qkv, o, lse, g, h, causal, rate, seed)) if backward else \
                (lambda: fp.flash_pair_fwd_reference(qkv, h, causal, rate,
                                                     seed))
        ms = cuda_time_ms(fn, iters=3, warmup=1)
        log(f"[plain-times] {tag}: {launcher} B={b} L={L} H={h} Hkv={hkv} "
            f"D={d} {str(dtype)[6:]} causal={causal} rate {rate}"
            f"{' lengths' if lens else ''}: plain "
            f"{'backward' if backward else 'forward'} {ms:.4f} ms")
        del fn, o, lse, g
        torch.cuda.empty_cache()


# [bwd-order] cases: (tag, launcher, B, L, H, Hkv, D, dtype, causal,
# kv_lens, segment cuts, rate): the model shapes (GPT-medium's training
# backward, BERT's packed and padded at rate 0.1, LLaMA-7B's), then one
# shape per head size each body is built for: the bf16 Hopper body at 64,
# 80, 96 and 128 with GQA 8/2, lengths, three segments a row and dropout;
# the wide bf16 body at 256 and 512 (flat) and 384 (packed); the fp32 body
# at 128 and 512 (flat, the same masks) and 64 (packed, bidirectional,
# dropout)
_ORDER_MASKS = ([1024, 700], (0.25, 0.5), 0.1)
BWD_ORDER_CASES = [
    ("gpt-train", "pair", 16, 1024, 8, 8, 128, BF16, True, None, None, 0.0),
    ("bert-packed", "pair", 64, 512, 12, 12, 64, BF16, False, None, None,
     0.1),
    ("bert-padded", "flat", 64, 512, 12, 12, 64, BF16, False, "bert", None,
     0.1),
    ("llama-train", "flat", 4, 2048, 32, 32, 128, BF16, True, None, None,
     0.0),
    *[(f"sm90-{d}", "flat", 2, 1024, 8, 2, d, BF16, True, *_ORDER_MASKS)
      for d in (64, 80, 96, 128)],
    *[(f"wide-{d}", "flat", 2, 1024, 8, 2, d, BF16, True, *_ORDER_MASKS)
      for d in (256, 512)],
    ("wide-pair-384", "pair", 2, 1024, 8, 8, 384, BF16, True, None, None,
     0.0),
    *[(f"f32-{d}", "flat", 2, 1024, 8, 2, d, FP32, True, *_ORDER_MASKS)
      for d in (128, 512)],
    ("f32-pair-64", "pair", 2, 512, 12, 12, 64, FP32, False, None, None,
     0.1)]
BWD_ORDER_RUNS = 3


def _order_case_call(case, gen):
    """The backward call of one BWD_ORDER_CASES case on its inputs (the
    forward run once), returning the gradients as a tuple."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import flash_pair as fp
    tag, launcher, b, L, h, hkv, d, dtype, causal, lens, cuts, rate = case
    seed = 0x0DE7 if rate else None
    if launcher == "pair":
        qkv, g = _bwd_inputs(b, L, h, d, dtype, gen)
        o, lse = fp.flash_pair_fwd(qkv, h, causal, rate, seed)
        return lambda: (fp.flash_pair_bwd(qkv, o, lse, g, h, causal, rate,
                                          seed),)
    if lens == "bert":
        lens = [int(x) for x in _bert_pad_lengths(b, L, BERT_PAD_SEED)]
    if lens is None:
        q, k, v, g = _fa_inputs(b, L, L, h, hkv, d, dtype, gen)
        kw = {}
    else:
        q, k, v, g, kw = _mask_case_inputs(
            (tag, b, L, L, h, hkv, d, dtype, causal, lens, cuts, rate), gen)
    kw.pop("seed", None)
    o, lse = fa.flash_attention_fwd(q, k, v, causal, None, rate, seed=seed,
                                    **kw)
    return lambda: fa.flash_attention_bwd(q, k, v, o, lse, g, causal, None,
                                          rate, seed=seed, **kw)


def _dq_sum_bytes(n_rows, b, lq, hd, dtype):
    """The ordered sum's bytes: each row's slabs read once (``n_rows`` the
    ``[B, Lq]`` slab counts), dq written once."""
    esize = torch.finfo(dtype).bits // 8
    return int(n_rows.sum()) * hd * 4 + b * lq * hd * esize


def phase_bwd_order():
    """F8's gate: every backward body gives the same dq, dk and dv bit for
    bit on the same inputs, BWD_ORDER_RUNS launches of each
    BWD_ORDER_CASES case (the model shapes and one shape per built head
    size, with GQA, lengths, segment ids and dropout where the launcher
    takes them). Then the ordered sum alone (csrc/dq_sum.cu) against its
    plain version on random slabs, bit for bit: at GPT-medium's training
    shape (the main path's: 8 slabs of [16, 1024, 1024], causal), where it
    is timed beside the plain version and its bound (bytes: each row's
    slabs read once, dq written once; no single PyTorch call sums masked
    slabs in order, so no library time), at LLaMA-7B's (16 slabs of [4,
    2048, 4096], timed), and at the part geometries of the bf16 body at 64
    (two slabs a tile, lengths) and of the fp32 body (32-key tiles, Lq !=
    Lk, lengths). Returns the GPT shape's record."""
    from paddle_tpu_torch.kernels.dq_sum import (dq_ordered_sum,
                                                 dq_ordered_sum_reference,
                                                 dq_parts, dq_parts_geometry,
                                                 parts_of_rows)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(71)
    for case in BWD_ORDER_CASES:
        call = _order_case_call(case, gen)
        first = call()
        for run in range(1, BWD_ORDER_RUNS):
            again = call()
            for name, x, y in zip(("dq, dk, dv",) if len(first) == 1
                                  else ("dq", "dk", "dv"), first, again):
                if not torch.equal(x, y):
                    raise AssertionError(
                        f"[bwd-order] {case[0]}: {name} of launch {run + 1} "
                        f"differs from launch 1's")
        tag, launcher, b, L, h, hkv, d, dtype = case[:8]
        log(f"[bwd-order] {tag}: {launcher} B={b} L={L} H={h} Hkv={hkv} "
            f"D={d} {str(dtype)[6:]} causal={case[8]} rate {case[11]}"
            f"{' lengths' if case[9] else ''}"
            f"{' segments' if case[10] else ''}: {BWD_ORDER_RUNS} launches "
            f"bit for bit")
        del call, first, again
        torch.cuda.empty_cache()

    record = None
    for tag, b, lq, lk, h, d, dtype, causal, lens, timed in (
            ("gpt-train", 16, 1024, 1024, 8, 128, BF16, True, None, True),
            ("llama-train", 4, 2048, 2048, 32, 128, BF16, True, None, True),
            ("sm90-64", 2, 1024, 1024, 8, 64, BF16, True, [1024, 700],
             False),
            ("f32-ragged", 2, 200, 300, 4, 64, FP32, True, [300, 230],
             False)):
        hd = h * d
        kv_tile, per_tile = dq_parts_geometry(d, dtype)
        n = dq_parts(lk, d, dtype)
        parts = torch.randn(n, b, lq, hd, device="cuda", generator=gen)
        lens_t = None if lens is None else torch.tensor(
            lens, dtype=torch.int32, device="cuda")
        scale = 1.0 / math.sqrt(d)
        dq = torch.empty(b, lq, hd, dtype=dtype, device="cuda")
        got = dq_ordered_sum(parts, dq, lk, causal, kv_tile, per_tile, scale,
                             lens_t)
        want = dq_ordered_sum_reference(parts, lk, causal, kv_tile, per_tile,
                                        scale, dtype, lens_t)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            err = (got.float() - want.float()).abs().max().item()
            raise AssertionError(f"[bwd-order] dq_ordered_sum {tag}: differs "
                                 f"from its plain version (max|diff| "
                                 f"{err:.3g})")
        where = (f"{n} slabs of [{b}, {lq}, {hd}] -> {str(dtype)[6:]}, "
                 f"tiles of {kv_tile} keys x {per_tile}, causal={causal}"
                 f"{' lengths' if lens else ''}")
        if not timed:
            log(f"[bwd-order] dq_ordered_sum {tag}: {where}: equal to its "
                f"plain version bit for bit")
            continue
        ms = cuda_time_ms(lambda: dq_ordered_sum(parts, dq, lk, causal,
                                                 kv_tile, per_tile, scale,
                                                 lens_t))
        plain_ms = cuda_time_ms(lambda: dq_ordered_sum_reference(
            parts, lk, causal, kv_tile, per_tile, scale, dtype, lens_t),
            iters=3, warmup=1)
        rows = parts_of_rows(b, lq, lk, causal, kv_tile, per_tile, lens_t)
        nbytes = _dq_sum_bytes(rows, b, lq, hd, dtype)
        bound_ms = nbytes / PEAK_BYTES * 1e3
        log(f"[bwd-order] dq_ordered_sum {tag}: {where}: equal to its plain "
            f"version bit for bit; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, bound {bound_ms:.4f} ms (bytes: {nbytes / 1e9:.3f} GB), "
            f"{nbytes / ms / 1e6:.0f} GB/s")
        if record is None:
            record = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by="bytes",
                          library_ms=None)
        del parts, dq, got, want
        torch.cuda.empty_cache()
    return record


# ------------------------------------------------------------------ LLaMA


def fa_pairs(lq, lk, causal):
    """Attended (query, key) pairs: all, or the bottom-right-aligned causal
    band (key j visible to row i when j <= i + lk - lq)."""
    if not causal:
        return lq * lk
    seen = torch.arange(lq) + (lk - lq) + 1
    return int(seen.clamp(0, lk).sum())


def fa_bound_ms(b, lq, lk, h, hkv, d, dtype, causal, backward=False,
                pairs=None, kv_rows=None):
    """Least time for the [B, L, H, D] attention: the larger of its bytes
    over the memory rate and its matmul operations over the peak rate of
    the input type. Forward: q, k, v read once, out and lse written once;
    2 products of 2*D per attended pair. Backward: q, k, v, out, dO and
    lse read once, dq, dk, dv written once; 5 products of 2*D a pair.
    ``pairs``: the attended pairs of all batch rows over one head, where
    lengths or segment ids mask some (default: B times ``fa_pairs``).
    ``kv_rows``: the K/V rows the function needs, summed over the batch
    (sum_b min(Lk, lens[b]) with lengths; default B*Lk): K and V are read
    only there, while dk and dv are written in full."""
    esize = torch.finfo(dtype).bits // 8
    q_elems, kv_elems = b * lq * h * d, b * lk * hkv * d
    kv_read = kv_elems if kv_rows is None else kv_rows * hkv * d
    if pairs is None:
        pairs = b * fa_pairs(lq, lk, causal)
    if backward:
        nbytes = ((4 * q_elems + 2 * kv_read + 2 * kv_elems) * esize
                  + b * h * lq * 4)
        flops = 10.0 * d * h * pairs
    else:
        nbytes = (2 * q_elems + 2 * kv_read) * esize + b * h * lq * 4
        flops = 4.0 * d * h * pairs
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def _fa_inputs(b, lq, lk, h, hkv, d, dtype, gen):
    """q, k ~ N(0, 2^2), v and dO ~ N(0, 1) on the card, [B, L, H, D]."""
    q = (torch.randn(b, lq, h, d, device="cuda", generator=gen) * 2.0)
    k = (torch.randn(b, lk, hkv, d, device="cuda", generator=gen) * 2.0)
    v = torch.randn(b, lk, hkv, d, device="cuda", generator=gen)
    g = torch.randn(b, lq, h, d, device="cuda", generator=gen)
    return [t.to(dtype) for t in (q, k, v, g)]


def _sdpa_library(q, k, v, causal, valid=None, rate=0.0):
    """The PyTorch call computing the same function (timed as library_ms
    only; the port never calls it): scaled_dot_product_attention on the
    [B, H, L, D] views with GQA, ``valid`` the boolean mask of the attended
    pairs where lengths or segments mask some (causal folded in), and
    dropout_p ``rate``."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=valid, dropout_p=rate, is_causal=causal and valid is None,
        enable_gqa=True)


def phase_compare_fa():
    """flash_attention_fwd vs its plain version: LLaMA-7B's scoring shape
    [2, 2048, 32, 128] and training shape [4, 2048, 32, 128] (bf16,
    causal), GQA (32 q heads on 8 KV heads), multi-query (4 on 1), fp32
    ragged Lq = 200, Lk = 300, D = 64 (GQA 4 on 2), causal and
    bidirectional, and the head sizes 80, 96, 256 and 72 (padded to 80) in
    bf16 [2, 1024, 8 on 2] and fp32 ragged. Inputs as [compare]. The limit on each output element
    is [compare]'s, atol 4e-3 + rtol 1e-2 in bf16 (1e-4 in fp32), with
    atol multiplied by the probability-weighted |v| the element sums over
    where that exceeds 1 (the plain version on |v| computes it): the
    kernel rounds p to bf16 against a running row max and the plain
    version against the final one, and that error is a share of p, so it
    scales with the |v| it multiplies, not with |out|, which cancels. At
    [2, 1024] GPT-medium shapes the weight stays near 1; over the 33.5M
    outputs of [4, 2048, 32, 128] one element read 4% over the unscaled
    limit (the first reading on an H100). lse within 1e-3. Each case is
    timed beside its plain version, the library call (where its causal
    alignment is the kernel's, Lq == Lk) and the bound. Rate 0, no lengths
    or segments: the code of the kernels before those were added, whose
    errors these must repeat."""
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention_fwd, flash_attention_fwd_reference)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)
    for case in FA_CASES:
        b, lq, lk, h, hkv, d, dtype, causal = case
        q, k, v, _ = _fa_inputs(b, lq, lk, h, hkv, d, dtype, gen)
        out, lse = flash_attention_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_attention_fwd_reference(q, k, v, causal)
        atol, rtol = (4e-3, 1e-2) if dtype == torch.bfloat16 else (1e-4,
                                                                    1e-4)
        # the probability-weighted |v| each output element sums over: the
        # scale of the error from rounding p (see the docstring)
        weight = flash_attention_fwd_reference(q, k, v.abs(),
                                               causal)[0].float()
        limit = atol * weight.clamp_min(1.0) + rtol * ref_out.float().abs()
        diff = (out.float() - ref_out.float()).abs()
        err = diff.max().item()
        of_limit = (diff / limit).max().item()
        if not of_limit <= 1.0:
            raise AssertionError(f"flash_attention_fwd at {case}: max|out "
                                 f"err| {err:.3g} is {of_limit:.3f} of the "
                                 f"limit")
        torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-3)
        lse_err = (lse - ref_lse).abs().max().item()
        del weight, limit
        ms = cuda_time_ms(lambda: flash_attention_fwd(q, k, v, causal))
        plain_ms = cuda_time_ms(
            lambda: flash_attention_fwd_reference(q, k, v, causal), iters=3,
            warmup=1)
        library_ms = cuda_time_ms(lambda: _sdpa_library(q, k, v, causal)) \
            if lq == lk else None
        bound_ms, bound_by = fa_bound_ms(b, lq, lk, h, hkv, d, dtype, causal)
        lib = f"{library_ms:.4f} ms" if library_ms is not None else "n/a"
        log(f"[compare-fa] flash_attention_fwd B={b} Lq={lq} Lk={lk} H={h} "
            f"Hkv={hkv} D={d} {str(dtype)[6:]} causal={causal}: max|out "
            f"err| {err:.3g}, {of_limit:.3f} of the limit (atol {atol}, "
            f"rtol {rtol}); max|lse err| {lse_err:.3g}; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, sdpa {lib}, bound {bound_ms:.4f} ms "
            f"({bound_by})")
        del q, k, v, out, lse, ref_out, ref_lse, diff
        torch.cuda.empty_cache()


def phase_compare_fa_bwd():
    """flash_attention_bwd vs its plain version at the shapes of
    [compare-fa]: per part (dq, dk, dv) the relative Frobenius error
    (limits FA_BWD_REL_LIMIT) and dq, dk and dv equal bit for bit between
    two launches. At the
    training shape and at heads of 80, 96 (csrc/flash_bwd_sm90.cuh on
    32-byte swizzle blocks) and 256 (the wide body), bf16, it then times
    the kernel beside the plain version, torch.autograd.grad through the
    library call and the bound. Returns the record of the bf16 D = 80 case
    (the kernels line's entry of that body)."""
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_reference,
        flash_attention_fwd, flash_attention_fwd_reference)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    record = None
    for case in FA_CASES:
        b, lq, lk, h, hkv, d, dtype, causal = case
        q, k, v, g = _fa_inputs(b, lq, lk, h, hkv, d, dtype, gen)
        out, lse = flash_attention_fwd(q, k, v, causal)
        got = flash_attention_bwd(q, k, v, out, lse, g, causal)
        again = flash_attention_bwd(q, k, v, out, lse, g, causal)
        torch.cuda.synchronize()
        limit = FA_BWD_REL_LIMIT[dtype]
        if _exact(dtype, d):
            q64, k64, v64, g64 = (t.double() for t in (q, k, v, g))
            o64, l64 = flash_attention_fwd_reference(q64, k64, v64, causal)
            want = flash_attention_bwd_reference(q64, k64, v64, o64, l64,
                                                 g64, causal)
            limit = BIG_D_FP32_REL_LIMIT
        else:
            want = flash_attention_bwd_reference(q, k, v, out, lse, g, causal)
        parts, worst_abs = [], 0.0
        for part, x, y in zip(("dq", "dk", "dv"), got, want):
            rel = rel_err(x, y)
            mx = (x.float() - y.float()).abs().max().item()
            worst_abs = max(worst_abs, mx)
            parts.append(f"{part} rel {rel:.3g} max|err| {mx:.3g}")
            if not rel < limit:
                raise AssertionError(
                    f"flash_attention_bwd {part} at {case}: relative error "
                    f"{rel:.3g} >= {limit}")
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError("flash_attention_bwd: dq, dk or dv differ "
                                 "between two launches on the same inputs")
        log(f"[compare-fa-bwd] flash_attention_bwd B={b} Lq={lq} Lk={lk} "
            f"H={h} Hkv={hkv} D={d} {str(dtype)[6:]} causal={causal}: "
            f"{'; '.join(parts)} (limit rel {limit}"
            f"{EXACT_NOTE if _exact(dtype, d) else ''}); two launches bit "
            f"for bit")
        if case == FA_TRAIN_CASE or (dtype == BF16 and d in (80, 96, 256)):
            ms = cuda_time_ms(
                lambda: flash_attention_bwd(q, k, v, out, lse, g, causal),
                iters=10)
            plain_ms = cuda_time_ms(
                lambda: flash_attention_bwd_reference(q, k, v, out, lse, g,
                                                      causal),
                iters=3, warmup=1)
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            o = _sdpa_library(*leaves, causal)
            library_ms = cuda_time_ms(lambda: torch.autograd.grad(
                o, leaves, g.transpose(1, 2), retain_graph=True))
            bound_ms, bound_by = fa_bound_ms(b, lq, lk, h, hkv, d, dtype,
                                             causal, backward=True)
            log(f"[compare-fa-bwd] at [{b}, {lq}, {h}, {d}]: kernel {ms:.4f} "
                f"ms, plain {plain_ms:.4f} ms, sdpa backward "
                f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
            if dtype == BF16 and d == 80:
                record = dict(max_abs_err=worst_abs, ms=ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by,
                              library_ms=library_ms)
            del leaves, o
        del q, k, v, g, out, lse, got, again, want
        torch.cuda.empty_cache()
    return record


def phase_llama_scoring(model):
    """The uncached scoring forward of LLaMA-7B (32 blocks) at [2, 2048]:
    finite logits of the right shape and exactly one flash_attention_fwd
    launch per block."""
    from paddle_tpu_torch.kernels import launch_counts
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    ids = torch.randint(0, LLAMA_7B["vocab_size"], (2, 2048), device="cuda",
                        generator=gen)
    before = launch_counts()
    with torch.no_grad():
        logits = model(ids)
    torch.cuda.synchronize()
    blocks = LLAMA_7B["num_layers"]
    _expect_launches("[llama-scoring]", _grew(before, launch_counts()),
                     flash_attention_fwd=blocks)
    if logits.shape != (2, 2048, LLAMA_7B["vocab_size"]):
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite scoring logits")
    log(f"[llama-scoring] logits {tuple(logits.shape)} finite; {blocks} "
        f"flash_attention_fwd launches per forward")
    return ids


def _llama_requests():
    """[llama-engine]'s 8 requests: a shared 16-token prefix + random
    tokens, 16-96 prompt tokens, 32 new each."""
    gen = torch.Generator()
    gen.manual_seed(13)
    vocab = LLAMA_7B["vocab_size"]
    prefix = torch.randint(0, vocab, (16,), generator=gen).tolist()
    prompts = [prefix + torch.randint(0, vocab, (n - 16,),
                                      generator=gen).tolist()
               for n in (96, 88, 16, 24, 40, 56, 72, 80)]
    return prompts, [32] * len(prompts)


def phase_llama_engine(model, tag="[llama-engine]", eager=False):
    """[llama-engine]'s 8 requests through the paged engine at the ENGINE
    geometry, invariants checked after every step; ``eager`` runs its
    steps eagerly (the reference of [llama-engine-graph]), else they are
    captured at their first call. Returns the requests and the eager
    record (tokens/s, peaks)."""
    from paddle_tpu_torch.serving import DecodeEngine
    prompts, new_tokens = _llama_requests()
    torch.cuda.empty_cache()
    eng = DecodeEngine(model, **ENGINE)
    eng._programs.capture = not eager
    reqs, steps, wall, peak, reserved = _serve(eng, prompts, new_tokens)
    st = eng.stats()
    if st["paged"]["shared_hits"] < 1:
        raise AssertionError(f"prefix sharing was not hit: {st['paged']}")
    rate = st["tokens_generated"] / wall
    log(f"{tag} {'eager' if eager else 'graphed'} steps: {len(reqs)} "
        f"requests done in {steps} steps, {wall:.3f} s: "
        f"{st['tokens_generated']} tokens, {rate:.1f} tokens/s"
        f"{'' if eager else ' (captures included)'}; "
        f"{st['decode_steps']} decode steps, {st['prefill_calls']} chunk "
        f"calls; shared_hits {st['paged']['shared_hits']}; peak memory "
        f"{peak:.2f} GB (reserved {reserved:.2f} GB)")
    return reqs, dict(rate=rate, peak=peak, reserved=reserved)


def phase_llama_crosscheck(model, reqs, tag="[llama-crosscheck]"):
    """The engine's greedy tokens against the uncached forward through the
    flash kernel: every request's prompt + tokens, right-padded to 128
    (causal attention: the padding changes no earlier position), in one
    [8, 128] forward. Over all generated positions the argmax agrees at
    CROSSCHECK_FLOOR or more and every disagreement is a near-tie (logit
    gap <= CROSSCHECK_GAP), in the model's type: bf16 rounds differently
    in the paged cached path (fp32 softmax) and in the kernel; fp32 leaves
    summation order."""
    from paddle_tpu_torch.models.gpt import _lm_head_logits
    dtype = model.head_weight.dtype
    width = max(128, max(len(r.prompt) + len(r.tokens) for r in reqs))
    ids = torch.zeros(len(reqs), width, dtype=torch.long)
    for i, r in enumerate(reqs):
        seq = r.prompt + r.tokens
        ids[i, :len(seq)] = torch.tensor(seq)
    with torch.no_grad():
        hidden = model.model(ids.cuda())
    agree, total, worst, gaps = 0, 0, 0.0, []
    for i, r in enumerate(reqs):
        n = len(r.prompt)
        logits = _lm_head_logits(hidden[i, n - 1:n - 1 + len(r.tokens)],
                                 model.head_weight)
        want = torch.tensor(r.tokens, device="cuda")
        top = logits.argmax(dim=-1)
        agree += int((top == want).sum())
        total += len(r.tokens)
        miss = (logits.gather(1, top[:, None])
                - logits.gather(1, want[:, None]))[:, 0]
        worst = max(worst, miss.max().item())
        two = logits.topk(2, dim=-1).values
        gaps.append(two[:, 0] - two[:, 1])
    median_gap = torch.cat(gaps).median().item()
    # witness: the same positions through the plain route (flash gate
    # closed), so the spread between two uncached routes is on record
    from paddle_tpu_torch.nn.functional import attention
    gate = attention.flash_path_available
    attention.flash_path_available = lambda *a, **kw: False
    try:
        with torch.no_grad():
            plain_hidden = model.model(ids.cuda())
    finally:
        attention.flash_path_available = gate
    same, spread = 0, []
    for i, r in enumerate(reqs):
        n, k = len(r.prompt), len(r.tokens)
        a = _lm_head_logits(hidden[i, n - 1:n - 1 + k], model.head_weight)
        b = _lm_head_logits(plain_hidden[i, n - 1:n - 1 + k],
                            model.head_weight)
        same += int((a.argmax(-1) == b.argmax(-1)).sum())
        spread.append((a - b).abs().mean(dim=-1))
    log(f"{tag} witness, the uncached forward through the kernel vs the "
        f"plain route at the same positions: argmax agreement "
        f"{same / total:.3f}, mean |logit difference| "
        f"{torch.cat(spread).mean().item():.4f}")
    log(f"{tag} {str(dtype)[6:]}, {total} generated positions of "
        f"{len(reqs)} requests: argmax agreement {agree / total:.3f} "
        f"(floor {CROSSCHECK_FLOOR[dtype]}), largest logit gap at a "
        f"disagreement {worst:.4f} (limit {CROSSCHECK_GAP[dtype]}); median "
        f"top-1/top-2 gap {median_gap:.4f}")
    if agree / total < CROSSCHECK_FLOOR[dtype] \
            or worst > CROSSCHECK_GAP[dtype]:
        raise AssertionError("engine tokens disagree with the uncached "
                             "forward beyond near-ties")


def phase_llama_engine_fp32():
    """The engine computes the uncached function on the card: LLaMA-7B
    width with 2 blocks and GQA (32 q heads on 8 KV heads) in fp32, the
    requests of [llama-engine] through captured steps, then
    [llama-crosscheck] at the fp32 limits (the argmax agrees at >= 0.99
    of positions). Returns the model, the requests and their record
    ([llama-engine-spec-fp32]'s reference)."""
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_7b
    model = LlamaForCausalLM(llama_7b(num_layers=2, num_kv_heads=8),
                             seed=16).eval()
    reqs, record = phase_llama_engine(model, tag="[llama-engine-fp32]")
    phase_llama_crosscheck(model, reqs, tag="[llama-crosscheck-fp32]")
    return model, reqs, record


def phase_llama_scoring_time(model, ids):
    """Device time of one LLaMA-7B scoring forward at [2, 2048] (outside
    the main path's launch count)."""
    with torch.no_grad():
        fwd_ms = cuda_time_ms(lambda: model(ids), iters=3, warmup=1)
    log(f"[llama-scoring] forward [2, 2048], 32 blocks: {fwd_ms:.2f} ms")


def phase_llama_train():
    """LLaMA-7B at full width cut to LLAMA_TRAIN["layers"] blocks (bf16
    params + grads, fp32 masters and two moments: 16 bytes a parameter,
    so 32 blocks would need ~108 GB), AdamW(1e-4, wd 0.01,
    multi_precision=True), TrainStep, one fixed random batch of
    LLAMA_TRAIN["batch"] x LLAMA_TRAIN["seq"], 1 warm-up + timed steps.
    Every loss is finite, the first is near ln(vocab) (random logits of
    std ~1.3 add ~sigma^2 / 2 ~ 0.8: within LOSS0_SLACK) and the last is
    below the first; each step launches both flash_attention kernels once
    per block and nothing else; every parameter equals its fp32 master
    cast to bf16."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import launch_counts
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_7b
    from paddle_tpu_torch.optimizer import AdamW
    blocks = LLAMA_TRAIN["layers"]
    t0 = time.perf_counter()
    model = LlamaForCausalLM(llama_7b(num_layers=blocks),
                             dtype=torch.bfloat16, seed=0)
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.parameters(), multi_precision=True)
    step = TrainStep(model, opt, fast_path=False)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    b, L = LLAMA_TRAIN["batch"], LLAMA_TRAIN["seq"]
    ids = torch.randint(0, LLAMA_7B["vocab_size"], (b, L), device="cuda",
                        generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    log(f"[llama-train] llama_7b(num_layers={blocks}) {n_params / 1e9:.3f} B "
        f"params bf16 + AdamW(multi_precision) built in "
        f"{time.perf_counter() - t0:.1f} s; batch {b} x {L}")
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for i in range(1 + LLAMA_TRAIN["steps"]):
        before = launch_counts()
        t0 = time.perf_counter()
        loss = step(ids, ids)
        losses.append(loss.item())              # synchronises
        walls.append(time.perf_counter() - t0)
        _expect_launches(f"[llama-train] step {i}",
                         _grew(before, launch_counts()),
                         flash_attention_fwd=blocks,
                         flash_attention_bwd=blocks)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    ln_v = math.log(LLAMA_7B["vocab_size"])
    if not abs(losses[0] - ln_v) < LOSS0_SLACK:
        raise AssertionError(f"first loss {losses[0]:.4f} is not near "
                             f"ln(vocab) = {ln_v:.4f}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall on a repeated batch: "
                             f"{losses}")
    for p in model.parameters():
        master = opt._master_weights[id(p)]
        if master.dtype != torch.float32 or not torch.equal(
                p, master.to(torch.bfloat16)):
            raise AssertionError("a parameter is not its fp32 master cast "
                                 "to bf16")
    fresh = torch.randint(0, LLAMA_7B["vocab_size"], (b, L), device="cuda",
                          generator=gen)
    with torch.no_grad():
        fresh_loss = model(fresh, fresh)[1].item()
    timed = walls[1:]
    wall = sum(timed) / len(timed)
    log(f"[llama-train] losses {[round(x, 4) for x in losses]} (ln vocab "
        f"{ln_v:.4f}); loss on a fresh batch after the steps "
        f"{fresh_loss:.4f} (the repeated batch is memorised)")
    log(f"[llama-train] {len(timed)} timed steps: wall per step "
        f"{wall * 1e3:.1f} ms (min {min(timed) * 1e3:.1f}, max "
        f"{max(timed) * 1e3:.1f}; warm-up {walls[0] * 1e3:.1f}), "
        f"{b * L / wall:.0f} tokens/s; {blocks} + {blocks} flash_attention "
        f"launches per step; peak memory {peak_gb:.2f} GB")
    return model, opt, ids, losses


def phase_llama_train_plain(losses):
    """A witness for [llama-train]'s loss curve: the same recipe, batch
    and steps with attention's forward and backward in their plain
    versions (``_PlainFlashAttention`` in place of ``FlashAttention``; no
    kernel launches). Every step's loss agrees with [llama-train]'s within
    TRAIN_PLAIN_LOSS_LIMIT, so the curve's shape comes from the recipe."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import launch_counts
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_7b
    from paddle_tpu_torch.nn.functional import attention
    from paddle_tpu_torch.optimizer import AdamW
    model = LlamaForCausalLM(llama_7b(num_layers=LLAMA_TRAIN["layers"]),
                             dtype=torch.bfloat16, seed=0)
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.parameters(), multi_precision=True)
    step = TrainStep(model, opt, fast_path=False)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    ids = torch.randint(0, LLAMA_7B["vocab_size"],
                        (LLAMA_TRAIN["batch"], LLAMA_TRAIN["seq"]),
                        device="cuda", generator=gen)
    kernel_path = attention.FlashAttention
    attention.FlashAttention = _PlainFlashAttention
    try:
        before = launch_counts()
        plain = [step(ids, ids).item() for _ in losses]
        after = launch_counts()
    finally:
        attention.FlashAttention = kernel_path
    if after != before:
        raise AssertionError(f"the plain run launched kernels: {before} -> "
                             f"{after}")
    diff = max(abs(x - y) for x, y in zip(losses, plain))
    log(f"[llama-train-plain] losses {[round(x, 4) for x in plain]}; "
        f"largest |kernel - plain| over the {len(plain)} steps {diff:.3g} "
        f"(limit {TRAIN_PLAIN_LOSS_LIMIT})")
    if not diff < TRAIN_PLAIN_LOSS_LIMIT:
        raise AssertionError("the kernel path's loss curve departs from the "
                             "plain path's on the same recipe")


def phase_profile_llama_train(model, opt, ids):
    """One training step of the [llama-train] model under torch.profiler:
    the device busy share, the share of the two flash_attention kernels
    and the six kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.jit import TrainStep
    step = TrainStep(model, opt, fast_path=False)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(ids, ids).item()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    flash_us = sum(e.self_device_time_total for e in kernels
                   if _is_flash_kernel(e.key))
    log(f"[profile-llama-train] one step, profiler on: {wall * 1e3:.1f} ms "
        f"wall, device busy {busy_us / 1e3:.1f} ms = "
        f"{busy_us / 1e6 / wall:.3f} of wall; flash_attention kernels "
        f"{flash_us / 1e3:.1f} ms = {flash_us / max(busy_us, 1.0):.3f} of "
        f"device time")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"[profile-llama-train]   {e.self_device_time_total / 1e3:8.2f} "
            f"ms x{e.count:5d}  {e.key[:90]}")


def phase_llama_train_check():
    """LLaMA-7B width with 2 blocks and GQA (32 q heads on 8 KV heads) in
    fp32, [1, 256], some labels ignored: the card (through both
    flash_attention kernels) against the plain CPU path on the same
    weights (``_card_vs_cpu``); the KV projections' gradients carry the
    kernel's sum over each group of 4 q heads."""
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_7b
    cfg = llama_7b(num_layers=2, num_kv_heads=8)
    gen = torch.Generator()
    gen.manual_seed(15)
    ids = torch.randint(0, cfg.vocab_size, (1, 256), generator=gen)
    labels = ids.clone()
    labels[:, :16] = -100
    rels = _card_vs_cpu(
        "[llama-train-check] fp32, 2 blocks, GQA 32/8, [1, 256]:",
        lambda dev: LlamaForCausalLM(cfg, device=dev, seed=7), (ids, labels),
        dict(flash_attention_fwd=2, flash_attention_bwd=2))
    kv_worst = max(v for k, v in rels.items()
                   if k.endswith(("k_proj.weight", "v_proj.weight")))
    log(f"[llama-train-check] worst k/v projection gradient rel "
        f"{kv_worst:.3g}")


# ------------------------------------------------- dropout kernels, BERT


def _bound(nbytes, flops, dtype):
    """The larger of bytes over the memory rate and operations over the
    peak rate of the type, in ms, and which of the two it is."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def _nonzero_randn(shape, dtype, gen):
    """N(0, 1) on the card in ``dtype`` with no exact zero (a zero input
    would read as a dropped element)."""
    x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    return torch.where(x == 0, torch.ones_like(x), x)


def phase_compare_dropout():
    """dropout_fwd against its plain version at BERT's embedding output
    [64, 512, 768], bf16 and fp32, rates 0.1 and 0.5, on the same seed:
    the kernel's zero pattern is the plain Philox keep mask (zero
    mismatches), the values are equal bit for bit, the keep share lies
    within 5 sigma of 1 - rate, and the backward launch (the same kernel
    on a cotangent with the forward's seed) drops exactly the forward's
    elements. Each case is timed beside the plain version,
    torch.nn.functional.dropout (library_ms only) and the bound (each
    element read and written once). Returns the main path's record (bf16,
    rate 0.1)."""
    from paddle_tpu_torch.kernels import philox
    from paddle_tpu_torch.kernels.dropout import (dropout_fwd,
                                                  dropout_fwd_reference)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20)
    shape = (64, 512, 768)
    rows, cols = shape[0] * shape[1], shape[2]
    record = None
    for dtype in (BF16, FP32):
        x = _nonzero_randn(shape, dtype, gen)
        g = _nonzero_randn(shape, dtype, gen)
        for rate in (0.1, 0.5):
            seed = 0x123456789 + int(rate * 10)
            out = dropout_fwd(x, seed, rate)
            back = dropout_fwd(g, seed, rate)
            torch.cuda.synchronize()
            ref = dropout_fwd_reference(x, seed, rate)
            keep = philox.row_keep(seed, philox.SALT_DROPOUT, rows, cols,
                                   rate, "cuda").reshape(shape)
            mism = int(((out != 0) != keep).sum())
            back_mism = int(((back != 0) != (out != 0)).sum())
            err = (out.float() - ref.float()).abs().max().item()
            share = keep.float().mean().item()
            sigma = math.sqrt(rate * (1 - rate) / keep.numel())
            z = (share - (1 - rate)) / sigma
            ms = cuda_time_ms(lambda: dropout_fwd(x, seed, rate))
            plain_ms = cuda_time_ms(
                lambda: dropout_fwd_reference(x, seed, rate), iters=3,
                warmup=1)
            library_ms = cuda_time_ms(
                lambda: torch.nn.functional.dropout(x, rate))
            esize = x.element_size()
            bound_ms, bound_by = _bound(2 * x.numel() * esize, x.numel(),
                                        FP32)
            log(f"[compare-dropout] dropout_fwd {list(shape)} "
                f"{str(dtype)[6:]} rate {rate}: keep-mask mismatches {mism}, "
                f"backward mismatches {back_mism}, max|err| {err:.3g}; keep "
                f"share {share:.6f} ({z:+.2f} sigma); kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, F.dropout {library_ms:.4f} ms, "
                f"bound {bound_ms:.4f} ms ({bound_by})")
            if mism or back_mism or not torch.equal(out, ref) \
                    or abs(z) > 5.0:
                raise AssertionError("dropout_fwd disagrees with its plain "
                                     "version")
            if dtype == BF16 and rate == 0.1:
                record = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by,
                              library_ms=library_ms)
            del out, back, ref, keep
        del x, g
        torch.cuda.empty_cache()
    return record


def _bf16_ulp(x):
    """One bf16 ulp of |x| (elementwise; 0 at 0)."""
    a = x.float().abs()
    e = torch.floor(torch.log2(a.clamp_min(1e-30)))
    return torch.where(a > 0, torch.exp2(e - 7), 0.0)


def phase_compare_fused_ln():
    """fused_add_dropout_ln_fwd/_bwd against their plain versions at
    BERT-base's [32768, 768] rows, bf16 and fp32, rates 0 and 0.1, on the
    same seed (x, sub, dy ~ N(0, 1), w ~ 1 + N(0, 0.1^2), b ~ N(0,
    0.1^2), eps 1e-12). Gates: d(sub) is zero exactly where the plain
    Philox mask drops (zero mismatches); out within one bf16 ulp of |out|
    + 1e-5 (fp32: 1e-5 + 1e-5 |out|): the two sum a row in other orders,
    which can move a value across a rounding boundary; mean within 1e-6 +
    1e-5 |mean| and rstd within 1e-5 relative; the relative Frobenius
    error of each of dx, d(sub), dw, db under FUSED_BWD_REL_LIMIT. Each
    is timed beside its plain version, the composition
    F.layer_norm(x + F.dropout(sub)) (library_ms: forward, and
    torch.autograd.grad through it) and the bound. Returns the records of
    the main path's case (bf16, rate 0.1): (forward, backward)."""
    from paddle_tpu_torch.kernels import philox
    from paddle_tpu_torch.kernels.fused_residual import (
        fused_add_dropout_ln_bwd, fused_add_dropout_ln_bwd_reference,
        fused_add_dropout_ln_fwd, fused_add_dropout_ln_fwd_reference)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    n, h, eps = 64 * 512, 768, 1e-12
    records = None
    for dtype in (BF16, FP32):
        x = torch.randn(n, h, device="cuda", generator=gen).to(dtype)
        sub = torch.randn(n, h, device="cuda", generator=gen).to(dtype)
        w = (1 + 0.1 * torch.randn(h, device="cuda", generator=gen)).to(dtype)
        b = (0.1 * torch.randn(h, device="cuda", generator=gen)).to(dtype)
        dy = torch.randn(n, h, device="cuda", generator=gen).to(dtype)
        for rate in (0.0, 0.1):
            seed = 0xFEEDBEEF + int(rate * 10)
            out, stats = fused_add_dropout_ln_fwd(x, sub, w, b, seed, rate,
                                                  eps)
            got = fused_add_dropout_ln_bwd(x, sub, w, stats, dy, seed, rate,
                                           eps)
            torch.cuda.synchronize()
            r_out, r_stats = fused_add_dropout_ln_fwd_reference(
                x, sub, w, b, seed, rate, eps)
            want = fused_add_dropout_ln_bwd_reference(x, sub, w, r_stats, dy,
                                                      seed, rate, eps)
            keep = philox.row_keep(seed, philox.SALT_FUSED_LN, n, h, rate,
                                   "cuda") if rate > 0 else \
                torch.ones(n, h, dtype=torch.bool, device="cuda")
            mism = int(((got[1] != 0) != keep).sum())
            diff = (out.float() - r_out.float()).abs()
            if dtype == BF16:
                limit = _bf16_ulp(r_out) + 1e-5
            else:
                limit = 1e-5 + 1e-5 * r_out.abs()
            of_limit = (diff / limit).max().item()
            mean_err = ((stats[0] - r_stats[0]).abs()
                        / (1e-6 + 1e-5 * r_stats[0].abs())).max().item()
            rstd_rel = ((stats[1] - r_stats[1]).abs()
                        / r_stats[1].abs()).max().item()
            rels = {name: rel_err(a, c) for name, a, c in
                    zip(("dx", "dsub", "dw", "db"), got, want)}
            bwd_abs = max((a.float() - c.float()).abs().max().item()
                          for a, c in zip(got[:2], want[:2]))

            def library_fwd():
                return torch.nn.functional.layer_norm(
                    x + torch.nn.functional.dropout(sub, rate), (h,), w, b,
                    eps)
            leaves = [t.detach().requires_grad_() for t in (x, sub, w, b)]
            lib_out = torch.nn.functional.layer_norm(
                leaves[0] + torch.nn.functional.dropout(leaves[1], rate),
                (h,), leaves[2], leaves[3], eps)
            ms = cuda_time_ms(lambda: fused_add_dropout_ln_fwd(
                x, sub, w, b, seed, rate, eps))
            bwd_ms = cuda_time_ms(lambda: fused_add_dropout_ln_bwd(
                x, sub, w, stats, dy, seed, rate, eps))
            plain_ms = cuda_time_ms(lambda: fused_add_dropout_ln_fwd_reference(
                x, sub, w, b, seed, rate, eps), iters=3, warmup=1)
            plain_bwd_ms = cuda_time_ms(
                lambda: fused_add_dropout_ln_bwd_reference(
                    x, sub, w, r_stats, dy, seed, rate, eps), iters=3,
                warmup=1)
            lib_ms = cuda_time_ms(library_fwd)
            lib_bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(
                lib_out, leaves, dy, retain_graph=True))
            es = x.element_size()
            fwd_bound = _bound(3 * n * h * es + 2 * h * es + 2 * n * 4,
                               10.0 * n * h, FP32)
            bwd_bound = _bound(5 * n * h * es + 3 * h * es + 2 * n * 4,
                               20.0 * n * h, FP32)
            tag = f"[compare-fused-ln] [{n}, {h}] {str(dtype)[6:]} rate {rate}"
            log(f"{tag}: keep-mask mismatches {mism}; out {of_limit:.3f} of "
                f"the limit (max|err| {diff.max().item():.3g}); mean "
                f"{mean_err:.3f} of its limit, rstd rel {rstd_rel:.3g}; "
                + ", ".join(f"{k} rel {v:.3g}" for k, v in rels.items())
                + f" (limit {FUSED_BWD_REL_LIMIT[dtype]})")
            log(f"{tag}: forward {ms:.4f} ms (plain {plain_ms:.4f}, "
                f"composition {lib_ms:.4f}, bound {fwd_bound[0]:.4f} ms "
                f"{fwd_bound[1]}); backward {bwd_ms:.4f} ms (plain "
                f"{plain_bwd_ms:.4f}, composition autograd {lib_bwd_ms:.4f}, "
                f"bound {bwd_bound[0]:.4f} ms {bwd_bound[1]})")
            if mism or not of_limit <= 1.0 or not mean_err <= 1.0 \
                    or not rstd_rel <= 1e-5 \
                    or max(rels.values()) >= FUSED_BWD_REL_LIMIT[dtype]:
                raise AssertionError("the fused add-dropout-LayerNorm "
                                     "kernels disagree with their plain "
                                     "versions")
            if dtype == BF16 and rate == 0.1:
                records = (dict(max_abs_err=diff.max().item(), ms=ms,
                                plain_ms=plain_ms, bound_ms=fwd_bound[0],
                                bound_by=fwd_bound[1], library_ms=lib_ms),
                           dict(max_abs_err=bwd_abs, ms=bwd_ms,
                                plain_ms=plain_bwd_ms, bound_ms=bwd_bound[0],
                                bound_by=bwd_bound[1],
                                library_ms=lib_bwd_ms))
            del out, stats, got, r_out, r_stats, want, keep, diff, limit
            del leaves, lib_out
        del x, sub, w, b, dy
        torch.cuda.empty_cache()
    return records


def _attn_mask_probe(b, L, h, d, causal, seed, rate, dtype=BF16):
    """Read the pair kernels' keep masks back off the card and count where
    they differ from ``philox.attention_keep`` over the attended pairs.

    With q = k = 0 every score is 0, so p = 1 in the forward (l = the
    number of visible keys) and p = 1 / l in the backward. Probe t sets v
    of key t*d + e to the unit vector e in every head: out[i, e] is then
    the dropped-and-rounded p of key t*d + e over l, zero exactly where
    the kernel drops it. In the backward, dO of row t*d + e is the unit
    vector e, so dv[j, e] is round(p * keep_factor) of pair (t*d + e, j).
    L / d probes of each cover every pair. Returns (forward mismatches,
    backward mismatches, attended pairs)."""
    from paddle_tpu_torch.kernels import philox
    from paddle_tpu_torch.kernels.flash_pair import (flash_pair_bwd,
                                                     flash_pair_fwd)
    hd = h * d
    want = philox.attention_keep(seed, b, h, L, L, rate, "cuda")
    visible = torch.ones(L, L, dtype=torch.bool, device="cuda")
    if causal:
        visible = visible.tril()
    e = torch.arange(d, device="cuda")
    heads = torch.arange(h, device="cuda")[:, None] * d + e[None, :]  # [h, d]
    fwd_m = bwd_m = 0
    for t in range(L // d):
        rows = (t * d + e)[None, :].expand(h, d)
        qkv = torch.zeros(b, L, 3 * hd, dtype=dtype, device="cuda")
        qkv[:, rows, 2 * hd + heads] = 1.0
        out, lse = flash_pair_fwd(qkv, h, causal, rate, seed)
        got = out.view(b, L, h, d).permute(0, 2, 1, 3) != 0  # [b, h, i, e]
        sl = slice(t * d, (t + 1) * d)
        fwd_m += int(((got != want[..., sl]) & visible[:, sl]).sum())
        dout = torch.zeros(b, L, hd, dtype=dtype, device="cuda")
        dout[:, rows, heads] = 1.0
        dqkv = flash_pair_bwd(qkv, out, lse, dout, h, causal, rate, seed)
        dv = dqkv[..., 2 * hd:].view(b, L, h, d).permute(0, 2, 3, 1) != 0
        bwd_m += int(((dv != want[:, :, sl, :]) & visible[sl, :]).sum())
        del qkv, out, lse, dout, dqkv, got, dv
    return fwd_m, bwd_m, int(visible.sum()) * b * h


def phase_compare_dropout_attn():
    """The pair kernels with dropout against their plain versions on the
    same seed: BERT's shape [64, 512, 3*12*64] bidirectional (new to the
    table: first at rate 0, then 0.1), GPT-medium's training shape [16,
    1024, 3*8*128] causal at 0.1 and heads of 384 on the wide kernels [2,
    768, 3*2*384] causal at 0.1, bf16, and in fp32 (the fp32 wide kernels).
    The limits of [compare-fa] (out: atol 4e-3 times the
    probability-weighted |v| where that exceeds 1, + rtol 1e-2; fp32 1e-4
    and 1e-4; lse) and [compare-bwd] (relative Frobenius error per part,
    fp32 above D = 256 against the exact gradient; dk/dv equal between
    launches). The weighted form is needed here: the
    error is each rounded p * keep_factor times its v, and a kept pair
    carries 1 / (1 - rate) = 1.11 of its p, so the weight passes 1 where
    [compare]'s unweighted atol assumed it would not (the first reading at
    BERT's shape, unweighted: 1.36 of the limit, one bf16 rounding of a
    kept 1.11 p times a |v| near 1.4). The keep masks read
    back from both kernels
    (``_attn_mask_probe``) match the plain Philox mask at every attended
    pair. Times beside the plain versions, scaled_dot_product_attention
    at the same dropout rate (forward, and autograd through it: library_ms
    only) and the bounds. Returns {(B, L, rate, dtype): (fwd ms, bwd
    ms)}."""
    from paddle_tpu_torch.kernels.flash_pair import (
        flash_pair_bwd, flash_pair_bwd_reference, flash_pair_fwd,
        flash_pair_fwd_reference)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(22)
    times = {}
    for b, L, h, d, causal, rates, dtype in (
            (64, 512, 12, 64, False, (0.0, 0.1), BF16),
            (16, 1024, 8, 128, True, (0.1,), BF16),
            (2, 768, 2, 384, True, (0.1,), BF16),
            (2, 768, 2, 384, True, (0.1,), FP32)):
        for rate in rates:
            seed = 0xABCDEF12345 if rate else None
            qkv, dout = _bwd_inputs(b, L, h, d, dtype, gen)
            out, lse = flash_pair_fwd(qkv, h, causal, rate, seed)
            got = flash_pair_bwd(qkv, out, lse, dout, h, causal, rate, seed)
            again = flash_pair_bwd(qkv, out, lse, dout, h, causal, rate, seed)
            torch.cuda.synchronize()
            ref_out, ref_lse = flash_pair_fwd_reference(qkv, h, causal, rate,
                                                        seed)
            limit = BWD_REL_LIMIT[dtype]
            if _exact(dtype, d):
                q64, g64 = qkv.double(), dout.double()
                o64, l64 = flash_pair_fwd_reference(q64, h, causal, rate,
                                                    seed)
                want = flash_pair_bwd_reference(q64, o64, l64, g64, h,
                                                causal, rate, seed)
                limit = BIG_D_FP32_REL_LIMIT
                del q64, g64, o64, l64
            else:
                want = flash_pair_bwd_reference(qkv, out, lse, dout, h,
                                                causal, rate, seed)
            atol, rtol = (4e-3, 1e-2) if dtype == BF16 else (1e-4, 1e-4)
            # the probability-weighted |v| of each output element, kept
            # pairs scaled by 1/(1 - rate): [compare-fa]'s atol scale
            absv = qkv.clone()
            absv[..., 2 * h * d:] = absv[..., 2 * h * d:].abs()
            weight = flash_pair_fwd_reference(absv, h, causal, rate,
                                              seed)[0].float()
            diff = (out.float() - ref_out.float()).abs()
            of_limit = (diff / (atol * weight.clamp_min(1.0)
                                + rtol * ref_out.float().abs())).max().item()
            del absv, weight
            lse_err = (lse - ref_lse).abs().max().item()
            lse_ok = bool(((lse - ref_lse).abs()
                           <= 1e-3 + 1e-3 * ref_lse.abs()).all())
            hd = h * d
            rels = [rel_err(got[..., i * hd:(i + 1) * hd],
                            want[..., i * hd:(i + 1) * hd]) for i in range(3)]
            stable = torch.equal(got[..., hd:], again[..., hd:])
            del ref_out, ref_lse, want, again
            probe = _attn_mask_probe(b, L, h, d, causal, seed, rate,
                                     dtype) if rate else (0, 0, 0)
            fwd_ms = cuda_time_ms(
                lambda: flash_pair_fwd(qkv, h, causal, rate, seed))
            bwd_ms = cuda_time_ms(
                lambda: flash_pair_bwd(qkv, out, lse, dout, h, causal, rate,
                                       seed), iters=10)
            plain_ms = cuda_time_ms(lambda: flash_pair_fwd_reference(
                qkv, h, causal, rate, seed), iters=3, warmup=1)
            plain_bwd_ms = cuda_time_ms(lambda: flash_pair_bwd_reference(
                qkv, out, lse, dout, h, causal, rate, seed), iters=3,
                warmup=1)
            leaf = qkv.detach().requires_grad_()
            q, k, v = (leaf[..., i * hd:(i + 1) * hd].view(b, L, h, d)
                       .transpose(1, 2) for i in range(3))

            def library():
                return torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, dropout_p=rate, is_causal=causal)
            lib_ms = cuda_time_ms(library)
            o = library()
            do = dout.view(b, L, h, d).transpose(1, 2)
            lib_bwd_ms = cuda_time_ms(
                lambda: torch.autograd.grad(o, leaf, do, retain_graph=True))
            fb = flash_bound_ms(b, L, h, d, dtype, causal)
            bb = flash_bwd_bound_ms(b, L, h, d, dtype, causal)
            tag = (f"[compare-dropout-attn] B={b} L={L} H={h} D={d} "
                   f"{str(dtype)[6:]} causal={causal} rate {rate}")
            log(f"{tag}: out {of_limit:.3f} of the limit (atol {atol}, rtol "
                f"{rtol}), max|lse err| {lse_err:.3g}; dq/dk/dv rel "
                f"{rels[0]:.3g}/{rels[1]:.3g}/{rels[2]:.3g} (limit "
                f"{limit}{EXACT_NOTE if _exact(dtype, d) else ''}); "
                f"keep-mask mismatches forward "
                f"{probe[0]}, backward {probe[1]} over {probe[2]} attended "
                f"pairs")
            log(f"{tag}: forward {fwd_ms:.4f} ms (plain {plain_ms:.4f}, sdpa "
                f"{lib_ms:.4f}, bound {fb[0]:.4f} ms {fb[1]}); backward "
                f"{bwd_ms:.4f} ms (plain {plain_bwd_ms:.4f}, sdpa backward "
                f"{lib_bwd_ms:.4f}, bound {bb[0]:.4f} ms {bb[1]})")
            if not (of_limit <= 1.0 and lse_ok and stable
                    and max(rels) < limit
                    and probe[0] == 0 and probe[1] == 0):
                raise AssertionError(f"{tag}: the pair kernels disagree with "
                                     f"their plain versions")
            times[(b, L, rate, dtype)] = (fwd_ms, bwd_ms)
            del qkv, dout, out, lse, got, leaf, q, k, v, o, do, diff
            torch.cuda.empty_cache()
    return times


class _PlainDropout(torch.autograd.Function):
    """``DropoutFunction`` with the kernel replaced by its plain version,
    for the kernel-free witness in ``phase_bert_train_plain``."""

    @staticmethod
    def forward(ctx, x, seed, rate, upscale=True):
        from paddle_tpu_torch.kernels.dropout import dropout_fwd_reference
        ctx.seed, ctx.rate, ctx.upscale = seed, rate, upscale
        return dropout_fwd_reference(x, seed, rate, upscale)

    @staticmethod
    def backward(ctx, dy):
        from paddle_tpu_torch.kernels.dropout import dropout_fwd_reference
        return (dropout_fwd_reference(dy.contiguous(), ctx.seed, ctx.rate,
                                      ctx.upscale), None, None, None)


class _PlainFusedLN(torch.autograd.Function):
    """``FusedAddDropoutLN`` with both kernels replaced by their plain
    versions."""

    @staticmethod
    def forward(ctx, x, sub, weight, bias, seed, rate, eps):
        from paddle_tpu_torch.kernels.fused_residual import (
            fused_add_dropout_ln_fwd_reference)
        h = x.shape[-1]
        x2, s2 = x.reshape(-1, h), sub.reshape(-1, h)
        out, stats = fused_add_dropout_ln_fwd_reference(x2, s2, weight, bias,
                                                        seed, rate, eps)
        ctx.save_for_backward(x2, s2, weight, stats)
        ctx.seed, ctx.rate, ctx.eps, ctx.shape = seed, rate, eps, x.shape
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, dout):
        from paddle_tpu_torch.kernels.fused_residual import (
            fused_add_dropout_ln_bwd_reference)
        x2, s2, weight, stats = ctx.saved_tensors
        dx, ds, dw, db = fused_add_dropout_ln_bwd_reference(
            x2, s2, weight, stats, dout.reshape(x2.shape), ctx.seed,
            ctx.rate, ctx.eps)
        return (dx.reshape(ctx.shape), ds.reshape(ctx.shape), dw, db, None,
                None, None)


class _plain_kernels:
    """Context manager: every autograd Function of the BERT paths
    (FlashPairPacked, FlashAttention, DropoutFunction, FusedAddDropoutLN)
    swapped for its plain twin in the functionals that call it."""

    def __enter__(self):
        from paddle_tpu_torch.nn.functional import attention, common, norm
        self._saved = [(attention, "FlashPairPacked", _PlainPairPacked),
                       (attention, "FlashAttention", _PlainFlashAttention),
                       (common, "DropoutFunction", _PlainDropout),
                       (norm, "FusedAddDropoutLN", _PlainFusedLN)]
        self._saved = [(mod, name, getattr(mod, name), plain)
                       for mod, name, plain in self._saved]
        for mod, name, _, plain in self._saved:
            setattr(mod, name, plain)
        return self

    def __exit__(self, *exc):
        for mod, name, kernel, _ in self._saved:
            setattr(mod, name, kernel)
        return False


def _bert_batch(b, s, seed, device="cuda"):
    """A pretraining batch from a CPU generator: token ids, token types
    (0 then 1 from a random split point per row), MLM labels on a random
    15% of positions (-100 elsewhere) and NSP labels. Returns the TrainStep
    inputs (ids, token_type_ids, attn_mask=None, masked_lm_labels,
    next_sentence_labels)."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    ids = torch.randint(0, BERT_BASE["vocab_size"], (b, s), generator=gen)
    split = torch.randint(s // 4, 3 * s // 4, (b, 1), generator=gen)
    types = (torch.arange(s)[None, :] >= split).long()
    masked = torch.rand(b, s, generator=gen) < 0.15
    mlm = torch.where(masked, ids, -100)
    nsp = torch.randint(0, 2, (b,), generator=gen)
    return tuple(t.to(device) if t is not None else None
                 for t in (ids, types, None, mlm, nsp))


def _bert_pad_lengths(b, s, seed):
    """Per-row lengths of a padded batch, made from ``seed`` with numpy:
    uniform in [32, s], row 0 at s and row 1 at 33 (a length that ends just
    inside a tile, leaving that tile nearly empty)."""
    rs = np.random.RandomState(seed)
    lens = rs.randint(32, s + 1, size=b)
    lens[0], lens[1] = s, 33
    return lens


def _bert_pad_batch(b, s, seed, device="cuda"):
    """A padded pretraining batch from ``seed`` (numpy): lengths of
    ``_bert_pad_lengths``; token ids past a length 0 and token types 0
    there (1 from a random split point inside each sequence); MLM labels on
    15% of the valid positions (-100 everywhere else); NSP labels random.
    Returns the TrainStep inputs (ids, token_type_ids, attn_mask=None,
    masked_lm_labels, next_sentence_labels, seq_lens)."""
    rs = np.random.RandomState(seed)
    lens = _bert_pad_lengths(b, s, seed)
    valid = np.arange(s)[None, :] < lens[:, None]
    ids = np.where(valid, rs.randint(1, BERT_BASE["vocab_size"], (b, s)), 0)
    split = (lens * rs.uniform(0.25, 0.75, b)).astype(np.int64)
    types = (np.arange(s)[None, :] >= split[:, None]) & valid
    mlm = np.where(valid & (rs.rand(b, s) < 0.15), ids, -100)
    nsp = rs.randint(0, 2, b)
    out = [torch.from_numpy(np.ascontiguousarray(a)).long()
           for a in (ids, types, mlm, nsp, lens)]
    ids, types, mlm, nsp, lens = (t.to(device) for t in out)
    return ids, types, None, mlm, nsp, lens


def _bert_recipe(dtype=BF16, padded=False):
    """The recipe of [bert-train] and [bert-pad-train]: BERT-base (seed 0,
    dropout 0.1) in ``dtype``, AdamW(1e-4, wd 0.01, multi_precision=True),
    TrainStep, one fixed batch of BERT_TRAIN["batch"] x BERT_TRAIN["seq"]:
    unpadded (``_bert_batch``, seed 31) or, with ``padded``, padded
    (``_bert_pad_batch``, seed BERT_PAD_SEED)."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import BertConfig, BertForPreTraining
    from paddle_tpu_torch.optimizer import AdamW
    model = BertForPreTraining(BertConfig(**BERT_BASE), dtype=dtype, seed=0)
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.parameters(), multi_precision=True)
    make = _bert_pad_batch if padded else _bert_batch
    batch = make(BERT_TRAIN["batch"], BERT_TRAIN["seq"],
                 BERT_PAD_SEED if padded else 31)
    return model, opt, TrainStep(model, opt, fast_path=False), batch


def _is_bert_kernel(key):
    """A profiler key of the kernels on BERT's path: the pair kernels
    (flash_attention.cuh) and the dropout and fused-LN kernels."""
    return _is_flash_kernel(key) or any(
        name in key for name in ("dropout_kernel", "fused_ln_fwd_kernel",
                                 "fused_ln_bwd_kernel"))


def phase_bert_train(smi, padded=False):
    """BERT-base pretraining: the recipe of ``_bert_recipe``, 1 warm-up
    step and BERT_TRAIN["steps"] timed steps (each synchronised), on the
    unpadded batch (the packed path, the pair kernels: [bert-train]) or,
    with ``padded``, on the padded batch with ``seq_lens`` (the flat
    kernels with the lengths and no pair kernel: [bert-pad-train]). Every
    loss is finite, the first is near ln(vocab) + ln 2 (MLM over a random
    vocabulary plus NSP, within LOSS0_SLACK) and a later one is below it;
    each step launches exactly BERT_STEP_LAUNCHES (BERT_PAD_STEP_LAUNCHES);
    every parameter equals its fp32 master cast to bf16. The timing line
    carries the card's name and power limit (``smi``). Returns the model,
    optimizer, batch and losses."""
    from paddle_tpu_torch.kernels import launch_counts
    tag = "[bert-pad-train]" if padded else "[bert-train]"
    want = BERT_PAD_STEP_LAUNCHES if padded else BERT_STEP_LAUNCHES
    t0 = time.perf_counter()
    model, opt, step, batch = _bert_recipe(padded=padded)
    b, s = batch[0].shape
    n_params = sum(p.numel() for p in model.parameters())
    valid_tokens, padding = b * s, ""
    if padded:
        lens = batch[5]
        valid_tokens = int(lens.sum())
        tiles = int(((lens + 63) // 64).sum()) / (b * ((s + 63) // 64))
        padding = (f" padded, lengths in [{int(lens.min())}, "
                   f"{int(lens.max())}], mean length {valid_tokens / b:.2f} "
                   f"({valid_tokens / (b * s):.4f} of the tokens and of the "
                   f"B*S*S pairs valid; live 64-key tiles {tiles:.4f}),")
    log(f"{tag} BERT-base {n_params / 1e6:.1f} M params bf16, dropout 0.1, "
        f"AdamW(multi_precision) built in {time.perf_counter() - t0:.1f} s; "
        f"batch {b} x {s},{padding} {int((batch[3] != -100).sum())} MLM "
        f"labels")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for i in range(1 + BERT_TRAIN["steps"]):
        before = launch_counts()
        t0 = time.perf_counter()
        loss = step(*batch)
        losses.append(loss.item())              # synchronises
        walls.append(time.perf_counter() - t0)
        _expect_launches(f"{tag} step {i}", _grew(before, launch_counts()),
                         **want)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    want0 = math.log(BERT_BASE["vocab_size"]) + math.log(2.0)
    if not abs(losses[0] - want0) < LOSS0_SLACK:
        raise AssertionError(f"first loss {losses[0]:.4f} is not near "
                             f"ln(vocab) + ln 2 = {want0:.4f}")
    if not min(losses[1:]) < losses[0]:
        raise AssertionError(f"loss did not fall on a repeated batch: "
                             f"{losses}")
    for p in model.parameters():
        master = opt._master_weights[id(p)]
        if master.dtype != torch.float32 or not torch.equal(
                p, master.to(torch.bfloat16)):
            raise AssertionError("a parameter is not its fp32 master cast "
                                 "to bf16")
    timed = walls[1:]
    wall = sum(timed) / len(timed)
    if not padded:
        BERT_TRAIN_WALLS[:] = timed          # [bert-lamb] prints it beside
    log(f"{tag} losses {[round(x, 4) for x in losses]} (ln vocab + ln 2 = "
        f"{want0:.4f})")
    log(f"{tag} {len(timed)} timed steps: wall per step {wall * 1e3:.1f} ms "
        f"(min {min(timed) * 1e3:.1f}, max {max(timed) * 1e3:.1f}; warm-up "
        f"{walls[0] * 1e3:.1f}), {b / wall:.1f} seq/s, {b * s / wall:.0f} "
        f"tokens/s, {valid_tokens / wall:.0f} valid tokens/s; launches per "
        f"step {want}; peak memory {peak_gb:.2f} GB; {smi}")
    return model, opt, batch, losses


def phase_bert_scoring(model, padded=False):
    """BERT-base's eval forward at [64, 512] bf16 (no labels: MLM and NSP
    logits), unpadded or, with ``padded``, on a padded batch with
    ``seq_lens``: finite, of the right shapes, and exactly 12 pair (padded:
    flat) forwards and 24 fused-LN forwards at rate 0, no dropout. Returns
    the model's inputs."""
    from paddle_tpu_torch.kernels import launch_counts
    if padded:
        ids, types, _, _, _, lens = _bert_pad_batch(64, 512, 50)
        inputs, tag, kernel = (ids, types, None, None, None, lens), \
            "[bert-pad-scoring]", "flash_attention_fwd"
    else:
        ids, types = _bert_batch(64, 512, 32)[:2]
        inputs, tag, kernel = (ids, types), "[bert-scoring]", "flash_pair_fwd"
    model.eval()
    before = launch_counts()
    with torch.no_grad():
        mlm, nsp = model(*inputs)
    torch.cuda.synchronize()
    layers = BERT_BASE["num_layers"]
    _expect_launches(tag, _grew(before, launch_counts()), **{kernel: layers},
                     fused_add_dropout_ln_fwd=2 * layers)
    if mlm.shape != (*ids.shape, BERT_BASE["vocab_size"]) \
            or nsp.shape != (ids.shape[0], 2):
        raise AssertionError(f"shapes {tuple(mlm.shape)}, {tuple(nsp.shape)}")
    if not (torch.isfinite(mlm).all() and torch.isfinite(nsp).all()):
        raise AssertionError("non-finite scoring logits")
    log(f"{tag} eval {list(ids.shape)}"
        + (f" padded (mean length {float(lens.float().mean()):.2f})"
           if padded else "")
        + f": MLM logits {tuple(mlm.shape)}, NSP {tuple(nsp.shape)} finite; "
        f"{layers} {kernel} + {2 * layers} fused-LN forwards at rate 0, no "
        f"dropout")
    return inputs


def phase_bert_scoring_time(model, inputs, tag, beside=""):
    """Device time of one BERT-base eval forward on ``inputs`` (outside the
    path's launch count), in ms; ``beside`` is printed after it."""
    with torch.no_grad():
        ms = cuda_time_ms(lambda: model(*inputs), iters=3, warmup=1)
    b = inputs[0].shape[0]
    log(f"{tag} forward {list(inputs[0].shape)}: {ms:.2f} ms, "
        f"{b / ms * 1e3:.1f} seq/s{beside}")
    return ms


def phase_profile_bert_train(model, opt, batch, tag):
    """One step of [bert-train] (or [bert-pad-train]: ``batch`` padded)
    under torch.profiler: the device busy share, the flash kernels' share
    of device time (forward, backward and the ordered dq sum), the share of
    the kernels of BERT's path (the flash kernels, dropout, fused-LN
    forward and backward) by name, and the six kernels with the most
    device time."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.jit import TrainStep
    model.train()
    step = TrainStep(model, opt, fast_path=False)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(*batch).item()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    flash_us = sum(e.self_device_time_total for e in kernels
                   if _is_flash_kernel(e.key))
    ours = {}
    for e in kernels:
        if _is_bert_kernel(e.key):
            name = next(n for n in (*FLASH_KERNELS, "dropout_kernel",
                                    "fused_ln_fwd_kernel",
                                    "fused_ln_bwd_kernel") if n in e.key)
            ours[name] = ours.get(name, 0.0) + e.self_device_time_total
    ours_us = sum(ours.values())
    busy = max(busy_us, 1.0)
    log(f"{tag} one step, profiler on: {wall * 1e3:.1f} ms wall, device "
        f"busy {busy_us / 1e3:.1f} ms = {busy_us / 1e6 / wall:.3f} of wall; "
        f"the flash kernels {flash_us / 1e3:.1f} ms = {flash_us / busy:.3f} "
        f"of device time; the path's kernels {ours_us / 1e3:.1f} ms = "
        f"{ours_us / busy:.3f} ("
        + ", ".join(f"{k} {v / 1e3:.2f} ms" for k, v in sorted(ours.items()))
        + ")")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"{tag}   {e.self_device_time_total / 1e3:8.2f} ms x"
            f"{e.count:5d}  {e.key[:90]}")


def phase_bert_train_plain(losses, padded=False):
    """A witness for [bert-train] (or [bert-pad-train]): the same recipe,
    batch and steps with every kernel of the path in its plain version
    (``_plain_kernels``: no launch). The plain versions draw the same masks
    from the same seeds, so every step's loss agrees within
    TRAIN_PLAIN_LOSS_LIMIT."""
    from paddle_tpu_torch.kernels import launch_counts
    tag = "[bert-pad-train-plain]" if padded else "[bert-train-plain]"
    model, opt, step, batch = _bert_recipe(padded=padded)
    with _plain_kernels():
        before = launch_counts()
        t0 = time.perf_counter()
        plain = [step(*batch).item() for _ in losses]
        wall = time.perf_counter() - t0
        after = launch_counts()
    if after != before:
        raise AssertionError(f"the plain run launched kernels: {before} -> "
                             f"{after}")
    diff = max(abs(x - y) for x, y in zip(losses, plain))
    log(f"{tag} losses {[round(x, 4) for x in plain]}; largest |kernel - "
        f"plain| over the {len(plain)} steps {diff:.3g} (limit "
        f"{TRAIN_PLAIN_LOSS_LIMIT}); {wall / len(plain) * 1e3:.0f} ms per "
        f"step")
    if not diff < TRAIN_PLAIN_LOSS_LIMIT:
        raise AssertionError("the kernel path's loss curve departs from the "
                             "plain path's on the same recipe")
    del model, opt, step


def phase_bert_train_check():
    """BERT-base width at 2 layers in fp32, [2, 512], dropout 0.1: the
    card (all five kernels, each dropping) against the plain CPU path from
    the same weights and generator state (``_card_vs_cpu``). The masks
    are keyed on the element, so the two runs drop the same elements; a
    mask tied to the kernels' tiles would show here as an O(1) gradient
    error."""
    from paddle_tpu_torch.models import BertConfig, BertForPreTraining
    cfg = BertConfig(**dict(BERT_BASE, num_layers=2))
    _card_vs_cpu(
        "[bert-train-check] fp32, 2 layers, [2, 512], dropout 0.1:",
        lambda dev: BertForPreTraining(cfg, device=dev, seed=7),
        _bert_batch(2, 512, 33, device="cpu"),
        dict(flash_pair_fwd=2, flash_pair_bwd=2, fused_add_dropout_ln_fwd=4,
             fused_add_dropout_ln_bwd=4, dropout_fwd=2))


def phase_gpt_dropout_check():
    """GPT-medium width at 2 blocks in fp32, [2, 256], dropout 0.1 on the
    embeddings, the residuals and the attention (causal pair kernels at
    d = 128): the card against the plain CPU path (``_card_vs_cpu``). Five
    dropouts forward (embeddings, two per block) and five backward."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    cfg = GPTConfig(**dict(GPT_MEDIUM, num_layers=2, hidden_dropout_prob=0.1,
                           attention_dropout_prob=0.1))
    gen = torch.Generator()
    gen.manual_seed(34)
    ids = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen)
    labels = ids.clone()
    labels[:, :16] = -100
    _card_vs_cpu(
        "[gpt-dropout-check] fp32, 2 blocks, [2, 256], dropout 0.1:",
        lambda dev: GPTForCausalLM(cfg, device=dev, seed=8).train(),
        (ids, labels), dict(flash_pair_fwd=2, flash_pair_bwd=2,
                            dropout_fwd=10))


# ------------------------------- masks, row 6, BERT on padded batches


def _mask_case_inputs(case, gen):
    """q, k, v, dO on the card and the mask keywords of one
    [compare-fa-masks] case."""
    tag, b, lq, lk, h, hkv, d, dtype, causal, lens, cuts, rate = case
    q, k, v, g = _fa_inputs(b, lq, lk, h, hkv, d, dtype, gen)
    kw = dict(kv_lens=torch.as_tensor(lens, dtype=torch.int32,
                                      device="cuda"))
    if cuts is not None:
        for name, length in (("q_segments", lq), ("kv_segments", lk)):
            seg = torch.zeros(b, length, dtype=torch.int32, device="cuda")
            for c in cuts:                       # a share of the length
                seg[:, int(c * length):] += 1
            kw[name] = seg
    if rate:
        kw["seed"] = 0x5EED0000 + b
    return q, k, v, g, kw


def _fa_mask_cases():
    """(tag, B, Lq, Lk, H, Hkv, D, dtype, causal, kv_lens, segment cuts as
    shares of the length, rate) of [compare-fa-masks]: BERT's padded shape
    at rates 0 and 0.1, GQA 32/8 causal with lengths, fp32 ragged Lq != Lk
    with lengths, 3 segments a row and dropout, and a length shorter than
    one tile, the bf16 kernel's segment ids at D = 128 (causal, rate 0.1)
    and D = 64, and the fp32 wide kernels at D = 512, ragged, GQA 4/2, with
    lengths, 3 segments a row and dropout (its walks long enough for
    clusters of 2). BERT's lengths are [bert-pad-train]'s batch's (seed
    45)."""
    bert = [int(x) for x in _bert_pad_lengths(BERT_TRAIN["batch"],
                                              BERT_TRAIN["seq"],
                                              BERT_PAD_SEED)]
    return [("bert", 64, 512, 512, 12, 12, 64, BF16, False, bert, None, 0.0),
            ("bert", 64, 512, 512, 12, 12, 64, BF16, False, bert, None, 0.1),
            ("gqa", 2, 2048, 2048, 32, 8, 128, BF16, True, [2048, 1111],
             None, 0.0),
            ("ragged", 2, 200, 300, 4, 2, 64, FP32, True, [300, 230],
             (0.3, 0.6), 0.1),
            ("short", 2, 256, 256, 4, 4, 64, BF16, False, [40, 1], None,
             0.1),
            # the bf16 kernel's segment-id instantiations at both head sizes
            ("segs", 2, 1024, 1024, 8, 2, 128, BF16, True, [1024, 700],
             (0.25, 0.5), 0.1),
            ("segs", 4, 512, 512, 4, 4, 64, BF16, False, [512, 300, 100, 512],
             (0.5,), 0.0),
            ("ragged-wide", 2, 600, 700, 4, 2, 512, FP32, True, [700, 333],
             (0.3, 0.6), 0.1)]


def phase_compare_fa_masks():
    """flash_attention_fwd and _bwd with kv_lens, segment ids and dropout
    against their plain versions (``_fa_mask_cases``), at [compare-fa]'s
    limits: out within atol 4e-3 times the probability-weighted |v| (kept
    pairs scaled by 1 / (1 - rate)) + rtol 1e-2 in bf16 (1e-4 in fp32), lse
    within 1e-3, dq/dk/dv within FA_BWD_REL_LIMIT (fp32 above D = 256:
    BIG_D_FP32_REL_LIMIT against the exact gradient), dk and dv equal
    between two launches and exactly zero on the keys past each length.
    Each case is timed beside its plain version, sdpa with a boolean mask
    and dropout_p (forward, and autograd through it) and the bounds, which
    count the attended pairs. Returns the records of BERT's shape at rate
    0.1 (the padded path's), forward and backward."""
    from paddle_tpu_torch.kernels.flash_attention import (
        _visible, flash_attention_bwd, flash_attention_bwd_reference,
        flash_attention_fwd, flash_attention_fwd_reference)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(40)
    records = None
    for case in _fa_mask_cases():
        tag, b, lq, lk, h, hkv, d, dtype, causal, lens, cuts, rate = case
        q, k, v, g, kw = _mask_case_inputs(case, gen)
        out, lse = flash_attention_fwd(q, k, v, causal, None, rate, **kw)
        got = flash_attention_bwd(q, k, v, out, lse, g, causal, None, rate,
                                  **kw)
        again = flash_attention_bwd(q, k, v, out, lse, g, causal, None, rate,
                                    **kw)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_attention_fwd_reference(q, k, v, causal,
                                                         None, rate, **kw)
        atol, rtol = (4e-3, 1e-2) if dtype == BF16 else (1e-4, 1e-4)
        weight = flash_attention_fwd_reference(q, k, v.abs(), causal, None,
                                               rate, **kw)[0].float()
        diff = (out.float() - ref_out.float()).abs()
        err = diff.max().item()
        of_limit = (diff / (atol * weight.clamp_min(1.0)
                            + rtol * ref_out.float().abs())).max().item()
        lse_ok = bool(((lse - ref_lse).abs()
                       <= 1e-3 + 1e-3 * ref_lse.abs()).all())
        limit = FA_BWD_REL_LIMIT[dtype]
        if _exact(dtype, d):
            q64, k64, v64, g64 = (t.double() for t in (q, k, v, g))
            o64, l64 = flash_attention_fwd_reference(q64, k64, v64, causal,
                                                     None, rate, **kw)
            want = flash_attention_bwd_reference(q64, k64, v64, o64, l64,
                                                 g64, causal, None, rate,
                                                 **kw)
            limit = BIG_D_FP32_REL_LIMIT
            del q64, k64, v64, g64, o64, l64
        else:
            want = flash_attention_bwd_reference(q, k, v, out, lse, g,
                                                 causal, None, rate, **kw)
        rels = [rel_err(x, y) for x, y in zip(got, want)]
        worst_abs = max((x.float() - y.float()).abs().max().item()
                        for x, y in zip(got, want))
        stable = torch.equal(got[1], again[1]) and torch.equal(got[2],
                                                               again[2])
        dead = sum(int(torch.count_nonzero(t[r, n:])) for t in got[1:]
                   for r, n in enumerate(lens))
        del weight, diff, want, again, ref_lse, ref_out
        valid = _visible(lq, lk, causal, "cuda", kw["kv_lens"],
                         kw.get("q_segments"), kw.get("kv_segments"))
        pairs = int(valid.sum())
        ms = cuda_time_ms(lambda: flash_attention_fwd(q, k, v, causal, None,
                                                      rate, **kw))
        bwd_ms = cuda_time_ms(lambda: flash_attention_bwd(
            q, k, v, out, lse, g, causal, None, rate, **kw), iters=10)
        plain_ms = cuda_time_ms(lambda: flash_attention_fwd_reference(
            q, k, v, causal, None, rate, **kw), iters=3, warmup=1)
        plain_bwd_ms = cuda_time_ms(lambda: flash_attention_bwd_reference(
            q, k, v, out, lse, g, causal, None, rate, **kw), iters=3,
            warmup=1)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        lib_ms = cuda_time_ms(lambda: _sdpa_library(*leaves, causal, valid,
                                                    rate))
        o = _sdpa_library(*leaves, causal, valid, rate)
        lib_bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(
            o, leaves, g.transpose(1, 2), retain_graph=True))
        kv_rows = sum(min(lk, n) for n in lens)
        fb = fa_bound_ms(b, lq, lk, h, hkv, d, dtype, causal, pairs=pairs,
                         kv_rows=kv_rows)
        bb = fa_bound_ms(b, lq, lk, h, hkv, d, dtype, causal, True, pairs,
                         kv_rows)
        name = (f"[compare-fa-masks] {tag} B={b} Lq={lq} Lk={lk} H={h} "
                f"Hkv={hkv} D={d} {str(dtype)[6:]} causal={causal} rate "
                f"{rate}" + (", 3 segments a row" if cuts else ""))
        shown = lens if len(lens) <= 4 else f"mean {np.mean(lens):.2f}"
        tiles = sum(-(-n // 64) for n in lens) / (b * -(-lk // 64))
        log(f"{name}: lengths {shown}, live 64-key tiles {tiles:.4f}, "
            f"attended pairs {pairs / (b * lq * lk):.4f} of B*Lq*Lk; out "
            f"{of_limit:.3f} of the limit (atol {atol}, rtol {rtol}); dq/dk/"
            f"dv rel {rels[0]:.3g}/{rels[1]:.3g}/{rels[2]:.3g} (limit "
            f"{limit}{EXACT_NOTE if _exact(dtype, d) else ''}); nonzero "
            f"dk/dv past the lengths {dead}")
        log(f"{name}: forward {ms:.4f} ms (plain {plain_ms:.4f}, sdpa "
            f"{lib_ms:.4f}, bound {fb[0]:.4f} ms {fb[1]}); backward "
            f"{bwd_ms:.4f} ms (plain {plain_bwd_ms:.4f}, sdpa backward "
            f"{lib_bwd_ms:.4f}, bound {bb[0]:.4f} ms {bb[1]})")
        if not (of_limit <= 1.0 and lse_ok and stable and dead == 0
                and max(rels) < limit):
            raise AssertionError(f"{name}: the flat kernels disagree with "
                                 f"their plain versions")
        if tag == "bert" and rate:
            records = (dict(max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=fb[0],
                            bound_by=fb[1], library_ms=lib_ms),
                       dict(max_abs_err=worst_abs, ms=bwd_ms,
                            plain_ms=plain_bwd_ms, bound_ms=bb[0],
                            bound_by=bb[1], library_ms=lib_bwd_ms))
        del q, k, v, g, out, lse, got, leaves, o, valid
        torch.cuda.empty_cache()
    return records


def _fa_mask_probe(b, L, h, d, causal, seed, rate, kw, dtype=BF16):
    """Read the flat kernels' keep masks back off the card, as
    ``_attn_mask_probe`` does for the pair kernels (q = k = 0: p = 1 / l;
    one-hot v and dO expose each pair). Over every (b, h, q, key) pair,
    the kernel's nonzero pattern must be philox.attention_keep AND the
    pairs the lengths and segments let through. Returns (forward
    mismatches on attended pairs, backward mismatches on attended pairs,
    nonzero probabilities on masked pairs, forward and backward together,
    nonzero dk/dv past the lengths, attended pairs, masked pairs)."""
    from paddle_tpu_torch.kernels import philox
    from paddle_tpu_torch.kernels.flash_attention import (
        _visible, flash_attention_bwd, flash_attention_fwd)
    keep = philox.attention_keep(seed, b, h, L, L, rate, "cuda")
    visible = _visible(L, L, causal, "cuda", kw.get("kv_lens"),
                       kw.get("q_segments"), kw.get("kv_segments"))
    want = keep & visible                              # [b, h, i, j]
    e = torch.arange(d, device="cuda")
    fwd_m = bwd_m = leak = dead = 0
    q = torch.zeros(b, L, h, d, dtype=dtype, device="cuda")
    for t in range(L // d):
        keys = t * d + e
        v = torch.zeros(b, L, h, d, dtype=dtype, device="cuda")
        v[:, keys, :, e] = 1.0
        out, lse = flash_attention_fwd(q, q, v, causal, None, rate,
                                       seed=seed, **kw)
        got = out.permute(0, 2, 1, 3) != 0            # [b, h, i, e]
        sl = slice(t * d, (t + 1) * d)
        fwd_m += int(((got != want[..., sl]) & visible[..., sl]).sum())
        leak += int((got & ~visible[..., sl]).sum())
        dout = torch.zeros(b, L, h, d, dtype=dtype, device="cuda")
        dout[:, keys, :, e] = 1.0
        _, dk, dv = flash_attention_bwd(q, q, v, out, lse, dout, causal,
                                        None, rate, seed=seed, **kw)
        got = dv.permute(0, 2, 3, 1) != 0              # [b, h, e, j]
        vis = visible[:, :, sl, :].expand(b, h, d, L)
        bwd_m += int(((got != want[:, :, sl, :]) & vis).sum())
        leak += int((got & ~vis).sum())
        dead += sum(int(torch.count_nonzero(x[r, n:])) for x in (dk, dv)
                    for r, n in enumerate(kw["kv_lens"].tolist()))
        del v, out, lse, dout, dk, dv, got
    attended = int(visible.expand(b, h, L, L).sum())
    return fwd_m, bwd_m, leak, dead, attended, b * h * L * L - attended


def phase_fa_mask_probe():
    """The keep masks of both flat kernels read back with probe inputs
    (``_fa_mask_probe``) at BERT's padded shape [64, 512, 12, 64] rate 0.1,
    at [2, 256, 4, 64] and [2, 256, 2, 128] causal with lengths and 3
    segments a row (the kSegs instantiations), at [2, 256, 2, 128]
    bidirectional with lengths, on the wide kernels at [2, 640, 2, 320]
    causal with lengths and segments and [2, 512, 2, 512] bidirectional
    with lengths, and on the fp32 wide kernels at [2, 640, 2, 320] causal
    with lengths and segments: 0 mismatches against philox.attention_keep on
    the attended pairs, probability exactly 0 on every masked pair (past a
    length, across segments, above the diagonal), and dk = dv = 0 exactly
    on the keys past each length."""
    rate = 0.1
    bert_lens = _bert_pad_lengths(BERT_TRAIN["batch"], BERT_TRAIN["seq"], 42)
    seg = torch.zeros(2, 256, dtype=torch.int32, device="cuda")
    seg[:, 70:] += 1
    seg[:, 150:] += 1
    wide_seg = torch.zeros(2, 640, dtype=torch.int32, device="cuda")
    wide_seg[:, 170:] += 1
    wide_seg[:, 400:] += 1
    cases = [(64, 512, 12, 64, False,
              dict(kv_lens=torch.as_tensor(bert_lens, dtype=torch.int32,
                                           device="cuda"))),
             (2, 256, 4, 64, True,
              dict(kv_lens=torch.tensor([256, 201], dtype=torch.int32,
                                        device="cuda"),
                   q_segments=seg, kv_segments=seg)),
             (2, 256, 2, 128, True,
              dict(kv_lens=torch.tensor([256, 201], dtype=torch.int32,
                                        device="cuda"),
                   q_segments=seg, kv_segments=seg)),
             (2, 256, 2, 128, False,
              dict(kv_lens=torch.tensor([130, 256], dtype=torch.int32,
                                        device="cuda"))),
             # the wide kernels (heads above 256): lengths and 3 segments a
             # row (the forward's 64-key tiles), lengths alone
             (2, 640, 2, 320, True,
              dict(kv_lens=torch.tensor([640, 501], dtype=torch.int32,
                                        device="cuda"),
                   q_segments=wide_seg, kv_segments=wide_seg)),
             (2, 512, 2, 512, False,
              dict(kv_lens=torch.tensor([512, 200], dtype=torch.int32,
                                        device="cuda")))]
    cases = [c + (BF16,) for c in cases]
    # the fp32 wide kernels (csrc/flash_f32_wide.cuh): lengths and 3
    # segments a row
    cases.append((2, 640, 2, 320, True,
                  dict(kv_lens=torch.tensor([640, 501], dtype=torch.int32,
                                            device="cuda"),
                       q_segments=wide_seg, kv_segments=wide_seg), FP32))
    for b, L, h, d, causal, kw, dtype in cases:
        fwd_m, bwd_m, leak, dead, attended, masked = _fa_mask_probe(
            b, L, h, d, causal, 0xFACE + b, rate, kw, dtype)
        log(f"[fa-mask-probe] B={b} L={L} H={h} D={d} {str(dtype)[6:]} "
            f"causal={causal} "
            f"rate {rate}{', 3 segments a row' if 'q_segments' in kw else ''}"
            f": keep-mask mismatches forward {fwd_m}, backward {bwd_m} over "
            f"{attended} attended pairs; nonzero probabilities on the "
            f"{masked} masked pairs {leak}; nonzero dk/dv past the lengths "
            f"{dead}")
        if fwd_m or bwd_m or leak or dead:
            raise AssertionError("[fa-mask-probe]: the flat kernels' masks "
                                 "are not the plain Philox mask and the "
                                 "structured masks")
        torch.cuda.empty_cache()


def phase_seed_device():
    """[seed-device]: each launcher with a dropout (rows 1, 2, 4, 5, 7, 8)
    at rate 0.1, once with the seed passed by value (the eager path) and
    once reading it from device memory (``philox.DeviceSeed``, as a
    captured training step passes its staged seeds): every output bit for
    bit the same, the flat kernels also past 256 (the wide bodies) and in
    fp32, with lengths and segments."""
    from paddle_tpu_torch.kernels import (dropout_fwd, flash_attention_bwd,
                                          flash_attention_fwd,
                                          flash_pair_bwd, flash_pair_fwd,
                                          fused_add_dropout_ln_bwd,
                                          fused_add_dropout_ln_fwd, philox)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(70)
    seed, rate = 0x2468ACE13579, 0.1
    dseed = philox.DeviceSeed(torch.tensor([7, seed], dtype=torch.int64,
                                           device="cuda"), 1)
    x = _nonzero_randn((8, 512, 768), BF16, gen)
    n, h = 4096, 768
    x2, s2, dy = (_nonzero_randn((n, h), BF16, gen) for _ in range(3))
    w, b = (_nonzero_randn((h,), BF16, gen) for _ in range(2))
    _, stats = fused_add_dropout_ln_fwd(x2, s2, w, b, seed, rate, 1e-12)
    qkv = _nonzero_randn((2, 1024, 3 * 8 * 128), BF16, gen)
    pout, plse = flash_pair_fwd(qkv, 8, True, rate, seed)
    pdo = _nonzero_randn(tuple(pout.shape), BF16, gen)
    seg = torch.zeros(2, 640, dtype=torch.int32, device="cuda")
    seg[:, 300:] += 1
    lens = torch.tensor([640, 500], dtype=torch.int32, device="cuda")
    cases = {
        "dropout_fwd": lambda s: dropout_fwd(x, s, rate),
        "fused_add_dropout_ln_fwd": lambda s: fused_add_dropout_ln_fwd(
            x2, s2, w, b, s, rate, 1e-12),
        "fused_add_dropout_ln_bwd": lambda s: fused_add_dropout_ln_bwd(
            x2, s2, w, stats, dy, s, rate, 1e-12),
        "flash_pair_fwd": lambda s: flash_pair_fwd(qkv, 8, True, rate, s),
        "flash_pair_bwd": lambda s: flash_pair_bwd(qkv, pout, plse, pdo, 8,
                                                   True, rate, s)}
    for d, dtype in ((128, BF16), (320, BF16), (128, FP32)):
        q, k, v, g = _fa_inputs(2, 640, 640, 4, 2, d, dtype, gen)
        kw = dict(kv_lens=lens, q_segments=seg, kv_segments=seg)
        fo, fl = flash_attention_fwd(q, k, v, True, None, rate, seed=seed,
                                     **kw)
        tag = f"{str(dtype)[6:]} D {d}"
        cases[f"flash_attention_fwd {tag}"] = \
            lambda s, q=q, k=k, v=v, kw=kw: flash_attention_fwd(
                q, k, v, True, None, rate, seed=s, **kw)
        cases[f"flash_attention_bwd {tag}"] = \
            lambda s, q=q, k=k, v=v, o=fo, lse=fl, g=g, kw=kw: \
            flash_attention_bwd(q, k, v, o, lse, g, True, None, rate,
                                seed=s, **kw)
    same = []
    for name, fn in cases.items():
        a, b_ = fn(seed), fn(dseed)
        a = a if isinstance(a, (tuple, list)) else (a,)
        b_ = b_ if isinstance(b_, (tuple, list)) else (b_,)
        if not all(torch.equal(u, t) for u, t in zip(a, b_)):
            raise AssertionError(f"[seed-device] {name}: the seed read from "
                                 f"device memory drops other elements than "
                                 f"the seed by value")
        same.append(name)
    log(f"[seed-device] rate {rate}: seed by value and from device memory "
        f"give every output bit for bit in {len(same)} launches: "
        f"{', '.join(same)}")


FA_PACKED_SHAPE = (2, 2048, 16, 128)      # row 6: [B, L, 3*H*D], D = 128


def phase_compare_fa_packed():
    """Row 6, ``kernels.flash_attention_qkv_packed`` (the call a user
    makes; no model reaches it): the pair kernels on [2, 2048, 3*16*128]
    bf16 causal, rates 0 and 0.1, under autograd, exactly one launch each
    way (counts set to 0 just before the call, read just after). Out within
    [compare-fa]'s limit and d(qkv) per block within FA_BWD_REL_LIMIT of
    its plain version, the flat references on the three column slices; lse
    within 1e-3; out and dk/dv equal to the pair wrappers called directly.
    Timed (those wrappers) beside the plain versions, sdpa on the column
    views (forward, autograd through it) and the bounds. Returns the launch
    counts of the rate-0.1 call and the records at rate 0.1, forward and
    backward."""
    from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd_reference, flash_attention_fwd_reference,
        flash_attention_qkv_packed)
    from paddle_tpu_torch.kernels.flash_pair import (flash_pair_bwd,
                                                     flash_pair_fwd)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(43)
    b, L, h, d = FA_PACKED_SHAPE
    hd = h * d
    for rate in (0.0, 0.1):
        seed = 0xC0FFEE if rate else None
        qkv, dout = _bwd_inputs(b, L, h, d, BF16, gen)
        leaf = qkv.clone().requires_grad_()
        reset_launch_counts()              # row 6's call starts here
        out = flash_attention_qkv_packed(leaf, h, True, None, rate, seed)
        out.backward(dout)
        torch.cuda.synchronize()
        counts = launch_counts()           # ... and ends here
        tag = (f"[compare-fa-packed] flash_attention_qkv_packed B={b} L={L} "
               f"H={h} D={d} bf16 causal rate {rate}")
        _expect_launches(tag, counts, flash_pair_fwd=1, flash_pair_bwd=1)
        out_k, lse = flash_pair_fwd(qkv, h, True, rate, seed)
        direct = flash_pair_bwd(qkv, out_k, lse, dout, h, True, rate, seed)
        q, k, v = (qkv[..., i * hd:(i + 1) * hd].reshape(b, L, h, d)
                   .contiguous() for i in range(3))
        do = dout.view(b, L, h, d)
        ref_out, ref_lse = flash_attention_fwd_reference(q, k, v, True, None,
                                                         rate, seed=seed)
        weight = flash_attention_fwd_reference(q, k, v.abs(), True, None,
                                               rate, seed=seed)[0].float()
        diff = (out.detach().view(b, L, h, d).float()
                - ref_out.float()).abs()
        of_limit = (diff / (4e-3 * weight.clamp_min(1.0)
                            + 1e-2 * ref_out.float().abs())).max().item()
        err = diff.max().item()
        lse_ok = bool(((lse - ref_lse).abs()
                       <= 1e-3 + 1e-3 * ref_lse.abs()).all())
        want = flash_attention_bwd_reference(q, k, v, out_k.view(b, L, h, d),
                                             lse, do, True, None, rate,
                                             seed=seed)
        got = leaf.grad
        rels = [rel_err(got[..., i * hd:(i + 1) * hd].view(b, L, h, d), w)
                for i, w in enumerate(want)]
        worst_abs = max((got[..., i * hd:(i + 1) * hd].view(b, L, h, d)
                         .float() - w.float()).abs().max().item()
                        for i, w in enumerate(want))
        same = (torch.equal(out, out_k)
                and torch.equal(got[..., hd:], direct[..., hd:]))
        del weight, diff, want, direct, ref_out, ref_lse
        ms = cuda_time_ms(lambda: flash_pair_fwd(qkv, h, True, rate, seed))
        bwd_ms = cuda_time_ms(lambda: flash_pair_bwd(
            qkv, out_k, lse, dout, h, True, rate, seed), iters=10)
        plain_ms = cuda_time_ms(lambda: flash_attention_fwd_reference(
            q, k, v, True, None, rate, seed=seed), iters=3, warmup=1)
        plain_bwd_ms = cuda_time_ms(lambda: flash_attention_bwd_reference(
            q, k, v, out_k.view(b, L, h, d), lse, do, True, None, rate,
            seed=seed), iters=3, warmup=1)
        lib_leaf = qkv.detach().requires_grad_()
        lq, lk, lv = (lib_leaf[..., i * hd:(i + 1) * hd].view(b, L, h, d)
                      .transpose(1, 2) for i in range(3))

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                lq, lk, lv, dropout_p=rate, is_causal=True)
        lib_ms = cuda_time_ms(library)
        o = library()
        lib_bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(
            o, lib_leaf, do.transpose(1, 2), retain_graph=True))
        fb = flash_bound_ms(b, L, h, d, BF16, True)
        bb = flash_bwd_bound_ms(b, L, h, d, BF16, True)
        log(f"{tag}: launches {counts}; out {of_limit:.3f} of the limit "
            f"(max|err| {err:.3g}), lse ok {lse_ok}; dq/dk/dv rel "
            f"{rels[0]:.3g}/{rels[1]:.3g}/{rels[2]:.3g} (limit "
            f"{FA_BWD_REL_LIMIT[BF16]}); out and dk/dv equal to the pair "
            f"wrappers called directly {same}")
        log(f"{tag}: forward {ms:.4f} ms (plain {plain_ms:.4f}, sdpa "
            f"{lib_ms:.4f}, bound {fb[0]:.4f} ms {fb[1]}); backward "
            f"{bwd_ms:.4f} ms (plain {plain_bwd_ms:.4f}, sdpa backward "
            f"{lib_bwd_ms:.4f}, bound {bb[0]:.4f} ms {bb[1]})")
        if not (of_limit <= 1.0 and lse_ok and same
                and max(rels) < FA_BWD_REL_LIMIT[BF16]):
            raise AssertionError(f"{tag}: row 6 disagrees with its plain "
                                 f"version")
        if rate:
            path = counts
            records = (dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=fb[0], bound_by=fb[1],
                            library_ms=lib_ms),
                       dict(max_abs_err=worst_abs, ms=bwd_ms,
                            plain_ms=plain_bwd_ms, bound_ms=bb[0],
                            bound_by=bb[1], library_ms=lib_bwd_ms))
        del qkv, dout, leaf, out, out_k, lse, got, q, k, v, do, lib_leaf
        del lq, lk, lv, o
        torch.cuda.empty_cache()
    return path, records


class _PlainFlashAttention(torch.autograd.Function):
    """``FlashAttention`` with both kernels replaced by their plain
    versions, for the kernel-free witnesses in ``phase_llama_train_plain``
    and ``phase_bert_pad_train_plain``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, dropout_rate=0.0, seed=None,
                kv_lens=None, q_segments=None, kv_segments=None):
        from paddle_tpu_torch.kernels.flash_attention import (
            flash_attention_fwd_reference)
        masks = dict(kv_lens=kv_lens, q_segments=q_segments,
                     kv_segments=kv_segments)
        out, lse = flash_attention_fwd_reference(q, k, v, causal, None,
                                                 dropout_rate, seed=seed,
                                                 **masks)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, dropout_rate, seed, masks)
        return out

    @staticmethod
    def backward(ctx, dout):
        from paddle_tpu_torch.kernels.flash_attention import (
            flash_attention_bwd_reference)
        q, k, v, out, lse = ctx.saved_tensors
        causal, rate, seed, masks = ctx.args
        grads = flash_attention_bwd_reference(q, k, v, out, lse,
                                              dout.contiguous(), causal,
                                              None, rate, seed=seed, **masks)
        return (*grads, None, None, None, None, None, None)


def phase_bert_pad_train_check():
    """BERT-base width at 2 layers in fp32, a padded [2, 512] batch
    (lengths 512 and 33), dropout 0.1: the card (the flat kernels with the
    lengths and dropout, the fused-LN and dropout kernels) against the
    plain CPU path from the same weights and generator state
    (``_card_vs_cpu``, every leaf within TRAIN_CHECK_REL_LIMIT)."""
    from paddle_tpu_torch.models import BertConfig, BertForPreTraining
    cfg = BertConfig(**dict(BERT_BASE, num_layers=2))
    _card_vs_cpu(
        "[bert-pad-train-check] fp32, 2 layers, padded [2, 512] (lengths "
        "512, 33), dropout 0.1:",
        lambda dev: BertForPreTraining(cfg, device=dev, seed=9),
        _bert_pad_batch(2, 512, 46, device="cpu"),
        dict(flash_attention_fwd=2, flash_attention_bwd=2,
             fused_add_dropout_ln_fwd=4, fused_add_dropout_ln_bwd=4,
             dropout_fwd=2))


def _pad_vs_packed(model, batch, gen_seed):
    """The loss and gradients of ``model`` on ``batch`` through the padded
    route (every length = S) and the packed route, each from generator
    state ``gen_seed``: ((loss, grads), (loss, grads), launches of each)."""
    from paddle_tpu_torch.kernels import launch_counts
    ids, types, _, mlm, nsp = batch[:5]
    full = torch.full((ids.shape[0],), ids.shape[1], device=ids.device)
    runs = []
    for lens in (full, None):
        model.zero_grad(set_to_none=True)
        model.generator.manual_seed(gen_seed)
        before = launch_counts()
        loss = model(ids, types, None, mlm, nsp, lens)
        loss.backward()
        torch.cuda.synchronize()
        runs.append((loss.item(), {n: p.grad.clone()
                                   for n, p in model.named_parameters()},
                     _grew(before, launch_counts())))
    return runs


def phase_bert_pad_full():
    """The padded route with every length = 512 against the packed route
    on the same weights and generator state, dropout 0.1: the same Philox
    masks on two kernel layouts (the flat kernels with lengths against
    the pair kernels). fp32, 2 layers of BERT-base width, [2, 512]: loss
    and every leaf's gradient within 1e-5 relative. Then the bf16
    12-layer model at [64, 512]: the loss gap, printed."""
    from paddle_tpu_torch.models import BertConfig, BertForPreTraining
    cfg = BertConfig(**dict(BERT_BASE, num_layers=2))
    model = BertForPreTraining(cfg, device="cuda", seed=10).train()
    batch = _bert_batch(2, 512, 47)
    (pl, pg, pn), (kl, kg, kn) = _pad_vs_packed(model, batch, 48)
    loss_rel = abs(pl - kl) / abs(kl)
    rels = {n: rel_err(pg[n], kg[n]) for n in kg if kg[n] is not None}
    worst = max(rels, key=rels.get)
    _expect_launches("[bert-pad-full] padded", pn, flash_attention_fwd=2,
                     flash_attention_bwd=2, fused_add_dropout_ln_fwd=4,
                     fused_add_dropout_ln_bwd=4, dropout_fwd=2)
    _expect_launches("[bert-pad-full] packed", kn, flash_pair_fwd=2,
                     flash_pair_bwd=2, fused_add_dropout_ln_fwd=4,
                     fused_add_dropout_ln_bwd=4, dropout_fwd=2)
    log(f"[bert-pad-full] fp32, 2 layers, [2, 512], every length 512, "
        f"dropout 0.1: loss padded {pl:.7f} vs packed {kl:.7f} (rel "
        f"{loss_rel:.3g}); worst leaf gradient rel {rels[worst]:.3g} "
        f"({worst}); limit 1e-5")
    if not (loss_rel <= 1e-5 and rels[worst] <= 1e-5):
        raise AssertionError("[bert-pad-full]: the padded route at full "
                             "lengths departs from the packed route")
    del model
    torch.cuda.empty_cache()
    model = BertForPreTraining(BertConfig(**BERT_BASE), dtype=BF16,
                               seed=0).train()
    batch = _bert_batch(BERT_TRAIN["batch"], BERT_TRAIN["seq"], 31)
    (pl, _, _), (kl, _, _) = _pad_vs_packed(model, batch, 49)
    log(f"[bert-pad-full] bf16, 12 layers, [64, 512], every length 512, "
        f"dropout 0.1: loss padded {pl:.5f} vs packed {kl:.5f}, gap "
        f"{abs(pl - kl):.3g}")
    del model
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The serving engine's other modes: the row cache, speculative
# decoding with its three drafters, int8 weight-only serving.

# bench.py decode's row-cache lane at this geometry: [64] would reject its
# own 65-128-token prompts, so the buckets are 64 and 128
ROW_ENGINE = dict(max_slots=16, max_len=256, paged=False,
                  prefill_buckets=[64, 128])
# bench.py decode --spec=draft_model's draft: a quarter of the blocks, half
# the width and half the heads of the target (GPT-medium: 4 blocks, hidden
# 512, 4 heads of 128); both model drafters' window is horizon // 4
DRAFT_GPT = dict(GPT_MEDIUM, hidden_size=512, num_layers=4, num_heads=4)
DRAFT_CTX = 64
# the first generated position where a speculative engine's token differs
# from the non-speculative engine's must be a near-tie: in the uncached
# forward's logits there, both tokens within this gap of the top. The
# verify step multiplies [1, vw] rows where decode multiplies [16, 1], so
# cuBLAS may sum in another order and bf16 may flip a near-tie. GPT: the
# gap limit of [crosscheck]; LLaMA: CROSSCHECK_GAP; fp32 with TF32 off:
# 1e-4
SPEC_TIE_GAP = {"gpt": 0.1, "llama": CROSSCHECK_GAP[BF16], "fp32": 1e-4}
# [draft-kernel]: the drafter's last-position logits through the kernels
# against the same forward with attention in its plain versions, largest
# |difference| over the logits' own largest |value| (bf16 rounds the
# attention outputs in one and not the other)
DRAFT_LOGIT_REL_LIMIT = 0.05
# [draft-kernel-*]: proposals profiled until one reading holds every
# replay's flash records. A graph replays the same kernels each time, yet
# the CUDA tracer read 12 of a draft GPT proposal's 16 in two runs and 16
# in two others on the same code (NVIDIA H100, torch 2.11), and 31 of an
# early-exit proposal's 32 in three readings in a row of one run: a short
# reading is the tracer's, a reading above the count would be the graph's.
# The tracer loses most often the first launches of a window
# ([trace-probe]), so each window opens with a marker launch
DRAFT_TRACE_TRIES = 6
# [engine-int8]: the int8 model's greedy pick at each of [engine]'s
# generated positions, fed [engine]'s own tokens, agrees with [engine]'s
# token at this share of them or more. Free-running, the two engines'
# trajectories part at the first flipped near-tie (random GPT-medium
# weights have top-1/top-2 gaps of a few thousandths, [crosscheck]), so
# that share is reported beside it (0.497 in the first reading on an
# H100, teacher-forced 0.965)
INT8_AGREE_FLOOR = 0.8


def _uncached_logits(model, seq, first):
    """fp32 logits of the uncached forward over ``seq`` (through the flash
    kernels; right-padded to their 128-token gate, causal attention so the
    padding changes nothing before it) at positions ``first`` to the end:
    ``[len(seq) - first, vocab]``."""
    from paddle_tpu_torch.models.gpt import _lm_head_logits
    from paddle_tpu_torch.serving.engine import _model_spec
    ids = torch.zeros(1, max(128, len(seq)), dtype=torch.long)
    ids[0, :len(seq)] = torch.tensor(seq)
    with torch.no_grad():
        hidden = _model_spec(model).backbone(ids.cuda())
    return _lm_head_logits(hidden[0, first:len(seq)], model.head_weight)


def _forced_logits(model, req):
    """The uncached forward's logits at each generated position of
    ``req``, fed ``req``'s own prompt and tokens (teacher-forced)."""
    return _uncached_logits(model, req.prompt + req.tokens[:-1],
                            len(req.prompt) - 1)


def phase_crosscheck_pooled(model, reqs, tag):
    """[crosscheck]'s rule over every generated position of every request,
    pooled: the argmax of the uncached forward agrees with the engine's
    tokens at >= 0.95 of them, and every disagreement is a near-tie (logit
    gap <= 0.1). A speculative engine's verify multiplies [1, vw] rows, so
    its near-ties fall elsewhere than the decode step's, and a request of
    36 positions would miss a per-request floor of 0.95 on two of them."""
    agree, total, worst = 0, 0, 0.0
    for req in reqs:
        logits = _forced_logits(model, req)
        want = torch.tensor(req.tokens, device="cuda")
        top = logits.argmax(dim=-1)
        agree += int((top == want).sum())
        total += len(req.tokens)
        worst = max(worst, (logits.gather(1, top[:, None])
                            - logits.gather(1, want[:, None])).max().item())
    log(f"{tag} {total} generated positions of {len(reqs)} requests: "
        f"argmax agreement {agree / total:.3f} (floor 0.95), largest logit "
        f"gap at a disagreement {worst:.4f} (limit 0.1)")
    if agree / total < 0.95 or worst > 0.1:
        raise AssertionError("engine tokens disagree with the uncached "
                             "forward beyond bf16 near-ties")


def _hold_to_reference(tag, model, reqs, ref_reqs, gap_limit):
    """``reqs``' tokens against ``ref_reqs``' (the same requests through
    the non-speculative engine): identical, or, at the first generated
    position where a request's differ, a near-tie: in the uncached
    forward's logits after the common prefix both tokens lie within
    ``gap_limit`` of the top. Returns how many requests differ."""
    differ = 0
    for r, e in zip(reqs, ref_reqs):
        if r.tokens == e.tokens:
            continue
        differ += 1
        i = next(j for j, (a, b) in enumerate(zip(r.tokens, e.tokens))
                 if a != b)
        seq = r.prompt + r.tokens[:i]
        logits = _uncached_logits(model, seq, len(seq) - 1)[0]
        gap = (logits.max() - torch.minimum(logits[r.tokens[i]],
                                            logits[e.tokens[i]])).item()
        log(f"{tag} request {r.id}: differs first at generated position "
            f"{i} of {len(r.tokens)} ({r.tokens[i]} vs {e.tokens[i]}); "
            f"uncached logit gap {gap:.4g} (limit {gap_limit})")
        if gap > gap_limit:
            raise AssertionError(f"{tag}: tokens differ from the "
                                 f"non-speculative engine's beyond a "
                                 f"near-tie")
    return differ


def _warm(eng, vocab, lengths, new=4):
    """A warm-up request of each prompt length (random ids, seed 99),
    drained: builds (and, on the card, captures) the programs they use.
    Returns the requests."""
    gen = torch.Generator()
    gen.manual_seed(99)
    reqs = [eng.submit(torch.randint(0, vocab, (n,), generator=gen)
                       .tolist(), max_new_tokens=new) for n in lengths]
    eng.run()
    torch.cuda.synchronize()
    return reqs


def _all_captured(tag, registry, want):
    progs = registry._programs
    if registry.count != want or not all(p.captured for p in progs.values()):
        raise AssertionError(f"{tag}: {registry.count} programs "
                             f"({list(progs)}), expected {want} captured")


def phase_engine_row(model, ref, requests=_gpt_requests,
                     tag="[engine-row]"):
    """paged=False at the bench.py decode geometry (16 slots, max_len 256,
    buckets 64 and 128): the requests with eager steps, then graphed after
    a warm-up that builds both buckets' prefills and the decode step
    (compile_count 3, no capture in the drain), tokens identical to the
    eager row engine's. Returns the graphed requests."""
    from paddle_tpu_torch.serving import DecodeEngine
    prompts, new_tokens = requests()
    vocab = model.config.vocab_size
    torch.cuda.empty_cache()
    eng = DecodeEngine(model, **ROW_ENGINE)
    eng._programs.capture = False
    eager_reqs, _, eager_wall, eager_peak, _ = _serve(eng, prompts,
                                                      new_tokens)
    eager_rate = eng.stats()["tokens_generated"] / eager_wall
    del eng
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated() / 1e9
    eng = DecodeEngine(model, **ROW_ENGINE)
    _warm(eng, vocab, (40, 100), new=2)
    _all_captured(tag, eng._programs, 3)
    warm_tokens = eng.tokens_generated
    reqs, steps, wall, peak, reserved = _serve(eng, prompts, new_tokens)
    if eng.compile_count != 3:
        raise AssertionError(f"{tag}: {eng.compile_count - 3} captures in "
                             f"the drain")
    diff = [r.id for r, e in zip(reqs, eager_reqs) if r.tokens != e.tokens]
    if diff:
        raise AssertionError(f"{tag}: graphed tokens differ from the eager "
                             f"row engine's in requests {diff}")
    st = eng.stats()
    if "paged" in st or any(r.prefill_chunks != 1 for r in reqs):
        raise AssertionError(f"{tag}: not the row cache: {st}")
    rate = (st["tokens_generated"] - warm_tokens) / wall
    log(f"{tag} {len(reqs)} requests in {steps} steps, {wall:.3f} s: "
        f"{rate:.1f} tokens/s graphed against {eager_rate:.1f} eager "
        f"(paged graphed {ref['rate']:.1f}); tokens identical to the eager "
        f"row engine's; compile_count 3 (buckets {eng.prefill_buckets} + "
        f"decode), 0 captures in the drain; {st['prefill_calls'] - 2} "
        f"prefill calls; peak memory {peak:.2f} GB (eager {eager_peak:.2f}; "
        f"paged graphed {ref['peak']:.2f}; {base:.2f} allocated before the "
        f"engine), reserved {reserved:.2f} GB")
    return reqs


def _draft_blocks(drafter):
    """The attention blocks one call of a model drafter's forward runs."""
    from paddle_tpu_torch.serving.spec import EarlyExitDrafter
    n = drafter.model.config.num_layers
    return len(range(0, n, drafter.interval)) \
        if isinstance(drafter, EarlyExitDrafter) else n


def _replayed(tag, counts_now, drafter):
    """A speculative phase's launch counts, checked against the drafter's
    calls. A captured program counts the launches the device ran (its
    first call's eager run, then one body's worth at each replay;
    ``core/programs.py``), so each count must be the blocks a call runs
    times the drafter program's calls."""
    out = dict(counts_now)
    ran = {k: n for k, n in counts_now.items() if n}
    if drafter is None or not hasattr(drafter, "calls"):
        if ran:
            raise AssertionError(f"{tag}: launched {ran} without a model "
                                 f"drafter")
        return out
    per_call = _draft_blocks(drafter)
    for key, n in ran.items():
        if n != per_call * drafter.calls:
            raise AssertionError(f"{tag}: {key} counted {n} launches, "
                                 f"expected {per_call} a call x "
                                 f"{drafter.calls} calls")
    return out


def phase_engine_spec(model, drafter, ref_reqs, ref, tag, gap_limit,
                      snapshot, requests=_gpt_requests, crosscheck=None):
    """Speculative decoding on ``ref_reqs``' requests (graphed: a warm-up
    builds and captures the chunk and verify programs and the drafter's
    [1, 64] program; nothing is captured in the drain): every request's
    tokens identical to the non-speculative graphed engine's or, at the
    first difference, a near-tie (``_hold_to_reference``), then held to
    the uncached forward by ``crosscheck``; the per-request ledgers sum to
    stats()["spec"]. Returns (requests, the stats, ``snapshot()`` taken
    right after the drain: the launch counts of the path, before the
    checks' own forwards)."""
    from paddle_tpu_torch.serving import DecodeEngine
    prompts, new_tokens = requests()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated() / 1e9
    eng = DecodeEngine(model, drafter=drafter, **ENGINE)
    model_drafter = hasattr(drafter, "calls")
    warm = _warm(eng, model.config.vocab_size, (40,), new=6)
    _all_captured(tag, eng._programs, 2)
    if model_drafter:
        _all_captured(tag + " drafter", drafter._programs, 1)
    warm_tokens, calls0 = eng.tokens_generated, getattr(drafter, "calls", 0)
    reqs, steps, wall, peak, reserved = _serve(eng, prompts, new_tokens)
    drained = snapshot()
    if eng.compile_count != 2 or (model_drafter
                                  and drafter.compile_count != 1):
        raise AssertionError(f"{tag}: programs were built in the drain")
    st = eng.stats()
    spec = st["spec"]
    if sum(r.spec_drafted for r in warm + reqs) != spec["drafted"] \
            or sum(r.spec_accepted for r in warm + reqs) \
            != spec["accepted"] or spec["accepted"] > spec["drafted"]:
        raise AssertionError(f"{tag}: the ledgers disagree with {spec}")
    differ = _hold_to_reference(tag, model, reqs, ref_reqs, gap_limit)
    rate = (st["tokens_generated"] - warm_tokens) / wall
    calls = getattr(drafter, "calls", 0) - calls0
    log(f"{tag} {len(reqs)} requests in {steps} steps, {wall:.3f} s: "
        f"{rate:.1f} tokens/s ({rate / ref['rate']:.2f}x the graphed "
        f"engine's {ref['rate']:.1f}); stats()['spec'] {spec}; "
        f"{len(reqs) - differ} of {len(reqs)} requests token-identical to "
        f"the non-speculative engine; drafter program calls in the drain "
        f"{calls}; peak memory {peak:.2f} GB (graphed engine "
        f"{ref['peak']:.2f}; {base:.2f} allocated before the engine), "
        f"reserved {reserved:.2f} GB")
    if crosscheck is not None:
        crosscheck(model, reqs)
    return reqs, spec, drained


def phase_draft_kernel(drafter, tag, gap_limit):
    """A model drafter's [1, 64] program (captured) against the same
    forward with attention in its plain versions (``_plain_kernels``): at
    a full window and a ragged one (37 tokens), the program's token is the
    eager kernel forward's argmax, and the last-position logits agree
    within DRAFT_LOGIT_REL_LIMIT with the argmax equal or a near-tie. One
    proposal (4 replays) is profiled: the flash forward body runs once a
    block a replay (each window opened with a marker launch,
    ``_open_window``; up to DRAFT_TRACE_TRIES proposals, for a reading the
    tracer did not cut; no reading may exceed it). Then the kernel alone
    at the drafter's shape, timed beside its plain version, sdpa and the
    bound. Returns (the kernel's record, its wrapper's name, the shape)."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.models.gpt import _lm_head_logits
    from paddle_tpu_torch.nn.functional import flash_at_any_length
    from paddle_tpu_torch.serving.engine import _model_spec
    model = drafter.model
    spec = _model_spec(model)
    prog = drafter._program()
    inputs, out = prog.state
    gen = torch.Generator()
    gen.manual_seed(64)
    vocab = model.config.vocab_size
    for n in (DRAFT_CTX, 37):
        window = torch.randint(0, vocab, (n,), generator=gen)
        inputs.host["ids"].fill(0)
        inputs.host["ids"][0, :n] = window.numpy()
        inputs.host["length"][...] = n
        inputs.upload()
        prog()
        tok = int(out.item())
        ids = inputs.dev["ids"].clone()
        with torch.no_grad(), flash_at_any_length():
            kern = _lm_head_logits(drafter._backbone(spec, ids)[0, n - 1],
                                   model.head_weight)
            with _plain_kernels():
                plain = _lm_head_logits(
                    drafter._backbone(spec, ids)[0, n - 1],
                    model.head_weight)
        rel = ((kern - plain).abs().max() / plain.abs().max()).item()
        a, b = int(kern.argmax()), int(plain.argmax())
        gap = (plain[b] - plain[a]).item()
        log(f"{tag} window {n}: program token {tok}, eager kernel argmax "
            f"{a}, plain argmax {b} (plain logit gap {gap:.4g}); max|logit "
            f"difference| / max|logit| {rel:.3g} (limit "
            f"{DRAFT_LOGIT_REL_LIMIT})")
        if tok != a or rel > DRAFT_LOGIT_REL_LIMIT \
                or (a != b and gap > gap_limit):
            raise AssertionError(f"{tag}: the drafter's kernels disagree "
                                 f"with the plain versions")
    req = type("Hist", (), {})()
    req.prompt = torch.randint(0, vocab, (100,), generator=gen).tolist()
    req.tokens = []
    per_call = _draft_blocks(drafter)
    readings = []
    for _ in range(DRAFT_TRACE_TRIES):
        calls0 = drafter.calls
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _open_window("marker")
            drafter.propose(req, 4)
            torch.cuda.synchronize()
        replays = drafter.calls - calls0
        events = prof.key_averages()
        ran = sum(e.count for e in events
                  if "flash_fwd" in e.key and "kernel" in e.key)
        readings.append((ran, sum(e.count for e in events)))
        if ran == per_call * replays:
            break
    log(f"{tag} one proposal: {replays} replays ran the flash forward "
        f"{ran} times ({per_call} blocks a replay; readings (flash, every "
        f"record) {readings})")
    if ran != per_call * replays \
            or max(r for r, _ in readings) > per_call * replays:
        raise AssertionError(f"{tag}: the replays launched the flash "
                             f"forward {readings}, expected "
                             f"{per_call * replays}")
    # the kernel alone at the drafter's shape
    d = model.config.hidden_size // model.config.num_heads
    h = model.config.num_heads
    kgen = torch.Generator(device="cuda")
    kgen.manual_seed(65)
    if hasattr(model, "gpt"):
        from paddle_tpu_torch.kernels.flash_pair import (
            flash_pair_fwd, flash_pair_fwd_reference)
        qkv = torch.randn(1, DRAFT_CTX, 3, h * d, device="cuda",
                          generator=kgen)
        qkv[:, :, :2] *= 2.0
        qkv = qkv.reshape(1, DRAFT_CTX, 3 * h * d).to(BF16)
        got, ref = flash_pair_fwd(qkv, h, True)[0], \
            flash_pair_fwd_reference(qkv, h, True)[0]
        ms = cuda_time_ms(lambda: flash_pair_fwd(qkv, h, True))
        plain_ms = cuda_time_ms(lambda: flash_pair_fwd_reference(qkv, h,
                                                                 True))
        q, k, v = (qkv[..., i * h * d:(i + 1) * h * d]
                   .view(1, DRAFT_CTX, h, d) for i in range(3))
        bound_ms, bound_by = flash_bound_ms(1, DRAFT_CTX, h, d, BF16, True)
        wrapper, shape = "flash_pair_fwd", f"[1, {DRAFT_CTX}, 3*{h}*{d}]"
    else:
        from paddle_tpu_torch.kernels.flash_attention import (
            flash_attention_fwd, flash_attention_fwd_reference)
        hkv = model.config.num_kv_heads
        q, k, v, _ = _fa_inputs(1, DRAFT_CTX, DRAFT_CTX, h, hkv, d, BF16,
                                kgen)
        got, ref = flash_attention_fwd(q, k, v, True)[0], \
            flash_attention_fwd_reference(q, k, v, True)[0]
        ms = cuda_time_ms(lambda: flash_attention_fwd(q, k, v, True))
        plain_ms = cuda_time_ms(
            lambda: flash_attention_fwd_reference(q, k, v, True))
        bound_ms, bound_by = fa_bound_ms(1, DRAFT_CTX, DRAFT_CTX, h, hkv, d,
                                         BF16, True)
        wrapper, shape = ("flash_attention_fwd",
                          f"[1, {DRAFT_CTX}, {h}/{hkv}, {d}]")
    torch.testing.assert_close(got.float(), ref.float(), atol=4e-3,
                               rtol=1e-2)
    err = (got.float() - ref.float()).abs().max().item()
    library_ms = cuda_time_ms(lambda: _sdpa_library(q, k, v, True))
    log(f"{tag} {wrapper} {shape} bf16 causal: max|out err| {err:.3g}; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
        f"{per_call} launches a draft, {per_call * 4} a proposal of 4")
    return (dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                 bound_ms=bound_ms, bound_by=bound_by,
                 library_ms=library_ms), wrapper, shape)


def phase_engine_int8(model, ref_reqs, ref, snapshot):
    """quantize="int8" on GPT-medium, in place (the model's last phase):
    the number of Linear layers swapped (the tied LM head stays), the
    model's parameter and buffer bytes before and after and the memory
    allocated (the old weights are freed), [engine]'s requests with eager
    steps and then graphed (tokens identical, compile_count 2 after a
    warm-up, no capture in the drain), and the share of [engine]'s
    generated positions where the int8 model, fed [engine]'s own tokens,
    picks [engine]'s token (INT8_AGREE_FLOOR), beside the share of
    positions where the two engines' free-running tokens agree. Returns
    ``snapshot()`` taken after the graphed drain (the path's launch
    counts)."""
    from paddle_tpu_torch.quantization import Int8Linear
    from paddle_tpu_torch.serving import DecodeEngine
    prompts, new_tokens = _gpt_requests()

    def model_bytes():
        return sum(t.numel() * t.element_size()
                   for t in (*model.parameters(), *model.buffers()))
    # no earlier engine may hold the float weights in its leaf list: each
    # went with its last reference
    torch.cuda.empty_cache()
    before, bytes_before = torch.cuda.memory_allocated(), model_bytes()
    eng = DecodeEngine(model, quantize="int8", **ENGINE)
    swapped = sum(isinstance(m, Int8Linear) for m in model.modules())
    left = sum(type(m) is torch.nn.Linear for m in model.modules())
    torch.cuda.empty_cache()
    after, bytes_after = torch.cuda.memory_allocated(), model_bytes()
    pools = eng._kv.numel() * eng._kv.element_size()
    if swapped != 4 * model.config.num_layers or left:
        raise AssertionError(f"[engine-int8] swapped {swapped} layers, "
                             f"{left} Linear left")
    eng._programs.capture = False
    eager_reqs, _, eager_wall, eager_peak, _ = _serve(eng, prompts,
                                                      new_tokens)
    eager_rate = eng.stats()["tokens_generated"] / eager_wall
    del eng
    torch.cuda.empty_cache()
    eng = DecodeEngine(model, quantize="int8", **ENGINE)
    _warm(eng, model.config.vocab_size, (40,), new=2)
    _all_captured("[engine-int8]", eng._programs, 2)
    warm_tokens = eng.tokens_generated
    reqs, steps, wall, peak, reserved = _serve(eng, prompts, new_tokens)
    drained = snapshot()
    if eng.compile_count != 2:
        raise AssertionError("[engine-int8]: captures in the drain")
    diff = [r.id for r, e in zip(reqs, eager_reqs) if r.tokens != e.tokens]
    if diff:
        raise AssertionError(f"[engine-int8]: graphed tokens differ from "
                             f"the eager int8 engine's in {diff}")
    rate = (eng.stats()["tokens_generated"] - warm_tokens) / wall
    same = sum(a == b for r, e in zip(reqs, ref_reqs)
               for a, b in zip(r.tokens, e.tokens))
    total = sum(len(e.tokens) for e in ref_reqs)
    # teacher-forced: the int8 model's pick after each of [engine]'s own
    # prefixes, which a first flip does not carry into later positions
    forced = sum(int((_forced_logits(model, e).argmax(dim=-1)
                      == torch.tensor(e.tokens, device="cuda")).sum())
                 for e in ref_reqs)
    agree, agree_forced = same / total, forced / total
    log(f"[engine-int8] {swapped} Linear layers swapped (the tied head "
        f"stays bf16): the model's parameters and buffers "
        f"{bytes_before / 1e9:.3f} -> {bytes_after / 1e9:.3f} GB; allocated "
        f"{before / 1e9:.3f} GB before the engine, {after / 1e9:.3f} GB "
        f"after the swap with the engine's pools ({pools / 1e9:.3f} GB); "
        f"{len(reqs)} requests in {steps} "
        f"steps, {wall:.3f} s: {rate:.1f} tokens/s graphed against "
        f"{eager_rate:.1f} eager ([engine-graph] {ref['rate']:.1f}); "
        f"tokens identical to the eager int8 engine's; compile_count 2, 0 "
        f"captures in the drain; agreement with [engine]'s tokens "
        f"teacher-forced {agree_forced:.3f} (floor {INT8_AGREE_FLOOR}), "
        f"free-running {agree:.3f}; peak memory {peak:.2f} GB (eager "
        f"{eager_peak:.2f}; [engine-graph] {ref['peak']:.2f}), reserved "
        f"{reserved:.2f} GB")
    if agree_forced < INT8_AGREE_FLOOR \
            or after - before > pools - (bytes_before - bytes_after) / 2:
        raise AssertionError(f"[engine-int8]: teacher-forced agreement "
                             f"{agree_forced:.3f}, or the float weights "
                             f"were not freed")
    return drained


def phase_int8_linear():
    """Int8Linear on the card (torch._int_mm: cuBLASLt's int8 product,
    rows padded to 32) against the CPU's exact plain product at
    GPT-medium's QKV width (K 1024, N 3072) and M = 1, 16, 32 rows:
    identical up to rounding (the int32 sums are exact and the fp32
    epilogue is the same operations). Timed beside the bf16 Linear it
    replaces and the bytes bound (int8 weight + activations read, output
    written)."""
    import copy
    from paddle_tpu_torch.quantization import Int8Linear
    gen = torch.Generator()
    gen.manual_seed(8)
    lin = torch.nn.Linear(1024, 3072)
    with torch.no_grad():
        lin.weight.normal_(0.0, 0.02, generator=gen)
        lin.bias.normal_(0.0, 0.1, generator=gen)
    lin = lin.to(BF16)
    cpu = Int8Linear.from_linear(lin)        # holds lin's own bias
    lin = copy.deepcopy(lin).cuda()
    card = Int8Linear.from_linear(lin)
    if not torch.equal(card.qweight.cpu(), cpu.qweight):
        raise AssertionError("[int8-linear] the card's int8 weights differ")
    for m in (1, 16, 32):
        x = torch.randn(m, 1024, generator=gen).to(BF16)
        xc = x.cuda()
        with torch.no_grad():
            want = cpu(x).float()
            got = card(xc).float().cpu()
            err = (got - want).abs().max().item()
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
            ms = cuda_time_ms(lambda: card(xc))
            lib_ms = cuda_time_ms(lambda: lin(xc))
        nbytes = 1024 * 3072 + 3072 * 8 + m * 1024 * 2 + m * 3072 * 2
        bound_ms = nbytes / PEAK_BYTES * 1e3
        log(f"[int8-linear] M={m} K=1024 N=3072 bf16 in/out: card vs CPU "
            f"max|err| {err:.3g}; Int8Linear {ms:.4f} ms, bf16 Linear "
            f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes)")


def gpt_other_modes(model, reqs, graph_reqs, graph, counts, paths,
                    spec_paths, draft_records):
    """GPT-medium's other serving modes, each path with the launch counts
    set to 0 just before it and read (``counts()``) just after: the row
    cache, the three drafters of bench.py decode --spec (their paths count
    the drafter programs' launches as the device ran them: _replayed),
    then int8, last, as it swaps the model's Linear layers in place.
    ``reqs`` / ``graph_reqs``, ``graph`` are [engine]'s and
    [engine-graph]'s requests and record; fills ``paths``, ``spec_paths``
    and ``draft_records``."""
    from paddle_tpu_torch.kernels import reset_launch_counts
    from paddle_tpu_torch.serving import (DraftModelDrafter,
                                          EarlyExitDrafter,
                                          PromptLookupDrafter)
    # [generate]'s step program and buffers go, so the modes' peaks
    # compare with [engine-graph]'s, read before [generate] ran
    model.__dict__.pop("_gen_programs", None)
    reset_launch_counts()
    row_reqs = phase_engine_row(model, graph)
    paths["gpt-serving-row"] = counts()
    phase_crosscheck(model, row_reqs, rows=len(row_reqs),
                     tag="[engine-row-crosscheck]")
    drafters = {
        "lookup": PromptLookupDrafter(max_n=3, min_n=1, max_k=8),
        "draft": DraftModelDrafter(_gpt_draft_model(), ctx_len=DRAFT_CTX,
                                   max_k=4),
        "early": EarlyExitDrafter(model, interval=2, ctx_len=DRAFT_CTX,
                                  max_k=4)}
    for which, drafter in drafters.items():
        tag = f"[engine-spec-{which}]"
        reset_launch_counts()
        _, _, drained = phase_engine_spec(
            model, drafter, graph_reqs, graph, tag, SPEC_TIE_GAP["gpt"],
            counts, crosscheck=lambda m, r, t=tag: phase_crosscheck_pooled(
                m, r, t[:-1] + "-crosscheck]"))
        spec_paths[f"gpt-serving-spec-{which}"] = _replayed(tag, drained,
                                                            drafter)
    for which in ("draft", "early"):
        draft_records[f"gpt-{which}"] = phase_draft_kernel(
            drafters[which], f"[draft-kernel-{which}]", SPEC_TIE_GAP["gpt"])
    del drafters, row_reqs
    torch.cuda.empty_cache()
    reset_launch_counts()
    paths["gpt-serving-int8"] = phase_engine_int8(model, reqs, graph, counts)
    phase_int8_linear()


def llama_other_modes(llama, graph_reqs, graph, counts, paths, spec_paths,
                      draft_records):
    """LLaMA-7B's row cache and its early-exit drafter (bench.py's
    interval 2: 16 of the 32 blocks draft), as ``gpt_other_modes``."""
    from paddle_tpu_torch.kernels import reset_launch_counts
    from paddle_tpu_torch.serving import EarlyExitDrafter
    llama.__dict__.pop("_gen_programs", None)    # as gpt_other_modes
    reset_launch_counts()
    row_reqs = phase_engine_row(llama, graph, requests=_llama_requests,
                                tag="[llama-engine-row]")
    paths["llama-serving-row"] = counts()
    phase_llama_crosscheck(llama, row_reqs,
                           tag="[llama-engine-row-crosscheck]")
    drafter = EarlyExitDrafter(llama, interval=2, ctx_len=DRAFT_CTX, max_k=4)
    reset_launch_counts()
    _, _, drained = phase_engine_spec(
        llama, drafter, graph_reqs, graph, "[llama-engine-spec]",
        SPEC_TIE_GAP["llama"], counts, requests=_llama_requests,
        crosscheck=lambda m, r: phase_llama_crosscheck(
            m, r, tag="[llama-engine-spec-crosscheck]"))
    spec_paths["llama-serving-spec"] = _replayed("[llama-engine-spec]",
                                                 drained, drafter)
    draft_records["llama-early"] = phase_draft_kernel(
        drafter, "[draft-kernel-llama]", SPEC_TIE_GAP["llama"])


def llama_spec_fp32(model, ref_reqs, ref, counts):
    """[llama-engine-fp32]'s model and requests through the early-exit
    drafter in fp32 (interval 2: block 0 of 2 drafts, the fp32 forward
    body in its graph): tokens identical to [llama-engine-fp32]'s under
    the 1e-4 near-tie clause, then [llama-crosscheck]'s fp32 rule. Returns
    the path's launch counts as the device ran them."""
    from paddle_tpu_torch.kernels import reset_launch_counts
    from paddle_tpu_torch.serving import EarlyExitDrafter
    drafter = EarlyExitDrafter(model, interval=2, ctx_len=DRAFT_CTX,
                               max_k=4)
    reset_launch_counts()
    _, _, drained = phase_engine_spec(
        model, drafter, ref_reqs, ref, "[llama-engine-spec-fp32]",
        SPEC_TIE_GAP["fp32"], counts, requests=_llama_requests,
        crosscheck=lambda m, r: phase_llama_crosscheck(
            m, r, tag="[llama-crosscheck-spec-fp32]"))
    return _replayed("[llama-engine-spec-fp32]", drained, drafter)


def _gpt_draft_model():
    """bench.py decode --spec=draft_model's draft model, random weights
    from seed 1, bf16."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    return GPTForCausalLM(GPTConfig(**DRAFT_GPT), dtype=BF16,
                          seed=1).eval()


# ------------------------- training features: recompute, accumulation, AMP

# [train-recompute], [train-recompute-dropout], [llama-train-recompute]
# and [train-amp] hold a run's gradients against a run without recompute
# (or scale) bit for bit, every leaf (``_hold_grads``): the flash
# backwards sum dq in a fixed order (csrc/dq_sum.cu), so two runs of one
# step give the same bits, and a recompute replays the same products.
# bench.py's --recompute lane: selective at batch 24 x 1024, 3 timed steps
RECOMPUTE_LANE = dict(batch=24, seq=1024, steps=3)
# [train-accum]: K = 2 x 8 against one step of 16 rows (bf16 gradients of
# each microbatch summed in fp32 and halved, against bf16 gradients of the
# 16 rows): the relative error of the whole gradient and of the loss
ACCUM_GRAD_REL_LIMIT = 1e-2
ACCUM_LOSS_REL_LIMIT = 1e-3
# [train-amp]: the loss scale of the clean step (a power of two: the
# scaled backward is the unscaled one times it, exactly, in bf16)
AMP_SCALE = 2.0 ** 15
# [train-amp-cast]: GPT-medium at 4 x 1024, 5 TrainStep calls a run; the
# first loss of auto_cast O1 and of decorate + O2 within 1e-2 relative of
# the uncast fp32 step's (the bf16 tolerance of the CPU test,
# tests/test_torch_accum_amp.py::test_auto_cast_matches_jax)
AMP_CAST = dict(batch=4, seq=1024, steps=5)
AMP_CAST_LOSS_REL_LIMIT = 1e-2


def _grad_errors(got, want):
    """Two ``{name: gradient}`` maps: the relative Frobenius error of the
    whole gradient (every leaf in one vector), and the largest relative
    error of one leaf with its name (a leaf whose gradient is 0: the
    largest absolute difference)."""
    num = den = 0.0
    worst = (0.0, None)
    for n, w in want.items():
        d = (got[n].double() - w.double()).norm().item()
        wn = w.double().norm().item()
        num, den = num + d * d, den + wn * wn
        worst = max(worst, (d / wn if wn else d, n), key=lambda t: t[0])
    return math.sqrt(num / den) if den else math.sqrt(num), worst


def _fwd_bwd(model, ids, policy, reset=None):
    """One forward and backward of ``model(ids, ids)`` under ``policy``
    (after ``reset()`` where given): the loss, every leaf's gradient
    (cloned), the peak allocated GB from before the forward (what the
    process held then included: ``_held_gb``), and the launches."""
    from paddle_tpu_torch.kernels import launch_counts
    if reset is not None:
        reset()
    model.enable_recompute(policy)
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = launch_counts()
    loss = model(ids, ids)[1]
    loss.backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    grew = _grew(before, launch_counts())
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads, peak, grew


def _hold_grads(tag, what, got, want):
    """Gate a run's gradients ``got`` against ``want`` (both ``{name:
    gradient}``): every leaf bit for bit. Logs the count; the error names
    the leaves that moved and the relative error of the whole gradient."""
    moved = [n for n in want if not torch.equal(got[n], want[n])]
    log(f"{tag} {what}: {len(want) - len(moved)} of {len(want)} leaves bit "
        f"for bit")
    if moved:
        err, (leaf_err, leaf) = _grad_errors(got, want)
        raise AssertionError(f"{tag} {what}: {len(moved)} leaves moved "
                             f"({moved[:4]}); whole gradient error "
                             f"{err:.3g}, largest leaf {leaf_err:.3g} "
                             f"({leaf})")


def _held_gb():
    """The GB allocated on the card now (model and optimizer state and
    whatever earlier phases still hold)."""
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated() / 1e9


def _policies(tag, model, ids, blocks, fwd, bwd, policies, dropouts=0,
              reset=None):
    """Two runs without recompute (the second held to the first by
    ``_hold_grads``: the step is deterministic), then one under each of
    ``policies``: every policy's gradients held to the first run by
    ``_hold_grads``, its launches the run without recompute's plus one
    attention forward (``fwd``) a block, and one dropout a block where the
    run without recompute launches ``dropouts``; the peak GB of each (the
    model's weights and what the process held before included; the held
    GB is printed). ``reset`` runs before every run."""
    held = _held_gb()
    loss0, g0, peak0, grew0 = _fwd_bwd(model, ids, "none", reset)
    _expect_launches(f"{tag} none", grew0, **{fwd: blocks, bwd: blocks},
                     dropout_fwd=dropouts)
    loss1, g1, _, _ = _fwd_bwd(model, ids, "none", reset)
    log(f"{tag} held {held:.2f} GB at the start (the model's weights "
        f"included); none: loss {loss0:.6f}, peak {peak0:.2f} GB; a second "
        f"run without recompute: loss {loss1:.6f}")
    _hold_grads(tag, "none against none", g1, g0)
    del g1
    peaks = {"none": peak0}
    for policy in policies:
        loss, g, peak, grew = _fwd_bwd(model, ids, policy, reset)
        want = {fwd: 2 * blocks, bwd: blocks,
                "dropout_fwd": dropouts + (blocks if dropouts else 0)}
        _expect_launches(f"{tag} {policy}", grew, **want)
        log(f"{tag} {policy}: loss {loss:.6f}, peak {peak:.2f} GB; launches "
            f"{want}")
        _hold_grads(tag, f"{policy} against none", g, g0)
        peaks[policy] = peak
        del g
    return peaks


def phase_train_recompute():
    """GPT-medium bf16 at TRAIN's batch 16 x 1024, one forward and backward
    without recompute (twice: the spread) and under "dots", "selective"
    and "full" on every block: gradients held by ``_policies``, the attention forward launched twice a block under
    each policy (the flash forward is recomputed: its ``lse`` carries no
    tag), the peak memory none > dots and none > selective > full. Then
    bench.py's recompute lane: selective at RECOMPUTE_LANE's batch 24 x
    1024, AdamW(multi_precision), 1 warm-up and 3 timed steps."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import launch_counts
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    blocks = GPT_MEDIUM["num_layers"]
    model = GPTForCausalLM(GPTConfig(**GPT_MEDIUM), dtype=BF16,
                           seed=0).train()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    ids = torch.randint(0, GPT_MEDIUM["vocab_size"],
                        (TRAIN["batch"], TRAIN["seq"]), device="cuda",
                        generator=gen)
    peaks = _policies("[train-recompute]", model, ids, blocks,
                      "flash_pair_fwd", "flash_pair_bwd",
                      ("dots", "selective", "full"))
    if not (peaks["none"] > peaks["dots"] and peaks["none"]
            > peaks["selective"] > peaks["full"]):
        raise AssertionError(f"[train-recompute] peak memory does not fall: "
                             f"{peaks}")
    log(f"[train-recompute] peak GB by policy {peaks}")
    del model
    torch.cuda.empty_cache()

    b, L = RECOMPUTE_LANE["batch"], RECOMPUTE_LANE["seq"]
    model = GPTForCausalLM(GPTConfig(**dict(
        GPT_MEDIUM, recompute_granularity="selective")), dtype=BF16, seed=0)
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.parameters(), multi_precision=True)
    step = TrainStep(model, opt, fast_path=False)
    ids = torch.randint(0, GPT_MEDIUM["vocab_size"], (b, L), device="cuda",
                        generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for i in range(1 + RECOMPUTE_LANE["steps"]):
        before = launch_counts()
        t0 = time.perf_counter()
        losses.append(step(ids, ids).item())       # synchronises
        walls.append(time.perf_counter() - t0)
        _expect_launches(f"[recompute-lane] step {i}",
                         _grew(before, launch_counts()),
                         flash_pair_fwd=2 * blocks, flash_pair_bwd=blocks)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"[recompute-lane] losses {losses}")
    timed = walls[1:]
    wall = sum(timed) / len(timed)
    log(f"[recompute-lane] bench.py --recompute (selective, batch {b} x "
        f"{L}): losses {[round(x, 4) for x in losses]}; {len(timed)} timed "
        f"steps: wall per step {wall * 1e3:.1f} ms (min "
        f"{min(timed) * 1e3:.1f}, max {max(timed) * 1e3:.1f}; warm-up "
        f"{walls[0] * 1e3:.1f}), {b * L / wall:.0f} tokens/s; peak memory "
        f"{peak_gb:.2f} GB")
    del model, opt, step


def phase_train_recompute_dropout():
    """GPT-medium width at 4 blocks and dropout 0.1 (embeddings, residuals,
    attention), bf16, batch 16 x 1024: "full" recompute from the model
    generator's state of the run without recompute gives its gradients
    (``_hold_grads``: every leaf bit for bit), so the recompute of every
    block replayed the masks
    of rows 1 (the pair forward's in-kernel dropout), 2 (the backward's)
    and 8 (the dropout kernel): a redrawn mask would move the gradients
    by O(1). Launches: 18 dropout kernels without recompute (1 + 2 a
    block forward, as many backward), one more a block under "full" (the
    residual dropout after attention, whose output the second LayerNorm
    keeps) and one more pair forward a block."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    blocks = 4
    cfg = GPTConfig(**dict(GPT_MEDIUM, num_layers=blocks,
                           hidden_dropout_prob=0.1,
                           attention_dropout_prob=0.1))
    model = GPTForCausalLM(cfg, dtype=BF16, seed=3).train()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    ids = torch.randint(0, cfg.vocab_size, (TRAIN["batch"], TRAIN["seq"]),
                        device="cuda", generator=gen)
    state = model.generator.get_state()
    _policies("[train-recompute-dropout]", model, ids, blocks,
              "flash_pair_fwd", "flash_pair_bwd", ("full",),
              dropouts=2 + 4 * blocks,
              reset=lambda: model.generator.set_state(state))
    del model


def phase_llama_train_recompute():
    """LLaMA-7B width at LLAMA_TRAIN's 4 blocks and batch 4 x 2048, bf16:
    "selective" against no recompute (twice), gradients held by
    ``_hold_grads``, the flash_attention forward twice a block, peak
    memory below the run without recompute's."""
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_7b
    blocks = LLAMA_TRAIN["layers"]
    model = LlamaForCausalLM(llama_7b(num_layers=blocks), dtype=BF16,
                             seed=0).train()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    ids = torch.randint(0, LLAMA_7B["vocab_size"],
                        (LLAMA_TRAIN["batch"], LLAMA_TRAIN["seq"]),
                        device="cuda", generator=gen)
    peaks = _policies("[llama-train-recompute]", model, ids, blocks,
                      "flash_attention_fwd", "flash_attention_bwd",
                      ("selective",))
    if not peaks["none"] > peaks["selective"]:
        raise AssertionError(f"[llama-train-recompute] peak memory does not "
                             f"fall: {peaks}")
    del model


def _capturing(cls):
    """``cls`` (an optimizer class) that also keeps an fp32 copy of the
    gradients each update is given (after the accumulation and the
    unscale; its clip comes after)."""
    class Capture(cls):
        def apply_gradients(self, params, grads):
            self.captured = [g.detach().float().clone() for g in grads]
            super().apply_gradients(params, grads)
    return Capture


def _gpt_step(k=None, rows=16, scaler=None, clip=None, seed=4):
    """A GPT-medium bf16 model (seed 0) with a capturing
    AdamW(multi_precision) and TrainStep(accumulate_steps=k), and ``rows``
    x TRAIN["seq"] random ids (``[k, rows / k, seq]`` when k is given)."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    model = GPTForCausalLM(GPTConfig(**GPT_MEDIUM), dtype=BF16, seed=0)
    opt = _capturing(AdamW)(learning_rate=1e-4, weight_decay=0.01,
                            parameters=model.parameters(),
                            multi_precision=True, grad_clip=clip)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    ids = torch.randint(0, GPT_MEDIUM["vocab_size"], (rows, TRAIN["seq"]),
                        device="cuda", generator=gen)
    if k:
        ids = ids.view(k, rows // k, TRAIN["seq"])
    return model, opt, TrainStep(model, opt, fast_path=False,
                                 accumulate_steps=k, grad_scaler=scaler), ids


def _peak_step(step, ids):
    """One step: its loss and the peak allocated GB from before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss = step(ids, ids).item()
    return loss, torch.cuda.max_memory_allocated() / 1e9


def phase_train_accum():
    """GPT-medium bf16: TrainStep(accumulate_steps=2) over 2 x 8 rows
    against one step of the same 16 rows (average_grads: the sum halved).
    The loss (the mean of the two microbatch means; every label counts)
    within ACCUM_LOSS_REL_LIMIT and the whole gradient within
    ACCUM_GRAD_REL_LIMIT (bf16 microbatch gradients summed in fp32 against
    bf16 gradients of 16 rows). Then the peak memory of K = 4 x 4 stays
    below one 16-row step and within 1.5 x the fp32 accumulators (4 bytes
    a parameter) of one 4-row step. Returns the launches of the K = 2
    step."""
    from paddle_tpu_torch.kernels import launch_counts
    blocks = GPT_MEDIUM["num_layers"]
    model, opt, step, ids = _gpt_step()
    loss16, peak16 = _peak_step(step, ids)
    want = {n: g for n, g in zip([n for n, _ in model.named_parameters()],
                                 opt.captured)}
    n_params = sum(p.numel() for p in model.parameters())
    del model, opt, step
    torch.cuda.empty_cache()
    model, opt, step, ids = _gpt_step(k=2)
    before = launch_counts()
    loss2, _ = _peak_step(step, ids)
    grew = _grew(before, launch_counts())
    _expect_launches("[train-accum] K = 2", grew,
                     flash_pair_fwd=2 * blocks, flash_pair_bwd=2 * blocks)
    got = {n: g for n, g in zip([n for n, _ in model.named_parameters()],
                                opt.captured)}
    err, (leaf_err, leaf) = _grad_errors(got, want)
    loss_err = abs(loss2 - loss16) / abs(loss16)
    log(f"[train-accum] K = 2 x 8 against one step of 16: loss {loss2:.6f} "
        f"vs {loss16:.6f} (relative {loss_err:.3g}, limit "
        f"{ACCUM_LOSS_REL_LIMIT}); gradient error {err:.3g} (limit "
        f"{ACCUM_GRAD_REL_LIMIT}; largest leaf {leaf_err:.3g}, {leaf})")
    if not (loss_err <= ACCUM_LOSS_REL_LIMIT
            and err <= ACCUM_GRAD_REL_LIMIT):
        raise AssertionError("[train-accum] K = 2 x 8 departs from one step "
                             "of 16")
    del model, opt, step, got, want
    torch.cuda.empty_cache()
    peaks = {}
    for k, rows in ((None, 4), (4, 16)):
        model, opt, step, ids = _gpt_step(k=k, rows=rows)
        _peak_step(step, ids)                  # states and masters made
        peaks[k] = _peak_step(step, ids)[1]
        del model, opt, step
        torch.cuda.empty_cache()
    acc_gb = 4 * n_params / 1e9
    log(f"[train-accum] peak GB: one 4-row step {peaks[None]:.2f}, K = 4 x 4 "
        f"{peaks[4]:.2f} (the fp32 accumulators {acc_gb:.2f}), one 16-row "
        f"step {peak16:.2f} (its first step)")
    if not (peaks[4] < peak16 and peaks[4] - peaks[None] <= 1.5 * acc_gb):
        raise AssertionError(f"[train-accum] K = 4 x 4 peak {peaks[4]:.2f} "
                             f"GB is not near one 4-row step")
    return grew


def phase_train_amp():
    """GPT-medium bf16, AdamW(multi_precision, grad_clip=
    ClipGradByGlobalNorm(1.0)): one step with a GradScaler at AMP_SCALE
    against the same step without one. A power-of-two scale commutes with
    every bf16 rounding, so the unscaled gradients the two hand to the
    update (and so their clips) equal each other bit for bit, as two
    unscaled runs do (``_hold_grads``). Then a gradient made
    inf by a hook (the last block's fc_in) leaves parameters, masters and
    moments bit for bit, the step counter where it was, and halves the
    scale."""
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    grads = {}
    for run in ("plain", "plain-again", "scaled"):
        scaler = GradScaler(init_loss_scaling=AMP_SCALE) \
            if run == "scaled" else None
        model, opt, step, ids = _gpt_step(scaler=scaler,
                                          clip=ClipGradByGlobalNorm(1.0))
        loss = step(ids, ids).item()
        names = [n for n, _ in model.named_parameters()]
        grads[run] = dict(zip(names, opt.captured))
        log(f"[train-amp] {run}: loss {loss:.6f}")
        if run != "scaled":
            del model, opt, step
            torch.cuda.empty_cache()
    _hold_grads("[train-amp]", "unscaled against unscaled",
                grads["plain-again"], grads["plain"])
    _hold_grads("[train-amp]", f"scaled x {AMP_SCALE:g} against unscaled",
                grads["scaled"], grads["plain"])
    if scaler._scale != AMP_SCALE or scaler._good_steps != 1:
        raise AssertionError("[train-amp] a clean step moved the scale")
    snap = [(p.detach().clone(), opt._master_weights[id(p)].clone(),
             {k: v.clone() for k, v in opt._accumulators[id(p)].items()})
            for p in model.parameters()]
    count = opt._step_count
    hook = model.gpt.h[-1].mlp.fc_in.weight.register_hook(
        lambda g: torch.full_like(g, float("inf")))
    try:
        step(ids, ids)
    finally:
        hook.remove()
    for p, (p0, m0, st0) in zip(model.parameters(), snap):
        if not (torch.equal(p, p0)
                and torch.equal(opt._master_weights[id(p)], m0)
                and all(torch.equal(v, st0[k])
                        for k, v in opt._accumulators[id(p)].items())):
            raise AssertionError("[train-amp] the skipped step moved a "
                                 "parameter, master or moment")
    if opt._step_count != count or scaler._scale != AMP_SCALE / 2:
        raise AssertionError(f"[train-amp] step {opt._step_count} (was "
                             f"{count}), scale {scaler._scale}")
    log(f"[train-amp] an inf gradient skipped the update: parameters, "
        f"masters and moments unchanged, step counter {count}, scale "
        f"{AMP_SCALE:g} -> {scaler._scale:g}")


def phase_train_amp_cast():
    """GPT-medium, AMP_CAST's batch 4 x 1024, AdamW(multi_precision), a
    capturing optimizer, AMP_CAST["steps"] TrainStep calls on one batch
    in each of four runs: "fp32" (the fp32 model uncast: the fp32 flash
    bodies), "O1" (the fp32 model, each call inside ``auto_cast()``),
    "O2" (``decorate`` + ``auto_cast(level="O2")``) and "bf16" (the bf16
    model, no AMP: the device work of O2 without the cast mode, so the
    walls show the mode's host cost). Under O1 and O2 the linears hand
    bf16 to the attention: every step launches the bf16 pair kernels, one
    forward and one backward a block, and no fp32 body. O1 keeps the
    parameters fp32; O2 makes them bf16 with fp32 masters. Each run's
    losses are finite and fall; O1's and O2's first loss sit within
    AMP_CAST_LOSS_REL_LIMIT of the uncast one. The relative error of the
    whole first gradient against the uncast one is printed, not gated
    (16 blocks of bf16 rounding; the CPU test gates 2 blocks per leaf)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import (f32_bwd_launch_counts,
                                          f32_fwd_launch_counts,
                                          launch_counts)
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    blocks = GPT_MEDIUM["num_layers"]
    b, L = AMP_CAST["batch"], AMP_CAST["seq"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    ids = torch.randint(0, GPT_MEDIUM["vocab_size"], (b, L), device="cuda",
                        generator=gen)
    runs = {"fp32": (FP32, None), "O1": (FP32, "O1"), "O2": (FP32, "O2"),
            "bf16": (BF16, None)}
    first, grads = {}, {}
    for run, (dtype, level) in runs.items():
        model = GPTForCausalLM(GPTConfig(**GPT_MEDIUM), dtype=dtype,
                               seed=0).train()
        opt = _capturing(AdamW)(learning_rate=1e-4, weight_decay=0.01,
                                parameters=model.parameters(),
                                multi_precision=True)
        if level == "O2":
            amp.decorate(model, opt, level="O2")
        step = TrainStep(model, opt, fast_path=False)
        losses, walls = [], []
        for i in range(AMP_CAST["steps"]):
            before = (launch_counts(), f32_fwd_launch_counts(),
                      f32_bwd_launch_counts())
            t0 = time.perf_counter()
            if level is None:
                loss = step(ids, ids).item()        # synchronises
            else:
                with amp.auto_cast(level=level):
                    loss = step(ids, ids).item()
            walls.append(time.perf_counter() - t0)
            losses.append(loss)
            _expect_launches(f"[train-amp-cast] {run} step {i}",
                             _grew(before[0], launch_counts()),
                             flash_pair_fwd=blocks, flash_pair_bwd=blocks)
            f32 = (f32_fwd_launch_counts()["flash_pair_fwd"]
                   - before[1]["flash_pair_fwd"],
                   f32_bwd_launch_counts()["flash_pair_bwd"]
                   - before[2]["flash_pair_bwd"])
            want = (blocks, blocks) if run == "fp32" else (0, 0)
            if f32 != want:
                raise AssertionError(f"[train-amp-cast] {run} step {i}: fp32 "
                                     f"body launches {f32}, expected {want}")
            if i == 0:
                grads[run] = dict(zip([n for n, _ in
                                       model.named_parameters()],
                                      opt.captured))
        types = {p.dtype for p in model.parameters()}
        want_types = {BF16} if run in ("O2", "bf16") else {FP32}
        if types != want_types or (run == "O2" and len(
                opt._master_weights) != len(list(model.parameters()))):
            raise AssertionError(f"[train-amp-cast] {run}: parameter types "
                                 f"{types}, {len(opt._master_weights)} "
                                 f"masters")
        if not all(math.isfinite(x) for x in losses) \
                or not losses[-1] < losses[0]:
            raise AssertionError(f"[train-amp-cast] {run}: losses {losses}")
        first[run] = losses[0]
        timed = walls[1:]
        log(f"[train-amp-cast] {run}: losses "
            f"{[round(x, 6) for x in losses]}; wall per step "
            f"{sum(timed) / len(timed) * 1e3:.1f} ms (steps 2-"
            f"{AMP_CAST['steps']}; first {walls[0] * 1e3:.1f}); "
            f"{blocks} + {blocks} flash launches a step "
            f"({'fp32' if run == 'fp32' else 'bf16'} bodies)")
        del model, opt, step
        torch.cuda.empty_cache()
    for run in ("O1", "O2"):
        rel = abs(first[run] - first["fp32"]) / abs(first["fp32"])
        err, (leaf_err, leaf) = _grad_errors(grads[run], grads["fp32"])
        log(f"[train-amp-cast] {run} against the uncast fp32 step: first "
            f"loss {first[run]:.6f} vs {first['fp32']:.6f} (relative "
            f"{rel:.3g}, limit {AMP_CAST_LOSS_REL_LIMIT}); whole gradient "
            f"error {err:.3g} (largest leaf {leaf_err:.3g}, {leaf})")
        if not rel <= AMP_CAST_LOSS_REL_LIMIT:
            raise AssertionError(f"[train-amp-cast] {run}: first loss "
                                 f"{rel:.3g} from the uncast step's")


# ------------------------------------------------------------------ monitor

# ------------------------------------------------ checkpoint and resume

# the snapshots of [ckpt-resume] and [ckpt-preempt] (removed after each)
CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "smoke_checkout", "ckpt")
CKPT_STEPS = 4          # the straight run; the resumed runs split it 2 + 2


def _ckpt_batches():
    """CKPT_STEPS distinct batches of TRAIN's geometry (seed 9)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    return [torch.randint(0, GPT_MEDIUM["vocab_size"],
                          (TRAIN["batch"], TRAIN["seq"]), device="cuda",
                          generator=gen) for _ in range(CKPT_STEPS)]


def _train_state(model, opt):
    """Every parameter, moment and master (where the rule keeps one) of a
    run (cloned on the card) and its step count."""
    state = {f"param:{n}": p.detach().clone()
             for n, p in model.named_parameters()}
    for i, p in enumerate(opt._parameter_list):
        for k, t in opt._accumulators[id(p)].items():
            state[f"{k}:{i}"] = t.clone()
        if id(p) in opt._master_weights:
            state[f"master:{i}"] = opt._master_weights[id(p)].clone()
    state["step_count"] = opt._step_count
    return state


def _hold_state(tag, got, want):
    """Raise unless two ``_train_state``s agree bit for bit, every
    tensor and the step count."""
    moved = [k for k in want if not (
        got[k] == want[k] if isinstance(want[k], int)
        else torch.equal(got[k], want[k]))]
    if set(got) != set(want) or moved:
        raise AssertionError(f"{tag}: the resumed run differs from the "
                             f"straight one at {moved[:4]} of {len(want)}")
    log(f"{tag} every parameter, moment and master ({len(want) - 1} "
        f"tensors) and the step count ({want['step_count']}) equal the "
        f"straight run's bit for bit")


def _snapshot_bytes(path):
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    return sum(f["bytes"] for f in ckpt.read_manifest(path)["files"].values())


def phase_ckpt_resume(smi):
    """Checkpoint and exact resume at GPT-medium 16 x 1024 ([train]'s
    recipe, bf16 with fp32 masters, dropout 0): CKPT_STEPS steps straight
    on _ckpt_batches, against a second run: 2 steps, ``save_checkpoint``
    (async, after each step) and ``wait_checkpoint``, then a fresh model,
    optimizer and TrainStep from another seed, ``load_checkpoint`` (step
    2) and the 2 other steps. The losses, every parameter, moment and master and the step
    count equal bit for bit (the flash backwards sum dq in a fixed order).
    Prints the snapshot's bytes, the stall ``save()`` puts on the step loop
    (the host copy: the first save's, which allocates the pinned buffers,
    and the second's, which reuses them), the background write, the load,
    and a ``block=True`` save's time, beside the card. Returns the straight run's losses and
    state (for [ckpt-preempt])."""
    import shutil
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    batches = _ckpt_batches()
    directory = os.path.join(CKPT_DIR, "resume")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    model, opt, step, _ = _train_recipe()
    straight = [step(b, b) for b in batches]
    want = _train_state(model, opt)
    del model, opt, step
    torch.cuda.empty_cache()

    model, opt, step, _ = _train_recipe()
    first = [step(batches[0], batches[0])]
    t0 = time.perf_counter()
    step.save_checkpoint(directory, 1)   # allocates the pinned buffers
    first_stall = time.perf_counter() - t0
    step.wait_checkpoint()
    first.append(step(batches[1], batches[1]))
    t0 = time.perf_counter()
    step.save_checkpoint(directory, 2)   # reuses them
    t1 = time.perf_counter()
    step.wait_checkpoint()
    t2 = time.perf_counter()
    stall, write = t1 - t0, t2 - t1
    copied = step._ckptr.last_bytes
    base = os.path.join(directory, "step_2")
    nbytes = _snapshot_bytes(base)
    del model, opt, step
    torch.cuda.empty_cache()

    model, opt, step, _ = _train_recipe(seed=1)
    t0 = time.perf_counter()
    info = step.load_checkpoint(directory)
    torch.cuda.synchronize()
    load = time.perf_counter() - t0
    if info is None or info["step"] != 2:
        raise AssertionError(f"[ckpt-resume] load_checkpoint gave {info}")
    second = [step(b, b) for b in batches[2:]]
    if not all(torch.equal(a, b) for a, b in zip(first + second, straight)):
        raise AssertionError(f"[ckpt-resume] losses "
                             f"{[x.item() for x in first + second]} against "
                             f"the straight run's "
                             f"{[x.item() for x in straight]}")
    _hold_state("[ckpt-resume]", _train_state(model, opt), want)
    t0 = time.perf_counter()
    step.save_checkpoint(directory, CKPT_STEPS, block=True)
    emergency = time.perf_counter() - t0
    log(f"[ckpt-resume] {smi}: GPT-medium {TRAIN['batch']} x "
        f"{TRAIN['seq']}, losses {[round(x.item(), 6) for x in straight]} "
        f"straight and resumed alike; snapshot {nbytes / 1e9:.3f} GB on "
        f"disk ({copied / 1e9:.3f} GB of tensors copied to pinned host "
        f"memory); stall at save() {stall * 1e3:.1f} ms (the first save, "
        f"which allocates the pinned buffers: {first_stall * 1e3:.1f} ms); "
        f"background write "
        f"{write:.2f} s ({nbytes / write / 1e9:.2f} GB/s, SHA-256 "
        f"included); load {load:.2f} s (verify and copy); a block=True "
        f"save {emergency:.2f} s")
    del model, opt, step
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return straight, want


def phase_ckpt_preempt(smi, straight, want):
    """Preemption at GPT-medium 16 x 1024: under a PreemptionWatcher the
    process sends itself SIGTERM after step 2; the loop's next
    ``requested()`` takes a ``block=True`` save; a fresh model from another
    seed resumes from it and the 2 other steps end bit for bit where
    [ckpt-resume]'s straight run did. The watcher's handler is gone
    afterwards (SIGTERM's handler is the one before it)."""
    import shutil
    import signal
    from paddle_tpu_torch.distributed.preemption import PreemptionWatcher
    batches = _ckpt_batches()
    directory = os.path.join(CKPT_DIR, "preempt")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    prev = signal.getsignal(signal.SIGTERM)
    model, opt, step, _ = _train_recipe()
    saved_at, save_s = None, None
    with PreemptionWatcher() as w:
        for i, b in enumerate(batches):
            step(b, b)
            if i == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            if w.requested():
                t0 = time.perf_counter()
                step.save_checkpoint(directory, i + 1, block=True)
                save_s = time.perf_counter() - t0
                saved_at = i + 1
                break
    if signal.getsignal(signal.SIGTERM) is not prev:
        raise AssertionError("[ckpt-preempt] the watcher's handler outlived "
                             "it")
    if saved_at != 2 or w.signum != signal.SIGTERM:
        raise AssertionError(f"[ckpt-preempt] saved at step {saved_at}, "
                             f"signal {w.signum}")
    del model, opt, step
    torch.cuda.empty_cache()
    model, opt, step, _ = _train_recipe(seed=1)
    if step.load_checkpoint(directory)["step"] != 2:
        raise AssertionError("[ckpt-preempt] resumed from the wrong step")
    tail = [step(b, b) for b in batches[2:]]
    if not all(torch.equal(a, b) for a, b in zip(tail, straight[2:])):
        raise AssertionError(f"[ckpt-preempt] losses after the resume "
                             f"{[x.item() for x in tail]} against "
                             f"{[x.item() for x in straight[2:]]}")
    _hold_state("[ckpt-preempt]", _train_state(model, opt), want)
    log(f"[ckpt-preempt] {smi}: SIGTERM after step 2, the emergency save "
        f"at the next step boundary in {save_s:.2f} s, the handler restored;"
        f" resumed steps 3-4 bit for bit")
    del model, opt, step
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()


MONITOR_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "smoke_checkout", "monitor")
MONITOR_TRAIN_BLOCKS = ("on", "off", "on", "off")     # 3 steps a block
# [monitor-train]'s budget for a health-sampled step: its extra wall over
# an unsampled monitored step, as a share of an off-step. A sampled step
# launches the health reductions and reads them back, launches the host
# paces (4-28 ms more against a ~200 ms step on the H100), so it is held
# apart from the monitor's own overhead, which the unsampled steps carry
# alone
MONITOR_SAMPLED_BUDGET = 0.25
MONITOR_FAULT_LAYERS = 4
MONITOR_FAULT_BATCH = 8


class _env:
    """Set environment variables for a block, then restore them."""

    def __init__(self, **env):
        self.env = env

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _tools_read(tag, *runs):
    """tools/metrics_summary.py, goodput_report.py and trace_view.py exit 0
    on the port's files (``runs``: (jsonl, trace jsonl) pairs)."""
    here = os.path.dirname(os.path.abspath(__file__))
    for jsonl, tjsonl in runs:
        for tool, path in (("metrics_summary.py", jsonl),
                           ("goodput_report.py", jsonl),
                           ("trace_view.py", tjsonl)):
            out = subprocess.run([sys.executable,
                                  os.path.join(here, "tools", tool), path],
                                 capture_output=True, text=True, timeout=120)
            if out.returncode != 0:
                raise AssertionError(f"{tag} tools/{tool} exited "
                                     f"{out.returncode} on {path}: "
                                     f"{out.stderr[-2000:]}")
    log(f"{tag} tools/metrics_summary.py, goodput_report.py and "
        f"trace_view.py exit 0 on the port's files")


def _goodput_identity(tag, gauges):
    from paddle_tpu_torch.monitor.goodput import GOODPUT_STATES
    total = sum(gauges[f"goodput/{s}_s"] for s in GOODPUT_STATES)
    if abs(total - gauges["goodput/wall_s"]) > 1e-9 * max(total, 1.0):
        raise AssertionError(f"{tag} goodput states sum to {total}, wall "
                             f"{gauges['goodput/wall_s']}")
    return total


def phase_monitor_train(smi):
    """[monitor-train]: [train]'s recipe (GPT-medium bf16, 16 x 1024,
    AdamW with masters) under ``monitor.enable(path, trace=True)`` with
    PADDLE_HEALTH_SAMPLE=2: the mint call and one sampled call (it builds
    the digest probes), then 6 steps with the monitor
    on and 6 with it off in blocks of 3 (off: the monitor's and the
    tracer's module globals set to None, the state the disabled path
    reads; the same eager TrainStep throughout), each step synchronised.
    Of the 6 on-steps 3 are health-sampled and 3 are not. The gate holds
    the monitor's own overhead, the unsampled on-steps' mean against the
    off-steps' mean, within [train]'s spread, and a sampled step's extra
    over an unsampled one within MONITOR_SAMPLED_BUDGET of an off-step;
    the ledger's MFU and HFU against the
    H100 peak over the first on-block, and the steady figures of the
    on-steps; the measured and analytic FLOPs a token and the attention
    share of the measured count. The JSONL holds one ``recompile``, the
    goodput gauges sum to the wall, the shared tools read the files."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.kernels import launch_counts
    from paddle_tpu_torch.monitor import trace as mtrace
    os.makedirs(MONITOR_DIR, exist_ok=True)
    path = os.path.join(MONITOR_DIR, "train.jsonl")
    model, opt, step, ids = _train_recipe()
    b, L = ids.shape
    blocks = GPT_MEDIUM["num_layers"]
    with _env(PADDLE_HEALTH_SAMPLE="2"):
        mon = monitor.enable(path, trace=True)
        tracer = mtrace.get()
        t0 = time.perf_counter()
        before = launch_counts()
        losses = [step(ids, ids).item()]
        mint_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        losses.append(step(ids, ids).item())          # sampled: probes built
        probe_s = time.perf_counter() - t0
        _expect_launches("[monitor-train] mint and first sample",
                         _grew(before, launch_counts()),
                         flash_pair_fwd=2 * blocks, flash_pair_bwd=2 * blocks)
        walls = {"on": [], "off": []}
        sampled = []
        first = None
        for i, block in enumerate(MONITOR_TRAIN_BLOCKS):
            if block == "off":
                monitor._active = mtrace._active = None
            for _ in range(3):
                before = launch_counts()
                n = step._health_n
                t0 = time.perf_counter()
                losses.append(step(ids, ids).item())     # synchronises
                walls[block].append(time.perf_counter() - t0)
                if block == "on":
                    sampled.append(step._health_n != n
                                   and step._health_n % 2 == 0)
                _expect_launches(f"[monitor-train] {block}",
                                 _grew(before, launch_counts()),
                                 flash_pair_fwd=blocks, flash_pair_bwd=blocks)
            monitor._active, mtrace._active = mon, tracer
            if first is None:
                first = monitor.snapshot()["gauges"]
        last = monitor.snapshot()["gauges"]
        cost = step._mint_cost
        monitor.disable()
    if not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"[monitor-train] losses {losses}")
    recs = _records(path)
    kinds = [r["kind"] for r in recs]
    if kinds.count("recompile") != 1:
        raise AssertionError(f"[monitor-train] {kinds.count('recompile')} "
                             f"recompile records, expected 1")
    if kinds.count("step") != 7:            # the first sample and 6 on
        raise AssertionError(f"[monitor-train] {kinds.count('step')} step "
                             f"records, expected 7")
    for g in (first, last):
        _goodput_identity("[monitor-train]", g)
    on = sum(walls["on"]) / 6 * 1e3
    off = sum(walls["off"]) / 6 * 1e3
    spread = (max(TRAIN_WALLS) - min(TRAIN_WALLS)) * 1e3 if TRAIN_WALLS \
        else (max(walls["off"]) - min(walls["off"])) * 1e3
    tokens = b * L
    measured = last["mfu/train_bucket1/flops"]
    analytic = last["mfu/train_bucket1/analytic_flops"]
    peak = last.get("mfu/peak_flops")
    if peak is None:
        raise AssertionError(f"[monitor-train] no peak for "
                             f"{torch.cuda.get_device_name(0)}")
    steady_on = min(walls["on"])
    samp = [w * 1e3 for w, s in zip(walls["on"], sampled) if s]
    unsamp = [w * 1e3 for w, s in zip(walls["on"], sampled) if not s]
    if min(len(samp), len(unsamp), len(walls["off"])) < 3:
        raise AssertionError(f"[monitor-train] {len(samp)} sampled, "
                             f"{len(unsamp)} unsampled and "
                             f"{len(walls['off'])} off-steps: each mean "
                             f"needs 3 readings")
    log(f"[monitor-train] {smi}: mint call {mint_s * 1e3:.1f} ms (FLOPs "
        f"counted, recorded as compile), first sampled call "
        f"{probe_s * 1e3:.1f} ms (probes built); on {on:.2f} ms a step "
        f"({', '.join(f'{w * 1e3:.2f}' for w in walls['on'])}; sampled "
        f"{sum(samp) / len(samp):.2f}, unsampled "
        f"{sum(unsamp) / len(unsamp):.2f}), off {off:.2f} ms "
        f"({', '.join(f'{w * 1e3:.2f}' for w in walls['off'])}), overhead "
        f"{on - off:+.2f} ms a step ({(on - off) / off:+.2%}); [train]'s "
        f"spread {spread:.2f} ms")
    log(f"[monitor-train] FLOPs a token: measured {measured / tokens:.4e} "
        f"(attention, reported by the flash wrappers: "
        f"{cost.kernel / tokens:.4e}, {cost.kernel / measured:.2%} of the "
        f"count), analytic 6N + 12LdS {analytic / tokens:.4e} "
        f"(measured / analytic {measured / analytic:.4f})")
    log(f"[monitor-train] ledger against the H100 peak {peak:.4g} FLOP/s "
        f"({smi}): after the first on-block MFU {first['mfu/mfu']:.4f} HFU "
        f"{first['mfu/hfu']:.4f} (goodput {first['goodput/fraction']:.4f}, "
        f"the mint's wall counted as compile); at the end MFU "
        f"{last['mfu/mfu']:.4f} HFU {last['mfu/hfu']:.4f} (the off-blocks "
        f"counted idle); at the fastest on-step, as the ledger defines them "
        f"(no recompute: model FLOPs = measured): MFU = HFU "
        f"{measured / steady_on / peak:.4f}; from the analytic count "
        f"{analytic / steady_on / peak:.4f}")
    unsamp_ms = sum(unsamp) / len(unsamp)
    extra = sum(samp) / len(samp) - unsamp_ms
    log(f"[monitor-train] gate ({smi}): unsampled on-steps "
        f"{unsamp_ms:.2f} ms against off {off:.2f} ms: the monitor's "
        f"overhead {unsamp_ms - off:+.2f} ms (limit [train]'s spread "
        f"{spread:.2f} ms); a sampled step {extra:+.2f} ms over an "
        f"unsampled one = {extra / off:.4f} of an off-step (budget "
        f"{MONITOR_SAMPLED_BUDGET})")
    if not abs(unsamp_ms - off) <= spread:
        raise AssertionError(f"[monitor-train] overhead {unsamp_ms - off:.2f}"
                             f" ms a step exceeds [train]'s spread "
                             f"{spread:.2f} ms")
    if not extra <= MONITOR_SAMPLED_BUDGET * off:
        raise AssertionError(f"[monitor-train] a sampled step costs "
                             f"{extra:.2f} ms over an unsampled one, above "
                             f"{MONITOR_SAMPLED_BUDGET} of an off-step")
    _tools_read("[monitor-train]",
                (path, path.replace(".jsonl", ".trace.jsonl")))
    del model, opt, step
    return dict(on=on, off=off, spread=spread, unsampled=unsamp_ms,
                sampled_extra=extra, mfu=measured / steady_on / peak)


def phase_monitor_health_fault():
    """[monitor-health-fault]: GPT-medium width at 4 blocks, batch 8 x
    1024, PADDLE_HEALTH_SAMPLE=2 and PADDLE_HEALTH_FAULT=nan@param:3: the
    NaN planted before call 3 trips at the next sample (step 4) with one
    WARN naming the poisoned leaf's group (``gpt.wte``: the first
    trainable parameter), one ``health_nan`` record and one flight
    dump."""
    import warnings
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    os.makedirs(MONITOR_DIR, exist_ok=True)
    path = os.path.join(MONITOR_DIR, "fault.jsonl")
    model = GPTForCausalLM(GPTConfig(**dict(
        GPT_MEDIUM, num_layers=MONITOR_FAULT_LAYERS)), dtype=torch.bfloat16,
        seed=0)
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.parameters(), multi_precision=True)
    step = TrainStep(model, opt, fast_path=False)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    ids = torch.randint(0, GPT_MEDIUM["vocab_size"],
                        (MONITOR_FAULT_BATCH, TRAIN["seq"]), device="cuda",
                        generator=gen)
    with _env(PADDLE_HEALTH_SAMPLE="2", PADDLE_HEALTH_FAULT="nan@param:3"), \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mon = monitor.enable(path, trace=True)
        losses = [step(ids, ids).item() for _ in range(4)]
        trips, dumps = mon.health.nan_trips, mon.health._dumps
        monitor.disable()
    warns = [str(w.message) for w in caught
             if "non-finite values" in str(w.message)]
    recs = _records(path)
    nan = [r for r in recs if r["kind"] == "health_nan"]
    if not (math.isfinite(losses[1]) and not math.isfinite(losses[2])):
        raise AssertionError(f"[monitor-health-fault] losses {losses}")
    if trips != 1 or len(nan) != 1 or nan[0]["step"] != 4 \
            or len(warns) != 1:
        raise AssertionError(f"[monitor-health-fault] trips {trips}, "
                             f"records {len(nan)}, warnings {warns}")
    if "gpt.wte" not in nan[0]["groups"] or "gpt.wte" not in warns[0]:
        raise AssertionError(f"[monitor-health-fault] the WARN does not "
                             f"name gpt.wte: {warns[0][:300]}")
    if dumps != 1 or not os.path.exists(nan[0]["dump"]):
        raise AssertionError(f"[monitor-health-fault] {dumps} flight dumps")
    log(f"[monitor-health-fault] nan@param:3 on {MONITOR_FAULT_LAYERS} "
        f"blocks: losses {[round(x, 4) for x in losses]}; tripped at step "
        f"{nan[0]['step']} (the next sample), {len(nan[0]['groups'])} "
        f"groups non-finite, the WARN names gpt.wte; "
        f"{len(nan[0]['leaves'])} poisoned leaves swept; 1 flight dump "
        f"({os.path.basename(nan[0]['dump'])})")
    del model, opt, step


def phase_monitor_engine(model, graph_reqs, graph):
    """[monitor-engine]: [engine-graph]'s 8 requests through a graphed
    paged engine with monitor and tracer on: every request one trace of
    queue, prefill and decode; ``serve_compile`` records equal to
    ``compile_count`` (2) and none in the drain; tokens identical to
    [engine-graph]'s, tokens/s beside its reading; then a prompt-lookup
    drafter's run whose verify steps reach ``serve_spec_step``."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.serving import DecodeEngine, PromptLookupDrafter
    os.makedirs(MONITOR_DIR, exist_ok=True)
    path = os.path.join(MONITOR_DIR, "engine.jsonl")
    prompts, new_tokens = _gpt_requests()
    torch.cuda.empty_cache()
    mon = monitor.enable(path, trace=True)
    eng = DecodeEngine(model, **ENGINE)
    gen = torch.Generator()
    gen.manual_seed(99)
    warm = torch.randint(0, model.config.vocab_size, (40,),
                         generator=gen).tolist()
    eng.submit(warm, max_new_tokens=2)
    eng.run()
    torch.cuda.synchronize()
    compiled = mon.registry.counter("serve/compiles").value
    reqs, steps, wall, _, _ = _serve(eng, prompts, new_tokens)
    rate = (eng.stats()["tokens_generated"] - 2) / wall
    st_counters = mon.registry.snapshot()["counters"]
    spec = DecodeEngine(model, drafter=PromptLookupDrafter(), **ENGINE)
    spec_reqs, _, spec_wall, _, _ = _serve(spec, prompts, new_tokens)
    spec_steps = mon.registry.counter("serve/spec_steps").value
    monitor.disable()
    if compiled != 2 or eng.compile_count != 2 \
            or st_counters["serve/compiles"] != 2:
        raise AssertionError(f"[monitor-engine] serve_compile {compiled} "
                             f"after the warm-up, "
                             f"{st_counters['serve/compiles']} after the "
                             f"drain, compile_count {eng.compile_count}")
    diff = [r.id for r, g in zip(reqs, graph_reqs) if r.tokens != g.tokens]
    if diff:
        raise AssertionError(f"[monitor-engine] tokens differ from "
                             f"[engine-graph]'s in requests {diff}")
    recs = _records(path)
    engine_ids = {eng.engine_id}
    compiles = [r for r in recs if r["kind"] == "serve_compile"
                and r["engine"] in engine_ids]
    if len(compiles) != eng.compile_count:
        raise AssertionError(f"[monitor-engine] {len(compiles)} "
                             f"serve_compile records")
    tr = _records(path.replace(".jsonl", ".trace.jsonl"))
    by_req = {}
    names = {}
    for r in tr:
        if r["kind"] == "span":
            names.setdefault(r["trace"], []).append(r["name"])
        if r["kind"] == "trace" and r["attrs"].get("engine") in engine_ids:
            by_req.setdefault(r["attrs"]["request"], []).append(r["trace"])
    want = [r.id for r in reqs]
    if any(len(by_req.get(i, [])) != 1 for i in want):
        raise AssertionError(f"[monitor-engine] traces per request "
                             f"{ {i: len(by_req.get(i, [])) for i in want} }")
    for i in want:
        got = names[by_req[i][0]]
        if got != ["request", "queue", "prefill", "decode"]:
            raise AssertionError(f"[monitor-engine] request {i} spans {got}")
    if spec_steps < 1 or spec_steps != spec.stats()["spec"]["steps"]:
        raise AssertionError(f"[monitor-engine] serve/spec_steps "
                             f"{spec_steps}, engine {spec.stats()['spec']}")
    spec_rate = sum(len(r.tokens) for r in spec_reqs) / spec_wall
    log(f"[monitor-engine] {len(reqs)} requests in {steps} steps, "
        f"{wall:.3f} s: {rate:.1f} tokens/s with monitor and tracer on "
        f"([engine-graph], off, same run: {graph['rate']:.1f}; "
        f"{rate / graph['rate'] - 1:+.2%}); tokens identical; one trace a "
        f"request (queue, prefill, decode); serve_compile 2 = compile_count "
        f"after the warm-up, 0 in the drain; prompt-lookup run: "
        f"{spec_steps} serve_spec_step calls, {spec_rate:.1f} tokens/s")
    _tools_read("[monitor-engine]",
                (path, path.replace(".jsonl", ".trace.jsonl")))
    del eng, spec
    return dict(rate=rate, off=graph["rate"])


# ------------------------------------------------- serving guardrails, fleet

# the fleet phases' engines: bench.py decode --paged / --router's geometry
FLEET_ENGINE = dict(max_slots=8, max_len=256, block_size=16,
                    prefill_chunk=32)
GUARD_FAULTS = ("raise@alloc:20,raise@alloc:45,raise@admit:3,"
                "slow@chunk:4:0.003,slow@decode:6:0.003")
HANG_S = 0.25                   # [guard-hang]'s watchdog threshold
HANG_SLEEP_CYCLES = 2_000_000_000   # ~1 s of device clock at 1.98 GHz
HANG_RATE_ROUNDS = 5            # [guard-hang]'s armed-vs-unarmed drains
FLEET_PROMPTS = 16              # [fleet-router]'s prompts, two groups
FLEET_NEW = 48
FLEET_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "smoke_checkout", "fleet")
POOL_ROUNDS = 5                 # [fleet-pool]'s rounds, the first a warm-up
FLEET_HTTP_BLOCKS = 4           # [fleet-http]'s workers: GPT-medium widths
FLEET_HTTP_TICKETS = 8
FLEET_PUBLISH_S = 0.5


def _drive(eng, reqs, limit=4000, each=None):
    """Step ``eng`` until every request is terminal, its invariants after
    every step (``each(step)`` first, when given). Returns the steps."""
    steps = 0
    while not all(r.finished for r in reqs):
        if each is not None:
            each(steps)
        eng.step()
        eng.check_invariants()
        steps += 1
        if steps > limit:
            raise AssertionError(f"engine did not finish in {limit} steps: "
                                 f"{[r.status for r in reqs]}")
    return steps


def _warmed(model, **kw):
    """A graphed engine at ``FLEET_ENGINE`` (or ``ENGINE`` when
    ``max_slots`` is given) whose chunk and decode programs are built and
    captured by a warm-up request of 40 tokens (seed 99)."""
    from paddle_tpu_torch.serving import DecodeEngine
    geom = dict(ENGINE) if kw.pop("engine", False) else dict(FLEET_ENGINE)
    eng = DecodeEngine(model, **geom, **kw)
    _warm(eng, model.config.vocab_size, [40], new=2)
    _all_captured("[warm]", eng._programs, 2)
    return eng


def phase_guard_chaos(model, graph_reqs):
    """[guard-chaos]: the graphed engine at [engine-graph]'s geometry
    under ``PADDLE_SERVE_FAULT`` (two injected allocation failures, an
    injected admission failure, slow chunk and decode calls) with a queue
    deadline and a cancel, on [engine-graph]'s prompts: every request
    terminal, invariants after every step, compile_count 2 throughout, and
    every request that ends done has [engine-graph]'s tokens."""
    from paddle_tpu_torch.serving import FaultSchedule, TERMINAL_STATUSES
    prompts, new_tokens = _gpt_requests()
    with _env(PADDLE_SERVE_FAULT=GUARD_FAULTS):
        eng = _warmed(model, engine=True)
    if eng._faults is None or eng._faults.entries \
            != FaultSchedule.parse(GUARD_FAULTS).entries:
        raise AssertionError("[guard-chaos] the env schedule was not read")
    t0 = time.perf_counter()
    reqs = [eng.submit(prompts[0], max_new_tokens=new_tokens[0])]
    while reqs[0].status in ("queued", "prefilling"):
        eng.step()
        eng.check_invariants()
    for i, (p, n) in enumerate(zip(prompts[1:], new_tokens[1:]), 1):
        reqs.append(eng.submit(p, max_new_tokens=n,
                               deadline_s=0.0 if i == 6 else None))

    def each(step):
        if step == 4 and not reqs[4].finished:
            eng.cancel(reqs[4])
    steps = _drive(eng, reqs, each=each)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    statuses = [r.status for r in reqs]
    if not set(statuses) <= TERMINAL_STATUSES:
        raise AssertionError(f"[guard-chaos] statuses {statuses}")
    if eng.compile_count != 2:
        raise AssertionError(f"[guard-chaos] compile_count "
                             f"{eng.compile_count} under faults")
    want = {"expired", "cancelled", "failed", "done"}
    if set(statuses) != want or eng.preemptions < 1:
        raise AssertionError(f"[guard-chaos] statuses {statuses}, "
                             f"preemptions {eng.preemptions}: the schedule "
                             f"did not reach every path")
    diff = [r.id for r, g in zip(reqs, graph_reqs)
            if r.status == "done" and r.tokens != g.tokens]
    if diff:
        raise AssertionError(f"[guard-chaos] tokens differ from "
                             f"[engine-graph]'s in requests {diff}")
    fired = {s: eng._faults.fired(s) for s in ("alloc", "admit", "chunk",
                                               "decode")}
    g = eng.stats()["guardrails"]
    log(f"[guard-chaos] {GUARD_FAULTS}: {len(reqs)} requests terminal in "
        f"{steps} steps, {wall:.3f} s ({statuses}); preemptions "
        f"{eng.preemptions}, expired {g['expired']}, cancelled "
        f"{g['cancelled']}; sites fired {fired}; invariants held after "
        f"every step; compile_count 2; the {statuses.count('done')} done "
        f"requests' tokens identical to [engine-graph]'s")
    eng.close()


class _DeviceSleep:
    """A program's call with ``torch.cuda._sleep`` enqueued on the current
    stream before the replay: the host returns from the launch at once and
    blocks in the read of the output, while the card sleeps."""

    def __init__(self, prog, cycles):
        self.prog, self.cycles = prog, cycles
        self.state = prog.state
        self.building = prog.building

    def __call__(self):
        torch.cuda._sleep(self.cycles)
        self.prog()


def phase_guard_hang(model, graph_reqs, smi):
    """[guard-hang]: (1) ``hang_s`` with a ``slow@decode`` far past it (the
    fault waits for the watchdog, at most 30 s): the WARN, the flight dump
    and ``EngineHangError``, every request failed, invariants held, and
    the reused engine's next request healthy with [engine-graph]'s
    tokens; (2) the same threshold against the device: the decode
    program's call wrapped (here, not in the package) to sleep on the card
    before its replay, so the host waits in the output's read, and the
    watchdog fires from its thread while it waits; (3) tokens/s of
    [engine-graph]'s requests with the watchdog armed (30 s, never firing),
    armed with a thread that arming never wakes, and unarmed, same
    process, in turns."""
    import threading
    import warnings
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.serving import EngineHangError, FaultSchedule
    prompts, new_tokens = _gpt_requests()
    os.makedirs(MONITOR_DIR, exist_ok=True)
    path = os.path.join(MONITOR_DIR, "hang.jsonl")
    flight = path.replace(".jsonl", ".flight.json")
    if os.path.exists(flight):
        os.remove(flight)
    monitor.enable(path)
    eng = _warmed(model, engine=True, hang_s=HANG_S,
                  fault_schedule=FaultSchedule.parse("slow@decode:3:30"))
    fired = threading.Event()
    on_hang = eng._watchdog._on_hang

    def hook(info, elapsed_s):
        try:
            on_hang(info, elapsed_s)
        finally:
            fired.set()
    eng._watchdog._on_hang = hook
    eng._faults.sleep = fired.wait
    doomed = [eng.submit(p, max_new_tokens=n)
              for p, n in zip(prompts[:2], new_tokens[:2])]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            eng.run()
        except EngineHangError as e:
            err = str(e)
        else:
            raise AssertionError("[guard-hang] no EngineHangError")
    warned = [str(w.message) for w in caught
              if "dispatch hang" in str(w.message)]
    if not fired.is_set() or len(warned) != 1 \
            or not os.path.exists(flight):
        raise AssertionError(f"[guard-hang] hang fired {fired.is_set()}, "
                             f"WARNs {warned}, flight dump "
                             f"{os.path.exists(flight)}")
    eng.check_invariants()
    if any(r.status != "failed" for r in doomed):
        raise AssertionError(f"[guard-hang] {[r.status for r in doomed]}")
    # the failed requests' prompts stay registered: drop them, so the
    # request prefills from 0 as [engine-graph]'s did
    eng.drop_prefix_cache()
    ok = eng.submit(prompts[0], max_new_tokens=new_tokens[0])
    eng.run()
    if ok.status != "done" or ok.tokens != graph_reqs[0].tokens \
            or eng.compile_count != 2:
        raise AssertionError(f"[guard-hang] the reused engine: {ok.status}, "
                             f"compile_count {eng.compile_count}")
    hangs = [r for r in _records(path) if r["kind"] == "serve_hang"]
    log(f"[guard-hang] slow@decode past hang_s {HANG_S}: WARN and "
        f"serve_hang ({hangs[0]['elapsed_s']:.3f} s), flight dump "
        f"{os.path.basename(flight)}, EngineHangError ({err[:60]}...); "
        f"both requests failed, invariants held; the next request on the "
        f"same engine done with [engine-graph]'s tokens")
    # (2) the card sleeps before the replay; the host waits in the read
    orig = eng._program
    sleeping = {"on": True}

    def program(key, build):
        prog = orig(key, build)
        if key == ("decode",) and sleeping["on"]:
            return _DeviceSleep(prog, HANG_SLEEP_CYCLES)
        return prog
    eng._program = program
    eng._faults = None
    req = eng.submit(prompts[1], max_new_tokens=new_tokens[1])
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            eng.run()
        except EngineHangError as e:
            err = str(e)
        else:
            raise AssertionError("[guard-hang] the device-side sleep "
                                 "raised no EngineHangError")
    blocked = time.perf_counter() - t0
    warned = [str(w.message) for w in caught
              if "dispatch hang" in str(w.message)]
    if len(warned) != 1 or blocked < 2 * HANG_S \
            or eng._watchdog.hangs != 2 or req.status != "failed":
        raise AssertionError(f"[guard-hang] device sleep: WARNs {warned}, "
                             f"blocked {blocked:.3f} s, hangs "
                             f"{eng._watchdog.hangs}, {req.status}")
    sleeping["on"] = False
    eng.drop_prefix_cache()
    ok = eng.submit(prompts[1], max_new_tokens=new_tokens[1])
    eng.run()
    if ok.status != "done" or ok.tokens != graph_reqs[1].tokens:
        raise AssertionError("[guard-hang] unhealthy after the device "
                             "sleep")
    monitor.disable()
    eng.close()
    log(f"[guard-hang] the card slept {HANG_SLEEP_CYCLES} cycles before "
        f"the decode replay: the host blocked {blocked:.3f} s in the "
        f"output's read and the watchdog fired from its thread meanwhile "
        f"(hang_s {HANG_S}): the window covers the device's work; the "
        f"next request healthy")
    # (3) armed (never firing) against unarmed, and armed with a thread
    # that arming never wakes (what the notify costs): one engine each,
    # served in turns, the first arm rotating, the prefix cache dropped
    # before each drain
    engines = {"off": _warmed(model, engine=True),
               "armed": _warmed(model, engine=True, hang_s=30.0),
               "quiet": _warmed(model, engine=True, hang_s=30.0)}
    _arm_quietly(engines["quiet"]._watchdog)
    rates = {arm: [] for arm in engines}
    order = list(engines)
    for i in range(HANG_RATE_ROUNDS):
        for arm in order[i % 3:] + order[:i % 3]:
            e = engines[arm]
            e.drop_prefix_cache()
            before = e.tokens_generated
            reqs, _, wall, _, _ = _serve(e, prompts, new_tokens)
            if [r.tokens for r in reqs] != [g.tokens for g in graph_reqs]:
                raise AssertionError(f"[guard-hang] {arm}: tokens differ")
            rates[arm].append((e.tokens_generated - before) / wall)
    if engines["armed"]._watchdog.hangs or engines["quiet"]._watchdog.hangs:
        raise AssertionError("[guard-hang] the armed watchdog fired")
    for e in engines.values():
        e.close()
    med = {arm: float(np.median(r)) for arm, r in rates.items()}
    span = {arm: f"{min(r):.1f}-{max(r):.1f}" for arm, r in rates.items()}
    log(f"[guard-hang] tokens/s over {HANG_RATE_ROUNDS} drains each, in "
        f"turns: armed (hang_s 30) median {med['armed']:.1f} "
        f"({span['armed']}), armed with the thread never woken "
        f"{med['quiet']:.1f} ({span['quiet']}), unarmed {med['off']:.1f} "
        f"({span['off']}); armed/unarmed {med['armed'] / med['off']:.4f}, "
        f"never woken/unarmed {med['quiet'] / med['off']:.4f} ({smi})")
    return med


def _arm_quietly(wd):
    """Make ``wd.arm`` open its window without notifying the watchdog's
    thread, which then stays in its untimed idle wait: an armed call's
    lock and bookkeeping alone, for [guard-hang]'s rates (with hang_s 30
    no window is meant to fire)."""
    def arm(**info):
        with wd._cond:
            wd.fired = None
            wd._armed = info
            wd._armed_at = time.monotonic()
    wd.arm = arm


def phase_guard_drain(model, graph_reqs):
    """[guard-drain]: ``drain_on_preemption`` under a ``PreemptionWatcher``
    with the phase sending itself SIGTERM once [engine-graph]'s 8 requests
    decode and 8 more wait (the engine's 16 slots full): the next step
    begins the drain, the live slots finish within the grace with
    [engine-graph]'s tokens, the queue ends ``rejected_draining``, the
    monitor hears ``serve_drain_begin`` / ``serve_drain_end``, and the
    SIGTERM handler is restored."""
    import signal
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.distributed.preemption import PreemptionWatcher
    prompts, new_tokens = _gpt_requests()
    os.makedirs(MONITOR_DIR, exist_ok=True)
    path = os.path.join(MONITOR_DIR, "drain.jsonl")
    before = signal.getsignal(signal.SIGTERM)
    monitor.enable(path)
    eng = _warmed(model, engine=True)
    gen = torch.Generator()
    gen.manual_seed(7)
    with PreemptionWatcher() as watcher:
        eng.drain_on_preemption(watcher, grace_s=120.0)
        live = [eng.submit(prompts[0], max_new_tokens=new_tokens[0])]
        while live[0].status in ("queued", "prefilling"):
            eng.step()
        live += [eng.submit(p, max_new_tokens=n)
                 for p, n in zip(prompts[1:], new_tokens[1:])]
        live += [eng.submit(torch.randint(0, model.config.vocab_size, (64,),
                                          generator=gen).tolist(),
                            max_new_tokens=64) for _ in range(8)]
        waiting = [eng.submit(p, max_new_tokens=n)
                   for p, n in zip(prompts, new_tokens)]
        while any(r.status in ("queued", "prefilling") for r in live):
            eng.step()
        t0 = time.perf_counter()
        os.kill(os.getpid(), signal.SIGTERM)
        steps = _drive(eng, live + waiting)
        wall = time.perf_counter() - t0
        signum = watcher.signum
    monitor.disable()
    if signal.getsignal(signal.SIGTERM) != before:
        raise AssertionError("[guard-drain] SIGTERM handler not restored")
    if signum != signal.SIGTERM or not eng.drained or eng.drains != 1:
        raise AssertionError(f"[guard-drain] signal {signum}, drained "
                             f"{eng.drained}, drains {eng.drains}")
    if any(r.status != "done" for r in live) \
            or any(r.status != "rejected_draining" for r in waiting):
        raise AssertionError(f"[guard-drain] live {[r.status for r in live]}"
                             f", queued {[r.status for r in waiting]}")
    diff = [r.id for r, g in zip(live, graph_reqs) if r.tokens != g.tokens]
    if diff:
        raise AssertionError(f"[guard-drain] tokens differ from "
                             f"[engine-graph]'s in requests {diff}")
    kinds = [r["kind"] for r in _records(path)]
    if "serve_drain_begin" not in kinds or "serve_drain_end" not in kinds:
        raise AssertionError("[guard-drain] drain records missing")
    late = eng.submit(prompts[0], max_new_tokens=4)
    if late.status != "rejected_draining":
        raise AssertionError(f"[guard-drain] the door: {late.status}")
    end = [r for r in _records(path) if r["kind"] == "serve_drain_end"][0]
    log(f"[guard-drain] SIGTERM -> drain: {len(live)} live requests done "
        f"within the grace in {steps} steps, {wall:.3f} s "
        f"(serve_drain_end wall_s {end['wall_s']:.3f}); {len(waiting)} "
        f"queued ended rejected_draining; the door bounces; tokens of "
        f"[engine-graph]'s 8 identical; handler restored")
    eng.close()


def _fleet_prompts(vocab, n=FLEET_PROMPTS, seed=5):
    """Two one-block (16-token) shared prefixes and ``n`` prompts, each
    opening with one of them (0, 0, 1, 1, 0, ...: out of step with a
    two-engine round-robin) and a random tail of 16 to 96 tokens."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    bs = FLEET_ENGINE["block_size"]
    prefixes = [torch.randint(0, vocab, (bs,), generator=gen).tolist()
                for _ in range(2)]
    prompts = []
    for i in range(n):
        tail = int(torch.randint(16, 97, (1,), generator=gen))
        prompts.append(prefixes[(i // 2) % 2] + torch.randint(
            0, vocab, (tail,), generator=gen).tolist())
    return prefixes, prompts


class _LocalFleet:
    """Named graphed engines on a LocalDirectory behind one Router, each
    warmed with one of the shared prefixes (bench.py decode --router)."""

    def __init__(self, model, prefixes, policy):
        from paddle_tpu_torch.serving import LocalDirectory, Router
        self.model, self.prefixes = model, prefixes
        self.directory = LocalDirectory()
        self.router = Router(self.directory, policy=policy, stale_after=1e9,
                             eject_after=2)
        self.engines, self.endpoints = {}, {}
        for i in range(2):
            self.make(f"eng{i}", prefixes[i])

    def make(self, name, prefix):
        from paddle_tpu_torch.serving import (DecodeEngine, EngineEndpoint,
                                              LocalEngineClient)
        eng = DecodeEngine(self.model, **FLEET_ENGINE)
        warm = eng.submit(prefix + prefix, max_new_tokens=2)
        eng.run()
        if warm.status != "done" or eng.compile_count != 2:
            raise AssertionError(f"[fleet-router] warm-up of {name}")
        old = self.engines.get(name)
        if old is not None:
            old.close()
            self.endpoints[name].deregister()
        self.engines[name] = eng
        self.endpoints[name] = EngineEndpoint(eng, name, self.directory,
                                              ttl_s=30.0)
        self.endpoints[name].publish()
        self.router.attach(name, LocalEngineClient(eng))
        return eng

    def step(self):
        for name, eng in list(self.engines.items()):
            client = self.router._clients.get(name)
            if client is not None and getattr(client, "dead", False):
                continue              # the killed engine: nobody steps it
            eng.step()
            eng.check_invariants()
            self.endpoints[name].publish()

    def compiles(self):
        return {n: e.compile_count for n, e in self.engines.items()}

    def close(self):
        for eng in self.engines.values():
            eng.close()


def _fleet_run(fleet, prompts, ids, kill_at=None):
    """Route ``prompts`` at once under ``ids``, step the fleet and poll the
    router until every ticket is terminal; ``kill_at`` kills eng1 after
    that many steps. Returns (tickets, wall s, generated tokens)."""
    t0 = time.perf_counter()
    tickets = [fleet.router.route(p, max_new_tokens=FLEET_NEW,
                                  request_id=i) for p, i in zip(prompts, ids)]
    steps = 0
    while not all(t.finished for t in tickets):
        if kill_at is not None and steps == kill_at:
            fleet.router._clients["eng1"].kill()
        fleet.step()
        fleet.router.poll()
        steps += 1
        if steps > 4000:
            raise AssertionError("[fleet-router] tickets did not finish")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return tickets, wall, sum(len(t.tokens) for t in tickets)


def phase_fleet_router(model, smi):
    """[fleet-router]: two in-process graphed GPT-medium engines (8 slots,
    max_len 256, block 16, chunk 32) behind ``Router(LocalDirectory)``, as
    bench.py decode --router 2 builds them, each warmed with one of two
    one-block shared prefixes; 16 prompts opening with one or the other,
    48 new tokens each, routed under affinity, then under round-robin on
    fresh engines, twice in turns: tokens/s and the affinity hit rate of
    each, every
    ticket's tokens those of a single graphed engine, compile_count flat.
    Then eng1 killed (``LocalEngineClient.kill()``) mid-run: ejected, its
    tickets requeued under the same ids, every ticket done with the
    reference tokens, each id done on exactly one engine; then
    ``rolling_restart`` over the fleet with a fresh engine for each name
    drops no request."""
    vocab = model.config.vocab_size
    prefixes, prompts = _fleet_prompts(vocab)
    from paddle_tpu_torch.serving import DecodeEngine
    ref = DecodeEngine(model, **FLEET_ENGINE)
    for p in prefixes:
        ref.submit(p + p, max_new_tokens=2)
    ref.run()
    ref_reqs = [ref.submit(p, max_new_tokens=FLEET_NEW) for p in prompts]
    _drive(ref, ref_reqs)
    want = {tuple(p): r.tokens for p, r in zip(prompts, ref_reqs)}
    if any(r.status != "done" for r in ref_reqs):
        raise AssertionError("[fleet-router] the reference engine")
    ref.close()
    del ref

    def check(tag, tickets):
        bad = [t.id for t in tickets if t.status != "done"
               or t.tokens != want[tuple(t.prompt)]]
        if bad:
            raise AssertionError(f"[fleet-router] {tag}: tickets {bad} "
                                 f"not done with the single engine's tokens "
                                 f"({[(t.status, t.error) for t in tickets]})")
    results = {}
    for rnd, policy in enumerate(("affinity", "round_robin") * 2):
        fleet = _LocalFleet(model, prefixes, policy)
        warm = fleet.compiles()
        hits0 = sum(e._pager.shared_hits for e in fleet.engines.values())
        tickets, wall, toks = _fleet_run(
            fleet, prompts,
            [f"{policy}-{rnd}-{i}" for i in range(len(prompts))])
        check(policy, tickets)
        if fleet.compiles() != warm:
            raise AssertionError(f"[fleet-router] {policy}: programs built "
                                 f"in steady state {fleet.compiles()}")
        view = fleet.router.fleet_view()
        hits = sum(e._pager.shared_hits
                   for e in fleet.engines.values()) - hits0
        placed = {n: sum(t.engine == n for t in tickets)
                  for n in fleet.engines}
        prev = results.get(policy, {}).get("rates", [])
        results[policy] = dict(rates=prev + [toks / wall], hit=view[
            "affinity_hit_rate"], prefix_hits=hits, placed=placed)
        fleet.close()
        del fleet
    if results["affinity"]["hit"] < 0.99 \
            or results["affinity"]["prefix_hits"] != len(prompts) \
            or results["round_robin"]["prefix_hits"] >= len(prompts):
        raise AssertionError(f"[fleet-router] affinity placement: "
                             f"{results}")
    for policy, r in results.items():
        log(f"[fleet-router] {policy}: {len(prompts)} tickets, "
            f"{r['rates'][0]:.1f} and {r['rates'][1]:.1f} tokens/s (fleet "
            f"total, two fleets in turns with the other policy's), "
            f"affinity hit rate "
            f"{r['hit']:.3f}, admissions that adopted the prefix "
            f"{r['prefix_hits']}, "
            f"placed {r['placed']}; tokens identical to one engine's; "
            f"compile_count flat ({smi})")
    # kill eng1 mid-run
    fleet = _LocalFleet(model, prefixes, "affinity")
    warm = fleet.compiles()
    ids = [f"kill-{i}" for i in range(len(prompts))]
    tickets, wall, _ = _fleet_run(fleet, prompts, ids, kill_at=6)
    check("kill", tickets)
    r = fleet.router
    if "eng1" not in r._ejected or r.counters["requeues"] < 1 \
            or fleet.engines["eng0"].compile_count != warm["eng0"]:
        raise AssertionError(f"[fleet-router] kill: {r.counters}, ejected "
                             f"{sorted(r._ejected)}")
    twice = [i for i in ids if sum(
        (e._done_ids.get(i) is not None
         and e._done_ids[i].status == "done")
        for e in fleet.engines.values()) != 1]
    if twice:
        raise AssertionError(f"[fleet-router] ids done on other than one "
                             f"engine: {twice}")
    moved = sum(t.requeues for t in tickets)
    log(f"[fleet-router] eng1 killed after 6 steps: ejected, {moved} "
        f"tickets requeued under their ids to eng0, all "
        f"{len(tickets)} done with the single engine's tokens in "
        f"{wall:.3f} s, each id done on exactly one engine; eng0 "
        f"compile_count flat")
    # rolling restart: eng1 first comes back as a new incarnation
    fleet.make("eng1", prefixes[1])
    fleet.router.refresh()
    ids = [f"roll-{i}" for i in range(len(prompts))]
    tickets = [fleet.router.route(p, max_new_tokens=FLEET_NEW, request_id=i)
               for p, i in zip(prompts, ids)]
    names = []

    def restart(name):
        names.append(name)
        fleet.make(name, prefixes[int(name[-1])])
    t0 = time.perf_counter()
    fleet.router.rolling_restart(grace_s=300.0, restart=restart,
                                 step=fleet.step, wait_s=300.0)
    fleet.router.join(tickets, step=fleet.step, timeout_s=300.0)
    wall = time.perf_counter() - t0
    check("rolling restart", tickets)
    if sorted(names) != ["eng0", "eng1"] \
            or fleet.router.counters["rejected"]:
        raise AssertionError(f"[fleet-router] rolling restart: {names}, "
                             f"{fleet.router.counters}")
    log(f"[fleet-router] rolling_restart of eng0 and eng1 under "
        f"{len(tickets)} tickets: {wall:.3f} s, none rejected, "
        f"{sum(t.requeues for t in tickets)} requeued, every ticket done "
        f"with the single engine's tokens")
    fleet.close()
    return results


def _flush_exports(eng):
    """Step an idle engine until its parked blocks are all exported (the
    drain sends a few a step, at the step's end)."""
    while eng._pager.pending_exports:
        eng.step()


def _pool_round(engines, prompt, odd, spent):
    """One [fleet-pool] round: ``prompt`` admitted alone on the cold
    engine and on the pooled one (the pooled first when ``odd``), each
    driven to its end; the pooled engine adopts its 8 shared blocks and
    gives the cold one's tokens in fewer chunks. Returns the TTFTs (ms),
    the pooled fetch-and-copy time (ms) and its parts (from the running
    totals ``spent``), the chunk counts and each request's TTFT window
    (its clock)."""
    run = {}
    for arm in (("pool", "cold") if odd else ("cold", "pool")):
        eng = engines[arm]
        before = eng.pool_stats() if arm == "pool" else None
        was = dict(spent)
        torch.cuda.synchronize()
        r = eng.submit(prompt, max_new_tokens=32)
        _drive(eng, [r])
        run[arm] = dict(req=r, ttft=r.t_first_token - r.t_submit,
                        chunks=r.prefill_chunks)
        if arm == "pool":
            after = eng.pool_stats()
            run[arm].update({k: after[k] - before[k] for k in
                             ("adopted_blocks", "fetch_hits", "fetch_s")})
            run[arm]["parts"] = {k: (spent[k] - was[k]) * 1e3
                                 for k in spent}
            _flush_exports(eng)          # none spills into the next round
    cold, hot = run["cold"], run["pool"]
    if hot["req"].tokens != cold["req"].tokens \
            or hot["adopted_blocks"] != 8 or hot["chunks"] >= cold["chunks"]:
        raise AssertionError(f"[fleet-pool] adopted {hot['adopted_blocks']}"
                             f", chunks {hot['chunks']} vs {cold['chunks']}"
                             f", tokens equal "
                             f"{hot['req'].tokens == cold['req'].tokens}")
    return dict(pool=hot["ttft"] * 1e3, cold=cold["ttft"] * 1e3,
                fetch=hot["fetch_s"] * 1e3, parts=hot["parts"],
                chunks=(hot["chunks"], cold["chunks"]),
                windows=[(x["req"].t_submit, x["req"].t_first_token)
                         for x in (hot, cold)])


def phase_fleet_pool(model, smi):
    """[fleet-pool] (bench.py decode --paged --pool): an engine serves
    POOL_ROUNDS shared prompts of 8 whole blocks plus a tail each and
    exports its parked blocks to a ``LocalPool``. A cold engine on the
    pool and the same cold engine without it then admit each prompt in
    turn (one request at a time): the pooled one adopts the 8 blocks (one
    copy of their rows into its KV tensor) and gives, bit for bit, the
    tokens of the other, in fewer prefill chunks. The first round warms
    the adopt path (its one-time costs: the first upload, allocation and
    scatter at this shape) and is printed apart; TTFT with and without
    the pool in every later round; the bytes a block moves; the adoption's
    host side alone; then ``drop_prefix_cache`` bumps the generation and
    a fetch misses."""
    from paddle_tpu_torch.serving import LocalPool, prefix_digest
    vocab = model.config.vocab_size
    gen = torch.Generator()
    gen.manual_seed(11)
    bs = FLEET_ENGINE["block_size"]
    shared = [torch.randint(0, vocab, (8 * bs,), generator=gen).tolist()
              for _ in range(POOL_ROUNDS)]
    tail = lambda: torch.randint(0, vocab, (8,), generator=gen).tolist()
    pool = LocalPool()
    warm = _warmed(model, kv_pool=pool)
    for s in shared:
        _drive(warm, [warm.submit(s + tail(), max_new_tokens=8)])
    _flush_exports(warm)
    digests = [[prefix_digest(tuple(s[:bs * k])) for k in range(1, 9)]
               for s in shared]
    if any(pool.get(d) is None for ds in digests for d in ds):
        raise AssertionError(f"[fleet-pool] exports {warm.pool_stats()}")
    engines = {"cold": _warmed(model), "pool": _warmed(model, kv_pool=pool)}
    # the collector's pauses (start on the requests' clock, seconds), to
    # set against each TTFT window
    pauses, began = [], []

    def on_gc(phase, info):
        if phase == "start":
            began[:] = [time.time(), time.perf_counter()]
        elif began:
            pauses.append((began[0], time.perf_counter() - began[1]))
    # the adoption's parts, timed by wrapping the calls it makes: the
    # pool's get, the block decode, the table splice (the rest of the
    # fetch-and-copy time is the stack, the upload and the scatter)
    from paddle_tpu_torch.distributed.reshard import snapshot
    spent = {"get": 0.0, "decode": 0.0, "splice": 0.0}

    def timed(key, fn):
        def call(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[key] += time.perf_counter() - t
        return call
    decode = snapshot.decode_block
    pager = engines["pool"]._pager
    pool.get = timed("get", pool.get)
    snapshot.decode_block = timed("decode", decode)
    pager.adopt_blocks = timed("splice", pager.adopt_blocks)
    rounds = []
    gc.callbacks.append(on_gc)
    try:
        for i, s in enumerate(shared):
            rounds.append(_pool_round(engines, s + tail(), i % 2, spent))
    finally:
        gc.callbacks.remove(on_gc)
        snapshot.decode_block = decode
        del pool.get, pager.adopt_blocks
    for r in rounds:
        r["gc"] = tuple(1e3 * sum(d for t, d in pauses if a <= t <= b)
                        for a, b in r.pop("windows"))
    if any(e.compile_count != 2 for e in engines.values()):
        raise AssertionError(f"[fleet-pool] compile_count "
                             f"{[e.compile_count for e in engines.values()]}")
    first, timed = rounds[0], rounds[1:]
    payload, meta = pool.get(digests[0][0])
    per_block = len(payload)
    # the adoption's host side, step by step (5 times): the 8 entries
    # fetched and decoded, stacked, then one copy to the card
    parts = {"decode": [], "stack": [], "copy": []}
    for _ in range(5):
        t = time.perf_counter()
        arrs = [snapshot.decode_block(*pool.get(d)) for d in digests[0]]
        t1 = time.perf_counter()
        rows = torch.stack(arrs, dim=2)
        t2 = time.perf_counter()
        rows.to(engines["pool"].device)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, dt in zip(parts, (t1 - t, t2 - t1, t3 - t2)):
            parts[k].append(dt * 1e3)
    parts = {k: (float(np.median(v)), max(v)) for k, v in parts.items()}
    # a weight swap's hook: the generation moves on, the old entries go;
    # the warm engine re-serves and re-exports under the new generation,
    # and a replica still at the old one misses every fetch
    warm.drop_prefix_cache()
    if pool.generation() != 1 or len(pool):
        raise AssertionError("[fleet-pool] the generation bump")
    again = warm.submit(shared[0] + tail(), max_new_tokens=4)
    _drive(warm, [again])
    _flush_exports(warm)
    if any(pool.get(d) is None for d in digests[0]):
        raise AssertionError("[fleet-pool] no re-export at generation 1")
    late = _warmed(model, kv_pool=pool)
    late._pool_gen = 0                # a replica that missed the bump
    before = late.pool_stats()
    r = late.submit(shared[0] + tail(), max_new_tokens=4)
    _drive(late, [r])
    after = late.pool_stats()
    if after["adopted_blocks"] != before["adopted_blocks"] \
            or after["fetch_misses"] <= before["fetch_misses"] \
            or r.status != "done":
        raise AssertionError(f"[fleet-pool] after the bump: {after}")
    med = lambda k: float(np.median([r[k] for r in timed]))
    fetches = ", ".join(
        f"{r['fetch']:.2f} (get {r['parts']['get']:.2f}, decode "
        f"{r['parts']['decode']:.2f}, splice {r['parts']['splice']:.2f})"
        for r in timed)
    pair = lambda r: (f"{r['pool']:.2f} / {r['cold']:.2f} (GC "
                      f"{r['gc'][0]:.2f} / {r['gc'][1]:.2f})")
    log(f"[fleet-pool] {len(shared[0]) + 8}-token prompts, 8 shared blocks "
        f"each, {POOL_ROUNDS} rounds, the arms in turns: the cold engine on "
        f"the pool adopted 8 blocks a round and ran {first['chunks'][0]} "
        f"prefill chunk(s) against {first['chunks'][1]}; tokens identical "
        f"every round; TTFT with / without the pool in ms, with the "
        f"collector's pauses inside each window: round 0 (the first "
        f"adoption in the process, warms the adopt path) {pair(first)}, "
        f"fetch and copy {first['fetch']:.2f}; rounds 1-{POOL_ROUNDS - 1} "
        + ", ".join(pair(r) for r in timed)
        + f"; median {med('pool'):.2f} / {med('cold'):.2f}; the pooled "
        f"fetch and copy, with its parts (the rest: stack, upload, "
        f"scatter) {fetches}; "
        f"{per_block} bytes a block ({meta['dtype']} {meta['shape']}); the "
        f"adoption's host side alone (median and max of 5, ms): fetch and "
        f"decode {parts['decode'][0]:.2f} ({parts['decode'][1]:.2f}), stack "
        f"{parts['stack'][0]:.2f} ({parts['stack'][1]:.2f}), one copy to "
        f"the card {parts['copy'][0]:.2f} ({parts['copy'][1]:.2f}; "
        f"{8 * per_block / parts['copy'][0] / 1e6:.2f} GB/s); after "
        f"drop_prefix_cache the generation is {pool.generation()} and "
        f"fetches miss ({smi})")
    for e in (warm, *engines.values(), late):
        e.close()
    return dict(rounds=rounds, bytes=per_block, **parts)


def _http_worker(name, kv, out_dir):
    """``chip_smoke.py --fleet-worker <name> <kv> <dir>``: one replica of
    [fleet-http]: GPT-medium at FLEET_HTTP_BLOCKS blocks (seed 0) in a
    graphed engine behind a ``DoorServer`` and an ``EngineEndpoint`` on a
    ``KVDirectory``, the monitor's fleet plane on (rank and world from the
    env). Prints ``READY <addr> <GB reserved>`` once warm, steps until
    drained, then one JSON line."""
    import threading
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.kernels import reset_launch_counts
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving import (DecodeEngine, DoorServer,
                                          EngineEndpoint, KVDirectory)
    monitor.enable(os.path.join(out_dir, "run.jsonl"), fleet=True)
    cfg = dict(GPT_MEDIUM, num_layers=FLEET_HTTP_BLOCKS)
    model = GPTForCausalLM(GPTConfig(**cfg), dtype=torch.bfloat16,
                           seed=0).eval()
    eng = DecodeEngine(model, **FLEET_ENGINE)
    _warm(eng, cfg["vocab_size"], [40], new=2)
    reset_launch_counts()           # the replica's serving path starts here
    warm_tokens = eng.tokens_generated
    lock = threading.Lock()
    ep = EngineEndpoint(eng, name, KVDirectory(endpoint=kv, job_id="smoke"),
                        ttl_s=2.0)
    door = DoorServer(eng, lock=lock, endpoint=ep)
    ep.addr = door.address
    door.start()
    ep.publish()
    ep.start_publishing(lock=lock)
    print(f"READY {door.address} "
          f"{torch.cuda.memory_reserved() / 1e9:.3f}", flush=True)
    deadline = time.time() + 600.0
    while time.time() < deadline:
        with lock:
            eng.step()
            done = eng.drained
        if done:
            break
        time.sleep(0.001)
    t_end = time.time() + 1.0
    while time.time() < t_end:
        with lock:
            eng.step()
        time.sleep(0.01)
    ep.close()
    door.stop()
    eng.check_invariants()
    print(json.dumps({"name": name, "drained": eng.drained,
                      "tokens": eng.tokens_generated - warm_tokens,
                      "launches": _path_counts(),
                      "compile_count": eng.compile_count,
                      "reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
                      "fleet": monitor.fleet_state() is not None}),
          flush=True)
    monitor.disable()
    return 0


def phase_fleet_http(smi):
    """[fleet-http]: two worker processes on the one card (``chip_smoke.py
    --fleet-worker``, GPT-medium at FLEET_HTTP_BLOCKS blocks), each an
    engine behind a DoorServer registered on a KVDirectory over the port's
    KVServer, started here; this process is the router, through
    ``HTTPEngineClient``. The workers run the monitor's fleet plane as
    ranks 0 and 1 over KVTransport. SIGKILL rank 1 with tickets on it: it
    goes stale, is ejected, its tickets requeue, every ticket ends done
    with the tokens of the same model in one engine here; rank 0's
    ``run.fleet.jsonl`` holds both ranks and then marks rank 1 stale;
    rank 0 drains over HTTP and exits 0. Returns rank 0's launch counts
    from its warm-up's end to its exit (the path's own; rank 1's die with
    it). Every worker is stopped."""
    import signal
    from paddle_tpu_torch.distributed.launch.master import KVServer
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving import (DecodeEngine, KVDirectory,
                                          RouteFaultSchedule, Router)
    cfg = dict(GPT_MEDIUM, num_layers=FLEET_HTTP_BLOCKS)
    gen = torch.Generator()
    gen.manual_seed(13)
    prompts = [torch.randint(0, cfg["vocab_size"], (int(n),),
                             generator=gen).tolist()
               for n in torch.randint(24, 120, (FLEET_HTTP_TICKETS,),
                                      generator=gen)]
    model = GPTForCausalLM(GPTConfig(**cfg), dtype=torch.bfloat16,
                           seed=0).eval()
    ref = _warmed(model)
    ref_reqs = [ref.submit(p, max_new_tokens=FLEET_NEW) for p in prompts]
    _drive(ref, ref_reqs)
    ref.close()
    del ref, model
    torch.cuda.empty_cache()
    srv = KVServer(0, host="127.0.0.1")
    srv.start()
    kv = srv.address
    procs, outs = {}, {}
    here = os.path.abspath(__file__)
    try:
        for rank in (0, 1):
            d = os.path.join(FLEET_DIR, f"w{rank}")
            os.makedirs(d, exist_ok=True)
            for f in os.listdir(d):
                os.remove(os.path.join(d, f))
            env = dict(os.environ, PADDLE_TRAINER_ID=str(rank),
                       PADDLE_TRAINERS_NUM="2", PADDLE_MONITOR_MASTER=kv,
                       PADDLE_JOB_ID="smoke",
                       PADDLE_MONITOR_PUBLISH_S=str(FLEET_PUBLISH_S))
            for k in ("PADDLE_MONITOR", "PADDLE_SERVE_FAULT",
                      "PADDLE_ROUTE_FAULT", "PADDLE_MONITOR_FLEET"):
                env.pop(k, None)
            procs[rank] = subprocess.Popen(
                [sys.executable, here, "--fleet-worker", f"w{rank}", kv, d],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=env)
        held = {}
        for rank, proc in procs.items():
            t0 = time.time()
            while True:
                line = proc.stdout.readline()
                if line.startswith("READY"):
                    held[rank] = float(line.split()[2])
                    break
                if (not line and proc.poll() is not None) \
                        or time.time() - t0 > 300:
                    raise AssertionError(f"[fleet-http] worker {rank} never "
                                         f"ready: {line}{proc.stdout.read()}")
        router = Router(KVDirectory(endpoint=kv, job_id="smoke"),
                        policy="round_robin", eject_after=2,
                        fault_schedule=RouteFaultSchedule.parse(""))
        t0 = time.time()
        while sorted(router.refresh()) != ["w0", "w1"]:
            if time.time() - t0 > 60:
                raise AssertionError("[fleet-http] registrations")
            time.sleep(0.05)
        fleet = os.path.join(FLEET_DIR, "w0", "run.fleet.jsonl")

        def fleet_recs():
            if not os.path.exists(fleet):
                return []
            out = []
            for line in open(fleet):
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    pass
            return [r for r in out if r.get("kind") == "fleet"]

        def wait(what, cond, limit=120.0):
            t = time.time()
            while not cond():
                if time.time() - t > limit:
                    raise AssertionError(f"[fleet-http] {what}")
                time.sleep(0.05)
        wait("both ranks in rank 0's fleet stream", lambda: any(
            set(r.get("ranks") or []) >= {0, 1} for r in fleet_recs()))
        t0 = time.perf_counter()
        tickets = [router.route(p, max_new_tokens=FLEET_NEW,
                                request_id=f"http-{i}")
                   for i, p in enumerate(prompts)]
        wait("tokens streaming on w1", lambda: (router.poll() or True) and
             any(t.tokens for t in tickets if t.engine == "w1"))
        on_w1 = [t.id for t in tickets
                 if t.engine == "w1" and not t.finished]
        procs[1].send_signal(signal.SIGKILL)
        procs[1].wait(timeout=60)
        router.join(tickets, timeout_s=300.0)
        wall = time.perf_counter() - t0
        bad = [(t.id, t.status, t.error) for t, r in zip(tickets, ref_reqs)
               if t.status != "done" or t.tokens != r.tokens]
        if bad or "w1" not in router._ejected \
                or router.counters["requeues"] < len(on_w1):
            raise AssertionError(f"[fleet-http] {bad}, {router.counters}, "
                                 f"ejected {sorted(router._ejected)}")
        wait("rank 1 stale in rank 0's fleet stream", lambda: any(
            1 in (r.get("stale") or []) for r in fleet_recs()))
        router._clients["w0"].begin_drain(30.0)
        out, _ = procs[0].communicate(timeout=300)
        if procs[0].returncode != 0:
            raise AssertionError(f"[fleet-http] w0 rc "
                                 f"{procs[0].returncode}: {out[-3000:]}")
        summary = json.loads([l for l in out.splitlines()
                              if l.startswith("{")][-1])
        if not summary["drained"] or summary["compile_count"] != 2 \
                or not summary["fleet"] or summary["tokens"] < 1:
            raise AssertionError(f"[fleet-http] w0 summary {summary}")
        # the path's launches are the serving replica's own (w1 was
        # SIGKILLed: its counts die with it); the phase's reference engine
        # is not the path
        ran = {k: n for k, n in summary["launches"].items() if n}
        if ran:
            raise AssertionError(f"[fleet-http] w0 launched {ran}")
        stale = next(r for r in fleet_recs() if 1 in (r.get("stale") or []))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        srv.stop()
    log(f"[fleet-http] 2 worker processes on the card (GPT-medium, "
        f"{FLEET_HTTP_BLOCKS} blocks; {held[0]:.2f} and {held[1]:.2f} GB "
        f"reserved at READY, w0 {summary['reserved_gb']:.2f} GB at its "
        f"peak), this process the router over HTTP: {len(tickets)} tickets, "
        f"{len(on_w1)} live on w1 when it was SIGKILLed; w1 ejected, "
        f"{router.counters['requeues']} requeued, all done with one "
        f"engine's tokens in {wall:.3f} s; rank 0's fleet stream held both "
        f"ranks and marked rank 1 stale at round {stale['round']}; w0 "
        f"served {summary['tokens']} tokens after its warm-up with no flash "
        f"launch in its process (w1's counts died with it), drained over "
        f"HTTP, rc 0 ({smi})")
    return summary["launches"]


# ------------------------------------------------ the captured train step

# [train-graph]: the captured step's steps a side, timed in turns with the
# eager step's (after 3 held bit for bit); [train-graph-features] and
# [train-graph-compiles] at GPT-medium width cut to these blocks and rows
TRAIN_GRAPH_STEPS = 6
GRAPH_FEATURE_BLOCKS = 4
GRAPH_FEATURE_ROWS = 8
GRAPH_COMPILE_BLOCKS = 2
GRAPH_COMPILE_SHAPES = ((4, 256), (2, 256))
GRAPH_CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "smoke_checkout", "ckpt_graph")


def _bits(t):
    """A tensor's bits (a NaN equals a NaN of the same bits)."""
    if t.is_floating_point():
        return t.contiguous().view({2: torch.int16, 4: torch.int32,
                                    8: torch.int64}[t.element_size()])
    return t


def _bit_equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape \
        and torch.equal(_bits(a), _bits(b))


def _hold_bits(tag, what, got, want):
    """Raise unless two ``_train_state``s (and anything else in them) are
    equal bit for bit."""
    if set(got) != set(want):
        raise AssertionError(f"{tag}: the states hold other entries")
    moved = [k for k in want if not (
        got[k] == want[k] if not torch.is_tensor(want[k])
        else _bit_equal(got[k], want[k]))]
    if moved:
        raise AssertionError(f"{tag}: the captured step differs from the "
                             f"eager step at {moved[:4]} of {len(want)}")
    log(f"{tag} {what}: every parameter, moment and master "
        f"({sum(torch.is_tensor(v) for v in want.values())} tensors) and "
        f"the step count ({want['step_count']}) bit for bit")


def _graph_of(step):
    """The captured step's programs: each must be a CUDA graph."""
    progs = list(step._programs._programs.values())
    if not progs or not all(p.captured for p in progs):
        raise AssertionError("the fast path ran a program that is not a "
                             "CUDA graph")
    return progs


def _busy_share(step, args):
    """One step under torch.profiler: its wall (ms) and the device's busy
    share of it (None where the profile holds no device time)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(*args).item()
        wall = time.perf_counter() - t0
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    return wall * 1e3, (busy / 1e6 / wall if busy else None)


def _pool_gb(step, args):
    """The step's first call (the warm-up and the capture), and the
    reserved memory it leaves held once the cache is given back."""
    opt = step._opt
    for p in opt._parameter_list:
        opt._ensure_state(p)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    loss = step(*args)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return loss, (torch.cuda.memory_reserved() - before) / 1e9


def phase_train_graph(smi):
    """[train-graph]: [train]'s recipe (GPT-medium bf16, 16 x 1024, AdamW
    with fp32 masters, 16 blocks) twice from seed 0: the eager step
    (``fast_path=False``) and the captured one (the default). 3 steps each
    from the same start: losses, every parameter, master and moment bit
    for bit, each step launching both flash kernels once a block (the
    replays counted as the device ran them), the programs CUDA graphs.
    Then TRAIN_GRAPH_STEPS timed steps a side in turns (ms a step min-max,
    tokens/s), one profiled step a side (the device's busy share), the
    reserved memory the capture holds, and the monitor on against off on
    the captured step (after its mint and a sampled call, which builds
    the digest probes), [monitor-train]'s repaired gate: the unsampled
    on-steps against the off-steps within [train]'s spread, a sampled
    step within MONITOR_SAMPLED_BUDGET. Returns the timings."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import launch_counts
    from paddle_tpu_torch.monitor import trace as mtrace
    blocks = GPT_MEDIUM["num_layers"]
    model_e, opt_e, step_e, ids = _train_recipe()
    model_g, opt_g, _, _ = _train_recipe()
    step_g = TrainStep(model_g, opt_g)
    b, L = ids.shape
    losses = {"eager": [], "graph": []}
    pool_gb = None
    for i in range(3):
        for name, step in (("eager", step_e), ("graph", step_g)):
            before = launch_counts()
            if name == "graph" and i == 0:
                loss, pool_gb = _pool_gb(step, (ids, ids))
            else:
                loss = step(ids, ids)
            losses[name].append(loss)
            torch.cuda.synchronize()
            _expect_launches(f"[train-graph] {name} step {i}",
                             _grew(before, launch_counts()),
                             flash_pair_fwd=blocks, flash_pair_bwd=blocks)
    _graph_of(step_g)
    if not _bit_equal(torch.stack(losses["graph"]),
                      torch.stack(losses["eager"])):
        raise AssertionError(f"[train-graph] losses {losses}")
    _hold_bits("[train-graph]", "captured against eager after 3 steps",
               _train_state(model_g, opt_g), _train_state(model_e, opt_e))
    walls = {"eager": [], "graph": []}
    for i in range(TRAIN_GRAPH_STEPS):
        order = (("eager", step_e), ("graph", step_g)) if i % 2 == 0 \
            else (("graph", step_g), ("eager", step_e))
        for name, step in order:
            t0 = time.perf_counter()
            step(ids, ids).item()                    # synchronises
            walls[name].append(time.perf_counter() - t0)
    ms = {k: sum(v) / len(v) * 1e3 for k, v in walls.items()}
    busy = {k: _busy_share(s, (ids, ids))
            for k, s in (("eager", step_e), ("graph", step_g))}
    peak = torch.cuda.max_memory_reserved() / 1e9

    def fmt(k):
        w, share = busy[k]
        return (f"{ms[k]:.2f} ms a step (min {min(walls[k]) * 1e3:.2f}, max "
                f"{max(walls[k]) * 1e3:.2f}), {b * L / ms[k] * 1e3:.0f} "
                f"tokens/s; profiled step {w:.1f} ms, device busy "
                + ("not measured" if share is None else f"{share:.3f}"))
    log(f"[train-graph] {smi}: {TRAIN_GRAPH_STEPS} steps a side in turns: "
        f"eager {fmt('eager')}; captured {fmt('graph')}; captured / eager "
        f"{ms['graph'] / ms['eager']:.4f}; the capture holds "
        f"{pool_gb:.2f} GB reserved; process peak reserved {peak:.2f} GB")
    del model_e, opt_e, step_e
    torch.cuda.empty_cache()
    # the monitor on the captured step: the program with the health
    # plane's reductions is a second program (built here, its first call
    # the mint), the monitor off runs the first one
    os.makedirs(MONITOR_DIR, exist_ok=True)
    path = os.path.join(MONITOR_DIR, "train_graph.jsonl")
    with _env(PADDLE_HEALTH_SAMPLE="2"):
        mon = monitor.enable(path, trace=True)
        tracer = mtrace.get()
        step_g(ids, ids).item()              # the health program's mint
        step_g(ids, ids).item()              # sampled: the probes built
        mon_walls = {"on": [], "off": []}
        sampled = []
        for block in MONITOR_TRAIN_BLOCKS:
            if block == "off":
                monitor._active = mtrace._active = None
            for _ in range(3):
                n = step_g._health_n
                t0 = time.perf_counter()
                step_g(ids, ids).item()
                mon_walls[block].append(time.perf_counter() - t0)
                if block == "on":
                    sampled.append(step_g._health_n != n
                                   and step_g._health_n % 2 == 0)
            monitor._active, mtrace._active = mon, tracer
        monitor.disable()
    kinds = [r["kind"] for r in _records(path)]
    if kinds.count("recompile") != 1 or step_g.num_compiles != 2:
        raise AssertionError(f"[train-graph] {kinds.count('recompile')} "
                             f"recompile records, {step_g.num_compiles} "
                             f"programs; expected 1 and 2")
    _graph_of(step_g)
    samp = [w * 1e3 for w, s in zip(mon_walls["on"], sampled) if s]
    unsamp = [w * 1e3 for w, s in zip(mon_walls["on"], sampled) if not s]
    off = sum(mon_walls["off"]) / len(mon_walls["off"]) * 1e3
    if min(len(samp), len(unsamp)) < 1:
        raise AssertionError(f"[train-graph] sampled {sampled}")
    unsamp_ms = sum(unsamp) / len(unsamp)
    extra = sum(samp) / len(samp) - unsamp_ms
    spread = (max(TRAIN_WALLS) - min(TRAIN_WALLS)) * 1e3 if TRAIN_WALLS \
        else (max(mon_walls["off"]) - min(mon_walls["off"])) * 1e3
    log(f"[train-graph] the monitor on the captured step ({smi}): "
        f"unsampled on-steps {unsamp_ms:.2f} ms ({len(unsamp)}), sampled "
        f"{sum(samp) / len(samp):.2f} ({len(samp)}), off {off:.2f} "
        f"({len(mon_walls['off'])}): overhead {unsamp_ms - off:+.2f} ms "
        f"(limit [train]'s spread {spread:.2f}), a sampled step "
        f"{extra:+.2f} ms = {extra / off:.4f} of an off-step (budget "
        f"{MONITOR_SAMPLED_BUDGET}); {step_g.num_compiles} programs")
    if not abs(unsamp_ms - off) <= spread \
            or not extra <= MONITOR_SAMPLED_BUDGET * off:
        raise AssertionError("[train-graph] the monitor's cost on the "
                             "captured step is over its gate")
    del model_g, opt_g, step_g
    return dict(ms=ms, walls=walls, busy=busy, pool_gb=pool_gb,
                monitor=dict(unsampled=unsamp_ms, off=off, extra=extra))


def _feature_pair(tag, cfg, rows, k=None, scaler=None, recompute=None,
                  poison=None, steps=3):
    """One training feature twice from seed 0 at GPT-medium width (``cfg``
    overrides): eager and captured, ``steps`` steps each on one batch of
    ``rows`` x 1024 (stacked ``[k, rows / k, 1024]`` under accumulation),
    the same launches a step each way, then losses, every parameter,
    master and moment, the step count, the scaler's and the model
    generator's state held bit for bit. ``poison(model, i)`` runs before
    step i on both. Returns the captured run's losses and step."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import launch_counts
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    ids = torch.randint(0, GPT_MEDIUM["vocab_size"], (rows, TRAIN["seq"]),
                        device="cuda", generator=gen)
    if k:
        ids = ids.view(k, rows // k, TRAIN["seq"])
    runs = {}
    for fast in (False, True):
        model = GPTForCausalLM(GPTConfig(**dict(GPT_MEDIUM, **cfg)),
                               dtype=BF16, seed=0)
        if recompute:
            model.enable_recompute(recompute)
        opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                    parameters=model.parameters(), multi_precision=True)
        sc = None if scaler is None else scaler()
        step = TrainStep(model, opt, accumulate_steps=k, grad_scaler=sc,
                         fast_path=fast)
        losses, grew = [], []
        for i in range(steps):
            if poison is not None:
                poison(model, i)
            before = launch_counts()
            losses.append(step(ids, ids))
            torch.cuda.synchronize()
            grew.append(_grew(before, launch_counts()))
        state = _train_state(model, opt)
        state["generator"] = model.generator.get_state()
        if sc is not None:
            state["scaler"] = sc.state_dict()
        runs[fast] = (torch.stack(losses), state, grew, step)
        if fast:
            _graph_of(step)
        del model, opt
    (le, se, ge, _), (lg, sg, gg, step) = runs[False], runs[True]
    if gg != ge or not any(ge[0].values()):
        raise AssertionError(f"{tag}: launches a step {gg}, eager {ge}")
    if not _bit_equal(lg, le):
        raise AssertionError(f"{tag}: losses {lg.tolist()} against "
                             f"{le.tolist()}")
    _hold_bits(tag, f"{steps} captured steps against eager (losses "
               f"{[round(x, 4) for x in lg.tolist()]})", sg, se)
    torch.cuda.empty_cache()
    return lg, step


def phase_train_graph_features():
    """[train-graph-features]: GPT-medium width at GRAPH_FEATURE_BLOCKS
    blocks, bf16 with masters, GRAPH_FEATURE_ROWS x 1024, each captured
    against its eager step bit for bit over 3 steps: accumulation K = 4;
    a GradScaler (2^15) with one forced overflow (an inf planted in the
    position embedding before step 2 and taken back before step 3): the
    update skipped bit for bit, the step count not advanced, the scale
    halved; "selective" recompute at dropout 0.1 (the seeds staged as the
    eager step draws them, the recompute reading its forward's)."""
    from paddle_tpu_torch import amp
    cfg = dict(num_layers=GRAPH_FEATURE_BLOCKS)
    rows = GRAPH_FEATURE_ROWS
    _feature_pair("[train-graph-features] K = 4", cfg, rows, k=4)

    def poison(model, i):
        w = model.gpt.wpe.weight
        with torch.no_grad():
            if i == 1:
                poison.kept = w[5, 0].clone()
                w[5, 0] = float("inf")
            elif i == 2:
                w[5, 0] = poison.kept
    losses, step = _feature_pair(
        "[train-graph-features] GradScaler overflow", cfg, rows,
        scaler=lambda: amp.GradScaler(init_loss_scaling=AMP_SCALE),
        poison=poison)
    fin = [math.isfinite(x) for x in losses.tolist()]
    if fin != [True, False, True] or step._opt._step_count != 2 \
            or step._scaler._scale != AMP_SCALE / 2:
        raise AssertionError(f"[train-graph-features] overflow: finite "
                             f"{fin}, step count {step._opt._step_count}, "
                             f"scale {step._scaler._scale}")
    log(f"[train-graph-features] the overflow skipped its update on the "
        f"device: step count 2 after 3 calls, scale {AMP_SCALE:.0f} -> "
        f"{step._scaler._scale:.0f}")
    del step
    _feature_pair("[train-graph-features] selective recompute, dropout 0.1",
                  dict(cfg, hidden_dropout_prob=0.1,
                       attention_dropout_prob=0.1), rows,
                  recompute="selective")


def phase_train_graph_compiles(smi):
    """[train-graph-compiles]: the JAX package's call sequences on the
    captured step (GPT-medium width at GRAPH_COMPILE_BLOCKS blocks, bf16
    with masters): one signature builds 1 program; a new shape 2, the old
    shape again none; parameters replaced by ones of their shape and type
    (``p.data = ...``) are copied into the captured storage, building
    nothing; a checkpoint saved after 2 steps and loaded into another
    captured step (one already built, its storage written in place)
    continues bit for bit to the uninterrupted run's 4th step; the model
    moved to fp32 cannot be re-adopted: the programs are dropped and built
    again, and the step runs on."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    cfg = GPTConfig(**dict(GPT_MEDIUM, num_layers=GRAPH_COMPILE_BLOCKS))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    (r1, s1), (r2, s2) = GRAPH_COMPILE_SHAPES
    big = [torch.randint(0, cfg.vocab_size, (r1, s1), device="cuda",
                         generator=gen) for _ in range(4)]
    small = torch.randint(0, cfg.vocab_size, (r2, s2), device="cuda",
                          generator=gen)

    def recipe(seed=0):
        model = GPTForCausalLM(cfg, dtype=BF16, seed=seed)
        opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                    parameters=model.parameters(), multi_precision=True)
        return model, opt, TrainStep(model, opt)

    model, opt, step = recipe()
    seen = []
    for ids in (big[0], big[0], small, big[0]):
        step(ids, ids)
        seen.append(step.num_compiles)
    old = [p.data_ptr() for p in model.parameters()]
    for p in model.parameters():
        p.data = p.data.clone()
    step(big[0], big[0])
    seen.append(step.num_compiles)
    handed = [p.data_ptr() for p in model.parameters()] == old
    if seen != [1, 1, 2, 2, 2] or not handed:
        raise AssertionError(f"[train-graph-compiles] num_compiles {seen}, "
                             f"leaves handed back {handed}")
    model.float()                       # no program can hold fp32 leaves
    loss = step(big[0], big[0]).item()
    seen.append(step.num_compiles)
    _graph_of(step)
    if seen[-1] != 1 or not math.isfinite(loss):
        raise AssertionError(f"[train-graph-compiles] after the fp32 move "
                             f"num_compiles {seen[-1]}, loss {loss}")
    del model, opt, step
    # checkpoint: 4 straight steps against 2 + save, load into a built step
    shutil.rmtree(GRAPH_CKPT_DIR, ignore_errors=True)
    model, opt, step = recipe()
    for ids in big:
        step(ids, ids)
    want = _train_state(model, opt)
    del model, opt, step
    model, opt, step = recipe()
    for ids in big[:2]:
        step(ids, ids)
    step.save_checkpoint(GRAPH_CKPT_DIR, 2, block=True)
    del model, opt, step
    model, opt, step = recipe(seed=3)
    step(big[0], big[0])                  # built before the load
    info = step.load_checkpoint(GRAPH_CKPT_DIR)
    for ids in big[2:]:
        step(ids, ids)
    _hold_bits("[train-graph-compiles]", f"saved at step {info['step']}, "
               f"loaded into a captured step, 2 more steps against 4 "
               f"straight ones", _train_state(model, opt), want)
    _graph_of(step)
    shutil.rmtree(GRAPH_CKPT_DIR, ignore_errors=True)
    log(f"[train-graph-compiles] ({smi}) num_compiles along the calls "
        f"(one shape, again, a new shape, the first again, leaves "
        f"replaced, the model moved to fp32): {seen}; the replaced leaves "
        f"handed back to their captured storage; {step.num_compiles} "
        f"program after the load")
    del model, opt, step
    torch.cuda.empty_cache()


TYPE_ORDER_CALLS = 60


def phase_type_order():
    """[type-order]: the gradient of BERT's token-type table (2 rows, every
    token of a 64 x 512 batch in one of them) from TYPE_ORDER_CALLS
    identical backwards: the model's one-hot product
    (``models.bert.type_embedding``) must give one result, bit for bit,
    and its forward the lookup's values; torch's embedding lookup is
    counted beside it ([bert-train-graph] holds the captured step bit for
    bit to the eager one)."""
    from paddle_tpu_torch.models.bert import type_embedding
    _, types, _, _, _ = _bert_batch(BERT_TRAIN["batch"], BERT_TRAIN["seq"], 31)
    gen = torch.Generator(device="cuda").manual_seed(17)
    weight = torch.randn(2, BERT_BASE["hidden_size"], device="cuda",
                         generator=gen).to(BF16).requires_grad_()
    cot = torch.randn(*types.shape, BERT_BASE["hidden_size"], device="cuda",
                      generator=gen).to(BF16)
    same = {}
    for name, fn in (("one-hot product", type_embedding),
                     ("torch's lookup", lambda i, w:
                      torch.nn.functional.embedding(i, w))):
        grads = []
        for _ in range(TYPE_ORDER_CALLS):
            weight.grad = None
            fn(types, weight).backward(cot)
            grads.append(weight.grad.clone())
        same[name] = sum(torch.equal(grads[0], g) for g in grads)
    lookup = torch.equal(type_embedding(types, weight),
                         torch.nn.functional.embedding(types, weight))
    log(f"[type-order] token-type gradient [2, {BERT_BASE['hidden_size']}] "
        f"over {list(types.shape)} tokens, {TYPE_ORDER_CALLS} identical "
        f"backwards: equal to the first {same}; the product's forward equals "
        f"the lookup bit for bit: {lookup}")
    if same["one-hot product"] != TYPE_ORDER_CALLS or not lookup:
        raise AssertionError("[type-order] the model's token-type route is "
                             "not the same every call")


def phase_bert_train_graph(smi):
    """[bert-train-graph]: [bert-train]'s recipe (BERT-base bf16, 64 x 512
    packed, dropout 0.1, AdamW with masters) eager and captured from seed
    0: 3 steps each, losses, every parameter, master and moment and the
    model generator bit for bit, both launching the same kernels a step.
    The embedding output after its dropout is copied out at every step (a
    forward hook, recorded into the graph): each replay drops the eager
    step's elements, and two consecutive replays drop different ones."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import launch_counts
    runs = {}
    for fast in (False, True):
        model, opt, _, batch = _bert_recipe()
        step = TrainStep(model, opt, fast_path=fast)
        out = torch.empty(BERT_TRAIN["batch"], BERT_TRAIN["seq"],
                          BERT_BASE["hidden_size"], dtype=BF16,
                          device="cuda")
        def keep(mod, inp, o, out=out):
            # returns None: a hook's return value would replace o
            out.copy_(o.detach())
        hook = model.bert.embeddings.register_forward_hook(keep)
        losses, masks, grew = [], [], []
        for _ in range(3):
            before = launch_counts()
            losses.append(step(*batch))
            masks.append(out == 0)
            torch.cuda.synchronize()
            grew.append(_grew(before, launch_counts()))
        hook.remove()
        state = _train_state(model, opt)
        state["generator"] = model.generator.get_state()
        runs[fast] = (torch.stack(losses), masks, state, grew)
        if fast:
            _graph_of(step)
        del model, opt, step, out
        torch.cuda.empty_cache()
    (le, me, se, ge), (lg, mg, sg, gg) = runs[False], runs[True]
    if gg != ge or ge[0] != dict(ge[0], **BERT_STEP_LAUNCHES):
        raise AssertionError(f"[bert-train-graph] launches {gg}, eager {ge}")
    if not _bit_equal(lg, le):
        raise AssertionError(f"[bert-train-graph] losses {lg} vs {le}")
    same = [torch.equal(a, b) for a, b in zip(mg, me)]
    moved = [int((mg[i] != mg[i + 1]).sum()) for i in range(2)]
    dropped = [float(m.float().mean()) for m in mg]
    if not all(same) or not all(moved):
        raise AssertionError(f"[bert-train-graph] masks equal to eager's "
                             f"{same}, differing between replays {moved}")
    _hold_bits("[bert-train-graph]", f"BERT-base 64 x 512 packed, dropout "
               f"0.1, 3 steps (losses {[round(x, 4) for x in lg.tolist()]})",
               sg, se)
    log(f"[bert-train-graph] ({smi}) the embedding dropout's zeros: each "
        f"step's equal to the eager step's; {moved} elements differ "
        f"between consecutive replays; dropped shares "
        f"{[round(x, 4) for x in dropped]}")


def phase_llama_train_graph(smi):
    """[llama-train-graph]: [llama-train]'s recipe (LLaMA-7B width at
    LLAMA_TRAIN["layers"] blocks, 4 x 2048, bf16, AdamW with masters):
    the eager step, 3 steps (its state kept on the host) then 4 timed; the
    captured step from the same seed, 3 steps held bit for bit to the
    eager ones (losses, every parameter, master and moment), then 4 timed;
    the reserved memory the capture holds."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import launch_counts
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_7b
    from paddle_tpu_torch.optimizer import AdamW
    blocks = LLAMA_TRAIN["layers"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    b, L = LLAMA_TRAIN["batch"], LLAMA_TRAIN["seq"]
    ids = torch.randint(0, LLAMA_7B["vocab_size"], (b, L), device="cuda",
                        generator=gen)
    res = {}
    for fast in (False, True):
        model = LlamaForCausalLM(llama_7b(num_layers=blocks),
                                 dtype=torch.bfloat16, seed=0)
        opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                    parameters=model.parameters(), multi_precision=True)
        step = TrainStep(model, opt, fast_path=fast)
        losses, pool = [], None
        for i in range(3):
            before = launch_counts()
            if fast and i == 0:
                loss, pool = _pool_gb(step, (ids, ids))
            else:
                loss = step(ids, ids)
            losses.append(loss)
            torch.cuda.synchronize()
            _expect_launches(f"[llama-train-graph] step {i}",
                             _grew(before, launch_counts()),
                             flash_attention_fwd=blocks,
                             flash_attention_bwd=blocks)
        state = {k: v.cpu() if torch.is_tensor(v) else v
                 for k, v in _train_state(model, opt).items()}
        walls = []
        for _ in range(4):
            t0 = time.perf_counter()
            step(ids, ids).item()
            walls.append(time.perf_counter() - t0)
        if fast:
            _graph_of(step)
        res[fast] = (torch.stack(losses).cpu(), state, walls, pool)
        del model, opt, step
        torch.cuda.empty_cache()
    (le, se, we, _), (lg, sg, wg, pool) = res[False], res[True]
    if not _bit_equal(lg, le):
        raise AssertionError(f"[llama-train-graph] losses {lg} vs {le}")
    _hold_bits("[llama-train-graph]", "3 captured steps against eager",
               sg, se)
    me, mg = (sum(w) / len(w) * 1e3 for w in (we, wg))
    log(f"[llama-train-graph] {smi}: eager {me:.2f} ms a step (min "
        f"{min(we) * 1e3:.2f}, max {max(we) * 1e3:.2f}), captured "
        f"{mg:.2f} (min {min(wg) * 1e3:.2f}, max {max(wg) * 1e3:.2f}): "
        f"{b * L / me * 1e3:.0f} and {b * L / mg * 1e3:.0f} tokens/s, "
        f"captured / eager {mg / me:.4f}; the capture holds {pool:.2f} GB "
        f"reserved")
    return dict(eager_ms=me, graph_ms=mg, pool_gb=pool)


def _release(tag):
    """Collect what earlier phases left (reference cycles included), give
    the cache back, and print what the process still holds."""
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[memory] {tag}: {_held_gb():.2f} GB allocated")


def _path_counts():
    """The launch counts and, as "wide:<wrapper>", "f32w:<wrapper>",
    "f32f:<wrapper>", "f32b:<wrapper>" and "sw32:<wrapper>", the bf16 and
    fp32 wide bodies', the fp32 forward's and backward's up to 256 and the
    bf16 backward's at 80 and 96."""
    from paddle_tpu_torch.kernels import (f32_bwd_launch_counts,
                                          f32_fwd_launch_counts,
                                          f32_wide_launch_counts,
                                          launch_counts,
                                          sw32_bwd_launch_counts,
                                          wide_launch_counts)
    return dict(launch_counts(),
                **{f"wide:{k}": n for k, n in wide_launch_counts().items()},
                **{f"f32w:{k}": n for k, n in
                   f32_wide_launch_counts().items()},
                **{f"f32f:{k}": n for k, n in
                   f32_fwd_launch_counts().items()},
                **{f"f32b:{k}": n for k, n in
                   f32_bwd_launch_counts().items()},
                **{f"sw32:{k}": n for k, n in
                   sw32_bwd_launch_counts().items()})


def _kernel_entry(name, source, replaces, launches, record):
    return dict(name=name, route="cuda",
                source=f"paddle_tpu_torch/csrc/{source}",
                replaces=f"paddle_tpu/kernels/pallas/{replaces}",
                launches=launches[name], **record)


# ---------------------------------------------------------------- the Paddle
# dygraph surface (slice 19): BERT-base width written as a user writes it

API_BERT = dict(vocab=30522, d=768, heads=12, ffn=3072, layers=12,
                dropout=0.1)
API_TRAIN = dict(batch=64, seq=512, steps=4)      # 1 warm-up, then timed
API_CHECK = dict(vocab=1024, d=256, heads=4, ffn=1024, layers=2,
                 dropout=0.0)
API_CHECK_BATCH = (4, 256)
# one step of the full-width stack: per block the flat flash forward and
# backward (the MHA's sdpa, no mask) and three nn.Dropout layers, each a
# dropout launch forward and one backward
API_STEP_LAUNCHES = dict(flash_attention_fwd=12, flash_attention_bwd=12,
                         dropout_fwd=72)
API_OP_ITERS = 20000      # dispatches timed a side for the per-op cost


def _api_encoder(cfg, seed, place):
    """The stack of the [api-*] phases built with ``import
    paddle_tpu_torch as paddle`` on ``place`` from ``paddle.seed(seed)``:
    ``nn.Embedding``, ``nn.TransformerEncoder`` of GELU layers,
    ``nn.LayerNorm``, an ``nn.Linear`` head over every token and
    ``F.cross_entropy`` (the logits cast to fp32)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    F = nn.functional

    class Encoder(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(cfg["vocab"], cfg["d"])
            self.encoder = nn.TransformerEncoder(
                nn.TransformerEncoderLayer(cfg["d"], cfg["heads"], cfg["ffn"],
                                           dropout=cfg["dropout"],
                                           activation="gelu"),
                cfg["layers"])
            self.norm = nn.LayerNorm(cfg["d"])
            self.head = nn.Linear(cfg["d"], cfg["vocab"])

        def forward(self, ids, labels):
            logits = self.head(self.norm(self.encoder(self.embed(ids))))
            return F.cross_entropy(logits.astype("float32"), labels)

    paddle.set_device(place)
    paddle.seed(seed)
    return Encoder()


def _api_batch(cfg, b, s, seed, place):
    import paddle_tpu_torch as paddle
    paddle.set_device(place)
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, cfg["vocab"], (b, s), generator=gen)
    labels = torch.randint(0, cfg["vocab"], (b, s), generator=gen)
    return paddle.to_tensor(ids), paddle.to_tensor(labels)


def phase_api_check():
    """[api-check]: the stack at 2 layers, width 256, 4 heads of 64,
    dropout 0, fp32, built twice from one seed (on the card and on the
    CPU: the initializers draw on the CPU chain, so the weights agree bit
    for bit) and run at 4 x 256: the loss and every leaf's gradient within
    TRAIN_CHECK_REL_LIMIT, the card through the flash kernels."""
    from paddle_tpu_torch.kernels import launch_counts
    import paddle_tpu_torch as paddle
    b, s = API_CHECK_BATCH
    cpu = _api_encoder(API_CHECK, 3, "cpu")
    cpu_batch = _api_batch(API_CHECK, b, s, 4, "cpu")
    card = _api_encoder(API_CHECK, 3, "gpu")
    card_batch = _api_batch(API_CHECK, b, s, 4, "gpu")
    same = all(torch.equal(p.cpu(), q) for p, q in
               zip(card.parameters(), cpu.parameters()))
    if not same:
        raise AssertionError("[api-check] one seed gave other weights on "
                             "the card than on the CPU")
    before = launch_counts()
    loss_card = card(*card_batch)
    loss_card.backward()
    torch.cuda.synchronize()
    grew = _grew(before, launch_counts())
    _expect_launches("[api-check]", grew,
                     flash_attention_fwd=API_CHECK["layers"],
                     flash_attention_bwd=API_CHECK["layers"])
    if not isinstance(loss_card, paddle.Tensor):
        raise AssertionError(f"[api-check] the loss is a {type(loss_card)}")
    loss_cpu = cpu(*cpu_batch)
    loss_cpu.backward()
    loss_rel = abs(float(loss_card) - float(loss_cpu)) / abs(float(loss_cpu))
    grads = {n: (p.grad.cpu(), q.grad) for (n, p), (_, q) in
             zip(card.named_parameters(), cpu.named_parameters())}
    # a key projection's bias adds one constant to a row's logits, which
    # the softmax ignores: its exact gradient is 0 and both sides hold fp32
    # noise, so it is held to zero against the largest leaf gradient
    scale = max(float(q.norm()) for _, q in grads.values())
    zero = {n: max(float(g.norm()), float(q.norm())) / scale
            for n, (g, q) in grads.items() if n.endswith("k_proj.bias")}
    rels = {n: rel_err(g, q) for n, (g, q) in grads.items()
            if n not in zero}
    worst = max(rels, key=rels.get)
    log(f"[api-check] fp32, {API_CHECK['layers']} layers, width "
        f"{API_CHECK['d']}, [{b}, {s}]: loss card {float(loss_card):.6f} vs "
        f"cpu {float(loss_cpu):.6f} (rel {loss_rel:.3g}); worst leaf "
        f"gradient rel {rels[worst]:.3g} ({worst}) of {len(rels)}; the key "
        f"biases' gradients (exactly 0) at most {max(zero.values()):.3g} of "
        f"the largest leaf's; limit {TRAIN_CHECK_REL_LIMIT}; launches {grew}")
    if not (loss_rel < TRAIN_CHECK_REL_LIMIT
            and rels[worst] < TRAIN_CHECK_REL_LIMIT
            and max(zero.values()) < TRAIN_CHECK_REL_LIMIT):
        raise AssertionError("[api-check] the card disagrees with the CPU")
    paddle.set_device("gpu")


def _api_full(seed=0):
    """The full-width stack in bf16 (``Layer.to(dtype="bfloat16")``) with
    ``AdamW(multi_precision=True)``, and its batch."""
    import paddle_tpu_torch as paddle
    model = _api_encoder(API_BERT, seed, "gpu")
    model.to(dtype="bfloat16")
    opt = paddle.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                                 parameters=model.parameters(),
                                 multi_precision=True)
    batch = _api_batch(API_BERT, API_TRAIN["batch"], API_TRAIN["seq"], 5,
                       "gpu")
    return model, opt, batch


def _api_eager_step(model, opt, batch):
    loss = model(*batch)
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss


def _dispatch_cost_us():
    """Host microseconds one dispatched op costs over the torch call it
    runs (``paddle.add`` against ``torch.add`` on small card tensors),
    the two calls' times, the same with the cycle collector off
    ("paddle_nogc", "torch_nogc"), and a pure-Python loop's ("python":
    ``sum(range(64))``, no torch), which reads the host's own speed."""
    import paddle_tpu_torch as paddle
    a = paddle.ones([16])
    b = paddle.ones([16])
    pa, pb = a.as_subclass(torch.Tensor), b.as_subclass(torch.Tensor)
    out = {}
    for name, fn in (("paddle", lambda: paddle.add(a, b)),
                     ("torch", lambda: torch.add(pa, pb)),
                     ("python", lambda: sum(range(64)))):
        for collect in (True, False):
            for _ in range(100):
                fn()
            torch.cuda.synchronize()
            if not collect:
                gc.disable()
            try:
                t0 = time.perf_counter()
                for _ in range(API_OP_ITERS):
                    fn()
                us = (time.perf_counter() - t0) / API_OP_ITERS * 1e6
            finally:
                gc.enable()
            out[name if collect else f"{name}_nogc"] = us
            torch.cuda.synchronize()
    return out["paddle"] - out["torch"], out


def _host_state():
    """What the process holds that host code pays for on every call: the
    dispatcher's profiler and monitor hooks, torch function modes, a
    Python trace or profile function, the live Python threads (by name)
    and all its threads, its child processes, the machine's load average,
    and the objects the cycle collector tracks."""
    from paddle_tpu_torch.core import dispatch
    names = {}
    for t in threading.enumerate():
        key = re.sub(r"[-_ ]?\d+", "", t.name)
        names[key] = names.get(key, 0) + 1
    tasks = os.listdir("/proc/self/task")
    children = []
    for task in tasks:
        try:
            with open(f"/proc/self/task/{task}/children") as fh:
                children += fh.read().split()
        except OSError:
            pass
    return dict(monitor_hook=dispatch._MONITOR_OP is not None,
                profiler_hook=dispatch._PROFILER_HOOK is not None,
                torch_modes=len(torch.overrides
                                ._get_current_function_mode_stack()),
                tracing=sys.gettrace() is not None
                or sys.getprofile() is not None,
                threads=sum(names.values()), thread_names=names,
                native_threads=len(tasks), child_processes=len(children),
                loadavg=os.getloadavg()[0], gc_objects=len(gc.get_objects()))


def phase_api_train(smi):
    """[api-train]: the full-width stack (BERT-base: vocab 30522, 12
    layers of 12 heads of 64, FFN 3072, GELU, dropout 0.1) at 64 x 512 as
    an eager Paddle loop, ``loss.backward(); opt.step();
    opt.clear_grad()``: 1 warm-up and API_TRAIN["steps"] timed steps (each
    launching API_STEP_LAUNCHES), peak memory, then one profiled step (the
    device's busy share) and one step with the dispatcher's profiler hook
    (ops a step and their host time), and the per-op dispatch cost.
    Returns the losses (for [api-plain]) and the timings."""
    from paddle_tpu_torch.core import dispatch
    from paddle_tpu_torch.kernels import launch_counts
    model, opt, batch = _api_full()
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for i in range(1 + API_TRAIN["steps"]):
        before = launch_counts()
        t0 = time.perf_counter()
        losses.append(float(_api_eager_step(model, opt, batch)))
        walls.append(time.perf_counter() - t0)
        _expect_launches(f"[api-train] step {i}",
                         _grew(before, launch_counts()), **API_STEP_LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    timed = walls[1:]
    ms = sum(timed) / len(timed) * 1e3
    tokens = API_TRAIN["batch"] * API_TRAIN["seq"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[api-train] losses {losses}")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(_api_eager_step(model, opt, batch))
        wall = time.perf_counter() - t0
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    ops = []
    dispatch.set_profiler_hook(lambda n, t0, t1: ops.append(t1 - t0))
    try:
        t0 = time.perf_counter()
        float(_api_eager_step(model, opt, batch))
        hooked = time.perf_counter() - t0
    finally:
        dispatch.set_profiler_hook(None)
    # one step timed by part on the host clock, with no wait between the
    # parts, then the wait for the device: where an eager step's host
    # time goes (forward, backward, the optimizer, clear_grad)
    torch.cuda.synchronize()
    marks = [time.perf_counter()]
    loss = model(*batch)
    marks.append(time.perf_counter())
    loss.backward()
    marks.append(time.perf_counter())
    opt.step()
    marks.append(time.perf_counter())
    opt.clear_grad()
    marks.append(time.perf_counter())
    float(loss)
    marks.append(time.perf_counter())
    parts = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    del loss
    cost_us, per_call = _dispatch_cost_us()
    state = _host_state()
    log(f"[api-train] ({smi}) {n_params / 1e6:.1f} M params, bf16 with fp32 "
        f"masters, 64 x 512, dropout 0.1: {ms:.2f} ms a step (min "
        f"{min(timed) * 1e3:.2f}, max {max(timed) * 1e3:.2f}), "
        f"{tokens / ms * 1e3:.0f} tokens/s, peak {peak:.2f} GB; losses "
        f"{[round(x, 4) for x in losses]}")
    log(f"[api-train] profiled step {wall * 1e3:.1f} ms wall, device busy "
        f"{busy_us / 1e3:.1f} ms = {busy_us / 1e6 / wall:.3f} of wall; "
        f"{len(ops)} dispatched ops a step, {sum(ops) * 1e3:.1f} ms of host "
        f"time inside them (step {hooked * 1e3:.1f} ms with the hook); one "
        f"dispatch {per_call['paddle']:.2f} us against torch.add's "
        f"{per_call['torch']:.2f} us: {cost_us:.2f} us more a call, "
        f"{len(ops) * cost_us / 1e3:.2f} ms a step")
    log(f"[api-train] host: with the cycle collector off a dispatch "
        f"{per_call['paddle_nogc']:.2f} us, torch.add "
        f"{per_call['torch_nogc']:.2f} us; a pure-Python sum(range(64)) "
        f"{per_call['python']:.3f} us ({per_call['python_nogc']:.3f} with "
        f"it off); the process holds {json.dumps(state)}")
    log(f"[api-train] one step by part on the host: forward "
        f"{parts[0]:.2f} ms, backward {parts[1]:.2f}, opt.step "
        f"{parts[2]:.2f}, opt.clear_grad {parts[3]:.2f}, then the wait for "
        f"the device {parts[4]:.2f} ms ({sum(parts):.2f} in all)")
    del model, opt, batch, prof
    return losses, dict(ms=ms, min=min(timed) * 1e3, max=max(timed) * 1e3,
                        busy=busy_us / 1e6 / wall, peak=peak)


def phase_api_graph(smi, eager):
    """[api-graph]: the same model under ``TrainStep(model, opt)`` (the
    captured step, the default) against ``TrainStep(fast_path=False)``
    from the same seed and chain state: 3 steps each, losses and every
    parameter, moment and master bit for bit, the programs CUDA graphs;
    then API_TRAIN["steps"] timed captured steps, a profiled one (busy
    share) and ``num_compiles``."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import launch_counts
    res = {}
    for fast in (False, True):
        model, opt, batch = _api_full()
        step = TrainStep(model, opt, fast_path=fast)
        paddle.seed(11)
        losses = []
        for i in range(3):
            before = launch_counts()
            losses.append(step(*batch))
            torch.cuda.synchronize()
            _expect_launches(f"[api-graph] fast_path={fast} step {i}",
                             _grew(before, launch_counts()),
                             **API_STEP_LAUNCHES)
        state = {k: v.cpu() if torch.is_tensor(v) else v
                 for k, v in _train_state(model, opt).items()}
        res[fast] = (torch.stack([x.detach().as_subclass(torch.Tensor)
                                  for x in losses]).cpu(), state)
        if fast:
            _graph_of(step)
            walls = []
            for _ in range(API_TRAIN["steps"]):
                t0 = time.perf_counter()
                step(*batch).item()
                walls.append(time.perf_counter() - t0)
            wall_ms, busy = _busy_share(step, batch)
            compiles = step.num_compiles
        del model, opt, step, batch
        torch.cuda.empty_cache()
    (le, se), (lg, sg) = res[False], res[True]
    if not _bit_equal(lg, le):
        raise AssertionError(f"[api-graph] losses {lg} vs {le}")
    _hold_bits("[api-graph]", "3 captured steps against eager TrainStep",
               sg, se)
    ms = sum(walls) / len(walls) * 1e3
    tokens = API_TRAIN["batch"] * API_TRAIN["seq"]
    if compiles != 1:
        raise AssertionError(f"[api-graph] num_compiles {compiles}")
    log(f"[api-graph] ({smi}) captured {ms:.2f} ms a step (min "
        f"{min(walls) * 1e3:.2f}, max {max(walls) * 1e3:.2f}), "
        f"{tokens / ms * 1e3:.0f} tokens/s; profiled step {wall_ms:.1f} ms, "
        f"busy {busy if busy is None else round(busy, 3)}; num_compiles "
        f"{compiles}; the eager loop [api-train] {eager['ms']:.2f} ms "
        f"(captured / eager {ms / eager['ms']:.4f})")


def phase_api_plain(losses):
    """[api-plain]: [api-train]'s recipe for two steps with every kernel in
    its plain version (``_plain_kernels``: no launch; the same masks from
    the same seeds): each loss within TRAIN_PLAIN_LOSS_LIMIT of
    [api-train]'s."""
    from paddle_tpu_torch.kernels import launch_counts
    model, opt, batch = _api_full()
    with _plain_kernels():
        before = launch_counts()
        plain = [float(_api_eager_step(model, opt, batch)) for _ in range(2)]
        after = launch_counts()
    if after != before:
        raise AssertionError(f"[api-plain] launched kernels: {before} -> "
                             f"{after}")
    diff = max(abs(x - y) for x, y in zip(losses, plain))
    log(f"[api-plain] losses {[round(x, 4) for x in plain]} against "
        f"[api-train]'s {[round(x, 4) for x in losses[:2]]}: largest "
        f"difference {diff:.3g} (limit {TRAIN_PLAIN_LOSS_LIMIT})")
    if not diff < TRAIN_PLAIN_LOSS_LIMIT:
        raise AssertionError("[api-plain] the kernel path departs from the "
                             "plain path")
    del model, opt, batch


# ---------------------------------------------------------------- vision
# (slice 20): convolution, pooling and the batch norms on the Paddle
# surface, and vision.models' ResNet-50 at BASELINE config 1's geometry
# (CIFAR-10's [B, 3, 32, 32] and 10 classes, seeded synthetic images drawn
# on the host) and at one card's share of config 3's (224 x 224, 1000
# classes). No hand kernel lies on these paths: conv, pooling and BN are
# XLA ops in the JAX package and torch / cuDNN ops in the port.

# [conv-check]: the card against the CPU on the same values (the CPU in
# fp32 on the values rounded to the checked type). fp32 is full fp32 on
# the card (TF32 off); a bf16 output carries 2^-8 of rounding an element
CONV_CHECK_LIMIT = {FP32: 1e-4, BF16: 2e-2}
RESNET_LR, RESNET_MOMENTUM = 0.1, 0.9
RESNET_CHECK = dict(batch=8, size=32, steps=3)
# a training ResNet-50 at this random initialisation is ill-conditioned in
# fp32 (tests/test_torch_vision.py): its logits differ from an fp64 run's
# by 1e-4 to 2e-4, and at batch 8 layer4's batch norms (8 values a
# channel) amplify that into a 1-7% error of every gradient below them,
# on any device. So [resnet-check] holds the loss and the buffers to the
# CPU's within VISION_FWD_LIMIT, and each step's update (from one shared
# state) to the fp64 CPU run's: the card's error, at the median leaf and
# at the worst, within VISION_UPDATE_RATIO times the CPU fp32 run's own
# (plus VISION_UPDATE_FLOOR)
VISION_FWD_LIMIT = 1e-3
VISION_UPDATE_RATIO = 3.0
VISION_UPDATE_FLOOR = 1e-4
VISION_EVAL_LIMIT = 1e-4            # eval mode: fp32 within 1e-6 of fp64
RESNET_TRAIN = dict(batch=32, size=32, windows=3, steps=10)
RESNET_GRAPH = dict(batch=64, size=32, steps=5, windows=3, timed=10)
RESNET_224 = dict(batch=64, size=224, classes=1000, windows=3, steps=5)
RESNET_ORDER = dict(batch=32, size=32, calls=20)


def _resnet50(seed, place, classes=10):
    """``vision.models.resnet50(num_classes=classes)`` built on ``place``
    from ``paddle.seed(seed)``: the initializers draw on the CPU chain, so
    one seed gives the same weights on the card and on the CPU."""
    import paddle_tpu_torch as paddle
    paddle.set_device(place)
    paddle.seed(seed)
    return paddle.vision.models.resnet50(num_classes=classes).train()


def _images(b, size, seed, place, classes=10):
    """Seeded synthetic images ``[b, 3, size, size]`` and labels in
    ``[0, classes)``, drawn on the host and put on ``place``."""
    import paddle_tpu_torch as paddle
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, 3, size, size, generator=gen)
    y = torch.randint(0, classes, (b,), generator=gen)
    paddle.set_device(place)
    return paddle.to_tensor(x), paddle.to_tensor(y)


def _momentum(model):
    import paddle_tpu_torch as paddle
    return paddle.optimizer.Momentum(learning_rate=RESNET_LR,
                                     momentum=RESNET_MOMENTUM,
                                     parameters=model.parameters())


def _paddle_step(model, opt, x, y, amp=None):
    """One step of the Paddle loop (the forward under ``auto_cast(level=
    amp)`` where given): ``loss.backward(); opt.step(); opt.clear_grad()``.
    Returns the loss."""
    import paddle_tpu_torch as paddle
    from contextlib import nullcontext
    with paddle.amp.auto_cast(level=amp) if amp else nullcontext():
        loss = paddle.nn.functional.cross_entropy(model(x), y)
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss


def _classifier(net):
    """``net`` with its loss as one Layer, ``forward(x, y)`` the
    cross-entropy: what ``TrainStep`` differentiates."""
    from paddle_tpu_torch import nn

    class Classifier(nn.Layer):
        def __init__(self):
            super().__init__()
            self.net = net

        def forward(self, x, y):
            return nn.functional.cross_entropy(self.net(x), y)
    return Classifier()


def _vision_state(model, opt):
    """Every parameter, velocity and BN buffer of a run (cloned to the
    host) and its step count."""
    state = {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()}
    for i, p in enumerate(opt._parameter_list):
        for k, t in opt._accumulators.get(id(p), {}).items():
            state[f"{k}:{i}"] = t.cpu().clone()
    state["step_count"] = opt._step_count
    return state


def _finite_rel(tag, got, want):
    """rel_err over the finite entries, after requiring the non-finite
    ones (a ceil_mode window wholly in the pad: -inf, nan) to match."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    fin = torch.isfinite(want)
    if not (torch.equal(torch.isfinite(got), fin)
            and torch.equal(got.isnan(), want.isnan())
            and torch.equal(got[got.isinf()], want[want.isinf()])):
        raise AssertionError(f"{tag}: the non-finite entries differ")
    return rel_err(got[fin], want[fin]) if bool(fin.any()) else 0.0


def _conv_cases():
    """(tag, input shapes, call(F, *inputs) -> outputs, how many leading
    inputs take a gradient, inputs drawn positive)."""
    return [
        ("conv2d stride 2 + bias", [(8, 64, 32, 32), (128, 64, 3, 3),
                                    (128,)],
         lambda F, x, w, b: F.conv2d(x, w, b, stride=2, padding=1), 3, ()),
        ("conv2d dilation 2", [(8, 64, 32, 32), (64, 64, 3, 3)],
         lambda F, x, w: F.conv2d(x, w, padding=2, dilation=2), 2, ()),
        ("conv2d groups 32", [(8, 64, 16, 16), (64, 2, 3, 3)],
         lambda F, x, w: F.conv2d(x, w, padding=1, groups=32), 2, ()),
        ("conv2d depthwise stride 2", [(8, 64, 16, 16), (64, 1, 3, 3)],
         lambda F, x, w: F.conv2d(x, w, stride=2, padding=1, groups=64), 2,
         ()),
        ("conv2d SAME stride 2", [(8, 32, 16, 16), (64, 32, 3, 3)],
         lambda F, x, w: F.conv2d(x, w, stride=2, padding="SAME"), 2, ()),
        ("conv2d NHWC", [(8, 16, 16, 32), (64, 32, 3, 3)],
         lambda F, x, w: F.conv2d(x, w, padding=1, data_format="NHWC"), 2,
         ()),
        ("conv2d_transpose output_padding", [(8, 64, 8, 8), (64, 32, 3, 3),
                                             (32,)],
         lambda F, x, w, b: F.conv2d_transpose(x, w, b, stride=2, padding=1,
                                               output_padding=1), 3, ()),
        ("max_pool2d 3/2/1", [(8, 64, 32, 32)],
         lambda F, x: F.max_pool2d(x, 3, 2, 1), 1, ()),
        ("max_pool2d ceil_mode", [(8, 16, 15, 15)],
         lambda F, x: F.max_pool2d(x, 2, 2, 1, ceil_mode=True), 1, ()),
        ("max_pool2d return_mask", [(8, 16, 16, 16)],
         lambda F, x: F.max_pool2d(x, 3, 2, 1, return_mask=True), 1, ()),
        ("avg_pool2d exclusive", [(8, 64, 32, 32)],
         lambda F, x: F.avg_pool2d(x, 3, 2, 1), 1, ()),
        ("avg_pool2d ceil_mode", [(8, 16, 15, 15)],
         lambda F, x: F.avg_pool2d(x, 2, 2, 1, ceil_mode=True), 0, ()),
        ("adaptive_avg_pool2d 1x1", [(8, 2048, 4, 4)],
         lambda F, x: F.adaptive_avg_pool2d(x, 1), 1, ()),
        ("adaptive_avg_pool2d 3x3 of 7x7", [(8, 64, 7, 7)],
         lambda F, x: F.adaptive_avg_pool2d(x, 3), 1, ()),
        ("adaptive_max_pool2d 2x2 of 7x7", [(8, 64, 7, 7)],
         lambda F, x: F.adaptive_max_pool2d(x, 2), 1, ()),
        ("batch_norm training", [(8, 64, 16, 16), (64,), (64,), (64,),
                                 (64,)],
         lambda F, x, w, b, m, v: (F.batch_norm(x, m, v, w, b,
                                                training=True), m, v), 3,
         (4,)),
        ("batch_norm inference", [(8, 64, 16, 16), (64,), (64,), (64,),
                                  (64,)],
         lambda F, x, w, b, m, v: F.batch_norm(x, m, v, w, b), 3, (4,)),
        ("group_norm 8 groups", [(8, 64, 16, 16), (64,), (64,)],
         lambda F, x, w, b: F.group_norm(x, 8, weight=w, bias=b), 3, ()),
        ("instance_norm", [(8, 64, 16, 16), (64,), (64,)],
         lambda F, x, w, b: F.instance_norm(x, weight=w, bias=b), 3, ()),
        ("local_response_norm 5", [(8, 64, 16, 16)],
         lambda F, x: F.local_response_norm(x, 5), 1, ()),
    ]


def phase_conv_check():
    """[conv-check]: each functional of slice 20 on the card and on the
    CPU from the same values, in fp32 and in bf16 (the CPU in fp32 on the
    bf16-rounded values): every output (a batch norm's running buffers,
    a max pool's int32 mask bit for bit) and the gradient of a fixed
    random projection of the first output for each float input, within
    CONV_CHECK_LIMIT; -inf and nan where the JAX package's ceil_mode puts
    them, on both."""
    import paddle_tpu_torch as paddle
    F = paddle.nn.functional
    gen = torch.Generator().manual_seed(21)
    worst = {FP32: (0.0, ""), BF16: (0.0, "")}
    for tag, shapes, call, n_grad, positive in _conv_cases():
        base = [torch.randn(s, generator=gen) for s in shapes]
        base = [t.abs() + 0.5 if i in positive else t
                for i, t in enumerate(base)]
        for dtype in (FP32, BF16):
            res = {}
            for place in ("gpu", "cpu"):
                paddle.set_device(place)
                dt = dtype if place == "gpu" else FP32
                ins = [paddle.to_tensor(t.to(dtype).to(dt),
                                        stop_gradient=i >= n_grad)
                       for i, t in enumerate(base)]
                out = call(F, *ins)
                outs = list(out) if isinstance(out, tuple) else [out]
                grads = []
                if n_grad:
                    ct = torch.randn(outs[0].shape,
                                     generator=torch.Generator()
                                     .manual_seed(22)).to(dtype).to(dt)
                    ct = paddle.to_tensor(ct)
                    grads = paddle.grad((outs[0] * ct).sum(), ins[:n_grad])
                res[place] = outs + list(grads)
            for k, (g, w) in enumerate(zip(res["gpu"], res["cpu"])):
                what = f"[conv-check] {tag} {str(dtype)[6:]} output {k}"
                if not g.is_floating_point():
                    if not torch.equal(g.cpu(), w):
                        raise AssertionError(f"{what}: the masks differ")
                    continue
                err = _finite_rel(what, g, w)
                if err > worst[dtype][0]:
                    worst[dtype] = (err, f"{tag} output {k}")
                if not err < CONV_CHECK_LIMIT[dtype]:
                    raise AssertionError(f"{what}: rel {err:.3g}, limit "
                                         f"{CONV_CHECK_LIMIT[dtype]}")
    paddle.set_device("gpu")
    log(f"[conv-check] {len(_conv_cases())} cases on the card against the "
        f"CPU, outputs and gradients: worst fp32 rel "
        f"{worst[FP32][0]:.3g} ({worst[FP32][1]}; limit "
        f"{CONV_CHECK_LIMIT[FP32]}), worst bf16 {worst[BF16][0]:.3g} "
        f"({worst[BF16][1]}; limit {CONV_CHECK_LIMIT[BF16]})")


def _resync(models, opts, src):
    """Copy ``src``'s parameters, buffers and velocities into every other
    run (each on its own device and type)."""
    with torch.no_grad():
        for k, m in models.items():
            if k == src:
                continue
            for p, q in zip(m.parameters(), models[src].parameters()):
                p.copy_(q)
            for b, c in zip(m.buffers(), models[src].buffers()):
                b.copy_(c)
            for p, q in zip(opts[k]._parameter_list,
                            opts[src]._parameter_list):
                opts[k]._accumulators[id(p)]["velocity"].copy_(
                    opts[src]._accumulators[id(q)]["velocity"])


def phase_resnet_check():
    """[resnet-check]: fp32 ResNet-50 (10 classes) built from one seed on
    the card and on the CPU (bit for bit), and an fp64 copy on the CPU,
    RESNET_CHECK["steps"] steps of the Paddle loop with ``Momentum(0.1,
    0.9)`` at 8 x 32 x 32, every step from one shared state (the CPU's,
    copied into the others after each step: a training ResNet-50 is
    chaotic in fp32, so free-running runs part after a step on any two
    devices). Each step: the loss and every ``_mean`` / ``_variance``
    after it within VISION_FWD_LIMIT of the CPU's, and the card's updates
    no farther from the fp64 run's than VISION_UPDATE_RATIO times the CPU
    fp32 run's own (median and worst leaf). Returns the card's and the CPU's models (their
    state shared) for [resnet-eval]."""
    import copy
    b, s = RESNET_CHECK["batch"], RESNET_CHECK["size"]
    cpu = _resnet50(11, "cpu")
    card = _resnet50(11, "gpu")
    if not all(torch.equal(p.cpu(), q) for p, q in
               zip(card.parameters(), cpu.parameters())):
        raise AssertionError("[resnet-check] one seed gave other weights "
                             "on the card than on the CPU")
    models = {"card": card, "cpu": cpu,
              "fp64": copy.deepcopy(cpu).to(dtype="float64")}
    opts = {k: _momentum(m) for k, m in models.items()}
    names = [n for n, _ in cpu.named_parameters()]
    for step in range(RESNET_CHECK["steps"]):
        x, y = _images(b, s, 30 + step, "cpu")
        inputs = {"card": (x.cuda(), y.cuda()), "cpu": (x, y),
                  "fp64": (x.double(), y)}
        before = {k: [p.detach().cpu().double().clone()
                      for p in m.parameters()] for k, m in models.items()}
        losses = {k: float(_paddle_step(m, opts[k], *inputs[k]))
                  for k, m in models.items()}
        upd = {k: [p.detach().double().cpu() - q for p, q in
                   zip(m.parameters(), before[k])]
               for k, m in models.items()}
        loss_rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
        bufs = {n: rel_err(b_.cpu(), c) for (n, b_), (_, c) in
                zip(card.named_buffers(), cpu.named_buffers())}
        ucard = [rel_err(a, e) for a, e in zip(upd["card"], upd["fp64"])]
        ucpu = [rel_err(a, e) for a, e in zip(upd["cpu"], upd["fp64"])]
        worst = max(range(len(ucard)), key=ucard.__getitem__)
        med = (float(np.median(ucard)), float(np.median(ucpu)))
        log(f"[resnet-check] step {step}: loss card {losses['card']:.6f}, "
            f"cpu {losses['cpu']:.6f} (rel {loss_rel:.3g}), fp64 "
            f"{losses['fp64']:.6f}; buffers worst rel "
            f"{max(bufs.values()):.3g} (limit {VISION_FWD_LIMIT}); update "
            f"against fp64: card median {med[0]:.3g} max {ucard[worst]:.3g} "
            f"({names[worst]}), cpu median {med[1]:.3g} max "
            f"{max(ucpu):.3g} (the card's within {VISION_UPDATE_RATIO}x the "
            f"cpu's + {VISION_UPDATE_FLOOR})")
        bound = (VISION_UPDATE_RATIO * med[1] + VISION_UPDATE_FLOOR,
                 VISION_UPDATE_RATIO * max(ucpu) + VISION_UPDATE_FLOOR)
        if not (loss_rel < VISION_FWD_LIMIT
                and max(bufs.values()) < VISION_FWD_LIMIT
                and med[0] <= bound[0] and max(ucard) <= bound[1]):
            raise AssertionError(f"[resnet-check] step {step}: the card "
                                 f"disagrees with the CPU")
        _resync(models, opts, "cpu")
    return card, cpu


def phase_resnet_eval(card, cpu):
    """[resnet-eval]: ``model.eval()`` on [resnet-check]'s models (one
    state, its running statistics moved by 3 steps): the forward at
    8 x 32 x 32 on the card and on the CPU, the logits within
    VISION_EVAL_LIMIT; the running statistics are read (eval's logits
    differ from the training forward's)."""
    import paddle_tpu_torch as paddle
    x, _ = _images(RESNET_CHECK["batch"], RESNET_CHECK["size"], 40, "cpu")
    card.eval()
    cpu.eval()
    with paddle.no_grad():
        got, want = card(x.cuda()), cpu(x)
        cpu.train()
        train_logits = cpu(x)
    err = rel_err(got.cpu(), want)
    moved = rel_err(train_logits, want)
    log(f"[resnet-eval] fp32 eval forward [8, 3, 32, 32]: logits rel "
        f"{err:.3g} (limit {VISION_EVAL_LIMIT}); the training forward's "
        f"logits differ by {moved:.3g}")
    if not (err < VISION_EVAL_LIMIT and moved > 10 * VISION_EVAL_LIMIT):
        raise AssertionError("[resnet-eval] the card's eval forward "
                             "disagrees with the CPU's")
    paddle.set_device("gpu")


def _profiled_busy(fn, n):
    """``n`` calls of ``fn`` under torch.profiler, then a synchronise: the
    wall (ms) and the device's busy share of it (None where no device time
    was recorded)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    return wall * 1e3, (busy / 1e6 / wall if busy else None)


def _windows(fn, windows, steps):
    """``windows`` windows of ``steps`` calls, each closed by reading the
    last loss: the ms a step of each window and the losses read."""
    ms, losses = [], []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = fn()
        losses.append(float(loss))
        ms.append((time.perf_counter() - t0) / steps * 1e3)
    return ms, losses


def _rate(tag, smi, b, ms, losses, peak, busy, what):
    mean = sum(ms) / len(ms)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{tag} {what}: losses {losses}")
    log(f"{tag} ({smi}) {what}, batch {b}: {b / mean * 1e3:.1f} images/s, "
        f"{mean:.2f} ms a step (windows {min(ms):.2f}-{max(ms):.2f}), peak "
        f"{peak:.2f} GB, busy {busy if busy is None else round(busy, 3)}; "
        f"losses {[round(v, 4) for v in losses]}")
    return dict(ms=mean, min=min(ms), max=max(ms), ips=b / mean * 1e3,
                peak=peak, busy=busy)


def phase_resnet_train(smi):
    """[resnet-train]: BASELINE config 1's eager row. ResNet-50 (10
    classes) on the card, the Paddle loop ``loss.backward(); opt.step();
    opt.clear_grad()`` with ``Momentum(0.1, 0.9)`` at batch 32 of 32 x 32
    images, in fp32 (full fp32: TF32 off) and under ``auto_cast()`` (O1:
    the convs in bf16, the batch norms in fp32): 2 warm-up steps, then
    RESNET_TRAIN["windows"] windows of RESNET_TRAIN["steps"] steps (images
    /s, ms a step and its spread over the windows), the peak memory, and
    the device's busy share over 3 profiled steps."""
    b, s = RESNET_TRAIN["batch"], RESNET_TRAIN["size"]
    out = {}
    for amp in (None, "O1"):
        model = _resnet50(0, "gpu")
        opt = _momentum(model)
        x, y = _images(b, s, 5, "gpu")

        def step():
            return _paddle_step(model, opt, x, y, amp)
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, losses = _windows(step, RESNET_TRAIN["windows"],
                              RESNET_TRAIN["steps"])
        peak = torch.cuda.max_memory_allocated() / 1e9
        _, busy = _profiled_busy(step, 3)
        what = "fp32" if amp is None else "auto_cast O1 (bf16 convs)"
        out[amp or "fp32"] = _rate("[resnet-train]", smi, b, ms, losses,
                                   peak, busy, f"eager Paddle loop, {what}")
        del model, opt, x, y
        torch.cuda.empty_cache()
    return out


def phase_resnet_graph(smi):
    """[resnet-graph]: BASELINE config 1's compiled row. ResNet-50 with
    its loss under ``TrainStep`` (captured: ``fast_path=True``, the
    default) against ``TrainStep(fast_path=False)`` from the same seed,
    ``FLAGS_cudnn_deterministic`` on: after RESNET_GRAPH["steps"] steps at
    batch 64 the losses, every parameter, velocity and ``_mean`` /
    ``_variance`` bit for bit, the programs CUDA graphs, ``num_compiles``
    1; then both timed (images/s, ms a step over windows) and the captured
    step's busy share."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.jit import TrainStep
    b, s = RESNET_GRAPH["batch"], RESNET_GRAPH["size"]
    res, rates = {}, {}
    paddle.set_flags({"FLAGS_cudnn_deterministic": True})
    try:
        for fast in (False, True):
            net = _resnet50(0, "gpu")
            opt = _momentum(net)
            step = TrainStep(_classifier(net), opt, fast_path=fast)
            x, y = _images(b, s, 6, "gpu")
            losses = [step(x, y) for _ in range(RESNET_GRAPH["steps"])]
            torch.cuda.synchronize()
            res[fast] = (torch.stack([v.detach().as_subclass(torch.Tensor)
                                      for v in losses]).cpu(),
                         _vision_state(net, opt))
            if fast:
                _graph_of(step)
                compiles = step.num_compiles
            torch.cuda.reset_peak_memory_stats()
            ms, seen = _windows(lambda: step(x, y), RESNET_GRAPH["windows"],
                                RESNET_GRAPH["timed"])
            peak = torch.cuda.max_memory_allocated() / 1e9
            _, busy = _profiled_busy(lambda: step(x, y), 3)
            what = "captured TrainStep" if fast else \
                "TrainStep(fast_path=False)"
            rates[fast] = _rate("[resnet-graph]", smi, b, ms, seen, peak,
                                busy, f"{what}, fp32")
            del net, opt, step, x, y
            torch.cuda.empty_cache()
    finally:
        paddle.set_flags({"FLAGS_cudnn_deterministic": False})
    (le, se), (lg, sg) = res[False], res[True]
    if not _bit_equal(lg, le):
        raise AssertionError(f"[resnet-graph] losses {lg} vs {le}")
    _hold_bits("[resnet-graph]", f"{RESNET_GRAPH['steps']} captured steps "
               f"against eager TrainStep (parameters, velocities, _mean and "
               f"_variance)", sg, se)
    if compiles != 1:
        raise AssertionError(f"[resnet-graph] num_compiles {compiles}")
    log(f"[resnet-graph] num_compiles {compiles}; captured / eager "
        f"{rates[True]['ms'] / rates[False]['ms']:.4f}")
    return rates


def phase_resnet_224(smi):
    """[resnet-224]: one card's share of BASELINE config 3's workload
    (no data parallelism): ResNet-50 with 1000 classes at 224 x 224,
    batch 64, ``TrainStep`` captured, every call under ``auto_cast()``
    (O1): the first call (warm-up and capture) and one more, then
    RESNET_224["windows"] windows of RESNET_224["steps"] steps (images/s,
    ms a step), the peak memory from the first call on, the busy share of
    3 steps; one program, a CUDA graph; finite losses."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.jit import TrainStep
    b, s, c = RESNET_224["batch"], RESNET_224["size"], RESNET_224["classes"]
    net = _resnet50(0, "gpu", classes=c)
    opt = _momentum(net)
    step = TrainStep(_classifier(net), opt)
    x, y = _images(b, s, 7, "gpu", classes=c)

    def call():
        with paddle.amp.auto_cast():
            return step(x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    float(call())
    first = time.perf_counter() - t0
    call()
    ms, losses = _windows(call, RESNET_224["windows"], RESNET_224["steps"])
    peak = torch.cuda.max_memory_allocated() / 1e9
    _, busy = _profiled_busy(call, 3)
    _graph_of(step)
    if step.num_compiles != 1:
        raise AssertionError(f"[resnet-224] num_compiles "
                             f"{step.num_compiles}")
    rate = _rate("[resnet-224]", smi, b, ms, losses, peak, busy,
                 f"captured TrainStep, auto_cast O1, {s} x {s}, {c} classes "
                 f"(first call {first:.1f} s)")
    del net, opt, step, x, y
    torch.cuda.empty_cache()
    return rate


def phase_resnet_order():
    """[resnet-order]: RESNET_ORDER["calls"] identical fp32 ResNet-50
    forwards and backwards at batch 32 (``paddle.grad`` of the loss for
    every parameter), ``FLAGS_cudnn_deterministic`` on: every gradient bit
    for bit the first call's (cuDNN may pick algorithms that add with
    atomics; the 1 x 1 adaptive average pool's backward adds one term an
    input). The same calls with the flag off are counted, not gated."""
    import paddle_tpu_torch as paddle
    F = paddle.nn.functional
    model = _resnet50(0, "gpu")
    params = list(model.parameters())
    x, y = _images(RESNET_ORDER["batch"], RESNET_ORDER["size"], 8, "gpu")
    differ = {}
    for on in (True, False):
        paddle.set_flags({"FLAGS_cudnn_deterministic": on})
        try:
            first, n = None, 0
            for _ in range(RESNET_ORDER["calls"]):
                grads = paddle.grad(F.cross_entropy(model(x), y), params)
                grads = [g.as_subclass(torch.Tensor) for g in grads]
                if first is None:
                    first = grads
                    continue
                n += not all(_bit_equal(g, h) for g, h in zip(grads, first))
            differ[on] = n
        finally:
            paddle.set_flags({"FLAGS_cudnn_deterministic": False})
    log(f"[resnet-order] {RESNET_ORDER['calls']} identical fp32 backwards at "
        f"batch {RESNET_ORDER['batch']}: with FLAGS_cudnn_deterministic "
        f"{differ[True]} differ from the first; without it {differ[False]}")
    if differ[True]:
        raise AssertionError("[resnet-order] deterministic backwards differ")
    del model, params, x, y, first, grads
    torch.cuda.empty_cache()


def vision_phases(smi):
    """The slice-20 phases, each with the launch counts set to 0 before it
    and read after: no hand kernel may launch on the vision paths. Returns
    each path's counts and the timings for the record."""
    from paddle_tpu_torch.kernels import reset_launch_counts
    paths = {}

    def run(tag, fn, *args):
        reset_launch_counts()
        out = fn(*args)
        counts = _path_counts()
        ran = {k: n for k, n in counts.items() if n}
        if ran:
            raise AssertionError(f"[{tag}] launched hand kernels: {ran}")
        paths[f"vision-{tag}"] = counts
        return out

    t0 = time.perf_counter()
    run("conv-check", phase_conv_check)
    card, cpu = run("resnet-check", phase_resnet_check)
    run("resnet-eval", phase_resnet_eval, card, cpu)
    del card, cpu
    _release("after [resnet-check] and [resnet-eval]")
    rates = {"train": run("resnet-train", phase_resnet_train, smi)}
    _release("after [resnet-train]")
    rates["graph"] = run("resnet-graph", phase_resnet_graph, smi)
    _release("after [resnet-graph]")
    run("resnet-order", phase_resnet_order)
    rates["224"] = run("resnet-224", phase_resnet_224, smi)
    _release("after [resnet-224]")
    log(f"[vision] the vision phases passed in "
        f"{time.perf_counter() - t0:.1f} s; no hand kernel launched on "
        f"{sorted(paths)}")
    return paths, rates


# ---------------------------------------------------------------- hapi and io
# (slice 21): paddle.Model's fit / evaluate / predict, the callbacks with
# AutoCheckpoint, metric, the DataLoader (collating on the host, worker
# threads) and the DeviceLoader (pinned copies on a side stream), on
# ResNet-50 at BASELINE config 1's geometry (no hand kernel, as in the
# vision phases) and on the Paddle-API encoder at BERT-base width through
# accumulation (rows 4, 5 and 8 and the dq sum). Seeded data only.

HAPI_FIT = dict(batch=32, size=32, steps=20, workers=2, profiled=4, turns=2)
HAPI_GRAPH = dict(batch=64, size=32, steps=20, workers=2, profiled=4)
HAPI_EVAL = dict(batch=64, samples=256)
HAPI_ACCUM = dict(batch=16, seq=512, k=4, windows=3)
HAPI_CKPT = dict(batch=64, size=32, steps=20, save_steps=5, sigterm_at=12)
HAPI_CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "smoke_checkout", "hapi_ckpt")
# [hapi-accum]'s eager GradientMergeOptimizer route sums the microbatches'
# bf16 gradients in bf16 (the JAX package's merge buffer), where the
# compiled routes sum them in fp32: each window's loss within
# HAPI_MERGE_LOSS_LIMIT (relative) and the update of the fp32 masters over
# the 3 windows within HAPI_MERGE_UPDATE_LIMIT (norm-relative over all
# leaves) of the compiled routes'. Adam's first updates are about lr times
# the gradient's sign, so the bf16 sums move only the elements whose
# gradient is near 0
HAPI_MERGE_LOSS_LIMIT = 1e-2
HAPI_MERGE_UPDATE_LIMIT = 5e-2


def _hapi_images(n, size, seed, classes=10):
    """``io.TensorDataset`` of seeded host images ``[n, 3, size, size]``
    and labels in ``[0, classes)``, as numpy arrays."""
    import paddle_tpu_torch as paddle
    r = np.random.default_rng(seed)
    x = r.standard_normal((n, 3, size, size), dtype=np.float32)
    y = r.integers(0, classes, (n,)).astype(np.int64)
    return paddle.io.TensorDataset([x, y])


def _hapi_loader(ds, batch, workers, device=True, **kw):
    """``io.DataLoader`` (shuffled, worker threads), in an
    ``io.DeviceLoader(prefetch_depth=2)`` where ``device``."""
    import paddle_tpu_torch as paddle
    dl = paddle.io.DataLoader(ds, batch_size=batch, shuffle=True,
                              num_workers=workers)
    return paddle.io.DeviceLoader(dl, prefetch_depth=2, **kw) if device \
        else dl


def _step_log():
    """A callback keeping each step's logs and the host clock at each
    step's end and each epoch's begin and end."""
    import paddle_tpu_torch as paddle

    class StepLog(paddle.callbacks.Callback):
        def __init__(self):
            super().__init__()
            self.logs, self.epochs, self.ends = [], [], []

        def on_epoch_begin(self, epoch, logs=None):
            self.epochs.append([time.perf_counter(), None])

        def on_epoch_end(self, epoch, logs=None):
            self.epochs[-1][1] = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            self.logs.append(dict(logs))
            self.ends.append(time.perf_counter())

        def ms(self, epoch, steps):
            t0, t1 = self.epochs[epoch]
            return (t1 - t0) / steps * 1e3
    return StepLog()


def _deterministic(fn, *args):
    """``fn(*args)`` with ``FLAGS_cudnn_deterministic`` on (cuDNN's
    backwards add with atomics otherwise, as [resnet-order] shows)."""
    import paddle_tpu_torch as paddle
    paddle.set_flags({"FLAGS_cudnn_deterministic": True})
    try:
        return fn(*args)
    finally:
        paddle.set_flags({"FLAGS_cudnn_deterministic": False})


def phase_recompute_bn():
    """[recompute-bn]: F12's card gate. ``Conv2D(3, 3, 3, padding=1)`` +
    ``BatchNorm2D(3)`` under ``fleet.recompute`` and without it, from one
    seed, ``FLAGS_cudnn_deterministic`` on: one captured ``TrainStep``
    with ``Momentum(0.1, 0.9)`` on a seeded [4, 3, 5, 5] batch (the
    parameters after the step carry the gradients, ``_mean`` /
    ``_variance`` the running update), then ``paddle.grad`` of the loss
    eagerly: parameters, buffers and gradients bit for bit with and
    without recompute, and the buffers moved once."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.jit import TrainStep
    nn = paddle.nn
    x = paddle.to_tensor(np.random.default_rng(0).standard_normal(
        (4, 3, 5, 5), dtype=np.float32))

    class Net(nn.Layer):
        def __init__(self, recompute):
            super().__init__()
            self.recompute = recompute
            self.conv = nn.Conv2D(3, 3, 3, padding=1)
            self.bn = nn.BatchNorm2D(3)

        def forward(self, t):
            def block(u):
                return self.bn(self.conv(u))
            y = paddle.distributed.fleet.recompute(block, t) \
                if self.recompute else block(t)
            return (y * y).mean()

    def run():
        out = {}
        for recompute in (False, True):
            paddle.seed(5)
            net = Net(recompute)
            init = {k: v.detach().clone() for k, v in
                    net.state_dict().items()}
            step = TrainStep(net, paddle.optimizer.Momentum(
                0.1, 0.9, parameters=net.parameters()))
            step(x)
            _graph_of(step)
            state = {k: v.detach().clone() for k, v in
                     net.state_dict().items()}
            grads = paddle.grad(net(x), list(net.parameters()))
            state.update({f"grad:{i}": g.detach().clone()
                          for i, g in enumerate(grads)})
            state["step_count"] = 1
            out[recompute] = (init, state)
        return out
    out = _deterministic(run)
    (init, plain), (_, again) = out[False], out[True]
    _hold_bits("[recompute-bn]", "recompute against none (captured step, "
               "then paddle.grad)", again, plain)
    moved = [k for k in init if k.startswith("bn._")
             and _bit_equal(plain[k], init[k])]
    if moved:
        raise AssertionError(f"[recompute-bn] {moved} did not move")


def phase_hapi_fit(smi, resnet):
    """[hapi-fit]: BASELINE config 1 through the high-level API.
    ``paddle.Model(vision.models.resnet50(num_classes=10))`` with
    ``prepare(Momentum(0.1, 0.9), nn.CrossEntropyLoss(),
    metric.Accuracy())``, eager, one epoch of HAPI_FIT["steps"] steps at
    batch 32 over a seeded ``io.TensorDataset`` of [3, 32, 32] images, a
    shuffled ``DataLoader`` with 2 worker threads; against a hand eager
    loop over the same batches on a model built from the same seed, both
    under ``FLAGS_cudnn_deterministic`` after two warm-up steps: every
    step's loss and accuracy bit for bit. Then HAPI_FIT["turns"] more
    epochs of each in turns (fit, hand, fit, hand) for the times. Prints
    images/s of each epoch, the host time of ``network.train()`` (the
    fit calls it every step), and the busy share of HAPI_FIT["profiled"]
    more fit steps, beside [resnet-train]'s."""
    import paddle_tpu_torch as paddle
    F = paddle.nn.functional
    b, steps = HAPI_FIT["batch"], HAPI_FIT["steps"]
    ds = _hapi_images(b * steps, HAPI_FIT["size"], 50)

    def run():
        # cuDNN picks and plans its algorithms at a shape's first call:
        # two warm-up steps, so neither timed route pays for that
        warm = _resnet50(0, "gpu")
        x0, y0 = _images(b, HAPI_FIT["size"], 52, "gpu")
        for _ in range(2):
            _paddle_step(warm, _momentum(warm), x0, y0)
        del warm
        net = _resnet50(0, "gpu")
        model = paddle.Model(net)
        model.prepare(_momentum(net), paddle.nn.CrossEntropyLoss(),
                      paddle.metric.Accuracy())
        hand_net = _resnet50(0, "gpu")
        opt = _momentum(hand_net)

        def fit_epoch():
            rec = _step_log()
            torch.cuda.synchronize()
            model.fit(_hapi_loader(ds, b, HAPI_FIT["workers"],
                                   device=False),
                      epochs=1, verbose=0, callbacks=[rec])
            return rec.logs, rec.ms(0, steps)

        def hand_epoch():
            acc = paddle.metric.Accuracy()
            logs = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for xb, yb in _hapi_loader(ds, b, HAPI_FIT["workers"],
                                       device=False):
                xb, yb = xb.cuda(), yb.cuda()
                out = hand_net(xb)
                loss = F.cross_entropy(out, yb)
                loss.backward()
                opt.step()
                opt.clear_grad()
                acc.update(acc.compute(out, yb))
                logs.append({"loss": float(loss),
                             "acc": float(acc.accumulate())})
            return logs, (time.perf_counter() - t0) / steps * 1e3
        np.random.seed(51)
        logs, fit_ms = fit_epoch()
        np.random.seed(51)
        hand, hand_ms = hand_epoch()
        turns = {"fit": [fit_ms], "hand": [hand_ms]}
        for _ in range(HAPI_FIT["turns"]):
            turns["fit"].append(fit_epoch()[1])
            turns["hand"].append(hand_epoch()[1])
        t0 = time.perf_counter()
        for _ in range(50):
            net.train()
        train_ms = (time.perf_counter() - t0) / 50 * 1e3
        sub = paddle.io.Subset(ds, range(b * HAPI_FIT["profiled"]))
        _, busy = _profiled_busy(lambda: model.fit(
            _hapi_loader(sub, b, HAPI_FIT["workers"], device=False),
            epochs=1, verbose=0), 1)
        return logs, hand, turns, train_ms, busy
    logs, hand, turns, train_ms, busy = _deterministic(run)
    if logs != hand or len(logs) != steps:
        first = next((i for i, (g, w) in enumerate(zip(logs, hand))
                      if g != w), None)
        raise AssertionError(f"[hapi-fit] the fit's logs differ from the "
                             f"hand loop's at step {first}: "
                             f"{logs[first:first + 1]} vs "
                             f"{hand[first:first + 1]}")
    ref = resnet.get("fp32") if resnet else None
    beside = (f"[resnet-train]'s eager loop {ref['ms']:.2f} ms, busy "
              f"{ref['busy'] if ref['busy'] is None else round(ref['busy'], 3)}"
              if ref else "[resnet-train] not run in this process")
    fit, hand_t = turns["fit"], turns["hand"]
    log(f"[hapi-fit] ({smi}) Model.fit eager, ResNet-50 fp32, batch {b}, "
        f"{steps} steps: every step's loss and accuracy bit for bit the "
        f"hand loop's (last {logs[-1]}); ms a step by epoch, in turns: fit "
        f"{[round(v, 2) for v in fit]}, hand loop "
        f"{[round(v, 2) for v in hand_t]} (mean {np.mean(fit):.2f} against "
        f"{np.mean(hand_t):.2f}: {b / np.mean(fit) * 1e3:.1f} against "
        f"{b / np.mean(hand_t) * 1e3:.1f} images/s); network.train() "
        f"{train_ms:.3f} ms on the host; busy "
        f"{busy if busy is None else round(busy, 3)} over "
        f"{HAPI_FIT['profiled']} fit steps; {beside}")


def phase_hapi_graph(smi):
    """[hapi-graph]: ``prepare(jit_compile=True)`` (the captured
    ``TrainStep``) at batch 64, fed by ``io.DeviceLoader(DataLoader(...),
    prefetch_depth=2)``, ``FLAGS_cudnn_deterministic`` on, 2 epochs of
    HAPI_GRAPH["steps"] steps from one numpy seed, three ways: ``fit``
    (a ``float(loss)`` and the callbacks each step), ``fit(metric_lag=
    2)``, and a hand loop over a ``TrainStep`` of the network and its loss
    on the same DeviceLoader (the loss read once an epoch). Gate: every
    step's loss, every parameter, velocity and buffer bit for bit across
    the three, ``num_compiles`` 1 each. Prints the second epoch's ms a step
    of each, the DeviceLoader's wait a step, and the busy share over
    HAPI_GRAPH["profiled"] more steps of the synced fit and the hand loop.
    Returns route "fit"'s network (for [hapi-eval])."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.jit import TrainStep
    b, steps = HAPI_GRAPH["batch"], HAPI_GRAPH["steps"]
    ds = _hapi_images(b * steps, HAPI_GRAPH["size"], 60)
    sub = paddle.io.Subset(ds, range(b * HAPI_GRAPH["profiled"]))

    def fit_route(lag):
        net = _resnet50(0, "gpu")
        model = paddle.Model(net)
        opt = _momentum(net)
        model.prepare(opt, paddle.nn.CrossEntropyLoss(), jit_compile=True)
        rec = _step_log()
        loader = _hapi_loader(ds, b, HAPI_GRAPH["workers"])
        np.random.seed(61)
        model.fit(loader, epochs=2, verbose=0, callbacks=[rec],
                  metric_lag=lag)
        wait = loader.last_wait_s / steps * 1e3
        state = _vision_state(net, opt)
        busy = None
        if not lag:
            busy = _profiled_busy(lambda: model.fit(
                _hapi_loader(sub, b, HAPI_GRAPH["workers"]), epochs=1,
                verbose=0), 1)[1]
        step = model._train_step
        _graph_of(step)
        return dict(losses=[x["loss"] for x in rec.logs], ms=rec.ms(1, steps),
                    wait=wait, busy=busy, compiles=step.num_compiles,
                    state=state, net=net)

    def hand_route():
        net = _resnet50(0, "gpu")
        opt = _momentum(net)
        step = TrainStep(_classifier(net), opt)
        loader = _hapi_loader(ds, b, HAPI_GRAPH["workers"])
        np.random.seed(61)
        losses, ms = [], 0.0
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            seen, waits = [], []
            it = iter(loader)
            while True:
                t = time.perf_counter()
                batch = next(it, None)
                if batch is None:
                    break
                waits.append(time.perf_counter() - t)
                seen.append(step(*batch))
            losses += [float(v) for v in seen]
            ms = (time.perf_counter() - t0) / steps * 1e3
        wait = loader.last_wait_s / steps * 1e3
        # the epoch's first batch waits for the pipeline to fill
        split = (waits[0] * 1e3, np.mean(waits[1:]) * 1e3)
        state = _vision_state(net, opt)

        def more():
            for xb, yb in _hapi_loader(sub, b, HAPI_GRAPH["workers"]):
                step(xb, yb)
        busy = _profiled_busy(more, 1)[1]
        _graph_of(step)
        return dict(losses=losses, ms=ms, wait=wait, busy=busy,
                    compiles=step.num_compiles, state=state, split=split)

    def run():
        out = {}
        for name, fn in (("fit", lambda: fit_route(0)),
                         ("fit metric_lag=2", lambda: fit_route(2)),
                         ("hand loop", hand_route)):
            out[name] = fn()
            out[name]["state"]["losses"] = torch.tensor(out[name]["losses"])
            if name != "fit":
                _release(f"after [hapi-graph] {name}")
        return out
    out = _deterministic(run)
    want = out["fit"]
    for name, got in out.items():
        if got["compiles"] != 1:
            raise AssertionError(f"[hapi-graph] {name}: num_compiles "
                                 f"{got['compiles']}")
        if name != "fit":
            _hold_bits(f"[hapi-graph] {name}", "against fit, 2 epochs of "
                       f"{steps} captured steps (losses, parameters, "
                       f"velocities, _mean and _variance)", got["state"],
                       want["state"])

    def fmt(v):
        return v if v is None else round(v, 3)
    log(f"[hapi-graph] ({smi}) ResNet-50 fp32, batch {b}, captured, fed by "
        f"a DeviceLoader: ms a step (second epoch) "
        + "; ".join(f"{k} {v['ms']:.2f} (DeviceLoader wait "
                    f"{v['wait']:.3f} ms a step, busy {fmt(v['busy'])})"
                    for k, v in out.items())
        + f"; the hand loop's next() waited {out['hand loop']['split'][0]:.3f}"
        f" ms for an epoch's first batch and {out['hand loop']['split'][1]:.3f}"
        f" ms a step after it"
        + f"; fit / hand loop {want['ms'] / out['hand loop']['ms']:.4f}, "
        f"metric_lag=2 / hand loop "
        f"{out['fit metric_lag=2']['ms'] / out['hand loop']['ms']:.4f}")
    return want["net"]


def phase_hapi_eval(net):
    """[hapi-eval]: on [hapi-graph]'s trained network, ``Model.evaluate``
    with ``nn.CrossEntropyLoss`` and ``metric.Accuracy(topk=(1, 5))`` over
    HAPI_EVAL["samples"] seeded images at batch 64 against a hand
    evaluation (the last batch's loss, top-1 and top-5 bit for bit), and
    ``predict(stack_outputs=True)`` against the hand eval forward, bit for
    bit."""
    import paddle_tpu_torch as paddle
    b, n = HAPI_EVAL["batch"], HAPI_EVAL["samples"]
    ds = _hapi_images(n, HAPI_GRAPH["size"], 70)
    images = paddle.io.TensorDataset([ds.tensors[0]])

    def run():
        model = paddle.Model(net)
        model.prepare(loss=paddle.nn.CrossEntropyLoss(),
                      metrics=paddle.metric.Accuracy(topk=(1, 5)))
        logs = model.evaluate(ds, batch_size=b, verbose=0)
        got = (logs["loss"], model._metrics[0].accumulate())
        pred = model.predict(images, batch_size=b, stack_outputs=True)
        acc = paddle.metric.Accuracy(topk=(1, 5))
        net.eval()
        outs = []
        with paddle.no_grad():
            for xb, yb in paddle.io.DataLoader(ds, batch_size=b):
                xb, yb = xb.cuda(), yb.cuda()
                out = net(xb)
                loss = paddle.nn.functional.cross_entropy(out, yb)
                acc.update(acc.compute(out, yb))
                outs.append(out.numpy())
        return got, (float(loss), acc.accumulate()), pred, \
            np.concatenate(outs)
    got, want, pred, hand = _deterministic(run)
    if got != want:
        raise AssertionError(f"[hapi-eval] evaluate {got} vs the hand "
                             f"evaluation {want}")
    if not np.array_equal(pred, hand):
        raise AssertionError("[hapi-eval] predict differs from the hand "
                             "forward")
    log(f"[hapi-eval] evaluate over {n} images: loss {got[0]:.6f}, top-1 "
        f"{got[1][0]:.4f}, top-5 {got[1][1]:.4f}, bit for bit the hand "
        f"evaluation; predict(stack_outputs=True) {pred.shape} bit for bit "
        f"the hand forward")


def _accum_launches(tag, counts):
    """A callback (or a hand loop's check) that holds each window's
    launches to HAPI_ACCUM["k"] x API_STEP_LAUNCHES."""
    k = HAPI_ACCUM["k"]
    want = {n: k * v for n, v in API_STEP_LAUNCHES.items()}
    _expect_launches(tag, counts, **want)


def phase_hapi_accum(smi):
    """[hapi-accum]: the Paddle-API encoder at BERT-base width
    (``_api_encoder(API_BERT)``: 12 layers of 12 heads of 64, dropout 0.1)
    in bf16 with ``AdamW(multi_precision=True)``, microbatches of 16 x
    512, K = 4, HAPI_ACCUM["windows"] windows, three routes from one seed
    (the global chain reseeded before each: dropout draws from it):
    ``Model.fit`` over ``io.DeviceLoader(DataLoader(...),
    stack_batches=4)`` with ``prepare(accumulate_steps=4)``; a hand
    ``TrainStep(accumulate_steps=4)`` over ``io.stack_microbatches`` of
    the host batches; ``TrainStep(fleet.GradientMergeOptimizer(opt,
    k_steps=4))``. Gate: each window launching 4 x API_STEP_LAUNCHES (rows
    4, 5 and 8, the dq sum behind each backward), the window losses and
    every parameter, moment and master bit for bit across the three,
    ``num_compiles`` 1 each. Then the eager ``GradientMergeOptimizer``
    route (``loss.backward(); opt.step(); opt.clear_grad()`` a
    microbatch) within HAPI_MERGE_LOSS_LIMIT and HAPI_MERGE_UPDATE_LIMIT.
    Returns the launches of the three compiled routes."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import launch_counts
    b, s, k, windows = (HAPI_ACCUM["batch"], HAPI_ACCUM["seq"],
                        HAPI_ACCUM["k"], HAPI_ACCUM["windows"])
    r = np.random.default_rng(80)
    n = b * k * windows
    ids = r.integers(0, API_BERT["vocab"], (n, s)).astype(np.int64)
    labels = r.integers(0, API_BERT["vocab"], (n, s)).astype(np.int64)
    ds = paddle.io.TensorDataset([ids, labels])
    total = {}

    def build():
        model = _api_encoder(API_BERT, 0, "gpu")
        model.to(dtype="bfloat16")
        opt = paddle.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                                     parameters=model.parameters(),
                                     multi_precision=True)
        init = {i: p.detach().float().clone()
                for i, p in enumerate(opt._parameter_list)}
        paddle.seed(11)
        return model, opt, init

    class Window(paddle.callbacks.Callback):
        def on_train_batch_begin(self, step, logs=None):
            self.before = launch_counts()

        def on_train_batch_end(self, step, logs=None):
            _accum_launches(f"[hapi-accum] fit window {step}",
                            _grew(self.before, launch_counts()))

    def host_windows():
        dl = paddle.io.DataLoader(ds, batch_size=b)
        batches = list(dl)
        return [paddle.io.stack_microbatches(batches[i:i + k])
                for i in range(0, len(batches), k)]

    def finish(name, model, opt, losses, step, t0, ends):
        """The route's state (window losses too) and its times: the first
        window (with the capture) and the mean of the others, each
        closed by reading its loss."""
        ms = ((ends[0] - t0) * 1e3,
              (ends[-1] - ends[0]) / (len(ends) - 1) * 1e3)
        if step.num_compiles != 1:
            raise AssertionError(f"[hapi-accum] {name}: num_compiles "
                                 f"{step.num_compiles}")
        _graph_of(step)
        state = {k_: v.cpu() if torch.is_tensor(v) else v
                 for k_, v in _train_state(model, opt).items()}
        state["losses"] = torch.tensor(losses)
        return state, ms

    out, ms = {}, {}
    before_all = launch_counts()
    # 1. Model.fit over a stacking DeviceLoader
    model, opt, init = build()
    hapi = paddle.Model(model)
    hapi.prepare(opt, accumulate_steps=k)
    rec = _step_log()
    t0 = time.perf_counter()
    hapi.fit(paddle.io.DeviceLoader(paddle.io.DataLoader(ds, batch_size=b),
                                    stack_batches=k),
             epochs=1, verbose=0, callbacks=[Window(), rec])
    out["fit"], ms["fit"] = finish("fit", model, opt,
                                   [x["loss"] for x in rec.logs],
                                   hapi._train_step, t0, rec.ends)
    del model, opt, hapi
    _release("after [hapi-accum] fit")
    # 2. and 3. hand TrainSteps over stacked host windows
    for name in ("accumulate_steps=4", "GradientMergeOptimizer"):
        model, opt, _ = build()
        step = TrainStep(model, opt, accumulate_steps=k) \
            if name == "accumulate_steps=4" else \
            TrainStep(model, paddle.distributed.fleet.GradientMergeOptimizer(
                opt, k_steps=k))
        losses, ends = [], []
        t0 = time.perf_counter()
        for i, window in enumerate(host_windows()):
            before = launch_counts()
            losses.append(float(step(*window)))
            ends.append(time.perf_counter())
            _accum_launches(f"[hapi-accum] {name} window {i}",
                            _grew(before, launch_counts()))
        out[name], ms[name] = finish(name, model, opt, losses, step, t0,
                                     ends)
        del model, opt, step
        _release(f"after [hapi-accum] {name}")
    total = _grew(before_all, launch_counts())
    for name, state in out.items():
        if name != "fit":
            _hold_bits(f"[hapi-accum] {name}", f"against Model.fit, "
                       f"{windows} windows of {k} x {b} x {s} (window "
                       f"losses too)", state, out["fit"])
    # 4. the eager merge buffer
    model, opt, _ = build()
    merged = paddle.distributed.fleet.GradientMergeOptimizer(opt, k_steps=k)
    eager = []
    for i, (xb, yb) in enumerate(paddle.io.DataLoader(ds, batch_size=b)):
        loss = model(xb.cuda(), yb.cuda())
        loss.backward()
        merged.step()
        merged.clear_grad()
        eager.append(float(loss))
    windows_eager = [sum(eager[i:i + k]) / k for i in range(0, n // b, k)]
    ref = out["accumulate_steps=4"]
    loss_rel = max(abs(a - w) / abs(w) for a, w in
                   zip(windows_eager, ref["losses"].tolist()))
    upd_got, upd_want = [], []
    for i, p in enumerate(opt._parameter_list):
        m = opt._master_weights.get(id(p), p).detach().float().cpu()
        upd_got.append((m - init[i].cpu()).flatten())
        upd_want.append((ref[f"master:{i}"].float() - init[i].cpu())
                        .flatten())
    upd_rel = rel_err(torch.cat(upd_got), torch.cat(upd_want))
    del model, opt, merged
    _release("after [hapi-accum] eager merge")
    log(f"[hapi-accum] ({smi}) the Paddle-API encoder, BERT-base width, "
        f"bf16, {windows} windows of {k} x {b} x {s}: Model.fit over "
        f"DeviceLoader(stack_batches={k}), TrainStep(accumulate_steps={k}) "
        f"and TrainStep(GradientMergeOptimizer(k_steps={k})) bit for bit, "
        f"num_compiles 1 each, window losses "
        f"{[round(v, 4) for v in out['fit']['losses'].tolist()]}; ms a window "
        "(the first, with its capture / the mean of the others) "
        + ", ".join(f"{k_} {v[0]:.2f} / {v[1]:.2f}" for k_, v in ms.items())
        + f"; launches {total}; the eager "
        f"merge buffer (bf16 sums): window losses rel {loss_rel:.3g} (limit "
        f"{HAPI_MERGE_LOSS_LIMIT}), masters' update rel {upd_rel:.3g} (limit "
        f"{HAPI_MERGE_UPDATE_LIMIT})")
    if not (loss_rel < HAPI_MERGE_LOSS_LIMIT
            and upd_rel < HAPI_MERGE_UPDATE_LIMIT):
        raise AssertionError("[hapi-accum] the eager GradientMergeOptimizer "
                             "departs from the compiled accumulation")
    return total


def phase_hapi_ckpt(smi):
    """[hapi-ckpt]: ``callbacks.AutoCheckpoint(save_steps=5)`` on
    [hapi-graph]'s captured ResNet-50 fit (batch 64, one epoch of
    HAPI_CKPT["steps"] steps, ``FLAGS_cudnn_deterministic`` on): a callback
    sends this process SIGTERM at step 12; the fit takes an emergency
    snapshot at step 12 (after the periodic ones at 5 and 10) and stops.
    A second fit, on a model built from another seed, resumes from it
    (replaying the data position) and finishes the epoch. Gate: its
    parameters, velocities, buffers and step count bit for bit an
    uninterrupted fit's, the SIGTERM handler restored. Prints the stall
    each ``save()`` put on the loop."""
    import signal
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed.checkpoint import committed_steps
    b, steps = HAPI_CKPT["batch"], HAPI_CKPT["steps"]
    ds = _hapi_images(b * steps, HAPI_GRAPH["size"], 90)
    shutil.rmtree(HAPI_CKPT_DIR, ignore_errors=True)
    prev = signal.getsignal(signal.SIGTERM)
    stalls = []

    class Timed(paddle.callbacks.AutoCheckpoint):
        def _save(self, block, mode=None):
            fresh = self._global_step != self._last_saved
            t0 = time.perf_counter()
            super()._save(block, mode)
            if fresh:
                stalls.append((self._global_step,
                               mode or ("sync" if block else "async"),
                               (time.perf_counter() - t0) * 1e3))

    class Sigterm(paddle.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            if step + 1 == HAPI_CKPT["sigterm_at"]:
                os.kill(os.getpid(), signal.SIGTERM)

    def fit(seed, cbs):
        net = _resnet50(seed, "gpu")
        opt = _momentum(net)
        model = paddle.Model(net)
        model.prepare(opt, paddle.nn.CrossEntropyLoss(), jit_compile=True)
        np.random.seed(91)
        model.fit(_hapi_loader(ds, b, HAPI_GRAPH["workers"]), epochs=1,
                  verbose=0, callbacks=cbs)
        if signal.getsignal(signal.SIGTERM) != prev:
            raise AssertionError("[hapi-ckpt] the SIGTERM handler was not "
                                 "restored")
        return model, _vision_state(net, opt)

    def run():
        _, straight = fit(0, [])
        cut, _ = fit(0, [Sigterm(), Timed(HAPI_CKPT_DIR, save_steps=HAPI_CKPT[
            "save_steps"], verbose=0)])
        saved = committed_steps(HAPI_CKPT_DIR)
        _, resumed = fit(1, [Timed(HAPI_CKPT_DIR, save_steps=HAPI_CKPT[
            "save_steps"], verbose=0)])
        return straight, cut.stop_training, saved, resumed
    straight, stopped, saved, resumed = _deterministic(run)
    at = HAPI_CKPT["sigterm_at"]
    if not stopped or at not in saved or [s for s, _, _ in stalls[:3]] != [
            5, 10, at] or stalls[2][1] != "emergency":
        raise AssertionError(f"[hapi-ckpt] no emergency snapshot at step "
                             f"{at}: saves {stalls}, committed {saved}")
    _hold_bits("[hapi-ckpt]", f"resumed at step {at} against an "
               f"uninterrupted fit of {steps} steps (parameters, "
               f"velocities, _mean and _variance)", resumed, straight)
    mb = _snapshot_bytes(os.path.join(HAPI_CKPT_DIR, f"step_{at}")) / 1e6
    log(f"[hapi-ckpt] ({smi}) AutoCheckpoint(save_steps="
        f"{HAPI_CKPT['save_steps']}) on the captured fit, batch {b}: SIGTERM "
        f"at step {at} -> emergency snapshot and stop, committed {saved}; a "
        f"snapshot {mb:.1f} MB; the stall each save() put on the loop: "
        + ", ".join(f"step {s} {m} {ms:.1f} ms" for s, m, ms in stalls)
        + " (warm page cache)")
    shutil.rmtree(HAPI_CKPT_DIR, ignore_errors=True)


def hapi_phases(smi, resnet=None):
    """The slice-21 phases, each with the launch counts set to 0 before it
    and read after: the ResNet paths launch no hand kernel; [hapi-accum]
    launches rows 4, 5 and 8 and the dq sum (counted a window inside it).
    ``resnet`` is [resnet-train]'s rates where the vision phases ran.
    Returns each path's counts."""
    from paddle_tpu_torch.kernels import reset_launch_counts
    paths = {}

    def run(tag, fn, *args, kernels=False):
        reset_launch_counts()
        out = fn(*args)
        counts = _path_counts()
        ran = {k: n for k, n in counts.items() if n}
        if ran and not kernels:
            raise AssertionError(f"[{tag}] launched hand kernels: {ran}")
        paths[tag] = counts
        return out

    t0 = time.perf_counter()
    run("recompute-bn", phase_recompute_bn)
    run("hapi-fit", phase_hapi_fit, smi, resnet)
    _release("after [hapi-fit]")
    net = run("hapi-graph", phase_hapi_graph, smi)
    run("hapi-eval", phase_hapi_eval, net)
    del net
    _release("after [hapi-graph] and [hapi-eval]")
    run("hapi-accum", phase_hapi_accum, smi, kernels=True)
    _release("after [hapi-accum]")
    run("hapi-ckpt", phase_hapi_ckpt, smi)
    _release("after [hapi-ckpt]")
    ran = {k: n for k, n in paths["hapi-accum"].items() if n}
    log(f"[hapi] the hapi phases passed in {time.perf_counter() - t0:.1f} "
        f"s; [hapi-accum] launched {ran}, the other paths nothing")
    return paths


# ---------------------------------------------------------------- the rest
# of nn and the optimizers (slice 22): a PTB LSTM language model, BERT-base
# under Lamb, and the new functionals, layers and rules on the card against
# the CPU

# Zaremba et al. 2014 (arXiv:1409.2329), the "medium" PTB model: vocabulary
# 10,000, embedding 650, 2 LSTM layers of 650 unrolled 35 steps, batch 20,
# dropout 0.5 on the embedding and LSTM outputs, untied head, uniform
# +-0.05 init, SGD at 1.0 with the global norm clipped at 5, zero states
PTB_MEDIUM = dict(vocab=10000, hidden=650, layers=2, unroll=35, batch=20,
                  dropout=0.5, init=0.05, lr=1.0, clip=5.0)
LSTM_TRAIN = dict(windows=3, steps=10, profiled=3)
LSTM_CHECK_BATCH = 4
# a step's launches: the two dropouts (row 8), each forward and backward
LSTM_STEP_LAUNCHES = dict(dropout_fwd=4)
# [bert-lamb]: [bert-train]'s recipe with Lamb in place of AdamW (the bf16
# weights update through fp32 masters, which Lamb keeps whether asked or
# not); LayerNorm weights and biases exempt from the decay
BERT_LAMB = dict(lr=1e-4, wd=0.01, steps=3, timed=3)
SURFACE_REL_LIMIT = 1e-4
# the six rules [surface-check] runs on the card against the CPU and
# captured against eager
SURFACE_RULES = [("SGD", dict(learning_rate=0.1)),
                 ("Adamax", dict(learning_rate=0.01)),
                 ("Adagrad", dict(learning_rate=0.1,
                                  initial_accumulator_value=0.1)),
                 ("Adadelta", dict(learning_rate=1.0)),
                 ("RMSProp", dict(learning_rate=0.01, momentum=0.9,
                                  centered=True)),
                 ("Lamb", dict(learning_rate=0.01, lamb_weight_decay=0.01))]


def _ptb_lm(place, dropout=None, seed=0):
    """The PTB medium model on ``place`` ("gpu" or "cpu"), every weight
    drawn uniform in [-init, init] from numpy ``seed`` (the same weights
    on both places); its ``forward(x, y)`` returns the mean cross-entropy
    of the next-token logits."""
    import paddle_tpu_torch as paddle
    nn, F = paddle.nn, paddle.nn.functional
    cfg = PTB_MEDIUM
    rate = cfg["dropout"] if dropout is None else dropout

    class PTBLanguageModel(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embedding = nn.Embedding(cfg["vocab"], cfg["hidden"])
            # the LSTM's own dropout is taken and not read (as in JAX)
            self.drop = nn.Dropout(rate)
            self.lstm = nn.LSTM(cfg["hidden"], cfg["hidden"],
                                num_layers=cfg["layers"])
            self.head = nn.Linear(cfg["hidden"], cfg["vocab"])

        def forward(self, x, y):
            out, _ = self.lstm(self.drop(self.embedding(x)))
            logits = self.head(self.drop(out))
            return F.cross_entropy(logits.reshape([-1, cfg["vocab"]]),
                                   y.reshape([-1]))

    paddle.set_device(place)
    model = PTBLanguageModel()
    paddle.set_device("gpu")
    rs = np.random.RandomState(seed)
    for p in model.parameters():
        p.set_value(rs.uniform(-cfg["init"], cfg["init"],
                               tuple(p.shape)).astype(np.float32))
    return model


def _ptb_batch(b, seed, place):
    """Seeded token ids (Zipf over the vocabulary, as word counts are; the
    PTB files are not in the repository): inputs and next-token targets
    ``[b, unroll]``."""
    import paddle_tpu_torch as paddle
    v, t = PTB_MEDIUM["vocab"], PTB_MEDIUM["unroll"]
    p = 1.0 / np.arange(1, v + 1)
    ids = np.random.RandomState(seed).choice(v, size=(b, t + 1),
                                             p=p / p.sum())
    return (paddle.to_tensor(ids[:, :-1], dtype="int64", place=place),
            paddle.to_tensor(ids[:, 1:], dtype="int64", place=place))


def _ptb_sgd(model):
    import paddle_tpu_torch as paddle
    return paddle.optimizer.SGD(
        learning_rate=PTB_MEDIUM["lr"], parameters=model.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(PTB_MEDIUM["clip"]))


def phase_lstm_check():
    """[lstm-check]: the PTB model at dropout 0 on the card and on the CPU
    from the same weights, batch LSTM_CHECK_BATCH x 35, fp32 (TF32 off):
    the first step's loss and every leaf's gradient within
    SURFACE_REL_LIMIT, then the losses of two more SGD steps (clipped)."""
    cpu, card = _ptb_lm("cpu", 0.0), _ptb_lm("gpu", 0.0)
    oc, og = _ptb_sgd(cpu), _ptb_sgd(card)
    xc, yc = _ptb_batch(LSTM_CHECK_BATCH, 21, "cpu")
    xg, yg = _ptb_batch(LSTM_CHECK_BATCH, 21, "gpu")
    losses, rels = [], {}
    for i in range(3):
        lc, lg = cpu(xc, yc), card(xg, yg)
        lc.backward()
        lg.backward()
        losses.append((float(lg), float(lc)))
        if i == 0:
            rels = {n: rel_err(p.grad.cpu(), q.grad) for (n, p), (_, q) in
                    zip(card.named_parameters(), cpu.named_parameters())}
        oc.step()
        og.step()
        oc.clear_grad()
        og.clear_grad()
    loss_rel = max(abs(a - b) / abs(b) for a, b in losses)
    worst = max(rels, key=rels.get)
    log(f"[lstm-check] PTB medium, dropout 0, fp32, [{LSTM_CHECK_BATCH}, "
        f"{PTB_MEDIUM['unroll']}]: losses card/cpu "
        f"{[(round(a, 6), round(b, 6)) for a, b in losses]} (worst rel "
        f"{loss_rel:.3g}); worst first-step leaf gradient rel "
        f"{rels[worst]:.3g} ({worst}) of {len(rels)}; limit "
        f"{SURFACE_REL_LIMIT}")
    if not (loss_rel < SURFACE_REL_LIMIT
            and rels[worst] < SURFACE_REL_LIMIT):
        raise AssertionError("[lstm-check] the card disagrees with the CPU")


def _cudnn_yardstick(lstm):
    """The port's 2-layer LSTM forward and backward (its Python time loop)
    against ``torch.nn.LSTM`` (cuDNN) on the same weights at [20, 35, 650]:
    the outputs' relative error and each one's ms (CUDA events). A
    yardstick only: cuDNN is not the port's route."""
    b, t, h = PTB_MEDIUM["batch"], PTB_MEDIUM["unroll"], PTB_MEDIUM["hidden"]
    ref = torch.nn.LSTM(h, h, num_layers=PTB_MEDIUM["layers"],
                        batch_first=True).cuda()
    with torch.no_grad():
        for name, p in ref.named_parameters():
            p.copy_(getattr(lstm, name))
    gen = torch.Generator()
    gen.manual_seed(23)
    x = torch.randn(b, t, h, generator=gen).cuda().requires_grad_()
    ct = torch.randn(b, t, h, generator=gen).cuda()
    ours = [p for p in lstm.parameters()]
    theirs = list(ref.parameters())

    def port():
        out = lstm(x)[0].as_subclass(torch.Tensor)
        return out, torch.autograd.grad(out, [x] + ours, ct)

    def cudnn():
        out = ref(x)[0]
        return out, torch.autograd.grad(out, [x] + theirs, ct)
    (o1, g1), (o2, g2) = port(), cudnn()
    err = max(rel_err(o1, o2), *(rel_err(a, b) for a, b in zip(g1, g2)))
    return err, cuda_time_ms(port, iters=10), cuda_time_ms(cudnn, iters=10)


def phase_lstm_lm(smi):
    """[lstm-lm]: the PTB medium model as an eager Paddle loop (``loss =
    model(x, y); loss.backward(); opt.step(); opt.clear_grad()``) on one
    seeded batch of 20 x 35: a warm-up step, LSTM_TRAIN["windows"]
    windows of LSTM_TRAIN["steps"] steps (each step launching
    LSTM_STEP_LAUNCHES), peak memory, the busy share over profiled steps,
    and the cuDNN yardstick. Returns the timings for [lstm-graph]."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.kernels import launch_counts
    paddle.seed(11)
    model = _ptb_lm("gpu")
    opt = _ptb_sgd(model)
    x, y = _ptb_batch(PTB_MEDIUM["batch"], 22, "gpu")
    n_params = sum(p.numel() for p in model.parameters())
    before = launch_counts()
    first = float(_api_eager_step(model, opt, (x, y)))
    _expect_launches("[lstm-lm] warm-up", _grew(before, launch_counts()),
                     **LSTM_STEP_LAUNCHES)
    want0 = math.log(PTB_MEDIUM["vocab"])
    if not abs(first - want0) < LOSS0_SLACK:
        raise AssertionError(f"[lstm-lm] first loss {first:.4f} is not near "
                             f"ln(vocab) = {want0:.4f}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = launch_counts()
    ms, losses = _windows(lambda: _api_eager_step(model, opt, (x, y)),
                          LSTM_TRAIN["windows"], LSTM_TRAIN["steps"])
    n = LSTM_TRAIN["windows"] * LSTM_TRAIN["steps"]
    _expect_launches("[lstm-lm] timed windows",
                     _grew(before, launch_counts()),
                     **{k: v * n for k, v in LSTM_STEP_LAUNCHES.items()})
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < first):
        raise AssertionError(f"[lstm-lm] losses {first} then {losses}")
    wall, busy = _profiled_busy(lambda: _api_eager_step(model, opt, (x, y)),
                                LSTM_TRAIN["profiled"])
    err, port_ms, cudnn_ms = _cudnn_yardstick(model.lstm)
    mean = sum(ms) / len(ms)
    tokens = PTB_MEDIUM["batch"] * PTB_MEDIUM["unroll"]
    log(f"[lstm-lm] ({smi}) PTB medium {n_params / 1e6:.2f} M params fp32, "
        f"dropout 0.5, SGD 1.0, clip 5, [{PTB_MEDIUM['batch']}, "
        f"{PTB_MEDIUM['unroll']}]: eager {mean:.2f} ms a step "
        f"(windows {min(ms):.2f}-{max(ms):.2f}), {tokens / mean * 1e3:.0f} "
        f"tokens/s, peak {peak:.2f} GB, busy "
        f"{busy if busy is None else round(busy, 3)} "
        f"({wall / LSTM_TRAIN['profiled']:.2f} ms a profiled step); losses {round(first, 4)} then "
        f"{[round(v, 4) for v in losses]} (ln vocab {want0:.4f}); row 8 "
        f"{LSTM_STEP_LAUNCHES['dropout_fwd']} launches a step")
    log(f"[lstm-lm] yardstick: the port's LSTM forward+backward at "
        f"[{PTB_MEDIUM['batch']}, {PTB_MEDIUM['unroll']}, "
        f"{PTB_MEDIUM['hidden']}] {port_ms:.3f} ms, torch.nn.LSTM (cuDNN) "
        f"{cudnn_ms:.3f} ms on "
        f"the same weights (outputs and gradients within {err:.3g})")
    if not err < SURFACE_REL_LIMIT:
        raise AssertionError("[lstm-lm] the port's LSTM departs from "
                             "torch.nn.LSTM's math")
    del model, opt
    return dict(ms=mean, min=min(ms), max=max(ms), peak=peak, busy=busy,
                port_ms=port_ms, cudnn_ms=cudnn_ms)


def phase_lstm_graph(smi, eager):
    """[lstm-graph]: the PTB model under ``TrainStep`` captured against
    ``TrainStep(fast_path=False)`` from one seed and chain state: 3 steps
    each, losses, every parameter and the step count bit for bit, both
    launching LSTM_STEP_LAUNCHES a step; then timed windows of captured
    steps and their busy share."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import launch_counts
    x, y = _ptb_batch(PTB_MEDIUM["batch"], 22, "gpu")
    res = {}
    for fast in (False, True):
        model = _ptb_lm("gpu")
        opt = _ptb_sgd(model)
        step = TrainStep(model, opt, fast_path=fast)
        paddle.seed(12)
        losses = []
        for i in range(3):
            before = launch_counts()
            losses.append(step(x, y))
            torch.cuda.synchronize()
            _expect_launches(f"[lstm-graph] fast_path={fast} step {i}",
                             _grew(before, launch_counts()),
                             **LSTM_STEP_LAUNCHES)
        res[fast] = (torch.stack([v.detach().as_subclass(torch.Tensor)
                                  for v in losses]),
                     _train_state(model, opt))
        if fast:
            _graph_of(step)
            torch.cuda.reset_peak_memory_stats()
            ms, tail = _windows(lambda: step(x, y), LSTM_TRAIN["windows"],
                                LSTM_TRAIN["steps"])
            peak = torch.cuda.max_memory_allocated() / 1e9
            wall, busy = _profiled_busy(lambda: step(x, y),
                                        LSTM_TRAIN["profiled"])
            compiles = step.num_compiles
        del model, opt, step
    (le, se), (lg, sg) = res[False], res[True]
    if not _bit_equal(lg, le):
        raise AssertionError(f"[lstm-graph] losses {lg} vs {le}")
    _hold_bits("[lstm-graph]", "3 captured PTB steps against eager "
               "TrainStep", sg, se)
    if compiles != 1 or not all(math.isfinite(v) for v in tail):
        raise AssertionError(f"[lstm-graph] num_compiles {compiles}, losses "
                             f"{tail}")
    mean = sum(ms) / len(ms)
    tokens = PTB_MEDIUM["batch"] * PTB_MEDIUM["unroll"]
    log(f"[lstm-graph] ({smi}) captured {mean:.2f} ms a step (windows "
        f"{min(ms):.2f}-{max(ms):.2f}), {tokens / mean * 1e3:.0f} tokens/s, "
        f"peak {peak:.2f} GB, busy {busy if busy is None else round(busy, 3)}"
        f"; the eager loop [lstm-lm] {eager['ms']:.2f} ms (captured / eager "
        f"{mean / eager['ms']:.4f}); num_compiles {compiles}")


def _lamb(model, lr=BERT_LAMB["lr"]):
    """Lamb on ``model`` with LayerNorm weights and biases exempt from
    the decay (``exclude_from_weight_decay_fn`` is called with the
    parameter)."""
    from paddle_tpu_torch.optimizer import Lamb
    exempt = {id(p) for n, p in model.named_parameters()
              if "norm" in n or n.endswith("bias")}
    return Lamb(learning_rate=lr, lamb_weight_decay=BERT_LAMB["wd"],
                parameters=model.parameters(),
                exclude_from_weight_decay_fn=lambda p: id(p) in exempt)


def phase_bert_lamb_check():
    """[bert-lamb-check]: BERT-base width cut to 2 layers, fp32, [2, 128],
    dropout 0.1, on the card and on the CPU from the same weights and
    generator state: the loss and every leaf's gradient within
    SURFACE_REL_LIMIT; then, the CPU's gradients given to both, two Lamb
    updates: every parameter's update within SURFACE_REL_LIMIT."""
    from paddle_tpu_torch.kernels import launch_counts
    from paddle_tpu_torch.models import BertConfig, BertForPreTraining
    cfg = BertConfig(**dict(BERT_BASE, num_layers=2))
    cpu = BertForPreTraining(cfg, device="cpu", seed=7)
    card = BertForPreTraining(cfg, device="cuda", seed=7)
    card.load_state_dict(cpu.state_dict())
    batch = _bert_batch(2, 128, 35, device="cpu")
    oc, og = _lamb(cpu), _lamb(card)
    before = launch_counts()
    loss_card = card(*(t.cuda() if t is not None else None for t in batch))
    loss_card = loss_card[-1] if isinstance(loss_card, tuple) else loss_card
    loss_card.backward()
    torch.cuda.synchronize()
    grew = {k: n for k, n in _grew(before, launch_counts()).items() if n}
    loss_cpu = cpu(*batch)
    loss_cpu = loss_cpu[-1] if isinstance(loss_cpu, tuple) else loss_cpu
    loss_cpu.backward()
    loss_rel = abs(loss_card.item() - loss_cpu.item()) / abs(loss_cpu.item())
    grads = {n: rel_err(p.grad.cpu(), q.grad) for (n, p), (_, q) in
             zip(card.named_parameters(), cpu.named_parameters())
             if q.grad is not None}
    upd = {}
    for _ in range(2):
        with torch.no_grad():
            for p, q in zip(card.parameters(), cpu.parameters()):
                if q.grad is not None:
                    p.grad.copy_(q.grad)
        was = [(p.detach().clone(), q.detach().clone()) for p, q in
               zip(card.parameters(), cpu.parameters())]
        og.step()
        oc.step()
        for (n, p), q, (p0, q0) in zip(card.named_parameters(),
                                       cpu.parameters(), was):
            upd[n] = max(upd.get(n, 0.0),
                         rel_err((p.detach() - p0).cpu(), q.detach() - q0))
    gw, uw = max(grads, key=grads.get), max(upd, key=upd.get)
    log(f"[bert-lamb-check] fp32, 2 layers, [2, 128], dropout 0.1: loss "
        f"card {loss_card.item():.6f} vs cpu {loss_cpu.item():.6f} (rel "
        f"{loss_rel:.3g}); worst leaf gradient rel {grads[gw]:.3g} ({gw}); "
        f"worst Lamb update rel {upd[uw]:.3g} ({uw}) over 2 updates of "
        f"{len(upd)} leaves; limit {SURFACE_REL_LIMIT}; launches {grew}")
    if not (loss_rel < SURFACE_REL_LIMIT and grads[gw] < SURFACE_REL_LIMIT
            and upd[uw] < SURFACE_REL_LIMIT):
        raise AssertionError("[bert-lamb-check] the card disagrees with the "
                             "CPU")
    if not grew.get("flash_pair_fwd"):
        raise AssertionError(f"[bert-lamb-check] no flash launch: {grew}")


def phase_bert_lamb(smi):
    """[bert-lamb]: BERT-base bf16 at 64 x 512, dropout 0.1, seed 0, with
    ``_lamb`` in place of [bert-train]'s AdamW (the bf16 weights update
    through their fp32 masters), eager (``TrainStep(fast_path=False)``)
    and captured from the same seed: 3 steps each launching exactly
    BERT_STEP_LAUNCHES (rows 1, 2, 7, 8 and the dq sum), losses, every
    parameter, master and moment, the step count and the model generator
    bit for bit; the share of the masters' and of the bf16 weights'
    elements each eager step changed (every master must move); then
    BERT_LAMB["timed"] more steps of each, timed, beside [bert-train]'s
    AdamW step where that phase ran in this process."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import launch_counts
    from paddle_tpu_torch.models import BertConfig, BertForPreTraining
    runs = {}
    for fast in (False, True):
        model = BertForPreTraining(BertConfig(**BERT_BASE), dtype=BF16,
                                   seed=0)
        opt = _lamb(model)
        step = TrainStep(model, opt, fast_path=fast)
        batch = _bert_batch(BERT_TRAIN["batch"], BERT_TRAIN["seq"], 31)
        n_el = sum(p.numel() for p in model.parameters())
        losses, grew, moved = [], [], []
        for _ in range(BERT_LAMB["steps"]):
            # a master is made from its weight at the first step
            was = None if fast else [
                (p.detach().clone(),
                 opt._master_weights.get(id(p), p.detach()).float().clone())
                for p in model.parameters()]
            before = launch_counts()
            losses.append(step(*batch))
            torch.cuda.synchronize()
            grew.append(_grew(before, launch_counts()))
            if was is not None:
                moved.append(tuple(sum(int((t != w[k]).sum()) for t, w in
                                       zip(now, was)) / n_el for k, now in
                                   enumerate((list(model.parameters()),
                                              [opt._master_weights[id(p)]
                                               for p in model.parameters()]
                                              ))))
            del was
        state = _train_state(model, opt)
        state["generator"] = model.generator.get_state()
        walls = []
        for _ in range(BERT_LAMB["timed"]):
            t0 = time.perf_counter()
            losses.append(step(*batch))
            float(losses[-1])
            walls.append(time.perf_counter() - t0)
        if fast:
            _graph_of(step)
        runs[fast] = (torch.stack([v.detach().as_subclass(torch.Tensor)
                                   for v in losses]), state, grew, walls,
                      moved)
        del model, opt, step, state
        _release(f"after [bert-lamb] fast_path={fast}")
    (le, se, ge, we, moved), (lg, sg, gg, wg, _) = runs[False], runs[True]
    n = BERT_LAMB["steps"]
    if gg != ge or ge[0] != dict(ge[0], **BERT_STEP_LAUNCHES):
        raise AssertionError(f"[bert-lamb] launches {gg}, eager {ge}")
    if not _bit_equal(lg[:n], le[:n]):
        raise AssertionError(f"[bert-lamb] losses {lg[:n]} vs {le[:n]}")
    _hold_bits("[bert-lamb]", f"BERT-base 64 x 512, Lamb, {n} captured "
               f"steps against eager", sg, se)
    losses = le.tolist()
    if not all(math.isfinite(v) for v in losses + lg.tolist()):
        raise AssertionError(f"[bert-lamb] losses {losses}, {lg.tolist()}")
    want0 = math.log(BERT_BASE["vocab_size"]) + math.log(2.0)
    if not abs(losses[0] - want0) < LOSS0_SLACK:
        raise AssertionError(f"[bert-lamb] first loss {losses[0]:.4f}")
    tokens = BERT_TRAIN["batch"] * BERT_TRAIN["seq"]
    me, mg = (sum(w) / len(w) * 1e3 for w in (we, wg))
    adamw = (f"{sum(BERT_TRAIN_WALLS) / len(BERT_TRAIN_WALLS) * 1e3:.1f} ms"
             if BERT_TRAIN_WALLS else "not run in this process")
    log(f"[bert-lamb] ({smi}) losses eager {[round(v, 4) for v in losses]}, "
        f"captured {[round(v, 4) for v in lg.tolist()]} (ln vocab + ln 2 = "
        f"{want0:.4f}); share each eager step changed of the fp32 masters "
        f"{[round(m, 4) for _, m in moved]} and of the bf16 weights "
        f"{[round(w, 4) for w, _ in moved]} (lr {BERT_LAMB['lr']})")
    log(f"[bert-lamb] eager {me:.1f} ms a step (min {min(we) * 1e3:.1f}, max "
        f"{max(we) * 1e3:.1f}), captured {mg:.1f} ms (min "
        f"{min(wg) * 1e3:.1f}, max {max(wg) * 1e3:.1f}), {tokens / mg * 1e3:.0f}"
        f" tokens/s captured; [bert-train]'s eager AdamW step {adamw}; "
        f"launches a step {ge[0]}")


def _twin(build):
    """``build()`` on the CPU, then on the card with the CPU one's state."""
    import paddle_tpu_torch as paddle
    paddle.set_device("cpu")
    cpu = build()
    paddle.set_device("gpu")
    card = build()
    card.set_state_dict(cpu.state_dict())
    return {"cpu": cpu, "cuda": card}


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _flat(o)]
    return [out]


def _surface_pair(tag, make, inputs, grad=(0,)):
    """``make(device)`` returns ``(fn, params)``; ``fn`` on the same numpy
    ``inputs`` on the CPU and on the card: every output within
    SURFACE_REL_LIMIT (integer outputs exactly), and the gradient of a
    seeded projection of the first output with respect to ``inputs[k]``
    for k in ``grad`` and to ``params``. Returns the worst error."""
    got = {}
    for dev in ("cpu", "cuda"):
        fn, params = make(dev)
        ts = [torch.from_numpy(a).to(dev).requires_grad_(
            k in grad and a.dtype.kind == "f")
            if isinstance(a, np.ndarray) else a
            for k, a in enumerate(inputs)]
        outs = _flat(fn(*ts))
        wrt = [ts[k] for k in grad] + list(params)
        grads = []
        if wrt:
            gen = torch.Generator()
            gen.manual_seed(99)
            ct = torch.randn(tuple(outs[0].shape), generator=gen,
                             dtype=torch.float32).to(dev, outs[0].dtype)
            grads = torch.autograd.grad((outs[0] * ct).sum(), wrt)
        got[dev] = ([o.detach().cpu() for o in outs],
                    [g.detach().cpu() for g in grads])
    worst = 0.0
    for a, b in zip(got["cuda"][0] + got["cuda"][1],
                    got["cpu"][0] + got["cpu"][1]):
        if not a.is_floating_point():
            if not torch.equal(a, b):
                raise AssertionError(f"[surface-check] {tag}: integer "
                                     f"outputs differ")
            continue
        worst = max(worst, rel_err(a, b))
    if not worst < SURFACE_REL_LIMIT:
        raise AssertionError(f"[surface-check] {tag}: card vs CPU {worst:.3g}")
    return worst


def _surface_cases():
    """(tag, make, inputs, grad) for [surface-check]."""
    import paddle_tpu_torch as paddle
    nn, F = paddle.nn, paddle.nn.functional
    rs = np.random.RandomState(30)

    def r(*shape, lo=None, hi=None):
        if lo is not None:
            return rs.uniform(lo, hi, shape).astype(np.float32)
        return rs.standard_normal(shape).astype(np.float32)

    def fn(f, **kw):
        return lambda dev: ((lambda *a: f(*a, **kw)), [])

    cases = []
    for mode, shape, sizes in (
            ("nearest", (2, 3, 16, 20), ((24, 30), (7, 9))),
            ("bilinear", (2, 3, 16, 20), ((24, 30), (7, 9))),
            ("bicubic", (2, 3, 16, 20), ((24, 30), (7, 9))),
            ("area", (2, 3, 16, 20), ((24, 30), (7, 9))),
            ("linear", (2, 3, 20), ((31,), (9,))),
            ("trilinear", (1, 2, 6, 8, 10), ((9, 12, 15), (3, 5, 4)))):
        x = r(*shape)
        for size, how in zip(sizes, ("grow", "shrink")):
            cases.append((f"interpolate {mode} {how}",
                          fn(F.interpolate, size=size, mode=mode), [x],
                          (0,)))
    cases.append(("unfold", fn(F.unfold, kernel_sizes=3, strides=2,
                                paddings=1), [r(2, 3, 16, 16)], (0,)))
    cases.append(("fold", fn(F.fold, output_sizes=[16, 16], kernel_sizes=3,
                              strides=2, paddings=1), [r(2, 27, 64)], (0,)))
    cases.append(("affine_grid + grid_sample",
                  lambda dev: ((lambda th, x: F.grid_sample(
                      x, F.affine_grid(th, [2, 3, 12, 14]))), []),
                  [r(2, 2, 3, lo=-1.0, hi=1.0), r(2, 3, 16, 16)], (0, 1)))
    grid = r(2, 12, 14, 2, lo=-1.3, hi=1.3)
    for mode, pad in (("bilinear", "zeros"), ("bilinear", "border"),
                      ("bilinear", "reflection"), ("nearest", "zeros")):
        cases.append((f"grid_sample {mode} {pad}",
                      fn(F.grid_sample, mode=mode, padding_mode=pad,
                         align_corners=False),
                      [r(2, 3, 16, 16), grid],
                      (0, 1) if mode == "bilinear" else (0,)))
    for nd, spatial in ((1, (12,)), (2, (6, 5)), (3, (3, 4, 2))):
        n_in, n_out = int(np.prod(spatial)), int(np.prod(spatial)) * 2 ** nd
        idx = np.stack([np.stack([np.sort(rs.permutation(n_out)[:n_in])
                                  for _ in range(3)]) for _ in range(2)])
        cases.append((f"max_unpool{nd}d",
                      fn(getattr(F, f"max_unpool{nd}d"), kernel_size=2),
                      [r(2, 3, *spatial), idx.reshape(2, 3, *spatial)],
                      (0,)))
    labels = rs.randint(1, 20, (4, 10)).astype(np.int64)
    cases.append(("ctc_loss", fn(F.ctc_loss, reduction="none"),
                  [r(50, 4, 20), labels, np.array([50, 45, 40, 30]),
                   np.array([10, 9, 7, 5])], (0,)))
    cases.append(("rnnt_loss", fn(F.rnnt_loss, reduction="none"),
                  [r(2, 20, 9, 16), rs.randint(1, 16, (2, 8)),
                   np.array([20, 15]), np.array([8, 6])], (0,)))
    # a block pattern of 40% of the (row, column) pairs and the diagonal,
    # as CSR rows padded to the longest head's count (its mask is built
    # on the device)
    keep = rs.random_sample((2, 4, 64, 64)) < 0.4
    keep[..., np.arange(64), np.arange(64)] = True
    off = np.zeros((2, 4, 65), np.int64)
    off[..., 1:] = np.cumsum(keep.sum(-1), -1)
    cols = np.zeros((2, 4, int(off.max())), np.int64)
    for b, h in np.ndindex(2, 4):
        listed = np.nonzero(keep[b, h])[1]
        cols[b, h, :len(listed)] = listed
    cases.append(("sparse_attention", fn(F.sparse_attention),
                  [r(2, 4, 64, 32), r(2, 4, 64, 32), r(2, 4, 64, 32), off,
                   cols], (0, 1, 2)))
    for tag, build in (
            ("GRU 2 layers", lambda: nn.GRU(16, 32, num_layers=2)),
            ("SimpleRNN bidirectional",
             lambda: nn.SimpleRNN(16, 32, direction="bidirect")),
            ("BiRNN(GRUCell, LSTMCell)",
             lambda: nn.BiRNN(nn.GRUCell(16, 32), nn.LSTMCell(16, 32)))):
        layers = _twin(build)
        cases.append((tag, lambda dev, m=layers: (m[dev], m[dev].parameters()),
                      [r(4, 20, 16)], (0,)))
    sn = _twin(lambda: nn.SpectralNorm((16, 8, 3), dim=1, power_iters=2))
    cases.append(("SpectralNorm", lambda dev: (sn[dev], []),
                  [r(16, 8, 3)], (0,)))
    return cases


def _surface_decode():
    """dynamic_decode over a GRU cell with an embedding and a head, the
    same weights on both devices: ids exactly, scores within the limit."""
    import paddle_tpu_torch as paddle
    nn = paddle.nn
    parts = _twin(lambda: nn.LayerList([nn.GRUCell(8, 16),
                                         nn.Embedding(12, 8),
                                         nn.Linear(16, 12)]))
    init = np.random.RandomState(31).standard_normal((3, 16)).astype(
        np.float32)
    out = {}
    for dev, (cell, emb, head) in parts.items():
        dec = nn.BeamSearchDecoder(cell, start_token=0, end_token=1,
                                   beam_size=4, embedding_fn=emb,
                                   output_fn=head)
        ids, scores = nn.dynamic_decode(
            dec, inits=torch.from_numpy(init).to(dev), max_step_num=8)
        out[dev] = (ids.cpu(), scores.cpu())
    if not torch.equal(out["cuda"][0], out["cpu"][0]):
        raise AssertionError("[surface-check] dynamic_decode ids differ")
    return rel_err(out["cuda"][1], out["cpu"][1])


def _rule_net(seed):
    """Linear(64, 32) (its weight at rate scale 0.5, F14), Tanh,
    Linear(32, 8), and the MSE against ``y``: ``forward(x, y)``."""
    import paddle_tpu_torch as paddle
    nn = paddle.nn

    class RuleNet(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(64, 32, weight_attr=paddle.ParamAttr(
                learning_rate=0.5))
            self.fc2 = nn.Linear(32, 8)

        def forward(self, x, y):
            return ((self.fc2(paddle.tanh(self.fc1(x))) - y) ** 2).mean()
    paddle.seed(seed)
    return RuleNet()


def _surface_rule(name, kw):
    """One rule: 3 eager steps on the card against the CPU (each
    parameter's displacement within SURFACE_REL_LIMIT), then 3 steps
    captured against 3 eager ``TrainStep`` steps on the card, bit for
    bit. Returns the worst displacement error."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.jit import TrainStep
    rs = np.random.RandomState(32)
    x_np = rs.standard_normal((16, 64)).astype(np.float32)
    y_np = rs.standard_normal((16, 8)).astype(np.float32)
    nets = _twin(lambda: _rule_net(5))
    start = {d: [p.detach().cpu().clone() for p in m.parameters()]
             for d, m in nets.items()}
    for dev, net in nets.items():
        opt = getattr(paddle.optimizer, name)(parameters=net.parameters(),
                                              **kw)
        x, y = (torch.from_numpy(a).to(dev) for a in (x_np, y_np))
        for _ in range(3):
            _api_eager_step(net, opt, (x, y))
    worst = max(rel_err(p.detach().cpu() - p0, q.detach() - q0)
                for p, q, p0, q0 in zip(nets["cuda"].parameters(),
                                        nets["cpu"].parameters(),
                                        start["cuda"], start["cpu"]))
    if not worst < SURFACE_REL_LIMIT:
        raise AssertionError(f"[surface-check] {name}: card vs CPU {worst}")
    x, y = (torch.from_numpy(a).cuda() for a in (x_np, y_np))
    states = {}
    for fast in (False, True):
        net = _rule_net(5)
        opt = getattr(paddle.optimizer, name)(parameters=net.parameters(),
                                              **kw)
        step = TrainStep(net, opt, fast_path=fast)
        losses = torch.stack([step(x, y).detach().as_subclass(torch.Tensor)
                              for _ in range(3)])
        if fast:
            _graph_of(step)
        states[fast] = dict(_train_state(net, opt), losses=losses)
    _hold_bits(f"[surface-check] {name}", "3 captured steps against eager",
               states[True], states[False])
    return worst


def phase_surface_check(smi):
    """[surface-check]: every new functional and layer (every
    ``interpolate`` mode growing and shrinking, ``unfold`` / ``fold``,
    ``affine_grid`` / ``grid_sample``, the unpools, ``ctc_loss``,
    ``rnnt_loss``, ``sparse_attention``, ``GRU``, a bidirectional
    ``SimpleRNN``, ``BiRNN`` over cells, ``SpectralNorm``,
    ``dynamic_decode``) on the card against the
    CPU in fp32, forward and gradient, within SURFACE_REL_LIMIT; then the
    six rules of SURFACE_RULES (``_surface_rule``: F14's scaled weight
    among the parameters)."""
    t0 = time.perf_counter()
    worst = {tag: _surface_pair(tag, make, inputs, grad)
             for tag, make, inputs, grad in _surface_cases()}
    worst["dynamic_decode (scores)"] = _surface_decode()
    if not worst["dynamic_decode (scores)"] < SURFACE_REL_LIMIT:
        raise AssertionError("[surface-check] dynamic_decode scores differ")
    rules = {name: _surface_rule(name, kw) for name, kw in SURFACE_RULES}
    tag = max(worst, key=worst.get)
    log(f"[surface-check] ({smi}) {len(worst)} functionals and layers on the "
        f"card against the CPU, fp32, forward and gradient: worst "
        f"{worst[tag]:.3g} ({tag}); six rules, 3 steps card against CPU: "
        f"{ {k: float(f'{v:.3g}') for k, v in rules.items()} }, each captured "
        f"bit for bit its eager steps; limit {SURFACE_REL_LIMIT}; "
        f"{time.perf_counter() - t0:.1f} s")


def surface_phases(smi):
    """The slice-22 phases, each with the launch counts set to 0 before it
    and read after: the PTB LSTM model (row 8 from its two dropouts),
    BERT-base under Lamb (rows 1, 2, 7, 8 and the dq sum) and the surface
    checks (no hand kernel). Returns (paths, checks): each model path's
    counts and the check phases'."""
    from paddle_tpu_torch.kernels import reset_launch_counts
    paths, checks = {}, {}

    def run(tag, fn, *args, into=paths, kernels=True):
        reset_launch_counts()
        out = fn(*args)
        counts = _path_counts()
        ran = {k: n for k, n in counts.items() if n}
        if ran and not kernels:
            raise AssertionError(f"[{tag}] launched hand kernels: {ran}")
        into[tag] = counts
        return out

    t0 = time.perf_counter()
    run("lstm-check", phase_lstm_check, into=checks, kernels=False)
    eager = run("lstm-lm", phase_lstm_lm, smi)
    run("lstm-lm-graph", phase_lstm_graph, smi, eager)
    _release("after [lstm-lm] and [lstm-graph]")
    run("bert-lamb-check", phase_bert_lamb_check, into=checks)
    _release("after [bert-lamb-check]")
    run("bert-lamb", phase_bert_lamb, smi)
    _release("after [bert-lamb]")
    run("surface-check", phase_surface_check, smi, into=checks,
        kernels=False)
    _release("after [surface-check]")
    log(f"[surface] the slice-22 phases passed in "
        f"{time.perf_counter() - t0:.1f} s; launches "
        f"{ {k: {n: c for n, c in v.items() if c} for k, v in paths.items()} }")
    return paths, checks


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "GPU", file=sys.stderr)
        return 2
    try:
        from paddle_tpu_torch.kernels import (launch_counts,
                                              reset_launch_counts)
        from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                             LlamaForCausalLM, llama_7b)
    except ModuleNotFoundError as e:
        # the script alone, outside a checkout: nothing to build or drive
        print(f"chip_smoke: the port is not beside this script ({e}); run "
              f"it from the root of a checkout of the repository",
              file=sys.stderr)
        return 3

    # fp32 products in full fp32 on the card: the plain versions and the
    # train-checks compare fp32 with fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    name, count, smi = phase_card()
    log("[card] TF32 off (torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False)")
    parent = phase_build()
    noise = _timing_noise() if parent is not None else 0.0
    parent_fwd = phase_parent_fwd(parent, noise)
    parent_bwd = phase_parent_bwd(parent, noise)
    records = {"flash_pair_fwd": phase_compare(),
               "flash_pair_bwd": phase_compare_bwd()}
    phase_autograd()
    phase_compare_fa()
    sw32_record = phase_compare_fa_bwd()
    sw32_record["parent_ms"] = parent_bwd["wmma-80"][1]
    records["dropout_fwd"] = phase_compare_dropout()
    (records["fused_add_dropout_ln_fwd"],
     records["fused_add_dropout_ln_bwd"]) = phase_compare_fused_ln()
    phase_compare_dropout_attn()
    (records["flash_attention_fwd"],
     records["flash_attention_bwd"]) = phase_compare_fa_masks()
    phase_fa_mask_probe()
    phase_seed_device()
    row6, row6_records = phase_compare_fa_packed()   # row 6's own call
    wide_records = phase_compare_wide()
    phase_wide_route()
    f32_records = phase_fp32_bodies(parent, parent_fwd, parent_bwd)
    phase_plain_times()
    records["dq_ordered_sum"] = phase_bwd_order()
    # the forward records beside the parent's time at their shapes
    for record, tag in ((records["flash_pair_fwd"], "gpt-scoring"),
                        (records["flash_attention_fwd"], "bert-padded"),
                        (row6_records[0], "row6"),
                        (wide_records[0], "wide-512")):
        record["parent_ms"] = parent_fwd[tag][1]
    # ... and the backward records beside the parent's at theirs
    for record, tag in ((records["flash_pair_bwd"], "gpt-train"),
                        (records["flash_attention_bwd"], "bert-padded"),
                        (row6_records[1], "row6"),
                        (wide_records[1], "wide-512")):
        record["parent_ms"] = parent_bwd[tag][1]

    counts = _path_counts
    checks = {}        # the fp32 phases' launches (card-vs-CPU, engine)

    def counted(tag, phase):
        reset_launch_counts()
        phase()
        checks[tag] = counts()
    paths = {}
    t0 = time.perf_counter()
    model = GPTForCausalLM(GPTConfig(**GPT_MEDIUM), dtype=torch.bfloat16,
                           seed=0).eval()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[model] GPT-medium {n_params / 1e6:.1f} M params, bf16, built in "
        f"{time.perf_counter() - t0:.1f} s")

    reset_launch_counts()                  # GPT serving starts here
    ids = phase_scoring(model)
    reqs, eager = phase_engine(model)
    paths["gpt-serving"] = counts()     # ... and ends here
    phase_crosscheck(model, reqs)
    # GPT serving's captured programs: the engine graphed, bucketed and
    # sampling, and generate(); no flash kernel lies on these paths
    reset_launch_counts()
    graph_reqs, graph = phase_engine_graph(model, reqs, eager)
    bucket_reqs = phase_engine_buckets(model)
    phase_engine_sample(model, reqs)
    gen_rows = phase_generate(model)
    paths["gpt-serving-graph"] = counts()
    # the monitored engine, on the bf16 model (the int8 phase of
    # gpt_other_modes swaps its Linear layers in place)
    reset_launch_counts()
    phase_monitor_engine(model, graph_reqs, graph)
    paths["gpt-serving-monitor"] = counts()
    phase_crosscheck(model, bucket_reqs, rows=len(bucket_reqs),
                     tag="[engine-buckets-crosscheck]")
    phase_crosscheck(model, gen_rows, rows=len(gen_rows),
                     tag="[generate-crosscheck]")
    phase_scoring_time(model, ids)
    phase_profile(model)
    phase_profile(model, graphed=True)
    spec_paths, draft_records = {}, {}
    gpt_other_modes(model, reqs, graph_reqs, graph, counts, paths,
                    spec_paths, draft_records)
    guard_ref = graph_reqs       # [engine-graph]'s tokens, for the last phases
    del model, reqs, bucket_reqs, gen_rows, graph_reqs
    _release("GPT serving freed")

    reset_launch_counts()                  # GPT training starts here
    train_model, opt, train_ids, losses = phase_train()
    paths["gpt-training"] = counts()    # ... and ends here
    phase_profile_train(train_model, opt, train_ids)
    del train_model, opt
    torch.cuda.empty_cache()
    phase_train_plain(losses)
    torch.cuda.empty_cache()
    counted("train-check", phase_train_check)
    torch.cuda.empty_cache()
    counted("gpt-dropout-check", phase_gpt_dropout_check)
    torch.cuda.empty_cache()
    # the training features: each path from 0 launches to its reading
    for path, phase in (("gpt-training-recompute", phase_train_recompute),
                        ("gpt-training-recompute-dropout",
                         phase_train_recompute_dropout),
                        ("gpt-training-accum", phase_train_accum),
                        ("gpt-training-amp", phase_train_amp),
                        ("gpt-training-amp-cast", phase_train_amp_cast)):
        reset_launch_counts()
        phase()
        paths[path] = counts()
        torch.cuda.empty_cache()
    # the monitor on the training path, then its health plane's tripwire
    reset_launch_counts()
    phase_monitor_train(smi)
    paths["gpt-training-monitor"] = counts()
    torch.cuda.empty_cache()
    reset_launch_counts()
    phase_monitor_health_fault()
    paths["gpt-training-monitor-fault"] = counts()
    torch.cuda.empty_cache()
    # checkpointing: a save, a resume and a preemption on the training path
    reset_launch_counts()
    straight, want = phase_ckpt_resume(smi)
    phase_ckpt_preempt(smi, straight, want)
    paths["gpt-training-ckpt"] = counts()
    del straight, want
    torch.cuda.empty_cache()
    # the captured train step: [train]'s recipe captured against eager,
    # timed in turns, with the monitor; the features; the compile counts
    reset_launch_counts()
    phase_train_graph(smi)
    paths["gpt-training-graph"] = counts()
    torch.cuda.empty_cache()
    reset_launch_counts()
    phase_train_graph_features()
    paths["gpt-training-graph-features"] = counts()
    reset_launch_counts()
    phase_train_graph_compiles(smi)
    paths["gpt-training-graph-compiles"] = counts()
    torch.cuda.empty_cache()

    reset_launch_counts()                  # BERT training starts here
    bert, opt, batch, losses = phase_bert_train(smi)
    paths["bert-training"] = counts()   # ... and ends here
    phase_profile_bert_train(bert, opt, batch, "[profile-bert-train]")
    reset_launch_counts()                  # BERT scoring starts here
    inputs = phase_bert_scoring(bert)
    paths["bert-scoring"] = counts()    # ... and ends here
    packed_ms = phase_bert_scoring_time(bert, inputs, "[bert-scoring]")
    del bert, opt, batch, inputs
    torch.cuda.empty_cache()
    phase_bert_train_plain(losses)
    torch.cuda.empty_cache()
    counted("bert-train-check", phase_bert_train_check)
    torch.cuda.empty_cache()

    reset_launch_counts()                  # BERT padded training starts here
    bert, opt, batch, losses = phase_bert_train(smi, padded=True)
    paths["bert-pad-training"] = counts()   # ... and ends here
    phase_profile_bert_train(bert, opt, batch, "[profile-bert-pad-train]")
    reset_launch_counts()                  # BERT padded scoring starts here
    inputs = phase_bert_scoring(bert, padded=True)
    paths["bert-pad-scoring"] = counts()    # ... and ends here
    phase_bert_scoring_time(bert, inputs, "[bert-pad-scoring]",
                            f" (packed [bert-scoring]: {packed_ms:.2f} ms)")
    del bert, opt, batch, inputs
    torch.cuda.empty_cache()
    phase_bert_train_plain(losses, padded=True)
    torch.cuda.empty_cache()
    counted("bert-pad-train-check", phase_bert_pad_train_check)
    torch.cuda.empty_cache()
    phase_bert_pad_full()
    torch.cuda.empty_cache()
    phase_type_order()
    reset_launch_counts()                  # BERT captured training
    phase_bert_train_graph(smi)
    paths["bert-training-graph"] = counts()
    torch.cuda.empty_cache()

    # the Paddle dygraph surface at BERT-base width: the card against the
    # CPU, the eager Paddle loop, the same model captured, the plain witness
    counted("api-check", phase_api_check)
    _release("before [api-train]")
    reset_launch_counts()                  # the Paddle eager loop
    api_losses, api_eager = phase_api_train(smi)
    paths["api-training"] = counts()
    _release("after [api-train]")
    reset_launch_counts()                  # the Paddle model captured
    phase_api_graph(smi, api_eager)
    paths["api-training-graph"] = counts()
    _release("after [api-graph]")
    phase_api_plain(api_losses)
    _release("after [api-plain]")

    # vision (slice 20): conv, pooling and the batch norms on the Paddle
    # surface, ResNet-50 at BASELINE config 1's geometry and at 224 x 224;
    # no hand kernel lies on these paths
    vision_paths, vision_rates = vision_phases(smi)
    paths.update(vision_paths)

    # hapi and io (slice 21): F12's card gate, Model.fit / evaluate /
    # predict on ResNet-50 eager and captured through the DeviceLoader,
    # AutoCheckpoint's preemption and resume, and accumulation on the
    # Paddle-API encoder (rows 4, 5 and 8)
    paths.update(hapi_phases(smi, vision_rates["train"]))

    # the rest of nn and the optimizers (slice 22): the PTB LSTM language
    # model (row 8), BERT-base under Lamb (rows 1, 2, 7, 8 and the dq sum)
    # and the new functionals, layers and rules on the card against the CPU
    surface_paths, surface_checks = surface_phases(smi)
    paths.update(surface_paths)
    checks.update(surface_checks)

    t0 = time.perf_counter()
    llama = LlamaForCausalLM(llama_7b(), dtype=torch.bfloat16, seed=0).eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in llama.parameters())
    log(f"[llama-model] LLaMA-7B {n_params / 1e9:.3f} B params, bf16, built "
        f"on the card in {time.perf_counter() - t0:.1f} s")
    reset_launch_counts()                  # LLaMA serving starts here
    ids = phase_llama_scoring(llama)
    reqs, eager = phase_llama_engine(llama, eager=True)
    paths["llama-serving"] = counts()   # ... and ends here
    phase_llama_crosscheck(llama, reqs)
    reset_launch_counts()                  # LLaMA's captured programs
    graph_reqs, graph = phase_engine_graph(llama, reqs, eager,
                                           requests=_llama_requests,
                                           tag="[llama-engine-graph]")
    gen_rows = phase_llama_generate(llama)
    paths["llama-serving-graph"] = counts()
    phase_llama_crosscheck(llama, gen_rows,
                           tag="[llama-generate-crosscheck]")
    phase_profile(llama, graphed=True, tag="[profile-llama-graph]")
    phase_llama_scoring_time(llama, ids)
    llama_other_modes(llama, graph_reqs, graph, counts, paths, spec_paths,
                      draft_records)
    del llama, reqs, ids, gen_rows, graph_reqs
    _release("LLaMA-7B serving freed")
    fp32 = {}

    def fp32_engine():
        fp32["model"], fp32["reqs"], fp32["ref"] = phase_llama_engine_fp32()
    counted("llama-engine-fp32", fp32_engine)
    checks["llama-engine-spec-fp32"] = llama_spec_fp32(
        fp32["model"], fp32["reqs"], fp32["ref"], counts)
    del fp32
    torch.cuda.empty_cache()

    reset_launch_counts()                  # LLaMA training starts here
    llama_model, opt, ids, losses = phase_llama_train()
    paths["llama-training"] = counts()  # ... and ends here
    phase_profile_llama_train(llama_model, opt, ids)
    del llama_model, opt, ids
    torch.cuda.empty_cache()
    phase_llama_train_plain(losses)
    torch.cuda.empty_cache()
    counted("llama-train-check", phase_llama_train_check)
    _release("before [llama-train-recompute]")
    reset_launch_counts()                  # LLaMA recompute starts here
    phase_llama_train_recompute()
    paths["llama-training-recompute"] = counts()   # ... and ends here
    _release("before [llama-train-graph]")
    reset_launch_counts()                  # LLaMA captured training
    phase_llama_train_graph(smi)
    paths["llama-training-graph"] = counts()

    # the serving guardrails and the fleet run last, on GPT-medium built
    # again from seed 0 (the same weights): every phase above runs in the
    # process state it ran in before these phases existed. No flash kernel
    # lies on these paths (graphed engines).
    _release("before the guardrail and fleet phases")
    model = GPTForCausalLM(GPTConfig(**GPT_MEDIUM), dtype=torch.bfloat16,
                           seed=0).eval()
    reset_launch_counts()
    phase_guard_chaos(model, guard_ref)
    phase_guard_hang(model, guard_ref, smi)
    phase_guard_drain(model, guard_ref)
    paths["gpt-serving-guard"] = counts()
    _release("after the guardrail phases")
    reset_launch_counts()
    phase_fleet_router(model, smi)
    phase_fleet_pool(model, smi)
    paths["gpt-serving-fleet"] = counts()
    del model, guard_ref
    _release("after [fleet-router] and [fleet-pool]")
    # two serving processes on the card behind this one's router
    # (the counts of the replica that served, read in its own process)
    paths["gpt-serving-http"] = phase_fleet_http(smi)

    # every kernel of a path ran on it
    needs = {"gpt-serving": ["flash_pair_fwd"],
             "gpt-training": ["flash_pair_fwd", "flash_pair_bwd"],
             "bert-training": ["flash_pair_fwd", "flash_pair_bwd",
                               "dropout_fwd", "fused_add_dropout_ln_fwd",
                               "fused_add_dropout_ln_bwd"],
             "bert-scoring": ["flash_pair_fwd", "fused_add_dropout_ln_fwd"],
             "bert-pad-training": ["flash_attention_fwd",
                                   "flash_attention_bwd", "dropout_fwd",
                                   "fused_add_dropout_ln_fwd",
                                   "fused_add_dropout_ln_bwd"],
             "bert-pad-scoring": ["flash_attention_fwd",
                                  "fused_add_dropout_ln_fwd"],
             "llama-serving": ["flash_attention_fwd"],
             "llama-training": ["flash_attention_fwd",
                                "flash_attention_bwd"],
             "gpt-training-recompute": ["flash_pair_fwd", "flash_pair_bwd"],
             "gpt-training-recompute-dropout": ["flash_pair_fwd",
                                                "flash_pair_bwd",
                                                "dropout_fwd"],
             "gpt-training-accum": ["flash_pair_fwd", "flash_pair_bwd"],
             "gpt-training-amp": ["flash_pair_fwd", "flash_pair_bwd"],
             "gpt-training-amp-cast": ["flash_pair_fwd", "flash_pair_bwd"],
             "gpt-training-monitor": ["flash_pair_fwd", "flash_pair_bwd"],
             "gpt-training-monitor-fault": ["flash_pair_fwd",
                                            "flash_pair_bwd"],
             "gpt-training-ckpt": ["flash_pair_fwd", "flash_pair_bwd"],
             "llama-training-recompute": ["flash_attention_fwd",
                                          "flash_attention_bwd"],
             "gpt-training-graph": ["flash_pair_fwd", "flash_pair_bwd"],
             "gpt-training-graph-features": ["flash_pair_fwd",
                                             "flash_pair_bwd",
                                             "dropout_fwd"],
             "gpt-training-graph-compiles": ["flash_pair_fwd",
                                             "flash_pair_bwd"],
             "bert-training-graph": ["flash_pair_fwd", "flash_pair_bwd",
                                     "dropout_fwd",
                                     "fused_add_dropout_ln_fwd",
                                     "fused_add_dropout_ln_bwd"],
             "llama-training-graph": ["flash_attention_fwd",
                                      "flash_attention_bwd"],
             "api-training": ["flash_attention_fwd", "flash_attention_bwd",
                              "dropout_fwd"],
             "api-training-graph": ["flash_attention_fwd",
                                    "flash_attention_bwd", "dropout_fwd"],
             "hapi-accum": ["flash_attention_fwd", "flash_attention_bwd",
                            "dropout_fwd"],
             "lstm-lm": ["dropout_fwd"],
             "lstm-lm-graph": ["dropout_fwd"],
             "bert-lamb": ["flash_pair_fwd", "flash_pair_bwd", "dropout_fwd",
                           "fused_add_dropout_ln_fwd",
                           "fused_add_dropout_ln_bwd"],
             "gpt-serving-spec-draft": ["flash_pair_fwd"],
             "gpt-serving-spec-early": ["flash_pair_fwd"],
             "llama-serving-spec": ["flash_attention_fwd"]}
    # every backward launches the ordered dq sum behind it
    for kernels in needs.values():
        if {"flash_pair_bwd", "flash_attention_bwd"} & set(kernels):
            kernels.append("dq_ordered_sum")
    every_path = dict(paths, **spec_paths)
    for path, kernels in needs.items():
        for kernel in kernels:
            if every_path[path][kernel] < 1:
                raise AssertionError(f"the {path} path never launched "
                                     f"{kernel}")
    # the captured programs run the cached attention, no flash kernel (a
    # speculative engine's drafter programs are the exception)
    for path in ("gpt-serving-graph", "llama-serving-graph",
                 "gpt-serving-row", "llama-serving-row", "gpt-serving-int8",
                 "gpt-serving-spec-lookup", "gpt-serving-monitor",
                 "gpt-serving-guard", "gpt-serving-fleet",
                 "gpt-serving-http"):
        ran = {k: n for k, n in every_path[path].items() if n}
        if ran:
            raise AssertionError(f"the {path} path launched {ran}")
    log(f"[paths] launches: {paths}; the speculative paths (device "
        f"launches): {spec_paths}; row 6's call: {row6}; the fp32 check "
        f"phases: {checks}")
    launches = {k: sum(p[k] for p in paths.values()) for k in records}
    # the wide-head bodies' launches on the model paths (bf16 heads of 64
    # and 128 there: none)
    wide_launches = {
        f"{body}:{d}": sum(p[f"{body}:flash_attention_{d}"]
                           + p[f"{body}:flash_pair_{d}"]
                           for p in paths.values())
        for body in ("wide", "f32w") for d in ("fwd", "bwd")}
    # the fp32 forward and backward up to 256 and the bf16 backward at 80
    # and 96 (no model path runs fp32 or a head of 80 or 96): their
    # launches on the model paths and in the fp32 phases (the check phases
    # and [llama-engine-fp32])
    for body, d in (("f32f", "fwd"), ("f32b", "bwd"), ("sw32", "bwd")):
        wide_launches[f"{body}:{d}"] = sum(
            p[f"{body}:flash_attention_{d}"] + p[f"{body}:flash_pair_{d}"]
            for p in (*paths.values(), *checks.values()))
    for body, what in (("f32f:fwd", "forward"), ("f32b:bwd", "backward")):
        if wide_launches[body] < 1:
            raise AssertionError(f"the fp32 check phases never launched the "
                                 f"fp32 {what} body")
    # the drafters' [1, 64] windows (rows 1 and 4 inside the drafter
    # programs' graphs): launches on their speculative path, as the
    # device ran them, and the kernel's record at the window's shape
    drafted = []
    for key, path in (("gpt-draft", "gpt-serving-spec-draft"),
                      ("gpt-early", "gpt-serving-spec-early"),
                      ("llama-early", "llama-serving-spec")):
        record, wrapper, shape = draft_records[key]
        source, line = (("flash_pair_fwd.cu", "flash_pair.py:95")
                        if wrapper == "flash_pair_fwd" else
                        ("flash_attention_fwd.cu", "flash_attention.py:122"))
        drafted.append(dict(_kernel_entry(wrapper, source, line,
                                          spec_paths[path], record),
                            name=f"{wrapper} ({key} drafter, {shape})"))
    kernels = [
        _kernel_entry("flash_pair_fwd", "flash_pair_fwd.cu",
                      "flash_pair.py:95", launches, records["flash_pair_fwd"]),
        _kernel_entry("flash_pair_bwd", "flash_pair_bwd.cu",
                      "flash_pair.py:298", launches,
                      records["flash_pair_bwd"]),
        _kernel_entry("flash_attention_fwd", "flash_attention_fwd.cu",
                      "flash_attention.py:122", launches,
                      records["flash_attention_fwd"]),
        _kernel_entry("flash_attention_bwd", "flash_attention_bwd.cu",
                      "flash_attention.py:340", launches,
                      records["flash_attention_bwd"]),
        # row 6 runs the pair kernels: its entries carry their launches in
        # its own call and their times at its shape
        dict(_kernel_entry("flash_pair_fwd", "flash_pair_fwd.cu",
                           "flash_attention.py:701", row6, row6_records[0]),
             name="flash_attention_qkv_packed (flash_pair_fwd)"),
        dict(_kernel_entry("flash_pair_bwd", "flash_pair_bwd.cu",
                           "flash_attention.py:755", row6, row6_records[1]),
             name="flash_attention_qkv_packed (flash_pair_bwd)"),
        # the backwards' last step: their bodies store dq's partials a kv
        # tile apart and this kernel adds them in kv-tile order, as the
        # Pallas backward's sequential grid sums dq (times at GPT-medium's
        # training shape, [bwd-order])
        dict(_kernel_entry("dq_ordered_sum", "dq_sum.cu",
                           "flash_pair.py:298", launches,
                           records["dq_ordered_sum"]),
             name="dq_ordered_sum (the flash backwards' dq, in kv-tile "
                  "order)"),
        _kernel_entry("dropout_fwd", "dropout.cu", "dropout.py:21", launches,
                      records["dropout_fwd"]),
        _kernel_entry("fused_add_dropout_ln_fwd", "fused_residual_fwd.cu",
                      "fused_residual.py:36", launches,
                      records["fused_add_dropout_ln_fwd"]),
        _kernel_entry("fused_add_dropout_ln_bwd", "fused_residual_bwd.cu",
                      "fused_residual.py:57", launches,
                      records["fused_add_dropout_ln_bwd"]),
        # the wide-head bodies (bf16 heads above 256, both launchers; the
        # D = 256 backward), at WIDE_SHAPE: their launches on the model
        # paths, their times at the headline shape
        dict(_kernel_entry("wide:fwd", "flash_wide_sm90.cuh",
                           "flash_attention.py:122", wide_launches,
                           wide_records[0]),
             name="flash_attention_fwd (wide body, bf16 D > 256)"),
        dict(_kernel_entry("wide:bwd", "flash_wide_sm90.cuh",
                           "flash_attention.py:340", wide_launches,
                           wide_records[1]),
             name="flash_attention_bwd (wide body, bf16 D >= 256)"),
        # the fp32 wide-head bodies (both launchers), at [2, 1024, 8/2,
        # 512] ([fp32-bodies]): their launches on the model paths
        dict(_kernel_entry("f32w:fwd", "flash_f32_wide.cuh",
                           "flash_attention.py:122", wide_launches,
                           f32_records[0]),
             name="flash_attention_fwd (fp32 wide body, D > 256)"),
        dict(_kernel_entry("f32w:bwd", "flash_f32_wide.cuh",
                           "flash_attention.py:340", wide_launches,
                           f32_records[1]),
             name="flash_attention_bwd (fp32 wide body, D > 256)"),
        # the fp32 forward and backward up to 256 (both launchers;
        # [fp32-bodies] at [2, 1024, 8/2, 128]) and the bf16 backward at 80
        # and 96 ([compare-fa-bwd] at [2, 1024, 8/2, 80]): their launches on
        # the model paths and in the fp32 phases
        dict(_kernel_entry("f32f:fwd", "flash_f32_wide.cuh",
                           "flash_attention.py:122", wide_launches,
                           f32_records[3]),
             name="flash_attention_fwd (fp32 body, D <= 256)"),
        dict(_kernel_entry("f32b:bwd", "flash_f32_wide.cuh",
                           "flash_attention.py:340", wide_launches,
                           f32_records[2]),
             name="flash_attention_bwd (fp32 body, D <= 256)"),
        dict(_kernel_entry("sw32:bwd", "flash_bwd_sm90.cuh",
                           "flash_attention.py:340", wide_launches,
                           sw32_record),
             name="flash_attention_bwd (bf16 body, D = 80, 96)"),
        *drafted]
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


def api_only() -> int:
    """``chip_smoke.py --api-only``: the card, the build and the [api-*]
    phases alone in a fresh process (their numbers without the rest of
    the script before them); no kernels line and no closing line."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from paddle_tpu_torch.kernels import reset_launch_counts
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    _, _, smi = phase_card()
    phase_build()
    phase_api_check()
    reset_launch_counts()
    losses, eager = phase_api_train(smi)
    log(f"[paths] api-training {_path_counts()}")
    _release("after [api-train]")
    reset_launch_counts()
    phase_api_graph(smi, eager)
    log(f"[paths] api-training-graph {_path_counts()}")
    _release("after [api-graph]")
    phase_api_plain(losses)
    log(f"[done] the [api-*] phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    return 0


def vision_only() -> int:
    """``chip_smoke.py --vision-only``: the card and the vision phases
    alone in a fresh process (no build: no hand kernel lies on the vision
    paths, and their launch counts must stay 0); no kernels line and no
    closing line."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        import paddle_tpu_torch  # noqa: F401
    except ModuleNotFoundError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    _, _, smi = phase_card()
    vision_phases(smi)
    log(f"[done] the vision phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    return 0


def hapi_only() -> int:
    """``chip_smoke.py --hapi-only``: the card, the build and the hapi
    phases alone in a fresh process; no kernels line and no closing
    line."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        import paddle_tpu_torch  # noqa: F401
    except ModuleNotFoundError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    _, _, smi = phase_card()
    phase_build()
    paths = hapi_phases(smi)
    log(f"[paths] {paths}")
    log(f"[done] the hapi phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    return 0


def surface_only(probe_reps=0) -> int:
    """``chip_smoke.py --surface-only [--trace-probe N]``: the card, the
    build and the slice-22 phases ([lstm-*], [bert-lamb*],
    [surface-check]) alone in a fresh process, then, with N, N traces of
    each [wide-route] route (``probe_wide_route_traces``); no kernels line
    and no closing line."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        import paddle_tpu_torch  # noqa: F401
    except ModuleNotFoundError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    _, _, smi = phase_card()
    phase_build()
    paths, checks = surface_phases(smi)
    log(f"[paths] {paths}; checks {checks}")
    if probe_reps:
        probe_wide_route_traces(probe_reps)
    log(f"[done] the slice-22 phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--fleet-worker"]:     # [fleet-http]'s replicas
        sys.exit(_http_worker(*sys.argv[2:5]))
    if sys.argv[1:2] == ["--api-only"]:
        sys.exit(api_only())
    if sys.argv[1:2] == ["--vision-only"]:
        sys.exit(vision_only())
    if sys.argv[1:2] == ["--hapi-only"]:
        sys.exit(hapi_only())
    if sys.argv[1:2] == ["--surface-only"]:
        sys.exit(surface_only(int(sys.argv[3]) if sys.argv[2:3]
                              == ["--trace-probe"] else 0))
    sys.exit(main())
