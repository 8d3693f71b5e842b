"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Builds the seven CUDA sources of the port from this checkout, one
``nvcc`` each, all started together: ``flash_pair_fwd`` and
``flash_pair_bwd`` (flash attention over packed qkv, with in-kernel
dropout; also ``kernels.flash_attention_qkv_packed``, the packed-qkv call
for heads of 128), ``flash_attention_fwd`` and ``flash_attention_bwd``
(flash attention on ``[B, L, H, D]`` with grouped-query attention,
per-sequence key lengths, segment ids and in-kernel dropout),
``dropout_fwd`` (dropout, forward and backward) and
``fused_add_dropout_ln_fwd`` / ``_bwd`` (BERT's residual epilogue
``LayerNorm(x + dropout(sub))``); the build fails on a wgmma that ptxas
serialises (its note C7520). It times both attention forwards and both
backwards against the parent commit's wrappers and kernels
(``[parent-fwd]``, ``[parent-bwd]``: an unpacked ``git archive`` of it in
``smoke_checkout/parent/`` or ``PARENT_TREE``; without one the phases say
so), in turns, and fails a case only beyond the timing noise (a body
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
counters, ``[wide-route]``; every dropout mask for mask:
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
  (loss and every leaf's gradient), and again at dropout 0.1;
* BERT-base (vocab 30528, hidden 768, 12 layers of 12 heads of 64, FFN
  3072, dropout 0.1; BASELINE.md config 2) pretraining at batch 64 x 512
  (MLM on 15% of positions + NSP), 1 warm-up and 6 timed steps, a profiled
  step, the eval scoring forward at [64, 512], the same steps with every
  kernel in its plain version, then 2 layers in fp32 against the plain CPU
  path at dropout 0.1: once on the packed path (unpadded batches, the pair
  kernels) and once on padded batches (``seq_lens``; lengths uniform in
  [32, 512] from a seed: the flat kernels with the lengths), where the
  padded route at full lengths is also held to the packed route;
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
  backward at 16 x 1024 without it (twice: the run-to-run spread) and
  under "dots", "selective" and "full" (the leaves no dq reaches bit for
  bit, the whole gradient within the spread or the dq reorder's, the
  attention forward launched twice a block, peak memory falling:
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
* LLaMA-7B training at full width and 4 blocks (32 would not fit: 16 bytes
  a parameter), batch 4 x seq 2048, the recipe of GPT's, 1 warm-up and 4
  timed steps, a profiled step, the same steps with attention in its plain
  versions, then the slice in fp32 at 2 blocks with GQA against the plain
  CPU path, and "selective" recompute against none
  ([llama-train-recompute]).

Each path is driven with the launch counts set to 0 just before it and
read just after; a kernel its path never launched fails the run. A
drafter's program runs its kernels inside a CUDA graph, whose replays the
wrappers do not count: a speculative path counts the launches the device
ran, blocks x the program's calls (``_replayed``; [draft-kernel-*] checks
that number a replay against the profiler's kernel names). TF32 is
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
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
import subprocess
import sys
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
# steps (Adam turns noise-level gradient differences into full steps, and
# dq's atomics change order each run); the limit is 10x that and still
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
    """Raise unless ``grew`` launched exactly ``want`` and nothing else."""
    full = {k: want.get(k, 0) for k in grew}
    if grew != full:
        raise AssertionError(f"{where}: launches {grew}, expected {full}")


# the flash kernels' names (csrc/flash_attention.cuh and the headers it
# includes: the forwards, the backwards, the backward's pre-pass and dq
# conversion), as profiler keys contain them
FLASH_KERNELS = ("flash_fwd_sm90_kernel", "flash_fwd_wide_kernel",
                 "flash_fwd_f32_kernel", "flash_fwd_f32_wide_kernel",
                 "flash_fwd_f32_small_kernel",
                 "flash_bwd_sm90_kernel", "flash_bwd_wide_kernel",
                 "flash_bwd_f32_kernel", "flash_bwd_f32_wide_kernel",
                 "bwd_prepass_kernel", "scale_q_kernel", "dq_convert_kernel")


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
    PARENT_TREE, imported as ``parent_kernels``: its wrappers with its own
    build module, sources and build directory) with its four flash
    sources built by its own ``_build`` in parallel, for [parent-fwd] and
    [parent-bwd]; None without a parent tree."""
    import importlib.util
    from concurrent.futures import ThreadPoolExecutor
    pkg = os.path.join(PARENT_TREE, "paddle_tpu_torch", "kernels")
    if not os.path.isfile(os.path.join(pkg, "__init__.py")):
        return None
    spec = importlib.util.spec_from_file_location(
        "parent_kernels", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_kernels"] = mod
    spec.loader.exec_module(mod)
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


def _judge_parent(tag, where, ours, parent, noise, speedup=None):
    """Log one [parent-*] case and fail it when the change is slower than
    the parent by more than the noise (``_timed_pair``; ``noise``, from
    ``_timing_noise``, its floor); a case under HOST_BOUND_MS is only
    logged. A case whose body this change redesigned must do better:
    ``speedup`` "noise", faster than the parent beyond the noise; a
    number, at least that many times the parent's speed."""
    (ms, sp), (pms, psp) = ours, parent
    margin = max(sp, psp, noise)
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
# as FWD_SPEEDUP: none (every backward body is the parent's design; each
# case must be no slower than the parent's beyond the noise)
BWD_SPEEDUP = {}


def phase_parent_bwd(parent, noise):
    """Both backward wrappers against the parent commit's, as
    [parent-fwd] does, with torch.autograd.grad through
    scaled_dot_product_attention on the same inputs beside them (the
    yardstick) and the bound. Every case must be faster than the parent's
    (beyond the noise, ``_judge_parent``). Returns {tag: (ms, parent ms,
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
                          BWD_SPEEDUP.get(tag))
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
    Frobenius error and the largest absolute error, and the change of dq
    between two launches (its fp32 atomics add in another order each run).
    Raises past BWD_REL_LIMIT (fp32 above D = 256: BIG_D_FP32_REL_LIMIT
    against the exact gradient) or when dk/dv differ between two launches.
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
    if not torch.equal(got[..., hd:], again[..., hd:]):
        raise AssertionError("flash_pair_bwd: dk/dv differ between two "
                             "launches on the same inputs")
    dq_jitter = (got[..., :hd].float()
                 - again[..., :hd].float()).abs().max().item()
    log(f"[compare-bwd] flash_pair_bwd B={b} L={L} H={h} D={d} "
        f"{str(dtype)[6:]} causal={causal}: {'; '.join(parts)} (limit "
        f"rel {limit}{EXACT_NOTE if _exact(dtype, d) else ''}); dq "
        f"run-to-run max|diff| {dq_jitter:.3g}")
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
    .backward(dO) is flash_pair_bwd's output (dk and dv bit for bit; dq,
    whose atomics add in another order each launch, within 1e-3 relative),
    and the forward and backward counters each go up by one."""
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
    hd = h * d
    dq_rel = rel_err(leaf.grad[..., :hd], want[..., :hd])
    if out.grad_fn is None or leaf.grad is None:
        raise AssertionError("no gradient reached qkv through "
                             "FlashPairPacked")
    if not torch.equal(out, ref_out) or not torch.equal(leaf.grad[..., hd:],
                                                         want[..., hd:]):
        raise AssertionError("FlashPairPacked out or dk/dv differ from the "
                             "kernels called directly")
    if not dq_rel < 1e-3:
        raise AssertionError(f"FlashPairPacked dq off by {dq_rel:.3g}")
    grew = _grew(before, after)
    _expect_launches("launches under autograd", grew, flash_pair_fwd=1,
                     flash_pair_bwd=1)
    log(f"[autograd] FlashPairPacked [2, 1024, 3*8*128] bf16: qkv.grad == "
        f"flash_pair_bwd output (dk, dv exact; dq rel {dq_rel:.3g}); "
        f"launches {grew}")


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


def _train_recipe():
    """The training recipe of [train] and [train-plain]: GPT-medium (bf16,
    seed 0), AdamW(1e-4, wd 0.01, multi_precision=True), TrainStep, and a
    fixed random batch of TRAIN["batch"] x TRAIN["seq"] tokens (seed 4).
    Returns (model, optimizer, step, ids)."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    model = GPTForCausalLM(GPTConfig(**GPT_MEDIUM), dtype=torch.bfloat16,
                           seed=0)
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.parameters(), multi_precision=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    ids = torch.randint(0, GPT_MEDIUM["vocab_size"],
                        (TRAIN["batch"], TRAIN["seq"]), device="cuda",
                        generator=gen)
    return model, opt, TrainStep(model, opt), ids


TRAIN_WALLS = []          # [train]'s timed steps (s), set by phase_train


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
    step = TrainStep(model, opt)
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
    names read; a trace with no device event at all is taken again, up
    to three times). The flash kernels seen must be exactly the expected
    ones, and each body counter of the wrappers (bf16 wide, fp32 wide,
    fp32 forward and backward, bf16 80/96 backward) must read 1 where its
    body ran and 0 elsewhere."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.kernels import (f32_bwd_launch_counts,
                                          f32_fwd_launch_counts,
                                          f32_wide_launch_counts,
                                          flash_attention, flash_pair,
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
        b, L, h = 2, 256, 4
        if launcher == "flat":
            q, k, v, g = _fa_inputs(b, L, L, h, 2, d, dtype, gen)
            names = ("flash_attention_fwd", "flash_attention_bwd")

            def run():
                out, lse = flash_attention.flash_attention_fwd(q, k, v, True)
                flash_attention.flash_attention_bwd(q, k, v, out, lse, g,
                                                    True)
        else:
            qkv, g = _bwd_inputs(b, L, h, d, dtype, gen)
            names = ("flash_pair_fwd", "flash_pair_bwd")

            def run():
                out, lse = flash_pair.flash_pair_fwd(qkv, h, True)
                flash_pair.flash_pair_bwd(qkv, out, lse, g, h, True)
        run()                                # built and warm
        torch.cuda.synchronize()
        for attempt in range(3):
            reset_launch_counts()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
            events = prof.key_averages()
            # a trace without a single device event is the profiler's
            # failure (an H100 run once gave one), not a route: profile the
            # same launches again
            if any(e.device_type == torch.autograd.DeviceType.CUDA
                   for e in events):
                break
            log(f"[wide-route] {launcher} D={d}: the profiler recorded no "
                f"device event (attempt {attempt + 1}); profiling again")
        counts = launch_counts()
        keys = [e.key for e in events]
        seen = {n for n in FLASH_KERNELS if any(n in key for key in keys)}
        want = {fwd_body, bwd_body, "bwd_prepass_kernel", "dq_convert_kernel"}
        if dtype == BF16 and "wide" in (ctr_f, ctr_b):
            want.add("scale_q_kernel")
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
    (limits FA_BWD_REL_LIMIT), dk and dv equal bit for bit between two
    launches (no atomics there) and dq's run-to-run change. At the
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
        if not (torch.equal(got[1], again[1])
                and torch.equal(got[2], again[2])):
            raise AssertionError("flash_attention_bwd: dk/dv differ between "
                                 "two launches on the same inputs")
        dq_jitter = (got[0].float() - again[0].float()).abs().max().item()
        log(f"[compare-fa-bwd] flash_attention_bwd B={b} Lq={lq} Lk={lk} "
            f"H={h} Hkv={hkv} D={d} {str(dtype)[6:]} causal={causal}: "
            f"{'; '.join(parts)} (limit rel {limit}"
            f"{EXACT_NOTE if _exact(dtype, d) else ''}); "
            f"dq run-to-run max|diff| {dq_jitter:.3g}")
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
    step = TrainStep(model, opt)
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
    step = TrainStep(model, opt)
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
    step = TrainStep(model, opt)
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
    return model, opt, TrainStep(model, opt), batch


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
    of device time (forward, backward and dq conversion), the share of
    the kernels of BERT's path (the flash kernels, dropout, fused-LN
    forward and backward) by name, and the six kernels with the most
    device time."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.jit import TrainStep
    model.train()
    step = TrainStep(model, opt)
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
# in two others on the same code (NVIDIA H100, torch 2.11): a short
# reading is the tracer's, a reading above the count would be the graph's
DRAFT_TRACE_TRIES = 3
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
    """A speculative phase's launch counts as the device ran them. The
    wrappers count Python calls: the drafter program's first call (eager)
    and its capture each call every kernel once a block, and a replay
    calls none. So each count must be 2 x the blocks a call runs, and the
    device launched blocks x calls."""
    out = dict(counts_now)
    ran = {k: n for k, n in counts_now.items() if n}
    if drafter is None or not hasattr(drafter, "calls"):
        if ran:
            raise AssertionError(f"{tag}: launched {ran} without a model "
                                 f"drafter")
        return out
    per_call = _draft_blocks(drafter)
    for key, n in ran.items():
        if n != 2 * per_call:
            raise AssertionError(f"{tag}: {key} counted {n} Python calls, "
                                 f"expected 2 x {per_call} (the first call "
                                 f"and its capture)")
        out[key] = per_call * drafter.calls
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
    block a replay (up to DRAFT_TRACE_TRIES proposals, for a reading the
    tracer did not cut; no reading may exceed it). Then the kernel alone at the drafter's shape, timed
    beside its plain version, sdpa and the bound. Returns (the kernel's
    record, its wrapper's name, the shape)."""
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
# and [train-amp] hold a run's gradients (every leaf) against a run
# without recompute (or scale) in two parts. The flash backwards add dq
# into an fp32 scratch with bulk reductions whose order changes from run
# to run (csrc/flash_bwd_sm90.cuh), so any leaf behind a dq may move by a
# bf16 rounding between two runs of the same step. (1) The leaves no dq
# reaches (``_DQ_FREE``: the last block's MLP, its second norm, its
# output projection, its k and v projections where they stand apart, the
# final norm and an untied head) equal the reference bit for bit: they
# read the last block's recomputed activations and the attention
# backward's dk and dv, whose sums keep their order. (2) The relative
# error of the whole gradient is at most RECOMPUTE_SPREAD_FACTOR times
# the larger of the spread of two runs without recompute and
# DQ_REORDER_REL, the largest whole-gradient difference two runs of one
# step have shown (LLaMA-7B width, 4 blocks, 4 x 2048: 3.33e-3, NVIDIA
# H100 80GB HBM3, 700 W; the two runs agree bit for bit as often as not)
RECOMPUTE_SPREAD_FACTOR = 2.0
DQ_REORDER_REL = 3.5e-3
_DQ_FREE = {
    "gpt": r"gpt\.(ln_f\.|h\.{last}\.(ln_2|mlp|attn\.out_proj)\.)",
    "llama": r"(model\.norm\.|lm_head\.|model\.layers\.{last}\."
             r"(post_attention_layernorm\.|mlp\.|self_attn\.[kvo]_proj\.))"}
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


def _hold_grads(tag, what, got, want, spread, family, blocks):
    """Gate a run's gradients ``got`` against ``want`` (both ``{name:
    gradient}``) as the comment on RECOMPUTE_SPREAD_FACTOR says: the
    ``_DQ_FREE[family]`` leaves (the last of ``blocks`` blocks) bit for
    bit, the whole gradient within the limit. Logs both parts."""
    pattern = re.compile(_DQ_FREE[family].format(last=blocks - 1))
    exact = [n for n in want if pattern.match(n)]
    moved = [n for n in exact if not torch.equal(got[n], want[n])]
    err, (leaf_err, leaf) = _grad_errors(got, want)
    limit = RECOMPUTE_SPREAD_FACTOR * max(spread, DQ_REORDER_REL)
    log(f"{tag} {what}: {len(exact)} leaves no dq reaches, "
        f"{len(moved)} moved {moved[:4]}; whole gradient error {err:.3g} "
        f"(limit {RECOMPUTE_SPREAD_FACTOR} x max(spread {spread:.3g}, "
        f"{DQ_REORDER_REL}); largest leaf {leaf_err:.3g}, {leaf})")
    if not exact or moved or not err <= limit:
        raise AssertionError(f"{tag} {what}: leaves no dq reaches moved "
                             f"({moved[:4]}) or the gradient is {err:.3g} "
                             f"from the reference (limit {limit:.3g})")


def _held_gb():
    """The GB allocated on the card now (model and optimizer state and
    whatever earlier phases still hold)."""
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated() / 1e9


def _policies(tag, model, ids, blocks, fwd, bwd, policies, family,
              dropouts=0, reset=None):
    """Two runs without recompute (their spread), then one under each of
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
    spread, (leaf_err, leaf) = _grad_errors(g1, g0)
    log(f"{tag} held {held:.2f} GB at the start (the model's weights "
        f"included); none: loss {loss0:.6f}, peak {peak0:.2f} GB; a second "
        f"run without recompute: loss {loss1:.6f}, gradient error "
        f"{spread:.3g} (largest leaf {leaf_err:.3g}, {leaf})")
    del g1
    peaks = {"none": peak0}
    for policy in policies:
        loss, g, peak, grew = _fwd_bwd(model, ids, policy, reset)
        want = {fwd: 2 * blocks, bwd: blocks,
                "dropout_fwd": dropouts + (blocks if dropouts else 0)}
        _expect_launches(f"{tag} {policy}", grew, **want)
        log(f"{tag} {policy}: loss {loss:.6f}, peak {peak:.2f} GB; launches "
            f"{want}")
        _hold_grads(tag, f"{policy} against none", g, g0, spread, family,
                    blocks)
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
                      ("dots", "selective", "full"), "gpt")
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
    step = TrainStep(model, opt)
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
    (``_hold_grads``: the last block's leaves that no dq reaches bit for
    bit), so the recompute of every block replayed the masks
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
              "flash_pair_fwd", "flash_pair_bwd", ("full",), "gpt",
              dropouts=2 + 4 * blocks,
              reset=lambda: model.generator.set_state(state))
    del model


def phase_llama_train_recompute():
    """LLaMA-7B width at LLAMA_TRAIN's 4 blocks and batch 4 x 2048, bf16:
    "selective" against no recompute (twice: the spread), gradients held
    by ``_hold_grads``, the flash_attention forward twice a block, peak
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
                      ("selective",), "llama")
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
    return model, opt, TrainStep(model, opt, accumulate_steps=k,
                                 grad_scaler=scaler), ids


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
    update (and so their clips) equal each other bit for bit unless the
    flash backward's dq order changed between the runs (a third, unscaled
    run shows that spread; the gate is ``_hold_grads``). Then a gradient made
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
    spread, _ = _grad_errors(grads["plain-again"], grads["plain"])
    differ = [n for n in grads["plain"]
              if not torch.equal(grads["scaled"][n], grads["plain"][n])]
    log(f"[train-amp] scaled x {AMP_SCALE:g} against unscaled: {len(differ)} "
        f"of {len(grads['plain'])} leaves differ ({differ[:4]}); unscaled "
        f"against unscaled: {spread:.3g}")
    _hold_grads("[train-amp]", "scaled against unscaled", grads["scaled"],
                grads["plain"], spread, "gpt", GPT_MEDIUM["num_layers"])
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
        step = TrainStep(model, opt)
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

MONITOR_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "smoke_checkout", "monitor")
MONITOR_TRAIN_BLOCKS = ("on", "off", "on", "off")     # 3 steps a block
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
    reads; the same TrainStep throughout), each step synchronised. Prints
    ms a step on and off and the overhead beside [train]'s spread, which
    the overhead must stay within; the ledger's MFU and HFU against the
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
    if not abs(on - off) <= spread:
        raise AssertionError(f"[monitor-train] overhead {on - off:.2f} ms "
                             f"a step exceeds [train]'s spread "
                             f"{spread:.2f} ms")
    _tools_read("[monitor-train]",
                (path, path.replace(".jsonl", ".trace.jsonl")))
    del model, opt, step
    return dict(on=on, off=off, spread=spread,
                mfu=measured / steady_on / peak)


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
    step = TrainStep(model, opt)
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


def _release(tag):
    """Collect what earlier phases left (reference cycles included), give
    the cache back, and print what the process still holds."""
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[memory] {tag}: {_held_gb():.2f} GB allocated")


def _kernel_entry(name, source, replaces, launches, record):
    return dict(name=name, route="cuda",
                source=f"paddle_tpu_torch/csrc/{source}",
                replaces=f"paddle_tpu/kernels/pallas/{replaces}",
                launches=launches[name], **record)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "GPU", file=sys.stderr)
        return 2
    try:
        from paddle_tpu_torch.kernels import (f32_bwd_launch_counts,
                                              f32_fwd_launch_counts,
                                              f32_wide_launch_counts,
                                              launch_counts,
                                              reset_launch_counts,
                                              sw32_bwd_launch_counts,
                                              wide_launch_counts)
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
    row6, row6_records = phase_compare_fa_packed()   # row 6's own call
    wide_records = phase_compare_wide()
    phase_wide_route()
    f32_records = phase_fp32_bodies(parent, parent_fwd, parent_bwd)
    phase_plain_times()
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

    def counts():
        """The launch counts and, as "wide:<wrapper>", "f32w:<wrapper>",
        "f32f:<wrapper>", "f32b:<wrapper>" and "sw32:<wrapper>", the bf16
        and fp32 wide bodies', the fp32 forward's and backward's up to 256
        and the bf16 backward's at 80 and 96."""
        return dict(launch_counts(),
                    **{f"wide:{k}": n for k, n in
                       wide_launch_counts().items()},
                    **{f"f32w:{k}": n for k, n in
                       f32_wide_launch_counts().items()},
                    **{f"f32f:{k}": n for k, n in
                       f32_fwd_launch_counts().items()},
                    **{f"f32b:{k}": n for k, n in
                       f32_bwd_launch_counts().items()},
                    **{f"sw32:{k}": n for k, n in
                       sw32_bwd_launch_counts().items()})

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
             "llama-training-recompute": ["flash_attention_fwd",
                                          "flash_attention_bwd"],
             "gpt-serving-spec-draft": ["flash_pair_fwd"],
             "gpt-serving-spec-early": ["flash_pair_fwd"],
             "llama-serving-spec": ["flash_attention_fwd"]}
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
                 "gpt-serving-spec-lookup", "gpt-serving-monitor"):
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


if __name__ == "__main__":
    sys.exit(main())
