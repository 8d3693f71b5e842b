"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Builds both CUDA kernels of the port from the sources in this checkout
(``flash_pair_fwd`` and ``flash_pair_bwd``, the packed flash-attention
forward and backward, one ``nvcc`` each, started together), holds each
against its plain PyTorch version at the shapes the main paths give it,
then drives the two main paths through the user entry points at GPT-medium
width (vocab 50304, hidden 1024, 16 blocks, 8 heads of 128, bf16, random
weights from a seed):

* serving: the scoring forward and the paged DecodeEngine answering 8
  requests at the ``bench.py decode --paged`` geometry, then a cross-check
  of the engine's tokens against the uncached forward, the scoring time and
  a profiled serving run;
* training: ``TrainStep`` + ``AdamW(1e-4, wd 0.01, multi_precision=True)``
  at the ``bench.py`` train geometry (batch 16 x seq 1024), 1 warm-up and 6
  timed steps, a profiled training step, the same 7 steps with attention
  in its plain versions (the loss curves agree step by step), then the
  slice against the plain CPU path on the same weights (loss and every
  leaf's gradient).

Each path is driven with the launch counts set to 0 just before it and
read just after; a kernel its path never launched fails the run. TF32 is
off for matrix products and cuDNN (``allow_tf32 = False``), so fp32 on the
card is fp32. Every phase raises on failure; the script exits non-zero and
prints no result line unless all of them pass. Needs CUDA (exits non-zero
without it) and imports nothing of JAX.

The second line from the end is the ``kernels`` JSON: per kernel, its
launches on the main paths (serving plus training), its error against the
plain version, its time, the plain version's time, the least time the
card could take (bound) and the time of one PyTorch call computing the
same function (library_ms, a yardstick only; the port never calls it).
The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

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


def rel_err(got, want):
    """Relative Frobenius error ||got - want|| / ||want|| in fp32."""
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


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
    from paddle_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"[build] {len(built)} kernel source(s) in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, res in built.items():
        for line in res["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def phase_compare():
    """Kernel vs plain version: the scoring shape, a ragged fp32 D=64
    case, a bidirectional case and the training shape. Returns the scoring
    shape's record.

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
             (16, 1024, 8, 128, torch.bfloat16, True)]   # the train shape
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
    Raises past BWD_REL_LIMIT or when dk/dv differ between two launches.
    Returns the inputs and the largest absolute error."""
    from paddle_tpu_torch.kernels.flash_pair import (
        flash_pair_bwd, flash_pair_bwd_reference, flash_pair_fwd)
    qkv, dout = _bwd_inputs(b, L, h, d, dtype, gen)
    out, lse = flash_pair_fwd(qkv, h, causal)
    got = flash_pair_bwd(qkv, out, lse, dout, h, causal)
    again = flash_pair_bwd(qkv, out, lse, dout, h, causal)
    torch.cuda.synchronize()
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
        if not rel < BWD_REL_LIMIT[dtype]:
            raise AssertionError(
                f"flash_pair_bwd {part} at B={b} L={L} H={h} D={d} "
                f"{dtype} causal={causal}: relative error {rel:.3g} >= "
                f"{BWD_REL_LIMIT[dtype]}")
    if not torch.equal(got[..., hd:], again[..., hd:]):
        raise AssertionError("flash_pair_bwd: dk/dv differ between two "
                             "launches on the same inputs")
    dq_jitter = (got[..., :hd].float()
                 - again[..., :hd].float()).abs().max().item()
    log(f"[compare-bwd] flash_pair_bwd B={b} L={L} H={h} D={d} "
        f"{str(dtype)[6:]} causal={causal}: {'; '.join(parts)} (limit "
        f"rel {BWD_REL_LIMIT[dtype]}); dq run-to-run max|diff| "
        f"{dq_jitter:.3g}")
    return qkv, out, lse, dout, worst_abs


def phase_compare_bwd():
    """Backward kernel vs plain version (``_compare_bwd_case``) at the
    slice's shape, a ragged fp32 D=64 case, a bidirectional case, L = 4608
    (above the TPU's fused-backward cutoff, 4096, where the JAX package
    switches to its split dq/dkv kernels) and the training shape [16, 1024,
    3*8*128]. At the training shape it then times the kernel beside the
    plain version, torch.autograd.grad through scaled_dot_product_attention
    (library_ms only) and the bound, so every field of the record describes
    the shape the training path gives the kernel.

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
                 (1, 4608, 8, 128, torch.bfloat16, True)]:  # above 4096
        _compare_bwd_case(*case, gen)
        torch.cuda.empty_cache()

    b, L, h, d = TRAIN["batch"], TRAIN["seq"], 8, 128   # the train shape
    qkv, out, lse, dout, err = _compare_bwd_case(b, L, h, d, torch.bfloat16,
                                                 True, gen)
    ms = cuda_time_ms(lambda: flash_pair_bwd(qkv, out, lse, dout, h, True),
                      iters=10)
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
    bound_ms, bound_by = flash_bwd_bound_ms(b, L, h, d, torch.bfloat16, True)
    log(f"[compare-bwd] flash_pair_bwd at the training shape B={b} L={L} "
        f"H={h} D={d} bf16 causal: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa backward {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by})")
    del qkv, dout, out, lse, leaf, q, k, v, o, do
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


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
    grew = {k: after[k] - before[k] for k in after}
    if grew != {"flash_pair_fwd": 1, "flash_pair_bwd": 1}:
        raise AssertionError(f"launches under autograd: {grew}")
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


def phase_engine(model):
    """8 requests (a shared 32-token prefix + random tokens, 64-128
    prompt tokens, 32-64 new) through the paged engine, invariants checked
    after every step."""
    from paddle_tpu_torch.serving import DecodeEngine
    gen = torch.Generator()
    gen.manual_seed(2)
    vocab = GPT_MEDIUM["vocab_size"]
    prefix = torch.randint(0, vocab, (32,), generator=gen).tolist()
    prompt_lens = [128, 120, 64, 72, 80, 96, 104, 112]
    new_tokens = [64, 56, 32, 40, 48, 64, 36, 60]
    prompts = [prefix + torch.randint(0, vocab, (n - 32,),
                                      generator=gen).tolist()
               for n in prompt_lens]
    eng = DecodeEngine(model, **ENGINE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reqs = [eng.submit(prompts[0], max_new_tokens=new_tokens[0])]
    steps = 0
    while reqs[0].status != "running":   # publish the shared prefix first
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
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    bad = [r for r in reqs if r.status != "done"
           or len(r.tokens) != r.max_new_tokens]
    if bad:
        raise AssertionError(f"requests not done: {bad}")
    st = eng.stats()
    if st["paged"]["shared_hits"] < 1:
        raise AssertionError(f"prefix sharing was not hit: {st['paged']}")
    log(f"[engine] {len(reqs)} requests done in {steps} steps, "
        f"{wall:.3f} s: {st['tokens_generated']} tokens, "
        f"{st['tokens_generated'] / wall:.1f} tokens/s; "
        f"{st['decode_steps']} decode steps, {st['prefill_calls']} chunk "
        f"calls; shared_hits {st['paged']['shared_hits']}, shared_tokens "
        f"{st['paged']['shared_tokens']}, cow {st['paged']['cow_copies']}; "
        f"peak memory {peak_gb:.2f} GB")
    return reqs


def phase_crosscheck(model, reqs):
    """The engine's greedy tokens against the uncached forward (through
    the flash kernel) over prompt + output: the argmax agrees at >= 95% of
    generated positions and every disagreement is a near-tie (bf16 rounds
    differently in the paged cached path and the kernel)."""
    from paddle_tpu_torch.models.gpt import _lm_head_logits
    longest = sorted(reqs, key=lambda r: -(len(r.prompt) + len(r.tokens)))
    for req in longest[:2]:
        seq = req.prompt + req.tokens[:-1]
        if len(seq) < 128:
            raise AssertionError("cross-check sequence below the kernel's "
                                 "128-token minimum")
        ids = torch.tensor([seq], device="cuda")
        with torch.no_grad():
            hidden = model.gpt(ids)[0, len(req.prompt) - 1:]
            logits = _lm_head_logits(hidden, model.head_weight)
        want = torch.tensor(req.tokens, device="cuda")
        top = logits.argmax(dim=-1)
        agree = (top == want).float().mean().item()
        gaps = (logits.gather(1, top[:, None])
                - logits.gather(1, want[:, None]))[:, 0]
        worst = gaps.max().item()
        log(f"[crosscheck] request {req.id}: {len(req.tokens)} generated "
            f"positions, argmax agreement {agree:.3f}, largest logit gap at "
            f"a disagreement {worst:.4f}")
        if agree < 0.95 or worst > 0.1:
            raise AssertionError("engine tokens disagree with the uncached "
                                 "forward beyond bf16 near-ties")


def phase_profile(model):
    """Where a serving run's time goes: 16 requests (64-token prompts, 32
    new tokens) through a fresh engine under torch.profiler. Reports the
    host wall time per scheduler step, the device's busy share (kernel
    time over wall time) and the kernels that take the most device time.
    The profiler adds host overhead, so the wall times here are not the
    engine's speed; the [engine] line is."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.serving import DecodeEngine
    gen = torch.Generator()
    gen.manual_seed(3)
    eng = DecodeEngine(model, **ENGINE)
    prompts = torch.randint(0, GPT_MEDIUM["vocab_size"], (16, 64),
                            generator=gen).tolist()
    reqs = [eng.submit(p, max_new_tokens=32) for p in prompts]
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
    steps = st["decode_steps"] + st["prefill_calls"]
    log(f"[profile] 16 requests x 32 tokens: {st['decode_steps']} decode "
        f"steps + {st['prefill_calls']} chunk calls in {wall * 1e3:.1f} ms "
        f"wall ({wall * 1e3 / max(steps, 1):.2f} ms per call, profiler "
        f"on); device busy {busy_us / 1e3:.1f} ms = "
        f"{busy_us / 1e6 / wall:.3f} of wall")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"[profile]   {e.self_device_time_total / 1e3:8.2f} ms "
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
        after = launch_counts()
        grew = {k: after[k] - before[k] for k in after}
        if grew != {"flash_pair_fwd": blocks, "flash_pair_bwd": blocks}:
            raise AssertionError(f"step {i}: launches {grew}, expected "
                                 f"{blocks} of each")
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
    def forward(ctx, qkv, num_heads, causal):
        from paddle_tpu_torch.kernels.flash_pair import (
            flash_pair_fwd_reference)
        out, lse = flash_pair_fwd_reference(qkv, num_heads, causal)
        ctx.save_for_backward(qkv, out, lse)
        ctx.num_heads, ctx.causal = num_heads, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        from paddle_tpu_torch.kernels.flash_pair import (
            flash_pair_bwd_reference)
        qkv, out, lse = ctx.saved_tensors
        return flash_pair_bwd_reference(qkv, out, lse, dout.contiguous(),
                                        ctx.num_heads, ctx.causal), None, None


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
    path). The loss and every leaf's gradient agree within
    TRAIN_CHECK_REL_LIMIT relative (Frobenius per leaf): fp32 on both
    sides, so what remains is summation order."""
    from paddle_tpu_torch.kernels import launch_counts
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    cfg = GPTConfig(**dict(GPT_MEDIUM, num_layers=2))
    cpu = GPTForCausalLM(cfg, device="cpu", seed=7)
    card = GPTForCausalLM(cfg, seed=7)
    card.load_state_dict(cpu.state_dict())
    gen = torch.Generator()
    gen.manual_seed(8)
    ids = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen)
    labels = ids.clone()
    labels[:, :16] = -100
    before = launch_counts()
    _, loss_card = card(ids.cuda(), labels.cuda())
    loss_card.backward()
    torch.cuda.synchronize()
    after = launch_counts()
    grew = {k: after[k] - before[k] for k in after}
    if grew != {"flash_pair_fwd": 2, "flash_pair_bwd": 2}:
        raise AssertionError(f"train-check launches {grew}")
    _, loss_cpu = cpu(ids, labels)
    loss_cpu.backward()
    loss_rel = abs(loss_card.item() - loss_cpu.item()) / abs(loss_cpu.item())
    worst_name, worst = None, 0.0
    cpu_params = dict(cpu.named_parameters())
    for name, p in card.named_parameters():
        if p.grad is None:
            raise AssertionError(f"{name} got no gradient on the card")
        rel = rel_err(p.grad.cpu(), cpu_params[name].grad)
        if rel > worst:
            worst_name, worst = name, rel
    log(f"[train-check] fp32, 2 blocks, [2, 256]: loss card "
        f"{loss_card.item():.6f} vs cpu {loss_cpu.item():.6f} (rel "
        f"{loss_rel:.3g}); worst leaf gradient rel {worst:.3g} "
        f"({worst_name}); limit {TRAIN_CHECK_REL_LIMIT}; launches {grew}")
    if not (loss_rel < TRAIN_CHECK_REL_LIMIT
            and worst < TRAIN_CHECK_REL_LIMIT):
        raise AssertionError("the card's loss or gradients disagree with "
                             "the plain CPU path")


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
                   if "flash_pair" in e.key or "dq_store" in e.key)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "GPU", file=sys.stderr)
        return 2
    from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    # fp32 products in full fp32 on the card: the plain versions and the
    # train-check compare fp32 with fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, count, smi = phase_card()
    log("[card] TF32 off (torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False)")
    phase_build()
    fwd_record = phase_compare()
    bwd_record = phase_compare_bwd()
    phase_autograd()
    t0 = time.perf_counter()
    model = GPTForCausalLM(GPTConfig(**GPT_MEDIUM), dtype=torch.bfloat16,
                           seed=0).eval()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[model] GPT-medium {n_params / 1e6:.1f} M params, bf16, built in "
        f"{time.perf_counter() - t0:.1f} s")

    reset_launch_counts()                  # the serving path starts here
    ids = phase_scoring(model)
    reqs = phase_engine(model)
    serving = launch_counts()              # ... and ends here
    if serving["flash_pair_fwd"] < 1:
        raise AssertionError("the serving path never launched "
                             "flash_pair_fwd")
    phase_crosscheck(model, reqs)
    phase_scoring_time(model, ids)
    phase_profile(model)
    del model, reqs
    torch.cuda.empty_cache()

    reset_launch_counts()                  # the training path starts here
    train_model, opt, train_ids, losses = phase_train()
    training = launch_counts()             # ... and ends here
    for kernel, n in training.items():
        if n < 1:
            raise AssertionError(f"the training path never launched {kernel}")
    log(f"[paths] launches: serving {serving}, training {training}")
    phase_profile_train(train_model, opt, train_ids)
    del train_model, opt
    torch.cuda.empty_cache()
    phase_train_plain(losses)
    torch.cuda.empty_cache()
    phase_train_check()

    launches = {k: serving[k] + training[k] for k in training}
    kernels = [
        dict(name="flash_pair_fwd", route="cuda",
             source="paddle_tpu_torch/csrc/flash_pair_fwd.cu",
             replaces="paddle_tpu/kernels/pallas/flash_pair.py:95",
             launches=launches["flash_pair_fwd"], **fwd_record),
        dict(name="flash_pair_bwd", route="cuda",
             source="paddle_tpu_torch/csrc/flash_pair_bwd.cu",
             replaces="paddle_tpu/kernels/pallas/flash_pair.py:298",
             launches=launches["flash_pair_bwd"], **bwd_record)]
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
