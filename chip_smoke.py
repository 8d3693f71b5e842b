"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Builds the four CUDA kernels of the port from the sources in this
checkout, one ``nvcc`` each, all started together: ``flash_pair_fwd`` and
``flash_pair_bwd`` (flash attention over GPT's packed qkv) and
``flash_attention_fwd`` and ``flash_attention_bwd`` (flash attention on
``[B, L, H, D]`` with grouped-query attention, LLaMA's). It holds each
kernel against its plain PyTorch version at the shapes the main paths give
it, then drives four main paths through the user entry points, bf16,
random weights from a seed:

* GPT-medium (vocab 50304, hidden 1024, 16 blocks, 8 heads of 128)
  serving: the scoring forward and the paged DecodeEngine answering 8
  requests at the ``bench.py decode --paged`` geometry, then a cross-check
  of the engine's tokens against the uncached forward, the scoring time and
  a profiled serving run;
* GPT-medium training: ``TrainStep`` + ``AdamW(1e-4, wd 0.01,
  multi_precision=True)`` at the ``bench.py`` train geometry (batch 16 x
  seq 1024), 1 warm-up and 6 timed steps, a profiled step, the same steps
  with attention in its plain versions, then the slice against the plain
  CPU path on the same weights (loss and every leaf's gradient);
* LLaMA-7B (vocab 32000, hidden 4096, FFN 11008, 32 blocks of 32 heads of
  128, built on the card) serving: the scoring forward at [2, 2048] and
  the engine answering 8 requests, a cross-check against the uncached
  forward, the scoring time, and the same engine run and cross-check in
  fp32 at 2 blocks with GQA (32 q heads on 8 KV heads), where the tokens
  must agree;
* LLaMA-7B training at full width and 4 blocks (32 would not fit: 16 bytes
  a parameter), batch 4 x seq 2048, the recipe of GPT's, 1 warm-up and 4
  timed steps, a profiled step, the same steps with attention in its plain
  versions, then the slice in fp32 at 2 blocks with GQA against the plain
  CPU path.

Each path is driven with the launch counts set to 0 just before it and
read just after; a kernel its path never launched fails the run. TF32 is
off for matrix products and cuDNN (``allow_tf32 = False``), so fp32 on the
card is fp32. Every phase raises on failure; the script exits non-zero and
prints no result line unless all of them pass. Needs CUDA (exits non-zero
without it) and imports nothing of JAX.

The second line from the end is the ``kernels`` JSON: per kernel, its
launches on the main paths, its error against the plain version, its time,
the plain version's time, the least time the card could take (bound) and
the time of one PyTorch call computing the same function (library_ms, a
yardstick only; the port never calls it). The last line is ``{"ok": true,
"device": {...}}``.
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
# [compare-fa-bwd] limits on the relative Frobenius error of each of dq,
# dk, dv against the plain version: 3x the largest first reading on an
# H100 (bf16 2.76e-4, dv of multi-query 4/1; fp32 2.96e-7)
FA_BWD_REL_LIMIT = {BF16: 8.3e-4, FP32: 9e-7}
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


def _is_flash_kernel(key):
    """A profiler key of the flash kernels (csrc/flash_attention.cuh: the
    forward, the backward and the backward's dq conversion; one family
    runs on each training path)."""
    return any(name in key for name in ("flash_fwd_kernel",
                                        "flash_bwd_kernel",
                                        "dq_convert_kernel"))


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
                 (2, 1024, 8, 128, torch.bfloat16, False)]:  # bidirectional
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
    grew = _grew(before, launch_counts())
    _expect_launches("[train-check]", grew, flash_pair_fwd=2,
                     flash_pair_bwd=2)
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


# ------------------------------------------------------------------ LLaMA


def fa_pairs(lq, lk, causal):
    """Attended (query, key) pairs: all, or the bottom-right-aligned causal
    band (key j visible to row i when j <= i + lk - lq)."""
    if not causal:
        return lq * lk
    seen = torch.arange(lq) + (lk - lq) + 1
    return int(seen.clamp(0, lk).sum())


def fa_bound_ms(b, lq, lk, h, hkv, d, dtype, causal, backward=False):
    """Least time for the [B, L, H, D] attention: the larger of its bytes
    over the memory rate and its matmul operations over the peak rate of
    the input type. Forward: q, k, v read once, out and lse written once;
    2 products of 2*D per attended pair. Backward: q, k, v, out, dO and
    lse read once, dq, dk, dv written once; 5 products of 2*D a pair."""
    esize = torch.finfo(dtype).bits // 8
    q_elems, kv_elems = b * lq * h * d, b * lk * hkv * d
    if backward:
        nbytes = (4 * q_elems + 4 * kv_elems) * esize + b * h * lq * 4
        flops = 10.0 * d * b * h * fa_pairs(lq, lk, causal)
    else:
        nbytes = (2 * q_elems + 2 * kv_elems) * esize + b * h * lq * 4
        flops = 4.0 * d * b * h * fa_pairs(lq, lk, causal)
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


def _sdpa_library(q, k, v, causal):
    """The PyTorch call computing the same function (timed as library_ms
    only; the port never calls it): scaled_dot_product_attention on the
    [B, H, L, D] views with GQA."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=causal, enable_gqa=True)


def phase_compare_fa():
    """flash_attention_fwd vs its plain version: LLaMA-7B's scoring shape
    [2, 2048, 32, 128] and training shape [4, 2048, 32, 128] (bf16,
    causal), GQA (32 q heads on 8 KV heads), multi-query (4 on 1), and
    fp32 ragged Lq = 200, Lk = 300, D = 64 (GQA 4 on 2), causal and
    bidirectional. Inputs as [compare]. The limit on each output element
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
    alignment is the kernel's, Lq == Lk) and the bound. Returns the
    training shape's record."""
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention_fwd, flash_attention_fwd_reference)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)
    record = None
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
        if case == FA_TRAIN_CASE:
            record = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=library_ms)
        del q, k, v, out, lse, ref_out, ref_lse, diff
        torch.cuda.empty_cache()
    return record


def phase_compare_fa_bwd():
    """flash_attention_bwd vs its plain version at the shapes of
    [compare-fa]: per part (dq, dk, dv) the relative Frobenius error
    (limits FA_BWD_REL_LIMIT), dk and dv equal bit for bit between two
    launches (no atomics there) and dq's run-to-run change. At the
    training shape it then times the kernel beside the plain version,
    torch.autograd.grad through the library call and the bound. Returns
    the training shape's record."""
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_reference,
        flash_attention_fwd)
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
        want = flash_attention_bwd_reference(q, k, v, out, lse, g, causal)
        parts, worst_abs = [], 0.0
        for part, x, y in zip(("dq", "dk", "dv"), got, want):
            rel = rel_err(x, y)
            mx = (x.float() - y.float()).abs().max().item()
            worst_abs = max(worst_abs, mx)
            parts.append(f"{part} rel {rel:.3g} max|err| {mx:.3g}")
            if not rel < FA_BWD_REL_LIMIT[dtype]:
                raise AssertionError(
                    f"flash_attention_bwd {part} at {case}: relative error "
                    f"{rel:.3g} >= {FA_BWD_REL_LIMIT[dtype]}")
        if not (torch.equal(got[1], again[1])
                and torch.equal(got[2], again[2])):
            raise AssertionError("flash_attention_bwd: dk/dv differ between "
                                 "two launches on the same inputs")
        dq_jitter = (got[0].float() - again[0].float()).abs().max().item()
        log(f"[compare-fa-bwd] flash_attention_bwd B={b} Lq={lq} Lk={lk} "
            f"H={h} Hkv={hkv} D={d} {str(dtype)[6:]} causal={causal}: "
            f"{'; '.join(parts)} (limit rel {FA_BWD_REL_LIMIT[dtype]}); dq "
            f"run-to-run max|diff| {dq_jitter:.3g}")
        if case == FA_TRAIN_CASE:
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
            log(f"[compare-fa-bwd] at the training shape: kernel {ms:.4f} "
                f"ms, plain {plain_ms:.4f} ms, sdpa backward "
                f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
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


def phase_llama_engine(model, tag="[llama-engine]"):
    """8 requests (a shared 16-token prefix + random tokens, 16-96 prompt
    tokens, 32 new each) through the paged engine at the ENGINE geometry,
    invariants checked after every step."""
    from paddle_tpu_torch.serving import DecodeEngine
    gen = torch.Generator()
    gen.manual_seed(13)
    vocab = LLAMA_7B["vocab_size"]
    prefix = torch.randint(0, vocab, (16,), generator=gen).tolist()
    prompts = [prefix + torch.randint(0, vocab, (n - 16,),
                                      generator=gen).tolist()
               for n in (96, 88, 16, 24, 40, 56, 72, 80)]
    eng = DecodeEngine(model, **ENGINE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reqs = [eng.submit(prompts[0], max_new_tokens=32)]
    steps = 0
    while reqs[0].status != "running":   # publish the shared prefix first
        eng.step()
        eng.check_invariants()
        steps += 1
    reqs += [eng.submit(p, max_new_tokens=32) for p in prompts[1:]]
    while eng.queue_depth or eng.active_count:
        eng.step()
        eng.check_invariants()
        steps += 1
        if steps > 2000:
            raise AssertionError("engine did not drain in 2000 steps")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    bad = [r for r in reqs if r.status != "done" or len(r.tokens) != 32]
    if bad:
        raise AssertionError(f"requests not done: {bad}")
    st = eng.stats()
    if st["paged"]["shared_hits"] < 1:
        raise AssertionError(f"prefix sharing was not hit: {st['paged']}")
    log(f"{tag} {len(reqs)} requests done in {steps} steps, "
        f"{wall:.3f} s: {st['tokens_generated']} tokens, "
        f"{st['tokens_generated'] / wall:.1f} tokens/s; "
        f"{st['decode_steps']} decode steps, {st['prefill_calls']} chunk "
        f"calls; shared_hits {st['paged']['shared_hits']}; peak memory "
        f"{peak_gb:.2f} GB")
    return reqs


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
    requests of [llama-engine], then [llama-crosscheck] at the fp32
    limits (the argmax agrees at >= 0.99 of positions)."""
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_7b
    model = LlamaForCausalLM(llama_7b(num_layers=2, num_kv_heads=8),
                             seed=16).eval()
    reqs = phase_llama_engine(model, tag="[llama-engine-fp32]")
    phase_llama_crosscheck(model, reqs, tag="[llama-crosscheck-fp32]")


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


class _PlainFlashAttention(torch.autograd.Function):
    """``FlashAttention`` with both kernels replaced by their plain
    versions, for the kernel-free witness in ``phase_llama_train_plain``."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        from paddle_tpu_torch.kernels.flash_attention import (
            flash_attention_fwd_reference)
        out, lse = flash_attention_fwd_reference(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        from paddle_tpu_torch.kernels.flash_attention import (
            flash_attention_bwd_reference)
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_attention_bwd_reference(q, k, v, out, lse,
                                               dout.contiguous(),
                                               ctx.causal), None)


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
    fp32, [1, 256], some labels ignored: one forward and backward on the
    card (through both flash_attention kernels) and one on the CPU (the
    plain path) on the same weights. The loss and every leaf's gradient
    agree within TRAIN_CHECK_REL_LIMIT relative (Frobenius per leaf): fp32
    on both sides, so what remains is summation order; the KV projections'
    gradients carry the kernel's sum over each group of 4 q heads."""
    from paddle_tpu_torch.kernels import launch_counts
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_7b
    cfg = llama_7b(num_layers=2, num_kv_heads=8)
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=7)
    card = LlamaForCausalLM(cfg, seed=7)
    card.load_state_dict(cpu.state_dict())
    gen = torch.Generator()
    gen.manual_seed(15)
    ids = torch.randint(0, cfg.vocab_size, (1, 256), generator=gen)
    labels = ids.clone()
    labels[:, :16] = -100
    before = launch_counts()
    _, loss_card = card(ids.cuda(), labels.cuda())
    loss_card.backward()
    torch.cuda.synchronize()
    grew = _grew(before, launch_counts())
    _expect_launches("[llama-train-check]", grew, flash_attention_fwd=2,
                     flash_attention_bwd=2)
    _, loss_cpu = cpu(ids, labels)
    loss_cpu.backward()
    loss_rel = abs(loss_card.item() - loss_cpu.item()) / abs(loss_cpu.item())
    worst_name, worst, kv_worst = None, 0.0, 0.0
    cpu_params = dict(cpu.named_parameters())
    for name, p in card.named_parameters():
        if p.grad is None:
            raise AssertionError(f"{name} got no gradient on the card")
        rel = rel_err(p.grad.cpu(), cpu_params[name].grad)
        if rel > worst:
            worst_name, worst = name, rel
        if name.endswith(("k_proj.weight", "v_proj.weight")):
            kv_worst = max(kv_worst, rel)
    log(f"[llama-train-check] fp32, 2 blocks, GQA 32/8, [1, 256]: loss card "
        f"{loss_card.item():.6f} vs cpu {loss_cpu.item():.6f} (rel "
        f"{loss_rel:.3g}); worst leaf gradient rel {worst:.3g} "
        f"({worst_name}), worst k/v projection {kv_worst:.3g}; limit "
        f"{TRAIN_CHECK_REL_LIMIT}; launches {grew}")
    if not (loss_rel < TRAIN_CHECK_REL_LIMIT
            and worst < TRAIN_CHECK_REL_LIMIT):
        raise AssertionError("the card's loss or gradients disagree with "
                             "the plain CPU path")


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
    from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         LlamaForCausalLM, llama_7b)

    # fp32 products in full fp32 on the card: the plain versions and the
    # train-checks compare fp32 with fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    name, count, smi = phase_card()
    log("[card] TF32 off (torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False)")
    phase_build()
    records = {"flash_pair_fwd": phase_compare(),
               "flash_pair_bwd": phase_compare_bwd()}
    phase_autograd()
    records["flash_attention_fwd"] = phase_compare_fa()
    records["flash_attention_bwd"] = phase_compare_fa_bwd()
    t0 = time.perf_counter()
    model = GPTForCausalLM(GPTConfig(**GPT_MEDIUM), dtype=torch.bfloat16,
                           seed=0).eval()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[model] GPT-medium {n_params / 1e6:.1f} M params, bf16, built in "
        f"{time.perf_counter() - t0:.1f} s")

    paths = {}
    reset_launch_counts()                  # GPT serving starts here
    ids = phase_scoring(model)
    reqs = phase_engine(model)
    paths["gpt-serving"] = launch_counts()     # ... and ends here
    phase_crosscheck(model, reqs)
    phase_scoring_time(model, ids)
    phase_profile(model)
    del model, reqs
    torch.cuda.empty_cache()

    reset_launch_counts()                  # GPT training starts here
    train_model, opt, train_ids, losses = phase_train()
    paths["gpt-training"] = launch_counts()    # ... and ends here
    phase_profile_train(train_model, opt, train_ids)
    del train_model, opt
    torch.cuda.empty_cache()
    phase_train_plain(losses)
    torch.cuda.empty_cache()
    phase_train_check()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    llama = LlamaForCausalLM(llama_7b(), dtype=torch.bfloat16, seed=0).eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in llama.parameters())
    log(f"[llama-model] LLaMA-7B {n_params / 1e9:.3f} B params, bf16, built "
        f"on the card in {time.perf_counter() - t0:.1f} s")
    reset_launch_counts()                  # LLaMA serving starts here
    ids = phase_llama_scoring(llama)
    reqs = phase_llama_engine(llama)
    paths["llama-serving"] = launch_counts()   # ... and ends here
    phase_llama_crosscheck(llama, reqs)
    phase_llama_scoring_time(llama, ids)
    del llama, reqs, ids
    torch.cuda.empty_cache()
    phase_llama_engine_fp32()
    torch.cuda.empty_cache()

    reset_launch_counts()                  # LLaMA training starts here
    llama_model, opt, ids, losses = phase_llama_train()
    paths["llama-training"] = launch_counts()  # ... and ends here
    phase_profile_llama_train(llama_model, opt, ids)
    del llama_model, opt, ids
    torch.cuda.empty_cache()
    phase_llama_train_plain(losses)
    torch.cuda.empty_cache()
    phase_llama_train_check()

    # every kernel of a path ran on it
    needs = {"gpt-serving": ["flash_pair_fwd"],
             "gpt-training": ["flash_pair_fwd", "flash_pair_bwd"],
             "llama-serving": ["flash_attention_fwd"],
             "llama-training": ["flash_attention_fwd",
                                "flash_attention_bwd"]}
    for path, kernels in needs.items():
        for kernel in kernels:
            if paths[path][kernel] < 1:
                raise AssertionError(f"the {path} path never launched "
                                     f"{kernel}")
    log(f"[paths] launches: {paths}")
    launches = {k: sum(p[k] for p in paths.values()) for k in records}
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
                      records["flash_attention_bwd"])]
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
