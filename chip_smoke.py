"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from the sources in this checkout,
holds each against its plain PyTorch version at the shapes the main path
gives it, then drives the main path through the user entry points at
GPT-medium width (vocab 50304, hidden 1024, 16 blocks, 8 heads of 128,
bf16, random weights from a seed): the scoring forward, and the paged
DecodeEngine answering 8 requests at the ``bench.py decode --paged``
geometry. Then it checks the engine's tokens against the uncached
forward, times the scoring forward and profiles a serving run (where the
time goes). Every phase raises on failure; the script exits non-zero and
prints no result line unless all of them pass. Needs CUDA (exits non-zero
without it) and imports nothing of JAX.

The second line from the end is the ``kernels`` JSON: per kernel, its
launches on the main path, its error against the plain version, its time,
the plain version's time, the least time the card could take (bound) and
the time of one PyTorch call computing the same function (library_ms,
a yardstick only; the port never calls it). The last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
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
    """Kernel vs plain version: the slice's shape, a ragged fp32 D=64
    case and a bidirectional case. Returns the slice shape's record.

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
             (2, 1024, 8, 128, torch.bfloat16, False)]   # bidirectional
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "GPU", file=sys.stderr)
        return 2
    from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    name, count, smi = phase_card()
    phase_build()
    record = phase_compare()
    t0 = time.perf_counter()
    model = GPTForCausalLM(GPTConfig(**GPT_MEDIUM), dtype=torch.bfloat16,
                           seed=0).eval()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[model] GPT-medium {n_params / 1e6:.1f} M params, bf16, built in "
        f"{time.perf_counter() - t0:.1f} s")

    reset_launch_counts()                  # the main path starts here
    ids = phase_scoring(model)
    reqs = phase_engine(model)
    launches = launch_counts()             # ... and ends here
    if launches["flash_pair_fwd"] < 1:
        raise AssertionError("the main path never launched flash_pair_fwd")
    phase_crosscheck(model, reqs)
    phase_scoring_time(model, ids)
    phase_profile(model)

    kernels = [dict(
        name="flash_pair_fwd", route="cuda",
        source="paddle_tpu_torch/csrc/flash_pair_fwd.cu",
        replaces="paddle_tpu/kernels/pallas/flash_pair.py:95",
        launches=launches["flash_pair_fwd"], **record)]
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
