"""Times variants of the port's fp32 flash forward and backward up to
D = 256 built side by side on one GPU, against the kernels of this
checkout.

    python3 chip_variants.py [variant ...]      # default: every variant

Each variant is a copy of ``paddle_tpu_torch`` under
``smoke_checkout/variants/<name>/`` (gitignored) with one edit to a
header, imported under its own name with its own build directory, as
``chip_smoke.py`` imports the parent's kernels; the builds run in
parallel. Every variant is first held to this checkout's kernel on the
same inputs (a forward's out and lse, a backward's dk and dv, bit for bit
where the variant keeps the summation order, else the fp32 plain
version's limit), then timed in turns with it
(``chip_smoke._timed_pair``: five rounds, best times) at the shapes the
redesign was asked for. The last lines are the card's name and power
limit and one JSON object of the times. Needs CUDA; imports nothing of
JAX.
"""
from __future__ import annotations

import importlib.util
import json
import os
import shutil
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HEADER = "csrc/flash_f32_wide.cuh"
# name: (what it changes, the header line as it is, the line in the
# variant, whether the outputs keep their bits, the direction it changes)
VARIANTS = {
    "padded": ("80 and 96 on the padded 128-column geometry (four score "
               "items of 32)",
               "const int ns = (D + SW - 1) / SW;",
               "const int ns = (D + kW - 1) / kW * (kW / SW);", True, "bwd"),
    "sw32": ("32-column score items at every head size",
             "constexpr int small_sw(int D) { return D % kW ? kH : kW; }",
             "constexpr int small_sw(int D) { return kH; }", True, "bwd"),
    "sw64": ("64-column score items at every head size (80 and 96 in two)",
             "constexpr int small_sw(int D) { return D % kW ? kH : kW; }",
             "constexpr int small_sw(int D) { return kW; }", True, "bwd"),
    "split8": ("clusters of up to 8 CTAs sharing a kv tile's walk",
               "constexpr int kMaxSplit = 4;", "constexpr int kMaxSplit = 8;",
               False, "bwd"),
    "fwd-one-cta": ("the forward at one CTA an SM at every head size (255 "
                    "registers a thread)",
                    "return D <= 128 ? 2 : 1;", "return 1;", True, "fwd"),
}
FP32 = torch.float32
# (tag, launcher, B, L, H, Hkv, D, causal, rate, lengths)
CASES = [("flat-128", "flat", 2, 1024, 8, 2, 128, True, 0.0, False),
         ("flat-64", "flat", 2, 1024, 8, 2, 64, True, 0.0, False),
         ("flat-80", "flat", 2, 1024, 8, 2, 80, True, 0.0, False),
         ("flat-96", "flat", 2, 1024, 8, 2, 96, True, 0.0, False),
         ("flat-256", "flat", 2, 1024, 8, 2, 256, True, 0.0, False),
         ("pair-128", "pair", 2, 1024, 8, 8, 128, True, 0.0, False),
         ("bert-pair", "pair", 2, 512, 12, 12, 64, False, 0.1, False),
         ("bert-flat", "flat", 2, 512, 12, 12, 64, False, 0.1, True),
         ("llama-gqa", "flat", 4, 2048, 32, 8, 128, True, 0.0, False)]


def make_variant(name):
    """The variant's package: a fresh copy with its one edit, imported as
    ``variant_<name>``."""
    _, old, new, _, _ = VARIANTS[name]
    tree = os.path.join(ROOT, "smoke_checkout", "variants", name)
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "paddle_tpu_torch"),
                    os.path.join(tree, "paddle_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(tree, "paddle_tpu_torch", HEADER)
    with open(path) as f:
        src = f.read()
    if src.count(old) != 1:
        raise RuntimeError(f"variant {name}: {old!r} is not in {HEADER}")
    with open(path, "w") as f:
        f.write(src.replace(old, new))
    pkg = os.path.join(tree, "paddle_tpu_torch", "kernels")
    spec = importlib.util.spec_from_file_location(
        f"variant_{name}", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[f"variant_{name}"] = mod
    spec.loader.exec_module(mod)
    return mod


def case_call(case, gen, cs, cur, direction):
    """(inputs' call in ``direction`` for a kernels package, the fp32 plain
    version's outputs: out and lse of the forward, dq, dk, dv of the
    backward)."""
    _, launcher, b, L, h, hkv, d, causal, rate, lens = case
    seed = 11 if rate else None
    if launcher == "flat":
        q, k, v, g = cs._fa_inputs(b, L, L, h, hkv, d, FP32, gen)
        kw = {}
        if lens:
            kw["kv_lens"] = torch.as_tensor(
                cs._bert_pad_lengths(b, L, cs.BERT_PAD_SEED),
                dtype=torch.int32, device="cuda")
        fa = cur.flash_attention
        if direction == "fwd":
            return (lambda m: lambda: m.flash_attention.flash_attention_fwd(
                q, k, v, causal, None, rate, seed=seed, **kw)), \
                fa.flash_attention_fwd_reference(q, k, v, causal, None, rate,
                                                 seed=seed, **kw)
        out, lse = fa.flash_attention_fwd(q, k, v, causal, None, rate,
                                          seed=seed, **kw)
        want = fa.flash_attention_bwd_reference(q, k, v, out, lse, g, causal,
                                                None, rate, seed=seed, **kw)
        return (lambda m: lambda: m.flash_attention.flash_attention_bwd(
            q, k, v, out, lse, g, causal, None, rate, seed=seed, **kw)), want
    qkv, g = cs._bwd_inputs(b, L, h, d, FP32, gen)
    fp = cur.flash_pair
    if direction == "fwd":
        return (lambda m: lambda: m.flash_pair.flash_pair_fwd(
            qkv, h, causal, rate, seed)), \
            fp.flash_pair_fwd_reference(qkv, h, causal, rate, seed)
    out, lse = fp.flash_pair_fwd(qkv, h, causal, rate, seed)
    want = fp.flash_pair_bwd_reference(qkv, out, lse, g, h, causal, rate,
                                       seed)
    hd = h * d
    want = [want[..., i * hd:(i + 1) * hd] for i in range(3)]
    return (lambda m: lambda: [
        x[..., i * hd:(i + 1) * hd] for x in [m.flash_pair.flash_pair_bwd(
            qkv, out, lse, g, h, causal, rate, seed)] for i in range(3)]), want


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_variants: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from paddle_tpu_torch import kernels as cur
    torch.backends.cuda.matmul.allow_tf32 = False
    names = sys.argv[1:] or list(VARIANTS)
    mods = {n: make_variant(n) for n in names}
    jobs = [(cur._build, s) for s in cur._build.SOURCES
            if s.startswith("flash")]
    jobs += [(m._build, f"flash_{launcher}_{VARIANTS[n][4]}")
             for n, m in mods.items() for launcher in ("attention", "pair")]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda j: j[0].build(j[1]), jobs))
    cs.log(f"[variants] {len(jobs)} builds in {time.perf_counter() - t0:.1f} "
           f"s; " + "; ".join(f"{n}: {VARIANTS[n][0]}" for n in names))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    results = {}
    for case in CASES:
        rec = {}
        for n, m in mods.items():
            direction = VARIANTS[n][4]
            call, want = case_call(case, gen, cs, cur, direction)
            base = call(cur)()
            got = call(m)()
            torch.cuda.synchronize()
            rels = [cs.rel_err(x, y) for x, y in zip(got, want)]
            # the bits a variant keeps: out and lse, or dk and dv (dq's
            # reductions change order from run to run)
            kept = zip(got, base) if direction == "fwd" else \
                zip(got[1:], base[1:])
            same = all(torch.equal(x, y) for x, y in kept)
            limit = 1e-4 if direction == "fwd" else cs.FA_BWD_REL_LIMIT[FP32]
            if not (max(rels) < limit and (same or not VARIANTS[n][3])):
                raise AssertionError(f"variant {n} at {case[0]}: rel {rels}, "
                                     f"outputs equal to this checkout's "
                                     f"{same}")
            ours, theirs = cs._timed_pair(call(cur), call(m),
                                          10 if direction == "fwd" else 3)
            rec[n] = theirs[0]
            cs.log(f"[variants] {case[0]} {n}: current {ours[0]:.4f} ms "
                   f"(spread {ours[1]:.3f}), variant {theirs[0]:.4f} ms "
                   f"(spread {theirs[1]:.3f}), {ours[0] / theirs[0]:.3f}x the "
                   f"current speed; rel {'/'.join(f'{r:.3g}' for r in rels)}"
                   f", equal to the current's {same}")
            rec[f"current-{direction}"] = min(
                rec.get(f"current-{direction}", 1e9), ours[0])
            del call, want, base, got
        results[case[0]] = rec
        torch.cuda.empty_cache()
    cs.log(cs.phase_card()[2])
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
