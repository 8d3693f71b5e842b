"""The port's speculative decoding against the JAX package's, in fp32 on
the CPU, on tiny GPT and LLaMA (GQA) models whose weights come from numpy
through ``convert.load_paddle_state``: the drafters propose what the JAX
drafters propose on the same histories and weights; ``layer_subset``
gives the JAX hidden states; and with every drafter the engine's tokens
are the JAX model's greedy ``generate()`` tokens under prefix sharing,
copy-on-write, chunked prefill and pool-pressure preemption, with the
per-request ledgers summing to ``stats()["spec"]`` and both recompile
sentinels (the engine's and the drafter's) flat in steady state. The test
marked ``cuda`` holds the drafter's captured program (flash kernels in a
CUDA graph) to the same program run eagerly; it skips without a card."""
import gc
import weakref

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu.serving import DraftModelDrafter as JaxDraftModelDrafter
from paddle_tpu.serving import EarlyExitDrafter as JaxEarlyExitDrafter
from paddle_tpu.serving import PromptLookupDrafter as JaxPromptLookupDrafter
from paddle_tpu_torch.convert import load_paddle_state
from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     LlamaForCausalLM, llama_tiny)
from paddle_tpu_torch.serving import (DecodeEngine, DraftModelDrafter,
                                      EarlyExitDrafter, PromptLookupDrafter)

# weights at a scale where context matters, set on the JAX model
from test_torch_generate import _numpy_weights

GPT_TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                max_position_embeddings=64, hidden_dropout_prob=0.0,
                attention_dropout_prob=0.0)
LLAMA_TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                  num_kv_heads=2, intermediate_size=64,
                  max_position_embeddings=64)


def _pair(family, seed, **overrides):
    paddle.seed(seed)
    if family == "gpt":
        cfg = dict(GPT_TINY, **overrides)
        jm = JaxGPT(JaxGPTConfig(use_flash_attention=False, **cfg))
        tm = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
    else:
        cfg = dict(LLAMA_TINY, **overrides)
        jm = JaxLlama(jax_llama_tiny(use_flash_attention=False, **cfg))
        tm = LlamaForCausalLM(llama_tiny(**cfg), device="cpu")
    jm.eval()
    load_paddle_state(tm, _numpy_weights(jm, seed))
    return jm, tm.eval()


@pytest.fixture(scope="module")
def gpt():
    return _pair("gpt", seed=5, num_layers=3)


@pytest.fixture(scope="module")
def llama():
    return _pair("llama", seed=7, num_layers=3)


@pytest.fixture(scope="module")
def draft_gpt():
    """The draft model: ANOTHER random GPT, so its guesses disagree with
    the target's sometimes and the reject path runs."""
    return _pair("gpt", seed=11)


def _drafters(which, target, draft_gpt, ctx_len=16):
    """(the port's drafter, the JAX one) of one kind on the same weights."""
    if which == "prompt_lookup":
        return (PromptLookupDrafter(max_n=3, min_n=1, max_k=8),
                JaxPromptLookupDrafter(max_n=3, min_n=1, max_k=8))
    if which == "draft_model":
        return (DraftModelDrafter(draft_gpt[1], ctx_len=ctx_len, max_k=4),
                JaxDraftModelDrafter(draft_gpt[0], ctx_len=ctx_len, max_k=4))
    return (EarlyExitDrafter(target[1], interval=2, ctx_len=ctx_len,
                             max_k=4),
            JaxEarlyExitDrafter(target[0], interval=2, ctx_len=ctx_len,
                                max_k=4))


def _jax_greedy(jm, prompt, n):
    ids = np.asarray([prompt], np.int32)
    out = jm.generate(paddle.to_tensor(ids), max_new_tokens=n).numpy()
    return out[0, len(prompt):].tolist()


class _Hist:
    def __init__(self, prompt, tokens=()):
        self.prompt, self.tokens = list(prompt), list(tokens)
        self.drafter_state = None


def test_prompt_lookup_proposes_continuations():
    """The JAX package's unit cases, and the JAX drafter's answers."""
    d, jd = PromptLookupDrafter(max_n=3, min_n=1, max_k=8), \
        JaxPromptLookupDrafter(max_n=3, min_n=1, max_k=8)
    cases = [(_Hist([1, 2, 3, 4, 2, 3]), 8, [4, 2, 3]),
             (_Hist([1, 2, 3, 4, 2, 3]), 2, [4, 2]),       # k clamp
             (_Hist([1, 2, 3, 4, 2, 3]), 0, []),
             (_Hist([1, 2, 3]), 4, []),                    # no match
             (_Hist([9, 8], [7, 9, 8]), 4, [7, 9, 8])]     # across tokens
    for req, k, want in cases:
        assert d.propose(req, k) == jd.propose(req, k) == want
    with pytest.raises(ValueError):
        PromptLookupDrafter(max_n=1, min_n=2)


def test_spec_requires_paged_and_greedy(gpt):
    _, tm = gpt
    with pytest.raises(NotImplementedError, match="paged=True"):
        DecodeEngine(tm, max_slots=2, max_len=32, paged=False,
                     prefill_buckets=[8], drafter=PromptLookupDrafter())
    with pytest.raises(NotImplementedError, match="greedy"):
        DecodeEngine(tm, max_slots=2, max_len=32, block_size=8,
                     prefill_chunk=8, do_sample=True,
                     drafter=PromptLookupDrafter())
    with pytest.raises(ValueError, match="interval"):
        EarlyExitDrafter(tm, interval=0)
    with pytest.raises(ValueError, match="ctx_len"):
        DraftModelDrafter(tm, ctx_len=1)


@pytest.mark.parametrize("which", ["prompt_lookup", "draft_model",
                                   "early_exit"])
def test_drafter_proposals_match_jax(which, gpt, draft_gpt):
    """The same histories (short, and longer than the window, so it
    slides) give the JAX drafter's proposals; a model drafter builds one
    program, ever."""
    d, jd = _drafters(which, gpt, draft_gpt, ctx_len=12)
    rs = np.random.RandomState(21)
    for n_prompt, n_tok in ((3, 0), (10, 2), (9, 8), (30, 5)):
        prompt = rs.randint(1, 64, n_prompt).tolist()
        if which == "prompt_lookup":             # give the lookup a match
            prompt = prompt + prompt[:4]
        req = _Hist(prompt, rs.randint(1, 64, n_tok).tolist())
        for k in (1, 4):
            assert d.propose(req, k) == jd.propose(req, k), (n_prompt, k)
    if which != "prompt_lookup":
        assert d.compile_count == 1 and d.calls == 4 * (1 + 4)


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_layer_subset_matches_jax(family, gpt, llama):
    jm, tm = gpt if family == "gpt" else llama
    jb, tb = (jm.gpt, tm.gpt) if family == "gpt" else (jm.model, tm.model)
    ids = np.random.RandomState(4).randint(1, 64, (2, 11))
    for subset in ({0, 2}, {1}, frozenset(range(3))):
        want = np.asarray(jb(paddle.to_tensor(ids.astype(np.int32)),
                             layer_subset=subset).numpy())
        with torch.no_grad():
            got = tb(torch.from_numpy(ids), layer_subset=subset).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        full = tb(torch.from_numpy(ids)).numpy()
        again = tb(torch.from_numpy(ids), layer_subset={0, 1, 2}).numpy()
    np.testing.assert_array_equal(full, again)
    with pytest.raises(ValueError, match="uncached"):
        tb(torch.from_numpy(ids), kv_caches=[], layer_subset={0})


def _check_spec(eng, reqs, drafter):
    st = eng.stats()
    spec = st["spec"]
    assert spec["drafter"] == drafter.name
    assert spec["steps"] > 0 and spec["emitted"] >= spec["steps"]
    assert spec["accepted"] <= spec["drafted"]
    assert spec["width"] == min(max(2, drafter.max_k + 1), eng.max_len)
    # the per-request ledgers sum to the engine's
    assert sum(r.spec_drafted for r in reqs) == spec["drafted"]
    assert sum(r.spec_accepted for r in reqs) == spec["accepted"]
    eng.check_invariants()
    return st


@pytest.mark.parametrize("which", ["prompt_lookup", "draft_model",
                                   "early_exit"])
def test_spec_parity_gpt_full_machinery(which, gpt, draft_gpt):
    """GPT through the speculative engine: the JAX model's greedy tokens
    under sharing, copy-on-write and chunked prefill, for every
    drafter."""
    jm, tm = gpt
    drafter, _ = _drafters(which, gpt, draft_gpt)
    rng = np.random.RandomState(0)
    prefix = rng.randint(1, 64, 10).tolist()
    prompts = [prefix + [50, 51, 52], prefix + [50, 51, 52],  # share + COW
               rng.randint(1, 64, 20).tolist(),               # chunked
               prefix[:5] * 3]                                # repetitive
    horizons = [8, 8, 6, 10]
    eng = DecodeEngine(tm, max_slots=4, max_len=48, block_size=8,
                       prefill_chunk=8, drafter=drafter)
    lead = eng.submit(prompts[0], max_new_tokens=horizons[0])
    # one step can take a request from prefilling straight to done
    while lead.status in ("queued", "prefilling"):
        eng.step()
    reqs = [lead] + [eng.submit(p, max_new_tokens=h)
                     for p, h in zip(prompts[1:], horizons[1:])]
    eng.run()
    for p, r, h in zip(prompts, reqs, horizons):
        assert r.status == "done", r
        assert list(r.output_tokens) == _jax_greedy(jm, p, h), p
    st = _check_spec(eng, reqs, drafter)
    assert st["paged"]["shared_hits"] >= 1
    assert st["paged"]["cow_copies"] >= 1
    assert all(r.drafter_state is not None for r in reqs)


@pytest.mark.parametrize("which", ["prompt_lookup", "draft_model",
                                   "early_exit"])
def test_spec_parity_llama_with_sharing(which, llama, draft_gpt):
    """LLaMA (GQA + RoPE) through the speculative engine with prefix
    sharing; the draft-model arm drafts with a GPT (only token ids cross
    the interface)."""
    jm, tm = llama
    drafter, _ = _drafters(which, llama, draft_gpt)
    rng = np.random.RandomState(7)
    prefix = rng.randint(1, 64, 10).tolist()
    pa, pb = prefix + [7], prefix + [9]
    eng = DecodeEngine(tm, max_slots=2, max_len=32, block_size=4,
                       prefill_chunk=4, drafter=drafter)
    ra = eng.submit(pa, max_new_tokens=6)
    while ra.status in ("queued", "prefilling"):
        eng.step()
    rb = eng.submit(pb, max_new_tokens=6)
    eng.run()
    assert eng.stats()["paged"]["shared_hits"] >= 1
    for p, r in zip((pa, pb), (ra, rb)):
        assert r.status == "done"
        assert list(r.output_tokens) == _jax_greedy(jm, p, 6)
    _check_spec(eng, [ra, rb], drafter)


def test_spec_parity_across_preemption(gpt):
    """Pool pressure with speculation on: re-admission restarts the
    drafter state with the token history and the tokens stay the JAX
    model's; the ledgers still sum to the engine's."""
    jm, tm = gpt
    drafter = PromptLookupDrafter()
    eng = DecodeEngine(tm, max_slots=4, max_len=48, block_size=8,
                       kv_blocks=9, prefill_chunk=8, drafter=drafter)
    rng = np.random.RandomState(6)
    prompts = [rng.randint(1, 64, 20).tolist() for _ in range(4)]
    reqs = [eng.submit(p, max_new_tokens=20) for p in prompts]
    eng.run(max_steps=600)
    assert eng.preemptions > 0
    for p, r in zip(prompts, reqs):
        assert r.status == "done"
        assert list(r.output_tokens) == _jax_greedy(jm, p, 20)
    _check_spec(eng, reqs, drafter)


def test_spec_zero_steady_state_recompiles(gpt):
    """After warm-up a churn wave (sharing, copy-on-write, fresh blocks,
    chunking) builds nothing: the engine's count (chunk + verify) and the
    drafter's (its one program) stay flat."""
    _, tm = gpt
    drafter = EarlyExitDrafter(tm, interval=2, ctx_len=32, max_k=4)
    eng = DecodeEngine(tm, max_slots=4, max_len=48, block_size=8,
                       prefill_chunk=8, drafter=drafter)
    warm = eng.submit([1, 2, 3], max_new_tokens=4)
    eng.run()
    assert warm.status == "done"
    assert drafter.compile_count == 1 and eng.compile_count == 2
    base = eng.compile_count
    rng = np.random.RandomState(1)
    shared = rng.randint(1, 64, 12).tolist()
    reqs = []
    for i in range(8):
        p = shared + rng.randint(1, 64, rng.randint(1, 4)).tolist() \
            if i % 2 == 0 else rng.randint(1, 64, rng.randint(2, 20)).tolist()
        reqs.append(eng.submit(p, max_new_tokens=int(rng.randint(2, 8))))
        eng.step()
    eng.run()
    assert all(r.status == "done" for r in reqs)
    assert eng.compile_count == base, \
        f"spec steady state built {eng.compile_count - base} programs"
    assert drafter.compile_count == 1, "the drafter rebuilt its program"
    eng.check_invariants()


def test_dropped_speculative_engine_and_drafter_are_freed(gpt):
    """The drafter's program holds its drafter weakly, as the engine's
    programs hold the engine: both go with their last reference, the
    cycle collector off."""
    _, tm = gpt
    drafter = EarlyExitDrafter(tm, interval=2, ctx_len=16, max_k=4)
    eng = DecodeEngine(tm, max_slots=2, max_len=32, block_size=8,
                       prefill_chunk=8, drafter=drafter)
    eng.submit([1, 2, 3], max_new_tokens=6)
    eng.run()
    assert drafter.compile_count == 1 and drafter.calls > 0
    refs = weakref.ref(eng), weakref.ref(drafter)
    gc.disable()
    try:
        del eng, drafter
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_cuda_drafter_graph_runs_the_flash_kernels(family):
    """On the card the drafter's [1, 64] program is a CUDA graph whose
    forward runs the flash kernels (rows 1 and 4) at a window of 64: the
    capture calls each kernel once a block, the replays give the eager
    program's drafts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    if family == "gpt":
        m = GPTForCausalLM(GPTConfig(**dict(
            GPT_TINY, hidden_size=256, num_heads=2, num_layers=2,
            max_position_embeddings=128)), dtype=torch.bfloat16).eval()
        kernel = "flash_pair_fwd"
    else:
        m = LlamaForCausalLM(llama_tiny(**dict(
            LLAMA_TINY, hidden_size=512, num_heads=4, num_kv_heads=2,
            max_position_embeddings=128)), dtype=torch.bfloat16).eval()
        kernel = "flash_attention_fwd"
    req = _Hist(np.random.RandomState(3).randint(1, 64, 40).tolist())
    graphed = DraftModelDrafter(m, ctx_len=64, max_k=4)
    eager = DraftModelDrafter(m, ctx_len=64, max_k=4)
    eager._program()._reg.capture = False
    reset_launch_counts()
    want = eager.propose(req, 4)
    assert launch_counts()[kernel] == 4 * 2          # 4 calls x 2 blocks
    reset_launch_counts()
    got = graphed.propose(req, 4)
    torch.cuda.synchronize()
    # the first call runs eagerly, then is captured: 2 calls' launches in
    # Python, and 3 replays that add none
    assert launch_counts()[kernel] == 2 * 2 and graphed.calls == 4
    assert got == want and graphed.compile_count == 1
