"""The port's paged DecodeEngine and BlockPager against the JAX package's,
in fp32 on the CPU: on the same tiny weights and the same submit/step
schedule the port's engine must give each request the greedy tokens of
the JAX model (the argmax of its uncached forward at every generated
position) and the JAX engine's scheduling decisions, under prefix
sharing, copy-on-write and pool-pressure preemption, with fixed chunks
and with whole-prompt buckets (``prefill_chunk=None``, where the tokens
are the JAX engine's too); ``compile_count`` (the programs built, CUDA
graphs on the card) stays flat under slot churn; and the two pagers must
make the same allocation decisions under a seeded random op mix.

The tokens are held to the JAX model rather than to the JAX engine: the
JAX engine's decode step writes every non-decoding row at position 0
through the slot's real block table, so a slot mid-prefill beside a live
one gets its first position (or a shared prefix block) overwritten, and
its later tokens drift. The port's engine gives those rows the trash
block (``test_decode_leaves_prefilling_blocks_alone``)."""
import gc
import weakref

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.serving import BlockPager as JaxBlockPager
from paddle_tpu.serving import DecodeEngine as JaxDecodeEngine
from paddle_tpu_torch.convert import load_paddle_state
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.serving import BlockPager, DecodeEngine

TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
            max_position_embeddings=64, hidden_dropout_prob=0.0,
            attention_dropout_prob=0.0)
GEOM = dict(max_slots=4, max_len=48, block_size=8, prefill_chunk=8)


def _spread_weights(jm, seed):
    """Give the JAX model weights at a scale where context matters and
    return them as numpy: matrices ~ N(0, 1/fan_in), so every block adds
    O(1) to the residual stream, embeddings ~ N(0, 0.2^2), so the token's
    own embedding does not drown the attention, and LayerNorm weights and
    biases near their init. At the GPT-3 init (std 0.02) a tiny model
    mostly repeats its last token, so a broken cache or block copy could
    still give the same tokens."""
    rs = np.random.RandomState(seed)
    params = {}
    for name, p in jm.named_parameters():
        shape = tuple(p.shape)
        if name.endswith(("wte.weight", "wpe.weight")):
            a = rs.normal(0.0, 0.2, shape)
        elif len(shape) == 2:                      # paddle Linear: [in, out]
            a = rs.normal(0.0, 1.0 / np.sqrt(shape[0]), shape)
        elif name.endswith("bias"):
            a = rs.normal(0.0, 0.1, shape)
        else:
            a = 1.0 + rs.normal(0.0, 0.1, shape)
        a = a.astype(np.float32)
        p.set_value(a)
        params[name] = a
    return params


def _model_pair(seed=5):
    paddle.seed(seed)
    jm = JaxGPT(JaxGPTConfig(use_flash_attention=False, **TINY))
    jm.eval()
    params = _spread_weights(jm, seed=seed)
    tm = GPTForCausalLM(GPTConfig(**TINY), device="cpu")
    load_paddle_state(tm, params)
    tm.eval()
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _model_pair()


@pytest.fixture(scope="module")
def row_models():
    """The row-cache tests' own pair: the tests above leave ``models``'s
    final LayerNorm bias at zero after poisoning it."""
    return _model_pair()


def _schedule(kind):
    """(step, prompt, max_new) triples: the step index at which each
    request is submitted."""
    rng = np.random.RandomState(42)
    prefix = rng.randint(1, 64, 16).tolist()
    if kind == "sharing":
        same = prefix + [7, 9, 11]
        return [(0, prefix + [50], 6), (0, same, 8),
                (3, prefix + [51, 52], 5),        # adopts the live prefix
                (3, same, 8),                     # identical prompt: COW
                (6, rng.randint(1, 64, 10).tolist(), 4),
                (30, same, 6)]                    # revives parked blocks
    # "preemption": 8 usable blocks cannot hold four 40-token tenants
    return [(0, prefix[:8] + rng.randint(1, 64, 12).tolist(), 20)
            for _ in range(4)]


def greedy_from(jax_model, req):
    """The JAX model's greedy continuation of ``req.prompt`` judged on
    ``req``'s own tokens: the argmax of the uncached forward over prompt +
    tokens at every generated position."""
    seq = np.asarray([list(req.prompt) + list(req.output_tokens)], np.int32)
    logits = np.asarray(jax_model(paddle.to_tensor(seq)).numpy())[0]
    n = len(req.prompt)
    return logits[n - 1:n - 1 + len(req.output_tokens)].argmax(-1).tolist()


def _drive(engine, sched, check):
    reqs, step = [], 0
    pending = list(sched)
    while pending or engine.queue_depth or engine.active_count:
        while pending and pending[0][0] <= step:
            _, prompt, n = pending.pop(0)
            reqs.append(engine.submit(prompt, max_new_tokens=n))
        engine.step()
        check()
        step += 1
        assert step < 600
    return reqs


@pytest.mark.parametrize("kind,kv_blocks", [("sharing", None),
                                            ("preemption", 9)])
def test_engine_greedy_parity_with_jax(models, kind, kv_blocks):
    jm, tm = models
    sched = _schedule(kind)
    jeng = JaxDecodeEngine(jm, kv_blocks=kv_blocks, **GEOM)
    teng = DecodeEngine(tm, kv_blocks=kv_blocks, **GEOM)
    jreqs = _drive(jeng, sched, jeng._pager.check_invariants)
    treqs = _drive(teng, sched, teng.check_invariants)
    for jr, tr in zip(jreqs, treqs):
        assert jr.status == tr.status == "done", (jr, tr)
        assert len(tr.output_tokens) == len(jr.output_tokens)
        assert list(tr.output_tokens) == greedy_from(jm, tr), tr.prompt
        assert tr.preemptions == jr.preemptions
    jst, tst = jeng.stats()["paged"], teng.stats()["paged"]
    for key in ("shared_hits", "shared_tokens", "cow_copies", "prefix_hits",
                "preemptions"):
        assert tst[key] == jst[key], key
    if kind == "sharing":
        assert tst["shared_hits"] >= 3 and tst["cow_copies"] >= 1
        assert tst["prefix_hits"] >= 1
    else:
        assert tst["preemptions"] > 0


@pytest.mark.parametrize("kind,kv_blocks", [("sharing", None),
                                            ("preemption", 9)])
def test_bucketed_engine_parity_with_jax(models, kind, kv_blocks):
    """prefill_chunk=None: each prompt prefills in one call of its bucket
    (sized by the whole prompt, shared or not); the port gives the JAX
    engine's tokens, statuses and scheduling."""
    jm, tm = models
    sched = _schedule(kind)
    geom = dict(GEOM, prefill_chunk=None)
    jeng = JaxDecodeEngine(jm, kv_blocks=kv_blocks, **geom)
    teng = DecodeEngine(tm, kv_blocks=kv_blocks, **geom)
    assert teng.prefill_buckets == jeng.prefill_buckets == [8, 16, 32, 48]
    jreqs = _drive(jeng, sched, jeng._pager.check_invariants)
    treqs = _drive(teng, sched, teng.check_invariants)
    for jr, tr in zip(jreqs, treqs):
        assert jr.status == tr.status == "done", (jr, tr)
        assert list(tr.output_tokens) == list(jr.output_tokens), tr.prompt
        assert list(tr.output_tokens) == greedy_from(jm, tr), tr.prompt
        assert tr.preemptions == jr.preemptions
        assert tr.prefill_chunks == jr.prefill_chunks == 1
    jst, tst = jeng.stats()["paged"], teng.stats()["paged"]
    for key in ("shared_hits", "shared_tokens", "cow_copies", "prefix_hits",
                "preemptions"):
        assert tst[key] == jst[key], key
    # one program per bucket the prompts reached, and the decode step
    assert teng.compile_count == jeng.compile_count


def test_bucketed_prompt_too_long_fails_alone(models):
    jm, tm = models
    eng = DecodeEngine(tm, max_slots=4, max_len=48, block_size=8,
                       prefill_buckets=[8, 16])
    rs = np.random.RandomState(3)
    reqs = [eng.submit(rs.randint(1, 64, n).tolist(), max_new_tokens=6)
            for n in (5, 20, 12)]
    assert reqs[1].status == "failed" and "prefill bucket" in reqs[1].error
    eng.run()
    for req in (reqs[0], reqs[2]):
        assert req.status == "done"
        assert list(req.output_tokens) == greedy_from(jm, req)
    assert eng.compile_count == 3           # buckets 8 and 16, decode


@pytest.mark.parametrize("chunk", [None, 4])
def test_zero_recompile_under_slot_churn(models, chunk):
    """The JAX gate: once the programs are built, a decode window with
    staggered admissions and evictions of varying prompt lengths and
    token budgets builds nothing new."""
    _, tm = models
    eng = DecodeEngine(tm, max_slots=4, max_len=48, prefill_buckets=[8],
                       prefill_chunk=chunk)
    eng.submit([1, 2, 3], max_new_tokens=2)     # builds the chunk + decode
    eng.run()
    base = eng.compile_count
    assert base == 2 == eng.stats()["compile_count"]
    rng = np.random.RandomState(0)
    reqs = []
    for _ in range(10):          # staggered arrivals: submit-then-step
        reqs.append(eng.submit(rng.randint(1, 64, rng.randint(2, 8)).tolist(),
                               max_new_tokens=int(rng.randint(2, 7))))
        eng.step()
    eng.run()
    assert all(r.status == "done" for r in reqs)
    assert eng.compile_count == base, \
        f"steady-state decode rebuilt {eng.compile_count - base} programs"
    assert eng.live_count == 0 and eng.queue_depth == 0


def test_new_parameter_storage_rebuilds_programs(models):
    """A parameter given new storage rebuilds (and counts) the programs
    it reads at their next call; an in-place update does not."""
    jm, tm = models
    eng = DecodeEngine(tm, **GEOM)
    req = eng.submit(list(range(1, 7)), max_new_tokens=12)
    for _ in range(3):
        eng.step()
    assert eng.compile_count == 2
    with torch.no_grad():
        tm.gpt.ln_f.weight.mul_(1.0)
    eng.step()
    assert eng.compile_count == 2
    old = tm.gpt.ln_f.weight.data
    try:
        tm.gpt.ln_f.weight.data = old.clone()
        eng.step()
        assert eng.compile_count == 3       # the decode program, once
        eng.run()
    finally:
        tm.gpt.ln_f.weight.data = old
    assert req.status == "done"
    assert list(req.output_tokens) == greedy_from(jm, req)


def test_copy_on_write_pairs_beyond_the_program_raise(models):
    _, tm = models
    eng = DecodeEngine(tm, **GEOM)
    ids = np.zeros((1, 8), np.int64)
    with pytest.raises(RuntimeError, match="copy-on-write"):
        eng._chunk_call([(1, 2)] * (GEOM["max_slots"] + 1), 0, ids, 0, 4)


def test_decode_leaves_prefilling_blocks_alone(models):
    """A decode step beside a slot that is mid-prefill (not live, at
    position 0, but owning blocks) writes nothing into that slot's blocks:
    its row goes to the trash block."""
    _, tm = models
    eng = DecodeEngine(tm, **GEOM)
    live = eng.submit(list(range(1, 6)), max_new_tokens=20)
    while live.status != "running":
        eng.step()
    eng.submit(list(range(10, 30)), max_new_tokens=4)   # 3 chunks of 8
    assert eng._try_admit(eng._queue.pop())
    slot = next(iter(eng._prefilling))
    eng._advance_prefill(slot, [])                      # chunk 1 of 3
    first = int(eng._pager.tables[slot, 0])
    before = [(pk[first].clone(), pv[first].clone()) for pk, pv in eng._pools]
    eng._decode([])                # the live slot decodes one token
    eng.check_invariants()
    for (pk, pv), (k0, v0) in zip(eng._pools, before):
        assert torch.equal(pk[first], k0) and torch.equal(pv[first], v0)


def test_engine_cancel_and_nonfinite_logits(models):
    _, tm = models
    eng = DecodeEngine(tm, **GEOM)
    a = eng.submit([1, 2, 3, 4, 5], max_new_tokens=10)
    b = eng.submit([6, 7, 8], max_new_tokens=10)
    c = eng.submit([9, 10], max_new_tokens=10)
    eng.step()
    eng.step()
    assert eng.cancel(b) and not eng.cancel(b)
    assert eng.cancel(c.id)
    done = eng.step()
    assert {r.status for r in done} >= {"cancelled"}
    eng.check_invariants()
    # poison the weights: every logit goes non-finite, the slot fails alone
    with torch.no_grad():
        tm.gpt.ln_f.bias.fill_(float("nan"))
    try:
        eng.run(max_steps=50)
    finally:
        with torch.no_grad():
            tm.gpt.ln_f.bias.zero_()
    assert a.status == "failed" and "non-finite" in a.error
    assert eng.nan_logits == 1
    eng.check_invariants()


def _row_schedule():
    """Staggered arrivals of varying prompt lengths (2 to 30 tokens, every
    bucket) and token budgets, more requests than slots."""
    rng = np.random.RandomState(17)
    return [(i // 2, rng.randint(1, 64, n).tolist(), int(rng.randint(3, 12)))
            for i, n in enumerate((5, 12, 30, 2, 16, 9, 23, 7))]


def test_row_cache_parity_with_jax_and_paged(row_models):
    """paged=False: each slot owns a row, each prompt prefills in one call
    of its bucket at admission. The tokens are the JAX model's greedy
    tokens and the paged engine's, one program per bucket used plus the
    decode step."""
    jm, tm = row_models
    row = DecodeEngine(tm, max_slots=4, max_len=48, paged=False)
    paged = DecodeEngine(tm, **GEOM)
    assert row.prefill_buckets == [8, 16, 32, 48]
    assert row.block_size is None and row.prefill_chunk is None
    rreqs = _drive(row, _row_schedule(), row.check_invariants)
    preqs = _drive(paged, _row_schedule(), paged.check_invariants)
    for rr, pr in zip(rreqs, preqs):
        assert rr.status == pr.status == "done", (rr, pr)
        assert list(rr.output_tokens) == greedy_from(jm, rr), rr.prompt
        assert list(rr.output_tokens) == list(pr.output_tokens)
        assert rr.prefill_chunks == 1
    assert row.compile_count == 3 + 1       # buckets 8, 16, 32 + decode
    assert row.prefill_calls == len(rreqs)
    assert row.stats()["kv_util"] == 0.0 and row.live_count == 0


def test_row_cache_matches_jax_row_engine(row_models):
    """The JAX engine's row cache on the same schedule: the same tokens
    and the same number of programs."""
    jm, tm = row_models
    jeng = JaxDecodeEngine(jm, max_slots=4, max_len=48, paged=False,
                           prefill_buckets=[8, 32])
    teng = DecodeEngine(tm, max_slots=4, max_len=48, paged=False,
                        prefill_buckets=[8, 32])
    sched = [(t, p, n) for t, p, n in _row_schedule() if len(p) <= 32]
    jreqs = _drive(jeng, sched, lambda: None)
    treqs = _drive(teng, sched, teng.check_invariants)
    for jr, tr in zip(jreqs, treqs):
        assert jr.status == tr.status == "done"
        assert list(tr.output_tokens) == list(jr.output_tokens), tr.prompt
    assert teng.compile_count == jeng.compile_count == 3
    assert "paged" not in teng.stats() and "paged" not in jeng.stats()


def test_row_cache_llama_matches_jax():
    """LLaMA (GQA: the rows are sized by the KV head count) on the row
    cache: the JAX row engine's tokens, which are its model's greedy
    tokens."""
    from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
    cfg = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
               num_kv_heads=2, intermediate_size=64,
               max_position_embeddings=64)
    paddle.seed(7)
    jm = JaxLlama(jax_llama_tiny(use_flash_attention=False, **cfg))
    jm.eval()
    rs = np.random.RandomState(7)
    params = {}
    for name, p in jm.named_parameters():
        scale = 1.0 / np.sqrt(p.shape[0]) if len(p.shape) == 2 else 0.1
        a = rs.normal(1.0 if len(p.shape) == 1 else 0.0, scale,
                      tuple(p.shape)).astype(np.float32)
        p.set_value(a)
        params[name] = a
    tm = LlamaForCausalLM(llama_tiny(**cfg), device="cpu")
    load_paddle_state(tm, params)
    tm.eval()
    geom = dict(max_slots=2, max_len=32, paged=False, prefill_buckets=[8, 16])
    jeng, teng = JaxDecodeEngine(jm, **geom), DecodeEngine(tm, **geom)
    assert tuple(teng._rows.shape) == (2, 2, 2, 32, 2, 8)
    sched = [(t, p, n) for t, p, n in _row_schedule() if len(p) <= 16]
    sched = [(t, p, min(n, 32 - len(p))) for t, p, n in sched]
    jreqs = _drive(jeng, sched, lambda: None)
    treqs = _drive(teng, sched, teng.check_invariants)
    for jr, tr in zip(jreqs, treqs):
        assert jr.status == tr.status == "done"
        assert list(tr.output_tokens) == list(jr.output_tokens), tr.prompt
    assert teng.compile_count == jeng.compile_count == 3


def test_row_cache_rejects_what_it_cannot_serve(row_models):
    _, tm = row_models
    with pytest.raises(ValueError, match="prefill_chunk requires paged"):
        DecodeEngine(tm, max_slots=2, max_len=48, paged=False,
                     prefill_chunk=8)
    eng = DecodeEngine(tm, max_slots=2, max_len=48, paged=False,
                       prefill_buckets=[8, 16])
    long = eng.submit(list(range(1, 21)), max_new_tokens=4)
    assert long.status == "failed" and "prefill bucket" in long.error
    assert eng.queue_depth == 0 and eng.compile_count == 0
    for bad in ([], [1] * 48):
        assert eng.submit(bad, max_new_tokens=2).status == "failed"


def test_row_cache_nonfinite_prefill_fails_alone(row_models):
    """A NaN in the position table past a short request's reach poisons
    only the prefill of a longer prompt: that request fails alone, its
    slot is freed, and the short one streams on to the greedy tokens."""
    jm, tm = row_models
    eng = DecodeEngine(tm, max_slots=2, max_len=48, paged=False)
    short = eng.submit([3, 1, 4, 1, 5], max_new_tokens=6)
    eng.step()
    assert short.status == "running"
    saved = tm.gpt.wpe.weight.data[20:].clone()
    with torch.no_grad():
        tm.gpt.wpe.weight[20:] = float("nan")
    try:
        long = eng.submit(list(range(1, 25)), max_new_tokens=4)
        eng.run(max_steps=20)
    finally:
        with torch.no_grad():
            tm.gpt.wpe.weight[20:] = saved
    assert long.status == "failed" and "non-finite" in long.error
    assert short.status == "done"
    assert list(short.output_tokens) == greedy_from(jm, short)
    assert eng.nan_logits == 1 and eng.live_count == 0
    eng.check_invariants()


def test_row_cache_cancel_and_stats(row_models):
    _, tm = row_models
    eng = DecodeEngine(tm, max_slots=2, max_len=48, paged=False)
    a = eng.submit([1, 2, 3], max_new_tokens=10)
    b = eng.submit([4, 5, 6, 7], max_new_tokens=10)
    c = eng.submit([8, 9], max_new_tokens=10)         # queued: 2 slots
    eng.step()
    assert a.status == b.status == "running" and c.status == "queued"
    util = eng.kv_util()
    assert util == (len(a.prompt) + 1 + len(b.prompt) + 1) / (2 * 48)
    assert eng.cancel(b) and eng.cancel(c.id) and not eng.cancel(c)
    done = eng.step()
    assert {r.status for r in done} == {"cancelled"} and len(done) == 2
    eng.check_invariants()
    eng.run()
    assert a.status == "done" and eng.cancelled == 2
    st = eng.stats()
    assert "paged" not in st and "spec" not in st
    assert st["compile_count"] == 2 and st["executables"] == 2


@pytest.mark.parametrize("paged", [True, False])
def test_dropped_engine_is_freed_without_the_collector(models, paged):
    """An engine's programs hold it weakly: dropping the last reference
    frees the engine, its caches and its programs at once, with the cycle
    collector off (the float weights an int8 swap replaced among them)."""
    _, tm = models
    kw = dict(GEOM) if paged else dict(max_slots=4, max_len=48, paged=False)
    eng = DecodeEngine(tm, **kw)
    eng.submit([1, 2, 3], max_new_tokens=4)
    eng.run()
    assert eng.compile_count == 2
    ref = weakref.ref(eng)
    gc.disable()
    try:
        del eng
        assert ref() is None
    finally:
        gc.enable()


def test_engine_rejects_malformed_requests(models):
    _, tm = models
    eng = DecodeEngine(tm, **GEOM)
    assert eng.submit([], max_new_tokens=2).status == "failed"
    assert eng.submit([1] * 48, max_new_tokens=2).status == "failed"
    assert eng.submit([1, 2], max_new_tokens=47).status == "failed"
    assert eng.submit([1, 2], max_new_tokens=0).status == "failed"
    assert eng.queue_depth == 0


def test_pager_matches_jax_under_random_ops():
    rng = np.random.RandomState(123)
    nb, bs, slots, mbs = 12, 4, 4, 6
    jp, tp = JaxBlockPager(nb, bs, slots, mbs), BlockPager(nb, bs, slots, mbs)
    families = [rng.randint(1, 30, 9).tolist() for _ in range(3)]
    pos = [None] * slots          # cached length per live slot

    def both(name, *args):
        a = getattr(jp, name)(*args)
        b = getattr(tp, name)(*args)
        assert a == b, (name, args, a, b)
        return a

    for _ in range(1500):
        slot = int(rng.randint(slots))
        op = rng.rand()
        if pos[slot] is None:
            if op < 0.05:
                both("drop_prefix_cache")
                continue
            fam = families[rng.randint(len(families))]
            prompt = fam[:rng.randint(3, 10)] + rng.randint(
                1, 30, rng.randint(0, 4)).tolist()
            cov = both("share_prefix", slot, prompt)
            if both("ensure_writable", slot, cov, len(prompt)) is None:
                both("release_slot", slot)
            else:
                both("register_prompt", slot, prompt)
                pos[slot] = len(prompt)
        elif op < 0.25:
            both("release_slot", slot)
            pos[slot] = None
        elif op < 0.5:
            k = int(rng.randint(1, 4))
            if pos[slot] + k <= mbs * bs and \
                    both("ensure_writable", slot, pos[slot],
                         pos[slot] + k) is not None:
                pos[slot] += k
        else:
            k = int(rng.randint(1, 4))
            if pos[slot] + k <= mbs * bs:
                cov, _, res = both("reserve_speculative", slot, pos[slot],
                                   pos[slot] + k)
                keep = pos[slot] + int(rng.randint(0, cov - pos[slot] + 1))
                both("rollback_speculative", slot, keep, res)
                pos[slot] = keep
        np.testing.assert_array_equal(tp.tables, jp.tables)
        tp.check_invariants()
    assert tp.stats().as_dict() == jp.stats().as_dict()
    # the mix really exercised COW, LRU revival and LRU reclamation
    assert tp.cow_copies > 0 and tp.prefix_hits > 0 and tp.lru_reclaims > 0
