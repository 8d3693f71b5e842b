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


@pytest.fixture(scope="module")
def models():
    paddle.seed(5)
    jm = JaxGPT(JaxGPTConfig(use_flash_attention=False, **TINY))
    jm.eval()
    params = _spread_weights(jm, seed=5)
    tm = GPTForCausalLM(GPTConfig(**TINY), device="cpu")
    load_paddle_state(tm, params)
    tm.eval()
    return jm, tm


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


@pytest.mark.parametrize("knob", [dict(paged=False), dict(quantize="int8"),
                                  dict(drafter=object()),
                                  dict(kv_pool=object()), dict(hang_s=1.0)])
def test_engine_unported_knobs_raise(models, knob):
    _, tm = models
    kw = dict(GEOM, **knob)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DecodeEngine(tm, **kw)


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
