"""The port's paged DecodeEngine and BlockPager against the JAX package's,
in fp32 on the CPU: the same tiny weights and the same submit/step
schedule must give the same greedy tokens per request under prefix
sharing, copy-on-write and pool-pressure preemption, and the two pagers
must make the same allocation decisions under a seeded random op mix."""
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
        assert tr.output_tokens == jr.output_tokens, (jr.prompt, jr, tr)
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


@pytest.mark.parametrize("knob", [dict(paged=False), dict(prefill_chunk=None),
                                  dict(quantize="int8"), dict(do_sample=True),
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
