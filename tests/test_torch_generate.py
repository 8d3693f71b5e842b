"""The port's generate() and token sampling against the JAX package's, in
fp32 on the CPU, on tiny GPT and LLaMA (GQA) models whose weights come
from numpy through ``convert.load_paddle_state``.

Greedy ``generate()`` is held to the JAX model's greedy argmax at every
generated position (the uncached forward over prompt + output, as
``greedy_from`` in test_torch_serving.py does) and to the JAX
``generate()``; ``use_engine=True`` to ``generate()``. Sampling is held
to itself (a seed reproduces, another differs, ``top_k=1`` is greedy) and
``_pick_token``'s draw to the distribution of the JAX rule and to the
JAX ``_pick_token``'s frequencies. The tests marked ``cuda`` hold the
captured programs (CUDA graphs) to the same steps run eagerly on the
card; they skip without one.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import _pick_token as jax_pick_token
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
import paddle_tpu_torch as ptt
from paddle_tpu_torch.convert import load_paddle_state
from paddle_tpu_torch.core.programs import (ProgramRegistry, StagedInputs,
                                            leaf_addresses, serving_mode)
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     LlamaForCausalLM, llama_tiny)
from paddle_tpu_torch.models.gpt import _gen_registry, _pick_token
from paddle_tpu_torch.serving import DecodeEngine

GPT_TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                max_position_embeddings=64, hidden_dropout_prob=0.0,
                attention_dropout_prob=0.0)
LLAMA_TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                  num_kv_heads=2, intermediate_size=64,
                  max_position_embeddings=64)


def _numpy_weights(jm, seed):
    """Weights at a scale where context matters (matrices ~ N(0,
    1/fan_in), GPT's embeddings ~ N(0, 0.2^2), LLaMA's ~ N(0, 1), norms and
    biases near their init), set on the JAX model and returned for the
    port."""
    rs = np.random.RandomState(seed)
    params = {}
    for name, p in jm.named_parameters():
        shape = tuple(p.shape)
        if name.endswith(("wte.weight", "wpe.weight")):
            a = rs.normal(0.0, 0.2, shape)
        elif name.endswith("embed_tokens.weight"):
            a = rs.normal(0.0, 1.0, shape)
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


def _gpt_pair(seed=5, device="cpu"):
    paddle.seed(seed)
    jm = JaxGPT(JaxGPTConfig(use_flash_attention=False, **GPT_TINY))
    jm.eval()
    params = _numpy_weights(jm, seed)
    tm = GPTForCausalLM(GPTConfig(**GPT_TINY), device="cpu")
    load_paddle_state(tm, params)
    return jm, tm.to(device).eval()


def _llama_pair(seed=7, device="cpu"):
    paddle.seed(seed)
    jm = JaxLlama(jax_llama_tiny(use_flash_attention=False, **LLAMA_TINY))
    jm.eval()
    params = _numpy_weights(jm, seed)
    tm = LlamaForCausalLM(llama_tiny(**LLAMA_TINY), device="cpu")
    load_paddle_state(tm, params)
    return jm, tm.to(device).eval()


@pytest.fixture(scope="module")
def gpt():
    return _gpt_pair()


@pytest.fixture(scope="module")
def llama():
    return _llama_pair()


def _ids(b, s, seed):
    return np.random.RandomState(seed).randint(1, 64, (b, s))


def _jax_greedy_at_every_position(jm, out, s0):
    """The JAX model's argmax over ``out[:, :-1]`` at the generated
    positions ``s0 - 1 ..``: what ``out[:, s0:]`` must be under greedy."""
    logits = np.asarray(jm(paddle.to_tensor(out[:, :-1].astype(np.int32)))
                        .numpy())
    return logits[:, s0 - 1:].argmax(-1)


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_greedy_generate_matches_jax(family, gpt, llama):
    jm, tm = gpt if family == "gpt" else llama
    ids = _ids(3, 5, seed=1)
    out = tm.generate(torch.from_numpy(ids), max_new_tokens=8).numpy()
    assert out.shape == (3, 13) and out.dtype == np.int64
    np.testing.assert_array_equal(out[:, :5], ids)
    np.testing.assert_array_equal(out[:, 5:],
                                  _jax_greedy_at_every_position(jm, out, 5))
    want = jm.generate(paddle.to_tensor(ids.astype(np.int32)),
                       max_new_tokens=8).numpy()
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_eos_rows_stay_eos(family, gpt, llama):
    """A row emits EOS after its EOS; the tokens before it are greedy, and
    the whole output is the JAX generate()'s under the same EOS id."""
    jm, tm = gpt if family == "gpt" else llama
    ids = _ids(3, 4, seed=2)
    greedy = tm.generate(ids, max_new_tokens=10).numpy()
    eos = int(greedy[0, 4 + 2])              # row 0 stops at its 3rd token
    out = tm.generate(ids, max_new_tokens=10, eos_token_id=eos).numpy()
    assert (out[0, 6:] == eos).all()
    for row, g in zip(out, greedy):
        gen = row[4:]
        hits = np.flatnonzero(gen == eos)
        stop = hits[0] if len(hits) else len(gen)
        assert (gen[stop:] == eos).all()
        np.testing.assert_array_equal(gen[:stop + 1][:len(gen)],
                                      g[4:][:stop + 1])
    want = jm.generate(paddle.to_tensor(ids.astype(np.int32)),
                       max_new_tokens=10, eos_token_id=eos).numpy()
    np.testing.assert_array_equal(out, want)


def test_generate_guards(gpt, llama):
    _, tm = gpt
    with pytest.raises(ValueError, match="max_length"):
        tm.generate(np.zeros((1, 60), np.int64), max_new_tokens=10)
    with pytest.raises(ValueError, match="max_length"):
        tm.generate(np.zeros((1, 6), np.int64), max_new_tokens=4,
                    max_length=8)
    with pytest.raises(ValueError, match="learned position"):
        tm.generate(np.zeros((1, 4), np.int64), max_new_tokens=2,
                    max_length=65)
    with pytest.raises(ValueError, match="max_new_tokens"):
        tm.generate(np.zeros((1, 4), np.int64), max_new_tokens=-1)
    ids = _ids(2, 4, seed=3)
    for model in (tm, llama[1]):
        same = model.generate(ids, max_new_tokens=0)
        assert torch.equal(same, torch.from_numpy(ids))
        with pytest.raises(ValueError, match="max_length"):
            model.generate(ids, max_new_tokens=5, max_length=8)


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_use_engine_equals_generate(family, gpt, llama):
    _, tm = gpt if family == "gpt" else llama
    ids = _ids(3, 5, seed=4)
    eager = tm.generate(ids, max_new_tokens=8)
    via = tm.generate(ids, max_new_tokens=8, use_engine=True)
    assert torch.equal(eager, via)
    eng = next(e for k, e in tm._serving_engines.items() if not k[2])
    n = eng.compile_count
    assert torch.equal(tm.generate(ids, max_new_tokens=8, use_engine=True),
                       eager)
    assert eng.compile_count == n          # the cached engine, no rebuild


@pytest.mark.parametrize("use_engine", [False, True])
def test_sampling_modes(gpt, use_engine):
    """The JAX test_sampling_modes: the same seed reproduces, another seed
    differs, top_k=1 is greedy."""
    _, tm = gpt
    ids = _ids(2, 4, seed=5)
    kw = dict(max_new_tokens=12, do_sample=True, temperature=1.0,
              use_engine=use_engine)
    a = tm.generate(ids, seed=0, **kw)
    b = tm.generate(ids, seed=0, **kw)
    c = tm.generate(ids, seed=1, **kw)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    greedy = tm.generate(ids, max_new_tokens=12)
    k1 = tm.generate(ids, max_new_tokens=12, do_sample=True, top_k=1,
                     seed=5, use_engine=use_engine)
    assert torch.equal(k1, greedy)


def test_greedy_leaves_the_global_chain_alone(gpt):
    _, tm = gpt
    ids = _ids(2, 4, seed=6)
    ptt.seed(11)
    state = ptt.get_rng_state()
    tm.generate(ids, max_new_tokens=6)
    tm.generate(ids, max_new_tokens=6, use_engine=True)
    assert torch.equal(ptt.get_rng_state(), state)
    for use_engine in (False, True):
        ptt.seed(11)
        a = tm.generate(ids, max_new_tokens=10, do_sample=True,
                        use_engine=use_engine)
        ptt.seed(11)
        b = tm.generate(ids, max_new_tokens=10, do_sample=True,
                        use_engine=use_engine)
        ptt.seed(12)
        c = tm.generate(ids, max_new_tokens=10, do_sample=True,
                        use_engine=use_engine)
        assert torch.equal(a, b) and not torch.equal(a, c)


def test_sampled_engine_reuse_keeps_compile_count(gpt):
    """generate_via_engine reuses one sampling engine: reseeding restarts
    its key stream, slot order and prefix cache, builds nothing, and
    reproduces, also for prompts longer than the chunk (two chunk calls
    first, which a prefix-cache hit would cut to one)."""
    _, tm = gpt
    ids = _ids(3, 40, seed=8)
    kw = dict(max_new_tokens=9, do_sample=True, temperature=0.7, top_k=8,
              use_engine=True)
    a = tm.generate(ids, seed=21, **kw)
    engines = [e for k, e in tm._serving_engines.items()
               if k[2] and k[3] == (0.7, 8)]
    assert len(engines) == 1
    n = engines[0].compile_count
    assert n == 2                           # one chunk width + decode
    c = tm.generate(ids, seed=22, **kw)
    b = tm.generate(ids, seed=21, **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert engines[0].compile_count == n


# logits with ties: sorted they read 2.0, 1.5, 1.5, 1.0, 0.5, 0.5, 0.5, ...
TIE_LOGITS = [0.5, 2.0, -1.0, 1.5, 0.5, 0.0, 1.5, 1.0, -3.0, 0.5, -0.5,
              -2.0]


def _rule_probs(logits, temperature, top_k):
    """softmax(lg / T) over the tokens the JAX tie rule keeps (every logit
    >= the top_k-th largest)."""
    lg = np.asarray(logits, np.float64) / max(temperature, 1e-6)
    keep = np.ones(len(lg), bool)
    if 0 < top_k < len(lg):
        keep = lg >= np.sort(lg)[-top_k]
    p = np.where(keep, np.exp(lg - lg.max()), 0.0)
    return p / p.sum(), keep


@pytest.mark.parametrize("temperature,top_k", [(1.0, 0), (0.8, 5), (0.5, 2),
                                               (1.3, 3)])
def test_pick_token_frequencies(temperature, top_k):
    """20 000 draws on fixed logits (one per row): each token's count lies
    within 5 sigma of softmax(lg / T) under the JAX tie rule and of the
    JAX _pick_token's count; nothing falls outside the kept set. top_k=5
    keeps 7 tokens (three tie at the 5th value), top_k=2 keeps 3."""
    n = 20000
    logits = torch.tensor(TIE_LOGITS, dtype=torch.float32).repeat(n, 1)
    key = torch.tensor([1234, 0], dtype=torch.int64)
    got = _pick_token(logits, key, True, temperature, top_k).numpy()
    again = _pick_token(logits, key, True, temperature, top_k).numpy()
    np.testing.assert_array_equal(got, again)
    jax_got = np.asarray(jax_pick_token(jnp.asarray(logits.numpy()),
                                        jax.random.PRNGKey(99), True,
                                        temperature, top_k))
    p, keep = _rule_probs(TIE_LOGITS, temperature, top_k)
    if top_k == 5:
        assert keep.sum() == 7
    if top_k == 2:
        assert keep.sum() == 3
    ours = np.bincount(got, minlength=len(p))
    theirs = np.bincount(jax_got, minlength=len(p))
    assert ours[~keep].sum() == 0 and theirs[~keep].sum() == 0
    sigma = np.sqrt(n * p * (1 - p))
    assert (np.abs(ours - n * p) <= 5 * sigma + 1e-9).all(), (ours, n * p)
    assert (np.abs(ours - theirs) <= 5 * np.sqrt(2) * sigma + 1e-9).all(), \
        (ours, theirs)


def test_pick_token_keys_and_greedy():
    """Greedy is the first maximum and reads no key; another seed or step
    draws otherwise, and a row draws apart from the next row."""
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0]])
    assert _pick_token(logits).tolist() == [1]
    lg = torch.zeros(4000, 16)
    draws = {tuple(_pick_token(lg, torch.tensor(k), True).tolist())
             for k in ([1, 0], [1, 1], [2, 0])}
    assert len(draws) == 3
    one = _pick_token(lg, torch.tensor([1, 0]), True)
    assert len(set(one.tolist())) == 16          # rows draw apart


def test_staged_inputs_are_views_of_one_buffer():
    st = StagedInputs(torch.device("cpu"), ids=(1, 4), p0=(), cow=(2, 3))
    st.host["ids"][:] = [[5, 6, 7, 8]]
    st.host["p0"][...] = 9
    st.host["cow"][1, 2] = 4
    st.upload()
    assert st.dev["ids"].tolist() == [[5, 6, 7, 8]]
    assert int(st.dev["p0"]) == 9 and st.dev["cow"][1, 2] == 4
    assert st.dev["ids"].untyped_storage().data_ptr() == \
        st.dev["cow"].untyped_storage().data_ptr()


def test_registry_counts_builds_and_rebuilds_on_new_storage(gpt):
    _, tm = gpt
    reg = ProgramRegistry("cpu", lambda: serving_mode(tm), limit=2)
    calls = []
    leaves = leaf_addresses(tm)
    reg.validate(leaves)
    prog = reg.get("a", lambda: (lambda: calls.append(1), None))
    prog()
    prog()
    assert reg.get("a", None) is prog and reg.count == 1 and calls == [1, 1]
    reg.get("b", lambda: (lambda: None, None))
    reg.get("c", lambda: (lambda: None, None))    # drops "a" (limit 2)
    assert len(reg) == 2 and reg.count == 3
    reg.validate(leaves)
    assert len(reg) == 2                        # same storage: kept
    reg.validate(leaves[1:])
    assert len(reg) == 0


def test_generate_program_is_reused_across_prompt_lengths(gpt):
    """The step program is keyed on (B, M, sampling), not on the prompt:
    two prompt lengths under one max_length share it."""
    _, tm = gpt
    reg = _gen_registry(tm)
    tm.generate(_ids(2, 5, seed=9), max_new_tokens=4, max_length=24)
    n = reg.count
    tm.generate(_ids(2, 9, seed=9), max_new_tokens=6, max_length=24)
    assert reg.count == n


# ------------------------------------------------------------ on the card


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA graphs have no CPU mode")


def _engine_tokens(tm, eager, **kw):
    eng = DecodeEngine(tm, max_slots=4, max_len=48, block_size=8,
                       prefill_chunk=8, **kw)
    eng._programs.capture = not eager
    prompts = [_ids(1, n, seed=20 + n)[0].tolist() for n in (5, 11, 19, 3)]
    reqs = [eng.submit(p, max_new_tokens=12) for p in prompts]
    eng.run()
    assert all(r.status == "done" for r in reqs)
    return [r.output_tokens for r in reqs], eng


@pytest.mark.cuda
@pytest.mark.parametrize("sampling", [{}, dict(do_sample=True,
                                               temperature=0.8, top_k=20,
                                               seed=3)])
def test_cuda_engine_graphs_equal_eager(sampling):
    """The captured chunk and decode programs give the eager steps' tokens
    on the card, greedy and sampled at one seed, and a second wave builds
    nothing."""
    _need_cuda()
    _, tm = _gpt_pair(device="cuda")
    want, _ = _engine_tokens(tm, eager=True, **sampling)
    got, eng = _engine_tokens(tm, eager=False, **sampling)
    assert got == want
    assert eng.compile_count == 2
    assert all(p.captured for p in eng._programs._programs.values())
    eng._reseed(sampling.get("seed", 0))
    again = [eng.submit(_ids(1, 7, seed=30)[0].tolist(), max_new_tokens=6)]
    eng.run()
    assert again[0].status == "done" and eng.compile_count == 2


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_cuda_generate_graph_equals_eager(family):
    _need_cuda()
    _, graphed = (_gpt_pair if family == "gpt" else _llama_pair)(
        device="cuda")
    _, eager = (_gpt_pair if family == "gpt" else _llama_pair)(
        device="cuda")
    _gen_registry(eager).capture = False
    ids = _ids(3, 6, seed=31)
    for kw in (dict(), dict(do_sample=True, temperature=0.9, top_k=10,
                            seed=4)):
        a = graphed.generate(ids, max_new_tokens=10, **kw)
        b = eager.generate(ids, max_new_tokens=10, **kw)
        assert torch.equal(a, b), kw
    assert all(p.captured for p in _gen_registry(graphed)._programs.values())
    assert torch.equal(graphed.generate(ids, max_new_tokens=10).cpu(),
                       graphed.to("cpu").generate(ids, max_new_tokens=10))


@pytest.mark.cuda
def test_cuda_weight_swap_recaptures_once():
    """A parameter given new storage (``p.data = ...``) makes the next
    decode re-capture its program once, and the tokens follow the new
    weights; an in-place update needs no capture."""
    _need_cuda()
    _, tm = _gpt_pair(device="cuda")
    eng = DecodeEngine(tm, max_slots=2, max_len=48, block_size=8,
                       prefill_chunk=8)
    req = eng.submit([3, 4, 5, 6], max_new_tokens=20)
    for _ in range(4):
        eng.step()
    assert eng.compile_count == 2
    with torch.no_grad():
        tm.gpt.ln_f.weight.mul_(1.0)             # in place: same address
    eng.step()
    assert eng.compile_count == 2
    tm.gpt.ln_f.weight.data = tm.gpt.ln_f.weight.data.clone()
    eng.step()
    assert eng.compile_count == 3
    eng.run()
    assert req.status == "done" and eng.compile_count == 3
