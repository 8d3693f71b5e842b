"""The port's int8 weight-only serving against the JAX package's, in fp32
on the CPU: ``Int8Linear.from_linear`` gives the JAX package's int8
weights (through the transpose: the port keeps ``[out, in]``, the JAX
package ``[in, out]``) and scales exactly, and its forward is within 1e-6
relative of the JAX ``_int8_linear_fwd``; ``quantize_for_serving`` swaps
the layers the JAX function swaps and never the LM head; the
``quantize="int8"`` engine gives the port's int8 ``generate()`` tokens and
the JAX int8 engine's, and agrees with the float model on at least 0.8 of
tokens; an in-place swap drops a cached ``generate(use_engine=True)``
engine and rebuilds ``generate()``'s programs. The test marked ``cuda``
holds the card's int8 product (``torch._int_mm``) to the CPU's plain one;
it skips without a card."""
import copy

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu.nn import Linear as JaxLinear
from paddle_tpu.quantization import Int8Linear as JaxInt8Linear
from paddle_tpu.serving import DecodeEngine as JaxDecodeEngine
from paddle_tpu.serving import quantize_for_serving as jax_quantize
from paddle_tpu_torch.convert import load_paddle_state
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     LlamaForCausalLM, llama_tiny)
from paddle_tpu_torch.models.gpt import _gen_registry
from paddle_tpu_torch.quantization import Int8Linear, int8_matmul
from paddle_tpu_torch.serving import DecodeEngine, quantize_for_serving

# weights at a scale where context matters, set on the JAX model
from test_torch_generate import _numpy_weights

GPT_TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                max_position_embeddings=64, hidden_dropout_prob=0.0,
                attention_dropout_prob=0.0)
LLAMA_TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                  num_kv_heads=2, intermediate_size=64,
                  max_position_embeddings=64)
ENGINE = dict(max_slots=2, max_len=32, prefill_buckets=[8])


def _pair(family, seed):
    """A JAX model and the port's copy of it (fresh: the tests swap
    layers in place)."""
    paddle.seed(seed)
    if family == "gpt":
        jm = JaxGPT(JaxGPTConfig(use_flash_attention=False, **GPT_TINY))
        tm = GPTForCausalLM(GPTConfig(**GPT_TINY), device="cpu")
    else:
        jm = JaxLlama(jax_llama_tiny(use_flash_attention=False,
                                     **LLAMA_TINY))
        tm = LlamaForCausalLM(llama_tiny(**LLAMA_TINY), device="cpu")
    jm.eval()
    load_paddle_state(tm, _numpy_weights(jm, seed))
    return jm, tm.eval()


def _linear_pair(n_in, n_out, bias, seed):
    rs = np.random.RandomState(seed)
    w = rs.normal(0.0, 0.5, (n_in, n_out)).astype(np.float32)
    w[:, 3] = 0.0                       # an all-zero channel: scale 1e-8
    jl = JaxLinear(n_in, n_out, bias_attr=None if bias else False)
    jl.weight.set_value(w)
    tl = torch.nn.Linear(n_in, n_out, bias=bias)
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(w.T))
        if bias:
            b = rs.normal(0.0, 0.3, n_out).astype(np.float32)
            jl.bias.set_value(b)
            tl.bias.copy_(torch.from_numpy(b))
    return jl, tl


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("shape", [(5, 48), (2, 7, 48)])
def test_int8_linear_matches_jax(bias, shape):
    jl, tl = _linear_pair(48, 40, bias, seed=3)
    jq, tq = JaxInt8Linear.from_linear(jl), Int8Linear.from_linear(tl)
    np.testing.assert_array_equal(tq.qweight.numpy(),
                                  np.asarray(jq.qweight.numpy()).T)
    np.testing.assert_array_equal(tq.w_scale.numpy(),
                                  np.asarray(jq.w_scale.numpy())[0])
    assert tq.qweight.dtype == torch.int8 and tq.bias is tl.bias
    x = np.random.RandomState(4).normal(0.0, 2.0, shape).astype(np.float32)
    want = np.asarray(jq(paddle.to_tensor(x)).numpy())
    with torch.no_grad():
        got = tq(torch.from_numpy(x))
    assert got.shape == shape[:-1] + (40,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    # the int8 product is the exact int32 one
    xq = torch.randint(-127, 128, (9, 48), dtype=torch.int8)
    exact = xq.long() @ tq.qweight.long().t()
    assert torch.equal(int8_matmul(xq, tq.qweight), exact.float())


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_quantize_for_serving_swaps_as_jax(family):
    jm, tm = _pair(family, seed=8)
    jax_quantize(jm)
    assert quantize_for_serving(tm) is tm
    n_jax = sum(isinstance(m, JaxInt8Linear)
                for _, m in jm.named_sublayers())
    n_port = sum(isinstance(m, Int8Linear) for m in tm.modules())
    per_block = 4 if family == "gpt" else 7
    assert n_port == n_jax == per_block * 2
    assert not any(type(m) is torch.nn.Linear for m in tm.modules()
                   if m is not getattr(tm, "lm_head", None))
    if family == "llama":               # the untied head stays float
        assert type(tm.lm_head) is torch.nn.Linear
    assert quantize_for_serving(tm) is tm      # nothing left to swap
    assert sum(isinstance(m, Int8Linear) for m in tm.modules()) == n_port


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_int8_engine_tokens_match_jax(family):
    jm, tm = _pair(family, seed=2 if family == "gpt" else 7)
    ids = np.random.RandomState(2).randint(1, 64, (2, 5))
    ref_fp32 = tm.generate(torch.from_numpy(ids), max_new_tokens=6).numpy()
    jeng = JaxDecodeEngine(jm, quantize="int8", **ENGINE)
    teng = DecodeEngine(tm, quantize="int8", **ENGINE)
    assert teng.quantize == "int8"
    assert any(isinstance(m, Int8Linear) for m in tm.modules())
    int8_gen = tm.generate(torch.from_numpy(ids), max_new_tokens=6).numpy()
    jreqs = [jeng.submit(row.tolist(), max_new_tokens=6) for row in ids]
    treqs = [teng.submit(row.tolist(), max_new_tokens=6) for row in ids]
    jeng.run()
    teng.run()
    for row, jr, tr in zip(int8_gen, jreqs, treqs):
        assert tr.status == jr.status == "done"
        assert list(tr.output_tokens) == list(row[5:])
        assert list(tr.output_tokens) == list(jr.output_tokens)
    match = (int8_gen == ref_fp32).mean()
    assert match >= 0.8, f"int8 diverged from fp32 on {1 - match:.0%}"
    assert teng.compile_count == 2             # bucket 8 + decode


def test_int8_swap_drops_the_cached_engine():
    """After an in-place swap, generate(use_engine=True) drops the engine
    whose parameters and buffers predate it (it would serve the float
    weights it holds) and generate() rebuilds its programs."""
    _, tm = _pair("gpt", seed=6)
    ids = torch.from_numpy(np.random.RandomState(6).randint(1, 64, (2, 4)))
    tm.generate(ids, max_new_tokens=4, use_engine=True)
    (key, old), = tm._serving_engines.items()
    tm.generate(ids, max_new_tokens=4)
    built = _gen_registry(tm).count
    quantize_for_serving(tm)
    eager = tm.generate(ids, max_new_tokens=4)
    assert _gen_registry(tm).count == built + 1
    via = tm.generate(ids, max_new_tokens=4, use_engine=True)
    assert torch.equal(eager, via)
    assert tm._serving_engines[key] is not old
    assert len(tm._serving_engines) == 1
    new_leaves = tm._serving_engines[key]._leaves
    assert any(t.dtype == torch.int8 for t in new_leaves)


def test_quantize_other_than_int8_raises():
    _, tm = _pair("gpt", seed=9)
    with pytest.raises(ValueError, match="quantize"):
        DecodeEngine(tm, quantize="int4", **ENGINE)
    assert not any(isinstance(m, Int8Linear) for m in tm.modules())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 16, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_int8_linear_matches_cpu(m, dtype):
    """The card's product (torch._int_mm, rows padded to 32) against the
    CPU's exact plain one at GPT-medium's QKV width, K 1024, N 3072: the
    int32 sums are exact and the fp32 epilogue is the same operations, so
    the outputs agree to rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch._int_mm runs there")
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(m)
    lin = torch.nn.Linear(1024, 3072).to(dt)
    with torch.no_grad():
        lin.weight.normal_(0.0, 0.02, generator=gen)
        lin.bias.normal_(0.0, 0.1, generator=gen)
    cpu = Int8Linear.from_linear(lin)       # holds lin's own bias
    card = Int8Linear.from_linear(copy.deepcopy(lin).cuda())
    assert torch.equal(card.qweight.cpu(), cpu.qweight)
    x = torch.randn(m, 1024, generator=gen).to(dt)
    with torch.no_grad():
        want = cpu(x).float()
        got = card(x.cuda()).float().cpu()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
