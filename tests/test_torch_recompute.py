"""Activation recompute in the port (core.remat, distributed.fleet.recompute
and the models' block loops) against the JAX package's compiled TrainStep
under the same policy, and against the port's own run without recompute,
in fp32 on the CPU.

The models are the small GPT of test_torch_train.py (hidden 128, 2 heads
of 64, 2 blocks, vocab 256) and the small LLaMA of test_torch_llama.py
(hidden 256, 4 heads on 2 KV heads, FFN 512, 2 blocks) at L = 128, on
weights drawn with numpy. The JAX gradients are read off a TrainStep with
SGD at learning rate 1 (before minus after), which costs one rounding of
the parameter: the JAX comparisons take atol 2e-5 beside rtol 1e-4. On
the CPU a recomputed block runs the same operations on the same inputs,
so the port's recompute is held to its run without recompute bit for
bit.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu_torch.convert import convert_paddle_state, load_paddle_state
from paddle_tpu_torch.core import remat
from paddle_tpu_torch.core.random import make_generator
from paddle_tpu_torch.distributed.fleet import recompute, recompute_sequential
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     LlamaForCausalLM, llama_tiny)
from paddle_tpu_torch.nn import functional as F

GPT_SMALL = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
                 max_position_embeddings=256, hidden_dropout_prob=0.0,
                 attention_dropout_prob=0.0)
LLAMA_SMALL = dict(hidden_size=256, num_heads=4, num_kv_heads=2,
                   intermediate_size=512, num_layers=2, vocab_size=256,
                   max_position_embeddings=256)
B, L = 2, 128
POLICIES = ("full", "dots", "selective")


def _weights(jm, seed):
    """Numpy weights at a scale where attention matters (matrices ~ N(0,
    1/fan_in), embeddings ~ N(0, 0.2^2), norms near 1), set on the JAX
    model and returned for the port."""
    rs = np.random.RandomState(seed)
    params = {}
    for name, p in jm.named_parameters():
        shape = tuple(p.shape)
        if name.endswith(("wte.weight", "wpe.weight", "embed_tokens.weight")):
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


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 256, (B, L)).astype(np.int32)
    labels = ids.copy()
    labels[0, 5:17] = -100
    return ids, labels


def _build(family, seed=21):
    """The JAX model (training mode) and the port's on the same weights."""
    paddle.seed(seed)
    if family == "gpt":
        jm = JaxGPT(JaxGPTConfig(**GPT_SMALL))
        tm = GPTForCausalLM(GPTConfig(**GPT_SMALL), device="cpu")
    else:
        jm = JaxLlama(jax_llama_tiny(**LLAMA_SMALL))
        tm = LlamaForCausalLM(llama_tiny(**LLAMA_SMALL), device="cpu")
    jm.train()
    load_paddle_state(tm, _weights(jm, seed))
    return jm, tm.train()


def _jax_step_grads(jm, policy):
    """Loss and gradients of the JAX compiled TrainStep under ``policy``
    (SGD at lr 1: before minus after), mapped to the port's layout; the
    weights are put back after."""
    jm.enable_recompute(policy)
    before = {n: np.asarray(p.numpy(), np.float32)
              for n, p in jm.named_parameters()}
    opt = paddle.optimizer.SGD(learning_rate=1.0,
                               parameters=jm.parameters())
    ids, labels = _batch()
    loss = float(paddle.jit.TrainStep(jm, opt)(paddle.to_tensor(ids),
                                              paddle.to_tensor(labels)))
    grads = {n: before[n] - np.asarray(p.numpy(), np.float32)
             for n, p in jm.named_parameters()}
    for n, p in jm.named_parameters():
        p.set_value(before[n])
    return loss, grads


def _port_grads(tm, policy, interval=1):
    tm.enable_recompute(policy, interval)
    tm.zero_grad(set_to_none=True)
    ids, labels = _batch()
    _, loss = tm(torch.from_numpy(ids).long(), torch.from_numpy(labels).long())
    loss.backward()
    grads = {n: p.grad.clone() for n, p in tm.named_parameters()}
    tm.zero_grad(set_to_none=True)
    return loss.detach(), grads


@pytest.fixture(scope="module", params=["gpt", "llama"])
def family(request):
    """A model pair and the port's loss and gradients without recompute."""
    jm, tm = _build(request.param)
    return request.param, jm, tm, _port_grads(tm, "none")


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_matches_jax_and_plain_run(family, policy):
    """Under each policy the port's loss and every leaf gradient equal its
    run without recompute bit for bit, and the JAX TrainStep's under the
    same policy within atol 2e-5 + rtol 1e-4."""
    name, jm, tm, (loss0, grads0) = family
    loss, grads = _port_grads(tm, policy)
    assert torch.equal(loss, loss0)
    for n in grads0:
        assert torch.equal(grads[n], grads0[n]), (policy, n)
    loss_j, grads_j = _jax_step_grads(jm, policy)
    np.testing.assert_allclose(loss.item(), loss_j, rtol=1e-5)
    want = convert_paddle_state(grads_j, tm)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), rtol=1e-4,
                                   atol=2e-5, err_msg=f"{name} {policy} {n}")


def _count_forwards(blocks):
    counts = [0] * len(blocks)

    def hook(i):
        def pre(module, args):
            counts[i] += 1
        return pre
    handles = [b.register_forward_pre_hook(hook(i))
               for i, b in enumerate(blocks)]
    return counts, handles


@pytest.mark.parametrize("family_name", ["gpt", "llama"])
def test_interval_recomputes_every_second_block(family_name):
    """``recompute_interval=2`` on 4 blocks: blocks 0 and 2 run their
    forward twice (the forward and the recompute), 1 and 3 once, and
    the gradients equal the run without recompute bit for bit."""
    if family_name == "gpt":
        tm = GPTForCausalLM(GPTConfig(**dict(GPT_SMALL, num_layers=4)),
                            device="cpu", seed=3).train()
        blocks = tm.gpt.h
    else:
        tm = LlamaForCausalLM(llama_tiny(**dict(LLAMA_SMALL, num_layers=4)),
                              device="cpu", seed=3).train()
        blocks = tm.model.layers
    _, grads0 = _port_grads(tm, "none")
    counts, handles = _count_forwards(blocks)
    _, grads = _port_grads(tm, "selective", interval=2)
    for h in handles:
        h.remove()
    assert counts == [2, 1, 2, 1]
    assert tm.config.recompute_interval == 2
    for n in grads0:
        assert torch.equal(grads[n], grads0[n]), n


def test_granularity_surface():
    """The config and enable_recompute share normalize_granularity: True
    is "full", None/False "none", the interval is clamped to 1, the legacy
    ``remat=`` spelling sets the granularity, and an unknown name
    raises; eval and no-grad forwards run no region."""
    assert remat.normalize_granularity(True, 0) == ("full", 1)
    assert remat.normalize_granularity(None) == ("none", 1)
    assert GPTConfig(**dict(GPT_SMALL, remat="dots")).recompute_granularity \
        == "dots"
    assert llama_tiny(recompute_granularity=True).recompute_granularity \
        == "full"
    with pytest.raises(ValueError, match="granularity"):
        GPTConfig(**dict(GPT_SMALL, recompute_granularity="some"))
    with pytest.raises(ValueError, match="policy"):
        recompute(torch.sin, torch.ones(2, requires_grad=True),
                  policy="names")
    assert remat.resolve_policy(None) == "full"
    tm = GPTForCausalLM(GPTConfig(**GPT_SMALL), device="cpu")
    tm.enable_recompute(False)
    assert tm.config.recompute_granularity == "none"
    counts, handles = _count_forwards(tm.gpt.h)
    tm.enable_recompute("full")
    with torch.no_grad():
        tm.train()(torch.zeros(1, 16, dtype=torch.long))
    tm.eval()(torch.zeros(1, 16, dtype=torch.long))
    for h in handles:
        h.remove()
    assert counts == [2, 2]
    x = torch.randn(3)
    assert remat.tag_activation(x, remat.ATTN_QKV) is x


def test_selective_keeps_the_tagged_products():
    """Inside a selective region the products whose outputs carry a tag
    are served from the keep store in the recompute: of the two Linears
    here only the untagged one runs again, and "full" runs both; "dots"
    keeps both."""
    torch.manual_seed(0)
    lin1, lin2 = torch.nn.Linear(8, 16), torch.nn.Linear(16, 8)
    x0 = torch.randn(2, 5, 8)
    runs = {}

    def f(x):
        h = remat.tag_activation(lin1(x), remat.MLP_HIDDEN)
        return lin2(torch.nn.functional.gelu(h)) * x.sum()

    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.addmm.default:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    grads = {}
    for policy in ("none",) + POLICIES:
        Count.n = 0
        x = x0.clone().requires_grad_()
        with Count():
            y = f(x) if policy == "none" else recompute(f, x, policy=policy)
            y.square().sum().backward()
        runs[policy] = Count.n
        grads[policy] = x.grad
    assert runs == {"none": 2, "full": 4, "dots": 2, "selective": 3}
    for policy in POLICIES:
        assert torch.equal(grads[policy], grads["none"])


def test_dropout_masks_replay_bit_for_bit():
    """GPT at dropout 0.1 (embedding, residual and attention dropout, all
    from the model's generator): "full" and "selective" recompute give the
    gradients of the run without recompute from the same generator state
    bit for bit, so every recomputed dropout drew its forward's seed. A
    region that does not preserve the generators draws new seeds, and its
    gradients differ."""
    cfg = dict(GPT_SMALL, hidden_dropout_prob=0.1, attention_dropout_prob=0.1)
    tm = GPTForCausalLM(GPTConfig(**cfg), device="cpu", seed=5).train()
    state = tm.generator.get_state()
    out = {}
    for policy in ("none", "full", "selective"):
        tm.generator.set_state(state)
        out[policy] = _port_grads(tm, policy)
        assert not torch.equal(tm.generator.get_state(), state)
    loss0, g0 = out["none"]
    for policy in ("full", "selective"):
        loss, g = out[policy]
        assert torch.equal(loss, loss0)
        for n in g0:
            assert torch.equal(g[n], g0[n]), (policy, n)

    gen = make_generator(9)
    w = torch.randn(16, 16, requires_grad=True)

    def f(x):
        return F.dropout(x @ w, 0.5, generator=gen) @ w

    def grad_w(preserve):
        gen.manual_seed(9)
        w.grad = None
        x = torch.randn(4, 16, generator=torch.Generator().manual_seed(1))
        recompute(f, x.requires_grad_(),
                  preserve_rng_state=preserve).sum().backward()
        return w.grad.clone()

    gen.manual_seed(9)
    w.grad = None
    x = torch.randn(4, 16, generator=torch.Generator().manual_seed(1))
    f(x.requires_grad_()).sum().backward()
    assert torch.equal(grad_w(True), w.grad)
    assert not torch.equal(grad_w(False), grad_w(True))


def test_recompute_sequential_matches_plain_run():
    """recompute_sequential over 5 layers in 2 segments (3 + 2), one of
    them returning a tuple that the next layer takes unpacked, at dropout
    0.2 from the global chain: the output and gradients equal the plain
    run from the same chain state bit for bit, under each policy."""
    torch.manual_seed(0)

    class Split(torch.nn.Module):
        def forward(self, x):
            return x[..., :8], x[..., 8:]

    class Join(torch.nn.Module):
        def forward(self, a, b):
            return torch.cat([b, a], dim=-1)

    class Drop(torch.nn.Module):
        def forward(self, x):
            return F.dropout(x, 0.2)

    layers = torch.nn.Sequential(torch.nn.Linear(16, 16), Drop(), Split(),
                                 Join(), torch.nn.Linear(16, 4))
    x0 = torch.randn(3, 16)
    from paddle_tpu_torch.core import random as rnd
    rnd.seed(4)
    state = rnd.get_rng_state()
    try:
        x = out = x0.clone().requires_grad_()
        for layer in layers:
            out = layer(*out) if isinstance(out, tuple) else layer(out)
        out.square().sum().backward()
        want = [x.grad] + [p.grad.clone() for p in layers.parameters()]
        for policy in POLICIES:
            rnd.set_rng_state(state)
            layers.zero_grad(set_to_none=True)
            x = x0.clone().requires_grad_()
            out = recompute_sequential({"segments": 2, "policy": policy},
                                       layers, x)
            out.square().sum().backward()
            got = [x.grad] + [p.grad for p in layers.parameters()]
            for a, b in zip(got, want):
                assert torch.equal(a, b), policy
    finally:
        rnd.seed(0)
    with pytest.raises(ValueError, match="empty"):
        recompute_sequential({}, [], x0)
