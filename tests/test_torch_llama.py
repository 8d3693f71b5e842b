"""The port's LLaMA (paddle_tpu_torch.models.llama) against the JAX
package's, on the same weights, in fp32 on the CPU: RMSNorm, RoPE, the
uncached logits (through the softmax chain and through FlashAttention's
plain versions), the loss and every leaf's gradient, three AdamW
TrainSteps, the paged DecodeEngine's greedy tokens, weight conversion,
device resolution, and the first model of a process freed by reference
counting alone.

The model is llama_tiny at hidden 256 (4 heads of 64 on 2 KV heads: GQA),
FFN 512, 2 blocks, vocab 256, at L = 128; weights are drawn with numpy and
loaded into both packages.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import _rope_fwd
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu.nn.layers_norm_act_loss import _rms_norm_fwd
from paddle_tpu.serving import DecodeEngine as JaxDecodeEngine
from paddle_tpu_torch.convert import convert_paddle_state, load_paddle_state
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.kernels.flash_attention import FlashAttention
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.models.llama import rope, shard_llama_tp
from paddle_tpu_torch.nn import RMSNorm
from paddle_tpu_torch.nn.functional import attention
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import DecodeEngine

SMALL = dict(hidden_size=256, num_heads=4, num_kv_heads=2,
             intermediate_size=512, num_layers=2, vocab_size=256,
             max_position_embeddings=256)
B, L = 2, 128


def _weights(jm, seed):
    """Numpy weights at a scale where attention matters (every matrix ~
    N(0, 1/fan_in), so each block adds O(1) to the residual stream; the
    embedding ~ N(0, 1); RMSNorm weights near 1), set on the JAX model and
    returned for the port. At the init std of 0.02 a tiny model's logits
    are nearly flat and a broken attention could go unseen."""
    rs = np.random.RandomState(seed)
    params = {}
    for name, p in jm.named_parameters():
        shape = tuple(p.shape)
        if name.endswith("embed_tokens.weight"):
            a = rs.normal(0.0, 1.0, shape)
        elif len(shape) == 2:                      # paddle Linear: [in, out]
            a = rs.normal(0.0, 1.0 / np.sqrt(shape[0]), shape)
        else:
            a = 1.0 + rs.normal(0.0, 0.1, shape)
        a = a.astype(np.float32)
        p.set_value(a)
        params[name] = a
    return params


def _pair(seed=31, **overrides):
    """A JAX LLaMA and the port's on the same weights."""
    cfg = dict(SMALL, **overrides)
    paddle.seed(seed)
    jm = JaxLlama(jax_llama_tiny(**cfg))
    params = _weights(jm, seed)
    tm = LlamaForCausalLM(llama_tiny(**cfg), device="cpu")
    load_paddle_state(tm, params)
    return jm, params, tm


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, SMALL["vocab_size"], (B, L)).astype(np.int32)
    labels = ids.copy()
    labels[0, 4:15] = -100                     # ignored targets
    labels[1, -2:] = -100
    return ids, labels


@pytest.fixture
def flash_route(monkeypatch):
    """Open the flash gate on the CPU, so attention goes through
    FlashAttention (its plain versions on CPU tensors); returns the list of
    the q shapes it was applied to."""
    calls = []
    real = FlashAttention.apply

    def spy(*args):
        calls.append(tuple(args[0].shape))
        return real(*args)

    monkeypatch.setattr(attention.FlashAttention, "apply", spy)
    monkeypatch.setattr(attention, "flash_path_available",
                        lambda *a, **kw: True)
    return calls


@pytest.fixture
def on_cpu():
    """A Paddle layer built outside a model (``RMSNorm`` alone) takes the
    default place, which ``set_device`` makes the CPU here."""
    from paddle_tpu_torch.core import device as tp_device
    saved = tp_device._default[0]
    tp_device.set_device("cpu")
    yield
    tp_device._default[0] = saved


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype, on_cpu):
    rs = np.random.RandomState(1)
    x = (rs.randn(3, 7, 64) * 3.0).astype(np.float32)
    w = (1.0 + rs.randn(64) * 0.1).astype(np.float32)
    ref = np.asarray(_rms_norm_fwd(jnp.asarray(x).astype(dtype),
                                   jnp.asarray(w), 1e-6).astype("float32"))
    norm = RMSNorm(64, epsilon=1e-6)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(w))
        got = norm(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("offset", [None, 37, "rows"])
def test_rope_matches_jax(offset):
    """Interleaved-pair rotary embedding against _rope_fwd, with no
    offset, a scalar offset and per-row [B] offsets (serving cursors)."""
    rs = np.random.RandomState(2)
    q = rs.randn(2, 24, 4, 64).astype(np.float32)
    k = rs.randn(2, 24, 2, 64).astype(np.float32)
    if offset is None:
        jq, jk = _rope_fwd(jnp.asarray(q), jnp.asarray(k), theta=10000.0)
        tq, tk = rope(torch.from_numpy(q), torch.from_numpy(k))
    else:
        pos = np.array([5, 211]) if offset == "rows" else np.int32(offset)
        jq, jk = _rope_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos),
                           theta=10000.0, has_pos=True)
        tpos = torch.from_numpy(pos) if offset == "rows" else offset
        tq, tk = rope(torch.from_numpy(q), torch.from_numpy(k), tpos)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=2e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=2e-5)


@pytest.mark.parametrize("route", ["plain", "flash"])
def test_uncached_logits_match_jax(pair, route, request):
    """Scoring logits against the JAX model, through the softmax chain
    (default routing on the CPU) and through FlashAttention's plain
    versions (the gate forced open: the route the card takes)."""
    jm, _, tm = pair
    calls = request.getfixturevalue("flash_route") if route == "flash" \
        else []
    jm.eval()
    tm.eval()
    ids = np.random.RandomState(3).randint(0, 256, (B, L)).astype(np.int32)
    ref = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long()).numpy()
    assert got.shape == (B, L, SMALL["vocab_size"])
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    want = [(B, L, 4, 64)] * SMALL["num_layers"] if route == "flash" else []
    assert calls == want


@pytest.mark.parametrize("route", ["plain", "flash"])
def test_loss_and_every_leaf_gradient_match_jax(route, request):
    """loss.backward() in both packages: the loss within 1e-5 and every
    leaf's gradient (mapped to the port's layout as weights are) within
    1e-4, through either attention route."""
    if route == "flash":
        request.getfixturevalue("flash_route")
    jm, params, tm = _pair(seed=32)
    jm.train()
    tm.train()
    ids, labels = _batch()
    none_j, loss_j = jm(paddle.to_tensor(ids), paddle.to_tensor(labels))
    loss_j.backward()
    grads_j = {n: np.asarray(p.grad.numpy(), np.float32)
               for n, p in jm.named_parameters()}
    assert set(grads_j) == set(params)
    want = convert_paddle_state(grads_j, tm)
    none_t, loss_t = tm(torch.from_numpy(ids).long(),
                        torch.from_numpy(labels).long())
    assert none_j is None and none_t is None
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    loss_t.backward()
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_three_train_steps_match_jax():
    """3 TrainStep + AdamW(1e-3, wd 0.01) calls on a repeated batch against
    the JAX package's: every step's loss within rtol 1e-5, and falling."""
    jm, _, tm = _pair(seed=33)
    jm.train()
    tm.train()
    ids, labels = _batch(1)
    step_j = paddle.jit.TrainStep(jm, paddle.optimizer.AdamW(
        learning_rate=1e-3, weight_decay=0.01, parameters=jm.parameters()))
    step_t = TrainStep(tm, AdamW(learning_rate=1e-3, weight_decay=0.01,
                                 parameters=tm.parameters()))
    ids_t, labels_t = torch.from_numpy(ids).long(), \
        torch.from_numpy(labels).long()
    losses_j = [float(step_j(paddle.to_tensor(ids), paddle.to_tensor(labels)))
                for _ in range(3)]
    losses_t = [step_t(ids_t, labels_t).item() for _ in range(3)]
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    assert losses_t[2] < losses_t[0]


def test_cached_forward_matches_uncached(pair):
    """The paged cached forward (two chunks through a block table, RoPE at
    absolute positions, GQA fold) gives the uncached forward's hidden
    states at every position."""
    _, _, tm = pair
    tm.eval()
    ids = torch.from_numpy(
        np.random.RandomState(4).randint(0, 256, (1, 40))).long()
    bs, nblk = 8, 8
    pools = [(torch.zeros(nblk, bs, 2, 64), torch.zeros(nblk, bs, 2, 64))
             for _ in range(SMALL["num_layers"])]
    table = torch.tensor([[3, 5, 1, 7, 2, 0, 0]])
    caches = [(pk, pv, table) for pk, pv in pools]
    with torch.no_grad():
        full = tm.model(ids)
        first = tm.model(ids[:, :24], kv_caches=caches, start_pos=0)
        pad = torch.cat([ids[:, 24:], torch.zeros(1, 8, dtype=torch.long)],
                        dim=1)
        second = tm.model(pad, kv_caches=caches, start_pos=24, write_end=40)
    got = torch.cat([first, second[:, :16]], dim=1)
    torch.testing.assert_close(got, full, atol=1e-4, rtol=1e-4)


ENGINE_TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                   num_kv_heads=2, intermediate_size=64,
                   max_position_embeddings=64)


def test_engine_greedy_parity_with_jax():
    """The paged DecodeEngine over LLaMA (GQA pools, RoPE at the slots'
    cursors) with prefix sharing and chunked prefill, set up as
    tests/test_paged_serving.py's LLaMA parity test plus a third request
    whose multi-chunk prefill runs beside live slots: each request's
    tokens are the JAX model's greedy tokens on the same weights, and the
    engine's sharing matches the JAX engine's. (The tokens are held to
    the JAX model, not the JAX engine: see tests/test_torch_serving.py.)"""
    paddle.seed(7)
    jm = JaxLlama(jax_llama_tiny(**ENGINE_TINY))
    jm.eval()
    params = _weights(jm, seed=7)
    tm = LlamaForCausalLM(llama_tiny(**ENGINE_TINY), device="cpu")
    load_paddle_state(tm, params)
    tm.eval()
    rng = np.random.RandomState(7)
    prefix = rng.randint(1, 64, 10).tolist()
    prompts = [prefix + [7], prefix + [9], rng.randint(1, 64, 13).tolist()]
    geom = dict(max_slots=2, max_len=32, block_size=4, prefill_chunk=4)
    outs, stats = [], []
    for eng in (JaxDecodeEngine(jm, **geom), DecodeEngine(tm, **geom)):
        first = eng.submit(prompts[0], max_new_tokens=6)
        while first.status != "running":
            eng.step()
        reqs = [first] + [eng.submit(p, max_new_tokens=6)
                          for p in prompts[1:]]
        eng.run()
        assert all(r.status == "done" for r in reqs)
        outs.append([list(r.output_tokens) for r in reqs])
        stats.append(eng.stats()["paged"])
    for prompt, got in zip(prompts, outs[1]):
        seq = np.asarray([prompt + got], np.int32)
        logits = np.asarray(jm(paddle.to_tensor(seq)).numpy())[0]
        n = len(prompt)
        assert got == logits[n - 1:n + 5].argmax(-1).tolist(), prompt
    assert stats[1]["shared_hits"] == stats[0]["shared_hits"] >= 1
    # the tokens depend on the context, not only on the last token
    assert outs[1][0] != outs[1][1]


def test_init_recipe():
    cfg = llama_tiny(**dict(SMALL, num_layers=4))
    tm = LlamaForCausalLM(cfg, device="cpu", seed=3)
    sd = tm.state_dict()
    std = cfg.initializer_range
    resid = std / np.sqrt(2.0 * cfg.num_layers)
    assert abs(sd["model.embed_tokens.weight"].std().item() - std) < 0.1 * std
    assert abs(sd["lm_head.weight"].std().item() - std) < 0.1 * std
    assert abs(sd["model.layers.0.mlp.down_proj.weight"].std().item()
               - resid) < 0.1 * resid
    assert abs(sd["model.layers.1.self_attn.o_proj.weight"].std().item()
               - resid) < 0.1 * resid
    assert torch.all(sd["model.layers.0.input_layernorm.weight"] == 1.0)
    again = LlamaForCausalLM(cfg, device="cpu", seed=3).state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    bf16 = LlamaForCausalLM(cfg, device="cpu", dtype=torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in bf16.parameters())


def test_convert_transposes_every_linear_and_nothing_else():
    """convert decides what to transpose by module type: LLaMA's square
    q_proj/o_proj (64 x 64, which a wrong layout would pass silently), the
    asymmetric k/v/gate/up/down projections and the untied lm_head are
    transposed; the embedding and the RMSNorm weights are not."""
    cfg = llama_tiny(hidden_size=64, num_heads=4, num_kv_heads=2,
                     intermediate_size=96, vocab_size=80)
    tm = LlamaForCausalLM(cfg, device="cpu")
    rs = np.random.RandomState(5)
    linear = {n for n in tm.state_dict()
              if n.endswith(("_proj.weight", "lm_head.weight"))}
    params = {}
    for name, t in tm.state_dict().items():
        shape = tuple(t.shape)[::-1] if name in linear else tuple(t.shape)
        params[name] = rs.randn(*shape).astype(np.float32)
    assert params["model.layers.0.self_attn.q_proj.weight"].shape == (64, 64)
    state = convert_paddle_state(params, tm)
    for name, arr in params.items():
        want = arr.T if name in linear else arr
        np.testing.assert_array_equal(state[name].numpy(), want,
                                      err_msg=name)
    assert len(linear) == 7 * cfg.num_layers + 1


def test_unported_paths_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        shard_llama_tp(LlamaForCausalLM(llama_tiny(), device="cpu"))


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        LlamaForCausalLM(llama_tiny())


def test_first_model_is_freed_without_the_collector():
    """With the cycle collector off, the FIRST LlamaForCausalLM of a
    process dies when its last strong reference goes: its modules are built
    on the meta device without nn.init's draws, whose first call would
    import torch._dynamo and leave a cycle of frames reaching the model.
    The trap fires once a process, so the test runs in a fresh one."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import gc, weakref\n"
            "gc.disable()\n"
            "from paddle_tpu_torch.models import LlamaForCausalLM, "
            "llama_tiny\n"
            "m = LlamaForCausalLM(llama_tiny(), device='cpu')\n"
            "ref = weakref.ref(m)\n"
            "del m\n"
            "print('alive' if ref() is not None else 'freed')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["freed"], r.stdout + r.stderr
