"""Gradient clipping and weight-decay selection in the port (nn.clip,
regularizer, the optimizers' grad_clip / L2Decay / apply_decay_param_fun /
lr_ratio) against the JAX package, on the CPU.

The clips run on the same numpy gradients in both packages (fp32 within
rtol 1e-6, bf16 within one bf16 rounding, rtol 8e-3). The optimizer
checks run one or two steps on small linear maps from numpy weights; the
clip inside an accumulated step runs the small GPT of test_torch_train.py
through both packages' TrainStep with SGD at learning rate 1.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import regularizer as jax_reg
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.nn import clip as jax_clip
from paddle_tpu_torch.convert import convert_paddle_state, load_paddle_state
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.nn import clip as port_clip
# SGD without decay, ``p - lr * g``: gradients read off one update
from paddle_tpu_torch.optimizer import SGD, Adam, AdamW
from paddle_tpu_torch.regularizer import L1Decay, L2Decay

SMALL = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
             max_position_embeddings=256, hidden_dropout_prob=0.0,
             attention_dropout_prob=0.0)

CLIPS = {"value": lambda m: m.ClipGradByValue(0.05, -0.02),
         "norm": lambda m: m.ClipGradByNorm(0.3),
         "global": lambda m: m.ClipGradByGlobalNorm(0.7)}




def _grads(seed=0):
    rs = np.random.RandomState(seed)
    return [rs.normal(0.0, s, shape).astype(np.float32)
            for s, shape in ((0.1, (8, 4)), (0.02, (4,)), (0.3, (3, 5)))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(CLIPS))
def test_clip_matches_jax(kind, dtype):
    """Each clip on three gradients (one far above the clip norm) in both
    packages; the result keeps each gradient's type."""
    grads = _grads()
    tdt = getattr(torch, dtype)
    jg = [jnp.asarray(g).astype(dtype) for g in grads]
    tg = [torch.from_numpy(g).to(tdt) for g in grads]
    want = CLIPS[kind](jax_clip)([(None, g) for g in jg])
    got = CLIPS[kind](port_clip)([(None, g) for g in tg])
    rtol = 1e-6 if dtype == "float32" else 8e-3
    changed = False
    for (_, w), (_, g), g0 in zip(want, got, tg):
        assert g.dtype == tdt
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=rtol,
                                   atol=1e-7)
        changed |= not torch.equal(g, g0)
    assert changed


def test_global_norm_below_clip_leaves_gradients():
    g = [torch.full((4,), 0.01), torch.full((2, 2), -0.02)]
    out = port_clip.ClipGradByGlobalNorm(1.0)([(None, x) for x in g])
    for (_, a), b in zip(out, g):
        assert torch.equal(a, b)


def _linear_pair(seed=3, names=("", "")):
    """Two parameters, ``w [8, 4]`` and ``b [4]``, on both sides, with the
    given names (the JAX side's set as a ParamAttr would)."""
    rs = np.random.RandomState(seed)
    w0, b0 = rs.randn(8, 4).astype(np.float32), \
        rs.randn(4).astype(np.float32)
    jw = paddle.create_parameter([8, 4], "float32", name=names[0] or None)
    jb = paddle.create_parameter([4], "float32", name=names[1] or None)
    jw.set_value(w0)
    jb.set_value(b0)
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    tb = torch.nn.Parameter(torch.from_numpy(b0.copy()))
    for p, n in zip((tw, tb), names):
        if n:
            p.param_name = n
    x = rs.randn(16, 8).astype(np.float32)
    return (jw, jb), (tw, tb), x


def _run_both(make_j, make_t, steps=2, names=("", "")):
    (jw, jb), (tw, tb), x = _linear_pair(names=names)
    opt_j, opt_t = make_j([jw, jb]), make_t([tw, tb])
    for _ in range(steps):
        ((paddle.to_tensor(x).matmul(jw) + jb) ** 2).sum().backward()
        opt_j.step()
        opt_j.clear_grad()
        ((torch.from_numpy(x) @ tw + tb) ** 2).sum().backward()
        opt_t.step()
        opt_t.clear_grad()
    for j, t in ((jw, tw), (jb, tb)):
        np.testing.assert_allclose(t.detach().numpy(), j.numpy(), rtol=1e-5,
                                   atol=1e-6)
    return tw.detach(), tb.detach()


def test_grad_clip_in_optimizer_step_matches_jax():
    """AdamW with ClipGradByGlobalNorm(0.5): the clip runs on the
    gradients before the update, as the JAX package's step does."""
    w, b = _run_both(
        lambda ps: paddle.optimizer.AdamW(
            learning_rate=0.1, parameters=ps,
            grad_clip=jax_clip.ClipGradByGlobalNorm(0.5)),
        lambda ps: AdamW(learning_rate=0.1, parameters=ps,
                         grad_clip=port_clip.ClipGradByGlobalNorm(0.5)))
    plain, _ = _run_both(
        lambda ps: paddle.optimizer.SGD(learning_rate=0.1, parameters=ps),
        lambda ps: SGD(learning_rate=0.1, parameters=ps))
    clipped, _ = _run_both(
        lambda ps: paddle.optimizer.SGD(
            learning_rate=0.1, parameters=ps,
            grad_clip=jax_clip.ClipGradByValue(0.1)),
        lambda ps: SGD(learning_rate=0.1, parameters=ps,
                       grad_clip=port_clip.ClipGradByValue(0.1)))
    assert not torch.equal(plain, clipped)


@pytest.mark.parametrize("names", [("w_decay", "b_nodecay"), ("", "")])
def test_apply_decay_param_fun_matches_jax(names):
    """AdamW(weight_decay=0.5, apply_decay_param_fun=name starts with
    "w_"): called with each parameter's name (the port's ``param_name``),
    "" where none was set, so only a parameter named "w_..." decays; both
    packages agree over two steps, and after one step the parameter that
    does not decay stands where it stands without decay."""
    fun = lambda n: n.startswith("w_")                         # noqa: E731
    _run_both(
        lambda ps: paddle.optimizer.AdamW(learning_rate=0.1,
                                          weight_decay=0.5, parameters=ps,
                                          apply_decay_param_fun=fun),
        lambda ps: AdamW(learning_rate=0.1, weight_decay=0.5, parameters=ps,
                         apply_decay_param_fun=fun), names=names)
    w, b = _run_both(
        lambda ps: paddle.optimizer.AdamW(learning_rate=0.1,
                                          weight_decay=0.5, parameters=ps,
                                          apply_decay_param_fun=fun),
        lambda ps: AdamW(learning_rate=0.1, weight_decay=0.5, parameters=ps,
                         apply_decay_param_fun=fun), steps=1, names=names)
    w0, b0 = _run_both(
        lambda ps: paddle.optimizer.AdamW(learning_rate=0.1,
                                          weight_decay=0.0, parameters=ps),
        lambda ps: AdamW(learning_rate=0.1, weight_decay=0.0, parameters=ps),
        steps=1, names=names)
    assert torch.equal(b, b0)                     # never decays
    assert torch.equal(w, w0) == (names[0] == "")


@pytest.mark.parametrize("opt_name", ["Adam", "AdamW"])
def test_l2decay_object_matches_jax_and_float(opt_name):
    """An L2Decay as weight_decay gives its coefficient: the same steps as
    the float, in both packages (Adam: L2 on the gradient; AdamW:
    decoupled)."""
    jcls = getattr(paddle.optimizer, opt_name)
    tcls = {"Adam": Adam, "AdamW": AdamW}[opt_name]
    w, b = _run_both(
        lambda ps: jcls(learning_rate=0.1, parameters=ps,
                        weight_decay=jax_reg.L2Decay(0.3)),
        lambda ps: tcls(learning_rate=0.1, parameters=ps,
                        weight_decay=L2Decay(0.3)))
    wf, bf = _run_both(
        lambda ps: jcls(learning_rate=0.1, parameters=ps, weight_decay=0.3),
        lambda ps: tcls(learning_rate=0.1, parameters=ps, weight_decay=0.3))
    assert torch.equal(w, wf) and torch.equal(b, bf)


def test_l1decay_raises_and_its_gradient_matches_jax():
    p = np.array([-2.0, 0.0, 3.0], np.float32)
    np.testing.assert_array_equal(
        L1Decay(0.1)(torch.from_numpy(p)).numpy(),
        np.asarray(jax_reg.L1Decay(0.1)(paddle.to_tensor(p)).numpy()))
    np.testing.assert_array_equal(
        L2Decay(0.1)(torch.from_numpy(p)).numpy(),
        np.asarray(jax_reg.L2Decay(0.1)(paddle.to_tensor(p)).numpy()))
    assert L2Decay(0.25).coeff == 0.25 and "0.25" in repr(L2Decay(0.25))
    ps = [torch.nn.Parameter(torch.ones(2))]
    with pytest.raises(NotImplementedError, match="L1"):
        Adam(parameters=ps, weight_decay=L1Decay(0.1))
    with pytest.raises(NotImplementedError):
        paddle.optimizer.Adam(parameters=[paddle.create_parameter([2])],
                              weight_decay=jax_reg.L1Decay(0.1))


def test_lr_ratio_is_taken_and_not_read():
    """AdamW takes lr_ratio and never reads it, as the JAX package (a
    fault of the reference, ROADMAP Queue 3): the steps equal those
    without it."""
    w, b = _run_both(
        lambda ps: paddle.optimizer.AdamW(learning_rate=0.1, parameters=ps,
                                          lr_ratio=lambda p: 0.1),
        lambda ps: AdamW(learning_rate=0.1, parameters=ps,
                         lr_ratio=lambda p: 0.1))
    w0, b0 = _run_both(
        lambda ps: paddle.optimizer.AdamW(learning_rate=0.1, parameters=ps),
        lambda ps: AdamW(learning_rate=0.1, parameters=ps))
    assert torch.equal(w, w0) and torch.equal(b, b0)


def test_clip_inside_accumulated_step_matches_jax():
    """TrainStep(accumulate_steps=2) with SGD(lr 1, grad_clip=
    ClipGradByGlobalNorm(0.5)) on the small GPT: the clip runs on the
    averaged fp32 sum, after which the update is p - g; the clipped
    gradients (before minus after) match the JAX package's within atol
    2e-6 (one rounding of the parameter) and their global norm is 0.5."""
    paddle.seed(21)
    jm = JaxGPT(JaxGPTConfig(**SMALL))
    jm.train()
    rs = np.random.RandomState(21)
    params = {}
    for name, p in jm.named_parameters():
        a = (rs.normal(0.0, 1.0 / np.sqrt(p.shape[0]), p.shape)
             if len(p.shape) == 2 else
             1.0 + rs.normal(0.0, 0.1, p.shape)).astype(np.float32)
        p.set_value(a)
        params[name] = a
    tm = GPTForCausalLM(GPTConfig(**SMALL), device="cpu")
    load_paddle_state(tm, params)
    tm.train()
    ids = rs.randint(0, 256, (2, 2, 128)).astype(np.int32)
    opt_j = paddle.optimizer.SGD(
        learning_rate=1.0, parameters=jm.parameters(),
        grad_clip=jax_clip.ClipGradByGlobalNorm(0.5))
    loss_j = float(paddle.jit.TrainStep(jm, opt_j, accumulate_steps=2)(
        paddle.to_tensor(ids), paddle.to_tensor(ids)))
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    opt_t = SGD(learning_rate=1.0, parameters=tm.parameters(),
                grad_clip=port_clip.ClipGradByGlobalNorm(0.5))
    ids_t = torch.from_numpy(ids).long()
    loss_t = TrainStep(tm, opt_t, accumulate_steps=2)(ids_t, ids_t)
    np.testing.assert_allclose(loss_t.item(), loss_j, rtol=1e-5)
    after_j = convert_paddle_state(
        {n: np.asarray(p.numpy(), np.float32)
         for n, p in jm.named_parameters()}, tm)
    want = {n: before[n] - after_j[n] for n in before}
    got = {n: before[n] - p.detach() for n, p in tm.named_parameters()}
    norm = torch.sqrt(sum(g.double().square().sum() for g in got.values()))
    assert abs(float(norm) - 0.5) < 1e-4
    for n in got:
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(),
                                   atol=2e-6, err_msg=n)
