"""The port's training path (paddle_tpu_torch: GPT loss, AdamW with fp32
masters, TrainStep, LR schedulers) against the JAX package's, on the same
weights and batch, in fp32 on the CPU (bf16 where stated).

The model is the small GPT of test_torch_gpt.py (hidden 128, 2 heads of
64, 2 blocks, vocab 256) at L = 160 with some labels at -100; weights are
drawn with numpy and loaded into both packages.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.optimizer import lr as jax_lr
from paddle_tpu_torch.convert import convert_paddle_state, load_paddle_state
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.optimizer import lr as port_lr

SMALL = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
             max_position_embeddings=256, hidden_dropout_prob=0.0,
             attention_dropout_prob=0.0)
B, L = 2, 160


def _weights(jm, seed):
    """Numpy weights at a scale where attention matters (matrices ~ N(0,
    1/fan_in), embeddings ~ N(0, 0.2^2), LayerNorm near its init), set on
    the JAX model and returned for the port."""
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


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, SMALL["vocab_size"], (B, L)).astype(np.int32)
    labels = ids.copy()
    labels[0, 5:17] = -100                     # ignored targets
    labels[1, -3:] = -100
    return ids, labels


def _pair(seed=21, dtype="float32"):
    """A JAX GPT in training mode and the port GPT on the same weights."""
    paddle.seed(seed)
    jm = JaxGPT(JaxGPTConfig(**SMALL))
    jm.train()
    params = _weights(jm, seed)
    if dtype == "bfloat16":
        for _, p in jm.named_parameters():      # bench.py's bf16 recipe
            p._data = p.value().astype("bfloat16")
    tm = GPTForCausalLM(GPTConfig(**SMALL), device="cpu", dtype=dtype)
    load_paddle_state(tm, params)
    tm.train()
    return jm, params, tm


def _np(t):
    return np.asarray(t.numpy(), dtype=np.float32)


@pytest.fixture(scope="module")
def fp32_pair():
    return _pair()


def test_loss_matches_jax(fp32_pair):
    """model(ids, labels) -> (None, loss): the shifted next-token CE with
    ignored labels, against the JAX model's on the same weights."""
    jm, _, tm = fp32_pair
    ids, labels = _batch()
    none_j, loss_j = jm(paddle.to_tensor(ids), paddle.to_tensor(labels))
    none_t, loss_t = tm(torch.from_numpy(ids).long(),
                        torch.from_numpy(labels).long())
    assert none_j is None and none_t is None
    assert loss_t.dim() == 0 and loss_t.dtype == torch.float32
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)


def test_all_labels_ignored_gives_zero_loss(fp32_pair):
    _, _, tm = fp32_pair
    ids, _ = _batch()
    _, loss = tm(torch.from_numpy(ids).long(),
                 torch.full((B, L), -100, dtype=torch.long))
    assert loss.item() == 0.0                  # sum 0 over max(n_valid, 1)


def test_every_leaf_gradient_matches_jax(fp32_pair):
    """loss.backward() in both packages: every leaf's gradient, mapped to
    the port's layout by convert_paddle_state as weights are, including
    the tied wte that receives the embedding and the head terms."""
    jm, params, tm = fp32_pair
    tm.zero_grad(set_to_none=True)
    ids, labels = _batch()
    _, loss_j = jm(paddle.to_tensor(ids), paddle.to_tensor(labels))
    loss_j.backward()
    grads_j = {n: _np(p.grad) for n, p in jm.named_parameters()}
    assert set(grads_j) == set(params)
    want = convert_paddle_state(grads_j, tm)
    _, loss_t = tm(torch.from_numpy(ids).long(),
                   torch.from_numpy(labels).long())
    loss_t.backward()
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_three_train_steps_match_jax():
    """3 TrainStep + AdamW(1e-3, wd 0.01) calls on a repeated batch against
    the JAX package's: the loss of every step within rtol 1e-5, and every
    parameter after step 3 within atol 5e-6 wherever its first gradient is
    above 1e-5 of its leaf's largest (the largest difference there is
    printed). Below that the gradient is at the fp32 noise floor (the key
    bias's is exactly 0: softmax ignores a per-row shift), Adam's
    normalised step turns noise into up to +-lr per step in either package,
    and those entries are held to that bound, 3 * 2 * lr."""
    jm, _, tm = _pair()
    ids, labels = _batch()
    opt_j = paddle.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                                   parameters=jm.parameters())
    step_j = paddle.jit.TrainStep(jm, opt_j)
    opt_t = AdamW(learning_rate=1e-3, weight_decay=0.01,
                  parameters=tm.parameters())
    step_t = TrainStep(tm, opt_t)
    first = {}

    def keep_first(name):
        def hook(grad):
            first.setdefault(name, grad.abs())
        return hook

    hooks = [p.register_hook(keep_first(n)) for n, p in tm.named_parameters()]
    ids_t, labels_t = torch.from_numpy(ids).long(), \
        torch.from_numpy(labels).long()
    losses_j, losses_t = [], []
    for _ in range(3):
        losses_j.append(float(step_j(paddle.to_tensor(ids),
                                     paddle.to_tensor(labels))))
        losses_t.append(step_t(ids_t, labels_t).item())
    for h in hooks:
        h.remove()
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    assert losses_t[2] < losses_t[0]
    want = convert_paddle_state({n: _np(p) for n, p in jm.named_parameters()},
                                tm)
    worst = 0.0
    for name, p in tm.named_parameters():
        diff = (p.detach() - want[name]).abs()
        live = first[name] > 1e-5 * first[name].max()
        worst = max(worst, float(diff[live].max()))
        assert float(diff[live].max()) < 5e-6, name
        assert float(diff.max()) <= 6e-3, name
    print(f"largest parameter difference after 3 steps: {worst:.3g}")
    assert all(p.grad is None for p in tm.parameters())   # clear_grad ran


def test_bf16_multi_precision_matches_jax():
    """bf16 parameters with fp32 masters (bench.py's recipe): masters are
    fp32 and each parameter is its master cast to bf16 after every step,
    losses are finite and within 2e-2 relative of the JAX package's (bf16
    activations round at different points in the two frameworks)."""
    jm, _, tm = _pair(dtype="bfloat16")
    ids, labels = _batch()
    opt_j = paddle.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                                   parameters=jm.parameters(),
                                   multi_precision=True)
    step_j = paddle.jit.TrainStep(jm, opt_j)
    opt_t = AdamW(learning_rate=1e-3, weight_decay=0.01,
                  parameters=tm.parameters(), multi_precision=True)
    step_t = TrainStep(tm, opt_t)
    ids_t, labels_t = torch.from_numpy(ids).long(), \
        torch.from_numpy(labels).long()
    for _ in range(3):
        loss_j = float(step_j(paddle.to_tensor(ids),
                              paddle.to_tensor(labels)))
        loss_t = step_t(ids_t, labels_t)
        assert torch.isfinite(loss_t)
        np.testing.assert_allclose(loss_t.item(), loss_j, rtol=2e-2)
        for p in tm.parameters():
            master = opt_t._master_weights[id(p)]
            assert p.dtype == torch.bfloat16 and master.dtype == torch.float32
            assert torch.equal(p, master.to(torch.bfloat16))
    assert all(st["moment1"].dtype == torch.float32
               for st in opt_t._accumulators.values())


def test_adam_l2_decay_and_scheduler_match_jax():
    """Adam with coupled (L2) decay driven by a StepDecay scheduler, two
    steps, against the JAX package on one linear map."""
    rs = np.random.RandomState(3)
    w0 = rs.randn(8, 4).astype(np.float32)
    x = rs.randn(16, 8).astype(np.float32)
    sched_j = jax_lr.StepDecay(0.01, step_size=1, gamma=0.5)
    wj = paddle.create_parameter([8, 4], "float32")
    wj.set_value(w0)
    opt_j = paddle.optimizer.Adam(learning_rate=sched_j, parameters=[wj],
                                  weight_decay=0.1)
    sched_t = port_lr.StepDecay(0.01, step_size=1, gamma=0.5)
    wt = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt_t = Adam(learning_rate=sched_t, parameters=[wt], weight_decay=0.1)
    for _ in range(2):
        (paddle.to_tensor(x).matmul(wj) ** 2).sum().backward()
        opt_j.step()
        opt_j.clear_grad()
        sched_j.step()
        ((torch.from_numpy(x) @ wt) ** 2).sum().backward()
        opt_t.step()
        opt_t.clear_grad()
        sched_t.step()
    assert opt_t.get_lr() == opt_j.get_lr() == 0.0025
    np.testing.assert_allclose(wt.detach().numpy(), _np(wj), rtol=1e-5,
                               atol=1e-6)


def _sched_cases():
    lam = lambda e: 0.9 ** e                                   # noqa: E731
    return {
        "NoamDecay": lambda m: m.NoamDecay(d_model=64, warmup_steps=5,
                                           learning_rate=2.0),
        "PiecewiseDecay": lambda m: m.PiecewiseDecay([3, 8], [0.1, 0.05,
                                                              0.01]),
        "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.5, gamma=0.1),
        "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.5, gamma=0.2),
        "PolynomialDecay": lambda m: m.PolynomialDecay(0.5, decay_steps=7,
                                                       end_lr=0.01,
                                                       power=2.0, cycle=True),
        "LinearWarmup": lambda m: m.LinearWarmup(
            m.CosineAnnealingDecay(0.5, T_max=10), warmup_steps=5,
            start_lr=0.0, end_lr=0.5),
        "ExponentialDecay": lambda m: m.ExponentialDecay(0.5, gamma=0.9),
        "MultiStepDecay": lambda m: m.MultiStepDecay(0.5, milestones=[4, 9],
                                                     gamma=0.3),
        "StepDecay": lambda m: m.StepDecay(0.5, step_size=3, gamma=0.5),
        "LambdaDecay": lambda m: m.LambdaDecay(0.5, lam),
        "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(0.5, patience=2,
                                                       factor=0.5),
        "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(
            0.5, T_max=12, eta_min=0.01),
        "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(0.5, lam),
        "OneCycleLR": lambda m: m.OneCycleLR(0.5, total_steps=15,
                                             three_phase=False),
        "CyclicLR": lambda m: m.CyclicLR(0.01, 0.5, step_size_up=4,
                                         mode="triangular2"),
    }


@pytest.mark.parametrize("name", sorted(_sched_cases()))
def test_lr_scheduler_first_values_match_jax(name):
    make = _sched_cases()[name]
    sj, st = make(jax_lr), make(port_lr)
    assert type(st).__name__ == name and isinstance(st, port_lr.LRScheduler)
    got, want = [], []
    for i in range(20):
        got.append(st())
        want.append(sj())
        if name == "ReduceOnPlateau":          # a loss that stalls at step 6
            metric = max(1.0 - 0.1 * i, 0.4)
            st.step(metric)
            sj.step(metric)
        else:
            st.step()
            sj.step()
    assert got == want
    assert len(set(got)) > 1


@pytest.mark.parametrize("knob", ["accumulate_steps", "average_grads",
                                  "grad_scaler", "recompute", "checkpoint",
                                  "grad_clip", "apply_decay_param_fun",
                                  "lazy_mode", "regularizer",
                                  "train_dropout"])
def test_unported_knobs_raise(knob):
    tm = GPTForCausalLM(GPTConfig(**dict(SMALL, num_layers=1)), device="cpu")
    params = list(tm.parameters())
    opt = AdamW(parameters=params)
    if knob in ("accumulate_steps", "average_grads", "grad_scaler"):
        value = {"accumulate_steps": 2, "average_grads": True,
                 "grad_scaler": object()}[knob]
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TrainStep(tm, opt, **{knob: value})
    elif knob == "recompute":
        tm.config.recompute_granularity = "full"
        with pytest.raises(NotImplementedError, match="recompute"):
            TrainStep(tm, opt)
    elif knob == "checkpoint":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TrainStep(tm, opt).save_checkpoint("ckpt", 1)
    elif knob == "grad_clip":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            AdamW(parameters=params, grad_clip=1.0)
    elif knob == "apply_decay_param_fun":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            AdamW(parameters=params, apply_decay_param_fun=lambda n: True)
    elif knob == "lazy_mode":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Adam(parameters=params, lazy_mode=True)
    elif knob == "regularizer":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            AdamW(parameters=params, weight_decay=object())
    else:
        cfg = GPTConfig(**dict(SMALL, num_layers=1, hidden_dropout_prob=0.1))
        m = GPTForCausalLM(cfg, device="cpu").train()
        with pytest.raises(NotImplementedError, match="slice 4"):
            m(torch.zeros(1, 8, dtype=torch.long))


def test_optimizer_updates_the_parameters_the_model_holds():
    """step() writes into the same Parameter objects (in place), and
    set_lr takes a float or a scheduler."""
    tm = GPTForCausalLM(GPTConfig(**dict(SMALL, num_layers=1)), device="cpu",
                        dtype="bfloat16")
    before = {n: (p, p.detach().clone()) for n, p in tm.named_parameters()}
    opt = AdamW(learning_rate=1e-2, parameters=tm.parameters(),
                multi_precision=True)
    ids, labels = _batch()
    TrainStep(tm, opt)(torch.from_numpy(ids).long(),
                       torch.from_numpy(labels).long())
    for n, p in tm.named_parameters():
        assert p is before[n][0]
    assert not torch.equal(tm.gpt.wte.weight, before["gpt.wte.weight"][1])
    opt.set_lr(5e-3)
    assert opt.get_lr() == 5e-3
    opt.set_lr(port_lr.StepDecay(0.1, step_size=2))
    assert opt.get_lr() == 0.1
    with pytest.raises(RuntimeError):
        opt.set_lr(0.2)
