"""Gradient accumulation, the GradScaler and AMP casts in the port
(jit.TrainStep(accumulate_steps=, average_grads=, grad_scaler=), amp)
against the JAX package, on the CPU.

The model is the small GPT of test_torch_train.py (hidden 128, 2 heads of
64, 2 blocks, vocab 256) at L = 128 on weights drawn with numpy. The
TrainStep checks read the gradients off one update with SGD at learning
rate 1 (before minus after) in both packages: atol 2e-5 beside rtol 1e-4
(one rounding of the parameter). The AMP checks hold bf16 runs within a
relative L2 error of 2e-2 per leaf (bf16 keeps 8 bits; the frameworks
round at different points).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.amp import GradScaler as JaxScaler
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu_torch import amp
from paddle_tpu_torch.convert import convert_paddle_state, load_paddle_state
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
# SGD without decay, ``p - lr * g``: gradients read off one update
from paddle_tpu_torch.optimizer import SGD, Adam, AdamW

SMALL = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
             max_position_embeddings=256, hidden_dropout_prob=0.0,
             attention_dropout_prob=0.0)
B, L = 2, 128




def _weights(jm, seed):
    rs = np.random.RandomState(seed)
    params = {}
    for name, p in jm.named_parameters():
        shape = tuple(p.shape)
        if name.endswith(("wte.weight", "wpe.weight")):
            a = rs.normal(0.0, 0.2, shape)
        elif len(shape) == 2:
            a = rs.normal(0.0, 1.0 / np.sqrt(shape[0]), shape)
        elif name.endswith("bias"):
            a = rs.normal(0.0, 0.1, shape)
        else:
            a = 1.0 + rs.normal(0.0, 0.1, shape)
        a = a.astype(np.float32)
        p.set_value(a)
        params[name] = a
    return params


def _pair(seed=21, **overrides):
    paddle.seed(seed)
    cfg = dict(SMALL, **overrides)
    jm = JaxGPT(JaxGPTConfig(**cfg))
    jm.train()
    params = _weights(jm, seed)
    tm = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
    load_paddle_state(tm, params)
    return jm, params, tm.train()


def _ids(k, seed=0):
    """``[B, L]`` ids for k = 1, else ``[k, B, L]``."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 256, (max(k, 1), B, L)).astype(np.int32)
    return ids[0] if k == 1 else ids


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _reset(jm, params, tm):
    for n, p in jm.named_parameters():
        p.set_value(params[n])
    load_paddle_state(tm, params)


def _step_grads(jm, params, tm, ids, **kw):
    """One TrainStep update at SGD lr 1 in both packages from the pair's
    weights: (port loss, JAX loss, port gradients, JAX gradients in the
    port's layout)."""
    _reset(jm, params, tm)
    jkw = dict(kw)
    if "grad_scaler" in kw:
        jkw["grad_scaler"] = JaxScaler(init_loss_scaling=kw["grad_scaler"])
        kw["grad_scaler"] = amp.GradScaler(init_loss_scaling=kw["grad_scaler"])
    opt_j = paddle.optimizer.SGD(learning_rate=1.0, parameters=jm.parameters())
    loss_j = float(paddle.jit.TrainStep(jm, opt_j, **jkw)(
        paddle.to_tensor(ids), paddle.to_tensor(ids)))
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    ids_t = torch.from_numpy(ids).long()
    step = TrainStep(tm, SGD(learning_rate=1.0, parameters=tm.parameters()),
                     **kw)
    loss_t = step(ids_t, ids_t).item()
    after_j = convert_paddle_state(
        {n: np.asarray(p.numpy(), np.float32)
         for n, p in jm.named_parameters()}, tm)
    got = {n: before[n] - p.detach() for n, p in tm.named_parameters()}
    want = {n: before[n] - after_j[n] for n in before}
    return loss_t, loss_j, got, want, step


def _close(got, want, **tol):
    for n in got:
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(),
                                   err_msg=n, **tol)


@pytest.mark.parametrize("k,avg", [(1, True), (1, False), (2, True),
                                   (2, False)])
def test_accumulation_matches_jax(pair, k, avg):
    """accumulate_steps=k, average_grads=avg: the loss (the mean of the k
    microbatch losses) and the one update's gradients equal the JAX
    TrainStep's."""
    loss_t, loss_j, got, want, _ = _step_grads(
        *pair, _ids(k), accumulate_steps=k, average_grads=avg)
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    _close(got, want, rtol=1e-4, atol=2e-5)


def test_average_grads_halves_the_sum(pair):
    """At k = 2 the averaged update is the summed one times 1/2 (both
    sums in fp32; 1/2 is exact)."""
    _, _, summed, _, _ = _step_grads(*pair, _ids(2), accumulate_steps=2,
                                     average_grads=False)
    _, _, averaged, _, _ = _step_grads(*pair, _ids(2), accumulate_steps=2)
    for n in summed:
        np.testing.assert_allclose(averaged[n].numpy(),
                                   summed[n].numpy() / 2, atol=1e-6)


def test_k1_equals_the_plain_step_bit_for_bit():
    """accumulate_steps=1 (with either average_grads) is the plain eager
    step (``loss.backward(); opt.step(); opt.clear_grad()``): three AdamW
    steps give the same parameters bit for bit."""
    out = []
    ids = torch.from_numpy(_ids(1)).long()
    for kw in (None, {}, {"accumulate_steps": 1, "average_grads": False}):
        _, _, tm = _pair()
        opt = AdamW(learning_rate=1e-3, parameters=tm.parameters())
        step = None if kw is None else TrainStep(tm, opt, **kw)
        for _ in range(3):
            if step is not None:
                step(ids, ids)
                continue
            tm(ids, ids)[1].backward()
            opt.step()
            opt.clear_grad()
        out.append([p.detach().clone() for p in tm.parameters()])
    for got in out[1:]:
        for a, b in zip(got, out[0]):
            assert torch.equal(a, b)


class _JaxTwo(paddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.used = paddle.nn.Linear(4, 4)
        self.unused = paddle.nn.Linear(4, 4)

    def forward(self, x):
        return (self.used(x) ** 2).mean()


class _TorchTwo(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.used = torch.nn.Linear(4, 4)
        self.unused = torch.nn.Linear(4, 4)

    def forward(self, x):
        return (self.used(x) ** 2).mean()


@pytest.mark.parametrize("k", [1, 2])
def test_unused_parameter_is_updated_as_jax(k):
    """A parameter the loss does not reach gets a zero gradient and the
    update all the same (AdamW's decay applied, its moments made), at
    K = 1 as at K = 2, as in the JAX TrainStep: every parameter after one
    step within 1e-6 of the JAX package's."""
    rs = np.random.RandomState(3)
    jm, tm = _JaxTwo(), _TorchTwo()
    with torch.no_grad():
        for (_, pj), (_, pt) in zip(jm.named_parameters(),
                                    tm.named_parameters()):
            a = rs.normal(0.0, 0.5, tuple(pj.shape)).astype(np.float32)
            pj.set_value(a)
            pt.copy_(torch.from_numpy(a.T.copy() if a.ndim == 2 else a))
    x = rs.normal(0.0, 1.0, (k, 3, 4) if k > 1 else (3, 4)) \
        .astype(np.float32)
    kw = {"accumulate_steps": k} if k > 1 else {}
    opt_j = paddle.optimizer.AdamW(learning_rate=0.1, weight_decay=0.5,
                                   parameters=jm.parameters())
    paddle.jit.TrainStep(jm, opt_j, **kw)(paddle.to_tensor(x))
    opt_t = AdamW(learning_rate=0.1, weight_decay=0.5,
                  parameters=tm.parameters())
    before = tm.unused.weight.detach().clone()
    TrainStep(tm, opt_t, **kw)(torch.from_numpy(x))
    assert opt_t._step_count == 1
    assert not torch.equal(tm.unused.weight, before)
    for (n, pj), (_, pt) in zip(jm.named_parameters(),
                                tm.named_parameters()):
        a = np.asarray(pj.numpy(), np.float32)
        np.testing.assert_allclose(pt.detach().numpy(),
                                   a.T if a.ndim == 2 else a, atol=1e-6,
                                   err_msg=n)


def test_unstacked_input_raises(pair):
    _, _, tm = pair
    step = TrainStep(tm, AdamW(parameters=tm.parameters()),
                     accumulate_steps=2)
    ids = torch.from_numpy(_ids(1)).long()[:1]          # [1, L]: not K
    with pytest.raises(ValueError, match="leading axis 2"):
        step(ids, ids)
    with pytest.raises(ValueError, match="leading axis 2"):
        step(torch.from_numpy(_ids(2)).long(), None)


def test_recompute_inside_accumulation_is_bit_for_bit():
    """accumulate_steps=2 with "selective" and "full" recompute gives the
    parameters of the run without recompute bit for bit (AdamW, bf16
    parameters with fp32 masters)."""
    out = []
    for policy in ("none", "selective", "full"):
        tm = GPTForCausalLM(GPTConfig(**SMALL), device="cpu",
                            dtype=torch.bfloat16, seed=4).train()
        tm.enable_recompute(policy)
        opt = AdamW(learning_rate=1e-3, parameters=tm.parameters(),
                    multi_precision=True)
        ids = torch.from_numpy(_ids(2)).long()
        TrainStep(tm, opt, accumulate_steps=2)(ids, ids)
        out.append([opt._master_weights[id(p)].clone()
                    for p in tm.parameters()])
    for got in out[1:]:
        for a, b in zip(got, out[0]):
            assert torch.equal(a, b)


def test_scaler_clean_window_matches_jax(pair):
    """grad_scaler=GradScaler(1024) at k = 2: the loss is scaled before
    each backward and the sum unscaled once; the clean window's update
    equals the JAX TrainStep's and leaves the scale alone."""
    loss_t, loss_j, got, want, step = _step_grads(
        *pair, _ids(2), accumulate_steps=2, grad_scaler=1024.0)
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    _close(got, want, rtol=1e-4, atol=2e-5)
    assert step._scaler._scale == 1024.0 and step._scaler._good_steps == 1


class MLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(7)
        self.fc1 = torch.nn.Linear(8, 16)
        self.fc2 = torch.nn.Linear(16, 4)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.3)

    def forward(self, x, labels):
        h = self.fc2(torch.relu(self.fc1(x))).float()
        return torch.nn.functional.cross_entropy(h, labels)


def test_inf_microbatch_skips_the_window_and_halves_the_scale():
    """An inf in one microbatch of two: parameters (bf16), fp32 masters and
    moments stay bit for bit, the step counter does not advance, the scale
    halves and its counters reset; two clean steps at
    incr_every_n_steps=2 bring it back."""
    m = MLP().to(torch.bfloat16)
    opt = AdamW(learning_rate=0.1, weight_decay=0.0,
                parameters=m.parameters(), multi_precision=True)
    sc = amp.GradScaler(init_loss_scaling=1024.0, incr_every_n_steps=2)
    step = TrainStep(m, opt, accumulate_steps=2, grad_scaler=sc)
    rs = np.random.RandomState(0)
    xs = torch.from_numpy(rs.randn(2, 16, 8).astype(np.float32)).bfloat16()
    ys = torch.from_numpy(rs.randint(0, 4, (2, 16)))
    step(xs, ys)
    assert sc._good_steps == 1 and sc._scale == 1024.0
    snap = [(p.clone(), opt._master_weights[id(p)].clone(),
             {k: v.clone() for k, v in opt._accumulators[id(p)].items()})
            for p in m.parameters()]
    count = opt._step_count
    bad = xs.clone()
    bad[1] = float("inf")
    loss = step(bad, ys)
    assert not torch.isfinite(loss)
    for p, (p0, m0, st0) in zip(m.parameters(), snap):
        assert torch.equal(p, p0)
        assert torch.equal(opt._master_weights[id(p)], m0)
        for k, v in opt._accumulators[id(p)].items():
            assert torch.equal(v, st0[k])
    assert opt._step_count == count
    assert sc._scale == 512.0 and sc._good_steps == 0 and sc._bad_steps == 0
    step(xs, ys)
    step(xs, ys)
    assert sc._scale == 1024.0 and opt._step_count == count + 2


def test_state_machine_matches_jax_scaler():
    """A scripted sequence of found-inf flags through the port's
    _compiled_outcome and the JAX scaler's eager update(): the same
    scale and counters after every step, and state_dict round trips."""
    seq = [False, True, False, False, True, True, False, False, False]
    j = JaxScaler(init_loss_scaling=256.0, incr_every_n_steps=2,
                  decr_every_n_nan_or_inf=2)
    t = amp.GradScaler(init_loss_scaling=256.0, incr_every_n_steps=2,
                       decr_every_n_nan_or_inf=2)
    for bad in seq:
        j._found_inf = bad
        j._unscaled = True
        j.update()
        t._compiled_outcome(bad)
        assert (t._scale, t._good_steps, t._bad_steps) == \
            (j._scale, j._good_steps, j._bad_steps)
    assert t.state_dict() == j.state_dict()
    u = amp.AmpScaler()
    u.load_state_dict(t.state_dict())
    assert u.get_init_loss_scaling() == t._scale
    assert u._good_steps == t._good_steps


def test_eager_scale_step_update():
    """The eager calls on a linear map: scale(loss).backward(), step()
    (unscale, update) and update(), then minimize() (step() + update()),
    equal plain Adam steps on the unscaled loss bit for bit (the scale is a
    power of two); a gradient that is not finite skips the update and
    halves the scale. (The JAX package's eager ``_unscale`` calls
    ``jnp.isfinite`` on a framework Tensor, which this JAX refuses, so the
    eager calls are held to the port's plain steps; the state machine is
    held to the JAX scaler above.)"""
    rs = np.random.RandomState(3)
    w0, x = rs.randn(8, 4).astype(np.float32), \
        torch.from_numpy(rs.randn(16, 8).astype(np.float32))
    wt = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    wp = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt_t = Adam(learning_rate=0.1, parameters=[wt])
    opt_p = Adam(learning_rate=0.1, parameters=[wp])
    st = amp.GradScaler(init_loss_scaling=64.0)
    for i in range(2):
        st.scale(((x @ wt) ** 2).mean()).backward()
        if i == 0:
            st.step(opt_t)
            st.update()
        else:
            st.minimize(opt_t, None)
        opt_t.clear_grad()
        ((x @ wp) ** 2).mean().backward()
        opt_p.step()
        opt_p.clear_grad()
        assert torch.equal(wt, wp)
    before = wt.detach().clone()
    wt.grad = torch.full_like(wt, float("nan"))
    st.step(opt_t)
    st.update()
    assert torch.equal(wt.detach(), before) and st._scale == 32.0
    assert amp.GradScaler(enable=False).scale(torch.ones(())) == 1.0


def _jax_loss_grads(jm, ids, level):
    """Loss and gradients of the JAX TrainStep traced under auto_cast
    (eager JAX autodiff refuses the casts): SGD at lr 1, the gradient read
    off the fp32 masters where O2 keeps them, else off the parameters."""
    if level == "O2":
        jm = paddle.amp.decorate(jm, level="O2")
    opt = paddle.optimizer.SGD(learning_rate=1.0, parameters=jm.parameters(),
                               multi_precision=level == "O2")
    named = list(jm.named_parameters())
    before = {n: np.asarray(p.numpy(), np.float32) for n, p in named}
    with paddle.amp.auto_cast(level=level):
        loss = float(paddle.jit.TrainStep(jm, opt)(paddle.to_tensor(ids),
                                                  paddle.to_tensor(ids)))
    after = {n: np.asarray(opt._master_weights[id(p)] if level == "O2"
                           else p.numpy(), np.float32) for n, p in named}
    return loss, {n: before[n] - after[n] for n in before}


def _port_loss_grads(tm, ids, level, **kw):
    ids_t = torch.from_numpy(ids).long()
    with amp.auto_cast(level=level, **kw):
        _, loss = tm(ids_t, ids_t)
    loss.backward()
    grads = {n: p.grad.float() for n, p in tm.named_parameters()}
    tm.zero_grad(set_to_none=True)
    return loss.item(), grads


def _rel_close(got, want, tol):
    for n, g in got.items():
        w = want[n]
        err = float((g - w).norm() / w.norm().clamp_min(1e-12))
        assert err < tol, (n, err)


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_auto_cast_matches_jax(level):
    """auto_cast on the fp32 GPT (O1), and decorate + auto_cast O2 (bf16
    parameters): the loss within 1e-2 relative and every leaf gradient
    within 2e-2 relative L2 error of the JAX package's; O1 keeps the
    parameters fp32 and gives the linears bf16 outputs."""
    jm, params, tm = _pair()
    ids = _ids(1)
    if level == "O2":
        opt = AdamW(parameters=tm.parameters())
        tm2, opt2 = amp.decorate(tm, opt, level="O2")
        assert tm2 is tm and opt2 is opt and opt._multi_precision
        assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    loss_t, grads_t = _port_loss_grads(tm, ids, level)
    loss_j, grads_j = _jax_loss_grads(jm, ids, level)
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-2)
    _rel_close(grads_t, convert_paddle_state(grads_j, tm), 2e-2)
    if level == "O1":
        x = torch.randn(2, 128)
        with amp.auto_cast():
            y = tm.gpt.h[0].mlp.fc_in(x)
            z = torch.nn.functional.layer_norm(y, (512,))
        assert y.dtype == torch.bfloat16 and z.dtype == torch.float32
        assert all(p.dtype == torch.float32 for p in tm.parameters())


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_train_step_under_auto_cast_is_the_eager_loop(level):
    """TrainStep called inside auto_cast (O1 on the fp32 GPT, O2 on the
    decorated one, AdamW with fp32 masters) casts its forward only: two
    steps give the parameters and masters of the eager loop whose forward
    alone runs inside auto_cast, bit for bit."""
    out = []
    ids = torch.from_numpy(_ids(1)).long()
    for eager in (True, False):
        _, _, tm = _pair()
        opt = AdamW(learning_rate=1e-3, parameters=tm.parameters(),
                    multi_precision=True)
        if level == "O2":
            amp.decorate(tm, opt, level="O2")
        step = TrainStep(tm, opt)
        for _ in range(2):
            if eager:
                with amp.auto_cast(level=level):
                    _, loss = tm(ids, ids)
                loss.backward()
                opt.step()
                opt.clear_grad()
            else:
                with amp.auto_cast(level=level):
                    step(ids, ids)
        out.append([p.detach().clone() for p in tm.parameters()]
                   + [m.clone() for m in opt._master_weights.values()])
    assert len(out[0]) == len(out[1])
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_custom_lists_and_disabled_cast():
    """custom_black_list={"linear"} keeps the linears in fp32 (the fp32
    forward bit for bit: nothing else in the GPT is white), a custom white
    op runs in bf16, enable=False casts nothing, and the state is gone
    after the block."""
    _, _, tm = _pair()
    ids = torch.from_numpy(_ids(1)).long()
    with torch.no_grad():
        _, plain = tm(ids, ids)
        with amp.auto_cast(custom_black_list={"linear"}):
            _, black = tm(ids, ids)
        with amp.auto_cast(enable=False):
            _, off = tm(ids, ids)
        with amp.auto_cast():
            _, o1 = tm(ids, ids)
    assert torch.equal(black, plain) and torch.equal(off, plain)
    assert not torch.equal(o1, plain)
    x = torch.randn(4, 4)
    with amp.auto_cast(custom_white_list={"tanh"}):
        assert torch.tanh(x).dtype == torch.bfloat16
        assert torch.sigmoid(x).dtype == torch.float32
    assert torch.tanh(x).dtype == torch.float32
    with pytest.raises(ValueError, match="level"):
        amp.auto_cast(level="O3")
