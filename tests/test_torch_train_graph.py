"""The port's compiled train step (``TrainStep(fast_path=True)``, a CUDA
graph on the card, its body run eagerly through the same staged buffers on
the CPU) against the eager step (``fast_path=False``) and against the JAX
package's ``TrainStep``, on the CPU (fp32; bf16 where stated).

* bit for bit with the eager step over 3 steps: loss, every parameter,
  master and moment, the step count, the scaler's state and every
  generator, at dropout 0.1, under accumulation, selective recompute, a
  scaler overflow and a clip (GPT, BERT packed, LLaMA);
* the seeds the kernels' plain versions receive, call for call, including
  the recompute's replays; a body that draws otherwise raises;
* Adam's staged step scalars against its host floats, steps 1-1000;
* ``num_compiles`` beside the JAX ``TrainStep``'s on the call sequences of
  ``tests/test_train_step.py`` and ``tests/test_health.py``;
* 3 fast-path steps held to the JAX package with
  ``tests/test_torch_train.py``'s tolerance; the monitor's records;
* ``cuda``-marked counterparts that skip without a card.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import monitor as jmon
from paddle_tpu.jit import train_step as jax_ts
from paddle_tpu_torch import amp
from paddle_tpu_torch import monitor as tmon
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import convert_paddle_state
from paddle_tpu_torch.core import random as rnd
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.kernels import philox
from paddle_tpu_torch.models import (BertConfig, BertForPreTraining,
                                     GPTConfig, GPTForCausalLM,
                                     LlamaForCausalLM, llama_tiny)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer.optimizer import adam_scalars, adam_update
from test_torch_accum_amp import SGD
from test_torch_train import _batch, _np, _pair

GPT_DROP = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
                max_position_embeddings=256, hidden_dropout_prob=0.1,
                attention_dropout_prob=0.1)
BERT_DROP = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
                 intermediate_size=256, max_position_embeddings=128,
                 hidden_dropout_prob=0.1, attention_dropout_prob=0.1)
LLAMA_SMALL = dict(hidden_size=256, num_heads=4, num_kv_heads=2,
                   intermediate_size=512, num_layers=2, vocab_size=256,
                   max_position_embeddings=256)
B, L = 2, 128
STEPS = 3


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's kernels)")


def _ids(shape, seed, vocab=256, device="cpu"):
    rs = np.random.RandomState(seed)
    return torch.from_numpy(rs.randint(0, vocab, shape)).long().to(device)


# ---------------------------------------------------------- the cases


def _gpt(device, **over):
    m = GPTForCausalLM(GPTConfig(**dict(GPT_DROP, **over)), device=device,
                       seed=5)
    return m.train()


def _case(name, device="cpu"):
    """(model, optimizer kwargs, TrainStep kwargs, inputs per call, a hook
    run on the model before call i or None) of one bit-for-bit case."""
    ids = _ids((B, L), 1, device=device)
    gpt_in = [(ids, ids)] * STEPS
    if name == "gpt-dropout":
        return _gpt(device), {}, {}, gpt_in, None
    if name == "gpt-accum":
        st = _ids((2, B, L), 2, device=device)
        return _gpt(device), {}, dict(accumulate_steps=2), \
            [(st, st)] * STEPS, None
    if name == "gpt-selective":
        m = _gpt(device)
        m.enable_recompute("selective")
        return m, {}, {}, gpt_in, None
    if name == "gpt-full":
        m = _gpt(device)
        m.enable_recompute("full")
        return m, {}, {}, gpt_in, None
    if name == "gpt-clip":
        return _gpt(device), dict(grad_clip=tnn.ClipGradByNorm(0.05)), {}, \
            gpt_in, None
    if name == "gpt-overflow":
        def poison(model, i):
            # the second update overflows (and is skipped, so the poison
            # is taken back by hand before the third)
            with torch.no_grad():
                w = model.gpt.wpe.weight
                if i == 1:
                    poison.kept = w[3, 0].clone()
                    w[3, 0] = float("inf")
                elif i == 2:
                    w[3, 0] = poison.kept
        return _gpt(device), {}, dict(grad_scaler=amp.GradScaler(
            init_loss_scaling=1024.0, incr_every_n_steps=2)), gpt_in, poison
    if name == "bert-dropout":
        m = BertForPreTraining(BertConfig(**BERT_DROP), device=device,
                               seed=5).train()
        tt = torch.zeros_like(ids)
        mlm = ids.clone()
        mlm[:, ::3] = -100
        nsp = torch.tensor([0, 1], device=device)
        return m, {}, {}, [(ids, tt, None, mlm, nsp)] * STEPS, None
    if name == "llama":
        m = LlamaForCausalLM(llama_tiny(**LLAMA_SMALL), device=device,
                             seed=5).train()
        return m, {}, {}, gpt_in, None
    raise KeyError(name)


CASES = ("gpt-dropout", "gpt-accum", "gpt-selective", "gpt-clip",
         "gpt-overflow", "bert-dropout", "llama")


def _run(name, fast, device="cpu", multi_precision=False, dtype=None):
    model, okw, skw, calls, hook = _case(name, device)
    if dtype is not None:
        model.to(dtype)
    opt = AdamW(learning_rate=1e-3, weight_decay=0.01,
                parameters=model.parameters(),
                multi_precision=multi_precision, **okw)
    step = TrainStep(model, opt, fast_path=fast, **skw)
    losses = []
    for i, args in enumerate(calls):
        if hook is not None:
            hook(model, i)
        losses.append(step(*args).detach().clone())
    return model, opt, step, losses


def _state(model, opt, step):
    """Everything a step leaves behind, as tensors and plain values."""
    out = {f"p:{n}": p.detach().clone() for n, p in model.named_parameters()}
    params = opt._parameter_list
    for i, p in enumerate(params):
        for k, t in opt._accumulators.get(id(p), {}).items():
            out[f"{k}:{i}"] = t.clone()
        if id(p) in opt._master_weights:
            out[f"master:{i}"] = opt._master_weights[id(p)].clone()
    out["step_count"] = opt._step_count
    if step._scaler is not None:
        out["scaler"] = step._scaler.state_dict()
    gen = getattr(model, "generator", None)
    if gen is not None:
        out["generator"] = gen.get_state()
    out["chain"] = rnd.get_rng_state()
    return out


def _bits(t):
    """A tensor's bits (NaN equals NaN when its bits do)."""
    if t.is_floating_point():
        return t.contiguous().view({2: torch.int16, 4: torch.int32,
                                    8: torch.int64}[t.element_size()])
    return t


def _equal(a, b):
    return a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if torch.is_tensor(a[k]):
            assert _equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.fixture(autouse=True)
def _chain():
    """Restore the global chain after each test (xdist workers share it)."""
    state = rnd.get_rng_state()
    yield
    rnd.set_rng_state(state)
    tmon.disable()
    jmon.disable()


@pytest.mark.parametrize("name", CASES)
def test_fast_path_equals_eager_bit_for_bit(name):
    """3 steps each way from the same start: the losses, every parameter,
    moment and master, the step count, the scaler and the generators."""
    rnd.seed(11)
    m_e, o_e, s_e, l_e = _run(name, fast=False)
    rnd.seed(11)
    m_f, o_f, s_f, l_f = _run(name, fast=True)
    assert all(_equal(a, b) for a, b in zip(l_e, l_f)), (l_e, l_f)
    _same(_state(m_e, o_e, s_e), _state(m_f, o_f, s_f))
    assert s_f.num_compiles == 1 and s_e.num_compiles == 1
    if name == "gpt-overflow":
        assert [math.isfinite(float(x)) for x in l_f] == [True, False, True]
        assert o_f._step_count == STEPS - 1           # the skip is undone
        assert s_f._scaler._scale == 512.0


def test_bf16_masters_fast_equals_eager():
    """bf16 weights with fp32 masters (the card's recipe), asked for and
    not (a bf16 weight gets its master either way): the staged scalars
    round as the host floats."""
    for mp in (True, False):
        rnd.seed(3)
        a = _run("gpt-dropout", fast=False, multi_precision=mp,
                 dtype=torch.bfloat16)
        rnd.seed(3)
        b = _run("gpt-dropout", fast=True, multi_precision=mp,
                 dtype=torch.bfloat16)
        _same(_state(*a[:3]), _state(*b[:3]))


class _TwoStreams(torch.nn.Module):
    """Dropout from its own generator and from the global chain."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.a = torch.nn.Linear(64, 64)
        self.b = torch.nn.Linear(64, 8)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.2)
        self.generator = rnd.make_generator(9)

    def forward(self, x):
        h = F.dropout(self.a(x), 0.2, training=True,
                      generator=self.generator)
        h = F.dropout(torch.tanh(h), 0.3, training=True)   # global chain
        return (self.b(h) ** 2).mean()


@pytest.mark.parametrize("n", [1, 5])
def test_generators_end_where_the_eager_steps_leave_them(n):
    x = torch.randn(16, 64, generator=torch.Generator().manual_seed(1))
    out = {}
    for fast in (False, True):
        rnd.seed(4)
        torch.manual_seed(0)
        m = _TwoStreams()
        step = TrainStep(m, AdamW(parameters=m.parameters()), fast_path=fast)
        losses = [step(x).clone() for _ in range(n)]
        out[fast] = (losses, m.generator.get_state(), rnd.get_rng_state(),
                     [p.detach().clone() for p in m.parameters()])
    (le, ge, ce, pe), (lf, gf, cf, pf) = out[False], out[True]
    assert all(torch.equal(a, b) for a, b in zip(le, lf))
    assert torch.equal(ge, gf) and torch.equal(ce, cf)
    assert all(torch.equal(a, b) for a, b in zip(pe, pf))
    if n > 1:
        assert not torch.equal(le[0], le[1])       # the masks move on


def _spy_seeds(monkeypatch):
    """Record, in order, the int of every seed the plain dropout versions
    receive (a staged seed reads as its value on the CPU)."""
    seen = []
    for fn in ("row_keep", "attention_keep"):
        real = getattr(philox, fn)

        def spy(seed, *a, _real=real, **k):
            seen.append(int(seed) if not isinstance(seed, int) else seed)
            return _real(seed, *a, **k)
        monkeypatch.setattr(philox, fn, spy)
    return seen


@pytest.mark.parametrize("name", ["gpt-dropout", "gpt-full",
                                  "bert-dropout"])
def test_staged_seeds_are_the_eager_draws(monkeypatch, name):
    """Call for call the kernels' plain versions get the eager step's
    seeds, the recompute's replays included (under "full" each block's
    forward runs twice and draws no new seed)."""
    got = {}
    for fast in (False, True):
        seen = _spy_seeds(monkeypatch)
        rnd.seed(2)
        _run(name, fast=fast)
        got[fast] = list(seen)
        monkeypatch.undo()
    assert got[True] == got[False] and len(got[True]) > 0
    per_step = len(got[True]) // STEPS
    assert len(set(got[True][:per_step]) & set(got[True][per_step:])) == 0


def test_staged_seeds_are_device_seeds_after_the_first_call(monkeypatch):
    kinds = []
    real = philox.attention_keep

    def spy(seed, *a, **k):
        kinds.append(type(seed).__name__)
        return real(seed, *a, **k)
    monkeypatch.setattr(philox, "attention_keep", spy)
    _run("gpt-dropout", fast=True)
    n = len(kinds) // STEPS
    assert set(kinds[:n]) == {"int"}                 # the live first run
    assert set(kinds[n:]) == {"DeviceSeed"}


def test_a_body_that_draws_otherwise_raises():
    class Flip(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(8, 8))
            self.generator = rnd.make_generator(1)
            self.extra = False

        def forward(self, x):
            h = F.dropout(x @ self.w, 0.5, training=True,
                          generator=self.generator)
            if self.extra:
                h = F.dropout(h, 0.5, training=True,
                              generator=self.generator)
            return h.square().mean()
    m = Flip()
    step = TrainStep(m, AdamW(parameters=m.parameters()))
    x = torch.ones(4, 8)
    step(x)
    step(x)
    m.extra = True
    with pytest.raises(RuntimeError, match="draw the same seeds"):
        step(x)


def test_device_seed_reads_and_checks():
    buf = torch.tensor([5, (7 << 32) | 3], dtype=torch.int64)
    s = philox.DeviceSeed(buf, 1)
    assert int(s) == (7 << 32) | 3 and philox.seed_words(s) == (3, 7)
    philox.check_seed(s)
    with pytest.raises(ValueError):
        philox.check_seed(-1)
    with pytest.raises(ValueError, match="on the card"):
        philox.kernel_args(0.1, s)                 # a CPU seed: no launch
    assert philox.kernel_args(0.1, 5) == (1, 5, 0, philox.threshold(0.1),
                                          philox.keep_scale(0.1))
    assert philox.threshold(1.0 - 1e-9) < philox.SEED_IN_MEMORY
    assert torch.equal(philox.row_keep(s, philox.SALT_DROPOUT, 3, 9, 0.5),
                       philox.row_keep(int(s), philox.SALT_DROPOUT, 3, 9,
                                       0.5))


# ------------------------------------------------------- staged scalars


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("decouple", [True, False])
def test_staged_adam_update_is_the_host_float_update(dtype, decouple):
    """Steps 1-1000: the update from host floats and from the staged fp32
    scalars (0-d tensors), on the same gradients, bit for bit, with decay
    L2 or decoupled; and a skipped update keeps every bit."""
    g = torch.Generator().manual_seed(0)
    init = (torch.randn(257, generator=g) * 0.1).to(dtype)
    a = [init.clone(), torch.zeros_like(init), torch.zeros_like(init)]
    b = [t.clone() for t in a]
    lr, wd, b1, b2 = 3e-4, 0.01, 0.9, 0.999
    f32 = np.float32
    for step in range(1, 1001):
        grad = (torch.randn(257, generator=g) * 0.05).to(dtype)
        adam_update(*a[:1], grad, *a[1:], lr=lr, step=step, beta1=b1,
                    beta2=b2, weight_decay=wd, decouple_wd=decouple)
        sc = torch.from_numpy(adam_scalars(lr, step, b1, b2))
        staged = (sc[0], sc[1], sc[2], sc[0] * float(f32(wd)))
        skip = torch.tensor(step % 97 == 0)
        before = [t.clone() for t in b]
        adam_update(*b[:1], grad, *b[1:], beta1=b1, beta2=b2,
                    weight_decay=wd, decouple_wd=decouple, scalars=staged,
                    skip=skip)
        if bool(skip):
            assert all(torch.equal(x, y) for x, y in zip(b, before))
            b = [t.clone() for t in a]              # rejoin the other run
        else:
            assert all(torch.equal(x, y) for x, y in zip(a, b)), step


def test_clip_by_norm_makes_its_constants_once():
    """ClipGradByNorm builds its constants once per device and type; the
    clipped gradients are the formula's, as before."""
    clip = tnn.ClipGradByNorm(0.3)
    g = torch.Generator().manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        grads = [(torch.randn(5, 4, generator=g) * s).to(dtype)
                 for s in (0.01, 1.0, 5.0)]
        for _ in range(2):
            out = clip([(None, x) for x in grads])
            for x, (_, y) in zip(grads, out):
                c = [torch.tensor(v, dtype=dtype) for v in (0.3, 1e-12, 1.0)]
                norm = x.square().sum().sqrt()
                want = x * torch.minimum(c[0] / torch.maximum(norm, c[1]),
                                         c[2])
                assert y.dtype == dtype and torch.equal(y, want)
    assert len(clip._consts) == 2
    first = clip._consts[(torch.device("cpu"), torch.float32)]
    clip([(None, torch.ones(3))])
    assert clip._consts[(torch.device("cpu"), torch.float32)] is first


# ------------------------------------------------------- num_compiles


class _JaxMLP(paddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = paddle.nn.Linear(8, 16)
        self.fc2 = paddle.nn.Linear(16, 4)

    def forward(self, x, labels):
        h = self.fc2(paddle.nn.functional.relu(self.fc1(x)))
        return paddle.nn.functional.cross_entropy(h, labels).mean()


class _PortMLP(torch.nn.Module):
    def __init__(self, jm):
        super().__init__()
        self.fc1 = torch.nn.Linear(8, 16)
        self.fc2 = torch.nn.Linear(16, 4)
        with torch.no_grad():
            for name in ("fc1", "fc2"):
                mine, theirs = getattr(self, name), getattr(jm, name)
                mine.weight.copy_(torch.from_numpy(_np(theirs.weight).T))
                mine.bias.copy_(torch.from_numpy(_np(theirs.bias)))

    def forward(self, x, labels):
        h = self.fc2(torch.relu(self.fc1(x)))
        return torch.nn.functional.cross_entropy(h, labels.reshape(-1))


def _mlp_pair():
    paddle.seed(7)
    jm = _JaxMLP()
    tm = _PortMLP(jm)
    js = paddle.jit.TrainStep(jm, paddle.optimizer.AdamW(
        learning_rate=0.01, parameters=jm.parameters()))
    ts = TrainStep(tm, AdamW(learning_rate=0.01, parameters=tm.parameters()))
    return jm, tm, js, ts


def _mlp_data(bs=16):
    rng = np.random.RandomState(0)
    return (rng.randn(bs, 8).astype("float32"),
            rng.randint(0, 4, (bs, 1)).astype("int64"))


def _both(js, ts, x, y, port_dtype=None):
    lj = float(js(paddle.to_tensor(x), paddle.to_tensor(y)))
    xt = torch.from_numpy(x)
    lt = float(ts(xt if port_dtype is None else xt.to(port_dtype),
                  torch.from_numpy(y)))
    assert js.num_compiles == ts.num_compiles, (js.num_compiles,
                                                ts.num_compiles)
    return lj, lt


def test_num_compiles_follows_jax_on_signatures_and_readoption():
    """The sequences of tests/test_train_step.py: one signature compiles
    once; a new shape adds one, the old one adds none; a leaf replaced by
    one of its shape and type is re-adopted without a compile; one that
    cannot be drops the programs, which are built again."""
    jm, tm, js, ts = _mlp_pair()
    x, y = _mlp_data()
    x8, y8 = x[:8], y[:8]
    lj, lt = _both(js, ts, x, y)
    assert lt == pytest.approx(lj, rel=1e-5)
    _both(js, ts, x, y)
    assert ts.num_compiles == 1
    _both(js, ts, x8, y8)
    _both(js, ts, x, y)
    assert ts.num_compiles == 2
    # replaced leaves, same shape and type: re-adopted, nothing built
    for p in jm.parameters():
        p.set_value(np.asarray(p.numpy()))
    for p in tm.parameters():
        p.data = p.data.clone()
    storage = [id(t) for t in ts._captured[0]]
    _both(js, ts, x, y)
    assert ts.num_compiles == 2 and js.num_compiles == 2
    assert [id(t) for t in ts._captured[0]] == storage
    for p, (_, old) in zip(tm.parameters(), ts._captured[0]):
        assert p.data_ptr() == old.data_ptr()         # handed back
    # a leaf that cannot be re-adopted: the programs are dropped and built
    # again (the JAX package's impossible device_put; the port's model
    # moved to another type, its inputs with it)
    orig = jax_ts.TrainStep._readopt

    def failing(self, new, old):
        if old is None or isinstance(old, tuple) or new is old:
            return new
        raise jax_ts._PlacementDropNeeded("simulated")
    jax_ts.TrainStep._readopt = failing
    try:
        for p in jm.parameters():
            p.set_value(np.asarray(p.numpy()))
        tm.double()
        lj, lt = _both(js, ts, x, y, torch.float64)
    finally:
        jax_ts.TrainStep._readopt = orig
    assert math.isfinite(lj) and math.isfinite(lt)
    assert ts.num_compiles == js.num_compiles == 1
    _both(js, ts, x, y, torch.float64)
    _both(js, ts, x8, y8, torch.float64)
    assert ts.num_compiles == 2


def test_dropped_step_frees_its_programs_without_the_collector():
    """A program holds its step and its registry weakly: dropping the last
    reference to the step frees its programs (on the card, their graphs'
    memory) at once, with the cycle collector off."""
    import gc
    import weakref
    _, tm, _, ts = _mlp_pair()
    x, y = (torch.from_numpy(a) for a in _mlp_data())
    ts(x, y)
    ts(x, y)
    prog = weakref.ref(next(iter(ts._programs._programs.values())))
    step = weakref.ref(ts)
    gc.disable()
    try:
        del ts
        assert step() is None and prog() is None
    finally:
        gc.enable()


def test_readoption_keeps_the_trajectory():
    """Re-adopted leaves carry their new values: a step after ``p.data =``
    equals the step of a twin whose leaves were written in place."""
    jm, tm, _, ts = _mlp_pair()
    twin = _PortMLP(jm)
    ts2 = TrainStep(twin, AdamW(learning_rate=0.01,
                                parameters=twin.parameters()))
    x, y = (torch.from_numpy(a) for a in _mlp_data())
    ts(x, y)
    ts2(x, y)
    for p, q in zip(tm.parameters(), twin.parameters()):
        p.data = p.data * 0.5
        with torch.no_grad():
            q.mul_(0.5)
    assert torch.equal(ts(x, y), ts2(x, y))
    assert all(torch.equal(p, q) for p, q in zip(tm.parameters(),
                                                 twin.parameters()))
    assert ts.num_compiles == 1


class _JaxWithLoss(paddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.a = paddle.nn.Linear(8, 16)
        self.b = paddle.nn.Linear(16, 8)

    def forward(self, x):
        return ((self.b((self.a(x)) ** 2)) ** 2).mean()


class _PortWithLoss(torch.nn.Module):
    def __init__(self, jm):
        super().__init__()
        self.a = torch.nn.Linear(8, 16)
        self.b = torch.nn.Linear(16, 8)
        with torch.no_grad():
            for name in ("a", "b"):
                mine, theirs = getattr(self, name), getattr(jm, name)
                mine.weight.copy_(torch.from_numpy(_np(theirs.weight).T))
                mine.bias.copy_(torch.from_numpy(_np(theirs.bias)))

    def forward(self, x):
        return ((self.b((self.a(x)) ** 2)) ** 2).mean()


def _health_inputs(seed, bs=4):
    return np.random.RandomState(seed).randn(bs, 8).astype("float32")


@pytest.mark.parametrize("env", [
    dict(PADDLE_HEALTH_SAMPLE="2"),
    dict(PADDLE_HEALTH="0"),
    dict(PADDLE_HEALTH_SAMPLE="2", PADDLE_HEALTH_FAULT="nan@param:3")])
def test_num_compiles_follows_jax_under_the_health_plane(monkeypatch,
                                                         tmp_path, env):
    """The sequences of tests/test_health.py: with health on the program
    count stays 1 over 6 steps and a second batch size adds one; opted
    out, 1; a chaos NaN poisons a leaf in place and builds nothing."""
    for k in ("PADDLE_HEALTH", "PADDLE_HEALTH_SAMPLE", "PADDLE_HEALTH_FAULT",
              "PADDLE_MONITOR", "PADDLE_TRACE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    paddle.seed(0)
    jm = _JaxWithLoss()
    tm = _PortWithLoss(jm)
    jmon_ = jmon.enable(str(tmp_path / "j.jsonl"))
    mon = tmon.enable(str(tmp_path / "t.jsonl"))
    js = paddle.jit.TrainStep(jm, paddle.optimizer.AdamW(
        learning_rate=1e-2, parameters=jm.parameters()))
    ts = TrainStep(tm, AdamW(learning_rate=1e-2, parameters=tm.parameters()))
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for s in range(6):
            x = _health_inputs(s)
            js(paddle.to_tensor(x))
            ts(torch.from_numpy(x))
            assert ts.num_compiles == js.num_compiles == 1
        x = _health_inputs(9, bs=8)
        js(paddle.to_tensor(x))
        ts(torch.from_numpy(x))
    assert ts.num_compiles == js.num_compiles == 2
    assert mon.registry.counter("train_step/recompiles").value == 2
    if "PADDLE_HEALTH_FAULT" in env:
        assert mon.health.nan_trips == jmon_.health.nan_trips >= 1
    elif env.get("PADDLE_HEALTH") != "0":
        g = mon.registry.snapshot()["gauges"]
        assert g["health/digest_step"] == 6 and g["health/groups"] == 2


# ------------------------------------------------- the JAX package, records


def test_three_fast_steps_match_jax():
    """test_torch_train.py's parity on the fast path: 3 AdamW steps on a
    repeated batch, losses within rtol 1e-5, the parameters whose first
    gradient is live within atol 5e-6 (the rest within 3 * 2 * lr)."""
    jm, _, tm = _pair()
    ids, labels = _batch()
    step_j = paddle.jit.TrainStep(jm, paddle.optimizer.AdamW(
        learning_rate=1e-3, weight_decay=0.01, parameters=jm.parameters()))
    step_t = TrainStep(tm, AdamW(learning_rate=1e-3, weight_decay=0.01,
                                 parameters=tm.parameters()), fast_path=True)
    first = {}

    def keep_first(name):
        def hook(grad):
            first.setdefault(name, grad.abs())
        return hook
    hooks = [p.register_hook(keep_first(n)) for n, p in tm.named_parameters()]
    ids_t, labels_t = torch.from_numpy(ids).long(), \
        torch.from_numpy(labels).long()
    lj, lt = [], []
    for _ in range(3):
        lj.append(float(step_j(paddle.to_tensor(ids),
                               paddle.to_tensor(labels))))
        lt.append(step_t(ids_t, labels_t).item())
    for h in hooks:
        h.remove()
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    want = convert_paddle_state({n: _np(p) for n, p in jm.named_parameters()},
                                tm)
    for name, p in tm.named_parameters():
        diff = (p.detach() - want[name]).abs()
        live = first[name] > 1e-5 * first[name].max()
        assert float(diff[live].max()) < 5e-6, name
        assert float(diff.max()) <= 6e-3, name
    assert step_t.num_compiles == step_j.num_compiles == 1


def _monitored(tmp_path, monkeypatch, fast, steps=4):
    monkeypatch.setenv("PADDLE_HEALTH_SAMPLE", "2")
    for k in ("PADDLE_HEALTH", "PADDLE_HEALTH_FAULT"):
        monkeypatch.delenv(k, raising=False)
    _, _, tm = _pair()
    ids, labels = _batch()
    path = str(tmp_path / f"{fast}.jsonl")
    mon = tmon.enable(path, trace=True)
    step = TrainStep(tm, SGD(learning_rate=0.1, parameters=tm.parameters()),
                     fast_path=fast)
    for _ in range(steps):
        step(torch.from_numpy(ids).long(), torch.from_numpy(labels).long())
    gauges = mon.registry.snapshot()["gauges"]
    tmon.disable()
    import json
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return recs, gauges, step


def test_fast_path_records_and_health_gauges(tmp_path, monkeypatch):
    """The mint is the first call (one ``recompile``, ``path="graph"``, its
    FLOPs counted), every later call a ``step``; the health gauges are the
    eager step's (the same sampled steps, the same statistics)."""
    recs_e, g_e, _ = _monitored(tmp_path, monkeypatch, False)
    recs_f, g_f, step = _monitored(tmp_path, monkeypatch, True)
    kinds = [r["kind"] for r in recs_f]
    assert kinds == [r["kind"] for r in recs_e] == [
        "meta", "exec_cost", "recompile", "step", "step", "step",
        "counters"]
    rc = [r for r in recs_f if r["kind"] == "recompile"][0]
    assert rc["path"] == "graph" and rc["count"] == 1
    assert [r for r in recs_f if r["kind"] == "exec_cost"][0]["flops"] > 0
    health = {k: v for k, v in g_e.items() if k.startswith("health/")}
    assert health and {k: g_f[k] for k in health} == health
    assert step.num_compiles == 1


def test_fast_path_reads_health_on_sampled_steps_only(tmp_path,
                                                      monkeypatch):
    """The program takes its statistics in every call (one device_stats,
    at the build) and the host reads them on the sampled calls only."""
    from paddle_tpu_torch.monitor import health as th
    built, read = [], []
    real_ds, real_pl = th.HealthPlane.device_stats, th.DeviceStats.payload

    def ds(self, *a, **k):
        built.append(1)
        return real_ds(self, *a, **k)

    def pl(self, *a, **k):
        read.append(1)
        return real_pl(self, *a, **k)
    monkeypatch.setattr(th.HealthPlane, "device_stats", ds)
    monkeypatch.setattr(th.DeviceStats, "payload", pl)
    _, g, step = _monitored(tmp_path, monkeypatch, True, steps=6)
    assert len(built) == 1 and len(read) == 3 and step._health_n == 6
    assert g["health/digest_step"] == 6


# -------------------------------------------------------- on the card


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_cuda_fast_path_equals_eager_bit_for_bit(name):
    """The captured step against the eager step on the card, bf16 with
    fp32 masters: 3 steps bit for bit, one program, a graph."""
    _need_cuda()
    rnd.seed(11)
    e = _run(name, fast=False, device="cuda", multi_precision=True,
             dtype=torch.bfloat16)
    rnd.seed(11)
    f = _run(name, fast=True, device="cuda", multi_precision=True,
             dtype=torch.bfloat16)
    assert all(_equal(a, b) for a, b in zip(e[3], f[3]))
    _same(_state(*e[:3]), _state(*f[:3]))
    progs = list(f[2]._programs._programs.values())
    assert len(progs) == 1 and progs[0].captured


@pytest.mark.cuda
def test_cuda_replays_count_their_launches_and_draw_new_masks():
    """Each replay adds one step's kernel launches to the counts, and two
    replays drop different elements."""
    _need_cuda()
    from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
    model = _gpt("cuda").to(torch.bfloat16)
    step = TrainStep(model, AdamW(parameters=model.parameters(),
                                  multi_precision=True))
    ids = _ids((B, L), 1, device="cuda")
    reset_launch_counts()
    step(ids, ids)
    first = launch_counts()
    losses = [step(ids, ids).item() for _ in range(2)]
    torch.cuda.synchronize()
    now = launch_counts()
    assert first["flash_pair_fwd"] == GPT_DROP["num_layers"]
    assert all(now[k] == 3 * first[k] for k in now)
    assert losses[0] != losses[1]
