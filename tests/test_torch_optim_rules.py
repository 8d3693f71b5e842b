"""The port's update rules (``paddle_tpu_torch.optimizer``: ``SGD``,
``Momentum``, ``Adam``, ``AdamW``, ``Adamax``, ``Adagrad``, ``Adadelta``,
``RMSProp``, ``Lamb``) against the JAX package's on the CPU.

- Per-parameter learning rates: a ``ParamAttr(learning_rate=0.5)`` weight
  moves half as far under every rule, as in the JAX package (one step of
  a carried ``Linear``, exact for SGD, 1e-6 for the others).
- Trajectories: three ``minimize`` steps of a carried two-layer net (one
  weight at rate scale 0.5) hold every parameter and every state to the
  JAX package's within 1e-5 relative (1e-7 absolute) in fp32.
- Staged form: each rule's update from its step scalars as 0-d fp32
  tensors (a captured step's) equals the host-float update bit for bit,
  and a true ``skip`` keeps every parameter and state bit.
- ``state_dict`` carries the JAX keys; a restored optimizer continues the
  trajectory bit for bit.
- bf16: one step of a bf16 ``Linear`` under every rule; the JAX parameter
  comes back fp32 holding the whole update, the port's stays bf16 with an
  fp32 master holding it (within 1e-2 of the update's size: the JAX rule
  rounds its first moments through bf16)."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.convert import load_paddle_layer_state
from paddle_tpu_torch.core import device as tp_device

RTOL, ATOL = 1e-5, 1e-7

# rule name -> constructor keywords (parameters= added by the tests)
RULES = {
    "sgd": ("SGD", dict(learning_rate=0.1)),
    "sgd-decay": ("SGD", dict(learning_rate=0.1, weight_decay=0.01)),
    "momentum": ("Momentum", dict(learning_rate=0.1, momentum=0.9)),
    "adam": ("Adam", dict(learning_rate=0.01)),
    "adamw": ("AdamW", dict(learning_rate=0.01, weight_decay=0.05)),
    "adamax": ("Adamax", dict(learning_rate=0.01)),
    "adamax-decay": ("Adamax", dict(learning_rate=0.01, weight_decay=0.02)),
    "adagrad": ("Adagrad", dict(learning_rate=0.1)),
    "adagrad-init": ("Adagrad", dict(learning_rate=0.1,
                                     initial_accumulator_value=0.3,
                                     weight_decay=0.01)),
    "adadelta": ("Adadelta", dict(learning_rate=1.0, rho=0.9)),
    "rmsprop": ("RMSProp", dict(learning_rate=0.01)),
    "rmsprop-centered": ("RMSProp", dict(learning_rate=0.01, centered=True)),
    "rmsprop-momentum": ("RMSProp", dict(learning_rate=0.01, momentum=0.9,
                                         centered=True, weight_decay=0.01)),
    "lamb": ("Lamb", dict(learning_rate=0.01)),
    "lamb-decay": ("Lamb", dict(learning_rate=0.01, lamb_weight_decay=0.1)),
}


@pytest.fixture(autouse=True)
def _on_cpu():
    saved = tp_device._default[0]
    tp.set_device("cpu")
    yield
    tp_device._default[0] = saved


def f(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def _net(pkg, scaled=True):
    """Linear(4, 3) (its weight at rate scale 0.5), Tanh, Linear(3, 2)."""
    attr = pkg.ParamAttr(learning_rate=0.5) if scaled else None
    return pkg.nn.Sequential(pkg.nn.Linear(4, 3, weight_attr=attr),
                             pkg.nn.Tanh(), pkg.nn.Linear(3, 2))


def _pair(scaled=True):
    """The JAX net with seeded weights, and the port's carrying them."""
    j = _net(jp, scaled)
    for k, (name, p) in enumerate(j.named_parameters()):
        p.set_value(f(*p.shape, seed=10 + k) * 0.5)
    t = _net(tp, scaled)
    load_paddle_layer_state(t, {k: _np(v) for k, v in j.state_dict().items()})
    return j, t


def _opt(pkg, rule, params):
    name, kw = RULES[rule]
    kw = dict(kw)
    if name == "Lamb" and "decay" in rule:
        # the first Linear's bias is exempt: called with the parameter
        exempt = params[1]
        kw["exclude_from_weight_decay_fn"] = lambda p: p is exempt
    return getattr(pkg.optimizer, name)(parameters=params, **kw)


def _loss(pkg, net, x, y):
    return ((net(pkg.to_tensor(x)) - pkg.to_tensor(y)) ** 2).mean()


@pytest.mark.parametrize("rule", sorted(RULES))
def test_per_parameter_learning_rate(rule):
    """A ``Linear(2, 2)`` whose weight carries ``ParamAttr(learning_rate=
    0.5)``, weights 1, input 1, one step on ``sum(out)``: the port's weight
    and bias equal the JAX package's (F14: the port used to ignore the
    scale), and under SGD at rate 1 the weight is exactly 0.5."""
    outs = []
    for pkg in (jp, tp):
        lin = pkg.nn.Linear(2, 2, weight_attr=pkg.ParamAttr(
            learning_rate=0.5))
        lin.weight.set_value(np.ones((2, 2), np.float32))
        lin.bias.set_value(np.zeros((2,), np.float32))
        name, kw = RULES[rule]
        if rule == "sgd":
            kw = dict(learning_rate=1.0)
        opt = getattr(pkg.optimizer, name)(parameters=lin.parameters(), **kw)
        opt.minimize(lin(pkg.to_tensor(np.ones((1, 2), np.float32))).sum())
        outs.append((_np(lin.weight), _np(lin.bias)))
    (jw, jb), (tw, tb) = outs
    np.testing.assert_allclose(tw, jw, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tb, jb, rtol=1e-6, atol=1e-7)
    if rule == "sgd":
        assert (tw == 0.5).all() and (jw == 0.5).all()


def _states(opt, params):
    return {f"{i}_{k}": _np(v) for i, p in enumerate(params)
            for k, v in opt._accumulators[id(p)].items()}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_trajectory_matches_jax(rule):
    """Three ``minimize`` steps: every parameter and every state within
    1e-5 relative of the JAX rule's after each step."""
    j, t = _pair()
    jo = _opt(jp, rule, j.parameters())
    to = _opt(tp, rule, t.parameters())
    x, y = f(5, 4, seed=2), f(5, 2, seed=3)
    for step in range(3):
        jo.minimize(_loss(jp, j, x, y))
        jo.clear_grad()
        to.minimize(_loss(tp, t, x, y))
        to.clear_grad()
        for (name, a), b in zip(t.named_parameters(), j.parameters()):
            np.testing.assert_allclose(_np(a), _np(b), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{rule} step {step} {name}")
        js, ts = _states(jo, j.parameters()), _states(to, t.parameters())
        assert set(js) == set(ts)
        for k in js:
            np.testing.assert_allclose(ts[k], js[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{rule} step {step} {k}")


@pytest.mark.parametrize("rule", sorted(RULES))
def test_staged_update_equals_host_update(rule):
    """Two updates from fixed gradients: the step scalars staged as an
    fp32 tensor (a captured step's form) give the host-float bits, and a
    true ``skip`` on the second leaves every parameter and state as the
    first update left them."""
    grads = [torch.from_numpy(f(4, 3, seed=20)), torch.from_numpy(f(3, seed=21)),
             torch.from_numpy(f(3, 2, seed=22)), torch.from_numpy(f(2, seed=23))]
    runs = {}
    for form in ("host", "staged", "skip", "one"):
        _, t = _pair()
        opt = _opt(tp, rule, t.parameters())
        for k in range(1 if form == "one" else 2):
            if form == "host" or form == "one":
                opt.apply_gradients(t.parameters(), grads)
                continue
            opt._step_count += 1
            scal = torch.tensor(opt.step_scalars(opt._step_count))
            skip = torch.tensor(form == "skip" and k == 1)
            opt.apply_gradients(t.parameters(), grads, staged=scal,
                                skip=skip)
        runs[form] = [p.detach().clone() for p in t.parameters()] + [
            v.clone() for p in t.parameters()
            for v in opt._accumulators[id(p)].values()]
    for form, want in (("staged", "host"), ("skip", "one")):
        for a, b in zip(runs[form], runs[want]):
            assert torch.equal(a, b), (rule, form)


@pytest.mark.parametrize("rule", ["adamax", "adagrad-init", "adadelta",
                                  "rmsprop-momentum", "lamb-decay"])
def test_state_dict_keys_and_resume(rule):
    """``state_dict`` has the JAX package's keys; a fresh optimizer given
    it (and the parameters) continues the trajectory bit for bit."""
    j, t = _pair()
    jo = _opt(jp, rule, j.parameters())
    to = _opt(tp, rule, t.parameters())
    x, y = f(5, 4, seed=2), f(5, 2, seed=3)
    for pkg, net, opt in ((jp, j, jo), (tp, t, to)):
        for _ in range(2):
            opt.minimize(_loss(pkg, net, x, y))
            opt.clear_grad()
    assert set(to.state_dict()) == set(jo.state_dict())
    saved = {k: (v.clone() if torch.is_tensor(v) else v)
             for k, v in to.state_dict().items()}
    _, t2 = _pair()
    load_paddle_layer_state(t2, {k: v.detach().numpy()
                                 for k, v in t.state_dict().items()})
    o2 = _opt(tp, rule, t2.parameters())
    o2.set_state_dict(saved)
    for net, opt in ((t, to), (t2, o2)):
        opt.minimize(_loss(tp, net, x, y))
        opt.clear_grad()
    for a, b in zip(t.parameters(), t2.parameters()):
        assert torch.equal(a, b)


def test_lamb_trust_ratio_is_one_on_zero_weights():
    """A zero weight has no norm: Lamb's trust ratio is 1 there (the JAX
    ``where``), so its first step moves it by ``lr * r`` as the JAX rule
    does."""
    outs = []
    for pkg in (jp, tp):
        lin = pkg.nn.Linear(3, 2)
        lin.weight.set_value(np.zeros((3, 2), np.float32))
        lin.bias.set_value(np.zeros((2,), np.float32))
        opt = pkg.optimizer.Lamb(learning_rate=0.1,
                                 parameters=lin.parameters())
        opt.minimize(lin(pkg.to_tensor(f(4, 3, seed=5))).sum())
        outs.append(_np(lin.weight))
    np.testing.assert_allclose(outs[1], outs[0], rtol=RTOL, atol=ATOL)
    assert np.abs(outs[1]).max() > 0.05



@pytest.mark.parametrize("rule", sorted(RULES))
def test_bf16_parameter_keeps_every_update(rule):
    """A bf16 ``Linear(4, 3)``, one step from the same bf16 gradients (a
    loss linear in the weights): the JAX rule, without a master, hands
    back an fp32 parameter holding the whole update (its rate is an fp32
    scalar; ROADMAP Queue 3). The port's parameter stays bf16, its fp32
    master holds the JAX values and the parameter is the master rounded.
    The JAX rule rounds this first step's moments and decayed gradient
    through bf16 where the port's are fp32, so the update is held within
    1e-2 of its own size (bf16 keeps 8 bits)."""
    rs = np.random.default_rng(31)
    coef = [torch.from_numpy(rs.standard_normal(s).astype(np.float32))
            .bfloat16().float().numpy() for s in ((4, 3), (3,))]
    start = [torch.from_numpy(f(*s, seed=32 + i) * 0.5).bfloat16().float()
             .numpy() for i, s in enumerate(((4, 3), (3,)))]
    out = {}
    for pkg in (jp, tp):
        lin = pkg.nn.Linear(4, 3)
        for p, v in zip((lin.weight, lin.bias), start):
            p.set_value(v)
        lin.to(dtype="bfloat16")
        params = [lin.weight, lin.bias]
        opt = _opt(pkg, rule, params)
        loss = sum((p.astype("float32") * pkg.to_tensor(c)).sum()
                   for p, c in zip(params, coef))
        opt.minimize(loss)
        out[pkg] = (opt, params)
    jo, jps = out[jp]
    to, tps = out[tp]
    for jpar, tpar, p0 in zip(jps, tps, start):
        assert str(jpar.dtype).endswith("float32")       # the promotion
        assert tpar.dtype == torch.bfloat16
        master = to._master_weights[id(tpar)]
        assert master.dtype == torch.float32
        assert torch.equal(tpar.detach(), master.bfloat16())
        want = _np(jpar).astype(np.float32) - p0
        got = master.numpy() - p0
        np.testing.assert_allclose(got, want, rtol=1e-2,
                                   atol=1e-2 * np.abs(want).max(),
                                   err_msg=rule)
        assert all(v.dtype == torch.float32
                   for v in to._accumulators[id(tpar)].values())
