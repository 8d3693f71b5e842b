"""The port's ``nn`` surface (``paddle_tpu_torch.nn``: ``Layer`` and its
containers, the common / norm / activation / loss layers, the
initializers, ``nn.functional``), its ``SGD`` / ``Momentum`` /
``minimize``, ``paddle.save`` / ``load`` and the monitor's per-op
counter, against the JAX package: every layer's ``state_dict`` keys and
shapes equal the JAX layer's; ``convert.load_paddle_layer_state`` then
the same input gives the same output and gradients (1e-4); ``Constant``
and ``Assign`` draw exactly, the random initializers within statistical
bounds of their mean, std and limits."""
import json
import math

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.convert import load_paddle_layer_state
from paddle_tpu_torch.core import device as tp_device

TOL = 1e-4


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
    return np.asarray(t.numpy())


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


LAYERS = [
    ("Linear", (4, 3), {}), ("Linear", (4, 3), {"bias_attr": False}),
    ("Embedding", (10, 4), {"padding_idx": 1}),
    ("LayerNorm", (4,), {}), ("RMSNorm", (4,), {}), ("PReLU", (3,), {}),
    ("Bilinear", (3, 4, 2), {}),
    ("MultiHeadAttention", (8, 2), {}),
    ("TransformerEncoderLayer", (8, 2, 16), {"dropout": 0.0}),
    ("TransformerDecoderLayer", (8, 2, 16), {"dropout": 0.0}),
    ("Transformer", (), dict(d_model=8, nhead=2, num_encoder_layers=1,
                             num_decoder_layers=2, dim_feedforward=16,
                             dropout=0.0)),
    ("Dropout", (0.5,), {}), ("Flatten", (), {}), ("Identity", (), {}),
    ("GELU", (), {}), ("CrossEntropyLoss", (), {}),
]


@pytest.mark.parametrize("name,args,kwargs", LAYERS,
                         ids=[f"{c[0]}-{k}" for k, c in enumerate(LAYERS)])
def test_state_dict_keys_and_shapes(name, args, kwargs):
    j = getattr(jp.nn, name)(*args, **kwargs)
    t = getattr(tp.nn, name)(*args, **kwargs)
    assert isinstance(t, torch.nn.Module) and isinstance(t, tp.nn.Layer)
    js, ts = j.state_dict(), t.state_dict()
    assert list(ts) == list(js) or set(ts) == set(js)
    assert {k: list(v.shape) for k, v in ts.items()} == \
        {k: list(v.shape) for k, v in js.items()}
    assert all(isinstance(p, torch.nn.Parameter) and isinstance(p, tp.Tensor)
               for p in t.parameters())
    assert isinstance(t.parameters(), list)


def _carry(name, args, kwargs):
    j = getattr(jp.nn, name)(*args, **kwargs)
    t = getattr(tp.nn, name)(*args, **kwargs)
    load_paddle_layer_state(t, j.state_dict())
    return j, t


@pytest.mark.parametrize("name,args,kwargs,inputs", [
    ("Linear", (4, 3), {}, (f(2, 5, 4),)),
    ("LayerNorm", (4,), {"epsilon": 1e-6}, (f(3, 4),)),
    ("RMSNorm", (4,), {}, (f(3, 4),)),
    ("PReLU", (3,), {}, (f(2, 3, 4),)),
    ("Bilinear", (3, 4, 2), {}, (f(5, 3), f(5, 4, seed=1))),
    ("MultiHeadAttention", (8, 2), {}, (f(2, 5, 8),))],
    ids=["Linear", "LayerNorm", "RMSNorm", "PReLU", "Bilinear", "MHA"])
def test_layer_carry_output_and_gradients(name, args, kwargs, inputs):
    """The JAX layer's state carried with no transpose: the same output,
    and the same gradients for every parameter and input."""
    j, t = _carry(name, args, kwargs)
    ji = [jp.to_tensor(x, stop_gradient=False) for x in inputs]
    ti = [tp.to_tensor(x, stop_gradient=False) for x in inputs]
    jo, to = j(*ji), t(*ti)
    _close(to, jo)
    ct = f(*list(to.shape), seed=9)
    jps, tps = list(j.parameters()), list(t.parameters())
    jg = jp.grad((jo * jp.to_tensor(ct)).sum(), ji + jps)
    tg = tp.grad((to * tp.to_tensor(ct)).sum(), ti + tps)
    for a, b in zip(tg, jg):
        _close(a, b)


def test_embedding_padding_idx():
    j, t = _carry("Embedding", (10, 4), {"padding_idx": 1})
    ids = np.array([[1, 2, 3], [1, 9, 0]])
    _close(t(tp.to_tensor(ids)), j(jp.to_tensor(ids)))
    assert float(t.weight[1].abs().sum()) == 0.0
    fresh = tp.nn.Embedding(10, 4, padding_idx=-1)
    assert float(fresh.weight[9].abs().sum()) == 0.0
    out = fresh(tp.to_tensor(np.array([9, 3])))
    out.sum().backward()
    assert float(fresh.weight.grad[9].abs().sum()) == 0.0


def test_rms_norm_weight_on_the_default_place():
    """``nn.RMSNorm``'s weight lies where every layer's parameters lie:
    on the default place, not on torch's default device (a ``meta``
    default place shows the difference on the CPU). With no place chosen
    and no CUDA both layers raise; an explicit ``with torch.device(...)``
    block off the CPU (LLaMA builds on ``meta``) keeps the weight there."""
    assert tp.nn.RMSNorm(8).weight.place == tp.nn.LayerNorm(8).weight.place
    assert tp.nn.RMSNorm(8).weight.place == tp.CPUPlace()
    tp_device._default[0] = tp_device.Place("meta")
    assert tp.nn.RMSNorm(8).weight.device.type == "meta"
    assert tp.nn.LayerNorm(8).weight.device.type == "meta"
    if not torch.cuda.is_available():
        tp_device._default[0] = None
        with pytest.raises(RuntimeError):
            tp.nn.LayerNorm(8)
        with pytest.raises(RuntimeError):
            tp.nn.RMSNorm(8)
    tp.set_device("cpu")
    with torch.device("meta"):
        assert tp.nn.RMSNorm(8).weight.device.type == "meta"
    norm = tp.nn.RMSNorm(8)
    assert isinstance(norm.weight, tp.Parameter)
    assert torch.equal(norm.weight, torch.ones(8))


def test_load_paddle_layer_state_refuses_a_mismatch():
    j = jp.nn.Linear(4, 3)
    state = dict(j.state_dict())
    with pytest.raises(ValueError, match="missing"):
        load_paddle_layer_state(tp.nn.Linear(4, 3),
                                {"weight": state["weight"]})
    with pytest.raises(ValueError, match="unexpected"):
        load_paddle_layer_state(tp.nn.Linear(4, 3, bias_attr=False), state)
    with pytest.raises(ValueError, match="shape"):
        load_paddle_layer_state(tp.nn.Linear(3, 4), state)


ACTIVATIONS = [
    ("relu", {}), ("relu6", {}), ("elu", {"alpha": 0.7}), ("selu", {}),
    ("celu", {"alpha": 1.2}), ("gelu", {}), ("gelu", {"approximate": True}),
    ("sigmoid", {}), ("tanh", {}), ("silu", {}), ("swish", {}), ("mish", {}),
    ("hardswish", {}), ("hardsigmoid", {}), ("hardtanh", {}),
    ("hardshrink", {}), ("softshrink", {"threshold": 0.3}),
    ("tanhshrink", {}), ("softsign", {}), ("softplus", {"beta": 2.0}),
    ("leaky_relu", {"negative_slope": 0.1}), ("log_sigmoid", {}),
    ("softmax", {"axis": 1}), ("log_softmax", {}), ("glu", {"axis": -1}),
    ("thresholded_relu", {"threshold": 0.2}), ("maxout", {"groups": 2}),
    ("rrelu", {"training": False}), ("normalize", {"axis": 1}),
    ("dropout", {"p": 0.3, "training": False}),
    ("dropout", {"p": 0.3, "training": False, "mode": "downscale_in_infer"}),
    ("cosine_similarity", None), ("label_smooth", {"epsilon": 0.2}),
    ("pixel_shuffle", {"upscale_factor": 2}),
    ("pixel_unshuffle", {"downscale_factor": 2}),
    ("channel_shuffle", {"groups": 2}),
]


@pytest.mark.parametrize("name,kwargs", ACTIVATIONS,
                         ids=[f"{c[0]}-{k}" for k, c in
                              enumerate(ACTIVATIONS)])
def test_functional_forward_and_gradient(name, kwargs):
    """``nn.functional`` names resolved on both packages: forward and
    gradient."""
    x = f(2, 4, 4, 4)
    args = [x]
    if kwargs is None:            # a two-input functional
        args, kwargs = [f(3, 4), f(3, 4, seed=1)], {}
    ja = [jp.to_tensor(a, stop_gradient=False) for a in args]
    ta = [tp.to_tensor(a, stop_gradient=False) for a in args]
    jo = getattr(jp.nn.functional, name)(*ja, **kwargs)
    to = getattr(tp.nn.functional, name)(*ta, **kwargs)
    _close(to, jo)
    ct = f(*list(to.shape), seed=3)
    jg = jp.grad((jo * jp.to_tensor(ct)).sum(), ja)
    tg = tp.grad((to * tp.to_tensor(ct)).sum(), ta)
    for a, b in zip(tg, jg):
        _close(a, b)


def _labels(n, c, seed=4):
    return np.random.default_rng(seed).integers(0, c, n).astype(np.int64)


LOSSES = [
    ("cross_entropy", (f(6, 5), _labels(6, 5)), {}),
    ("cross_entropy", (f(6, 5), _labels(6, 5)), {"label_smoothing": 0.1}),
    ("cross_entropy", (f(6, 5), np.array([0, -100, 2, 3, -100, 1])), {}),
    ("cross_entropy", (f(2, 5, 3), _labels(6, 5).reshape(2, 3)),
     {"axis": 1}),
    ("cross_entropy", (f(6, 5), np.abs(f(6, 5, seed=2)) / 5),
     {"soft_label": True, "reduction": "sum"}),
    ("cross_entropy", (f(6, 5), _labels(6, 5)),
     {"weight": np.linspace(0.5, 2.0, 5).astype(np.float32)}),
    ("softmax_with_cross_entropy", (f(6, 5), _labels(6, 5)[:, None]), {}),
    ("mse_loss", (f(4, 3), f(4, 3, seed=1)), {}),
    ("square_error_cost", (f(4, 3), f(4, 3, seed=1)), {}),
    ("l1_loss", (f(4, 3), f(4, 3, seed=1)), {"reduction": "sum"}),
    ("smooth_l1_loss", (f(4, 3), f(4, 3, seed=1)), {"delta": 0.5}),
    ("nll_loss", (f(6, 5), _labels(6, 5)), {}),
    ("kl_div", (f(4, 3), np.abs(f(4, 3, seed=1))), {"reduction": "batchmean"}),
    ("binary_cross_entropy", (np.abs(f(4, 3)) / 4 + 0.1,
                              (f(4, 3, seed=1) > 0).astype(np.float32)), {}),
    ("binary_cross_entropy_with_logits",
     (f(4, 3), (f(4, 3, seed=1) > 0).astype(np.float32)), {}),
    ("margin_ranking_loss", (f(5), f(5, seed=1),
                             np.sign(f(5, seed=2))), {"margin": 0.1}),
    ("hinge_embedding_loss", (f(5), np.sign(f(5, seed=2))), {}),
    ("soft_margin_loss", (f(5), np.sign(f(5, seed=2))), {}),
    ("log_loss", (np.abs(f(4, 1)) / 4 + 0.1,
                  (f(4, 1, seed=1) > 0).astype(np.float32)), {}),
    ("sigmoid_focal_loss", (f(4, 3), (f(4, 3, seed=1) > 0).astype(
        np.float32)), {}),
    ("multi_label_soft_margin_loss", (f(4, 3), (f(4, 3, seed=1) > 0).astype(
        np.float32)), {}),
    ("poisson_nll_loss", (f(4, 3), np.abs(f(4, 3, seed=1))), {}),
    ("triplet_margin_loss", (f(4, 3), f(4, 3, seed=1), f(4, 3, seed=2)), {}),
    ("cosine_embedding_loss", (f(4, 3), f(4, 3, seed=1),
                               np.sign(f(4, seed=2))), {}),
]


@pytest.mark.parametrize("name,args,kwargs", LOSSES,
                         ids=[f"{c[0]}-{k}" for k, c in enumerate(LOSSES)])
def test_loss_forward_and_gradient(name, args, kwargs):
    kw_j = {k: jp.to_tensor(v) if isinstance(v, np.ndarray) else v
            for k, v in kwargs.items()}
    kw_t = {k: tp.to_tensor(v) if isinstance(v, np.ndarray) else v
            for k, v in kwargs.items()}
    ja = [jp.to_tensor(a, stop_gradient=k != 0) for k, a in enumerate(args)]
    ta = [tp.to_tensor(a, stop_gradient=k != 0) for k, a in enumerate(args)]
    jo = getattr(jp.nn.functional, name)(*ja, **kw_j)
    to = getattr(tp.nn.functional, name)(*ta, **kw_t)
    _close(to, jo)
    (jg,) = jp.grad(jo.sum(), [ja[0]])
    (tg,) = tp.grad(to.sum(), [ta[0]])
    _close(tg, jg)


@pytest.mark.parametrize("name,kwargs", [
    ("CrossEntropyLoss", {}), ("MSELoss", {}), ("L1Loss", {}),
    ("SmoothL1Loss", {"delta": 0.5}), ("SoftMarginLoss", {})])
def test_loss_layers(name, kwargs):
    x, y = f(6, 5), _labels(6, 5)
    if name != "CrossEntropyLoss":
        y = np.sign(f(6, 5, seed=1))
    jo = getattr(jp.nn, name)(**kwargs)(jp.to_tensor(x), jp.to_tensor(y))
    to = getattr(tp.nn, name)(**kwargs)(tp.to_tensor(x), tp.to_tensor(y))
    _close(to, jo)


def test_constant_and_assign_are_exact():
    for init_j, init_t, shape in (
            (jp.nn.initializer.Constant(0.25),
             tp.nn.initializer.Constant(0.25), (3, 4)),
            (jp.nn.initializer.Assign(np.arange(6.0).reshape(2, 3)),
             tp.nn.initializer.Assign(np.arange(6.0).reshape(2, 3)), (2, 3))):
        jl = jp.nn.Linear(shape[0], shape[1], weight_attr=jp.ParamAttr(
            initializer=init_j))
        tl = tp.nn.Linear(shape[0], shape[1], weight_attr=tp.ParamAttr(
            initializer=init_t))
        np.testing.assert_array_equal(_np(tl.weight), _np(jl.weight))


@pytest.mark.parametrize("name,kwargs,check", [
    ("Uniform", {"low": -0.3, "high": 0.5},
     lambda a, fi, fo: a.min() >= -0.3 and a.max() < 0.5
     and abs(a.mean() - 0.1) < 0.01),
    ("Normal", {"mean": 0.2, "std": 0.5},
     lambda a, fi, fo: abs(a.mean() - 0.2) < 0.01
     and abs(a.std() - 0.5) < 0.01),
    ("TruncatedNormal", {"std": 0.5},
     lambda a, fi, fo: abs(a).max() <= 1.0 and abs(a.mean()) < 0.01),
    ("XavierUniform", {},
     lambda a, fi, fo: abs(a).max() <= math.sqrt(6 / (fi + fo))
     and abs(a.std() - math.sqrt(2 / (fi + fo))) < 0.002),
    ("XavierNormal", {},
     lambda a, fi, fo: abs(a.std() - math.sqrt(2 / (fi + fo))) < 0.002),
    ("KaimingUniform", {},
     lambda a, fi, fo: abs(a).max() <= math.sqrt(6 / fi)
     and abs(a.std() - math.sqrt(2 / fi)) < 0.002),
    ("KaimingNormal", {},
     lambda a, fi, fo: abs(a.std() - math.sqrt(2 / fi)) < 0.002)])
def test_random_initializers(name, kwargs, check):
    """The port's draw and the JAX package's both sit within the
    distribution's bounds (other bits: the port draws on its torch
    chain)."""
    fi, fo = 256, 192
    for pkg in (jp, tp):
        layer = pkg.nn.Linear(fi, fo, weight_attr=pkg.ParamAttr(
            initializer=getattr(pkg.nn.initializer, name)(**kwargs)))
        assert check(_np(layer.weight).astype(np.float64), fi, fo), pkg


def test_orthogonal_and_seeded_draws():
    w = tp.nn.initializer.Orthogonal(gain=2.0)((6, 4), torch.float32)
    torch.testing.assert_close(w.T @ w, 4.0 * torch.eye(4), atol=1e-5,
                               rtol=1e-5)
    tp.seed(7)
    a = tp.nn.Linear(8, 8).weight.detach().clone()
    tp.seed(7)
    b = tp.nn.Linear(8, 8).weight
    assert torch.equal(a, b)
    assert tp.nn.initializer.calculate_gain("relu") == \
        jp.nn.initializer.calculate_gain("relu")


def test_layer_api():
    """Containers, modes, hooks, ``create_parameter`` with a ``ParamAttr``,
    ``set_state_dict``, ``to(dtype=)`` and ``clear_gradients``."""
    net = tp.nn.Sequential(tp.nn.Linear(4, 8), tp.nn.ReLU(),
                           tp.nn.Linear(8, 2))
    jnet = jp.nn.Sequential(jp.nn.Linear(4, 8), jp.nn.ReLU(),
                            jp.nn.Linear(8, 2))
    assert list(net.state_dict()) == list(jnet.state_dict())
    assert [n for n, _ in net.named_sublayers()] == \
        [n for n, _ in jnet.named_sublayers()]
    net.eval()
    assert not any(m.training for m in net.sublayers())
    net.train()
    seen = []
    h1 = net.register_forward_pre_hook(lambda m, i: seen.append("pre"))
    h2 = net.register_forward_post_hook(lambda m, i, o: o * 0.0)
    out = net(tp.randn([3, 4]))
    assert seen == ["pre"] and float(out.abs().sum()) == 0.0
    h1.remove()
    h2.remove()
    layer = tp.nn.Layer()
    p = layer.create_parameter([2, 3], attr=tp.ParamAttr(
        name="w0", initializer=tp.nn.initializer.Constant(1.5),
        trainable=False))
    assert p.name == "w0" and p.stop_gradient and float(p.sum()) == 9.0
    lst = tp.nn.LayerList([tp.nn.Linear(2, 2) for _ in range(3)])
    assert len(lst) == 3 and len(lst.parameters()) == 6
    missing, unexpected = net.set_state_dict(
        {k: np.zeros(list(v.shape), np.float32)
         for k, v in net.state_dict().items()})
    assert not missing and not unexpected
    assert float(net[0].weight.abs().sum()) == 0.0
    with pytest.raises(ValueError):
        net.set_state_dict({"0.weight": np.zeros((2, 2), np.float32)})
    net.to(dtype="bfloat16")
    assert all(p.dtype == torch.bfloat16 for p in net.parameters())
    assert isinstance(net[0].weight, tp.Parameter)
    net.float()
    net(tp.randn([3, 4])).sum().backward()
    assert net[0].weight.grad is not None
    net.clear_gradients()
    assert net[0].weight.grad is None


@pytest.mark.parametrize("opt_name,kwargs", [
    ("SGD", {"learning_rate": 0.1}),
    ("SGD", {"learning_rate": 0.1, "weight_decay": 0.01}),
    ("Momentum", {"learning_rate": 0.1, "momentum": 0.9}),
    ("Momentum", {"learning_rate": 0.1, "momentum": 0.9,
                  "use_nesterov": True})],
    ids=["sgd", "sgd-decay", "momentum", "nesterov"])
def test_sgd_momentum_trajectory(opt_name, kwargs):
    """Three ``minimize`` steps of a carried Linear: parameters within
    1e-4 of the JAX package's at each step."""
    j, t = _carry("Linear", (4, 3), {})
    jo = getattr(jp.optimizer, opt_name)(parameters=j.parameters(), **kwargs)
    to = getattr(tp.optimizer, opt_name)(parameters=t.parameters(), **kwargs)
    x = f(5, 4, seed=2)
    for _ in range(3):
        jo.minimize((j(jp.to_tensor(x)) ** 2).mean())
        jo.clear_grad()
        to.minimize((t(tp.to_tensor(x)) ** 2).mean())
        to.clear_grad()
        _close(t.weight, j.weight)
        _close(t.bias, j.bias)


@pytest.mark.parametrize("nesterov", [False, True])
def test_momentum_staged_rule(nesterov):
    """``Momentum`` is a staged rule (``TrainStep(fast_path=True)``
    captures it on the card): its update from the step scalars as staged
    fp32 tensors equals the host-float update bit for bit, and a true
    ``skip`` keeps every parameter and velocity bit."""
    kw = dict(learning_rate=0.1, momentum=0.9, use_nesterov=nesterov,
              weight_decay=0.01)
    runs = []
    for staged in (None, "tensor", "skip"):
        t = tp.nn.Linear(4, 3)
        tp.convert.load_paddle_layer_state(
            t, {"weight": f(4, 3), "bias": f(3, seed=1)})
        opt = tp.optimizer.Momentum(parameters=t.parameters(), **kw)
        grads = [tp.to_tensor(f(4, 3, seed=2)), tp.to_tensor(f(3, seed=3))]
        for k in range(2):
            if staged is None:
                opt.apply_gradients(t.parameters(), grads)
            else:
                scal = torch.tensor(opt.step_scalars(k + 1))
                skip = torch.tensor(staged == "skip" and k == 1)
                opt.apply_gradients(t.parameters(), grads, staged=scal,
                                    skip=skip)
        runs.append([p.detach().clone() for p in t.parameters()]
                    + [opt._accumulators[id(p)]["velocity"].clone()
                       for p in t.parameters()])
    host, staged, skipped = runs
    assert "_update_staged" in vars(tp.optimizer.Momentum)
    for a, b in zip(host, staged):
        assert torch.equal(a, b)
    one = tp.nn.Linear(4, 3)
    tp.convert.load_paddle_layer_state(
        one, {"weight": f(4, 3), "bias": f(3, seed=1)})
    ref = tp.optimizer.Momentum(parameters=one.parameters(), **kw)
    ref.apply_gradients(one.parameters(), [tp.to_tensor(f(4, 3, seed=2)),
                                           tp.to_tensor(f(3, seed=3))])
    want = [p.detach() for p in one.parameters()] + \
        [ref._accumulators[id(p)]["velocity"] for p in one.parameters()]
    for a, b in zip(skipped, want):
        assert torch.equal(a, b)


def test_clear_grad_set_to_zero_and_scheduler():
    t = tp.nn.Linear(2, 2)
    opt = tp.optimizer.SGD(learning_rate=0.1, parameters=t.parameters())
    t(tp.randn([3, 2])).sum().backward()
    opt.clear_grad(set_to_zero=True)
    assert float(t.weight.grad.abs().sum()) == 0.0
    opt.clear_grad()
    assert t.weight.grad is None
    sched = tp.optimizer.lr.StepDecay(0.5, step_size=1, gamma=0.1)
    opt.set_lr_scheduler(sched)
    assert opt.get_lr() == 0.5
    sched.step()
    assert abs(opt.get_lr() - 0.05) < 1e-9


def test_save_load_round_trip(tmp_path):
    layer = tp.nn.Linear(3, 2)
    path = str(tmp_path / "sub" / "linear.pdparams")
    tp.save({"model": layer.state_dict(), "step": 3,
             "extra": [tp.to_tensor([1.0, 2.0])]}, path)
    got = tp.load(path)
    assert got["step"] == 3
    assert isinstance(got["model"]["weight"], tp.Parameter)
    assert torch.equal(got["model"]["weight"], layer.weight)
    assert isinstance(got["extra"][0], tp.Tensor)
    arrs = tp.load(path, return_numpy=True)
    np.testing.assert_array_equal(arrs["model"]["bias"], _np(layer.bias))


def test_monitor_counts_dispatched_ops(tmp_path):
    """With the monitor on, every dispatched op is counted by name and the
    counters record carries ``op/<name>``; ``disable`` removes the hook;
    no per-op compile is ever recorded (eager torch mints none)."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.core import dispatch
    path = str(tmp_path / "run.jsonl")
    monitor.enable(path)
    try:
        assert dispatch._MONITOR_OP is not None
        layer = tp.nn.Linear(4, 3)
        x = tp.randn([2, 4])
        for _ in range(3):
            tp.nn.functional.relu(layer(x)).sum()
    finally:
        monitor.disable()
    assert dispatch._MONITOR_OP is None and dispatch._MONITOR_COMPILE is None
    recs = [json.loads(line) for line in open(path)]
    counters = [r for r in recs if r["kind"] == "counters"][-1]["metrics"][
        "counters"]
    assert counters["op/linear"] == 3 and counters["op/relu"] == 3
    assert counters["op/sum"] == 3
    assert not any(r["kind"] == "op_compile" for r in recs)
