"""The batch, instance and group norms and LRN of the port
(``nn.functional.norm``, ``nn.layers_norm_act_loss``) against the JAX
package on the CPU: the same seeded numpy inputs through both, outputs
within rtol 1e-4 / atol 1e-5 and the gradient of a fixed random
projection within 1e-4 of the JAX tape; the running buffers after a
training call within 1e-5 of the JAX package's (Paddle's momentum, which
weighs the old value, and the unbiased running variance, checked against
numpy too); layers' state_dicts, carried outputs, gradients and buffers;
the buffers on the default place; ``SyncBatchNorm`` in one process and
its refusal across processes; ``FLAGS_cudnn_deterministic`` driving
cuDNN's switches; ``copy.deepcopy`` of a layer with buffers."""
import copy

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from _torch_op_parity import _on_cpu, f, run_case  # noqa: F401
from paddle_tpu_torch.convert import load_paddle_layer_state
from paddle_tpu_torch.core import device as tp_device

FN = "nn.functional"
BUF_TOL = 1e-5


def _stats(c, seed=5):
    r = np.random.default_rng(seed)
    return (r.standard_normal(c).astype(np.float32),
            (r.random(c) + 0.5).astype(np.float32))


NORM_CASES = [
    ("batch_norm", [f(4, 3, 5, 5), *_stats(3), f(3, seed=1), f(3, seed=2)],
     dict(training=False), [0, 3, 4]),
    ("batch_norm", [f(4, 3, 5, 5), *_stats(3)], dict(use_global_stats=True,
                                                    training=True), [0]),
    ("batch_norm", [f(4, 5, 5, 3), *_stats(3), f(3, seed=1), f(3, seed=2)],
     dict(training=False, data_format="NHWC"), [0, 3, 4]),
    ("instance_norm", [f(2, 3, 4, 5), None, None, f(3, seed=1),
                       f(3, seed=2)], {}, [0, 3, 4]),
    ("instance_norm", [f(2, 3, 6)], dict(eps=1e-3), [0]),
    ("group_norm", [f(2, 4, 3, 3), 2], dict(weight=None), [0]),
    ("group_norm", [f(2, 6, 3, 3), 3, 1e-5, f(6, seed=1), f(6, seed=2)], {},
     [0, 3, 4]),
    ("group_norm", [f(2, 3, 3, 6), 2, 1e-5, f(6, seed=1), f(6, seed=2),
                    "NHWC"], {}, [0, 3, 4]),
    ("local_response_norm", [f(2, 7, 3, 3), 5], {}, [0]),
    ("local_response_norm", [f(2, 6, 4), 4], dict(alpha=1e-2, beta=0.5,
                                                  k=2.0), [0]),
]


@pytest.mark.parametrize("name,args,kwargs,grad", NORM_CASES,
                         ids=[f"{c[0]}-{k}" for k, c in
                              enumerate(NORM_CASES)])
def test_norm_forward_and_gradient(name, args, kwargs, grad):
    run_case(name, args, kwargs, grad=grad, module=FN)


TRAIN_CASES = [
    ((4, 3, 5, 5), "NCHW", True), ((4, 5, 5, 3), "NHWC", True),
    ((6, 3), "NCHW", True), ((4, 3, 7), "NCL", True),
    ((2, 3, 2, 3, 3), "NCDHW", True), ((4, 3, 5, 5), "NCHW", False),
    ((1, 3, 1, 1), "NCHW", True)]


@pytest.mark.parametrize("shape,fmt,affine", TRAIN_CASES,
                         ids=[f"{'x'.join(map(str, c[0]))}-{c[1]}-"
                              f"{'affine' if c[2] else 'plain'}"
                              for c in TRAIN_CASES])
def test_batch_norm_training_and_running_update(shape, fmt, affine):
    """Batch statistics in training: the output and its gradients as the
    JAX package's, and the running buffers updated in place as the JAX
    package updates them (a channel of one element too: the running
    variance's n / max(n - 1, 1))."""
    c = shape[1] if fmt.startswith("NC") else shape[-1]
    x, ct = f(*shape), f(*shape, seed=9)
    mean0, var0 = _stats(c)
    w, b = f(c, seed=1), f(c, seed=2)
    res = {}
    for pkg in (jp, tp):
        xs = pkg.to_tensor(x, stop_gradient=False)
        rm, rv = pkg.to_tensor(mean0), pkg.to_tensor(var0)
        ws = pkg.to_tensor(w, stop_gradient=False) if affine else None
        bs = pkg.to_tensor(b, stop_gradient=False) if affine else None
        out = pkg.nn.functional.batch_norm(xs, rm, rv, ws, bs, training=True,
                                           momentum=0.8, data_format=fmt)
        leaves = [xs] + ([ws, bs] if affine else [])
        grads = pkg.grad((out * pkg.to_tensor(ct)).sum(), leaves)
        res[pkg] = [np.asarray(t.numpy()) for t in [out, rm, rv, *grads]]
    for got, want in zip(res[tp], res[jp]):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=BUF_TOL)


def test_batch_norm_momentum_and_unbiased_variance():
    """Paddle's running update, by numpy: ``running * m + batch * (1 -
    m)`` (torch's momentum is the other way round), the running variance
    from the unbiased batch variance, the normalisation by the biased one."""
    x = f(4, 3, 2, 2)
    rm, rv = tp.to_tensor(np.zeros(3, np.float32)), \
        tp.to_tensor(np.ones(3, np.float32))
    out = tp.nn.functional.batch_norm(tp.to_tensor(x), rm, rv, training=True,
                                      momentum=0.9, epsilon=0.0)
    xs = x.transpose(1, 0, 2, 3).reshape(3, -1).astype(np.float64)
    n = xs.shape[1]
    np.testing.assert_allclose(rm.numpy(), 0.1 * xs.mean(1), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(rv.numpy(), 0.9 + 0.1 * xs.var(1) * n / (n - 1),
                               rtol=1e-5)
    want = (xs - xs.mean(1, keepdims=True)) / xs.std(1, keepdims=True)
    np.testing.assert_allclose(
        out.numpy().transpose(1, 0, 2, 3).reshape(3, -1), want, rtol=1e-4,
        atol=1e-5)


NORM_LAYERS = [
    ("BatchNorm2D", (3,), {}, (4, 3, 5, 5)),
    ("BatchNorm2D", (3,), dict(momentum=0.5, epsilon=1e-3,
                               data_format="NHWC"), (4, 5, 5, 3)),
    ("BatchNorm1D", (3,), {}, (6, 3)),
    ("BatchNorm1D", (3,), {}, (4, 3, 7)),
    ("BatchNorm3D", (2,), {}, (2, 2, 3, 3, 3)),
    ("BatchNorm2D", (3,), dict(weight_attr=False, bias_attr=False),
     (4, 3, 5, 5)),
    ("BatchNorm2D", (3,), dict(use_global_stats=True), (4, 3, 5, 5)),
    ("BatchNorm", (3,), dict(act="relu"), (4, 3, 5, 5)),
    ("SyncBatchNorm", (3,), {}, (4, 3, 5, 5)),
    ("GroupNorm", (2, 4), {}, (2, 4, 3, 3)),
    ("GroupNorm", (3, 6), dict(data_format="NHWC"), (2, 3, 3, 6)),
    ("InstanceNorm1D", (3,), {}, (2, 3, 6)),
    ("InstanceNorm2D", (3,), {}, (2, 3, 4, 5)),
    ("InstanceNorm3D", (2,), dict(weight_attr=False), (2, 2, 3, 3, 3)),
    ("LocalResponseNorm", (3,), {}, (2, 5, 3, 3)),
]


@pytest.mark.parametrize("name,args,kwargs,shape", NORM_LAYERS,
                         ids=[f"{c[0]}-{k}" for k, c in
                              enumerate(NORM_LAYERS)])
@pytest.mark.parametrize("mode", ["train", "eval"])
def test_norm_layer_carry(name, args, kwargs, shape, mode):
    """state_dict keys and shapes as the JAX layer's (the batch norms'
    ``_mean`` / ``_variance`` buffers among them); the JAX layer's state
    carried (buffers moved off their defaults first), then in training and
    in eval mode: the output, the gradients of the input and every
    parameter, and the buffers after the call."""
    j = getattr(jp.nn, name)(*args, **kwargs)
    t = getattr(tp.nn, name)(*args, **kwargs)
    js = j.state_dict()
    assert {k: list(v.shape) for k, v in t.state_dict().items()} == \
        {k: list(v.shape) for k, v in js.items()}
    state = {k: np.asarray(v.numpy()) for k, v in js.items()}
    for k in state:
        if k.endswith("_mean") or k.endswith("_variance"):
            state[k] = _stats(state[k].shape[0])[k.endswith("_variance")]
    j.set_state_dict({k: jp.to_tensor(v) for k, v in state.items()})
    load_paddle_layer_state(t, state)
    for layer in (j, t):
        layer.train() if mode == "train" else layer.eval()
    x, ct = f(*shape, seed=3), f(*shape, seed=9)
    jx, tx = jp.to_tensor(x, stop_gradient=False), \
        tp.to_tensor(x, stop_gradient=False)
    jo, to = j(jx), t(tx)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo.numpy()),
                               rtol=1e-4, atol=1e-5)
    jg = jp.grad((jo * jp.to_tensor(ct)).sum(), [jx] + list(j.parameters()))
    tg = tp.grad((to * tp.to_tensor(ct)).sum(), [tx] + list(t.parameters()))
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b.numpy()),
                                   rtol=1e-4, atol=1e-4)
    for k, v in j.state_dict().items():
        np.testing.assert_allclose(t.state_dict()[k].numpy(),
                                   np.asarray(v.numpy()), rtol=1e-5,
                                   atol=BUF_TOL, err_msg=k)


def test_buffers_on_the_default_place():
    """The batch norms' buffers and parameters lie where a convolution's
    weight lies (the default place), and move with the layer."""
    bn = tp.nn.BatchNorm2D(8)
    assert bn._mean.place == tp.nn.Conv2D(3, 8, 3).weight.place
    assert bn._variance.place == bn.weight.place == tp.CPUPlace()
    assert isinstance(bn._mean, tp.Tensor) and bn._mean.stop_gradient
    tp_device._default[0] = tp_device.Place("meta")
    bn = tp.nn.BatchNorm2D(8)
    assert bn._mean.device.type == bn._variance.device.type == "meta"
    assert bn.weight.device.type == "meta"


def test_sync_batch_norm_single_process_and_refusal(monkeypatch):
    """In one process ``SyncBatchNorm`` is the batch norm; trained across
    processes it raises (ROADMAP item 10) instead of normalising its own
    batch alone; its eval forward reads the running statistics anywhere.
    ``convert_sync_batchnorm`` swaps every batch norm, state kept."""
    net = tp.nn.Sequential(tp.nn.Conv2D(3, 4, 3), tp.nn.BatchNorm2D(4),
                           tp.nn.ReLU())
    with torch.no_grad():
        net[1]._mean.fill_(0.5)
    synced = tp.nn.SyncBatchNorm.convert_sync_batchnorm(net)
    assert isinstance(synced[1], tp.nn.SyncBatchNorm)
    assert float(synced[1]._mean[0]) == 0.5
    assert torch.equal(synced[0].weight, net[0].weight)
    x = tp.to_tensor(f(2, 3, 6, 6))
    assert torch.equal(synced(x), net(x))
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    with pytest.raises(NotImplementedError, match="item 10"):
        synced(x)
    synced.eval()
    net.eval()
    assert torch.equal(synced(x), net(x))


def test_cudnn_deterministic_flag_drives_cudnn():
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    try:
        torch.backends.cudnn.benchmark = True
        tp.set_flags({"FLAGS_cudnn_deterministic": True})
        assert torch.backends.cudnn.deterministic
        assert not torch.backends.cudnn.benchmark
        assert tp.get_flags("FLAGS_cudnn_deterministic") == \
            {"FLAGS_cudnn_deterministic": True}
        tp.set_flags({"FLAGS_cudnn_deterministic": False})
        assert not torch.backends.cudnn.deterministic
    finally:
        tp.set_flags({"FLAGS_cudnn_deterministic": False})
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


def test_deepcopy_of_a_layer_with_buffers():
    """``copy.deepcopy`` copies a batch norm's buffers (``Tensor``s, not
    parameters) as ``Tensor``s with their values, detached from the
    original."""
    bn = tp.nn.BatchNorm2D(3)
    with torch.no_grad():
        bn._mean.fill_(0.25)
    twin = copy.deepcopy(bn)
    assert type(twin._mean) is tp.Tensor
    assert twin._mean.data_ptr() != bn._mean.data_ptr()
    assert torch.equal(twin._mean, bn._mean)
    assert torch.equal(twin.weight, bn.weight)
    t = tp.to_tensor([1.0, 2.0], stop_gradient=False)
    c = copy.deepcopy(t)
    assert not c.stop_gradient and torch.equal(c, t)
