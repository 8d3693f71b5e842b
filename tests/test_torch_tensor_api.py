"""The port's Paddle ``Tensor`` surface (``paddle_tpu_torch.core.tensor``,
``core.dispatch``, ``core.autograd``, ``autograd.PyLayer``) held against
the JAX package on the same numpy inputs: ``to_tensor``'s types,
``stop_gradient``, ``shape``, ``numpy``, indexing and ``__setitem__``,
the in-place ops, ``register_hook``, ``backward(grad_tensor,
retain_graph)``, ``clear_grad``, ``paddle.grad`` (double backward,
``allow_unused``), ``PyLayer`` and ``no_grad``. Values at rtol 1e-4 /
atol 1e-5; the JAX package's int64 is int32 (XLA without 64-bit mode),
the port's is int64."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.core import device as tp_device

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    saved = tp_device._default[0]
    tp.set_device("cpu")
    yield
    tp_device._default[0] = saved


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a.numpy() if hasattr(a, "numpy")
                                          else a),
                               np.asarray(b.numpy() if hasattr(b, "numpy")
                                          else b), rtol=rtol, atol=atol)


def _same_type(port, jax):
    """The port's type is the JAX package's, or int64 where that one is
    int32 (its int64)."""
    p = tp.core.dtype.dtype_name(port.dtype)
    j = str(np.dtype(jax.dtype))
    return p == j or (p, j) == ("int64", "int32")


@pytest.mark.parametrize("data,dtype", [
    (1.5, None), (3, None), (True, None), ([1.0, 2.0], None),
    ([[1, 2], [3, 4]], None), (np.arange(4, dtype=np.float64), None),
    (np.arange(6, dtype=np.int32).reshape(2, 3), None),
    ([1.0, 2.0], "float16"), ([1, 2], "float32"), (2.5, "bfloat16")],
    ids=["float", "int", "bool", "floats", "ints", "f64-array", "i32-array",
         "as-f16", "as-f32", "as-bf16"])
def test_to_tensor_types(data, dtype):
    """Python floats and float64 arrays become float32, Python ints int64
    (the JAX package's int32), an explicit dtype wins; values equal."""
    a = jp.to_tensor(data, dtype=dtype)
    b = tp.to_tensor(data, dtype=dtype)
    assert isinstance(b, tp.Tensor) and isinstance(b, torch.Tensor)
    assert _same_type(b, a)
    assert list(b.shape) == list(a.shape)
    _close(b, np.asarray(a.numpy(), np.float64).astype(b.numpy().dtype))
    assert b.stop_gradient and a.stop_gradient


def test_stop_gradient_and_parameter():
    """``stop_gradient`` is the inverse of ``requires_grad``; a
    ``Parameter`` is a ``torch.nn.Parameter`` and a ``Tensor`` that
    needs a gradient; ``trainable`` and ``name`` carry."""
    x = tp.to_tensor([1.0, 2.0])
    assert x.stop_gradient and not x.requires_grad
    x.stop_gradient = False
    assert x.requires_grad
    p = tp.Parameter(torch.ones(2, 3), name="w")
    jpar = jp.Parameter(np.ones((2, 3), np.float32), name="w")
    assert isinstance(p, torch.nn.Parameter) and isinstance(p, tp.Tensor)
    assert p.stop_gradient == jpar.stop_gradient is False
    assert p.trainable == jpar.trainable is True
    assert p.name == jpar.name == "w"
    p.trainable = False
    assert p.stop_gradient


def test_shape_size_numpy_and_methods():
    """``list(x.shape)``, ``size`` (an int that torch can still call),
    ``ndim``, ``numpy``, ``astype``, ``place``, ``set_value``."""
    arr = np.random.default_rng(0).standard_normal((2, 3, 4)).astype(
        np.float32)
    a, b = jp.to_tensor(arr), tp.to_tensor(arr)
    assert list(b.shape) == list(a.shape) == [2, 3, 4]
    assert b.size == a.size == 24 and b.size() == torch.Size([2, 3, 4])
    assert b.ndim == a.ndim and b.rank() == 3
    _close(b, a)
    assert str(b.astype("float16").dtype) == "torch.float16"
    assert b.place.is_cpu_place()
    b.set_value(np.zeros((2, 3, 4)))
    assert float(b.sum()) == 0.0
    with pytest.raises(ValueError):
        b.set_value(np.zeros((3, 3)))


def _parts(parts):
    return [list(p.shape) for p in parts]


def _host(t):
    return t.detach().numpy()


@pytest.mark.parametrize("holder", ["Tensor", "Parameter"])
def test_torch_form_calls_keep_torch_meaning(holder):
    """On a ``Tensor`` and on a ``Parameter``, torch's own functions
    (which call the tensor's methods in torch's form) and torch-form
    method calls (``dim=``, an int ``dim`` first) keep torch's meaning;
    the Paddle-form calls give what the JAX package gives."""
    data = np.arange(12, dtype=np.float32).reshape(2, 6)[:, ::-1].copy()
    x = tp.to_tensor(data) if holder == "Tensor" else \
        tp.Parameter(torch.from_numpy(data.copy()))
    jx = jp.to_tensor(data)
    with torch.no_grad():   # a Parameter's outputs need no gradient here
        # torch's functions
        assert _parts(torch.split(x, 4, 1)) == [[2, 4], [2, 2]]
        assert _parts(torch.split(x, 3, dim=1)) == [[2, 3], [2, 3]]
        vals, idx = torch.max(x, 1)
        np.testing.assert_array_equal(_host(vals), data.max(1))
        np.testing.assert_array_equal(_host(idx), data.argmax(1))
        vals, idx = torch.sort(x, 1)
        np.testing.assert_array_equal(_host(idx), np.argsort(data, 1))
        _close(torch.std(x, False), data.std())
        # torch-form method calls
        assert _parts(x.split(4, dim=1)) == [[2, 4], [2, 2]]
        vals, idx = x.max(dim=1)
        np.testing.assert_array_equal(_host(idx), data.argmax(1))
        vals, idx = x.min(dim=0, keepdim=True)
        np.testing.assert_array_equal(_host(idx), data.argmin(0)[None])
        index = torch.tensor([[0, 2], [1, 1]])
        _close(x.gather(1, index),
               np.take_along_axis(data, index.numpy(), 1))
        _close(x.index_select(1, torch.tensor([0, 2])), data[:, [0, 2]])
        _close(x.std(False), data.std())
        _close(x.max(torch.full((2, 6), 5.0)), np.maximum(data, 5.0))
        # Paddle-form calls, against the JAX package
        assert _parts(x.split(3, 1)) == _parts(jp.split(jx, 3, 1))
        assert _parts(x.split(3, 1)) == [[2, 2]] * 3
        _close(x.max(1), jp.max(jx, 1))
        _close(x.min(axis=0), jp.min(jx, axis=0))
        _close(x.sort(1), jp.sort(jx, 1))
        rows = np.array([1, 0])
        _close(x.gather(tp.to_tensor(rows)),
               jp.gather(jx, jp.to_tensor(rows)))
        _close(x.index_select(tp.to_tensor(rows), 0),
               jp.index_select(jx, jp.to_tensor(rows), 0))


def test_kernel_wrappers_keep_torch_meaning():
    """A method called from the port's kernel wrappers (whose autograd
    backwards get their saved ``Tensor`` arguments back) keeps torch's
    meaning, as a call from torch's own code does."""
    ns = {"__name__": "paddle_tpu_torch.kernels._probe"}
    exec("def chunks(t):\n    return t.split(4, 1)\n", ns)
    x = tp.to_tensor(np.zeros((2, 6), np.float32))
    assert _parts(ns["chunks"](x)) == [[2, 4], [2, 2]]
    assert _parts(x.split(3, 1)) == [[2, 2]] * 3     # Paddle's, from here


def test_reduction_dtype_accumulates_in_that_type():
    """``x.sum(dtype=...)`` casts before it reduces, as torch does: the
    float64 sum of float32 values that cancel in float32 is exact."""
    data = np.array([1e8, 1.0, -1e8, 1.0], np.float32)
    x = tp.to_tensor(data)
    got = x.sum(dtype="float64")
    assert got.dtype == torch.float64
    assert float(got) == float(data.astype(np.float64).sum()) == 2.0
    assert float(x.mean(dtype="float64")) == 0.5
    assert float(x.sum(dim=0, dtype=torch.float64)) == 2.0


def test_torch_init_on_a_parameter():
    """``torch.nn.init`` draws into a Paddle ``Parameter`` as into any
    tensor (``normal_`` / ``uniform_`` with torch's ``generator=``), and
    the parameter stays a leaf."""
    p = tp.Parameter(torch.zeros(3, 4))
    torch.nn.init.normal_(p, 0.0, 2.0, generator=torch.Generator()
                          .manual_seed(5))
    want = torch.zeros(3, 4).normal_(0.0, 2.0, generator=torch.Generator()
                                     .manual_seed(5))
    assert torch.equal(p.detach().as_subclass(torch.Tensor), want)
    torch.nn.init.uniform_(p, -0.5, 0.5, generator=torch.Generator()
                           .manual_seed(6))
    want = torch.zeros(3, 4).uniform_(-0.5, 0.5, generator=torch.Generator()
                                      .manual_seed(6))
    assert torch.equal(p.detach().as_subclass(torch.Tensor), want)
    assert p.is_leaf and p.grad_fn is None


def _pair(shape, seed=0, grad=True):
    arr = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    a = jp.to_tensor(arr, stop_gradient=not grad)
    b = tp.to_tensor(arr, stop_gradient=not grad)
    return a, b


@pytest.mark.parametrize("index", [
    1, (slice(None), slice(1, 3)), (Ellipsis, None), [0, 2],
    (slice(None, None, 2), -1), (1, slice(None), 0)],
    ids=["int", "slices", "ellipsis-newaxis", "list", "step-neg", "mixed"])
def test_getitem_and_its_gradient(index):
    """Indexing reads the same elements and routes the same gradient."""
    a, b = _pair((4, 5, 3))
    _close(b[index], a[index])
    ga = jp.grad((a[index] * 2.0).sum(), a)[0]
    gb = tp.grad((b[index] * 2.0).sum(), b)[0]
    _close(gb, ga)


def test_getitem_bool_mask_and_tensor_index():
    a, b = _pair((4, 3), grad=False)
    mask = np.array([True, False, True, False])
    _close(b[tp.to_tensor(mask)], a[jp.to_tensor(mask)])
    idx = np.array([3, 0])
    _close(b[tp.to_tensor(idx)], a[jp.to_tensor(idx)])


def test_setitem_in_place_with_gradient():
    """``y[index] = value`` on an op's output writes in place; the
    gradient no longer flows to the overwritten elements."""
    a, b = _pair((3, 4))
    ya, yb = a * 1.0, b * 1.0
    ya[1, 1:3] = 5.0
    yb[1, 1:3] = 5.0
    _close(yb, ya)
    (ya * ya).sum().backward()
    (yb * yb).sum().backward()
    _close(b.grad, a.grad)


@pytest.mark.parametrize("method,args", [
    ("add_", (2.0,)), ("subtract_", (1.5,)), ("multiply_", (3.0,)),
    ("divide_", (2.0,)), ("scale_", (2.0, 1.0)), ("clip_", (-0.5, 0.5)),
    ("exp_", ()), ("floor_", ()), ("ceil_", ()), ("reciprocal_", ()),
    ("fill_", (7.0,)), ("zero_", ())])
def test_in_place_ops(method, args):
    a, b = _pair((3, 4), grad=False)
    targs_a = tuple(jp.to_tensor(np.full((3, 4), v, np.float32))
                    if method in ("add_", "subtract_", "multiply_",
                                  "divide_") else v for v in args)
    ra = getattr(a, method)(*targs_a)
    rb = getattr(b, method)(*args)
    assert rb is b
    _close(b, a)
    _close(rb, ra)


def test_register_hook_scales_the_gradient():
    a, b = _pair((5,))
    a.register_hook(lambda g: g * 3.0)
    hb = b.register_hook(lambda g: g * 3.0)
    (a * a).sum().backward()
    (b * b).sum().backward()
    _close(b.grad, a.grad)
    hb.remove()
    b.clear_grad()
    (b * b).sum().backward()
    _close(b.grad, 2.0 * b.numpy())


def test_backward_grad_tensor_retain_graph_and_clear_grad():
    """``backward(grad_tensor)`` seeds a non-scalar root; with
    ``retain_graph`` a second backward accumulates; ``clear_grad``
    drops the gradient."""
    a, b = _pair((2, 3))
    g = np.random.default_rng(1).standard_normal((2, 3)).astype(np.float32)
    ya, yb = a * a, b * b
    ya.backward(jp.to_tensor(g), retain_graph=True)
    yb.backward(tp.to_tensor(g), retain_graph=True)
    _close(b.grad, a.grad)
    ya.backward(jp.to_tensor(g))
    yb.backward(tp.to_tensor(g))
    _close(b.grad, a.grad)
    _close(b.gradient(), 4.0 * g * b.numpy())
    b.clear_grad()
    assert b.grad is None


def test_grad_double_backward():
    """``paddle.grad(create_graph=True)``: the first derivative is
    differentiable, its backward gives the second."""
    a, b = _pair((4,))
    (ga,) = jp.grad((a * a * a).sum(), a, create_graph=True)
    (gb,) = tp.grad((b * b * b).sum(), b, create_graph=True)
    _close(gb, ga)
    assert not gb.stop_gradient
    (ga * ga).sum().backward()
    (gb * gb).sum().backward()
    _close(b.grad, a.grad)


def test_grad_allow_unused():
    a, b = _pair((3,))
    ua, ub = _pair((3,), seed=1)
    ga = jp.grad((a * 2.0).sum(), [a, ua], allow_unused=True)
    gb = tp.grad((b * 2.0).sum(), [b, ub], allow_unused=True)
    assert ga[1] is None and gb[1] is None
    _close(gb[0], ga[0])
    with pytest.raises(RuntimeError):
        tp.grad((b * 2.0).sum(), [b, ub])


def _exp_layer(pkg):
    class Exp(pkg.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, scale=1.0):
            y = pkg.exp(x) * scale
            ctx.save_for_backward(y)
            return y

        @staticmethod
        def backward(ctx, dy):
            (y,) = ctx.saved_tensor
            return dy * y * 2.0      # a deliberate non-derivative rule
    return Exp


def test_pylayer_forward_and_backward():
    """A ``PyLayer`` runs its own forward and its own backward rule."""
    a, b = _pair((2, 3))
    oa = _exp_layer(jp).apply(a, scale=0.5)
    ob = _exp_layer(tp).apply(b, scale=0.5)
    assert isinstance(ob, tp.Tensor)
    _close(ob, oa)
    (oa * 1.5).sum().backward()
    (ob * 1.5).sum().backward()
    _close(b.grad, a.grad)


def test_no_grad_and_grad_mode():
    a, b = _pair((3,))
    with jp.no_grad():
        ya = a * 2.0
    with tp.no_grad():
        yb = b * 2.0
        assert not tp.is_grad_enabled()
    assert ya.stop_gradient and yb.stop_gradient
    assert not (b * 2.0).stop_gradient
    assert tp.is_grad_enabled()


def test_flash_attention_apply_returns_the_subclass():
    """The attention functional under autograd takes and gives
    ``Tensor``s (its kernel wrapper runs on plain tensors inside the op);
    plain tensors in give plain tensors out, as the port's models call
    it."""
    from paddle_tpu_torch.nn import functional as F
    rng = np.random.default_rng(2)
    q, k, v = (tp.to_tensor(rng.standard_normal((1, 128, 2, 64)).astype(
        np.float32), stop_gradient=False) for _ in range(3))
    out = F.scaled_dot_product_attention(q, k, v)
    assert type(out) is tp.Tensor
    out.sum().backward()
    assert q.grad is not None and k.grad is not None
    plain = F.scaled_dot_product_attention(*(t.detach().as_subclass(
        torch.Tensor) for t in (q, k, v)))
    assert type(plain) is torch.Tensor
    torch.testing.assert_close(plain, out.detach().as_subclass(torch.Tensor))


@pytest.mark.cuda
def test_flash_attention_apply_on_the_card_returns_the_subclass():
    """On the card the functional launches the flash kernels and still
    returns a ``Tensor``, with gradients for its inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from paddle_tpu_torch.kernels import launch_counts
    from paddle_tpu_torch.nn import functional as F
    tp.set_device("gpu")
    q, k, v = (tp.randn([2, 256, 4, 64]).astype("bfloat16")
               for _ in range(3))
    for t in (q, k, v):
        t.stop_gradient = False
    before = launch_counts()
    out = F.scaled_dot_product_attention(q, k, v)
    out.float().sum().backward()
    torch.cuda.synchronize()
    after = launch_counts()
    assert type(out) is tp.Tensor
    assert after["flash_attention_fwd"] == before["flash_attention_fwd"] + 1
    assert after["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    assert q.grad is not None


def test_dispatch_register_op_explicit_backward():
    """``register_op(name, fwd, bwd)`` becomes one autograd Function whose
    backward is ``bwd(primals, outs, cotangents)``; without ``bwd``
    torch autograd differentiates ``fwd``."""
    from paddle_tpu_torch.core.dispatch import apply_op, register_op
    register_op("test_cube", lambda x: x ** 3,
                bwd=lambda primals, outs, cts: (cts[0] * 10.0,))
    register_op("test_square", lambda x: x * x)
    _, b = _pair((3,))
    apply_op("test_cube", (b,)).sum().backward()
    _close(b.grad, np.full(3, 10.0, np.float32))
    b.clear_grad()
    out = apply_op("test_square", (b,))
    assert type(out) is tp.Tensor
    out.sum().backward()
    _close(b.grad, 2.0 * b.numpy())


def test_flags_and_check_nan_inf():
    """``set_flags`` / ``get_flags`` with the JAX package's names;
    ``FLAGS_check_nan_inf`` makes a dispatched op raise on a NaN."""
    assert tp.get_flags("FLAGS_check_nan_inf") == \
        jp.get_flags("FLAGS_check_nan_inf")
    with pytest.raises(KeyError):
        tp.set_flags({"FLAGS_no_such_flag": 1})
    tp.set_flags({"FLAGS_check_nan_inf": True})
    try:
        with pytest.raises(FloatingPointError):
            tp.log(tp.to_tensor([-1.0]))
    finally:
        tp.set_flags({"FLAGS_check_nan_inf": False})


def test_devices():
    """``set_device("cpu")`` is the way onto the CPU; without CUDA the
    default place raises instead of falling back."""
    assert tp.get_device() == "cpu"
    tp_device._default[0] = None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tp.to_tensor([1.0])
        with pytest.raises(RuntimeError):
            tp.CUDAPlace(0)
    tp.set_device("cpu")
    assert tp.to_tensor([1.0], place=tp.CPUPlace()).place == tp.CPUPlace()
