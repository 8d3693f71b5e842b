"""The parity harness the op tables share (``test_torch_ops_math.py``,
``test_torch_ops_manipulation.py``, ``test_torch_ops_linalg.py``): the
CPU place, seeded numpy inputs, and ``run_case``, which calls one public
op name on both packages and holds the forward at rtol 1e-4 / atol 1e-5
and the gradient against the JAX tape at 1e-4. The tables are split
across files so that ``--dist loadfile`` spreads them over workers."""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.core import device as tp_device

RTOL, ATOL, GRAD_TOL = 1e-4, 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _on_cpu():
    saved = tp_device._default[0]
    tp.set_device("cpu")
    yield
    tp_device._default[0] = saved


def _rng(seed=0):
    return np.random.default_rng(seed)


def f(*shape, seed=0, lo=None):
    """A float32 array from a seed (uniform in [lo, lo + 1) when ``lo`` is
    given, else standard normal)."""
    r = _rng(seed)
    if lo is not None:
        return (r.random(shape) + lo).astype(np.float32)
    return r.standard_normal(shape).astype(np.float32)


def i(*shape, high=5, seed=0):
    return _rng(seed).integers(0, high, shape).astype(np.int64)


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _leaves(o)]
    return [out]


def _as_np(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def _wrap(pkg, a, stop):
    """numpy arrays (alone or in a list) as ``pkg``'s tensors."""
    if isinstance(a, np.ndarray):
        return pkg.to_tensor(a, stop_gradient=stop)
    if isinstance(a, list) and a and isinstance(a[0], np.ndarray):
        return [pkg.to_tensor(x, stop_gradient=stop) for x in a]
    return a


def _namespace(pkg, module):
    for part in filter(None, module.split(".")):
        pkg = getattr(pkg, part)
    return pkg


def run_case(name, args, kwargs, grad, module="", rtol=RTOL, atol=ATOL,
             grad_tol=GRAD_TOL):
    """``name`` resolved with getattr on both packages (``module`` a
    sub-namespace such as ``linalg`` or ``nn.functional``), called on the
    same numpy inputs: every output within ``rtol`` / ``atol`` (NaNs in
    the same places); where ``grad`` lists input positions, the gradient
    of a fixed random projection of the first output against the JAX tape
    within ``grad_tol``."""
    jmod, tmod = _namespace(jp, module), _namespace(tp, module)
    jfn, tfn = getattr(jmod, name), getattr(tmod, name)
    ja = [_wrap(jp, a, k not in grad) for k, a in enumerate(args)]
    ta = [_wrap(tp, a, k not in grad) for k, a in enumerate(args)]
    jo, to = jfn(*ja, **kwargs), tfn(*ta, **kwargs)
    jl, tl = _leaves(jo), _leaves(to)
    assert len(jl) == len(tl), f"{name}: {len(tl)} outputs, JAX {len(jl)}"
    for x, y in zip(tl, jl):
        if y is None:
            assert x is None
            continue
        assert isinstance(x, tp.Tensor), f"{name} gave a {type(x)}"
        xa, ya = _as_np(x), _as_np(y)
        assert list(xa.shape) == list(ya.shape), (name, xa.shape, ya.shape)
        if ya.dtype == np.bool_:
            assert (xa == ya).all(), name
        else:
            np.testing.assert_allclose(xa.astype(np.float64),
                                       ya.astype(np.float64), rtol=rtol,
                                       atol=atol, err_msg=name)
    if not grad:
        return
    ct = _rng(99).standard_normal(_as_np(jl[0]).shape).astype(np.float32)
    jg = jp.grad((jl[0] * jp.to_tensor(ct)).sum(), [ja[k] for k in grad])
    tg = tp.grad((tl[0] * tp.to_tensor(ct)).sum(), [ta[k] for k in grad])
    for k, x, y in zip(grad, tg, jg):
        np.testing.assert_allclose(_as_np(x), _as_np(y), rtol=grad_tol,
                                   atol=grad_tol,
                                   err_msg=f"{name} gradient {k}")
