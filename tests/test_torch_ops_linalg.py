"""The port's linear algebra (``paddle_tpu_torch.linalg``), comparison
and logical ops and deterministic creation ops against the JAX
package's: one parametrised table of public op names resolved with
``getattr`` on both packages (``linalg`` names on the ``linalg``
namespaces), numpy inputs from a seed, the forward at rtol 1e-4 / atol
1e-5 and the gradient against the JAX tape at 1e-4. The random creation
ops draw on the port's chain (other bits than the JAX package's): they
are held to their distributions."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp

from _torch_op_parity import _on_cpu, f, i, run_case  # noqa: F401

X = f(3, 4)
Y = f(3, 4, seed=1)
SQ = f(4, 4) + 4.0 * np.eye(4, dtype=np.float32)          # well conditioned
SPD = (SQ @ SQ.T + np.eye(4, dtype=np.float32)).astype(np.float32)
DISTINCT_SPD = (np.diag([1.0, 2.0, 3.5, 5.0]) + 0.1 * np.ones((4, 4))
                ).astype(np.float32)

LINALG = [
    ("norm", (X,), {}, (0,)), ("norm", (X,), {"p": 1, "axis": 1}, (0,)),
    ("norm", (X,), {"p": float("inf"), "axis": 0}, ()),
    ("vector_norm", (X,), {"p": 3.0, "axis": 1}, (0,)),
    ("matrix_norm", (X,), {}, (0,)),
    ("matrix_norm", (SQ,), {"p": 1}, ()),
    ("dist", (X, Y), {"p": 2}, (0, 1)),
    ("cond", (SQ,), {}, ()),
    ("matrix_rank", (SQ,), {}, ()),
    ("cholesky", (SPD,), {}, (0,)),
    ("cholesky", (SPD,), {"upper": True}, ()),
    ("svdvals", (X,), {}, (0,)),
    ("eigvalsh", (DISTINCT_SPD,), {}, (0,)),
    ("inv", (SQ,), {}, (0,)), ("pinv", (X,), {}, ()),
    ("solve", (SQ, f(4, 2, seed=2)), {}, (0, 1)),
    ("triangular_solve", (np.triu(SQ), f(4, 2, seed=2)), {}, (1,)),
    ("triangular_solve", (np.tril(SQ), f(4, 2, seed=2)),
     {"upper": False, "transpose": True}, ()),
    ("cholesky_solve", (f(4, 2, seed=2), np.linalg.cholesky(SPD)), {}, ()),
    ("det", (SQ,), {}, (0,)), ("slogdet", (SQ,), {}, ()),
    ("matrix_power", (SQ * 0.3,), {"n": 3}, (0,)),
    ("matrix_exp", (SQ * 0.1,), {}, ()),
    ("mv", (X, f(4, seed=2)), {}, (0, 1)),
    ("bmm", (f(2, 3, 4), f(2, 4, 5, seed=1)), {}, (0, 1)),
    ("bincount", (i(10, high=5),), {"minlength": 6}, ()),
    ("histogram", (X,), {"bins": 5, "min": -2, "max": 2}, ()),
    ("cross", (f(2, 3), f(2, 3, seed=1)), {"axis": 1}, (0, 1)),
    ("cov", (X,), {}, ()), ("corrcoef", (X,), {}, ()),
    ("einsum", ("ij,kj->ik", X, Y), {}, ()),
    ("multi_dot", ([f(2, 3), f(3, 4, seed=1), f(4, 2, seed=2)],), {}, ()),
]

LOGIC = [
    (n, (X, Y), {}, ()) for n in ("equal", "not_equal", "less_than",
                                  "less_equal", "greater_than",
                                  "greater_equal", "isclose")
] + [
    (n, (X > 0, Y > 0), {}, ()) for n in ("logical_and", "logical_or",
                                          "logical_xor")
] + [
    ("logical_not", (X > 0,), {}, ()), ("allclose", (X, X + 1e-7), {}, ()),
    ("equal_all", (X, X), {}, ()), ("equal_all", (X, Y), {}, ()),
    ("is_empty", (X,), {}, ()),
]

CREATION = [
    ("zeros", ([2, 3],), {}, ()), ("ones", ([2, 3],), {"dtype": "int32"}, ()),
    ("full", ([2, 2], 1.5), {}, ()), ("zeros_like", (X,), {}, ()),
    ("ones_like", (X,), {}, ()), ("full_like", (X, 3.0), {}, ()),
    ("arange", (5,), {}, ()), ("arange", (1.0, 4.0, 0.5), {}, ()),
    ("linspace", (0.0, 1.0, 5), {}, ()),
    ("logspace", (0.0, 2.0, 3), {}, ()),
    ("eye", (3,), {}, ()), ("eye", (2, 4), {}, ()),
    ("tril", (X,), {"diagonal": 1}, (0,)),
    ("triu", (X,), {"diagonal": -1}, (0,)),
    ("diag", (f(3),), {}, (0,)), ("diag", (SQ,), {"offset": 1}, (0,)),
    ("diagflat", (f(3),), {"offset": -1}, (0,)),
    ("meshgrid", (f(3), f(2, seed=1)), {}, ()),
    ("assign", (X,), {}, ()), ("clone", (X,), {}, (0,)),
    ("numel", (X,), {}, ()),
]

CASES = [(*c, "linalg") for c in LINALG] + [(*c, "") for c in LOGIC] \
    + [(*c, "") for c in CREATION]


@pytest.mark.parametrize("name,args,kwargs,grad,module", CASES,
                         ids=[f"{c[0]}-{k}" for k, c in enumerate(CASES)])
def test_linalg_logic_creation_op(name, args, kwargs, grad, module):
    run_case(name, args, kwargs, grad, module)


@pytest.mark.parametrize("name,args,check", [
    ("rand", ([4000],), lambda a: (a.min() >= 0) & (a.max() < 1)
     & (abs(a.mean() - 0.5) < 0.03)),
    ("randn", ([4000],), lambda a: (abs(a.mean()) < 0.08)
     & (abs(a.std() - 1) < 0.08)),
    ("uniform", ([4000],), lambda a: (a.min() >= -1) & (a.max() < 1)),
    ("normal", (1.0, 2.0, [4000]), lambda a: abs(a.mean() - 1) < 0.15),
    ("randint", (0, 7, [4000]), lambda a: (a.min() == 0) & (a.max() == 6)),
    ("randperm", (50,), lambda a: sorted(a.tolist()) == list(range(50))),
    ("bernoulli", (np.full(4000, 0.3, np.float32),),
     lambda a: abs(a.mean() - 0.3) < 0.04),
    ("multinomial", (np.array([0.0, 1.0, 0.0], np.float32),),
     lambda a: (a == 1).all())],
    ids=["rand", "randn", "uniform", "normal", "randint", "randperm",
         "bernoulli", "multinomial"])
def test_random_creation_distributions(name, args, check):
    """Drawn on the port's chain: the same seed gives the same values,
    and the values have the JAX op's distribution."""
    targs = [tp.to_tensor(a) if isinstance(a, np.ndarray) else a
             for a in args]
    tp.seed(5)
    a = getattr(tp, name)(*targs)
    tp.seed(5)
    b = getattr(tp, name)(*targs)
    torch.testing.assert_close(a, b)
    assert bool(check(a.numpy())), name
    jargs = [jp.to_tensor(x) if isinstance(x, np.ndarray) else x
             for x in args]
    assert list(getattr(jp, name)(*jargs).shape) == list(a.shape)
