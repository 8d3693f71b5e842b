"""The port's shape and indexing ops (``paddle_tpu_torch.ops.manipulation``)
against the JAX package's: one parametrised table of public op names
resolved with ``getattr`` on both packages, numpy inputs from a seed, the
forward at rtol 1e-4 / atol 1e-5 and the gradient against the JAX tape
at 1e-4 (index outputs compared by value: the port's are int64, the JAX
package's int32)."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp

from _torch_op_parity import (ATOL, RTOL, _on_cpu,  # noqa: F401
                              f, i, run_case)


X = f(3, 4)
X3 = f(2, 3, 4)
DISTINCT = np.random.default_rng(3).permutation(12).reshape(3, 4).astype(
    np.float32)

CASES = [
    ("cast", (X,), {"dtype": "float16"}, ()),
    ("reshape", (X3,), {"shape": [4, -1]}, (0,)),
    ("view", (X3,), {"shape": [6, 4]}, (0,)),
    ("transpose", (X3,), {"perm": [2, 0, 1]}, (0,)),
    ("t", (X,), {}, (0,)),
    ("moveaxis", (X3,), {"source": 0, "destination": 2}, (0,)),
    ("squeeze", (f(3, 1, 4, 1),), {"axis": [1, 3]}, (0,)),
    ("squeeze", (f(3, 1, 4, 1),), {}, (0,)),
    ("unsqueeze", (X,), {"axis": [0, 2]}, (0,)),
    ("flatten", (f(2, 3, 4, 5),), {"start_axis": 1, "stop_axis": 2}, (0,)),
    ("concat", ([X, f(2, 4, seed=1)],), {"axis": 0}, ()),
    ("stack", ([X, f(3, 4, seed=1)],), {"axis": 1}, ()),
    ("split", (f(6, 4),), {"num_or_sections": 3, "axis": 0}, (0,)),
    ("split", (f(6, 4),), {"num_or_sections": [1, -1, 2], "axis": 0}, (0,)),
    ("chunk", (f(3, 6),), {"chunks": 2, "axis": 1}, (0,)),
    ("unbind", (X,), {"axis": 1}, (0,)),
    ("unstack", (X,), {"axis": 0}, (0,)),
    ("tile", (X,), {"repeat_times": [2, 1]}, (0,)),
    ("expand", (f(1, 4),), {"shape": [3, -1]}, (0,)),
    ("expand_as", (f(1, 4), X), {}, (0,)),
    ("broadcast_to", (f(4),), {"shape": [2, 4]}, (0,)),
    ("broadcast_tensors", ([f(1, 4), f(3, 1, seed=1)],), {}, ()),
    ("flip", (X,), {"axis": [1]}, (0,)),
    ("rot90", (X,), {"k": 1, "axes": [0, 1]}, (0,)),
    ("roll", (X,), {"shifts": 1, "axis": 1}, (0,)),
    ("roll", (X,), {"shifts": 2}, (0,)),
    ("gather", (X, i(5, high=3)), {"axis": 0}, (0,)),
    ("gather", (X, i(2, high=4)), {"axis": 1}, (0,)),
    ("gather_nd", (X3, i(4, 2, high=2)), {}, (0,)),
    ("scatter", (X, np.array([2, 0]), f(2, 4, seed=1)), {}, (0, 2)),
    ("scatter", (X, np.array([2, 0, 2]), f(3, 4, seed=1)),
     {"overwrite": False}, ()),
    ("scatter_nd_add", (X, np.array([[1], [2], [1]]), f(3, 4, seed=1)), {},
     (0, 2)),
    ("scatter_nd", (np.array([[1], [2]]), f(2, 4, seed=1), [3, 4]), {}, ()),
    ("index_select", (X, np.array([3, 0, 1])), {"axis": 1}, (0,)),
    ("index_sample", (X, i(3, 2, high=4)), {}, (0,)),
    ("index_add", (X, np.array([0, 2]), 0, f(2, 4, seed=1)), {}, (0, 3)),
    ("masked_select", (X, X > 0), {}, ()),
    ("masked_fill", (X, X > 0, 2.0), {}, (0,)),
    ("where", (X > 0, X, f(3, 4, seed=1)), {}, (1, 2)),
    ("take_along_axis", (X, i(3, 2, high=4)), {"axis": 1}, (0,)),
    ("put_along_axis", (X, i(3, 1, high=4), f(3, 1, seed=1)),
     {"axis": 1}, ()),
    ("put_along_axis", (X, i(3, 1, high=4), f(3, 1, seed=1)),
     {"axis": 1, "reduce": "add"}, ()),
    ("slice", (X3,), {"axes": [1, 2], "starts": [0, 1], "ends": [2, 3]},
     (0,)),
    ("strided_slice", (f(6, 8),),
     {"axes": [0, 1], "starts": [0, 1], "ends": [6, 8], "strides": [2, 3]},
     (0,)),
    ("strided_slice", (f(6, 8),),
     {"axes": [1], "starts": [6], "ends": [0], "strides": [-2]}, (0,)),
    ("crop", (X,), {"shape": [2, 2], "offsets": [1, 1]}, (0,)),
    ("repeat_interleave", (X,), {"repeats": 2, "axis": 1}, (0,)),
    ("topk", (DISTINCT,), {"k": 2}, (0,)),
    ("topk", (DISTINCT,), {"k": 2, "axis": 0, "largest": False}, (0,)),
    ("sort", (DISTINCT,), {"axis": 1}, (0,)),
    ("sort", (DISTINCT,), {"axis": 0, "descending": True}, (0,)),
    ("argsort", (DISTINCT,), {"axis": 1}, ()),
    ("argsort", (DISTINCT,), {"axis": 1, "descending": True}, ()),
    ("argmax", (DISTINCT,), {"axis": 1}, ()), ("argmax", (DISTINCT,), {}, ()),
    ("argmin", (DISTINCT,), {"axis": 0, "keepdim": True}, ()),
    ("mode", (np.array([[1, 2, 2, 3], [4, 4, 1, 1]], np.float32),), {}, ()),
    ("kthvalue", (DISTINCT,), {"k": 2, "axis": 1}, (0,)),
    ("searchsorted", (np.array([1.0, 3.0, 5.0, 7.0], np.float32),
                      np.array([0.0, 3.0, 6.0], np.float32)), {}, ()),
    ("bucketize", (np.array([0.0, 3.0, 6.0], np.float32),
                   np.array([1.0, 3.0, 5.0, 7.0], np.float32)),
     {"right": True}, ()),
    ("unique", (np.array([3, 1, 3, 2, 1], np.int64),), {}, ()),
    ("unique", (np.array([3, 1, 3, 2, 1], np.int64),),
     {"return_index": True, "return_inverse": True, "return_counts": True},
     ()),
    ("unique_consecutive", (np.array([1, 1, 2, 2, 3, 1], np.int64),),
     {"return_counts": True}, ()),
    ("nonzero", (np.where(X > 0, X, 0),), {}, ()),
    ("nonzero", (np.where(X > 0, X, 0),), {"as_tuple": True}, ()),
    ("one_hot", (i(5, high=4),), {"num_classes": 4}, ()),
    ("pad", (f(1, 2, 3, 3),), {"pad": [1, 0, 2, 1], "value": 0.5}, (0,)),
    ("pad", (f(1, 2, 3, 3),), {"pad": [1, 1, 1, 1], "mode": "reflect"},
     (0,)),
    ("pad", (f(1, 2, 3, 3),), {"pad": [1, 1, 0, 1], "mode": "replicate"},
     (0,)),
    ("pad", (f(2, 3),), {"pad": [1, 0, 0, 2]}, (0,)),
    ("shard_index", (i(6, 1, high=20),),
     {"index_num": 20, "nshards": 2, "shard_id": 1}, ()),
    ("tensordot", (f(2, 3, 4), f(3, 4, 5, seed=1)), {"axes": 2}, (0, 1)),
    ("tensordot", (f(2, 3), f(3, 2, seed=1)), {"axes": [[1], [0]]}, (0, 1)),
    ("atleast_2d", (f(4),), {}, ()), ("atleast_3d", (f(4),), {}, ()),
    ("view_as", (X3, f(6, 4)), {}, (0,)),
    ("as_real", (None,), {}, ()),
]
CASES = [c for c in CASES if c[0] != "as_real"]


@pytest.mark.parametrize("name,args,kwargs,grad", CASES,
                         ids=[f"{c[0]}-{k}" for k, c in enumerate(CASES)])
def test_manipulation_op(name, args, kwargs, grad):
    run_case(name, args, kwargs, grad)


def test_as_complex_as_real_round_trip():
    a = f(3, 2)
    jc, tc = jp.as_complex(jp.to_tensor(a)), tp.as_complex(tp.to_tensor(a))
    np.testing.assert_allclose(tc.numpy(), jc.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tp.as_real(tc).numpy(), a)


@pytest.mark.parametrize("call,torch_form", [
    (lambda x: x.reshape([4, 3]), lambda x: x.reshape(4, 3)),
    (lambda x: x.transpose([1, 0]), lambda x: x.transpose(0, 1)),
    (lambda x: x.expand([2, 3, 4]), lambda x: x.expand(2, 3, 4)),
    (lambda x: x.sum(axis=1), lambda x: x.sum(dim=1)),
    (lambda x: x.view([12]), lambda x: x.view(12))],
    ids=["reshape", "transpose", "expand", "sum", "view"])
def test_methods_take_both_forms(call, torch_form):
    """Paddle's signature and torch's give the same result on a
    ``Tensor`` (torch's own code calls the methods in its form)."""
    x = tp.to_tensor(X)
    torch.testing.assert_close(call(x), torch_form(x))


def test_split_and_max_are_paddle_methods():
    """``x.split(3)`` is three parts and ``x.max(axis)`` the values, as in
    the JAX package."""
    a, b = jp.to_tensor(f(6, 2)), tp.to_tensor(f(6, 2))
    assert len(b.split(3)) == len(a.split(3)) == 3
    np.testing.assert_allclose(b.max(axis=0).numpy(), a.max(axis=0).numpy())
