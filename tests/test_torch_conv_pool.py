"""Convolution and pooling of the port (``nn.functional.conv``,
``nn.functional.pooling``, ``nn.layers_conv_pool``) against the JAX
package on the CPU: the same seeded numpy inputs through both, each
functional's outputs within rtol 1e-4 / atol 1e-5 (a convolution's
within 1e-4 / 1e-4: its sums run in another order) and the gradient of a
fixed random projection of the first output within 1e-4 of the JAX
tape; each layer's ``state_dict`` keys and shapes equal the JAX layer's,
and with the JAX layer's state carried over
(``convert.load_paddle_layer_state``) its output and gradients agree
within 1e-4. Named cases: ``"SAME"`` at stride 2 pads lax's way (the odd
pad high), and ``ceil_mode`` gives the JAX package's windows, a window
wholly in the pad included (``-inf`` for max, ``nan`` for an exclusive
average; torch's own ``ceil_mode`` gives 3 x 3)."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from _torch_op_parity import _on_cpu, f, run_case  # noqa: F401
from paddle_tpu_torch.convert import load_paddle_layer_state

CONV_TOL = dict(rtol=1e-4, atol=1e-4)
FN = "nn.functional"

CONV_CASES = [
    ("conv1d", [f(2, 4, 9), f(6, 4, 3, seed=1), f(6, seed=2)],
     dict(stride=2, padding=1)),
    ("conv1d", [f(2, 9, 4), f(6, 4, 3, seed=1)],
     dict(stride=2, padding="SAME", data_format="NLC")),
    ("conv2d", [f(2, 4, 9, 9), f(6, 4, 3, 3, seed=1), f(6, seed=2)],
     dict(stride=2, padding=1)),
    ("conv2d", [f(2, 4, 9, 9), f(6, 4, 3, 3, seed=1)],
     dict(padding=2, dilation=2)),
    ("conv2d", [f(2, 4, 7, 7), f(6, 2, 3, 3, seed=1), f(6, seed=2)],
     dict(padding=1, groups=2)),
    ("conv2d", [f(2, 4, 7, 7), f(4, 1, 3, 3, seed=1)],
     dict(stride=2, padding=1, groups=4)),
    ("conv2d", [f(2, 4, 8, 8), f(6, 4, 3, 3, seed=1)],
     dict(stride=2, padding="SAME")),
    ("conv2d", [f(2, 4, 8, 8), f(6, 4, 3, 3, seed=1)],
     dict(stride=2, padding="valid")),
    ("conv2d", [f(2, 4, 7, 7), f(6, 4, 3, 3, seed=1)],
     dict(padding=[1, 0, 2, 1])),
    ("conv2d", [f(2, 7, 7, 4), f(6, 4, 3, 3, seed=1), f(6, seed=2)],
     dict(stride=2, padding=1, data_format="NHWC")),
    ("conv3d", [f(1, 2, 5, 5, 5), f(3, 2, 3, 3, 3, seed=1), f(3, seed=2)],
     dict(padding=1)),
    ("conv3d", [f(1, 5, 5, 5, 2), f(3, 2, 3, 3, 3, seed=1)],
     dict(stride=2, padding="SAME", data_format="NDHWC")),
    ("conv1d_transpose", [f(2, 4, 5), f(4, 3, 3, seed=1), f(3, seed=2)],
     dict(stride=2, padding=1, output_padding=1)),
    ("conv2d_transpose", [f(2, 4, 5, 5), f(4, 3, 3, 3, seed=1),
                          f(3, seed=2)],
     dict(stride=2, padding=1, output_padding=1)),
    ("conv2d_transpose", [f(2, 4, 5, 5), f(4, 3, 3, 3, seed=1),
                          f(6, seed=2)],
     dict(stride=2, padding=1, groups=2)),
    ("conv2d_transpose", [f(2, 4, 5, 5), f(4, 3, 3, 3, seed=1)],
     dict(padding=1, dilation=2)),
    ("conv2d_transpose", [f(2, 4, 5, 5), f(4, 3, 3, 3, seed=1)],
     dict(stride=1, padding=0, output_padding=1)),
    ("conv2d_transpose", [f(2, 4, 5, 5), f(4, 3, 3, 3, seed=1),
                          f(3, seed=2)],
     dict(stride=2, padding="SAME", output_padding=1)),
    ("conv2d_transpose", [f(2, 4, 5, 5), f(4, 3, 3, 3, seed=1)],
     dict(stride=2, padding="VALID")),
    ("conv2d_transpose", [f(2, 4, 5, 5), f(4, 3, 2, 2, seed=1)],
     dict(stride=2, padding=[1, 0, 0, 1])),
    ("conv2d_transpose", [f(2, 5, 5, 4), f(4, 3, 3, 3, seed=1)],
     dict(stride=2, padding=1, output_padding=1, data_format="NHWC")),
    ("conv3d_transpose", [f(1, 2, 3, 3, 3), f(2, 2, 3, 3, 3, seed=1),
                          f(2, seed=2)],
     dict(stride=2, padding=1, output_padding=1)),
]


@pytest.mark.parametrize("name,args,kwargs", CONV_CASES,
                         ids=[f"{c[0]}-{k}" for k, c in
                              enumerate(CONV_CASES)])
def test_conv_forward_and_gradient(name, args, kwargs):
    run_case(name, args, kwargs, grad=list(range(len(args))), module=FN,
             **CONV_TOL)


def test_same_padding_at_stride_two_pads_high():
    """An 8-wide input, kernel 3, stride 2, "SAME": 4 outputs from one pad
    on the high side only (lax's rule; torch's ``padding="same"`` refuses
    a stride above 1), so the first window starts at the input's column
    0."""
    x = np.zeros((1, 1, 8, 8), np.float32)
    x[0, 0, 0, 0] = 1.0
    w = np.zeros((1, 1, 3, 3), np.float32)
    w[0, 0, 0, 0] = 1.0
    out = tp.nn.functional.conv2d(tp.to_tensor(x), tp.to_tensor(w),
                                  stride=2, padding="SAME")
    assert list(out.shape) == [1, 1, 4, 4]
    assert float(out[0, 0, 0, 0]) == 1.0 and float(out.sum()) == 1.0
    run_case("conv2d", [x, w], dict(stride=2, padding="SAME"), grad=[],
             module=FN)


POOL_CASES = [
    ("max_pool1d", [f(2, 3, 9)], dict(kernel_size=2, stride=2), True),
    ("max_pool1d", [f(2, 3, 9)], dict(kernel_size=2, stride=2,
                                      ceil_mode=True), True),
    ("max_pool2d", [f(2, 3, 8, 8)], dict(kernel_size=3, stride=2,
                                         padding=1), True),
    ("max_pool2d", [f(2, 3, 7, 7)], dict(kernel_size=2, stride=2,
                                         padding=1), True),
    ("max_pool2d", [f(2, 3, 7, 7)], dict(kernel_size=3, stride=2,
                                         ceil_mode=True), True),
    ("max_pool2d", [f(2, 8, 8, 3)], dict(kernel_size=3, stride=2,
                                         padding=1, data_format="NHWC"),
     True),
    ("max_pool2d", [f(2, 3, 8, 8)], dict(kernel_size=2, stride=2,
                                         return_mask=True), True),
    ("max_pool2d", [f(2, 3, 7, 7)], dict(kernel_size=3, stride=2,
                                         padding=1, return_mask=True), True),
    ("max_pool2d", [f(1, 2, 6, 6)], dict(kernel_size=2, stride=2,
                                         padding=2, return_mask=True), True),
    ("max_pool3d", [f(1, 2, 6, 6, 6)], dict(kernel_size=2, stride=2), True),
    ("max_pool3d", [f(1, 2, 5, 5, 5)], dict(kernel_size=3, stride=2,
                                            padding=1, return_mask=True),
     True),
    ("avg_pool1d", [f(2, 3, 9)], dict(kernel_size=3, stride=2, padding=1),
     True),
    ("avg_pool2d", [f(2, 3, 8, 8)], dict(kernel_size=2, stride=2), True),
    ("avg_pool2d", [f(2, 3, 7, 7)], dict(kernel_size=3, stride=2,
                                         padding=1), True),
    ("avg_pool2d", [f(2, 3, 7, 7)], dict(kernel_size=3, stride=2, padding=1,
                                         exclusive=False), True),
    ("avg_pool2d", [f(2, 3, 7, 7)], dict(kernel_size=2, stride=2, padding=2),
     True),
    ("avg_pool2d", [f(2, 3, 8, 8)], dict(kernel_size=3, stride=2,
                                         ceil_mode=True), True),
    ("avg_pool2d", [f(2, 8, 8, 3)], dict(kernel_size=3, stride=2, padding=1,
                                         data_format="NHWC"), True),
    ("avg_pool3d", [f(1, 2, 5, 5, 5)], dict(kernel_size=2, stride=2,
                                            padding=1), True),
    ("adaptive_avg_pool1d", [f(2, 3, 7)], dict(output_size=3), True),
    ("adaptive_avg_pool2d", [f(2, 3, 6, 6)], dict(output_size=(1, 1)),
     True),
    ("adaptive_avg_pool2d", [f(2, 3, 6, 6)], dict(output_size=3), True),
    ("adaptive_avg_pool2d", [f(2, 3, 7, 6)], dict(output_size=(3, 2)),
     True),
    ("adaptive_avg_pool2d", [f(2, 7, 5, 3)], dict(output_size=(3, 2),
                                                  data_format="NHWC"), True),
    ("adaptive_avg_pool3d", [f(1, 2, 4, 5, 4)], dict(output_size=2), True),
    ("adaptive_max_pool1d", [f(2, 3, 7)], dict(output_size=3), True),
    ("adaptive_max_pool2d", [f(2, 3, 6, 6)], dict(output_size=2), True),
    ("adaptive_max_pool2d", [f(2, 3, 7, 5)], dict(output_size=(3, 2)),
     True),
    ("adaptive_max_pool3d", [f(1, 2, 4, 5, 4)], dict(output_size=2), True),
]


@pytest.mark.parametrize("name,args,kwargs,grad", POOL_CASES,
                         ids=[f"{c[0]}-{k}" for k, c in
                              enumerate(POOL_CASES)])
def test_pool_forward_and_gradient(name, args, kwargs, grad):
    run_case(name, args, kwargs, grad=[0] if grad else [], module=FN)


def test_ceil_mode_keeps_the_jax_windows():
    """``[1, 1, 5, 5]``, kernel 2, stride 2, pad 1, ``ceil_mode``: the JAX
    package's ``[1, 1, 4, 4]`` with a last row and column wholly in the
    pad (``-inf`` for max, ``nan`` for the exclusive average), where
    torch's ``ceil_mode`` gives ``[1, 1, 3, 3]``."""
    x = np.arange(25, dtype=np.float32).reshape(1, 1, 5, 5)
    kw = dict(kernel_size=2, stride=2, padding=1, ceil_mode=True)
    mx = tp.nn.functional.max_pool2d(tp.to_tensor(x), **kw).numpy()
    av = tp.nn.functional.avg_pool2d(tp.to_tensor(x), **kw).numpy()
    assert mx.shape == av.shape == (1, 1, 4, 4)
    assert np.isneginf(mx[0, 0, 3]).all() and np.isneginf(mx[0, 0, :, 3]).all()
    assert np.isnan(av[0, 0, 3]).all() and np.isnan(av[0, 0, :, 3]).all()
    assert np.isfinite(mx[0, 0, :3, :3]).all()
    assert list(torch.nn.functional.max_pool2d(
        torch.tensor(x), 2, 2, 1, ceil_mode=True).shape) == [1, 1, 3, 3]
    for name in ("max_pool2d", "avg_pool2d"):
        run_case(name, [x], kw, grad=[], module=FN)


def test_max_pool_mask_indexes_the_input_plane():
    """``return_mask``'s int32 indices point into the flattened input
    plane, where the maxima are."""
    x = f(2, 3, 7, 7)
    out, mask = tp.nn.functional.max_pool2d(tp.to_tensor(x), 3, 2, 1,
                                            return_mask=True)
    assert mask.dtype == torch.int32
    flat = x.reshape(2, 3, -1)
    got = np.take_along_axis(flat, mask.numpy().reshape(2, 3, -1), axis=2)
    np.testing.assert_array_equal(got.reshape(out.shape), out.numpy())


# ------------------------------------------------------------------ layers

LAYERS = [
    ("Conv1D", (4, 6, 3), dict(stride=2, padding=1), (2, 4, 9)),
    ("Conv2D", (4, 6, 3), dict(stride=2, padding=1), (2, 4, 9, 9)),
    ("Conv2D", (4, 6, 3), dict(padding=1, groups=2, bias_attr=False),
     (2, 4, 7, 7)),
    ("Conv2D", (4, 6, (3, 1)), dict(padding=(1, 0), data_format="NHWC"),
     (2, 7, 7, 4)),
    ("Conv3D", (2, 3, 3), dict(padding=1), (1, 2, 5, 5, 5)),
    ("Conv1DTranspose", (4, 3, 3), dict(stride=2, padding=1,
                                        output_padding=1), (2, 4, 5)),
    ("Conv2DTranspose", (4, 6, 3), dict(stride=2, padding=1, groups=2),
     (2, 4, 5, 5)),
    ("Conv3DTranspose", (2, 2, 3), dict(stride=2, padding=1),
     (1, 2, 3, 3, 3)),
    ("MaxPool1D", (2,), dict(stride=2), (2, 3, 8)),
    ("MaxPool2D", (3,), dict(stride=2, padding=1), (2, 3, 8, 8)),
    ("MaxPool2D", (2,), dict(stride=2, ceil_mode=True), (2, 3, 7, 7)),
    ("MaxPool3D", (2,), dict(stride=2), (1, 2, 4, 4, 4)),
    ("AvgPool1D", (3,), dict(stride=2, padding=1), (2, 3, 9)),
    ("AvgPool2D", (3,), dict(stride=2, padding=1), (2, 3, 8, 8)),
    ("AvgPool3D", (2,), dict(stride=2), (1, 2, 4, 4, 4)),
    ("AdaptiveAvgPool1D", (3,), {}, (2, 3, 7)),
    ("AdaptiveAvgPool2D", ((1, 1),), {}, (2, 3, 5, 5)),
    ("AdaptiveAvgPool3D", (2,), {}, (1, 2, 4, 5, 4)),
    ("AdaptiveMaxPool1D", (3,), {}, (2, 3, 7)),
    ("AdaptiveMaxPool2D", (2,), {}, (2, 3, 5, 4)),
    ("AdaptiveMaxPool3D", (2,), {}, (1, 2, 4, 4, 4)),
]


@pytest.mark.parametrize("name,args,kwargs,shape", LAYERS,
                         ids=[f"{c[0]}-{k}" for k, c in enumerate(LAYERS)])
def test_layer_carry_output_and_gradients(name, args, kwargs, shape):
    """The layer's state_dict matches the JAX layer's in keys and shapes;
    with that state carried, the same input gives the same output and the
    same gradients for the input and every parameter."""
    j = getattr(jp.nn, name)(*args, **kwargs)
    t = getattr(tp.nn, name)(*args, **kwargs)
    assert {k: list(v.shape) for k, v in t.state_dict().items()} == \
        {k: list(v.shape) for k, v in j.state_dict().items()}
    load_paddle_layer_state(t, j.state_dict())
    x = f(*shape, seed=3)
    jx, tx = jp.to_tensor(x, stop_gradient=False), \
        tp.to_tensor(x, stop_gradient=False)
    jo, to = j(jx), t(tx)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo.numpy()),
                               rtol=1e-4, atol=1e-4)
    ct = f(*list(to.shape), seed=9)
    jg = jp.grad((jo * jp.to_tensor(ct)).sum(), [jx] + list(j.parameters()))
    tg = tp.grad((to * tp.to_tensor(ct)).sum(), [tx] + list(t.parameters()))
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b.numpy()),
                                   rtol=1e-4, atol=1e-4)


def test_conv_parameters_and_padding_mode():
    """A convolution's parameters are Paddle's shapes on the default place;
    ``padding_mode`` is taken and not read (every pad is zeros), as in the
    JAX package."""
    conv = tp.nn.Conv2D(3, 8, 3, padding=1, padding_mode="reflect")
    assert list(conv.weight.shape) == [8, 3, 3, 3]
    assert conv.weight.place == tp.CPUPlace() == conv.bias.place
    plain = tp.nn.Conv2D(3, 8, 3, padding=1)
    load_paddle_layer_state(plain, conv.state_dict())
    x = tp.to_tensor(f(1, 3, 5, 5))
    assert torch.equal(conv(x), plain(x))
    assert list(tp.nn.Conv2DTranspose(4, 6, 3, groups=2).weight.shape) == \
        [4, 3, 3, 3]
