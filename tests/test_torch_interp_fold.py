"""``nn.functional.interpolate`` / ``upsample``, ``unfold`` and ``fold``
and their layers (``Upsample``, ``UpsamplingBilinear2D``,
``UpsamplingNearest2D``, ``Unfold``, ``Fold``) against the JAX package on
the CPU: the same seeded inputs, forward and gradient (a fixed random
projection of the output), within 1e-5 relative / 1e-6 absolute in fp32.

The JAX ``interpolate`` is ``jax.image.resize``, not torch's resize: a
case for every mode, growing and shrinking, in 1-D, 2-D and 3-D, holds the
port to it, and ``test_differs_from_torch_resize`` shows where torch's own
``F.interpolate`` would have missed (antialiasing, Keys' cubic at -0.5,
half-pixel nearest)."""
import numpy as np
import pytest
import torch
import torch.nn.functional as TF

import paddle_tpu as jp
import paddle_tpu_torch as tp
from _torch_op_parity import _on_cpu, f, run_case  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
F_MOD = "nn.functional"

# (mode, input shape, size or None, scale_factor or None, data_format)
RESIZE = [
    ("nearest", (2, 3, 5, 7), (9, 11), None, "NCHW"),
    ("nearest", (2, 3, 9, 8), (4, 3), None, "NCHW"),
    ("nearest", (2, 3, 5), None, 2.5, "NCW"),
    ("nearest", (1, 2, 4, 5, 6), (3, 7, 4), None, "NCDHW"),
    ("bilinear", (2, 3, 5, 7), (9, 11), None, "NCHW"),
    ("bilinear", (2, 3, 12, 9), (5, 4), None, "NCHW"),
    ("bilinear", (2, 5, 7, 3), (10, 4), None, "NHWC"),
    ("bilinear", (2, 3, 6, 6), None, [1.5, 0.5], "NCHW"),
    ("linear", (2, 3, 7), (15,), None, "NCW"),
    ("linear", (2, 3, 16), (5,), None, "NCW"),
    ("linear", (2, 9, 3), (4,), None, "NWC"),
    ("trilinear", (1, 2, 4, 5, 6), (7, 3, 9), None, "NCDHW"),
    ("trilinear", (1, 4, 5, 6, 2), (2, 8, 3), None, "NDHWC"),
    ("bicubic", (2, 3, 5, 7), (9, 13), None, "NCHW"),
    ("bicubic", (2, 3, 13, 11), (4, 6), None, "NCHW"),
    ("bicubic", (2, 3, 8, 8), None, 2, "NCHW"),
    ("area", (2, 3, 8, 10), (4, 5), None, "NCHW"),
    ("area", (2, 3, 4, 5), (6, 10), None, "NCHW"),
]


def _id(case):
    mode, shape, size, scale, fmt = case
    return f"{mode}-{'x'.join(map(str, shape))}-{size or scale}-{fmt}"


@pytest.mark.parametrize("case", RESIZE, ids=[_id(c) for c in RESIZE])
@pytest.mark.parametrize("name", ["interpolate", "upsample"])
def test_interpolate_matches_jax(name, case):
    mode, shape, size, scale, fmt = case
    run_case(name, [f(*shape, seed=1)],
             dict(size=size, scale_factor=scale, mode=mode,
                  align_corners=mode in ("bilinear", "bicubic"),
                  data_format=fmt),
             grad=[0], module=F_MOD, rtol=RTOL, atol=ATOL, grad_tol=RTOL)


def test_differs_from_torch_resize():
    """Where torch's resize is not the JAX package's: shrinking linear is
    antialiased (torch's ``antialias=False`` default differs), bicubic is
    Keys at -0.5 (torch's -0.75 differs) and nearest samples half-pixel
    centres (torch's ``"nearest-exact"``, not ``"nearest"``)."""
    raw = torch.from_numpy(f(1, 1, 12, 12, seed=4))

    def gap(ours, size, **kw):
        got = tp.nn.functional.interpolate(raw, size=size, mode=ours)
        return float((got - TF.interpolate(raw, size=size, **kw)).abs().max())
    assert gap("bilinear", (5, 5), mode="bilinear",
               align_corners=False) > 1e-2
    assert gap("bicubic", (17, 17), mode="bicubic",
               align_corners=False) > 1e-3
    assert gap("nearest", (5, 7), mode="nearest") > 1e-2
    assert gap("nearest", (5, 7), mode="nearest-exact") == 0.0


def test_resize_matrices_built_once():
    """A second resize of the same sizes, mode, device and type builds no
    weight matrix: it reuses the first call's, so a steady-state resize
    only contracts; another mode builds its own."""
    from paddle_tpu_torch.nn.functional import common
    x = torch.from_numpy(f(1, 2, 6, 9, seed=5))
    common._resize_matrix.cache_clear()
    first = tp.nn.functional.interpolate(x, size=(4, 12), mode="bicubic")
    built = common._resize_matrix.cache_info().misses
    again = tp.nn.functional.interpolate(x, size=(4, 12), mode="bicubic")
    info = common._resize_matrix.cache_info()
    assert built == 2 and info.misses == 2 and info.hits == 2
    assert torch.equal(first, again)
    tp.nn.functional.interpolate(x, size=(4, 12), mode="bilinear")
    assert common._resize_matrix.cache_info().misses == 4


UNFOLD = [
    dict(kernel_sizes=3),
    dict(kernel_sizes=[2, 3], strides=2, paddings=1),
    dict(kernel_sizes=[3, 2], strides=[1, 2], paddings=[2, 1],
         dilations=[2, 1]),
]


@pytest.mark.parametrize("kw", UNFOLD, ids=["k3", "k23-s2-p1", "dil"])
def test_unfold_matches_jax(kw):
    run_case("unfold", [f(2, 3, 7, 8, seed=2)], kw, grad=[0], module=F_MOD,
             rtol=RTOL, atol=ATOL, grad_tol=RTOL)


def _blocks(out_hw, k, s=1, p=0, d=1, c=3, seed=3):
    k = [k, k] if isinstance(k, int) else k
    s, p, d = ([v, v] if isinstance(v, int) else v for v in (s, p, d))
    n = [(o + 2 * pp - dd * (kk - 1) - 1) // ss + 1
         for o, kk, ss, pp, dd in zip(out_hw, k, s, p, d)]
    return f(2, c * k[0] * k[1], n[0] * n[1], seed=seed)


@pytest.mark.parametrize("kw", UNFOLD, ids=["k3", "k23-s2-p1", "dil"])
def test_fold_matches_jax(kw):
    """``fold`` back to 7 x 8 (overlapping blocks summed)."""
    args = dict(s=kw.get("strides", 1), p=kw.get("paddings", 0),
                d=kw.get("dilations", 1))
    x = _blocks((7, 8), kw["kernel_sizes"], **args)
    run_case("fold", [x], dict(kw, output_sizes=[7, 8]), grad=[0],
             module=F_MOD, rtol=RTOL, atol=ATOL, grad_tol=RTOL)


def test_class_center_sample_raises_as_jax():
    for pkg in (jp, tp):
        with pytest.raises(NotImplementedError):
            pkg.nn.functional.class_center_sample(None, 10, 4)


LAYERS = [
    ("Upsample", dict(size=(7, 9), mode="bilinear"), (2, 3, 4, 5)),
    ("Upsample", dict(scale_factor=0.5, mode="bicubic"), (2, 3, 8, 10)),
    ("UpsamplingBilinear2D", dict(scale_factor=2), (2, 3, 4, 5)),
    ("UpsamplingNearest2D", dict(size=(6, 3)), (2, 3, 4, 5)),
    ("Unfold", dict(kernel_sizes=[2, 3], strides=2, paddings=1),
     (2, 3, 7, 8)),
    ("Fold", dict(output_sizes=[7, 8], kernel_sizes=3), None),
]


@pytest.mark.parametrize("name,kw,shape", LAYERS,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(LAYERS)])
def test_layers_match_jax(name, kw, shape):
    x = _blocks((7, 8), 3) if shape is None else f(*shape, seed=5)
    outs = []
    for pkg in (jp, tp):
        xt = pkg.to_tensor(x, stop_gradient=False)
        y = getattr(pkg.nn, name)(**kw)(xt)
        ct = pkg.to_tensor(f(*y.shape, seed=6))
        (g,) = pkg.grad((y * ct).sum(), [xt])
        outs.append((np.asarray(y.numpy()), np.asarray(g.numpy())))
    (jy, jg), (ty, tg) = outs
    np.testing.assert_allclose(ty, jy, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tg, jg, rtol=RTOL, atol=ATOL)
