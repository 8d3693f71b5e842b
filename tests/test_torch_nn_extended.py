"""``nn.functional.extended`` and ``nn.layers_extended`` of the port
against the JAX package on the CPU: every public name on the same seeded
inputs, forward and gradient (a fixed random projection of the first
output, against the JAX tape).

Tolerances: 1e-5 relative (1e-6 absolute) for the elementwise and
gather-based functions; 1e-4 for the CTC and RNN-T recursions (at most 12
frames) and the attention and decoding paths. ``SpectralNorm``'s forward
and its ``weight_u`` / ``weight_v`` update are held to the JAX layer; its
gradient (which the JAX layer cuts) to an fp64 ``gradcheck``."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from _torch_op_parity import _on_cpu, f, i, run_case  # noqa: F401
from paddle_tpu_torch.convert import load_paddle_layer_state

RTOL, ATOL = 1e-5, 1e-6
REC_TOL = 1e-4
F_MOD = "nn.functional"


def _np(t):
    return np.asarray(t.numpy())


def _u(*shape, seed=0, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _case(name, args, kw=None, grad=(0,), tol=RTOL):
    run_case(name, args, kw or {}, grad=list(grad), module=F_MOD, rtol=tol,
             atol=tol if tol != RTOL else ATOL, grad_tol=tol)


# ------------------------------------------------------------ elementwise

@pytest.mark.parametrize("kw", [{}, {"p": 1.0}, {"p": 3.0, "keepdim": True},
                                {"p": float("inf")}],
                         ids=["p2", "p1", "p3-keep", "pinf"])
def test_pairwise_distance(kw):
    _case("pairwise_distance", [f(5, 6, seed=1), f(5, 6, seed=2)], kw,
          grad=(0, 1))


@pytest.mark.parametrize("kw", [{}, {"offset": 1}, {"offset": -2},
                                {"offset": 1, "dim1": 0, "dim2": 2}],
                         ids=["plain", "up", "down", "dims"])
def test_diag_embed(kw):
    _case("diag_embed", [f(3, 4, seed=1)], kw)


def test_sequence_mask():
    lens = np.array([[3, 0], [5, 2]], np.int64)
    for maxlen in (None, 7):
        got = _np(tp.nn.functional.sequence_mask(tp.to_tensor(lens), maxlen))
        want = _np(jp.nn.functional.sequence_mask(jp.to_tensor(lens), maxlen))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt,shape", [("NCHW", (2, 3, 4, 5)),
                                       ("NHWC", (2, 4, 5, 3))])
def test_zeropad2d(fmt, shape):
    _case("zeropad2d", [f(*shape, seed=1)],
          dict(padding=[1, 2, 0, 3], data_format=fmt))


def _unpool_indices(n, c, n_in, n_out, seed):
    rs = np.random.default_rng(seed)
    return np.stack([np.stack([np.sort(rs.permutation(n_out)[:n_in])
                               for _ in range(c)]) for _ in range(n)])


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_max_unpool(ndim):
    """Unique indices into each plane's flattened output (max pooling's
    kind), default output size from kernel 2, stride 2."""
    spatial = (5, 3, 2)[:ndim] if ndim > 1 else (5,)
    x = f(2, 3, *spatial, seed=1)
    n_in = int(np.prod(spatial))
    n_out = int(np.prod([2 * s for s in spatial]))
    idx = _unpool_indices(2, 3, n_in, n_out, 2).reshape(2, 3, *spatial)
    _case(f"max_unpool{ndim}d", [x, idx.astype(np.int64), 2])


def test_max_unpool_output_size():
    x = f(2, 3, 4, 4, seed=1)
    idx = _unpool_indices(2, 3, 16, 81, 3).reshape(2, 3, 4, 4)
    _case("max_unpool2d", [x, idx.astype(np.int64), 2],
          dict(output_size=[9, 9]))


def test_temporal_shift():
    _case("temporal_shift", [f(6, 8, 3, 3, seed=1)],
          dict(seg_num=3, shift_ratio=0.25))


def test_gather_tree():
    T, B, K = 5, 3, 4
    ids = i(T, B, K, high=20, seed=1)
    parents = i(T, B, K, high=K, seed=2)
    got = _np(tp.nn.functional.gather_tree(tp.to_tensor(ids),
                                           tp.to_tensor(parents)))
    want = _np(jp.nn.functional.gather_tree(jp.to_tensor(ids),
                                            jp.to_tensor(parents)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,kw", [("elu_", {"alpha": 0.7}),
                                     ("softmax_", {"axis": 0}),
                                     ("tanh_", {})])
def test_inplace_activations(name, kw):
    x = f(3, 4, seed=1)
    outs = []
    for pkg in (jp, tp):
        t = pkg.to_tensor(x)
        out = getattr(pkg.nn.functional, name)(t, **kw)
        assert out is t
        outs.append(_np(t))
    np.testing.assert_allclose(outs[1], outs[0], rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------------ losses

def test_dice_loss():
    probs = _u(4, 5, 3, seed=1, lo=0.0)
    _case("dice_loss", [probs, i(4, 5, 1, high=3, seed=2)])


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
def test_hsigmoid_loss(bias):
    C = 6
    args = [f(7, 4, seed=1), i(7, high=C, seed=2), C, f(C - 1, 4, seed=3)]
    if bias:
        args.append(f(C - 1, 1, seed=4))
    _case("hsigmoid_loss", args, grad=(0, 3, 4) if bias else (0, 3))


def test_npair_loss():
    _case("npair_loss", [f(6, 4, seed=1), f(6, 4, seed=2),
                         i(6, high=3, seed=3)], dict(l2_reg=0.01),
          grad=(0, 1))


@pytest.mark.parametrize("kw", [{}, {"return_softmax": True,
                                     "reduction": "sum"},
                                {"margin1": 0.9, "margin2": 0.2,
                                 "margin3": 0.1, "scale": 16.0,
                                 "reduction": None}],
                         ids=["arcface", "softmax-sum", "combined"])
def test_margin_cross_entropy(kw):
    _case("margin_cross_entropy", [_u(5, 7, seed=1, lo=-0.99, hi=0.99),
                                   i(5, high=7, seed=2)], kw)


@pytest.mark.parametrize("kw", [{}, {"swap": True, "margin": 0.5},
                                {"reduction": "none"}],
                         ids=["mean", "swap", "none"])
def test_triplet_margin_with_distance_loss(kw):
    _case("triplet_margin_with_distance_loss",
          [f(6, 5, seed=1), f(6, 5, seed=2), f(6, 5, seed=3)], kw,
          grad=(0, 1, 2))


@pytest.mark.parametrize("kw", [{}, {"p": 2, "margin": 0.5},
                                {"reduction": "sum"}],
                         ids=["p1", "p2", "sum"])
@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weight"])
def test_multi_margin_loss(kw, weighted):
    args = [f(6, 5, seed=1), i(6, high=5, seed=2)]
    kw = dict(kw, weight=_u(5, seed=3, lo=0.5) if weighted else None)
    _case("multi_margin_loss", args, kw)


def _ctc_inputs(repeats=False):
    T, B, V, L = 12, 3, 5, 4
    labels = i(B, L, high=V - 1, seed=2) + 1
    if repeats:
        labels[0, 1] = labels[0, 0]
    return [f(T, B, V, seed=1), labels.astype(np.int64),
            np.array([12, 10, 7], np.int64), np.array([4, 3, 2], np.int64)]


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("repeats", [False, True], ids=["plain", "repeats"])
def test_ctc_loss(reduction, repeats):
    _case("ctc_loss", _ctc_inputs(repeats), dict(reduction=reduction),
          tol=REC_TOL)


def test_ctc_loss_impossible_alignment_is_finite():
    """A label sequence longer than the frames allow: the JAX recursion's
    -1e30 floor gives a huge finite loss (torch's would be inf)."""
    logits, labels, _, lens = _ctc_inputs()
    short = np.array([2, 2, 2], np.int64)
    got = tp.nn.functional.ctc_loss(tp.to_tensor(logits), tp.to_tensor(labels),
                                    tp.to_tensor(short), tp.to_tensor(lens),
                                    reduction="none")
    want = jp.nn.functional.ctc_loss(jp.to_tensor(logits),
                                     jp.to_tensor(labels),
                                     jp.to_tensor(short), jp.to_tensor(lens),
                                     reduction="none")
    assert np.isfinite(_np(got)).all()
    np.testing.assert_allclose(_np(got), _np(want), rtol=REC_TOL)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_rnnt_loss(reduction):
    B, T, U, V = 2, 6, 3, 5
    args = [f(B, T, U + 1, V, seed=1),
            (i(B, U, high=V - 1, seed=2) + 1).astype(np.int64),
            np.array([6, 4], np.int64), np.array([3, 2], np.int64)]
    _case("rnnt_loss", args, dict(reduction=reduction, blank=0),
          tol=REC_TOL)


# -------------------------------------------------------- spatial sampling

@pytest.mark.parametrize("align", [True, False], ids=["align", "half"])
def test_affine_grid(align):
    _case("affine_grid", [f(2, 2, 3, seed=1)],
          dict(out_shape=[2, 3, 5, 6], align_corners=align))


GRID = [(mode, pad, align) for mode in ("bilinear", "nearest")
        for pad in ("zeros", "border", "reflection")
        for align in (True, False)]


@pytest.mark.parametrize("mode,pad,align", GRID,
                         ids=[f"{m}-{p}-{'a' if a else 'h'}"
                              for m, p, a in GRID])
def test_grid_sample(mode, pad, align):
    x = f(2, 3, 5, 6, seed=1)
    grid = _u(2, 4, 7, 2, seed=2, lo=-1.3, hi=1.3)
    _case("grid_sample", [x, grid],
          dict(mode=mode, padding_mode=pad, align_corners=align),
          grad=(0, 1) if mode == "bilinear" else (0,))


def test_sparse_attention():
    B, H, L, D = 1, 2, 8, 4
    rs = np.random.default_rng(7)
    keep = rs.random((B, H, L, L)) < 0.4
    keep[..., np.arange(L), np.arange(L)] = True
    off = np.zeros((B, H, L + 1), np.int64)
    off[..., 1:] = np.cumsum(keep.sum(-1), -1)
    cols = np.zeros((B, H, int(off.max())), np.int64)
    for b in range(B):
        for h in range(H):
            c = np.nonzero(keep[b, h])[1]
            cols[b, h, :len(c)] = c
    _case("sparse_attention", [f(B, H, L, D, seed=1), f(B, H, L, D, seed=2),
                               f(B, H, L, D, seed=3), off, cols],
          grad=(0, 1, 2), tol=REC_TOL)


# ------------------------------------------------------------------ layers

def _layer_pair(name, args=(), kw=None):
    kw = kw or {}
    j = getattr(jp.nn, name)(*args, **kw)
    t = getattr(tp.nn, name)(*args, **kw)
    js = {k: _np(v) for k, v in j.state_dict().items()}
    assert list(js) == list(t.state_dict())
    load_paddle_layer_state(t, js)
    return j, t


def _layer_case(name, args, kw, inputs, grad=(0,), tol=RTOL):
    j, t = _layer_pair(name, args, kw)
    outs = []
    for pkg, layer in ((jp, j), (tp, t)):
        xs = [pkg.to_tensor(a, stop_gradient=k not in grad)
              for k, a in enumerate(inputs)]
        y = layer(*xs)
        ct = pkg.to_tensor(f(*y.shape, seed=9)) if y.shape else 1.0
        gs = pkg.grad((y * ct).sum(), [xs[k] for k in grad] +
                      list(layer.parameters()))
        outs.append([_np(y)] + [_np(g) for g in gs])
    for a, b in zip(outs[1], outs[0]):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


LAYERS = [
    ("PairwiseDistance", (), {"p": 1.0}, [f(4, 5, seed=1), f(4, 5, seed=2)],
     (0, 1), RTOL),
    ("Softmax2D", (), {}, [f(2, 3, 4, 5, seed=1)], (0,), RTOL),
    ("CTCLoss", (), {"reduction": "sum"}, _ctc_inputs(), (0,), REC_TOL),
    ("RNNTLoss", (), {}, [f(2, 5, 3, 4, seed=1),
                          np.array([[1, 2], [3, 1]], np.int64),
                          np.array([5, 3], np.int64),
                          np.array([2, 1], np.int64)], (0,), REC_TOL),
    ("HSigmoidLoss", (4, 6), {}, [f(7, 4, seed=1), i(7, high=6, seed=2)],
     (0,), RTOL),
    ("MaxUnPool2D", (2,), {}, [f(2, 3, 2, 3, seed=1),
                               _unpool_indices(2, 3, 6, 24, 2).reshape(
                                   2, 3, 2, 3).astype(np.int64)], (0,), RTOL),
    ("MultiMarginLoss", (), {"p": 2}, [f(6, 5, seed=1), i(6, high=5, seed=2)],
     (0,), RTOL),
    ("TripletMarginWithDistanceLoss", (), {"swap": True},
     [f(6, 5, seed=1), f(6, 5, seed=2), f(6, 5, seed=3)], (0, 1, 2), RTOL),
]


@pytest.mark.parametrize("name,args,kw,inputs,grad,tol", LAYERS,
                         ids=[c[0] for c in LAYERS])
def test_layers_match_jax(name, args, kw, inputs, grad, tol):
    _layer_case(name, args, kw, inputs, grad, tol)


@pytest.mark.parametrize("dim,iters", [(0, 1), (1, 3)])
def test_spectral_norm_forward_and_state(dim, iters):
    """Two calls: each output and the ``weight_u`` / ``weight_v`` the JAX
    layer leaves behind, within 1e-5."""
    shape = (4, 6, 3)
    j, t = _layer_pair("SpectralNorm", (shape,), dict(dim=dim,
                                                       power_iters=iters))
    for call in range(2):
        w = f(*shape, seed=call)
        jo, to = j(jp.to_tensor(w)), t(tp.to_tensor(w))
        np.testing.assert_allclose(_np(to), _np(jo), rtol=RTOL, atol=ATOL)
        for name in ("weight_u", "weight_v"):
            np.testing.assert_allclose(_np(getattr(t, name)),
                                       _np(getattr(j, name)), rtol=RTOL,
                                       atol=ATOL)


def test_spectral_norm_gradient_is_autograds():
    """The port keeps the gradient through sigma and the power iteration
    (the JAX layer detaches its output): ``gradcheck`` in fp64 from fixed
    ``weight_u`` / ``weight_v``."""
    layer = tp.nn.SpectralNorm((3, 4), dim=1, power_iters=2,
                               dtype="float64")
    u0, v0 = layer.weight_u.detach().clone(), layer.weight_v.detach().clone()

    def fn(w):
        with torch.no_grad():
            layer.weight_u.copy_(u0)
            layer.weight_v.copy_(v0)
        return layer(w).as_subclass(torch.Tensor)
    w = torch.from_numpy(f(3, 4, seed=3).astype(np.float64)).requires_grad_()
    assert torch.autograd.gradcheck(fn, (w,), eps=1e-6, atol=1e-7)


def test_dynamic_decode_matches_jax():
    """Beam search over a carried ``GRUCell`` with an embedding and an
    output projection: the same ids and scores (1e-4) as the JAX
    decoder."""
    V, E, H, B, K = 7, 4, 5, 3, 3
    jc, tc = _layer_pair("GRUCell", (E, H))
    je, te = _layer_pair("Embedding", (V, E))
    jl, tl = _layer_pair("Linear", (H, V))
    got = []
    for pkg, cell, emb, lin in ((jp, jc, je, jl), (tp, tc, te, tl)):
        dec = pkg.nn.BeamSearchDecoder(cell, start_token=0, end_token=1,
                                       beam_size=K, embedding_fn=emb,
                                       output_fn=lin)
        ids, scores = pkg.nn.dynamic_decode(
            dec, inits=pkg.to_tensor(f(B, H, seed=4)), max_step_num=6)
        got.append((_np(ids), _np(scores)))
    np.testing.assert_array_equal(got[1][0], got[0][0])
    np.testing.assert_allclose(got[1][1], got[0][1], rtol=REC_TOL)
