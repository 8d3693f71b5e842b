"""The recurrent layers (``paddle_tpu_torch.nn.layers_rnn``) against the
JAX package on the CPU: ``SimpleRNN`` (tanh and relu), ``LSTM`` and
``GRU``, one and two layers, forward and bidirectional, batch- and
time-major, with and without initial states; the three cells alone and
under ``RNN`` / ``BiRNN``. The JAX layer's state dict carries across by
name (the keys and shapes must be equal), the same seeded input goes
through both, and the outputs, the final states and the gradients of a
fixed random projection (input, initial states and every weight) agree
within 1e-4 at 7 time steps."""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.convert import load_paddle_layer_state
from paddle_tpu_torch.core import device as tp_device

TOL = 1e-4
B, T, D, H = 3, 7, 4, 5


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


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _leaves(o)]
    return [out]


def _carry(name, args, kw):
    j = getattr(jp.nn, name)(*args, **kw)
    t = getattr(tp.nn, name)(*args, **kw)
    js = {k: _np(v) for k, v in j.state_dict().items()}
    ts = t.state_dict()
    assert list(js) == list(ts)
    assert all(list(js[k].shape) == list(ts[k].shape) for k in js)
    load_paddle_layer_state(t, js)
    return j, t


def _run(j, t, inputs, call):
    """``call(layer, tensors)`` on both packages: outputs and gradients
    (of every output leaf against a seeded projection) w.r.t. the inputs
    and every parameter, within TOL."""
    got = []
    for pkg, layer in ((jp, j), (tp, t)):
        xs = [pkg.to_tensor(a, stop_gradient=False) for a in inputs]
        outs = _leaves(call(layer, xs))
        loss = sum((o * pkg.to_tensor(f(*o.shape, seed=50 + k))).sum()
                   for k, o in enumerate(outs))
        params = list(layer.parameters())
        grads = pkg.grad(loss, xs + params)
        got.append(([_np(o) for o in outs], [_np(g) for g in grads]))
    (jo, jg), (to, tg) = got
    assert len(jo) == len(to)
    for a, b in zip(to, jo):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    for k, (a, b) in enumerate(zip(tg, jg)):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL,
                                   err_msg=f"gradient {k}")


# every (layer, layers, direction, major) for the tanh RNN, the LSTM and
# the GRU, and the relu RNN at 2 bidirectional time-major layers
LAYER_CASES = [(name, {}, n, d, tm)
               for name in ("SimpleRNN", "LSTM", "GRU") for n in (1, 2)
               for d in ("forward", "bidirect") for tm in (False, True)] + [
    ("SimpleRNN", {"activation": "relu"}, 2, "bidirect", True)]


@pytest.mark.parametrize(
    "name,kw,num_layers,direction,time_major", LAYER_CASES,
    ids=[f"{n}{'-relu' if kw else ''}-{k}-{d}-{'tm' if tm else 'bm'}"
         for n, kw, k, d, tm in LAYER_CASES])
def test_layer_matches_jax(name, kw, num_layers, direction, time_major):
    j, t = _carry(name, (D, H), dict(kw, num_layers=num_layers,
                                      direction=direction,
                                      time_major=time_major))
    x = f(T, B, D, seed=1) if time_major else f(B, T, D, seed=1)
    _run(j, t, [x], lambda layer, xs: layer(xs[0]))


@pytest.mark.parametrize("name", ["SimpleRNN", "LSTM", "GRU"])
def test_layer_with_initial_states(name):
    """Initial states given (``(h, c)`` for the LSTM): they get gradients
    too; ``dropout`` and ``sequence_length`` are taken and not read."""
    j, t = _carry(name, (D, H), dict(num_layers=2, direction="bidirect",
                                      dropout=0.5))
    n = 4
    inputs = [f(B, T, D, seed=1), f(n, B, H, seed=2)] + \
        ([f(n, B, H, seed=3)] if name == "LSTM" else [])

    def call(layer, xs):
        states = tuple(xs[1:]) if name == "LSTM" else xs[1]
        return layer(xs[0], states,
                     sequence_length=np.full((B,), 2, np.int64))
    _run(j, t, inputs, call)


CELLS = [("SimpleRNNCell", {}), ("SimpleRNNCell", {"activation": "relu"}),
         ("LSTMCell", {}), ("GRUCell", {})]


@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "given"])
@pytest.mark.parametrize("name,kw", CELLS,
                         ids=["rnn", "rnn-relu", "lstm", "gru"])
def test_cell_matches_jax(name, kw, with_state):
    j, t = _carry(name, (D, H), kw)
    inputs = [f(B, D, seed=1)]
    if with_state:
        inputs += [f(B, H, seed=2)] * (2 if name == "LSTMCell" else 1)

    def call(layer, xs):
        if not with_state:
            return layer(xs[0])
        return layer(xs[0], tuple(xs[1:]) if name == "LSTMCell" else xs[1])
    _run(j, t, inputs, call)


@pytest.mark.parametrize("is_reverse", [False, True], ids=["fw", "rev"])
@pytest.mark.parametrize("name", ["SimpleRNNCell", "LSTMCell", "GRUCell"])
def test_rnn_over_cell(name, is_reverse):
    jc, tc = _carry(name, (D, H), {})
    j, t = jp.nn.RNN(jc, is_reverse), tp.nn.RNN(tc, is_reverse)
    _run(j, t, [f(B, T, D, seed=1)], lambda layer, xs: layer(xs[0]))


@pytest.mark.parametrize("time_major", [False, True], ids=["bm", "tm"])
def test_birnn_over_cells(time_major):
    jf, tf_ = _carry("GRUCell", (D, H), {})
    jb, tb = _carry("LSTMCell", (D, H), {})
    j = jp.nn.BiRNN(jf, jb, time_major)
    t = tp.nn.BiRNN(tf_, tb, time_major)
    x = f(T, B, D, seed=1) if time_major else f(B, T, D, seed=1)
    _run(j, t, [x], lambda layer, xs: layer(xs[0]))


def test_lstm_keys_follow_the_flat_order():
    """Weights carry across by name in the JAX flat order (layer, then
    direction, then w_ih, w_hh, b_ih, b_hh)."""
    t = tp.nn.LSTM(D, H, num_layers=2, direction="bidirect")
    names = [n for n, _ in t.named_parameters()]
    assert names[:5] == ["weight_ih_l0", "weight_hh_l0", "bias_ih_l0",
                         "bias_hh_l0", "weight_ih_l0_reverse"]
    assert len(names) == 16 and names[-1] == "bias_hh_l1_reverse"
    assert tuple(t.weight_ih_l1.shape) == (4 * H, 2 * H)
