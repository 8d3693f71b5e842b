"""The port's transformer layers (``paddle_tpu_torch.nn.layers_transformer``)
against the JAX package after ``convert.load_paddle_layer_state``:
``TransformerEncoder`` (2 layers, d 64, 4 heads, dropout 0) with and
without ``src_mask`` and ``Transformer`` encoder-decoder, outputs and
gradients within 1e-4; ``MultiHeadAttention`` with each cache type,
token for token; and a 3-step AdamW trajectory of the small stack
(embedding, encoder, LayerNorm, head, cross entropy), losses within
1e-4."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.convert import load_paddle_layer_state
from paddle_tpu_torch.core import device as tp_device

TOL = 1e-4
D, H, FFN = 64, 4, 128


@pytest.fixture(autouse=True)
def _on_cpu():
    saved = tp_device._default[0]
    tp.set_device("cpu")
    yield
    tp_device._default[0] = saved


def f(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a.numpy()), np.asarray(b.numpy()),
                               rtol=tol, atol=tol)


def _encoders(layers=2):
    j = jp.nn.TransformerEncoder(jp.nn.TransformerEncoderLayer(
        D, H, FFN, dropout=0.0, activation="gelu"), layers)
    t = tp.nn.TransformerEncoder(tp.nn.TransformerEncoderLayer(
        D, H, FFN, dropout=0.0, activation="gelu"), layers)
    load_paddle_layer_state(t, j.state_dict())
    return j, t


def _grads_close(jo, to, jins, tins):
    ct = f(*list(to.shape), seed=7)
    jg = jp.grad((jo * jp.to_tensor(ct)).sum(), jins)
    tg = tp.grad((to * tp.to_tensor(ct)).sum(), tins)
    for a, b in zip(tg, jg):
        _close(a, b)


@pytest.mark.parametrize("mask", [None, "bool", "additive"])
def test_encoder_outputs_and_gradients(mask):
    """No mask (the flash route on the card, the softmax chain here, as in
    the JAX package on the CPU), a bool padding mask and an additive
    mask: the same output and gradients for the input and every
    parameter."""
    j, t = _encoders()
    x = f(2, 16, D)
    jx, tx = jp.to_tensor(x, stop_gradient=False), \
        tp.to_tensor(x, stop_gradient=False)
    jm = tm = None
    if mask == "bool":
        keep = np.ones((2, 1, 1, 16), bool)
        keep[1, ..., 12:] = False
        jm, tm = jp.to_tensor(keep), tp.to_tensor(keep)
    elif mask == "additive":
        add = np.triu(np.full((16, 16), -1e9, np.float32), 1)
        jm, tm = jp.to_tensor(add), tp.to_tensor(add)
    jo, to = j(jx, jm), t(tx, tm)
    assert type(to) is tp.Tensor
    _close(to, jo)
    _grads_close(jo, to, [jx] + list(j.parameters()),
                 [tx] + list(t.parameters()))


def test_encoder_layer_pre_norm_and_relu():
    j = jp.nn.TransformerEncoderLayer(D, H, FFN, dropout=0.0,
                                      normalize_before=True)
    t = tp.nn.TransformerEncoderLayer(D, H, FFN, dropout=0.0,
                                      normalize_before=True)
    load_paddle_layer_state(t, j.state_dict())
    x = f(2, 8, D)
    _close(t(tp.to_tensor(x)), j(jp.to_tensor(x)))


def test_transformer_encoder_decoder():
    """``Transformer`` with a causal target mask: outputs and gradients."""
    kw = dict(d_model=D, nhead=H, num_encoder_layers=2, num_decoder_layers=2,
              dim_feedforward=FFN, dropout=0.0)
    j, t = jp.nn.Transformer(**kw), tp.nn.Transformer(**kw)
    load_paddle_layer_state(t, j.state_dict())
    src, tgt = f(2, 12, D), f(2, 7, D, seed=1)
    jm = j.generate_square_subsequent_mask(7)
    tm = t.generate_square_subsequent_mask(7)
    _close(tm, jm)
    js, jt = (jp.to_tensor(a, stop_gradient=False) for a in (src, tgt))
    ts, tt = (tp.to_tensor(a, stop_gradient=False) for a in (src, tgt))
    jo = j(js, jt, tgt_mask=jm)
    to = t(ts, tt, tgt_mask=tm)
    _close(to, jo)
    _grads_close(jo, to, [js, jt] + list(j.parameters()),
                 [ts, tt] + list(t.parameters()))


def _mha_pair():
    j = jp.nn.MultiHeadAttention(D, H)
    t = tp.nn.MultiHeadAttention(D, H)
    load_paddle_layer_state(t, j.state_dict())
    return j, t


def test_mha_incremental_cache():
    """The concat ``Cache``: one token at a time, each step's output and
    the grown cache equal the JAX layer's."""
    j, t = _mha_pair()
    x = f(2, 5, D)
    jc = j.gen_cache(jp.to_tensor(x))
    tc = t.gen_cache(tp.to_tensor(x))
    for s in range(5):
        jo, jc = j(jp.to_tensor(x[:, s:s + 1]), cache=jc)
        to, tc = t(tp.to_tensor(x[:, s:s + 1]), cache=tc)
        _close(to, jo)
        _close(tc.k, jc.k)
    assert list(tc.v.shape) == [2, 5, H, D // H]


def test_mha_static_cache():
    """The ``StaticCache``: keys and values projected once from a memory,
    then attended by queries."""
    j, t = _mha_pair()
    mem, q = f(2, 6, D), f(2, 3, D, seed=1)
    jc = j.gen_cache(jp.to_tensor(mem), type=jp.nn.MultiHeadAttention
                     .StaticCache)
    tc = t.gen_cache(tp.to_tensor(mem), type=tp.nn.MultiHeadAttention
                     .StaticCache)
    _close(tc.k, jc.k)
    jo = j(jp.to_tensor(q), jp.to_tensor(mem), jp.to_tensor(mem), None, jc)
    to = t(tp.to_tensor(q), tp.to_tensor(mem), tp.to_tensor(mem), None, tc)
    _close(to, jo)


def test_mha_static_decode_cache():
    """The ``StaticDecodeCache``: a prompt chunk then single tokens written
    at the cursor of fixed buffers, token for token the JAX layer's."""
    j, t = _mha_pair()
    x = f(1, 7, D)
    jc = j.gen_cache(jp.to_tensor(x), type=jp.nn.MultiHeadAttention
                     .StaticDecodeCache, max_length=8)
    tc = t.gen_cache(tp.to_tensor(x), type=tp.nn.MultiHeadAttention
                     .StaticDecodeCache, max_length=8)
    for lo, hi in ((0, 4), (4, 5), (5, 6), (6, 7)):
        jo, jc = j(jp.to_tensor(x[:, lo:hi]), cache=jc)
        to, tc = t(tp.to_tensor(x[:, lo:hi]), cache=tc)
        _close(to, jo)
        assert int(tc.pos) == int(jc.pos) == hi
    _close(tc.k, jc.k)


def _stack(pkg, vocab=50):
    nn = pkg.nn

    class Stack(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(vocab, D)
            self.encoder = nn.TransformerEncoder(nn.TransformerEncoderLayer(
                D, H, FFN, dropout=0.0, activation="gelu"), 2)
            self.norm = nn.LayerNorm(D)
            self.head = nn.Linear(D, vocab)

        def forward(self, ids, labels):
            logits = self.head(self.norm(self.encoder(self.embed(ids))))
            return nn.functional.cross_entropy(logits, labels)
    return Stack()


def test_adamw_trajectory_of_the_stack():
    """Three eager ``loss.backward(); opt.step(); opt.clear_grad()`` steps
    of the small stack from the JAX model's weights: each loss within
    1e-4 of the JAX package's."""
    j, t = _stack(jp), _stack(tp)
    load_paddle_layer_state(t, j.state_dict())
    rng = np.random.default_rng(5)
    ids, labels = rng.integers(0, 50, (2, 16)), rng.integers(0, 50, (2, 16))
    jo = jp.optimizer.AdamW(learning_rate=1e-3, parameters=j.parameters())
    to = tp.optimizer.AdamW(learning_rate=1e-3, parameters=t.parameters())
    jl, tl = [], []
    for _ in range(3):
        loss = j(jp.to_tensor(ids), jp.to_tensor(labels))
        loss.backward()
        jo.step()
        jo.clear_grad()
        jl.append(float(loss))
        loss = t(tp.to_tensor(ids), tp.to_tensor(labels))
        loss.backward()
        to.step()
        to.clear_grad()
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    assert tl[2] < tl[0]


def test_stack_trains_under_train_step():
    """The Paddle-API stack goes unchanged into the port's ``TrainStep``
    (the captured step's staged path, eager here on the CPU) and
    ``AdamW``: the same losses as the eager loop, one program."""
    rng = np.random.default_rng(6)
    ids, labels = rng.integers(0, 50, (2, 16)), rng.integers(0, 50, (2, 16))
    tp.seed(1)
    a = _stack(tp)
    tp.seed(1)
    b = _stack(tp)
    oa = tp.optimizer.AdamW(learning_rate=1e-3, parameters=a.parameters())
    ob = tp.optimizer.AdamW(learning_rate=1e-3, parameters=b.parameters())
    step = tp.TrainStep(b, ob)
    ti, tl = tp.to_tensor(ids), tp.to_tensor(labels)
    eager, staged = [], []
    for _ in range(3):
        loss = a(ti, tl)
        loss.backward()
        oa.step()
        oa.clear_grad()
        eager.append(float(loss))
        staged.append(float(step(ti, tl)))
    np.testing.assert_allclose(staged, eager, rtol=1e-6, atol=1e-6)
    assert step.num_compiles == 1
    for p, q in zip(a.parameters(), b.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-6)
