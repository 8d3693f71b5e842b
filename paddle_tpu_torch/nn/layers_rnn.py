"""Recurrent layers (counterpart of ``paddle_tpu/nn/layers_rnn.py``):
``SimpleRNNCell``, ``LSTMCell``, ``GRUCell``, the cell wrappers ``RNN``
and ``BiRNN``, and the multi-layer ``SimpleRNN``, ``LSTM`` and ``GRU``.

The cell math is the JAX package's (``_cell_step``): gates in the order
i, f, g, o for the LSTM and r, z, n for the GRU, whose candidate is
``tanh(x W_in^T + b_in + r * (h W_hn^T + b_hn))``. Parameters keep the
JAX names (``weight_ih_l{k}[_reverse]``, ``weight_hh_l{k}``,
``bias_ih_l{k}``, ``bias_hh_l{k}``; a cell's ``weight_ih`` ...) and
shapes (``[gates * hidden, in]``), so a JAX state dict carries across by
name.

The time loop is a Python loop over torch ops and backpropagation
through time is autograd. The input projection of every step (``x
W_ih^T + b_ih``) is one product over the whole sequence, hoisted out of
the loop; the loop runs the recurrent product and the gates. As in the
JAX package, ``dropout`` and ``sequence_length`` are taken and not read
(every step of every sequence runs; no dropout between layers)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ..core.dispatch import register_op
from ..core.tensor import wrap_outputs
from ..ops._helpers import _op
from .initializer import Uniform
from .layer import Layer

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "BiRNN", "SimpleRNN", "LSTM", "GRU"]

_GATES = {"LSTM": 4, "GRU": 3, "RNN": 1}


def _cell_step(mode, xw, h, c, w_hh, b_hh, activation="tanh"):
    """One step from the input projection ``xw = x W_ih^T + b_ih``: the
    new ``(h, c)`` (``c`` passes through unchanged but for the LSTM)."""
    hw = TF.linear(h, w_hh, b_hh)
    if mode == "LSTM":
        i, f, g, o = (xw + hw).chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c_new), c_new
    if mode == "GRU":
        xr, xz, xn = xw.chunk(3, dim=-1)
        hr, hz, hn = hw.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        return (1 - z) * n + z * h, c
    act = torch.tanh if activation == "tanh" else torch.relu
    return act(xw + hw), c


def _rnn_fwd(x, init_h, init_c, *weights, mode="LSTM", num_layers=1,
             bidirectional=False, time_major=False, activation="tanh",
             dropout=0.0):
    """``x`` ``[B, T, D]`` (``[T, B, D]`` if ``time_major``); ``weights``
    per (layer, direction): ``w_ih, w_hh, b_ih, b_hh``; ``init_h`` /
    ``init_c`` ``[num_layers * directions, B, H]``. Returns the last
    layer's outputs and the final ``h`` and ``c`` of every (layer,
    direction)."""
    if not time_major:
        x = x.transpose(0, 1)
    n_dir = 2 if bidirectional else 1
    out, final_h, final_c = x, [], []
    for layer in range(num_layers):
        dir_outs = []
        for d in range(n_dir):
            k = 4 * (layer * n_dir + d)
            w_ih, w_hh, b_ih, b_hh = weights[k:k + 4]
            h, c = init_h[layer * n_dir + d], init_c[layer * n_dir + d]
            xw = TF.linear(out, w_ih, b_ih)         # every step's at once
            ys = [None] * xw.shape[0]
            steps = range(xw.shape[0] - 1, -1, -1) if d == 1 \
                else range(xw.shape[0])
            for t in steps:
                h, c = _cell_step(mode, xw[t], h, c, w_hh, b_hh, activation)
                ys[t] = h
            dir_outs.append(torch.stack(ys))
            final_h.append(h)
            final_c.append(c)
        out = dir_outs[0] if n_dir == 1 else torch.cat(dir_outs, dim=-1)
    if not time_major:
        out = out.transpose(0, 1)
    return out, torch.stack(final_h), torch.stack(final_c)


register_op("rnn", _rnn_fwd)


def _cell_op_fwd(x, h, c, w_ih, w_hh, b_ih, b_hh, mode="LSTM",
                 activation="tanh"):
    return _cell_step(mode, TF.linear(x, w_ih, b_ih), h, c, w_hh, b_hh,
                      activation)


register_op("rnn_cell", _cell_op_fwd)


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """``[batch, hidden]`` of ``init_value`` (fp32 unless ``dtype``,
        as in the JAX package) on ``batch_ref``'s device."""
        from ..core.dtype import convert_dtype
        b = int(batch_ref.shape[batch_dim_idx])
        return wrap_outputs(torch.full(
            (b, self.hidden_size), float(init_value),
            dtype=convert_dtype(dtype or "float32"),
            device=batch_ref.device))

    @property
    def state_shape(self):
        raise NotImplementedError


class _CellCommon(RNNCellBase):
    def __init__(self, input_size, hidden_size, n_gates, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        std = 1.0 / math.sqrt(hidden_size)
        init = Uniform(-std, std)
        self.weight_ih = self.create_parameter(
            [n_gates * hidden_size, input_size], weight_ih_attr,
            default_initializer=init)
        self.weight_hh = self.create_parameter(
            [n_gates * hidden_size, hidden_size], weight_hh_attr,
            default_initializer=init)
        self.bias_ih = self.create_parameter(
            [n_gates * hidden_size], bias_ih_attr, is_bias=True,
            default_initializer=init)
        self.bias_hh = self.create_parameter(
            [n_gates * hidden_size], bias_hh_attr, is_bias=True,
            default_initializer=init)

    def _step(self, x, h, c, mode, activation="tanh"):
        return _op("rnn_cell", x, h, c, self.weight_ih, self.weight_hh,
                   self.bias_ih, self.bias_hh, mode=mode,
                   activation=activation)


class SimpleRNNCell(_CellCommon):
    def __init__(self, input_size, hidden_size, activation="tanh", **kw):
        super().__init__(input_size, hidden_size, 1, **kw)
        self.activation = activation

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h, _ = self._step(inputs, states, states, "RNN", self.activation)
        return h, h

    @property
    def state_shape(self):
        return (self.hidden_size,)


class LSTMCell(_CellCommon):
    def __init__(self, input_size, hidden_size, **kw):
        super().__init__(input_size, hidden_size, 4, **kw)

    def forward(self, inputs, states=None):
        if states is None:
            h0 = self.get_initial_states(inputs)
            c0 = self.get_initial_states(inputs)
        else:
            h0, c0 = states
        h, c = self._step(inputs, h0, c0, "LSTM")
        return h, (h, c)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))


class GRUCell(_CellCommon):
    def __init__(self, input_size, hidden_size, **kw):
        super().__init__(input_size, hidden_size, 3, **kw)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h, _ = self._step(inputs, states, states, "GRU")
        return h, h

    @property
    def state_shape(self):
        return (self.hidden_size,)


class RNN(Layer):
    """A cell run over the time axis (a Python loop calling the cell);
    ``sequence_length`` is taken and not read, as in the JAX package."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        from ..ops import stack
        time_axis = 0 if self.time_major else 1
        steps = inputs.shape[time_axis]
        states = initial_states
        outs = []
        order = range(steps - 1, -1, -1) if self.is_reverse else range(steps)
        for t in order:
            x_t = inputs[t] if self.time_major else inputs[:, t]
            y, states = self.cell(x_t, states)
            outs.append(y)
        if self.is_reverse:
            outs = outs[::-1]
        return stack(outs, axis=time_axis), states


class BiRNN(Layer):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        from ..ops import concat
        s_fw, s_bw = (None, None) if initial_states is None \
            else initial_states
        out_fw, st_fw = self.rnn_fw(inputs, s_fw)
        out_bw, st_bw = self.rnn_bw(inputs, s_bw)
        return concat([out_fw, out_bw], axis=-1), (st_fw, st_bw)


class _RNNBase(Layer):
    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout            # taken and not read (JAX's too)
        self.activation = activation
        self.bidirectional = direction in ("bidirect", "bidirectional")
        self.n_dir = 2 if self.bidirectional else 1
        gates = _GATES[mode] * hidden_size
        init = Uniform(-1.0 / math.sqrt(hidden_size),
                       1.0 / math.sqrt(hidden_size))
        self._flat_names = []
        for layer in range(num_layers):
            for d in range(self.n_dir):
                in_sz = input_size if layer == 0 else hidden_size * self.n_dir
                sfx = f"_l{layer}" + ("_reverse" if d == 1 else "")
                for kind, shape, attr, bias in (
                        ("weight_ih", [gates, in_sz], weight_ih_attr, False),
                        ("weight_hh", [gates, hidden_size], weight_hh_attr,
                         False),
                        ("bias_ih", [gates], bias_ih_attr, True),
                        ("bias_hh", [gates], bias_hh_attr, True)):
                    self.add_parameter(kind + sfx, self.create_parameter(
                        shape, attr, is_bias=bias, default_initializer=init))
                    self._flat_names.append(kind + sfx)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        b = inputs.shape[1 if self.time_major else 0]
        shape = (self.num_layers * self.n_dir, b, self.hidden_size)
        zeros = wrap_outputs(torch.zeros(shape, dtype=inputs.dtype,
                                         device=inputs.device))
        if initial_states is None:
            h0, c0 = zeros, zeros
        elif self.mode == "LSTM":
            h0, c0 = initial_states
        else:
            h0, c0 = initial_states, zeros
        out, fh, fc = _op("rnn", inputs, h0, c0,
                          *(getattr(self, n) for n in self._flat_names),
                          mode=self.mode, num_layers=self.num_layers,
                          bidirectional=self.bidirectional,
                          time_major=self.time_major,
                          activation=self.activation,
                          dropout=float(self.dropout))
        if self.mode == "LSTM":
            return out, (fh, fc)
        return out, fh


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kw):
        super().__init__("RNN", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, activation, **kw)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)
