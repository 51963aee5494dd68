"""The recurrent family built on ``scan`` (the counterpart of
``aesara_tpu/models/rnn.py``): ``ElmanRNN``, ``LSTM`` and ``GRU`` over
``x`` of shape (T, B, n_in), each classifying its last state.  Each
cell's loop is one Scan, run on the card by ``link/torch/scan_dispatch.py``
(its fused gate chain one K1 launch a step); BPTT is the reverse Scan
``Scan.L_op`` builds."""

from __future__ import annotations

import numpy as np

from aesara_tpu_torch.models.base import Model, glorot, zeros
from aesara_tpu_torch.scan.basic import scan
from aesara_tpu_torch.tensor import math as tm
from aesara_tpu_torch.tensor.basic import arange, join, zeros as t_zeros
from aesara_tpu_torch.tensor.special import log_softmax


__all__ = ["ElmanRNN", "LSTM", "GRU"]


class _Recurrent(Model):
    """Common classify-last-state head."""

    def logits(self, x):
        h_last = self.final_state(x)
        return tm.dot(h_last, self.w_out) + self.b_out

    def predict(self, x):
        return tm.argmax(self.logits(x), axis=1)

    def loss(self, x, y):
        logp = log_softmax(self.logits(x), axis=-1)
        return -tm.mean(logp[arange(y.shape[0]), y])

    def _h0(self, x, dim):
        return t_zeros((x.shape[1], dim), dtype=x.dtype)


class ElmanRNN(_Recurrent):
    """h_t = tanh(x_t Wx + h_{t-1} Wh + b);  x: (T, B, n_in)."""

    def __init__(self, n_in: int, n_hidden: int, n_out: int, seed: int = 0):
        super().__init__()
        rng = np.random.default_rng(seed)
        self.wx = self._register(glorot(rng, n_in, n_hidden, "wx"))
        self.wh = self._register(glorot(rng, n_hidden, n_hidden, "wh"))
        self.b = self._register(zeros((n_hidden,), "b"))
        self.w_out = self._register(glorot(rng, n_hidden, n_out, "w_out"))
        self.b_out = self._register(zeros((n_out,), "b_out"))

    def final_state(self, x):
        def step(x_t, h_prev, wx, wh, b):
            return tm.tanh(tm.dot(x_t, wx) + tm.dot(h_prev, wh) + b)

        hs, _ = scan(step, sequences=[x],
                     outputs_info=[self._h0(x, self.wh.get_value().shape[0])],
                     non_sequences=[self.wx, self.wh, self.b])
        return hs[-1]


class LSTM(_Recurrent):
    """Standard LSTM; the gates come from one (n_in+H) x 4H product."""

    def __init__(self, n_in: int, n_hidden: int, n_out: int, seed: int = 0):
        super().__init__()
        rng = np.random.default_rng(seed)
        self.n_hidden = n_hidden
        self.w = self._register(glorot(rng, n_in + n_hidden, 4 * n_hidden, "w_lstm"))
        self.b = self._register(zeros((4 * n_hidden,), "b_lstm"))
        self.w_out = self._register(glorot(rng, n_hidden, n_out, "w_out"))
        self.b_out = self._register(zeros((n_out,), "b_out"))

    def final_state(self, x):
        H = self.n_hidden

        def step(x_t, h_prev, c_prev, w, b):
            gates = tm.dot(join(1, x_t, h_prev), w) + b
            i = tm.sigmoid(gates[:, :H])
            f = tm.sigmoid(gates[:, H:2 * H])
            g = tm.tanh(gates[:, 2 * H:3 * H])
            # built twice, as the JAX package's cell builds it (the merge
            # pass makes one node of the two)
            g = tm.tanh(gates[:, 2 * H:3 * H])
            o = tm.sigmoid(gates[:, 3 * H:])
            c = f * c_prev + i * g
            h = o * tm.tanh(c)
            return h, c

        (hs, cs), _ = scan(step, sequences=[x],
                           outputs_info=[self._h0(x, H), self._h0(x, H)],
                           non_sequences=[self.w, self.b])
        return hs[-1]


class GRU(_Recurrent):
    """Gated recurrent unit (Cho et al. 2014)."""

    def __init__(self, n_in: int, n_hidden: int, n_out: int, seed: int = 0):
        super().__init__()
        rng = np.random.default_rng(seed)
        self.n_hidden = n_hidden
        self.w_rz = self._register(glorot(rng, n_in + n_hidden, 2 * n_hidden, "w_rz"))
        self.b_rz = self._register(zeros((2 * n_hidden,), "b_rz"))
        self.w_h = self._register(glorot(rng, n_in + n_hidden, n_hidden, "w_h"))
        self.b_h = self._register(zeros((n_hidden,), "b_h"))
        self.w_out = self._register(glorot(rng, n_hidden, n_out, "w_out"))
        self.b_out = self._register(zeros((n_out,), "b_out"))

    def final_state(self, x):
        H = self.n_hidden

        def step(x_t, h_prev, w_rz, b_rz, w_h, b_h):
            rz = tm.sigmoid(tm.dot(join(1, x_t, h_prev), w_rz) + b_rz)
            r = rz[:, :H]
            z = rz[:, H:]
            h_tilde = tm.tanh(tm.dot(join(1, x_t, r * h_prev), w_h) + b_h)
            return (1.0 - z) * h_prev + z * h_tilde

        hs, _ = scan(step, sequences=[x],
                     outputs_info=[self._h0(x, H)],
                     non_sequences=[self.w_rz, self.b_rz, self.w_h, self.b_h])
        return hs[-1]
