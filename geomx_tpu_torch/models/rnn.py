"""Recurrent layers: LSTM / GRU / vanilla RNN as torch modules.

Counterpart of ``geomx_tpu/models/rnn.py`` (reference: src/operator/
rnn.cc + python/mxnet/gluon/rnn). The flax module scans flax's cells
(``OptimizedLSTMCell``, ``GRUCell``, ``SimpleCell``) over time; here each
layer keeps the cell's per-gate denses under their flax names (``ii``,
``hf``, ``hn``, ...) and runs the recurrence as one fused
``torch.lstm`` / ``torch.gru`` / ``torch.rnn_tanh`` call over the
sequence (cuDNN on the card), with the gates stacked in torch's order:

- LSTM: gates i, f, g, o in both. flax's input denses have no bias and
  its hidden denses have one; torch adds an input-side and a
  hidden-side bias, so the input side's is zero.
- GRU: gates r, z, n in both; flax gives every input dense a bias and
  of the hidden denses only ``hn``, so the hidden-side r and z biases
  are zero.
- Simple: ``tanh(W_i x + b_i + W_h h)``, the hidden-side bias zero.

The carry starts at zero, as ``nn.RNN`` starts it, and the recurrence
runs in fp32 whatever the parameters' dtype, as in the JAX module.
``RNNModel`` is the small recurrent language model of ``get_model``'s
``lstm_lm``, ``gru_lm`` and ``rnn_lm``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from geomx_tpu_torch.models.layers import Dense, Embed

__all__ = ["RNNLayer", "RNNModel"]

# cell class (the flax module name) -> (input-side gates with a bias?,
# gate names in torch's order, hidden-side gates that carry a bias)
_CELLS = {
    "lstm": ("OptimizedLSTMCell", False, "ifgo", "ifgo"),
    "gru": ("GRUCell", True, "rzn", "n"),
    "rnn": ("SimpleCell", True, "", ""),
}
_FUSED = {"lstm": torch.lstm, "gru": torch.gru, "rnn": torch.rnn_tanh}


class _Cell(nn.Module):
    """A flax cell's denses (``i<gate>`` input side, ``h<gate>`` hidden
    side; the simple cell's are ``i`` and ``h``)."""

    def __init__(self, in_features: int, hidden: int, cell_type: str,
                 generator: Optional[torch.Generator]):
        super().__init__()
        _name, in_bias, gates, h_bias = _CELLS[cell_type]
        self.gates = gates or [""]
        self.h_bias = h_bias
        for g in self.gates:
            self.add_module("i" + g, Dense(in_features, hidden, in_bias,
                                           generator))
        for g in self.gates:
            h = Dense(hidden, hidden, bool(g) and g in h_bias, generator)
            with torch.no_grad():       # flax: orthogonal recurrent init
                nn.init.orthogonal_(h.weight, generator=generator)
            self.add_module("h" + g, h)

    def fused_params(self):
        """``[w_ih, w_hh, b_ih, b_hh]`` in torch's gate order."""
        i = [getattr(self, "i" + g) for g in self.gates]
        h = [getattr(self, "h" + g) for g in self.gates]
        w_ih = torch.cat([d.weight for d in i])
        w_hh = torch.cat([d.weight for d in h])

        def bias(d):
            return d.bias if d.bias is not None else \
                torch.zeros(d.weight.shape[0], dtype=d.weight.dtype,
                            device=d.weight.device)

        return [w_ih, w_hh, torch.cat([bias(d) for d in i]),
                torch.cat([bias(d) for d in h])]


class RNNLayer(nn.Module):
    """One recurrent layer over time: [B, T, F] -> [B, T, H]."""

    def __init__(self, in_features: int, hidden: int,
                 cell_type: str = "lstm",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cell_type not in _CELLS:
            raise ValueError(f"cell_type must be one of {sorted(_CELLS)}")
        self.cell_type = cell_type
        self.hidden = hidden
        self.cell_name = _CELLS[cell_type][0] + "_0"
        self.add_module(self.cell_name, _Cell(in_features, hidden,
                                              cell_type, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        x = x.float()
        params = [p.float() for p in
                  getattr(self, self.cell_name).fused_params()]
        h0 = torch.zeros(1, x.shape[0], self.hidden, device=x.device)
        hx = (h0, torch.zeros_like(h0)) if self.cell_type == "lstm" else h0
        out = _FUSED[self.cell_type](x, hx, params, True, 1, 0.0,
                                     self.training, False, True)[0]
        return out.to(dt)


class RNNModel(nn.Module):
    """Recurrent LM: embed -> N recurrent layers -> vocab head."""

    def __init__(self, vocab: int = 256, hidden: int = 128, depth: int = 1,
                 cell_type: str = "lstm",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embed = Embed(vocab, hidden, generator)
        for i in range(depth):
            self.add_module(f"layer{i}", RNNLayer(hidden, hidden,
                                                  cell_type, generator))
        self.depth = depth
        self.head = Dense(hidden, vocab, generator=generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """``tokens``: ``[B, T]`` ints; returns fp32 ``[B, T, vocab]``."""
        x = self.embed(tokens.long())
        for i in range(self.depth):
            x = getattr(self, f"layer{i}")(x)
        return self.head(x).float()
