"""Simple MLP (parity with gluon Dense stacks used across the reference
examples; also the cheapest end-to-end smoke model).

Counterpart of ``geomx_tpu/models/mlp.py``. The layers keep flax's names
and layouts (``Dense_<i>.kernel`` ``[in, out]``, ``Dense_<i>.bias``), so
:mod:`geomx_tpu_torch.models.convert` moves a flax leaf list in and out
unchanged. flax infers the input width at init; here it is
``in_features``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from geomx_tpu_torch.models.transformer import Dense


class MLP(nn.Module):
    def __init__(self, in_features: int,
                 features: Sequence[int] = (256, 128, 10),
                 compute_dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.n_layers = len(features)
        widths = [int(in_features), *map(int, features)]
        for i in range(self.n_layers):
            setattr(self, f"Dense_{i}", Dense(widths[i], widths[i + 1],
                                              compute_dtype, generator))

    def forward(self, x):
        x = x.reshape(x.shape[0], -1).to(self.compute_dtype)
        for i in range(self.n_layers - 1):
            x = torch.relu(getattr(self, f"Dense_{i}")(x))
        x = getattr(self, f"Dense_{self.n_layers - 1}")(x)
        return x.to(torch.float32)
