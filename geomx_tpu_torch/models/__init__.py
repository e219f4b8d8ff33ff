"""geomx_tpu_torch.models — the port's model zoo (so far the transformer)."""

from geomx_tpu_torch.models.transformer import (  # noqa: F401
    Block, Transformer, dense_attention, make_attention)
