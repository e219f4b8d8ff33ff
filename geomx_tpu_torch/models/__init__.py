"""geomx_tpu_torch.models — the port's model zoo (so far LeNet and the
transformer)."""

from geomx_tpu_torch.models.cnn import LeNetCNN, create_cnn  # noqa: F401
from geomx_tpu_torch.models.transformer import (  # noqa: F401
    Block, Transformer, dense_attention, make_attention)
