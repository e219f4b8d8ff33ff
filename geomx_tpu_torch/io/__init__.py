"""geomx_tpu_torch.io — datasets and iterators (so far MNIST-family)."""

from geomx_tpu_torch.io.datasets import (  # noqa: F401
    DataIter, load_data, synthetic_mnist)
