"""geomx_tpu_torch.io — datasets, iterators, RecordIO and the image
pipeline (counterpart of ``geomx_tpu/io``)."""

from geomx_tpu_torch.io.datasets import (  # noqa: F401
    DataIter, load_data, synthetic_mnist)
from geomx_tpu_torch.io.iterators import (  # noqa: F401
    CSVIter, LibSVMIter, NDArrayIter, PrefetchIter)
from geomx_tpu_torch.io.recordio import (  # noqa: F401
    ImageRecordIter, IRHeader, MXRecordIO, pack, pack_array, unpack,
    unpack_array)
from geomx_tpu_torch.io.image import (  # noqa: F401
    ImageAugmenter, imdecode, imencode, pack_img, unpack_img)
