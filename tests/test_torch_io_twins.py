"""The JAX package's host-layer test files, run against the port.

``tests/test_iterators.py``, ``test_image_pipeline.py``,
``test_row_sparse.py``, ``test_io.py``, the metric cases of
``test_checkpoint_metric.py`` and ``test_initializer.py`` run on the
port's ``io`` (iterators, RecordIO, the image pipeline, datasets),
``kvstore.local`` row-sparse push and pull (and the HiPS topology's),
``metric`` and ``initializer`` through ``torch_twin`` (the JAX file with
the package name changed). Left out, each with its port counterpart:

- ``test_image_pipeline.py::test_cifar_records_train_zoo_model`` (slow:
  it trains through the JAX example's flax step) —
  ``tests/test_torch_records.py``;
- ``test_initializer.py::test_as_flax_adapter`` (flax) — the port's
  ``as_torch`` is held against ``as_flax`` in ``tests/test_torch_records.py``;
- the checkpoint and trainer cases of ``test_checkpoint_metric.py``,
  ported in earlier slices' files.
"""

from torch_twin import export

export(globals(), "test_iterators", prefix="iterators_")
export(globals(), "test_image_pipeline", prefix="image_",
       skip=["test_cifar_records_train_zoo_model"])
export(globals(), "test_row_sparse", prefix="row_sparse_")
export(globals(), "test_io", prefix="io_")
export(globals(), "test_checkpoint_metric", prefix="metric_", only=[
    "test_accuracy_and_topk", "test_f1_and_regression_metrics",
    "test_cross_entropy_perplexity_composite"])
export(globals(), "test_initializer", prefix="initializer_",
       skip=["test_as_flax_adapter"],
       subs=[("Xavier, Zero, as_flax, create,", "Xavier, Zero, create,")])
