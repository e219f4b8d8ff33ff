"""The JAX package's wire and store suites, run against the port.

``tests/test_batch_wire.py``, ``test_sparse_wire.py``,
``test_conformance.py``, ``test_nonloopback.py``,
``test_compression.py``, ``test_kv_factory.py`` and
``test_device_store.py`` run on the port through ``torch_twin`` (the JAX
file with the package name changed; a case keeps its name after
``test_<file>_``). ``test_nonloopback.py``'s 12-process launch keeps
its ``slow`` mark. The framework seams, each a substitution of the same
line count:

- the port's entry points run on the CUDA card unless the caller names
  the CPU, so the "nccl" store and the device trainer are given
  ``device="cpu"``;
- the port's "nccl" store on the CPU is one device (the JAX one lays
  its values over the 8 virtual CPU devices), so its device count is
  held to the port's own (one card, or one CPU device), and its
  device-resident pull is a tensor with a ``device``, not an array with
  a ``sharding``;
- ``test_sparse_wire.py``'s 2^24 index case builds its gradient with
  torch (``index_put_``) where the JAX file uses ``.at[].set``.
"""

from torch_twin import export

for _name in ("batch_wire", "conformance", "nonloopback", "compression"):
    export(globals(), f"test_{_name}", prefix=f"{_name}_")
export(globals(), "test_sparse_wire", prefix="sparse_wire_", subs=[
    ("import jax.numpy as jnp", "import torch as jnp"),
    ("jnp.zeros_like(w).at[spike].set(100.0).at[3].set(-50.0)",
     "jnp.zeros_like(w).index_put_((jnp.tensor([spike, 3]),), "
     "jnp.tensor([100.0, -50.0]))"),
    ("threshold=2 / n, learning_rate=0.1)",
     "threshold=2 / n, learning_rate=0.1, device=\"cpu\")")])
export(globals(), "test_kv_factory", prefix="kv_factory_", subs=[
    ('kvmod.create("nccl")', 'kvmod.create("nccl", device="cpu")')])
export(globals(), "test_device_store", prefix="device_store_", subs=[
    ('gx.kv.create("nccl")', 'gx.kv.create("nccl", device="cpu")'),
    ("    import jax\n", "    import torch\n"),
    ("len(jax.local_devices())", "max(1, torch.cuda.device_count())"),
    ('hasattr(dev_val, "sharding")', 'hasattr(dev_val, "device")')])
