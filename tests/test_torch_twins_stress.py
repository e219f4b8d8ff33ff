"""``tests/test_hips_stress.py`` run against the port: many concurrent
keys, big arrays over the bigarray bound, interleaved push and pull
from several workers, repeated rounds on one topology (``torch_twin``:
the JAX file with the package name changed; a case keeps its name
after ``test_hips_stress_``). Nothing is left out or substituted.
"""

from torch_twin import export

export(globals(), "test_hips_stress", prefix="hips_stress_")
