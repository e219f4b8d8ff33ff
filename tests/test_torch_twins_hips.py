"""The JAX package's HiPS core suites, run against the port.

``tests/test_hips.py`` (the two-tier topology: FSA rounds, the global
optimizer, the party aggregate), ``test_membership.py`` (elastic
membership epochs), ``test_multi_precision.py`` and
``test_server_protocol.py`` (the server's request paths, no sockets)
run on the port's ``kvstore``, ``ps`` and ``simulate`` through
``torch_twin`` (the JAX file with the package name changed; a case
keeps its name after ``test_<file>_``). Nothing is left out and nothing
is substituted.
"""

from torch_twin import export

for _name in ("hips", "membership", "multi_precision", "server_protocol"):
    export(globals(), f"test_{_name}", prefix=f"{_name}_")
