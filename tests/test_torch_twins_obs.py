"""The JAX package's observability and lock suites, run against the
port: ``tests/test_telemetry.py`` (counters, WAN bytes, the metrics
command over a live topology), ``test_profiler.py`` (spans and the
chrome-trace dump), ``test_trace_merge.py`` and ``test_locks.py`` (the
lock witness), through ``torch_twin`` (the JAX file with the package
name changed; a case keeps its name after ``test_<file>_``). Nothing is
left out or substituted.

``test_trace_merge.py`` imports the repository's ``tools/trace_merge.py``
unchanged, so its two-party case shows that the tool merges the port's
profiler dumps: one HiPS round of port processes, visible end to end.
"""

from torch_twin import export

for _name in ("telemetry", "profiler", "trace_merge", "locks"):
    export(globals(), f"test_{_name}", prefix=f"{_name}_")
