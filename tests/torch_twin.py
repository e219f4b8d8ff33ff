"""A JAX-package test module, translated to the port.

The port's host layers (``ps/``, the kvstore worker and servers, the
numpy codecs, the wire codec's host path) are the JAX package's modules
with the package name changed, so a test file of those layers ports the
same way: :func:`twin` reads ``tests/<name>.py``, replaces every
``geomx_tpu`` module name by ``geomx_tpu_torch`` (imports, string
targets of ``monkeypatch``, the code of subprocesses), points its
imports of sibling test files at their translations, and runs the
result as a module of its own. One framework seam changes with it: the
port's topologies run on the CUDA card unless the caller names the CPU,
so every ``InProcessHiPS(`` of a twin is given ``device="cpu"``.
Nothing of the JAX file changes; line numbers are kept, so a traceback
names the JAX file's line.

:func:`export` puts a twin's tests, fixtures and module mark into the
namespace of a port test file, where pytest collects them as that
file's tests (``prefix`` keeps the names of several twins apart).
"""

import re
import sys
import types
from pathlib import Path

TESTS = Path(__file__).resolve().parent
_PKG = re.compile(r"\bgeomx_tpu\b(?!_torch)")
_TOPO = re.compile(r"\bInProcessHiPS\(")
_SIBLING = re.compile(r"^(\s*)from (?:tests\.)?(test_\w+) import", re.M)


def _twin_name(name: str) -> str:
    return f"_port_twin_{name}"


def twin(name: str, subs=()) -> types.ModuleType:
    """``tests/<name>.py`` run against the port (cached per process).
    ``subs``: ``(old, new)`` text replacements made after the renaming,
    for a name the port does not have (say, a flax adapter); each must
    match, and none may add or remove a line."""
    mod_name = _twin_name(name)
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    path = TESTS / f"{name}.py"
    src = _PKG.sub("geomx_tpu_torch", path.read_text())
    src = _TOPO.sub('InProcessHiPS(device="cpu", ', src)
    for old, new in subs:
        assert old in src and old.count("\n") == new.count("\n"), old
        src = src.replace(old, new)
    for dep in sorted(set(m.group(2) for m in _SIBLING.finditer(src))):
        if _PKG.search((TESTS / f"{dep}.py").read_text()):
            twin(dep)
            src = re.sub(rf"^(\s*)from (?:tests\.)?{dep} import",
                         rf"\1from {_twin_name(dep)} import", src,
                         flags=re.M)
    mod = types.ModuleType(mod_name)
    mod.__file__ = str(path)
    sys.modules[mod_name] = mod
    try:
        exec(compile(src, str(path), "exec"), mod.__dict__)
    except BaseException:
        del sys.modules[mod_name]
        raise
    return mod


def export(namespace: dict, name: str, prefix: str = "",
           only=None, skip=(), subs=()) -> list:
    """Bind ``twin(name, subs)``'s ``test_*`` functions (``only`` those,
    when given, less ``skip``), its fixtures and its ``pytestmark`` into
    ``namespace``; a test keeps its name after ``test_`` + ``prefix``.
    Returns the names bound."""
    mod = twin(name, subs)
    bound = []
    for attr, obj in vars(mod).items():
        if attr.startswith("test_") and callable(obj):
            if (only is not None and attr not in only) or attr in skip:
                continue
            new = "test_" + prefix + attr[len("test_"):]
            assert new not in namespace, f"{new} bound twice"
            namespace[new] = obj
            bound.append(new)
        elif hasattr(obj, "_pytestfixturefunction") or \
                type(obj).__name__ == "FixtureFunctionDefinition":
            namespace.setdefault(attr, obj)
    mark = getattr(mod, "pytestmark", None)
    if mark is not None:
        namespace.setdefault("pytestmark", mark)
    return bound
