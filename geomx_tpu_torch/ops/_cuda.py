"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface. It is
compiled for Hopper (``sm_90a``) into a shared library under
``geomx_tpu_torch/_build/`` at first use, and again whenever the source,
a ``csrc/*.cuh`` header or the flags change (the file name carries their
hash). Nothing here runs at import: the CPU tests import every module,
and there is no nvcc on a machine without the CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, List

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "geomx_tpu_torch are built from source at first use")
    return found


def _target(name: str) -> Path:
    # the headers of csrc/ count as source: editing one rebuilds
    src = b"".join(f.read_bytes() for f in [SRC_DIR / f"{name}.cu",
                                            *sorted(SRC_DIR.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library is current; returns
    (target, temp output, process) or None."""
    so = _target(name)
    if so.exists():
        return None
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(SRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return so, tmp, proc


def _finish(name: str, job) -> str:
    so, tmp, proc = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    # rename is atomic: a concurrent build of the same source wins or
    # loses the race with an identical file
    os.replace(tmp, so)
    so.with_suffix(".log").write_text(out)
    return out


def _build(names: Iterable[str]) -> List[str]:
    jobs = [(n, _start(n)) for n in names]
    outs, errors = [], []
    for n, job in jobs:      # wait for every nvcc, even after a failure
        if job is None:
            continue
        try:
            outs.append(_finish(n, job))
        except RuntimeError as err:
            errors.append(str(err))
    if errors:
        raise RuntimeError("\n".join(errors))
    return outs


def build(names: Iterable[str]) -> List[str]:
    """Build every named source that is not current, all nvcc processes
    started together; returns the compiler output of each build."""
    with _LOCK:
        return _build(names)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    with _LOCK:
        if name not in _LIBS:
            _build([name])
            _LIBS[name] = ctypes.CDLL(str(_target(name)))
        return _LIBS[name]


def count_launch(counts: dict, name: str) -> None:
    """Add one launch of ``name`` to a wrapper's ``LAUNCHES``; locked,
    because the party workers of one process launch from several
    threads and ``+=`` on a dict entry is not atomic."""
    with _COUNT_LOCK:
        counts[name] += 1
