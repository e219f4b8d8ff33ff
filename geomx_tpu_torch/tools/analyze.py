"""geomx-lint over the port: ``python -m geomx_tpu_torch.tools.analyze``.

Runs the repo's static analysis (``tools.analyze``, imported, not
copied) over ``geomx_tpu_torch/`` with the port's settings, from the
repo root:

- **concurrency** (GX-L001..L004) and **metrics** (GX-M4xx) as they are;
- **config-drift** (GX-C2xx) against ``geomx_tpu_torch/config.py`` and
  ``geomx_tpu_torch/scripts/*.sh``. A knob counts as documented when
  ``docs/env-var-summary.md`` (the knobs both packages read) or
  ``geomx_tpu_torch/docs/env-vars.md`` (the port's own) lists it; a row
  of the port's file that no port code reads is a GX-C202;
- **protocol** (GX-P3xx): the wire is shared (BINMETA_VERSION 4), so
  the port's ``Meta`` schema must equal ``tools/analyze/binmeta.lock.json``;
- **lockmodel** (GX-L005, GX-L006) and **statemodel** (GX-S502..S504)
  as they are, while GX-L007 and GX-S501 hold the port's extracted lock
  and state models against the committed JAX models,
  ``tools/analyze/locks.lock.json`` and ``state.lock.json``, file by
  file, each port path ``geomx_tpu_torch/<p>`` taken as ``geomx_tpu/<p>``.
  These are the files the port's lock witness (``ps/locks.py``) and
  state sanitizer (``ps/conformance.py``) load, so an equal model is
  what makes their lookup sound. Every difference is a finding naming
  the class and field, or the transition. A deliberate lock change in
  the port gives it a model file of its own; there is no update flag.

The **traced** pass (GX-J1xx: hazards under ``jax.jit`` / ``shard_map``)
does not apply: the port has no jit.

Exit codes are those of ``python -m tools.analyze``: 0 no findings
beyond the baseline (``geomx_tpu_torch/tools/analyze_baseline.json``),
1 new findings, 2 usage error.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from tools.analyze import (PASSES as ROOT_PASSES, Finding, SEV_ERROR,
                           apply_suppressions, load_baseline, load_sources,
                           sort_findings, split_by_baseline)
from tools.analyze.config_drift import (parse_doc_vars, parse_raw_reads,
                                        parse_registrations,
                                        run_config_drift)
from tools.analyze.lockmodel import extract_lock_model, lockmodel_lock_path
from tools.analyze.statemodel import (extract_state_model,
                                      statemodel_lock_path)

PACKAGE = "geomx_tpu_torch"
TWIN_PACKAGE = "geomx_tpu"
ROOT = Path(__file__).resolve().parents[2]
CONFIG_REL = f"{PACKAGE}/config.py"
SCRIPTS_GLOB = f"{PACKAGE}/scripts/*.sh"
SHARED_DOC_REL = "docs/env-var-summary.md"
PORT_DOC_REL = f"{PACKAGE}/docs/env-vars.md"
BASELINE_REL = f"{PACKAGE}/tools/analyze_baseline.json"

PASSES = ("concurrency", "config-drift", "protocol", "metrics", "lockmodel",
          "statemodel")


def twin_path(rel: str) -> str:
    """``geomx_tpu_torch/<p>`` -> ``geomx_tpu/<p>``: the key of a port
    file in the JAX package's frozen models (as ``ps/locks.py``
    ``_twin_path`` looks it up)."""
    head, _, tail = rel.partition("/")
    return f"{TWIN_PACKAGE}/{tail}" if head == PACKAGE else rel


def _port_path(twin: str) -> str:
    head, _, tail = twin.partition("/")
    return f"{PACKAGE}/{tail}" if head == TWIN_PACKAGE else twin


def _differences(frozen, port, path: Tuple = ()
                 ) -> Iterator[Tuple[Tuple, object, object]]:
    """``(path, frozen value, port value)`` at each leaf where two models
    differ; lists compare as sets, item by item (None: absent)."""
    if isinstance(frozen, dict) and isinstance(port, dict):
        for key in sorted(set(frozen) | set(port)):
            yield from _differences(frozen.get(key), port.get(key),
                                    path + (key,))
    elif isinstance(frozen, list) and isinstance(port, list):
        for item in sorted(set(frozen) ^ set(port)):
            yield (path + (item,), item if item in frozen else None,
                   item if item in port else None)
    elif frozen != port:
        yield path, frozen, port


def model_findings(rule: str, model: Dict[str, dict], lock_path: Path,
                   root: Path) -> List[Finding]:
    """``rule`` findings for every difference between the port's
    extracted ``model`` (of the whole package) and the committed JAX
    model at ``lock_path``, under ``twin_path``: a frozen file whose
    twin yields no entry differs in all of it."""
    lock_rel = lock_path.relative_to(root).as_posix()
    try:
        frozen = json.loads(lock_path.read_text(encoding="utf-8"))["files"]
    except (OSError, ValueError, KeyError):
        return [Finding(rule, SEV_ERROR, lock_rel, 0, symbol=lock_rel,
                        detail="lock-unreadable",
                        message=f"{lock_rel} is missing or not a model")]
    port = {twin_path(rel): (rel, entry) for rel, entry in model.items()}
    out: List[Finding] = []
    for twin in sorted(set(frozen) | set(port)):
        rel, entry = port.get(twin, (_port_path(twin), None))
        want = {k: v for k, v in (frozen.get(twin) or {}).items()
                if k != "fingerprint"}
        for path, jax_value, port_value in _differences(want, entry or {}):
            symbol = ".".join(str(p) for p in path[1:]) or twin
            out.append(Finding(
                rule, SEV_ERROR, rel, 0, symbol=symbol,
                detail=f"{jax_value}->{port_value}",
                message=(f"{'/'.join(str(p) for p in path)} is "
                         f"{port_value!r} in {rel} but {jax_value!r} for "
                         f"{twin} in {lock_rel}: the port's model departs "
                         f"from the JAX package's")))
    return out


def _config_drift(sources, root: Path) -> List[Finding]:
    port_doc = parse_doc_vars(root / PORT_DOC_REL)
    out = [f for f in run_config_drift(sources, root, config_rel=CONFIG_REL,
                                       doc_rel=SHARED_DOC_REL,
                                       scripts_glob=SCRIPTS_GLOB)
           if not (f.rule in ("GX-C201", "GX-C204")
                   and f.symbol in port_doc)]
    config = next((s for s in sources if s.rel == CONFIG_REL), None)
    read = set(parse_registrations(config) if config else {})
    read |= {name for _, _, name in parse_raw_reads(sources, CONFIG_REL)}
    for name, line in sorted(port_doc.items()):
        if name not in read:
            out.append(Finding(
                "GX-C202", SEV_ERROR, PORT_DOC_REL, line, symbol=name,
                message=(f"{PORT_DOC_REL} documents {name!r} but no port "
                         f"code reads it — stale doc row")))
    return out


def _lockmodel(sources, root: Path) -> List[Finding]:
    out = [f for f in ROOT_PASSES["lockmodel"](sources, root)
           if f.rule != "GX-L007"]
    return out + model_findings(
        "GX-L007", extract_lock_model(sources), lockmodel_lock_path(root),
        root)


def _statemodel(sources, root: Path) -> List[Finding]:
    out = [f for f in ROOT_PASSES["statemodel"](sources, root)
           if f.rule != "GX-S501"]
    return out + model_findings(
        "GX-S501", extract_state_model(sources), statemodel_lock_path(root),
        root)


_RUNNERS = {
    "concurrency": ROOT_PASSES["concurrency"],
    "config-drift": _config_drift,
    "protocol": ROOT_PASSES["protocol"],
    "metrics": ROOT_PASSES["metrics"],
    "lockmodel": _lockmodel,
    "statemodel": _statemodel,
}


def analyze(root: Path = ROOT,
            passes: Optional[Sequence[str]] = None) -> List[Finding]:
    """Findings over ``root/geomx_tpu_torch`` (suppressions applied,
    sorted), with the models, docs and locks read under ``root``."""
    root = Path(root)
    sources = load_sources([root / PACKAGE], root)
    findings = [Finding("GX-E000", SEV_ERROR, s.rel,
                        s.parse_error.lineno or 0, symbol="<parse>",
                        message=f"syntax error: {s.parse_error.msg}")
                for s in sources if s.parse_error is not None]
    for name in passes or PASSES:
        findings += _RUNNERS[name](sources, root)
    return sort_findings(apply_suppressions(findings, sources))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog=f"python -m {PACKAGE}.tools.analyze",
        description="geomx-lint over the PyTorch port")
    ap.add_argument("--root", default=str(ROOT),
                    help="repo root holding geomx_tpu_torch/, docs/ and "
                         "tools/analyze/ (default: this checkout)")
    ap.add_argument("--passes", default=None,
                    help="comma list from: %s" % ",".join(PASSES))
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, accepted or not")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable findings with fingerprints")
    args = ap.parse_args(argv)
    passes = args.passes.split(",") if args.passes else None
    unknown = set(passes or []) - set(PASSES)
    if unknown:
        print(f"unknown pass(es): {sorted(unknown)}", file=sys.stderr)
        return 2
    root = Path(args.root)
    findings = analyze(root, passes)
    baseline = (set() if args.no_baseline
                else load_baseline(root / BASELINE_REL))
    new, accepted = split_by_baseline(findings, baseline)
    if args.json:
        print(json.dumps({
            "new": [{**vars(f), "fingerprint": f.fingerprint} for f in new],
            "accepted": [{**vars(f), "fingerprint": f.fingerprint}
                         for f in accepted],
        }, indent=1))
    else:
        for f in new:
            print(f.render())
        print(("FAIL: " if new else "OK: ") +
              f"{len(new)} new finding(s), {len(accepted)} accepted in "
              f"baseline")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
