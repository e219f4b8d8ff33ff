"""geomx-lint over the port (``python -m geomx_tpu_torch.tools.analyze``).

The port's tree is clean against its baseline; its lock and state
models equal the committed JAX models under ``ps/locks.py``
``_twin_path``'s translation, file by file; its wire schema equals
``tools/analyze/binmeta.lock.json``; every baseline entry names its JAX
twin or carries a reason; planted faults, each in a copy of the port's
tree, fail the gate with exactly the findings they plant; and the root
gate over the JAX package still passes.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from geomx_tpu_torch.ps.locks import _twin_path
from geomx_tpu_torch.tools import analyze as lint
from tools.analyze import load_baseline, load_sources
from tools.analyze.lockmodel import extract_lock_model, lockmodel_lock_path
from tools.analyze.protocol import (binmeta_lock_path, extract_meta_schema,
                                    meta_schema_fingerprint)
from tools.analyze.statemodel import (extract_state_model,
                                      statemodel_lock_path)

ROOT = Path(__file__).resolve().parents[1]
JAX_LOCKS = json.loads(lockmodel_lock_path(ROOT).read_text())["files"]
JAX_STATES = json.loads(statemodel_lock_path(ROOT).read_text())["files"]
JAX_BASELINE = ROOT / "tools" / "analyze" / "baseline.json"
PORT_BASELINE = ROOT / lint.BASELINE_REL


def _port_rel(twin: str) -> str:
    return "geomx_tpu_torch/" + twin.partition("/")[2]


def _unfrozen(entry: dict) -> dict:
    return {k: v for k, v in entry.items() if k != "fingerprint"}


@pytest.fixture(scope="module")
def sources():
    return load_sources([ROOT / "geomx_tpu_torch"], ROOT)


@pytest.fixture(scope="module")
def gates():
    """Both CLIs over this checkout, every pass, run at once: the port's
    (``--json``) and the root one over the JAX package; each name ->
    (exit code, standard output)."""
    cmds = {"port": ["-m", "geomx_tpu_torch.tools.analyze", "--json"],
            "root": ["-m", "tools.analyze"]}
    procs = {name: subprocess.Popen([sys.executable, *cmd], cwd=ROOT,
                                    stdout=subprocess.PIPE, text=True)
             for name, cmd in cmds.items()}
    out = {}
    try:
        for name, proc in procs.items():
            out[name] = (proc.wait(timeout=120), proc.stdout.read())
    finally:
        for proc in procs.values():
            proc.kill()
            proc.stdout.close()
    return out


@pytest.fixture(scope="module")
def gate(gates):
    rc, text = gates["port"]
    return rc, json.loads(text)


def test_port_tree_is_clean_against_its_baseline(gate):
    rc, doc = gate
    assert doc["new"] == [] and rc == 0
    assert {f["fingerprint"] for f in doc["accepted"]} == \
        load_baseline(PORT_BASELINE)


@pytest.mark.parametrize("twin", sorted(JAX_LOCKS))
def test_lock_model_equals_the_jax_model(sources, twin):
    rel = _port_rel(twin)
    module = rel[:-len(".py")].replace("/", ".")
    assert _twin_path(module) == lint.twin_path(rel) == twin
    port = extract_lock_model([s for s in sources if s.rel == rel])
    assert port == {rel: _unfrozen(JAX_LOCKS[twin])}


def test_lock_model_has_no_port_only_file(sources):
    port = extract_lock_model(sources)
    assert sorted(lint.twin_path(rel) for rel in port) == sorted(JAX_LOCKS)


@pytest.mark.parametrize("twin", sorted(JAX_STATES))
def test_state_model_equals_the_jax_model(sources, twin):
    rel = _port_rel(twin)
    port = extract_state_model([s for s in sources if s.rel == rel])
    assert port == {rel: _unfrozen(JAX_STATES[twin])}


def test_state_model_has_no_port_only_file(sources):
    port = extract_state_model(sources)
    assert sorted(lint.twin_path(rel) for rel in port) == sorted(JAX_STATES)


def test_wire_schema_equals_the_binmeta_lock(sources):
    lock = json.loads(binmeta_lock_path(ROOT).read_text())
    src, _line, version, fields = extract_meta_schema(sources)
    assert src.rel == "geomx_tpu_torch/ps/message.py"
    assert (version, meta_schema_fingerprint(fields)) == \
        (lock["version"], lock["fingerprint"]) == (4, lock["fingerprint"])


def _twin_fingerprint(fp: str) -> str:
    rule, path, rest = fp.split(":", 2)
    return f"{rule}:{lint.twin_path(path)}:{rest}"


def test_baseline_entries_name_a_twin_or_a_reason(gate):
    doc = json.loads(PORT_BASELINE.read_text())
    entries, reasons = set(doc["findings"]), doc["reasons"]
    jax = load_baseline(JAX_BASELINE)
    for fp in entries:
        assert _twin_fingerprint(fp) in jax or reasons.get(fp), fp
    assert set(reasons) <= entries
    # a reason is for an entry with no twin in the JAX baseline
    assert not {fp for fp in reasons if _twin_fingerprint(fp) in jax}
    # none is stale: each still matches a finding of the tree
    found = gate[1]["new"] + gate[1]["accepted"]
    assert entries <= {f["fingerprint"] for f in found}
    # the JAX baseline's twins that apply are all there; GX-J102 (a
    # retrace under jit) has none: the port has no jit
    twins = {_twin_fingerprint(fp) for fp in entries}
    assert jax - twins == {fp for fp in jax if fp.startswith("GX-J")}
    assert len(jax - twins) == 1


@pytest.fixture
def tree(tmp_path):
    """A copy of everything the port's lint reads: the package (sources,
    docs, scripts, baseline), the shared env-var summary and the
    committed JAX models."""
    dst = tmp_path / "repo"
    shutil.copytree(ROOT / "geomx_tpu_torch", dst / "geomx_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    (dst / "docs").mkdir()
    shutil.copy(ROOT / "docs" / "env-var-summary.md", dst / "docs")
    (dst / "tools" / "analyze").mkdir(parents=True)
    for name in ("locks.lock.json", "state.lock.json", "binmeta.lock.json"):
        shutil.copy(ROOT / "tools" / "analyze" / name,
                    dst / "tools" / "analyze")
    return dst


def _plant(tree, rel, old, new):
    path = tree / rel
    text = path.read_text()
    assert old in text, f"{rel} moved; update the planted fault"
    path.write_text(text.replace(old, new, 1))


def _gate(tree, passes, capsys):
    capsys.readouterr()
    rc = lint.main(["--root", str(tree), "--passes", passes, "--json"])
    out = json.loads(capsys.readouterr().out)
    return rc, {(f["rule"], f["path"], f["symbol"], f["detail"])
                for f in out["new"]}


# each: the file, the text replaced, its replacement, the pass, and the
# new findings the gate must report (and no other)
PLANTS = {
    "guarded_by-removed": (
        "geomx_tpu_torch/ps/resender.py",
        '@locks.guarded_by("_lock", "_outgoing", "_seen", "_seen_order")',
        '@locks.guarded_by("_lock", "_outgoing", "_seen")',
        "lockmodel",
        {("GX-L007", "geomx_tpu_torch/ps/resender.py",
          "Resender.guarded._seen_order", "_lock->None")}),
    "epoch-fence-removed": (
        "geomx_tpu_torch/ps/van.py",
        "self.membership_epoch += 1\n            epoch = self.membership_epoch",
        "epoch = self.membership_epoch",
        "statemodel",
        {("GX-S503", "geomx_tpu_torch/ps/van.py", "Van.declare_dead",
          "declare_dead:missing-write:membership_epoch"),
         ("GX-S501", "geomx_tpu_torch/ps/van.py",
          "declare_dead.writes.membership_epoch", "membership_epoch->None")}),
    "raw-environ-read": (
        "geomx_tpu_torch/ps/resender.py",
        'log = logging.getLogger("geomx.resender")',
        'import os\nlog = logging.getLogger("geomx.resender")\n'
        'PLANTED = os.environ.get("GEOMX_PLANTED_KNOB")',
        "config-drift",
        {("GX-C201", "geomx_tpu_torch/ps/resender.py", "GEOMX_PLANTED_KNOB",
          ""),
         ("GX-C203", "geomx_tpu_torch/ps/resender.py", "GEOMX_PLANTED_KNOB",
          "")}),
    "meta-field-added": (
        "geomx_tpu_torch/ps/message.py",
        '("sender", "i"), ',
        '("sender", "i"), ("planted", "i"), ',
        "protocol",
        {("GX-P306", "geomx_tpu_torch/ps/message.py", "_META_FIELDS",
          "schema-changed")}),
}


@pytest.mark.parametrize("plant", sorted(PLANTS))
def test_planted_fault_fails_the_gate(tree, capsys, plant):
    rel, old, new, passes, want = PLANTS[plant]
    _plant(tree, rel, old, new)
    assert _gate(tree, passes, capsys) == (1, want)


def test_stale_port_doc_row_fails_the_gate(tree, capsys):
    doc = tree / lint.PORT_DOC_REL
    doc.write_text(doc.read_text() + "| `GEOMX_NEVER_READ` | — | x |\n")
    rc, new = _gate(tree, "config-drift", capsys)
    assert (rc, {n[:3] for n in new}) == (
        1, {("GX-C202", lint.PORT_DOC_REL, "GEOMX_NEVER_READ")})


def test_cli(gate, capsys):
    assert {f["rule"] for f in gate[1]["accepted"]} == \
        {"GX-C203", "GX-L002", "GX-M401"}
    assert lint.main(["--passes", "metrics", "--no-baseline"]) == 1
    assert "FAIL: 3 new finding(s)" in capsys.readouterr().out
    # the traced pass (jit hazards) does not apply to the port
    assert lint.main(["--passes", "traced"]) == 2


def test_root_gate_over_the_jax_package_still_passes(gates):
    rc, text = gates["root"]
    assert rc == 0 and text.splitlines()[-1].startswith("OK: "), text
