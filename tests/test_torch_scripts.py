"""The port's launch recipes (``geomx_tpu_torch/scripts``).

Every recipe must pass ``bash -n`` and name only modules of the port
that exist: workers run ``python -m geomx_tpu_torch.examples.<name>``,
infrastructure roles ``python -m geomx_tpu_torch.kvstore_server``. The
recipes are the JAX package's (``scripts/``), one for one, with the same
feature switches; none bakes in ``--cpu`` (the workers run on the card
unless the caller passes it). The multi-process runs themselves are
``tests/test_torch_launch_integration.py`` (slow).
"""

import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "geomx_tpu_torch" / "scripts"
RECIPES = ("vanilla_hips", "bsc", "fp16", "mpq", "hfa", "mixed_sync",
           "dcasgd", "p3", "dgt", "inter_ts", "intra_ts", "multi_gps",
           "esync", "transformer_bsc", "mesh_hips", "chaos_matrix",
           "mesh_multihost")
# the switches each recipe exports, as its JAX twin does
SWITCHES = {"p3": "ENABLE_P3=1", "dgt": "ENABLE_DGT", "hfa":
            "MXNET_KVSTORE_USE_HFA=1", "inter_ts": "ENABLE_INTER_TS=1",
            "intra_ts": "ENABLE_INTRA_TS=1", "multi_gps": "NGS=2"}


def _all():
    return sorted(p.name for p in SCRIPTS.glob("*.sh"))


def test_every_recipe_is_there():
    assert _all() == sorted(["hips_env.sh"] +
                            [f"run_{r}.sh" for r in RECIPES])


@pytest.mark.parametrize("name", _all())
def test_recipe_parses_and_names_port_modules(name):
    path = SCRIPTS / name
    subprocess.run(["bash", "-n", str(path)], check=True, timeout=30)
    text = path.read_text()
    mods = set(re.findall(r"\bgeomx_tpu_torch(?:\.\w+)+", text))
    assert mods, f"{name} names no module of the port"
    for mod in mods:
        assert importlib.util.find_spec(mod) is not None, \
            f"{name}: no module {mod}"
    # nothing of the JAX package, and no --cpu baked in
    assert not re.search(r"\bgeomx_tpu\b(?!_torch)", text)
    assert "examples/" not in text
    code = "\n".join(l for l in text.splitlines()
                     if not l.lstrip().startswith("#"))
    assert "--cpu" not in code
    recipe = name[len("run_"):-len(".sh")] if name.startswith("run_") else ""
    if recipe in SWITCHES:
        assert SWITCHES[recipe] in code


def test_recipes_mirror_the_jax_package():
    """One port recipe per JAX recipe that runs only what is ported."""
    jax = {p.name for p in (ROOT / "scripts").glob("run_*.sh")}
    assert {f"run_{r}.sh" for r in RECIPES} <= jax


@pytest.mark.parametrize("launch,server_log", [
    ("launch_hips", "server_{port}.log"),
    ("launch_mesh_hips", "mesh_server_{port}.log")])
def test_chaos_plan_reaches_party_a_server_only(tmp_path, launch, server_log):
    """``CHAOS_PLAN_SERVER_A`` becomes ``PS_FAULT_PLAN`` of party A's
    server and of no other role (every party's server is local id 8, so
    a plan's node match alone cannot single it out). Every role is a
    stub that prints its environment into its log."""
    stub = tmp_path / "role.sh"
    stub.write_text("#!/bin/sh\nenv\n")
    stub.chmod(0o755)
    logs = tmp_path / "logs"
    plan = '[{"type": "crash", "node": 8, "at": 50, "on": "recv"}]'
    env = {"PATH": "/usr/bin:/bin", "CHAOS_PLAN_SERVER_A": plan,
           "PYTHON": str(stub), "WORKER_LAUNCH": str(stub),
           "LOG_DIR": str(logs), "APORT": "19094", "BPORT": "19095"}
    out = subprocess.run(
        ["bash", "-c", f"source {SCRIPTS / 'hips_env.sh'}; {launch} mod"],
        env=env, capture_output=True, text=True, timeout=60, check=True)
    seen = {p.name: p.read_text() for p in logs.glob("*.log")}
    seen["foreground worker"] = out.stdout
    target = server_log.format(port=19094)
    assert f"PS_FAULT_PLAN={plan}\n" in seen[target]
    assert server_log.format(port=19095) in seen
    others = [n for n, text in seen.items()
              if n != target and "PS_FAULT_PLAN" in text]
    assert others == []
    # the stubs stood for every role: schedulers, servers, workers
    assert len(seen) >= (9 if launch == "launch_mesh_hips" else 12)


def _matrix_cases(text):
    """(name, plan, port base) of every run_case, the names of every
    case the matrix reports, and the plans of party A's server."""
    runs = re.findall(r"run_case ([\w-]+) \\\n\s*'(.*?)' \\\n\s*(\d+)",
                      text, re.S)
    names = set(re.findall(r"chaos\[([\w-]+)\]", text)) | \
        set(re.findall(r"shaped_case ([\w-]+)", text)) | \
        {n for n, _p, _b in runs}
    plans_a = re.findall(r"CHAOS_PLAN_SERVER_A='(.*?)'", text)
    return runs, names - {"$name", "$1"}, plans_a


def test_chaos_matrix_mirrors_the_jax_package():
    """The port's matrix has the JAX matrix's eleven cases with the same
    plans and ports (``PORT_OFFSET`` 0)."""
    jax = _matrix_cases((ROOT / "scripts" / "run_chaos_matrix.sh")
                        .read_text())
    port = _matrix_cases((SCRIPTS / "run_chaos_matrix.sh").read_text())
    assert port[0] == jax[0] and len(port[0]) == 6
    assert port[1] == jax[1] and len(port[1]) == 11
    assert port[2] == jax[2] and len(port[2]) == 2


def test_chaos_sim_four_parties_on_the_cpu():
    """``geomx_tpu_torch.tools.chaos_sim`` at 4 in-process parties on the
    shaped heterogeneous plan, with stragglers, a flapping party server
    and 2-bit thin legs: every worker completes, no sanitizer marker."""
    out = subprocess.run(
        [sys.executable, "-m", "geomx_tpu_torch.tools.chaos_sim",
         "--parties", "4", "--cpu"], cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "OK: 4 shaped chaotic parties completed 4 rounds" in out.stdout
    assert "gradients on cpu" in out.stdout


def test_chaos_sim_refuses_to_run_without_the_card_unless_asked():
    if subprocess.run([sys.executable, "-c", "import torch, sys; "
                       "sys.exit(torch.cuda.is_available())"]).returncode:
        pytest.skip("a card is present: the default runs on it")
    out = subprocess.run(
        [sys.executable, "-m", "geomx_tpu_torch.tools.chaos_sim",
         "--parties", "2", "--rounds", "1"], cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr


@pytest.mark.slow
@pytest.mark.chaos
@pytest.mark.parametrize("flags", [[], ["--health"], ["--controller"]],
                         ids=["shaped-16p", "health", "adaptive"])
def test_chaos_sim_sixteen_parties(flags):
    out = subprocess.run(
        [sys.executable, "-m", "geomx_tpu_torch.tools.chaos_sim",
         "--parties", "16", "--cpu", *flags], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]


# the matrix's cases and the LeNet rounds each needs: the mesh kill
# case's crash (party A's server's 60th frame) comes after 20 rounds.
# worker-kill is not here: its survivors finish, but the infrastructure
# roles never exit, in the JAX package's matrix as in the port's
# (ROADMAP queue C)
MATRIX = {"loss": 20, "wan-jitter": 20, "partition": 20, "overlap": 20,
          "quant-wire": 20, "shaped-16p": 0, "shaped-16p-health": 0,
          "shaped-16p-adaptive": 0, "dist-sync-mesh": 80,
          "server-kill": 20}


@pytest.mark.slow
@pytest.mark.chaos
@pytest.mark.parametrize("case", list(MATRIX))
def test_chaos_matrix_case_on_the_cpu(tmp_path, case):
    """One case of the port's matrix as separate processes on the CPU:
    the matrix's own verdict, every role's exit code and the sanitizer
    markers in every log."""
    env = dict(os.environ, CASES=case, LOG_ROOT=str(tmp_path),
               CHAOS_SIM_ARGS="--cpu", PORT_OFFSET="1000")
    out = subprocess.run(
        ["bash", str(SCRIPTS / "run_chaos_matrix.sh"), "--cpu",
         "--max-iters", str(MATRIX[case] or 20)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert f"=== chaos[{case}] OK ===" in out.stdout
