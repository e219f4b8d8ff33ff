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
import re
import subprocess
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "geomx_tpu_torch" / "scripts"
RECIPES = ("vanilla_hips", "bsc", "fp16", "mpq", "hfa", "mixed_sync",
           "dcasgd", "p3", "dgt", "inter_ts", "intra_ts", "multi_gps",
           "esync", "transformer_bsc", "mesh_hips")
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
