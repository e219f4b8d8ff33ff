"""The port's wire and overlay benches against the JAX package's tools
(``tools/wire_bench.py``, ``tools/overlay_bench.py``).

On the same seeded inputs, on the CPU: ``run_overlap``'s chunk count,
``run_loss``'s loss trace (bit for bit expected; 1e-6 relative covers a
summation order), the overlay bench's final weights, direct and overlay,
bit for bit, the layouts, and the rows' keys against the JAX tools' own
rows (the JAX round functions stubbed where the keys are all that is
compared). Each port tool raises without a card unless told the CPU.
Every topology runs under a wall deadline of its own.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from geomx_tpu_torch.tools import overlay_bench, wire_bench
from geomx_tpu_torch.tools.chaos_sim import SHAPES
from torch_parity_kit import within

from tools import overlay_bench as joverlay
from tools import wire_bench as jwire

DEADLINE = 60.0


def _rows(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return [json.loads(line) for line in buf.getvalue().splitlines()
            if line.startswith("{")]


def _jax_main_rows(monkeypatch, argv, **stubs):
    """The rows the JAX tool's ``main`` prints for ``argv``, its round
    functions replaced by ``stubs``."""
    for name, fn in stubs.items():
        monkeypatch.setattr(jwire, name, fn)
    monkeypatch.setattr("sys.argv", ["wire_bench"] + argv)
    return _rows(jwire.main)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


WITHOUT_A_CARD = {
    "run": lambda: wire_bench.run([(4,)], True, 1),
    "run_sparse": lambda: wire_bench.run_sparse([(4,)], 0.5, 1),
    "run_overlap": lambda: wire_bench.run_overlap([(4,)], 1, 1024),
    "run_loss": lambda: wire_bench.run_loss(2, 4, "raw", 0.5, 1),
    "wire_cli": lambda: wire_bench.main(["--rounds", "1"]),
    "overlay": lambda: overlay_bench.run(2, 4, 1, {}, inter_ts=False),
    "overlay_cli": lambda: overlay_bench.main(["--parties", "2"]),
}


@pytest.mark.parametrize("call", sorted(WITHOUT_A_CARD))
def test_the_card_unless_the_cpu_is_named(no_cuda, call):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WITHOUT_A_CARD[call]()


def test_layouts_and_constants_match_the_jax_tool(monkeypatch):
    assert wire_bench.LAYOUTS == jwire.LAYOUTS
    assert wire_bench.CONTROLLER_CFG == jwire.CONTROLLER_CFG
    assert wire_bench.LOSS_POLICIES == jwire.LOSS_POLICIES
    seen = []

    def record(shapes, batched, rounds, extra_cfg=None):
        seen.append(shapes)
        return 1.0

    _jax_main_rows(monkeypatch, ["--layout", "transformer"], run=record)
    assert wire_bench.layout_shapes("transformer") == seen[0]
    assert len(seen[0]) == 75
    assert wire_bench.layout_shapes("cnn") == jwire.LAYOUTS["cnn"]


def test_overlap_chunk_count_matches_the_jax_tool():
    shapes = wire_bench.LAYOUTS["cnn"]
    serial, piped, chunks = within(DEADLINE, wire_bench.run_overlap,
                                   shapes, 1, 131072, None, "", "cpu")
    want = within(DEADLINE, jwire.run_overlap, shapes, 1, 131072)
    assert chunks == want[2] > 1
    assert serial > 0 and piped > 0


@pytest.mark.parametrize("policy", ["raw", "fp16", "2bit"])
def test_loss_trace_matches_the_jax_tool(policy):
    # a target no round reaches: every worker runs all 5 rounds
    rounds, wall, trace = within(DEADLINE, wire_bench.run_loss, 2, 4096,
                                 policy, 1e-12, 5, None, 2, "cpu")
    want = within(DEADLINE, jwire.run_loss, 2, 4096, policy, 1e-12, 5)
    assert rounds is None and wall is None and want[0] is None
    assert len(trace) == len(want[2]) == 5
    np.testing.assert_allclose(trace, want[2], rtol=1e-6, atol=0)
    assert trace[-1] < trace[0] < 1.0


MODES = {
    "per_key_vs_batched": (["--rounds", "2"],
                           {"run": lambda *a, **k: 1.0}),
    "sparse": (["--sparse", "--rounds", "2"],
               {"run_sparse": lambda *a, **k: 1.0}),
    "overlap": (["--overlap", "--rounds", "2"],
                {"run_overlap": lambda *a, **k: (1.0, 1.0, 1)}),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_wire_rows_have_the_jax_keys(monkeypatch, mode):
    argv, stubs = MODES[mode]
    port = within(DEADLINE, _rows, wire_bench.main, argv + ["--cpu"])
    want = _jax_main_rows(monkeypatch, argv, **stubs)
    assert len(port) == len(want) == 1
    assert list(port[0]) == list(want[0])
    assert port[0]["layout"] == "cnn" and port[0]["keys"] == 10


def test_loss_bench_rows_have_the_jax_keys(monkeypatch):
    argv = ["--loss-bench", "--parties", "2", "--size", "2048",
            "--max-rounds", "3", "--policy", "raw"]
    port = within(DEADLINE, _rows, wire_bench.main, argv + ["--cpu"])
    want = _jax_main_rows(monkeypatch, argv,
                          run_loss=lambda *a, **k: (1, 1.0, [0.5]))
    assert [list(r) for r in port] == [list(r) for r in want]
    assert port[-1]["policies"]["raw"]["rounds_to_target"] in (None, 1, 2, 3)


@pytest.mark.parametrize("inter_ts", [False, True], ids=["direct", "overlay"])
def test_overlay_weights_match_the_jax_tool_bit_for_bit(inter_ts):
    ms, w = within(DEADLINE, overlay_bench.run, 4, 4096, 2, {}, inter_ts,
                   False, "cpu")
    _ms, want = within(DEADLINE, joverlay.run, 4, 4096, 2, {}, inter_ts)
    assert len(ms) == 2 and min(ms) > 0
    # SGD at lr 1 on integer gradients summed over 4 parties: -4, then -12
    np.testing.assert_array_equal(w, np.full(4096, -12.0, np.float32))
    np.testing.assert_array_equal(w, want)


def test_overlay_cli_replays_the_ports_hetero16_by_default(capsys):
    out = within(DEADLINE, overlay_bench.main,
                 ["--cpu", "--parties", "2", "--size", "1024", "--rounds",
                  "1"])
    # the tool raises unless direct and overlay weights are equal
    assert len(out["direct_ms"]) == len(out["overlay_ms"]) == 1
    header = capsys.readouterr().out.splitlines()[0]
    assert header.endswith("shape=" + os.path.join(SHAPES, "hetero16.json"))
    assert os.path.isfile(os.path.join(SHAPES, "hetero16.json"))
    assert SHAPES == os.path.join(os.path.dirname(os.path.dirname(
        overlay_bench.__file__)), "scripts", "shapes")
