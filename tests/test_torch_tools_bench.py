"""The port's compress, attention, server and PS benches against the JAX
package's tools (``tools/{compress,attention,server,ps}_bench.py``).

Each port tool keeps the JAX tool's names, defaults and row keys (in
order), runs on the CUDA card unless told ``--cpu`` / ``device="cpu"``,
and raises without a card otherwise. Here, at small sizes on the CPU:
the rows' keys against the JAX tools' own rows (a JAX timing function
that would only spend time is stubbed where the keys are all that is
compared), flash against dense attention in fp32, and the server's
weights after the same pushes against the JAX server's, bit for bit.
Every topology runs under a wall deadline of its own.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from geomx_tpu_torch.models.transformer import dense_attention
from geomx_tpu_torch.ops.flash_attention import flash_attention
from geomx_tpu_torch.tools import (attention_bench, compress_bench, ps_bench,
                                   server_bench)
from geomx_tpu_torch._device import resolve_device
from torch_parity_kit import within

from tools import attention_bench as jattention
from tools import compress_bench as jcompress
from tools import ps_bench as jps
from tools import server_bench as jserver

DEADLINE = 60.0


def _rows(fn, *args):
    """The JSON lines ``fn(*args)`` prints."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return [json.loads(line) for line in buf.getvalue().splitlines()
            if line.startswith("{")]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


# -- where the tools run ---------------------------------------------------

WITHOUT_A_CARD = {
    "compress": lambda: compress_bench.run_compress_bench([16]),
    "attention": lambda: attention_bench.bench_row(16, 1, 1, 16),
    "ps": lambda: ps_bench.bench_size(16, seconds=0.01),
    "server": lambda: server_bench.drive(1, 1, duration=0.01),
    "compress_cli": lambda: compress_bench.main(["--sizes", "16"]),
    "attention_cli": lambda: attention_bench.main(["--seqs", "16"]),
    "server_cli": lambda: server_bench.main([]),
    "ps_cli": lambda: ps_bench.main([]),
}


@pytest.mark.parametrize("call", sorted(WITHOUT_A_CARD))
def test_the_card_unless_the_cpu_is_named(no_cuda, call):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WITHOUT_A_CARD[call]()


def test_a_cuda_device_needs_the_card(no_cuda):
    assert resolve_device("cpu") == torch.device("cpu")
    for dev in (None, "cuda", "cuda:0", torch.device("cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(dev)


# -- compress_bench --------------------------------------------------------

def test_compress_row_has_the_jax_row_keys_in_order():
    port = compress_bench.run_compress_bench([4096], repeat=1, device="cpu")
    jax_rows = jcompress.run_compress_bench([4096], repeat=1)
    assert list(port[0]) == list(jax_rows[0])
    assert port[0]["size"] == 4096 and port[0]["backend"] == "cpu"
    for key, value in port[0].items():
        if key.endswith(("_ms", "_mbps")):
            assert value >= 0, key


def test_compress_keep_holds_first_outputs_against_the_jax_codec():
    from geomx_tpu import compression as jhost

    n = 4096
    keep = {}
    compress_bench.run_compress_bench([n], repeat=2, device="cpu", keep=keep)
    got = keep[n]
    grad = np.random.default_rng(0).normal(size=n).astype(np.float32)
    assert np.array_equal(got["grad"], grad)
    assert np.array_equal(got["fp16_host"].view(np.uint16),
                          grad.astype(np.float16).view(np.uint16))
    assert np.array_equal(got["fp16_device"].view(np.uint16),
                          got["fp16_host"].view(np.uint16))
    # the first (warm-up) call, from zero state, on the JAX package's codec
    res = np.zeros(n, np.float32)
    packed = jhost.two_bit_quantize(grad, res, 0.5)
    for side in ("2bit_host", "2bit_device"):
        assert np.array_equal(got[side][0], packed), side
        assert np.array_equal(got[side][1].view(np.uint32),
                              res.view(np.uint32)), side
    vals, idx = jhost.bsc_compress(grad, np.zeros(n, np.float32),
                                   np.zeros(n, np.float32), 0.01)
    assert np.array_equal(got["bsc_host"][1], idx)
    assert np.array_equal(got["bsc_host"][0].view(np.uint32),
                          vals.view(np.uint32))
    # the device side's selection is the exact top-k (no ties here)
    k = int(n * 0.01)
    dvals, didx = got["bsc_device"]
    assert sorted(didx.tolist()) == sorted(
        np.argsort(-np.abs(grad))[:k].tolist())
    assert np.array_equal(dvals.view(np.uint32), grad[didx].view(np.uint32))


def test_compress_cli_json_document(capsys):
    compress_bench.main(["--sizes", "1024,4096", "--json", "--cpu"])
    doc = json.loads(capsys.readouterr().out)
    assert doc["backend"] == "cpu" and doc["threshold"] == 0.01
    assert [r["size"] for r in doc["results"]] == [1024, 4096]


def test_compress_defaults_match_the_jax_tool():
    import inspect

    for name in ("run_compress_bench", "timeit"):
        port = inspect.signature(getattr(compress_bench, name)).parameters
        want = inspect.signature(getattr(jcompress, name)).parameters
        for p, v in want.items():
            assert port[p].default == v.default, (name, p)


# -- attention_bench -------------------------------------------------------

def test_attention_row_has_the_jax_row_keys(monkeypatch):
    port = _rows(attention_bench.main, ["--cpu", "--seqs", "128", "--batch",
                                        "1", "--heads", "2", "--head-dim",
                                        "16"])
    # the JAX tool's row at the same flags; its interpret-mode timing
    # would only spend time, so it is stubbed
    monkeypatch.setattr(jattention, "_time", lambda *a, **k: 1.0)
    monkeypatch.setattr("sys.argv", ["attention_bench", "--force-cpu",
                                     "--seqs", "128", "--batch", "1",
                                     "--heads", "2", "--head-dim", "16"])
    want = _rows(jattention.main)
    assert len(port) == len(want) == 1
    assert list(port[0]) == list(want[0])
    assert {k: port[0][k] for k in ("T", "B", "H", "D", "causal")} == \
        {"T": 128, "B": 1, "H": 2, "D": 16, "causal": True}
    for key in ("dense_fwd_ms", "flash_fwd_ms", "dense_fwdbwd_ms",
                "flash_fwdbwd_ms"):
        assert port[0][key] > 0, key


def test_attention_flash_matches_dense_in_fp32():
    q, k, v = attention_bench.inputs(1, 128, 2, 16, "cpu", torch.float32)
    assert q.dtype == torch.float32
    got, want = flash_attention(q, k, v), dense_attention(q, k, v)
    assert float((got - want).abs().max()) < 1e-4
    g_flash = attention_bench._grad(flash_attention)(q, k, v)
    g_dense = attention_bench._grad(dense_attention)(q, k, v)
    for a, b in zip(g_flash, g_dense):
        assert float((a - b).abs().max()) < 1e-4


def test_attention_sweep_blocks_raises_on_the_card(no_cuda, monkeypatch):
    with pytest.raises(ValueError, match="never read block_q / block_k"):
        attention_bench.main(["--sweep-blocks", "--seqs", "128"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        attention_bench.sweep_blocks(128, 1, 2, 16, [64], 1.0, "cuda")
    # with a card the sweep refuses before it makes any tensor
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="never read block_q / block_k"):
        attention_bench.sweep_blocks(128, 1, 2, 16, [64], 1.0, "cuda")


def test_attention_sweep_blocks_on_the_cpu():
    rows = _rows(attention_bench.main, ["--cpu", "--seqs", "128", "--batch",
                                        "1", "--heads", "2", "--head-dim",
                                        "16", "--sweep-blocks", "--blocks",
                                        "64,128,256"])
    combos = [(r["block_q"], r["block_k"]) for r in rows if "block_q" in r]
    assert combos == [(64, 64), (64, 128), (128, 64), (128, 128)]
    best = rows[-1]
    assert (best["best_block_q"], best["best_block_k"]) in combos
    assert best["dense_fwdbwd_ms"] == rows[0]["dense_fwdbwd_ms"]


# -- server_bench ----------------------------------------------------------

def _pushed_weights(mod, kvpairs_cls, data_init, grad, pushes):
    server = mod.make_server(num_workers=1)
    fake = mod._FakeSrv()
    n = grad.size

    def kvs():
        return kvpairs_cls(keys=[0], vals=[grad], offsets=[0], totals=[n],
                           lens=[n])

    server._handle(mod.push_req(head=data_init), kvs(), fake,
                   global_tier=False)
    for _ in range(pushes):
        server._handle(mod.push_req(), kvs(), fake, global_tier=False)
    return server._states[(0, 0)].stored.copy()


def test_server_weights_match_the_jax_server_bit_for_bit():
    from geomx_tpu.kvstore.base import DATA_INIT as J_INIT
    from geomx_tpu.ps.kv_app import KVPairs as JKVPairs
    from geomx_tpu_torch.kvstore.base import DATA_INIT
    from geomx_tpu_torch.ps.kv_app import KVPairs

    grad = np.random.default_rng(0).normal(size=4096).astype(np.float32)
    port = _pushed_weights(server_bench, KVPairs, DATA_INIT, grad, 7)
    want = _pushed_weights(jserver, JKVPairs, J_INIT, grad, 7)
    assert port.dtype == want.dtype == np.float32
    assert not np.array_equal(port, grad)      # the pushes moved them
    np.testing.assert_array_equal(port, want)


def test_server_drive_gives_a_positive_rate():
    rate = within(DEADLINE, server_bench.drive, 2, 2, 0.2, "cpu")
    assert rate > 0


def test_server_sweep_rows_have_the_jax_keys(monkeypatch):
    port = within(DEADLINE, server_bench.sweep, 0.05, "cpu")
    monkeypatch.setattr(jserver, "drive", lambda *a, **k: 1.0)
    want = _rows(jserver.main)
    assert [list(r) for r in port] == [list(r) for r in want]
    assert [r["threads"] for r in port] == [1, 2, 4, 8]
    assert all(r["rounds_per_s"] > 0 for r in port)
    assert (server_bench.N_ELEMS, server_bench.DURATION) == \
        (jserver.N_ELEMS, jserver.DURATION)


# -- ps_bench --------------------------------------------------------------

def test_ps_row_has_the_jax_keys_and_a_positive_rate(monkeypatch):
    port = within(DEADLINE, ps_bench.bench_size, 1024, 0.5, "cpu")
    monkeypatch.setattr(jps, "SECONDS", 0.5)
    want = within(DEADLINE, jps.bench_size, 1024)
    assert list(port) == list(want)
    assert port["elems"] == 1024 and port["rounds_per_s"] > 0
    assert port["round_ms"] > 0 and port["mb_per_s"] > 0
    assert (ps_bench.SIZES, ps_bench.SECONDS) == (jps.SIZES, 5.0)
