"""The quantized combined wire in the port, against the JAX package and
the four-leg numpy oracle.

``GEOMX_WIRE_CODEC`` narrows every leg of a combined round (worker
push, party WAN forward, global response, party response) to fp16 or
residual-feedback 2-bit codes, the codec chosen per P3 chunk (``mpq``:
bulk chunks 2-bit, small ones fp16; ``p3``: the head chunk fp16, tails
as ``mpq``). Here:

- the units of ``tests/test_quant_wire.py`` (codec policy, chunk
  stamping, encode/decode with residual carry) on both packages;
- that file's topology cases on the port (``torch_twin``): the dense
  wire against its numpy oracle on ``dist_sync`` and ``dist_sync_mesh``,
  the ``bsc16`` wire, MPQ routing with per-codec WAN telemetry and the
  >= 4x byte gate;
- every policy through live topologies over 3 rounds, the port alone,
  JAX-package tiers with port workers and the reverse, held bit for bit
  against the JAX package's run and against a numpy replay of the four
  legs with a codec per chunk; the port's workers also push torch
  tensors, which the wire encodes where they lie (the 2-bit kernel's
  plain version on the CPU) with the same bits.

Aggregator mode (no optimizer), as in the JAX file: the stores hold the
round's aggregated gradient, so the responses quantize too.
"""

import numpy as np
import pytest
import torch

import geomx_tpu.simulate as jsim
import geomx_tpu_torch.simulate as tsim
import test_quant_wire as jqw
from geomx_tpu.compression import two_bit_dequantize, two_bit_quantize
from test_torch_mesh_party import MixedMeshHiPS
from torch_parity_kit import assert_same, make_topo, run_rounds
from torch_twin import export, twin

UNITS = ["test_wire_codec_rejects_unknown_policy", "test_codec_requires_aux",
         "test_chunk_codec_routing", "test_plan_chunks_stamps_codec",
         "test_encode_decode_2bit_residual_carry_vs_oracle",
         "test_encode_fp16_and_raw"]

# the JAX file's topology cases, on the port
export(globals(), "test_quant_wire", only=[
    "test_dense_wire_matches_numpy_oracle",
    "test_bsc_wire_matches_numpy_oracle",
    "test_mpq_routes_per_chunk_and_telemetry_breaks_out_codecs",
    "test_wan_bytes_drop_at_least_4x_with_2bit_wire"])


@pytest.mark.parametrize("case", UNITS)
@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_quant_wire_unit(pkg, case):
    mod = jqw if pkg == "jax" else twin("test_quant_wire")
    getattr(mod, case)()


# -- every policy, port against the JAX package and the oracle -------------

THR = 0.1           # low enough that every leg passes most elements
SLB = 8             # size_lower_bound: keys of >= 8 elements go 2-bit
SIZES = [40, 6, 9, 4]
KEYS = list(range(len(SIZES)))
ROUNDS = 3
POLICIES = ["fp16", "2bit", "mpq", "p3"]


def _grad(w, rnd, key):
    rng = np.random.RandomState(2000 + 97 * w + 13 * rnd + key)
    return rng.uniform(-1, 1, SIZES[key]).astype(np.float32)


def _slice_bytes(policy):
    # mpq / p3 choose per chunk: a 16-byte budget gives every key a
    # chunk of its own; fp16 / 2bit ride one chunk
    return 16 if policy in ("mpq", "p3") else None


def _codec_of(policy, key):
    if policy in ("fp16", "2bit"):
        return policy
    if policy == "p3" and key == 0:
        return "fp16"               # the head chunk
    return "2bit" if SIZES[key] >= SLB else "fp16"


def _oracle(policy):
    """The four legs in numpy, each key on its chunk's codec: per party
    agg = leg(g); WAN forward wan = leg(agg); global S = wan_0 + wan_1;
    one global response rsp = leg(S); party response out = leg(rsp);
    every 2-bit leg with its own residual stream."""
    f16 = lambda x: x.astype(np.float16).astype(np.float32)  # noqa: E731
    res = {}

    def qd(leg, key, x):
        r = res.setdefault((leg, key), np.zeros(x.size, np.float32))
        return two_bit_dequantize(two_bit_quantize(x.copy(), r, THR),
                                  x.size, THR)

    out = [[], []]
    for rnd in range(ROUNDS):
        per = [[], []]
        for k in KEYS:
            if _codec_of(policy, k) == "fp16":
                S = f16(f16(_grad(0, rnd, k))) + f16(f16(_grad(1, rnd, k)))
                outs = [f16(f16(S))] * 2
            else:
                wan = [qd(("fwd", p), k, qd(("push", p), k, _grad(p, rnd, k)))
                       for p in (0, 1)]
                rsp = qd("grsp", k, wan[0] + wan[1])
                outs = [qd(("prsp", p), k, rsp) for p in (0, 1)]
            for p in (0, 1):
                per[p].append(outs[p])
        for p in (0, 1):
            out[p].extend(per[p])
    return out


def _topo(layout, policy, mesh):
    extra = {"wire_codec": policy, "wire_2bit_threshold": THR,
             "size_lower_bound": SLB}
    if not mesh:
        return make_topo(layout, num_parties=2, workers_per_party=1,
                         extra_cfg=extra)
    if layout == "jax":
        return jsim.InProcessHiPS(num_parties=2, workers_per_party=1,
                                  party_mesh_size=2, extra_cfg=extra)
    if layout == "torch":
        return tsim.InProcessHiPS(num_parties=2, workers_per_party=1,
                                  party_mesh_size=2, device="cpu",
                                  extra_cfg=extra)
    topo = MixedMeshHiPS(*{"jax_tiers_torch_workers": ("jax", "jax", "torch"),
                           "torch_tiers_jax_workers": ("torch", "torch",
                                                       "jax")}[layout])
    topo.extra_cfg = extra
    return topo


def _run(layout, policy, mesh=False, tensors=False):
    def master(kv):
        for k, n in zip(KEYS, SIZES):
            kv.init(k, np.zeros(n, np.float32))
        kv.wait()

    def worker(kv, w):
        outs = [np.zeros(n, np.float32) for n in SIZES]
        for k, o in zip(KEYS, outs):
            kv.init(k, o.copy())
            kv.pull(k, out=o)
        kv.wait()
        got = []
        for rnd in range(ROUNDS):
            grads = [_grad(w, rnd, k) for k in KEYS]
            if tensors:
                grads = [torch.from_numpy(g) for g in grads]
            kv.push_pull_async(KEYS, grads, outs,
                               slice_bytes=_slice_bytes(policy)
                               ).wait(timeout=30)
            got.extend(o.copy() for o in outs)
        if tensors and policy != "fp16":
            # the 2-bit legs encoded where the tensors lie: their error
            # feedback residuals are tensors too
            res = kv._wire._residual
            assert res and all(isinstance(r, torch.Tensor)
                               for r in res.values())
        return got

    return run_rounds(_topo(layout, policy, mesh), worker, master)


_REF = {}


def _reference(policy, mesh):
    if (policy, mesh) not in _REF:
        _REF[policy, mesh] = _run("jax", policy, mesh)
    return _REF[policy, mesh]


CASES = [(p, False, l) for p in POLICIES for l in
         ("torch", "torch-tensors", "jax_tiers_torch_workers",
          "torch_tiers_jax_workers")] + \
        [(p, True, "torch") for p in POLICIES] + \
        [("2bit", True, l) for l in ("jax_tiers_torch_workers",
                                     "torch_tiers_jax_workers")]


@pytest.mark.parametrize(
    "policy,mesh,layout", CASES,
    ids=[f"{p}-{'dist_sync_mesh' if m else 'dist_sync'}-{l}"
         for p, m, l in CASES])
def test_wire_matches_the_jax_package_and_the_oracle(policy, mesh, layout):
    ref = _reference(policy, mesh)
    want = _oracle(policy)
    assert_same(ref, want)
    tensors = layout == "torch-tensors"
    got = _run("torch" if tensors else layout, policy, mesh, tensors)
    assert_same(got, ref)
    # the last round's widest key came through the four legs non-zero
    assert np.abs(got[0][-len(KEYS)]).sum() > 0


# -- the bsc16 wire (BSC values narrowed to fp16), 3 rounds ----------------

BSC_SIZES = [8, 5, 12, 6]
BSC_KEYS = list(range(len(BSC_SIZES)))


def _bsc_inputs(w, rnd):
    rng = np.random.RandomState(50 + 10 * rnd + w)
    vals = [rng.rand(3).astype(np.float32) + 1.0 for _ in BSC_KEYS]
    idxs = [np.sort(rng.choice(n, 3, replace=False)) for n in BSC_SIZES]
    return vals, idxs


def _bsc_oracle():
    """Per round and key: dense_p = scatter(f16(vals_p)); the WAN
    forward is the dense fp16 downgrade; S = sum_p f16(dense_p); the
    responses are S's exact nonzeros at fp16."""
    f16 = lambda x: x.astype(np.float16).astype(np.float32)  # noqa: E731
    out = []
    for rnd in range(ROUNDS):
        for k, n in zip(BSC_KEYS, BSC_SIZES):
            S = np.zeros(n, np.float32)
            for p in (0, 1):
                vals, idxs = _bsc_inputs(p, rnd)
                dense = np.zeros(n, np.float32)
                np.add.at(dense, idxs[k], f16(vals[k]))
                S += f16(dense)
            out.append(f16(S))
    return [out, out]


def _run_bsc(layout):
    def master(kv):
        for k, n in zip(BSC_KEYS, BSC_SIZES):
            kv.init(k, np.zeros(n, np.float32))
        kv.wait()

    def worker(kv, w):
        for k, n in zip(BSC_KEYS, BSC_SIZES):
            kv.init(k, np.zeros(n, np.float32))
        kv.wait()
        got = []
        for rnd in range(ROUNDS):
            vals, idxs = _bsc_inputs(w, rnd)
            agg = kv.push_pull_bsc_batch_async(BSC_KEYS, vals, idxs
                                               ).results(timeout=30)
            for k, n in zip(BSC_KEYS, BSC_SIZES):
                buf = np.zeros(n, np.float32)
                np.add.at(buf, agg[k][1], agg[k][0])
                got.append(buf)
        return got

    topo = make_topo(layout, num_parties=2, workers_per_party=1,
                     extra_cfg={"wire_codec": "fp16"})
    return run_rounds(topo, worker, master)


@pytest.mark.parametrize("layout", ["torch", "jax_tiers_torch_workers",
                                    "torch_tiers_jax_workers"])
def test_bsc16_wire_matches_the_jax_package_and_the_oracle(layout):
    if "bsc" not in _REF:
        _REF["bsc"] = _run_bsc("jax")
    assert_same(_REF["bsc"], _bsc_oracle())
    assert_same(_run_bsc(layout), _REF["bsc"])


# -- the device trainer's wire16: BSC values narrowed on the device ---------

@pytest.mark.parametrize("overlap", [True, False],
                         ids=["pipelined", "serial"])
def test_device_trainer_over_the_bsc16_wire_matches_the_jax_trainer(overlap):
    """``DeviceResidentTrainer`` with ``GEOMX_WIRE_CODEC`` set narrows the
    selected values to fp16 with error feedback inside its step, so the
    wire ships ``bsc16`` (JAX: ``trainer_device.py:148-157``): 6 rounds of
    the bowl over live HiPS, the port's parameters bit for bit the JAX
    trainer's."""
    import test_torch_trainer_hips as th

    leaves = [np.zeros(s, np.float32) for s in th.SHAPES]
    kw = dict(threshold=0.25, learning_rate=0.2, momentum=0.9)
    batches = [[(s, None)] for s in th.SHIFTS]
    ref = th._run("jax", leaves, lambda lv, kv: th.JaxTrainer(
        lv, kv, th._jax_bowl, **kw), batches, 6, overlap=overlap,
        slice_bytes=8, wire_codec="fp16")
    got = th._run("torch", leaves, lambda lv, kv: th.DeviceResidentTrainer(
        lv, kv, th._torch_bowl, device="cpu", **kw), batches, 6,
        overlap=overlap, slice_bytes=8, wire_codec="fp16")
    assert got[0][2]._wire16
    for w in (0, 1):
        for a, b in zip(got[w][0], ref[w][0]):
            np.testing.assert_array_equal(a.view(np.int32),
                                          b.view(np.int32))
    for a, b in zip(got[0][0], got[1][0]):
        np.testing.assert_array_equal(a, b)
    assert any(np.abs(a).sum() > 0 for a in got[0][0])
