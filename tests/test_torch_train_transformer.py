"""The slice whole: the port's ``train_transformer`` and ``train_moe``
steps vs the JAX examples' steps, and the port examples as processes.

Both packages start from the same flax init leaves (converted) and the
same copy-task tokens, and take 3 steps: the transformer at tp 2, sp 2
(ring attention), 2 microbatches and remat; the MoE transformer at ep 2
with 4 experts. The JAX side is the JAX examples' step code on the
8-device virtual CPU mesh (``optax.adamw``); the port's is the step its
examples build (``torch.optim.AdamW`` with optax's weight decay 1e-4).

Tolerances. fp32: losses within 1e-5; parameters within 1e-5, except
the key projection's bias, whose gradient is rounding noise (softmax is
invariant to a per-row constant, and q.b_k is one): Adam normalises that
noise to steps of about the learning rate either way, so those
coordinates are held within 2 * steps * lr. In the MoE step, a
coordinate whose gradient in the JAX run was non-zero and below
``torch_parity_kit.NEAR_EPS`` in some step is held within steps * lr
(``near_eps``): Adam's first step g / (|g| + eps) on such a gradient
turns the two frameworks' rounding into a few percent of lr
(``block0.moe.w_up[0, 26, 100]``'s first gradient is -1.30e-9 in JAX
and -4.38e-10 in the port, with the same router assignment, so the step
differs by 0.073 lr).
bf16 (compute in bf16, the JAX side compiled without excess precision):
losses and parameters within 3e-2.
"""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from geomx_tpu.models.transformer import Transformer as FlaxTransformer
from geomx_tpu.models.transformer import (
    transformer_param_sharding as jax_sharding)
from geomx_tpu.parallel.grad_accum import (
    accumulate_gradients as jax_accumulate)
from geomx_tpu.parallel.mesh import make_mesh as jax_make_mesh
from geomx_tpu.parallel.ring_attention import (
    make_ring_attention as jax_ring)
from geomx_tpu_torch.examples import train_moe, train_transformer
from geomx_tpu_torch.models.convert import leaf_names
from torch_parity_kit import assert_adam_leaves_close, near_eps

ROOT = Path(__file__).resolve().parents[1]
STEPS, LR = 3, 3e-4
TINY = ["--dim", "32", "--depth", "2", "--heads", "4", "--vocab", "64",
        "--seq-len", "32", "--batch-size", "4"]
TF_FLAGS = TINY + ["--tp", "2", "--sp", "2", "--microbatches", "2",
                   "--remat"]
MOE_FLAGS = TINY + ["--ep", "2", "--experts", "4"]
DIMS = dict(vocab=64, dim=32, depth=2, heads=4)


def _jax_steps(params, mesh, toks, grad_fn):
    """3 steps of the JAX examples' jitted AdamW step; ``grad_fn(p, t) ->
    (loss, grads)``. Returns the losses, the final leaves and each step's
    gradient leaves."""
    with mesh:
        params = jax_sharding(mesh)(params)
        opt = optax.adamw(LR)
        state = opt.init(params)

        def step(p, s, t):
            loss, grads = grad_fn(p, t)
            updates, s = opt.update(grads, s, p)
            return optax.apply_updates(p, updates), s, loss, grads

        compiled = jax.jit(step, compiler_options={
            "xla_allow_excess_precision": False})
        losses, grads = [], []
        for _ in range(STEPS):
            params, state, loss, g = compiled(params, state, toks)
            losses.append(float(loss))
            grads.append([np.asarray(l)
                          for l in jax.tree_util.tree_leaves(g)])
    return (losses, [np.asarray(l) for l in jax.tree_util.tree_leaves(params)],
            grads)


def _check(names, tl, jl, tparams, jparams, dtype, dim, jgrads=None):
    """``jgrads`` (the JAX run's gradients) mark the near-epsilon
    coordinates; without them every coordinate keeps 1e-5."""
    if dtype == "float32":
        np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=1e-5)
        near = (near_eps(jgrads) if jgrads is not None
                else [np.zeros(b.shape, bool) for b in jparams])
        got, want, marks = [], [], []
        for name, a, b, m in zip(names, tparams, jparams, near):
            a = a.detach().numpy()
            if name.endswith("qkv.bias"):
                noise = slice(dim, 2 * dim)    # the key projection's bias
                np.testing.assert_allclose(a[noise], b[noise], rtol=0,
                                           atol=2 * STEPS * LR, err_msg=name)
                a, b, m = (np.delete(x, noise) for x in (a, b, m))
            got.append(a)
            want.append(b)
            marks.append(m)
        assert_adam_leaves_close(got, want, marks, 1e-5, LR, STEPS, names)
    else:
        np.testing.assert_allclose(tl, jl, atol=3e-2, rtol=3e-2)
        for name, a, b in zip(names, tparams, jparams):
            np.testing.assert_allclose(a.detach().numpy(), b, atol=3e-2,
                                       rtol=3e-2, err_msg=name)
    assert tl[-1] < tl[0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_transformer_step_matches_jax(dtype):
    seq = 32
    toks_np = train_transformer.copy_task_tokens(4, seq, DIMS["vocab"])
    init = FlaxTransformer(**DIMS, max_len=seq).init(
        jax.random.PRNGKey(0), jnp.zeros((1, seq), jnp.int32))
    leaves0 = [np.asarray(l) for l in jax.tree_util.tree_leaves(init)]

    mesh = jax_make_mesh(jax.devices(), tp=2, sp=2)
    model = FlaxTransformer(**DIMS, max_len=seq,
                            attn_fn=jax_ring(mesh, causal=True), remat=True,
                            compute_dtype=jnp.dtype(dtype))

    def loss_fn(p, t):
        logits = model.apply(p, t)
        tgt = jnp.roll(t, -1, axis=1)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, tgt).mean()

    toks = jax.device_put(jnp.asarray(toks_np, jnp.int32),
                          NamedSharding(mesh, P("dp", "sp")))
    grad_fn = jax_accumulate(
        lambda p, t: jax.value_and_grad(loss_fn)(p, t), 2)
    jl, jparams, _ = _jax_steps(init, mesh, toks, grad_fn)

    args = train_transformer.parse_args(TF_FLAGS + ["--ranks", "8",
                                                    "--cpu"])
    run = train_transformer.build(args, torch.device("cpu"),
                                  init_leaves=leaves0,
                                  compute_dtype=getattr(torch, dtype))
    assert run["mesh"].shape == {"dp": 2, "tp": 2, "sp": 2}
    tl = [float(run["step"]()) for _ in range(STEPS)]
    _check(leaf_names(run["model"]), tl, jl, run["params"], jparams, dtype,
           DIMS["dim"])


def test_train_moe_step_matches_jax():
    seq = 32
    toks_np = train_transformer.copy_task_tokens(4, seq, DIMS["vocab"])
    model = FlaxTransformer(**DIMS, max_len=seq, moe_experts=4)
    init = {"params": model.init(jax.random.PRNGKey(0),
                                 jnp.zeros((1, seq), jnp.int32))["params"]}
    leaves0 = [np.asarray(l) for l in jax.tree_util.tree_leaves(init)]
    mesh = jax_make_mesh(jax.devices(), ep=2)

    def loss_fn(p, t):
        logits, state = model.apply(p, t[:, :-1], mutable=["losses"])
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits, t[:, 1:]).mean()
        aux = sum(jnp.asarray(v).sum()
                  for v in jax.tree_util.tree_leaves(state["losses"]))
        return ce + 0.01 * aux

    toks = jax.device_put(jnp.asarray(toks_np, jnp.int32),
                          NamedSharding(mesh, P("dp", None)))
    jl, jparams, jgrads = _jax_steps(init, mesh, toks,
                                     jax.value_and_grad(loss_fn))

    args = train_moe.parse_args(MOE_FLAGS + ["--ranks", "8", "--cpu"])
    run = train_moe.build(args, torch.device("cpu"), init_leaves=leaves0,
                          compute_dtype=torch.float32)
    assert run["specs"]["block0/moe/w_up"] == ("ep", None, None)
    out = [run["step"]() for _ in range(STEPS)]
    tl = [float(ce) + 0.01 * float(aux) for ce, aux in out]
    assert all(1.0 <= float(aux) < 4.0 for _, aux in out)
    _check(leaf_names(run["model"]), tl, jl, run["params"], jparams,
           "float32", DIMS["dim"], jgrads)


def _run(module, argv, timeout=120):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-m", module, *argv], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _losses(text):
    return {int(i): v for i, v in
            re.findall(r"\[Iteration (\d+)\] Loss (\S+)", text)}


def test_train_transformer_process_learns_and_resumes(tmp_path):
    ckpt = tmp_path / "ck"
    argv = TF_FLAGS + ["--cpu", "--max-iters", "4", "--ckpt-dir", str(ckpt),
                       "--ckpt-every", "2"]
    first = _run("geomx_tpu_torch.examples.train_transformer", argv)
    assert "mesh: dp=1 tp=2 sp=2 (4 ranks on 1 x cpu)" in first
    losses = _losses(first)
    assert sorted(losses) == [1, 2, 3, 4]
    assert float(losses[4]) < float(losses[1])
    assert "checkpointed step 2" in first and "checkpointed step 4" in first
    assert sorted(os.listdir(ckpt)) == ["2", "4"]
    shutil.rmtree(ckpt / "4")
    again = _run("geomx_tpu_torch.examples.train_transformer", argv)
    assert "resumed from step 2" in again
    resumed = _losses(again)
    assert sorted(resumed) == [3, 4]
    assert resumed == {i: losses[i] for i in (3, 4)}


def test_train_moe_process_learns():
    text = _run("geomx_tpu_torch.examples.train_moe",
                MOE_FLAGS + ["--cpu", "--max-iters", "3"])
    assert "mesh: dp=1 ep=2 (2 ranks on 1 x cpu), 4 experts" in text
    rows = re.findall(r"\[Iteration (\d+)\] Loss (\S+) Aux (\S+)", text)
    assert [int(i) for i, _, _ in rows] == [1, 2, 3]
    ce = [float(c) for _, c, _ in rows]
    assert ce[-1] < ce[0]
    assert all(np.isfinite(float(a)) for _, _, a in rows)


def test_new_modules_import_no_jax():
    code = (
        "import sys\n"
        "import geomx_tpu_torch.parallel\n"
        "import geomx_tpu_torch.parallel.ring_attention\n"
        "import geomx_tpu_torch.parallel.grad_accum\n"
        "import geomx_tpu_torch.parallel.fsdp\n"
        "import geomx_tpu_torch.parallel.pipeline\n"
        "import geomx_tpu_torch.checkpoint_sharded\n"
        "import geomx_tpu_torch.models.moe\n"
        "import geomx_tpu_torch.examples.train_transformer\n"
        "import geomx_tpu_torch.examples.train_moe\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'geomx_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]"
