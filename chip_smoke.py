#!/usr/bin/env python3
"""Drive geomx_tpu_torch on one CUDA card, end to end.

Run from the root of a checkout, on a machine with an NVIDIA card:

  python3 chip_smoke.py

Phase 0 builds the CUDA kernels from ``geomx_tpu_torch/ops/csrc`` with
nvcc, one process per source, all started together, prints each
kernel's registers and spills, and counts the tensor-core instructions
(HMMA, HGMMA) in each kernel's SASS where ``cuobjdump`` exists, failing
if a bf16 tensor-core kernel has none. Phase 1 holds each
FlashAttention-2 kernel (forward, dQ, dK/dV) against its plain PyTorch
version on the card, at the transformer slice's shape and a few others
(head dims 32, 40, 128, the decode shape, q/k/v as views of a fused qkv
projection), and times kernel, plain version,
``scaled_dot_product_attention`` (as a yardstick only) and the bound:
back-to-back calls under CUDA events (the wrapper's host work included)
and the device time per launch under ``torch.profiler``, each kernel and
SDPA's forward and backward in a window of its own; ``phase1_d32``
does the same at phase 8a's attention shape (B 4, H 8, T 512, D 32).
Phase 2 trains the
59M transformer (dim 512, depth 8, heads 8, vocab 32768, seq 512, batch
8, bf16) through ``DeviceResidentTrainer`` on the local kv store and
checks that every step went through the kernels, and a profiled round
through the bf16 tensor-core ones.

Phase 3 is the intra-party tier: 3a holds the 2-bit quantize kernel bit
for bit against its plain version (up to the transformer's full
parameter count, and at the quantized ring's strided shape) and times
both beside the bound; 3b runs the quantized ring all-reduce of a 2-rank
party for every codec, checks the byte gates and the ring on the card
against the same ring on CPU tensors, bit for bit; 3c is the 200-round
convergence probe of the JAX package's bench; 3d trains the 59M
transformer as a 2-rank party, 5 steps of local grads, one 2-bit ring
over the flattened gradient and SGD, and checks every step's launches
and step 1's ring against its CPU replay.

Phase 4 is the HiPS tier: a live two-party topology (``InProcessHiPS``,
one worker per party, every role on threads of this process, every byte
over loopback sockets) with ``DeviceResidentTrainer`` on the card in
both workers. 4a is the main path, ``bench.py`` ``bench_hips_bsc``:
LeNet, BSC threshold 0.02, lr 0.05, 128 images per worker, 200 rounds
of the pipelined round, then both accuracies (at least 0.98), the
``step_timed`` medians, img/s and WAN bytes per round, and the two
workers' parameters bit for bit. 4b is ``bench_transformer_bsc``: the
59M transformer, 10 counted rounds (finite, declining losses; 8 launches
of each flash kernel per step per worker), the ``step_timed`` split with
the pipelined and the serial round, one profiled round, and the
replicas bit for bit. Its variant puts BSC (threshold 0.01) on the
global tier, as ``examples/cnn_bsc.py`` does: 1 counted round, its WAN
bytes and ``step_timed`` wire beside the dense rounds', and the host
spans of that round.

Phase 5 runs the BASELINE.md feature configs over the same topology,
each through its example's ``run_worker`` (the master's part first),
LeNet at full width, 128 images per worker per round, cuDNN exact: 5a
the no-kvstore baseline (batch 256, Adam, 100 steps) and ``cnn.py``'s
FSA with Adam on the global server for 100 rounds, within 0.02 of the
baseline's accuracy; 5b ``cnn_hfa.py`` (K1 4, K2 2, local Adam), within
0.02; 5c 40 rounds each of ``cnn_fp16.py`` (multi-precision, bf16
compute), ``cnn_bsc.py`` at 0.01 and at 0.2, ``cnn_mpq.py`` (0.01, size
bound 20,000) and ``cnn.py -ms`` (MixedSync), above chance. Each prints
its accuracies, step times, img/s and WAN bytes per round beside the
payload counted from the shapes, and fails on a non-finite loss, WAN
bytes outside that count, or replicas that differ where the global tier
is synchronous.

Phase 6 is the mesh-party tier (``InProcessHiPS(party_mesh_size=2)``:
each party ONE ``KVStorePartyMesh`` whose 2 ranks share the card, so the
van sees one worker per party, both parties' meshes on the one card).
6a is ``bench.py`` ``bench_hips_mesh``: the main path's LeNet recipe
(BSC 0.02, lr 0.05, 200 rounds) with a party batch of 2 x 128, run with
``GEOMX_MESH_CODEC`` none and 2bit (settings scoped to the run): the
intra-party protocol probe beside phase 4a's wire, accuracies against
their floors, img/s, WAN and mesh bytes per round (2bit at least 14x
below none), the two_bit kernel's launches, the parties bit for bit. 6b
is the 59M transformer as 2 parties x 2 ranks, 8 sequences per rank,
through the 2-bit ring and BSC 0.01: 1 warm-up round, 1 counted
``step_timed`` rounds and a profiled one; launches of every kernel per
round, WAN and mesh bytes, the device's busy share, round 1's loss
against plain attention, the parties bit for bit.

Phase 7 runs every role as its own process, through the port's launch
recipes (``geomx_tpu_torch/scripts``: ``hips_env.sh``'s ``launch_hips``
and ``launch_mesh_hips``, ``run_*.sh``), each in a session of its own,
every worker (and the master) through this script's ``--worker`` mode,
which runs the example's ``main`` and then prints one JSON line: the
devices the process resolved, whether the card held its tensors, its
kernel launches and the sha256 of its final parameters. A recipe that
does not finish in time has its process group killed and fails the
phase; so do a non-zero exit and a process left behind. 7a is the main
path's recipe (``cnn_bsc_device``, BSC 0.02, lr 0.05, 128 images per
worker, 12 processes: 2 parties x 2 workers) for 200 rounds and 5
``step_timed`` rounds: every worker on the card, the four workers'
per-round accuracies and final parameters identical, those parameters
bit-identical to the same recipe's run with every role on threads of
this process (the example's ``main`` on a 2 x 2 ``InProcessHiPS``), the
last and the peak accuracy above floors set from CPU rehearsals, the
``step_timed`` medians beside phase 4a's. 7b is ``run_transformer_bsc.sh`` (the 59M
transformer): 3 counted and 2 ``step_timed`` rounds, finite losses,
identical parameters, 8 launches of each flash kernel per step per
worker, the wire beside phase 4b's in-process wire. 7c is
``run_mesh_hips.sh`` with ``GEOMX_MESH_CODEC=2bit`` (LeNet, 2 parties of
2 ranks, 20 rounds): the two_bit kernel launched in each party worker,
the parties' accuracies identical. 7d runs ``run_p3.sh``,
``run_inter_ts.sh``, ``run_dgt.sh`` (mode 1), ``run_multi_gps.sh`` and
``run_esync.sh`` for 5 rounds each, all at once: every worker alive,
in lockstep, every process gone at the end, and the P3, inter-TS and
MultiGPS runs ending on the same parameters.

Phase 8 is long-context and sharded training (the JAX package's
``train_transformer`` / ``train_moe`` flagship; a mesh's ranks share the
card). 8a runs ``geomx_tpu_torch.examples.train_transformer`` at its
defaults (dim 256, depth 4, heads 8, vocab 1024, seq 512, batch 8, bf16,
AdamW at 3e-4, 20 steps) as one rank, as tp 2 with 2 microbatches, remat
and a checkpoint every 10 steps (then a resume from step 10 that must
give the same losses for steps 11-20), and as tp 2 x sp 2 (ring
attention): falling losses, the whole loss curve within bf16 rounding
of one rank's step by step (three planted faults, a wrong accumulation
scale, a gradient of one microbatch, ring attention's softmax
denominator without a gradient, must each fail that check), the flash
launches per step as reckoned from depth, microbatches and remat, none
of two_bit (phase 1 times the kernels at this attention shape, D 32,
beside SDPA and the bound), median step ms. 8b holds ring attention (sp 4) and
the flash kernels at B 2, H 8, D 32, T 4096, bf16, against fp32 dense
attention, forward and q/k/v gradients, and times both. 8c runs
``train_moe`` at its defaults with ep 1 and ep 2. 8d holds
``FSDPTrainer`` on LeNet at dp 8 against ``DataParallelTrainer`` and
the GPipe pipeline at pp 4, M 6 against its stages in sequence. To
rehearse on the CPU: ``python -c "import numpy, torch, chip_smoke as c;
from geomx_tpu_torch.ops import flash_attention as fa, two_bit as tb;
c.TF8 = ['--dim', '32', '--depth', '2', '--heads', '4', '--vocab', '64',
'--seq-len', '32', '--batch-size', '4']; c.MOE8 = c.TF8;
c.PHASE8['ring']['T'] = 512; c.phase8a(torch, numpy, fa, tb, 'cpu');
c.phase8b(torch, fa, 'cpu'); c.phase8c(torch, numpy, fa, 'cpu');
c.phase8d(torch, numpy, 'cpu')"``.

Phase 9 is the quantized combined wire (``GEOMX_WIRE_CODEC``) and the
chaos layer. 9a runs the 59M decoder as 2 parties x 1 worker over a live
``InProcessHiPS`` in aggregator mode (``bench.py``
``_quant_wire_layout``), its gradient leaves pushed as tensors on the
card through ``push_pull_async`` (P3 chunks of 4 MiB), SGD on the
aggregate, under the policies "", fp16, 2bit and mpq in turn (1 warm-up
and 2 counted rounds each; 3 before phase 13 was added): every counted
round's aggregate on both workers against a host replay of the four legs
(worker push, WAN forward, global response, party response;
``tests/test_quant_wire.py``'s oracle, each element on its chunk's
codec, the 2-bit residuals carried over the rounds), the replicas bit
for bit, the two_bit kernel launched once per 2-bit entry of each push,
WAN bytes per codec against the payload counted from the shapes, 2bit at
least 4x below raw, falling losses, and the split of a round (compute,
encode and D2H, wire, apply). 9b is ``_quant_wire_parity`` with the
gradients on the card: the 2-bit wire's final loss within 0.05 of the
raw wire's. 9c runs ``run_chaos_matrix.sh``'s quant-wire case (beside
the same recipe with an empty plan) and its server-kill case as separate
processes at once: every role exits 0, every worker completes in
lockstep, no sanitizer marker. To rehearse on the CPU: ``python -c
"import numpy, torch, chip_smoke as c; from geomx_tpu_torch.ops import
flash_attention as fa, two_bit as tb; c.MODEL = dict(dim=64, depth=2,
heads=4, vocab=256, seq_len=64); c.BATCH = 2; c.PHASE9['slice_bytes'] =
16384; c.phase9a(torch, numpy, fa, tb, None, 'cpu'); c.phase9b(torch,
numpy, tb, 'cpu'); c.phase9c('cpu')"`` (~45 s).

Phase 11 is a party over several processes (``torch.distributed``,
gloo; each rank's launches counted in its own process from zero). 11a
runs ``geomx_tpu_torch/scripts/run_mesh_multihost.sh`` with 2 and with
4 processes, every mesh codec in turn at n = 1<<16: the group
forms, one global worker, every process's output bit-identical to every
other's and to the one-process ring on a ``PartyMesh`` of the same P
(none within 1e-6), ``two_bit`` launched in every process under 2bit.
11b is phase 3d's configuration with each of its two ranks a process
(``--party-rank``): the 59M decoder, 3d's batches and warm-up, 3 counted
steps of local grads, the 2-bit ring across the processes and SGD; per
process and step 8 launches of each flash kernel and 2 of ``two_bit``,
the split local grads / quantize / D2H + gloo + H2D / dequantize /
apply, the ranks identical and their parameters equal to 3d's after as
many steps, bit for bit. 11c is 7c's recipe with ``MESH_PROCS=2`` (12
processes): the four ranks' accuracies in lockstep and equal to 7c's,
their parameter digests equal to each other and to 7c's, every role's
exit code. On the CPU: ``phase11a(..., dev="cpu")`` and
``phase11c("cpu", accs, digest)`` as they are, ``phase11b(np, losses,
digest, dev="cpu")`` at a small ``MODEL`` given the losses and the
digest of 3d's steps at that size on the CPU.

Phase 12 runs right after phase 0, so that every later phase stands on
a checked card: ``geomx_tpu_torch/tools/chip_sanity.py``'s five probes
(the JAX package's ``tools/chip_sanity.py`` for the H100). Float32
buffers holding denormal and NaN-payload bit patterns go to the card and
back from pageable and pinned memory, blocking and ``non_blocking``; the
same patterns made on the card go through ``cat``, ``index_select``,
``where`` and the device trainer's pack; an fp32 matmul and convolution
against a float64 numpy oracle under PyTorch's defaults, with TF32 on,
with TF32 off and under the script's own settings (the ratios printed);
a chain of 2048^3 bf16 matmuls timed by a synchronise and by CUDA events
against a value fetch; the device trainer's BSC cycle for 25 rounds
against its numpy oracle. Each probe's verdict is a line; a red probe,
or more than ``PHASE12_LIMIT_S``, fails the run. On the CPU:
``python -c "import chip_smoke as c; c.phase12('cpu')"``.

Phase 13 runs the repo's measurement tools over the port
(``geomx_tpu_torch/tools/*_bench.py``), each line of theirs printed
again as a ``[phase13]`` line. 13a is ``attention_bench`` at its defaults
(B 4, H 8, D 64, T 512-4096) and at the 59M decoder's attention (B 8, T
512): per row 42 forward, 21 dQ and 21 dK/dV launches, flash within 2e-2
of dense attention in bf16, finite positive times, and SDPA timed by the
same chain as a yardstick; on the row's inputs flash's out, dq, dk and
dv against fp32 dense attention, each row's error within 2e-2 (out) or
5e-2 of the larger of its max and a tenth of the tensor's. 13b is
``compress_bench`` at its sizes and at the 59M decoder's whole gradient
(repeat 3): the ``two_bit`` launches of each size, and on the tool's
first outputs (from zero state) the card's fp16 bytes, 2-bit bytes and
residual equal to the host codec's, its BSC selection the exact top-k,
and every index where it and the host codec's differ where the host's
sampled boundary and its cap of k put it. 13c is ``ps_bench``'s
three sizes (2 s each) and ``server_bench``'s 1-8 threads (1 s each),
every rate positive. 13d is ``wire_bench``: per-key against batched at
both layouts (10 / 2 rounds), the sparse wire, the overlap (3 rounds)
at the transformer layout under "", fp16, 2bit and mpq at 128 KiB and 4
MiB slices with the host profiler's spans of each, and the loss bench's
five policies on ``wan2_50ms_100mbps.json`` (the raw policy must reach its
target). 13e is ``overlay_bench`` at 16 parties on ``hetero16.json``,
direct and overlay bit-exact. The lap is held to 180 s. To rehearse on
the CPU at small sizes: ``python -c "import chip_smoke as c, torch,
numpy as np; from geomx_tpu_torch.ops import flash_attention as fa,
two_bit as tb; c.PHASE13.update(attn=((1, 2, 16, (128,)),),
compress_sizes=(4096,), big=65536, ps_s=0.3, server_s=0.2,
rounds={'cnn': 2, 'transformer': 1}, overlap_rounds=1,
overlay=dict(parties=2, rounds=1)); c.phase13(torch, np, fa, tb,
'cpu')"`` (~40 s).

Exits non-zero without a card, outside a checkout, or when any check
fails. The line before the last is the kernel table as JSON; the last is
``{"ok": true, "device": {...}}``.
"""

import hashlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
from unittest import mock

SLICE = dict(B=8, T=511, H=8, D=64)        # the transformer's attention
D32 = dict(B=4, T=512, H=8, D=32)          # phase 8a's, per microbatch
MODEL = dict(dim=512, depth=8, heads=8, vocab=32768, seq_len=512)
BATCH, STEPS = 8, 5
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
SOURCE = "geomx_tpu_torch/ops/csrc/flash_attention.cu"
KERNELS = {   # launch-count key -> (name, TPU kernel it replaces, the CUDA
    #                              kernel bf16 runs, as the profiler names it)
    "fwd": ("flash_fwd", "geomx_tpu/ops/flash_attention.py:85",
            "geomx_fa_fwd_tc"),
    "dq": ("flash_bwd_dq", "geomx_tpu/ops/flash_attention.py:155",
           "geomx_fa_dq_tc"),
    "dkv": ("flash_bwd_dkv", "geomx_tpu/ops/flash_attention.py:207",
            "geomx_fa_dkv_tc"),
}
# the bf16 kernels on the tensor cores: one instantiation per padded head dim
TC_KERNELS = ("geomx_fa_fwd_tc", "geomx_fa_dq_tc", "geomx_fa_dkv_tc")
PROFILE_REPS = 20           # calls per torch.profiler window
TWO_BIT = ("two_bit_quantize", "geomx_tpu_torch/ops/csrc/two_bit.cu",
           "geomx_tpu/ops/__init__.py:161")
TWO_BIT_BYTES = 12.25      # per element: read grad + residual, write
#                            residual + a quarter of a code byte
MESH_CODECS = ("none", "int8", "2bit", "fp16")
MESH_QUANT_PARITY_TOL = 5e-4        # bench.py's gate for int8 vs none
PARTY, PARTY_LR = 2, 0.05           # phase 3d: ranks, SGD step
# phase 3d's 2-bit threshold: the config default 0.5 would code nothing
# at this gradient scale; this one codes about a quarter of step 1's
# coordinates (the script prints the share and fails below 1%)
PARTY_THRESHOLD = 1e-4
# phase 4a: bench.py bench_hips_bsc's main path (bench.py:52,76,352,355)
LENET = dict(batch=128, threshold=0.02, lr=0.05, rounds=200, timed=5,
             thr_rounds=50)
PARITY_TOL_BSC = 0.02       # of the 1.0 the dense run reaches on this data
# phase 4b: bench.py bench_transformer_bsc's settings
HIPS_TF = dict(threshold=0.01, lr=0.05, momentum=0.9, batches=4, rounds=10,
               timed=1, alternations=1, bsc_rounds=1)
# phase 5: the BASELINE.md feature configs through their examples'
# run_worker (bench.py BATCH_PER_WORKER :52, ACC_ITERS :53, bench_nokv
# :140, bench_hips :246, bench_hips_hfa :746, the tolerances :75-81)
FEATURE = dict(batch=128, acc_iters=100, codec_rounds=40, lr=1e-3,
               hfa_k1=4, hfa_k2=2, threshold=0.01, mpq_bound=20000,
               chance=0.2)
PARITY_TOL_FSA = PARITY_TOL_HFA = 0.02
# phase 6: the mesh-party tier (bench.py bench_hips_mesh :491, party
# batch ranks x 128; the transformer at 8 sequences per rank). Accuracy
# floors (PERF.md, slice 7): "none" at the JAX package's own CPU reading
# of bench_hips_mesh (0.0967: the recipe's 200 rounds end on its plateau
# there, as the port's CPU rehearsal does at one torch thread) less
# 0.02, since it and the port's rehearsal both fall below phase 4a's
# 0.98; "2bit" (threshold 2e-4) at its CPU rehearsal's 0.4531 less 0.05
MESH6 = dict(ranks=2, probe_reps=30, thr_rounds=20, tf_rounds=1,
             lenet_2bit_threshold=2e-4, acc_none=0.0967 - 0.02,
             acc_2bit=0.4531 - 0.05, round1_tol=1e-4)
JOIN_S = 900                # per topology: a hung worker fails the phase
# phase 7: the port's launch recipes, every role its own process. The
# LeNet floors come from three CPU rehearsals of 7a's recipe (PERF.md,
# slice 8): at 4 workers the recipe learns, then may fall back to chance
# (last accuracies 0.0967, 0.5420, 0.0928; peaks 0.3135, 0.7393, 0.5508),
# so the last accuracy is gated at the lowest less 0.02 and the peak at
# the lowest less 0.1
PHASE7 = dict(lenet_rounds=200, timed=5, acc_last=0.0928 - 0.02,
              acc_peak=0.3135 - 0.1, tf_rounds=3, timed_tf=2, mesh_rounds=20,
              short=5, timeout_7a=300, timeout_7b=420, timeout_short=240)
HIPS_ENV = "source geomx_tpu_torch/scripts/hips_env.sh"
# phase 8: long-context and sharded training at the examples' defaults
# (examples/train_transformer.py:30-49, examples/train_moe.py:27-44).
# curve_tol: the 20-step loss curves of tp 2 with 2 microbatches and of
# ring attention against one rank's, the largest relative gap of a step,
# bf16 (PERF.md: the sound runs' and the planted faults' readings);
# moe_tol: ep only records a layout, so ep 1 and ep 2 compute the same;
# ring_tol: out, dq, dk, dv of bf16 ring attention and bf16 flash against
# fp32 dense attention, as a share of the reference's largest magnitude
PHASE8 = dict(iters=20, ckpt_every=10, curve_tol=3e-3, moe_tol=1e-6,
              ring=dict(B=2, H=8, D=32, T=4096, sp=4),
              ring_tol=(2e-2, 5e-2, 5e-2, 5e-2), fsdp_steps=10, pp=4, M=6)
# phase 9: the quantized combined wire (bench.py _quant_wire_layout /
# _quant_wire_parity, :1016-1126) at the 59M decoder's width and the
# chaos matrix's quant-wire and server-kill cases. threshold: the 2-bit
# legs' at this gradient scale (phase 3d's: the config default 0.5 would
# code nothing); lr: SGD on the aggregate of the 2 workers; slice_bytes:
# P3_SLICE_BYTES, 4 MiB (the matrix's 128 KiB cuts the 59M decoder into
# 1,867 entries and 7,336 WAN messages a round: 25-45 s per round, 834 s
# for 9a on the H100, PERF.md); parity: bench.py's probe and its gate
# QUANT_PARITY_TOL (bench.py:1020); matrix_threshold: 9c's quant-wire
# WAN legs (phase 6a's LeNet threshold: at the default 0.5 they would
# code nothing of LeNet's gradients and the model would never move)
PHASE9 = dict(policies=("", "fp16", "2bit", "mpq"), size_lower_bound=2048,
              slice_bytes=4 << 20, warm=1, rounds=2, threshold=1e-4, lr=0.5,
              parity=dict(d=256, n=64, rounds=200, threshold=0.1, lr=0.05),
              parity_tol=0.05, matrix_iters=10, timeout_9c=300,
              matrix_threshold=2e-4)
# phase 10: the image-classification path. 10a: one model per zoo family
# at published width (224 x 224 x 3, InceptionV3 299 x 299 x 3, 1,000
# classes; the language models at get_model's defaults, sequences of
# `seq` tokens); its train step at `check_batch` from the same leaves:
# in float64 on the card, each gradient leaf within f64_tol of (its norm
# plus the whole gradient's) of the CPU's float64 step: the same
# function, leaf by leaf (the vision models land within 1e-9 of the
# bound's scale, cuDNN's float64 recurrences up to 2.3e-6 off the CPU's). In float32 on the card against float64: the
# loss within loss_tol relative; and, where the CPU's own float32 step
# from the same leaves lands within grad_tol of float64 (relative norm
# of the whole gradient), the card's within grad_tol or whole_factor
# times the CPU's; the leaves within grad_tol of their norm are counted.
# Elsewhere float32 cannot meet the bound: at random init a BatchNorm
# net's float32 backward is far off float64, as the CPU's shows: the
# BatchNorm backward subtracts its batch means at every layer, and on
# the CPU the stem BatchNorm's bias gradient lands 3 to 24 times past
# 1e-3 of its norm at these sizes, the whole gradient 1-3% from float64
# (ResNet-50, VGG16-BN, DenseNet-121, the MobileNets, InceptionV3); on
# the card cuDNN's float32 algorithms add their own rounding (SqueezeNet
# 1.1's stem weight gradient 3.4e-3 of its norm, the CPU's 6e-7;
# InceptionV3's whole gradient 71% from float64, the CPU's 3.6%).
# Then the float32 step's median over `time_reps` at `time_batch`. JAX_PARAMS: the JAX package's parameter
# counts of the same names (jax.eval_shape of its get_model at 1,000
# classes). 10b: examples/cnn.py's run_worker, --model resnet50 -dt
# cifar10, 2 parties x 1 worker, batch 32, 3 rounds; a leg carries the
# 161 leaves dense fp32, 4 x 23,520,842 bytes. 10c: the records path
# (tests/test_image_pipeline.py:138's) on the card: 96 raw CIFAR-shaped
# records, ResNet-18 at 3 classes, 12 Adam steps of 32.
ZOO10 = ("resnet50", "alexnet", "vgg16_bn", "squeezenet1.1", "mobilenet1.0",
         "mobilenetv2_1.0", "densenet121", "inceptionv3", "lstm_lm",
         "gru_lm", "rnn_lm")
JAX_PARAMS = {"resnet50": 25_557_032, "alexnet": 61_100_840,
              "vgg16_bn": 138_365_992, "squeezenet1.1": 1_235_496,
              "mobilenet1.0": 4_231_976, "mobilenetv2_1.0": 3_504_872,
              "densenet121": 7_978_856, "inceptionv3": 23_834_568,
              "lstm_lm": 388_584, "gru_lm": 355_816, "rnn_lm": 289_896}
PHASE10 = dict(check_batch=2, time_batch=32, time_reps=10, seq=64,
               loss_tol=1e-4, grad_tol=1e-3, f64_tol=1e-5, whole_factor=4,
               hips_rounds=3, hips_batch=32, resnet50_cifar_params=23_520_842,
               records=96, record_epochs=4, record_batch=32)
# phase 11: a party over several processes (torch.distributed, gloo).
# 11a: run_mesh_multihost.sh at the JAX script's n with 2 and 4
# processes; none_tol: the all-reduce against the one-process sum, as a
# share of the largest magnitude. 11b: phase 3d's party, each rank a
# process, `steps` counted steps after 3d's warm-up: the same
# computation on the same card as 3d's, so the parameters after them
# must equal 3d's after as many steps bit for bit; loss_tol: the largest
# gap of a step's mean loss from 3d's (3d averages the ranks' float32
# losses in float64, 11b in float32: half an ulp of a loss near 11 is
# 5e-7). timeout: per topology, a hung rank fails the phase
PHASE11 = dict(sizes=(2, 4), n=1 << 16, none_tol=1e-6, timeout=240, steps=3,
               loss_tol=1e-5)
# phase 12: the card's self-check, run before phase 1
PHASE12_LIMIT_S = 30
# phase 13: the measurement tools (geomx_tpu_torch/tools/*_bench.py). 13a:
# attention_bench at its defaults (B 4, H 8, D 64, T 512-4096) and at the
# 59M decoder's attention (B 8, H 8, D 64, T 512), `attn_iters` calls per
# timed chain, flash within phase 1's bf16 tolerance of dense attention,
# and flash's out, dq, dk, dv on the row's inputs against fp32 dense
# attention within `attn_tol` by `row_close` (each row against the larger
# of its own max and ROW_FLOOR of the tensor's; the floor leaves room for
# the kernels' bf16 rounding of dS on dQ's first rows, which cancel).
# 13b: compress_bench at its defaults and at the 59M decoder's whole
# gradient (2 x 29,534,720), `big_repeat` timed calls there; the checks
# read the tool's own first outputs. 13c:
# ps_bench's sizes and server_bench's thread counts, `ps_s` and
# `server_s` seconds each. 13d: wire_bench, `rounds` per layout, its
# overlap at the transformer layout under each wire codec and slice size,
# its loss bench on the two-party WAN plan. 13e: overlay_bench at 16
# parties on hetero16. The lap is held to `limit_s`.
ROW_FLOOR = 0.1
PHASE13 = dict(attn=((4, 8, 64, (512, 1024, 2048, 4096)), (8, 8, 64, (512,))),
               attn_iters=20, attn_tol=(2e-2, 5e-2, 5e-2, 5e-2),
               compress_sizes=(262_144, 1_048_576, 8_388_608),
               big=2 * 29_534_720, big_repeat=3, ps_s=2.0, server_s=1.0,
               rounds={"cnn": 10, "transformer": 2}, overlap_rounds=3,
               codecs=("", "fp16", "2bit", "mpq"),
               slices=(131_072, 4_194_304),
               loss=dict(parties=2, size=65536, target=3e-2, max_rounds=20,
                         shape="wan2_50ms_100mbps.json"),
               overlay=dict(parties=16, rounds=1), limit_s=180)
TF8 = []     # extra train_transformer flags (a CPU rehearsal's tiny model)
MOE8 = []    # extra train_moe flags


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, reps, warmup=3):
    """Mean device ms of ``fn`` over ``reps`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")   # + Ex, ExC
PROFILE_TRIES = 3           # windows per reading before "not measured"


def traced(torch, run):
    """``run()`` once under ``torch.profiler`` after one warm-up call in
    the same session (its events are dropped: a session's first
    launches can go unrecorded). Returns (key_averages, wall ms of the
    recorded call, what ``run`` returned)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        run()
        torch.cuda.synchronize()
        prof.step()
        t = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        prof.step()
    return prof.key_averages(), wall, out


def device_rows(events):
    """(self device ms, count, name) of all the device did in ``events``:
    kernels, copies and fills, not the spans that the profiler's steps
    and the optimizer's annotations draw on the device's timeline."""
    return [(e.self_device_time_total / 1e3, e.count, e.key) for e in events
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith(("ProfilerStep", "Optimizer."))]


def kernel_rows(events):
    """:func:`device_rows` without the copies and fills."""
    return [r for r in device_rows(events)
            if not r[2].startswith(("Memcpy", "Memset"))]


def complete(events, expect=None, calls=1):
    """Whether a traced window saw every launch: with ``expect`` ({kernel
    name: launches per call}) each named kernel ran ``calls`` x its
    count; without it, the device ran as many kernels as the host
    launched (``cudaLaunchKernel*`` and ``cuLaunchKernel*`` calls, at
    least one). Returns (ok, what was seen)."""
    rows = kernel_rows(events)
    if expect is not None:
        seen = {k: sum(n for _ms, n, name in rows if k in name)
                for k in expect}
        return all(seen[k] == calls * n for k, n in expect.items()), seen
    launched = sum(e.count for e in events
                   if e.key.startswith(LAUNCH_CALLS))
    ran = sum(n for _ms, n, _name in rows)
    return launched > 0 and ran == launched, {"launched": launched,
                                              "ran": ran}


def device_ms(torch, fn, reps, expect=None, whole=False):
    """Mean device ms per call of ``fn`` over ``reps`` calls in a
    torch.profiler window (:func:`traced`): with ``expect`` ({kernel
    name: launches per call}) the self device time of those kernels
    (of every kernel with ``whole``), else of every kernel. It counts
    only from a window that :func:`complete` finds whole, tried up to
    ``PROFILE_TRIES`` times. Returns (ms, or None when not measured;
    what the last window saw)."""
    fn()
    for _ in range(PROFILE_TRIES):
        events, _wall, _ = traced(torch, lambda: [fn() for _ in range(reps)])
        ok, seen = complete(events, expect, reps)
        if ok:
            rows = kernel_rows(events)
            if expect is not None and not whole:
                rows = [r for r in rows if any(k in r[2] for k in expect)]
            return sum(r[0] for r in rows) / reps, seen
    return None, seen


def shown(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def sass_check(_cuda, head_dims):
    """Count HMMA / HGMMA instructions in each kernel's SASS of the flash
    library; fail if a bf16 tensor-core kernel (every padded head dim)
    has none. Without cuobjdump, say that it was not checked."""
    tool = shutil.which("cuobjdump")
    if tool is None:
        home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
        cand = os.path.join(home, "bin", "cuobjdump")
        tool = cand if os.path.exists(cand) else None
    if tool is None:
        print("[phase0] cuobjdump not found: tensor-core instructions not "
              "checked", flush=True)
        return
    sass = subprocess.run([tool, "-sass", str(_cuda._target(
        "flash_attention"))], capture_output=True, text=True, timeout=300,
        check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = line.split("Function :", 1)[1].strip()
            counts[cur] = 0
        elif cur is not None and ("HMMA" in line or "HGMMA" in line):
            counts[cur] += 1
    for name, n in counts.items():
        print(f"[phase0] SASS {n:4d} HMMA/HGMMA in {name}", flush=True)
    for tc in TC_KERNELS:
        found = [n for name, n in counts.items() if tc in name]
        if len(found) != len(head_dims) or min(found) == 0:
            fail(f"{tc}: tensor-core instructions per instantiation {found}, "
                 f"expected {len(head_dims)} instantiations, none empty")


def visible_pairs(Tq, Tk, causal):
    if not causal:
        return Tq * Tk
    off = Tk - Tq
    return sum(min(Tk, i + off + 1) for i in range(Tq))


def bounds(B, Tq, Tk, H, D, causal, dtype):
    """(bound_ms, bound_by, bytes, flops) per kernel: each input read once,
    each output written once; products over the visible (q, k) pairs."""
    esz = 2 if dtype == "bfloat16" else 4
    q_b, kv_b = B * Tq * H * D * esz, B * Tk * H * D * esz
    row_b = B * H * Tq * 4                 # one fp32 value per query row
    mac = 2 * B * H * D * visible_pairs(Tq, Tk, causal)   # one product
    work = {   # (bytes, flops)
        "fwd": (q_b + 2 * kv_b + q_b + row_b, 2 * mac),
        "dq": (2 * q_b + 2 * kv_b + 2 * row_b + q_b, 3 * mac),
        "dkv": (2 * q_b + 2 * kv_b + 2 * row_b + 2 * kv_b, 4 * mac),
    }
    out = {}
    for k, (nbytes, flops) in work.items():
        t_b, t_f = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
        out[k] = (max(t_b, t_f), "bytes" if t_b >= t_f else "operations",
                  nbytes, flops)
    return out


def phase1(torch, fa):
    """Each kernel against its plain version, then timed at the slice
    shape; returns (errors, times, library times, device times, library
    device times, bounds) by kernel."""
    g = torch.Generator(device="cuda").manual_seed(0)
    B, T, H, D = SLICE["B"], SLICE["T"], SLICE["H"], SLICE["D"]
    cases = [  # B, H, D, Tq, Tk, causal, dtype, q/k/v as fused-qkv views
        (B, H, D, T, T, True, "bfloat16", False),
        (B, H, D, T, T, True, "float32", False),
        (B, H, D, T, T, False, "bfloat16", False),
        (B, H, D, 64, T, True, "bfloat16", False),
        (B, H, D, T, T, True, "bfloat16", True),
        (2, 4, 32, T, T, True, "bfloat16", False),
        (2, 4, 40, 65, 65, False, "bfloat16", False),
        (2, 4, 128, T, T, True, "bfloat16", False),
        (2, 4, 128, 64, T, True, "float32", False)]
    errs = {k: 0.0 for k in KERNELS}
    slice_inputs = None
    for Bc, Hc, Dc, Tq, Tk, causal, dname, fused in cases:
        dt = getattr(torch, dname)
        if fused:   # the model's q, k, v: per-head views of one projection,
            #         and the gradient taken through such views
            qkv = torch.randn(Bc, Tq, 3 * Hc * Dc, device="cuda",
                              generator=g).to(dt)
            leaf = qkv.clone().requires_grad_()
            q, k, v = (x.reshape(Bc, Tq, Hc, Dc)
                       for x in qkv.split(Hc * Dc, dim=-1))
            views = [x.reshape(Bc, Tq, Hc, Dc)
                     for x in leaf.split(Hc * Dc, dim=-1)]
            do = torch.randn(Bc, Tq, Hc, Dc, device="cuda",
                             generator=g).to(dt)
        else:
            q, k, v, do = (torch.randn(Bc, t, Hc, Dc, device="cuda",
                                       generator=g).to(dt)
                           for t in (Tq, Tk, Tk, Tq))
            views = [x.clone().requires_grad_() for x in (q, k, v)]
        o = fa.flash_attention(*views, causal=causal)
        o.backward(do)
        if fused:
            grads = [x.reshape(Bc, Tq, Hc, Dc)
                     for x in leaf.grad.split(Hc * Dc, dim=-1)]
        else:
            grads = [x.grad for x in views]
        _o2, lse = fa.flash_fwd(q, k, v, causal=causal)
        op, lp = fa.flash_fwd_plain(q, k, v, causal=causal)
        delta = (do.float() * op.float()).sum(-1).transpose(1, 2).contiguous()
        dqp = fa.flash_bwd_dq_plain(q, k, v, do, lp, delta, causal=causal)
        dkp, dvp = fa.flash_bwd_dkv_plain(q, k, v, do, lp, delta,
                                          causal=causal)
        torch.cuda.synchronize()
        pairs = {"fwd": [(o, op), (lse, lp)], "dq": [(grads[0], dqp)],
                 "dkv": [(grads[1], dkp), (grads[2], dvp)]}
        what = (f"{dname} B={Bc} H={Hc} D={Dc} Tq={Tq} Tk={Tk} "
                f"causal={causal}" + (" fused-qkv views" if fused else ""))
        line = []
        for kname, pp in pairs.items():
            for got, want in pp:
                if not bool(torch.isfinite(got).all()):
                    fail(f"{kname} {what}: non-finite output")
                diff = (got.float() - want.float()).abs()
                err = diff.max().item()
                scale = want.float().abs().max().item()
                # per element |got - want| <= tol + tol * |want|: one bf16
                # ulp is 0.031 for values in [4, 8)
                bad = diff > TOL[dname] * (1 + want.float().abs())
                if bool(bad.any()):
                    fail(f"{kname} {what}: {int(bad.sum())} elements beyond "
                         f"atol = rtol = {TOL[dname]} (max abs err {err})")
                errs[kname] = max(errs[kname], err)
                line.append(f"{kname} {err:.3e} (|ref| {scale:.3e})")
        print(f"[phase1] {what}: " + ", ".join(line), flush=True)
        if slice_inputs is None:
            slice_inputs = (q, k, v, do, lp, delta)

    q, k, v, do, lse, delta = slice_inputs
    kw = dict(causal=True)
    calls = {
        "fwd": (lambda: fa.flash_fwd(q, k, v, **kw),
                lambda: fa.flash_fwd_plain(q, k, v, **kw)),
        "dq": (lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
               lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw)),
        "dkv": (lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw),
                lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                               **kw)),
    }
    times = {kname: (time_ms(kern, 50), time_ms(plain, 10))
             for kname, (kern, plain) in calls.items()}
    # yardstick: PyTorch's fused attention on the same values, [B, H, T, D]
    F = torch.nn.functional
    ql, kl, vl = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dol = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)

    def fwd_bwd():
        torch.autograd.grad(sdpa(), (ql, kl, vl), dol)

    sdpa_fwd = time_ms(sdpa, 50)
    sdpa_bwd = time_ms(fwd_bwd, 50) - sdpa_fwd
    library = {"fwd": sdpa_fwd, "dq": sdpa_bwd, "dkv": sdpa_bwd}

    # device time per launch, each in a profiler window of its own; SDPA's
    # backward is the sum of its kernels, which compute dQ, dK, dV together
    dev = {}
    for kname, (kern, _plain) in calls.items():
        dev[kname], seen = device_ms(torch, kern, PROFILE_REPS,
                                     {KERNELS[kname][2]: 1})
        print(f"[phase1] device time {KERNELS[kname][0]}: "
              f"{shown(dev[kname])} ms per launch ({seen})", flush=True)
    out = sdpa()
    lib_fwd, seen_f = device_ms(torch, sdpa, PROFILE_REPS)
    lib_bwd, seen_b = device_ms(torch, lambda: torch.autograd.grad(
        out, (ql, kl, vl), dol, retain_graph=True), PROFILE_REPS)
    print(f"[phase1] device time SDPA forward: {shown(lib_fwd)} ms per call "
          f"({seen_f})", flush=True)
    print(f"[phase1] device time SDPA backward: {shown(lib_bwd)} ms per call "
          f"({seen_b})", flush=True)
    library_dev = {"fwd": lib_fwd, "dq": lib_bwd, "dkv": lib_bwd}

    bnd = bounds(SLICE["B"], SLICE["T"], SLICE["T"], SLICE["H"],
                 SLICE["D"], True, "bfloat16")
    for kname, (ms, plain) in times.items():
        print(f"[phase1] {KERNELS[kname][0]} at B8 T511 H8 D64 bf16 causal: "
              f"kernel_ms {ms:.4f} device_ms {shown(dev[kname])} plain_ms "
              f"{plain:.4f} library_ms {library[kname]:.4f} "
              f"library_device_ms {shown(library_dev[kname])} bound_ms "
              f"{bnd[kname][0]:.4f} ({bnd[kname][1]}: {bnd[kname][2]} bytes, "
              f"{bnd[kname][3]} flops)", flush=True)
    return errs, times, library, dev, library_dev, bnd


def phase1_d32(torch, fa):
    """The flash kernels at phase 8a's attention shape (``train_transformer``'s
    defaults: B 4 per microbatch, H 8, T 512, D 32, bf16, causal; D 32
    runs the tensor-core kernels padded to 32): each against its plain
    version, then device time per launch beside SDPA's and the bound.
    Returns {kernel: numbers} for the kernels line."""
    B, T, H, D = D32["B"], D32["T"], D32["H"], D32["D"]
    g = torch.Generator(device="cuda").manual_seed(32)
    q, k, v, do = (torch.randn(B, T, H, D, device="cuda", generator=g)
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_fwd(q, k, v, causal=True)
    op, lp = fa.flash_fwd_plain(q, k, v, causal=True)
    delta = (do.float() * op.float()).sum(-1).transpose(1, 2).contiguous()
    got = {"fwd": [(o, op), (lse, lp)],
           "dq": [(fa.flash_bwd_dq(q, k, v, do, lp, delta, causal=True),
                   fa.flash_bwd_dq_plain(q, k, v, do, lp, delta,
                                         causal=True))],
           "dkv": list(zip(fa.flash_bwd_dkv(q, k, v, do, lp, delta,
                                            causal=True),
                           fa.flash_bwd_dkv_plain(q, k, v, do, lp, delta,
                                                  causal=True)))}
    out = {}
    for kname, pairs in got.items():
        err = 0.0
        for a, b in pairs:
            diff = (a.float() - b.float()).abs()
            if bool((diff > TOL["bfloat16"] * (1 + b.float().abs())).any()):
                fail(f"{kname} at D32's shape: beyond {TOL['bfloat16']} "
                     f"(max abs err {diff.max().item()})")
            err = max(err, diff.max().item())
        out[kname] = {"max_abs_err": err}
    calls = {
        "fwd": lambda: fa.flash_fwd(q, k, v, causal=True),
        "dq": lambda: fa.flash_bwd_dq(q, k, v, do, lp, delta, causal=True),
        "dkv": lambda: fa.flash_bwd_dkv(q, k, v, do, lp, delta, causal=True),
    }
    F = torch.nn.functional
    ql, kl, vl = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dol = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)

    sdpa_out = sdpa()
    lib_fwd, _ = device_ms(torch, sdpa, PROFILE_REPS)
    lib_bwd, _ = device_ms(torch, lambda: torch.autograd.grad(
        sdpa_out, (ql, kl, vl), dol, retain_graph=True), PROFILE_REPS)
    # SDPA's backward (dQ, dK, dV in one call) as phase1 times it
    lib_ms = time_ms(sdpa, 50)
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
        sdpa(), (ql, kl, vl), dol), 50) - lib_ms
    lib = {"fwd": (lib_ms, lib_fwd), "dq": (lib_bwd_ms, lib_bwd),
           "dkv": (lib_bwd_ms, lib_bwd)}
    bnd = bounds(B, T, T, H, D, True, "bfloat16")
    for kname, fn in calls.items():
        dev, _ = device_ms(torch, fn, PROFILE_REPS, {KERNELS[kname][2]: 1})
        out[kname].update(
            device_ms=dev, kernel_ms=time_ms(fn, 50), bound_ms=bnd[kname][0],
            bound_by=bnd[kname][1], library_ms=lib[kname][0],
            library_device_ms=lib[kname][1])
        r = out[kname]
        print(f"[phase1] {KERNELS[kname][0]} at B{B} T{T} H{H} D{D} bf16 "
              f"causal: max_abs_err {r['max_abs_err']:.3e} kernel_ms "
              f"{r['kernel_ms']:.4f} device_ms {shown(dev)} library_ms "
              f"{shown(lib[kname][0])} library_device_ms "
              f"{shown(lib[kname][1])} bound_ms {bnd[kname][0]:.4f} "
              f"({bnd[kname][1]}: {bnd[kname][2]} bytes, {bnd[kname][3]} "
              f"flops)", flush=True)
    return out


def phase2(torch, np, fa):
    """Train the 59M transformer for STEPS rounds through the kernels."""
    import geomx_tpu_torch as gx
    from geomx_tpu_torch.examples.transformer_bsc_device import (
        build_transformer_grad_step, synth_batch)
    from geomx_tpu_torch.trainer_device import DeviceResidentTrainer

    t0 = time.perf_counter()
    leaves, grad_step = build_transformer_grad_step(
        **MODEL, compute_dtype=torch.bfloat16, device="cuda", attn="auto")
    n_params = sum(l.size for l in leaves)
    tr = DeviceResidentTrainer(leaves, gx.kv.create("local"), grad_step,
                               threshold=0.01, learning_rate=0.05,
                               momentum=0.9, device="cuda")
    rng = np.random.default_rng(1234)
    batches = [synth_batch(rng, BATCH, MODEL["seq_len"], MODEL["vocab"])
               for _ in range(STEPS + 1)]
    tr.warmup(batches[0], None)
    print(f"[phase2] {n_params} params ({n_params / 1e6:.1f}M), selection "
          f"{tr.k} of {tr.total}, set-up + warmup "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    for key in fa.LAUNCHES:
        fa.LAUNCHES[key] = 0
    losses, step_ms, per_step = [], [], []
    for toks in batches[:STEPS]:
        before = dict(fa.LAUNCHES)
        t = time.perf_counter()
        losses.append(tr.step(toks, None))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        per_step.append({k: fa.LAUNCHES[k] - before[k] for k in before})
    before = dict(fa.LAUNCHES)
    loss_t, phases = tr.step_timed(batches[STEPS], None)
    per_step.append({k: fa.LAUNCHES[k] - before[k] for k in before})
    launches = dict(fa.LAUNCHES)

    losses.append(loss_t)
    print(f"[phase2] losses {losses}", flush=True)
    print(f"[phase2] step_ms {[round(s, 3) for s in step_ms]}", flush=True)
    print(f"[phase2] step_timed phases_ms "
          f"{ {k: round(v, 3) for k, v in phases.items()} }", flush=True)
    print(f"[phase2] launches per step {per_step}", flush=True)
    if not all(math.isfinite(l) for l in losses):
        fail(f"non-finite loss: {losses}")
    for i, counts in enumerate(per_step):
        if any(c != MODEL["depth"] for c in counts.values()):
            fail(f"step {i + 1}: kernel launches {counts}, expected "
                 f"{MODEL['depth']} of each (one per block)")
    if not all(np.isfinite(l).all() for l in tr.leaves):
        fail("non-finite parameters after training")

    # step 1's loss again, attention through the plain version on the card
    def plain_attn(q, k, v):
        return fa.flash_fwd_plain(q, k, v, causal=True)[0]

    _, plain_step = build_transformer_grad_step(
        **MODEL, compute_dtype=torch.bfloat16, device="cuda",
        attn=plain_attn, init_leaves=leaves)
    with torch.no_grad():
        ref = [torch.as_tensor(l, device="cuda") for l in leaves]
    ref_loss = float(plain_step(ref, torch.as_tensor(batches[0],
                                                     device="cuda"), None)[0])
    rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    print(f"[phase2] step-1 loss {losses[0]:.6f} vs plain attention "
          f"{ref_loss:.6f}: rel diff {rel:.3e}", flush=True)
    if rel > 2e-2:
        fail(f"step-1 loss differs from the plain-attention run by {rel}")
    profile_round(torch, lambda: tr.step_timed(batches[0], None)[1],
                  "profile", MODEL["depth"])
    return launches, n_params


def profile_round(torch, run, tag, tc_launches):
    """One more round under torch.profiler: device time by kernel and the
    device's busy share of the round (profiler overhead included), and a
    check that each tensor-core flash kernel ran ``tc_launches`` times.
    ``run()`` drives the round and returns its phase split in ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        phases = run()
        wall = (time.perf_counter() - t) * 1e3
    counts = profile_summary(prof.key_averages(), wall, phases, tag)
    for tc in TC_KERNELS:
        if counts is not None and counts[tc] != tc_launches:
            fail(f"{tag}: {tc} ran {counts[tc]} times in the round, "
                 f"expected {tc_launches}: the bf16 path must run the "
                 "tensor-core kernels")


def profile_summary(events, wall, phases, tag):
    """Print a profiled round's device busy share and largest kernels;
    returns the launches of each tensor-core flash kernel (None when the
    profiler saw no device time)."""
    rows = sorted(device_rows(events), reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        print(f"[{tag}] device time not measured: the profiler saw no "
              "device activity", flush=True)
        return None
    print(f"[{tag}] round wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / wall:.1f}%), phases "
          f"{ {k: round(v, 3) for k, v in phases.items()} }", flush=True)
    for ms, n, name in rows[:15]:
        print(f"[{tag}] {ms:9.3f} ms {100 * ms / busy:5.1f}% x{n:<5d} "
              f"{name[:100]}", flush=True)
    counts = {}
    for tc in TC_KERNELS:
        ms = sum(r[0] for r in rows if tc in r[2])
        counts[tc] = n = sum(r[1] for r in rows if tc in r[2])
        print(f"[{tag}] {tc}: {n} launches, {ms:.3f} ms", flush=True)
    return counts


def two_bit_bound(n):
    """(bound_ms, bytes) of the fused 2-bit quantize over n elements:
    bytes bound it, it does no tensor-core work."""
    nbytes = TWO_BIT_BYTES * n
    return nbytes / PEAK_BYTES * 1e3, nbytes


def phase3a(torch, tb, pmesh, n_params):
    """The 2-bit kernel against its plain version, bit for bit, then
    timed; returns (ms, plain ms, device ms, bound ms) at the ring's
    full-width shape."""
    g = torch.Generator(device="cuda").manual_seed(3)

    def check(what, got, want):
        for a, b in zip(got, want):
            if not torch.equal(a, b):
                fail(f"two_bit {what}: kernel != plain version "
                     f"({int((a != b).sum())} elements differ)")

    for n in (1, 3, 4, 1001, 1 << 20, n_params):
        grad = torch.randn(n, device="cuda", generator=g)
        res = torch.randn(n, device="cuda", generator=g) * 0.3
        for thr in (0.5, 0.01):
            check(f"n={n} thr={thr}", tb.two_bit_quantize(grad, res, thr),
                  tb.two_bit_quantize_plain(grad, res, thr))
        if n >= 1 << 20:
            bnd, nbytes = two_bit_bound(n)
            ms = time_ms(lambda: tb.two_bit_quantize(grad, res, 0.01), 50)
            plain = time_ms(lambda: tb.two_bit_quantize_plain(grad, res,
                                                              0.01), 10)
            print(f"[phase3a] two_bit n={n}: kernel_ms {ms:.4f} plain_ms "
                  f"{plain:.4f} library_ms none bound_ms {bnd:.4f} (bytes: "
                  f"{nbytes:.0f})", flush=True)
        del grad, res
    # the ring's form: (P, m) rows, residual slot in and out as strided
    # views of (P, P, m) state; m = 1001 takes the scalar path
    for P, m in ((3, 1001), (PARTY, pmesh.ring_chunk_layout(n_params, PARTY,
                                                            4)[0])):
        grad = torch.randn(P, m, device="cuda", generator=g)
        res = torch.randn(P, P, m, device="cuda", generator=g) * 0.3
        out = torch.empty_like(res)
        want = tb.two_bit_quantize_plain(grad, res[:, 1], PARTY_THRESHOLD)
        packed, _ = tb.two_bit_quantize(grad, res[:, 1], PARTY_THRESHOLD,
                                        out_residual=out[:, 1])
        check(f"rows {P}x{m} strided", (packed, out[:, 1]), want)

        def kernel():
            tb.two_bit_quantize(grad, res[:, 1], PARTY_THRESHOLD,
                                out_residual=out[:, 1])

        ms = time_ms(kernel, 50)
        dev, _ = device_ms(torch, kernel, PROFILE_REPS,
                           {"two_bit_kernel": 1})
        plain = time_ms(lambda: tb.two_bit_quantize_plain(
            grad, res[:, 1], PARTY_THRESHOLD), 10)
        bnd, nbytes = two_bit_bound(P * m)
        print(f"[phase3a] two_bit rows {P}x{m} strided (the ring's shape): "
              f"kernel_ms {ms:.4f} device_ms {shown(dev)} plain_ms "
              f"{plain:.4f} library_ms none bound_ms {bnd:.4f} (bytes: "
              f"{nbytes:.0f})", flush=True)
    print("[phase3a] two_bit: kernel == plain version bit for bit at n in "
          f"(1, 3, 4, 1001, 2^20, {n_params}), thr 0.5 / 0.01, and on "
          "strided rows", flush=True)
    return ms, plain, dev, bnd


def phase3b(torch, np, qc, pmesh):
    """bench.py's bench_mesh_quant on the card: a 2-rank party, 2^20
    elements, every codec; the card's ring against its CPU replay."""
    n, reps = 1 << 20, 30
    card, host = (pmesh.make_party_mesh(2, device=d) for d in ("cuda", "cpu"))
    g_stack = torch.as_tensor(
        np.random.RandomState(0).randn(2, n).astype(np.float32),
        device="cuda")
    codecs = {}
    for codec in MESH_CODECS:
        red = qc.QuantRingReducer(card, codec, n, mean=True)
        red.reduce(g_stack)
        torch.cuda.synchronize()
        samples = []
        for _ in range(reps):
            t0 = time.perf_counter()
            red.reduce(g_stack)
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e3)
        codecs[codec] = {"mesh_bytes_per_round": red.wire_bytes_per_round(),
                         "intra_party_ms": float(np.median(samples))}
        # 3 rounds with the residual carried, card against CPU tensors
        reds = [qc.QuantRingReducer(m, codec, n, mean=True)
                for m in (card, host)]
        rng = np.random.RandomState(1)
        for rnd in range(3):
            xs = torch.as_tensor(rng.randn(2, n).astype(np.float32))
            y_card = reds[0].reduce(xs.cuda())
            y_host = reds[1].reduce(xs)
            if not all(torch.equal(y_card[r], y_card[0]) for r in range(2)):
                fail(f"ring {codec} round {rnd}: rank rows differ")
            if not torch.equal(y_card.cpu(), y_host) or not torch.equal(
                    reds[0]._res.cpu(), reds[1]._res):
                fail(f"ring {codec} round {rnd}: card != CPU replay")
        print(f"[phase3b] {codec}: {codecs[codec]}; card == CPU replay bit "
              "for bit over 3 rounds, rank rows identical", flush=True)
    fp32 = codecs["none"]["mesh_bytes_per_round"]
    red_int8 = fp32 / codecs["int8"]["mesh_bytes_per_round"]
    red_2bit = fp32 / codecs["2bit"]["mesh_bytes_per_round"]
    print(f"[phase3b] reduction vs fp32: int8 {red_int8:.2f}x, 2bit "
          f"{red_2bit:.2f}x", flush=True)
    if red_int8 < 3.5 or red_2bit < 14.0:
        fail(f"byte gates: int8 {red_int8} < 3.5 or 2bit {red_2bit} < 14")


def mesh_quant_parity(torch, np, qc, pmesh, codec, rounds=200, d=512,
                      n_samples=256, lr=0.1, ranks=4):
    """bench.py's _mesh_quant_parity through the ring on the card: 4-rank
    linear regression, the ranks' local-shard gradients reduced (mean),
    SGD on the replicated output; returns the final mean squared error."""
    red = qc.QuantRingReducer(pmesh.make_party_mesh(ranks, device="cuda"),
                              codec, d, mean=True, threshold=0.01)
    w_true = (np.random.RandomState(7).randn(d)
              / np.sqrt(d)).astype(np.float32)
    rng = np.random.RandomState(42)
    X = rng.randn(n_samples, d).astype(np.float32)
    y = X @ w_true
    per = n_samples // ranks
    Xs = X.reshape(ranks, per, d)
    ys = y.reshape(ranks, per)
    w = np.zeros(d, np.float32)
    for _ in range(rounds):
        g = np.stack([(2.0 / per) * Xs[r].T @ (Xs[r] @ w - ys[r])
                      for r in range(ranks)]).astype(np.float32)
        w -= lr * red.reduce(torch.as_tensor(g, device="cuda"))[0].cpu().numpy()
    r = X @ w - y
    return float(np.mean(r * r))


def phase3c(torch, np, qc, pmesh):
    losses = {c: mesh_quant_parity(torch, np, qc, pmesh, c)
              for c in MESH_CODECS}
    delta = losses["int8"] - losses["none"]
    print(f"[phase3c] 200-round probe final loss {losses}; int8 - none "
          f"{delta:.3e} (tol {MESH_QUANT_PARITY_TOL})", flush=True)
    if not all(math.isfinite(v) for v in losses.values()):
        fail(f"non-finite probe loss: {losses}")
    if delta > MESH_QUANT_PARITY_TOL:
        fail(f"int8 probe loss {losses['int8']} not within "
             f"{MESH_QUANT_PARITY_TOL} of none's {losses['none']}")


def phase3d(torch, np, fa, tb, qc, pmesh):
    """The 59M transformer as a 2-rank party: local grads through the
    flash kernels, the flattened (2, N) gradient through one 2-bit ring
    (mean), SGD on the replicated parameters. Returns the two_bit
    launches of the STEPS counted steps, each step's mean loss over the
    ranks and the digest of the parameters after PHASE11["steps"] of
    them (phase 11b's reference)."""
    from geomx_tpu_torch.examples.transformer_bsc_device import synth_batch
    from geomx_tpu_torch.models.transformer import (Transformer,
                                                    make_attention)
    from geomx_tpu_torch.parallel.train_step import DataParallelTrainer

    t = time.perf_counter()
    mesh = pmesh.make_party_mesh(PARTY, device="cuda")
    model = Transformer(vocab=MODEL["vocab"], dim=MODEL["dim"],
                        depth=MODEL["depth"], heads=MODEL["heads"],
                        max_len=MODEL["seq_len"],
                        attn_fn=make_attention("auto"),
                        compute_dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(42))
    tr = DataParallelTrainer(model, torch.optim.SGD(model.parameters(),
                                                    lr=PARTY_LR),
                             mesh, num_classes=MODEL["vocab"])
    sizes = [p.numel() for p in tr.params]
    n = sum(sizes)
    rng = np.random.default_rng(4321)
    batches = [synth_batch(rng, BATCH, MODEL["seq_len"], MODEL["vocab"])
               for _ in range(STEPS + 1)]

    def step(toks, red):
        t0 = time.perf_counter()
        losses, grads = tr.local_grads(toks[:, :-1], toks[:, 1:])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        stack = torch.cat([g.reshape(PARTY, -1) for g in grads], dim=1)
        del grads
        out = red.reduce(stack)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for p, g in zip(tr.params, out[0].split(sizes)):
            p.grad = g.view(p.shape)
        tr.optimizer.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        ms = {"local_grads_ms": (t1 - t0) * 1e3, "ring_ms": (t2 - t1) * 1e3,
              "apply_ms": (t3 - t2) * 1e3}
        return losses.cpu().tolist(), ms, stack, out

    # warm-up on a throwaway reducer: the counted run starts at zero
    # residual, as its CPU replay does
    step(batches[STEPS], qc.QuantRingReducer(
        mesh, "2bit", n, mean=True, threshold=PARTY_THRESHOLD))
    red = qc.QuantRingReducer(mesh, "2bit", n, mean=True,
                              threshold=PARTY_THRESHOLD)
    print(f"[phase3d] {n} params, party of {PARTY} on one card, 2-bit "
          f"threshold {PARTY_THRESHOLD}, set-up + warm-up "
          f"{time.perf_counter() - t:.1f} s", flush=True)

    counters = [fa.LAUNCHES, tb.LAUNCHES]
    for c in counters:
        for key in c:
            c[key] = 0
    losses, per_step, launches = [], [], []
    first = digest11 = None
    for i, toks in enumerate(batches[:STEPS]):
        before = {k: v for c in counters for k, v in c.items()}
        loss, ms, stack, out = step(toks, red)
        if i + 1 == PHASE11["steps"]:
            digest11 = param_digest(tr.params)
        launches.append({k: v - before[k] for c in counters
                         for k, v in c.items()})
        losses.append(loss)
        per_step.append(ms)
        if first is None:
            same_rows = all(torch.equal(out[r], out[0]) for r in range(PARTY))
            first = (stack.cpu(), out.cpu(), same_rows)
        del stack, out
    total = dict(tb.LAUNCHES)

    print(f"[phase3d] per-rank losses {losses}", flush=True)
    for i, ms in enumerate(per_step):
        print(f"[phase3d] step {i + 1}: " + ", ".join(
            f"{k} {v:.3f}" for k, v in ms.items())
            + f", total_ms {sum(ms.values()):.3f}", flush=True)
    print(f"[phase3d] launches per step {launches}", flush=True)
    if not all(math.isfinite(v) for l in losses for v in l):
        fail(f"non-finite loss: {losses}")
    want = {"two_bit": 2, **{k: PARTY * MODEL["depth"] for k in KERNELS}}
    for i, counts in enumerate(launches):
        if counts != want:
            fail(f"step {i + 1}: kernel launches {counts}, expected {want}")
    if not all(bool(torch.isfinite(p).all()) for p in tr.params):
        fail("non-finite parameters after training")

    stack, out, same_rows = first
    share = float((out[0] != 0).to(torch.float64).mean())
    replay = qc.QuantRingReducer(pmesh.make_party_mesh(PARTY, device="cpu"),
                                 "2bit", n, mean=True,
                                 threshold=PARTY_THRESHOLD)
    if not same_rows:
        fail("step 1: the ranks' rows of the ring output differ")
    if not torch.equal(replay.reduce(stack), out):
        fail("step 1: the ring on the card != its CPU replay")
    print(f"[phase3d] step 1: ring output == CPU replay of the same "
          f"({PARTY}, {n}) stack bit for bit, rank rows identical; nonzero "
          f"2-bit codes {100 * share:.2f}%", flush=True)
    if share < 0.01:
        fail(f"threshold {PARTY_THRESHOLD} codes only {share} of step 1")
    profile_round(torch, lambda: step(batches[0], red)[1], "phase3d profile",
                  PARTY * MODEL["depth"])
    return total["two_bit"], [float(np.mean(l)) for l in losses], digest11


def param_digest(params):
    """The first 16 hex digits of the sha256 of the parameters' float32
    bytes."""
    return hashlib.sha256(b"".join(p.detach().float().cpu().numpy().tobytes()
                                   for p in params)).hexdigest()[:16]


def medians(timed):
    """Per-phase medians (ms) of a list of ``step_timed`` splits."""
    return {k: round(statistics.median(t[k] for t in timed), 3)
            for k in timed[0]}


def reset(counters):
    for c in counters:
        for key in c:
            c[key] = 0


def init_keys(np, leaves0):
    """The master's part when the phase drives the trainers itself: init
    every key from ``leaves0``."""
    def master(kv):
        for i, leaf in enumerate(leaves0):
            kv.init(i, np.array(leaf))
        kv.wait()
    return master


def run_hips(worker, master, tag, barriers=(), main_fn=None, topo_kw=None):
    """Start a live two-party HiPS (one worker per party unless
    ``topo_kw`` says otherwise, all roles on
    threads of this process, every byte over loopback sockets, topology
    options ``topo_kw``), run ``master(kv)`` on the master worker, then
    ``worker(kv, widx)`` on both party workers at once (``main_fn()`` on
    this thread meanwhile) and stop the topology. The master's settings
    and init reach the global tier before any party pulls the initial
    values (ROADMAP queue C item 1). A failure in either worker breaks
    ``barriers`` and fails the phase; a hung worker fails it after
    JOIN_S."""
    from geomx_tpu_torch.simulate import InProcessHiPS

    t = time.perf_counter()
    topo = InProcessHiPS(**{"num_parties": 2, "workers_per_party": 1,
                            **(topo_kw or {})}).start()
    errors = []
    master_done = threading.Event()

    def master_fn(kv):
        try:
            master(kv)
        finally:
            master_done.set()

    def one(kv):
        try:
            if not master_done.wait(JOIN_S):
                raise TimeoutError("the master did not finish its set-up")
            worker(kv, topo.workers.index(kv))
        except BaseException:
            for b in barriers:
                b.abort()
            raise

    def body():
        try:
            topo.run_workers(one, include_master=master_fn,
                             timeout=JOIN_S)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)
            for b in barriers:
                b.abort()

    try:
        runner = threading.Thread(target=body, daemon=True)
        runner.start()
        main_err = None
        try:
            if main_fn is not None:
                main_fn()
        except BaseException as e:  # noqa: BLE001 — a worker's error first
            main_err = e
        runner.join(JOIN_S + 60)
        if errors:
            raise errors[0]
        if main_err is not None:
            raise main_err
        if runner.is_alive():
            fail(f"{tag}: the workers did not finish")
    finally:
        topo.stop()
    print(f"[{tag}] topology up, trained and down in "
          f"{time.perf_counter() - t:.1f} s", flush=True)


def check_replicas(np, leaves, tag):
    for a, b in zip(leaves[0], leaves[1]):
        if a.tobytes() != b.tobytes():
            fail(f"{tag}: the two workers' parameters differ (FSA lockstep "
                 "keeps them bit-identical)")
    if not all(np.isfinite(l).all() for l in leaves[0]):
        fail(f"{tag}: non-finite parameters")
    print(f"[{tag}] the two workers' {len(leaves[0])} parameter leaves are "
          "bit-identical and finite", flush=True)


def phase4a(torch, np, fa, tb):
    """The main path: LeNet through DeviceResidentTrainer over a live
    two-party HiPS with BSC (the pipelined round, GEOMX_OVERLAP's
    default), bench_hips_bsc's settings."""
    from geomx_tpu_torch import telemetry
    from geomx_tpu_torch.examples.utils import build_model_and_step, eval_acc
    from geomx_tpu_torch.io import load_data
    from geomx_tpu_torch.trainer_device import DeviceResidentTrainer

    B, R = LENET["batch"], LENET["rounds"]
    telemetry.enable(True)
    leaves0, _names, grad_step, eval_step = build_model_and_step(
        B, device="cuda")
    warm = threading.Lock()
    bar = threading.Barrier(2)
    res, wan, counts = {}, {}, {}

    def worker(kv, w):
        tr = DeviceResidentTrainer(
            list(leaves0), kv, grad_step, threshold=LENET["threshold"],
            learning_rate=LENET["lr"], momentum=0.0, device="cuda")
        train_iter, test_iter, _, _ = load_data(B, 2, w)
        batches = [(torch.as_tensor(X, device="cuda"),
                    torch.as_tensor(y, device="cuda"))
                   for X, y in train_iter]
        with warm:          # no kv round inside: it would wait on the peer
            tr.warmup(*batches[0])
        bar.wait(JOIN_S)
        if w == 0:
            reset([fa.LAUNCHES, tb.LAUNCHES])
        bar.wait(JOIN_S)
        for it in range(R):
            tr.step(*batches[it % len(batches)])
        bar.wait(JOIN_S)
        if w == 0:
            counts.update(fa.LAUNCHES, **tb.LAUNCHES)
        trained = tr.leaves
        acc = eval_acc(test_iter, trained, eval_step, device="cuda")
        digest = hashlib.sha256(b"".join(l.tobytes() for l in trained))
        timed = [tr.step_timed(*batches[j % len(batches)])[1]
                 for j in range(LENET["timed"])]
        bar.wait(JOIN_S)
        if w == 0:
            wan[0] = telemetry.wan_bytes()
        bar.wait(JOIN_S)
        t0 = time.perf_counter()
        for i in range(LENET["thr_rounds"]):
            tr.step(*batches[i % len(batches)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        bar.wait(JOIN_S)
        if w == 0:
            wan[1] = telemetry.wan_bytes()
        res[w] = dict(acc=acc, digest=digest.hexdigest()[:16], timed=timed,
                      wall=wall, leaves=tr.leaves,
                      pipelined=tr.pipelined, batches=len(batches))

    run_hips(worker, init_keys(np, leaves0), "phase4a", barriers=[bar])
    img_s = LENET["thr_rounds"] * B * 2 / max(r["wall"] for r in res.values())
    wan_round = (wan[1] - wan[0]) / LENET["thr_rounds"]
    print(f"[phase4a] LeNet, 2 parties x 1 worker, {B} images per worker, "
          f"BSC threshold {LENET['threshold']}, lr {LENET['lr']}, pipelined "
          f"round {res[0]['pipelined']}, {res[0]['batches']} batches per "
          f"worker on the card", flush=True)
    print(f"[phase4a] test accuracy after {R} rounds: worker 0 "
          f"{res[0]['acc']:.4f}, worker 1 {res[1]['acc']:.4f}; leaves "
          f"sha256 {res[0]['digest']} / {res[1]['digest']} (cuDNN fp32, "
          "deterministic: the same on every run)", flush=True)
    print(f"[phase4a] launches in the {R} rounds (LeNet runs no kernel of "
          f"the port: cuDNN convolutions, torch.topk) {counts}", flush=True)
    print(f"[phase4a] {img_s:.1f} img/s over {LENET['thr_rounds']} rounds "
          f"(both workers), {wan_round:.1f} WAN bytes per round", flush=True)
    for w in (0, 1):
        print(f"[phase4a] worker {w} step_timed medians of "
              f"{LENET['timed']} rounds (ms) {medians(res[w]['timed'])}",
              flush=True)
    for w in (0, 1):
        if res[w]["acc"] < 1.0 - PARITY_TOL_BSC:
            fail(f"phase4a: worker {w} accuracy {res[w]['acc']} < "
                 f"{1.0 - PARITY_TOL_BSC}")
    if not res[0]["pipelined"]:
        fail("phase4a: the HiPS store did not take the pipelined round")
    check_replicas(np, [res[0]["leaves"], res[1]["leaves"]], "phase4a")
    return {"img_s": img_s, "wan_bytes_per_round": wan_round,
            "acc": [res[0]["acc"], res[1]["acc"]],
            "wire_ms": [medians(res[w]["timed"])["wire_ms"] for w in (0, 1)],
            "step_timed": [medians(res[w]["timed"]) for w in (0, 1)]}


def host_spans(profiler, rounds=1, top=10):
    """The host profiler's ``top`` largest aggregate spans, ms per round
    (thread-ms summed over every role's threads), digits of a name folded
    into N (key and chunk numbers merged)."""
    spans = {}
    for name, us in profiler.aggregate_stats().items():
        name = "".join("N" if c.isdigit() else c for c in name)
        spans[name] = spans.get(name, 0.0) + us / 1e3 / rounds
    return sorted(spans.items(), key=lambda kv: -kv[1])[:top]


def phase4b(torch, np, fa, tb):
    """The 59M transformer over the same live HiPS (bench_transformer_bsc's
    settings): losses, launches, the step_timed split with the pipelined
    round and with the serial round, one profiled round. Returns the
    flash launches of the counted rounds."""
    from torch.profiler import ProfilerActivity, profile

    from geomx_tpu_torch.examples.transformer_bsc_device import (
        build_transformer_grad_step, synth_batch)
    from geomx_tpu_torch.trainer_device import DeviceResidentTrainer

    R = HIPS_TF["rounds"]
    leaves0, grad_step = build_transformer_grad_step(
        **MODEL, compute_dtype=torch.bfloat16, device="cuda", attn="auto")
    warm = threading.Lock()
    bar = threading.Barrier(2)
    bar3 = threading.Barrier(3)     # the two workers and this thread
    res, counts, prof = {}, {}, {}

    def worker(kv, w):
        tr = DeviceResidentTrainer(
            list(leaves0), kv, grad_step, threshold=HIPS_TF["threshold"],
            learning_rate=HIPS_TF["lr"], momentum=HIPS_TF["momentum"],
            device="cuda")
        rng = np.random.default_rng(1234 + w)
        batches = [torch.as_tensor(synth_batch(rng, BATCH, MODEL["seq_len"],
                                               MODEL["vocab"]), device="cuda")
                   for _ in range(HIPS_TF["batches"])]
        with warm:          # no kv round inside: it would wait on the peer
            tr.warmup(batches[0], None)
        bar.wait(JOIN_S)
        if w == 0:
            reset([fa.LAUNCHES, tb.LAUNCHES])
        bar.wait(JOIN_S)
        t0 = time.perf_counter()
        losses = [tr.step(batches[it % len(batches)], None)
                  for it in range(R)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        bar.wait(JOIN_S)
        if w == 0:
            counts.update(fa.LAUNCHES, **tb.LAUNCHES)
        on = [tr.step_timed(batches[j % len(batches)], None)[1]
              for j in range(HIPS_TF["timed"])]
        tr.pipelined = False        # the serial round: the same state
        off = [tr.step_timed(batches[j % len(batches)], None)[1]
               for j in range(HIPS_TF["timed"])]
        # round wall times, pipelined and serial in turns
        walls = {True: [], False: []}
        for _ in range(HIPS_TF["alternations"]):
            for mode in (True, False, False, True):
                tr.pipelined = mode
                t0 = time.perf_counter()
                tr.step(batches[0], None)
                torch.cuda.synchronize()
                walls[mode].append((time.perf_counter() - t0) * 1e3)
        tr.pipelined = True
        bar3.wait(JOIN_S)           # this thread starts the profiler
        bar3.wait(JOIN_S)
        phases = tr.step_timed(batches[0], None)[1]
        if w == 0:
            prof["phases"] = phases
        bar3.wait(JOIN_S)           # this thread stops it
        res[w] = dict(losses=losses, wall=wall, on=on, off=off,
                      walls=walls,
                      leaves=tr.leaves, k=tr.k, total=tr.total,
                      chunks=len(tr._chunks))

    def profile_one_round():
        """One round of both workers under torch.profiler and the host
        profiler (spans of every role), started and stopped on this (the
        main) thread."""
        from geomx_tpu_torch import profiler as hostprof
        from geomx_tpu_torch import telemetry

        telemetry.enable(True)
        bar3.wait(JOIN_S)
        hostprof.reset()
        hostprof.set_config(aggregate_stats=True)
        wan0 = telemetry.wan_bytes()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            t = time.perf_counter()
            hostprof.set_state("run")
            bar3.wait(JOIN_S)
            bar3.wait(JOIN_S)
            hostprof.set_state("stop")
            prof["wall"] = (time.perf_counter() - t) * 1e3
        prof["p"] = p
        prof["wan"] = telemetry.wan_bytes() - wan0
        prof["host"] = host_spans(hostprof)
        hostprof.reset()

    run_hips(worker, init_keys(np, leaves0), "phase4b",
             barriers=[bar, bar3], main_fn=profile_one_round)
    tok_s = R * BATCH * MODEL["seq_len"] * 2 / max(r["wall"]
                                                   for r in res.values())
    print(f"[phase4b] 59M transformer over 2 parties x 1 worker: "
          f"{res[0]['total']} params, selection {res[0]['k']} per worker, "
          f"{res[0]['chunks']} chunk(s) per pipelined round", flush=True)
    for w in (0, 1):
        print(f"[phase4b] worker {w} losses {res[w]['losses']}", flush=True)
    print(f"[phase4b] {tok_s:.0f} tokens/s over {R} rounds (both workers)",
          flush=True)
    for w in (0, 1):
        ws = res[w]["walls"]
        print(f"[phase4b] worker {w} round wall ms, in turns: pipelined "
              f"{[round(x, 3) for x in ws[True]]} (median "
              f"{statistics.median(ws[True]):.3f}), serial "
              f"{[round(x, 3) for x in ws[False]]} (median "
              f"{statistics.median(ws[False]):.3f})", flush=True)
    print(f"[phase4b] {prof['wan']:.1f} WAN bytes in the profiled round",
          flush=True)
    print("[phase4b] host spans of the profiled round (thread-ms summed "
          "over every role's threads, key and chunk numbers merged): "
          + ", ".join(f"{k} {v:.1f}" for k, v in prof["host"]), flush=True)
    print(f"[phase4b] launches in the {R} counted rounds {counts}",
          flush=True)
    for w in (0, 1):
        print(f"[phase4b] worker {w} step_timed medians of "
              f"{HIPS_TF['timed']} rounds (ms), pipelined "
              f"{medians(res[w]['on'])}, serial {medians(res[w]['off'])}",
              flush=True)
    tc = profile_summary(prof["p"].key_averages(), prof["wall"],
                         prof["phases"], "phase4b profile")
    for w in (0, 1):
        l = res[w]["losses"]
        if not all(math.isfinite(x) for x in l):
            fail(f"phase4b: worker {w} non-finite loss {l}")
        if not sum(l[-5:]) / 5 < l[0]:
            fail(f"phase4b: worker {w} loss did not decline: {l}")
    want = 2 * MODEL["depth"] * R
    for key in KERNELS:
        if counts[key] != want:
            fail(f"phase4b: {key} launched {counts[key]} times in {R} "
                 f"rounds of 2 workers, expected {want} (8 per step per "
                 "worker)")
    if fa.route(torch.bfloat16, MODEL["dim"] // MODEL["heads"]) == 0:
        fail("phase4b: bf16 does not route to the tensor-core kernels")
    if tc is not None:
        for name, n in tc.items():
            # the profiler window holds both workers' rounds
            if n != 2 * MODEL["depth"]:
                fail(f"phase4b profile: {name} ran {n} times in the "
                     f"round, expected {MODEL['depth']} per worker")
    check_replicas(np, [res[0]["leaves"], res[1]["leaves"]], "phase4b")
    dense = {"wan": prof["wan"],
             "wire_ms": [medians(res[w]["on"])["wire_ms"] for w in (0, 1)]}
    return counts, dense


def phase4b_bsc(torch, np, dense, dev="cuda"):
    """4b's variant with BSC on the global tier, as ``cnn_bsc.py`` sets
    it (``set_gradient_compression``, threshold 0.01): one round through
    the new wire, then HIPS_TF["bsc_rounds"] counted ``step_timed``
    rounds with the host profiler on; WAN bytes, the wire split beside
    the dense rounds' and the host spans that hold the round."""
    from geomx_tpu_torch import profiler as hostprof
    from geomx_tpu_torch import telemetry
    from geomx_tpu_torch.examples.transformer_bsc_device import (
        build_transformer_grad_step, synth_batch)
    from geomx_tpu_torch.trainer_device import DeviceResidentTrainer

    R = HIPS_TF["bsc_rounds"]
    leaves0, grad_step = build_transformer_grad_step(
        **MODEL, compute_dtype=torch.bfloat16, device=dev, attn="auto")
    warm = threading.Lock()
    bar = threading.Barrier(2)
    res, wan, spans = {}, {}, []

    def master(kv):
        kv.set_gradient_compression({"type": "bsc",
                                     "threshold": HIPS_TF["threshold"]})
        init_keys(np, leaves0)(kv)

    def worker(kv, w):
        tr = DeviceResidentTrainer(
            list(leaves0), kv, grad_step, threshold=HIPS_TF["threshold"],
            learning_rate=HIPS_TF["lr"], momentum=HIPS_TF["momentum"],
            device=dev)
        rng = np.random.default_rng(1234 + w)
        batches = [torch.as_tensor(synth_batch(rng, BATCH, MODEL["seq_len"],
                                               MODEL["vocab"]), device=dev)
                   for _ in range(HIPS_TF["batches"])]
        with warm:          # no kv round inside: it would wait on the peer
            tr.warmup(batches[0], None)
        first = tr.step(batches[0], None)
        bar.wait(JOIN_S)
        if w == 0:
            telemetry.enable(True)
            wan[0] = telemetry.wan_bytes()
            hostprof.reset()
            hostprof.set_config(aggregate_stats=True)
            hostprof.set_state("run")
        bar.wait(JOIN_S)
        timed = [tr.step_timed(batches[j % len(batches)], None)
                 for j in range(R)]
        bar.wait(JOIN_S)
        if w == 0:
            hostprof.set_state("stop")
            wan[1] = telemetry.wan_bytes()
            spans.extend(host_spans(hostprof))
            hostprof.reset()
        res[w] = dict(losses=[first] + [t[0] for t in timed],
                      phases=[t[1] for t in timed], leaves=tr.leaves)

    run_hips(worker, master, "phase4b-bsc", barriers=[bar])
    wan_round = (wan[1] - wan[0]) / R
    print(f"[phase4b-bsc] transformer of {sum(l.size for l in leaves0)} "
          f"params, BSC threshold {HIPS_TF['threshold']} on the global "
          f"tier: {wan_round:.1f} WAN "
          f"bytes per round over {R} rounds ({100 * wan_round / dense['wan']:.2f}% "
          f"of the dense rounds' {dense['wan']:.1f})", flush=True)
    for w in (0, 1):
        med = medians(res[w]["phases"])
        wires = [round(p["wire_ms"], 3) for p in res[w]["phases"]]
        print(f"[phase4b-bsc] worker {w} losses {res[w]['losses']}; "
              f"step_timed medians (ms) {med}; wire per round {wires} "
              f"(dense rounds' median {dense['wire_ms'][w]:.3f})", flush=True)
    print(f"[phase4b-bsc] host spans of the {R} rounds (thread-ms summed "
          "over every role's threads, key and chunk numbers merged): "
          + ", ".join(f"{k} {v:.1f}" for k, v in spans), flush=True)
    for w in (0, 1):
        if not all(math.isfinite(x) for x in res[w]["losses"]):
            fail(f"phase4b-bsc: worker {w} non-finite loss "
                 f"{res[w]['losses']}")
    if not wan_round < dense["wan"] / 10:
        fail(f"phase4b-bsc: {wan_round} WAN bytes per round, not under a "
             f"tenth of the dense {dense['wan']}")
    check_replicas(np, [res[0]["leaves"], res[1]["leaves"]], "phase4b-bsc")


def phase5_baseline(torch, np, dev):
    """``bench.py`` ``bench_nokv``'s accuracy probe: one trainer, no kv
    store, batch 2 x FEATURE["batch"], Adam at lr 1e-3 (``torch.optim.Adam``
    stands in for ``optax.adam``: a yardstick, not a port), ACC_ITERS
    steps over the cached batches, then the test accuracy."""
    from geomx_tpu_torch.examples.utils import build_model_and_step, eval_acc
    from geomx_tpu_torch.io import load_data

    B = 2 * FEATURE["batch"]
    leaves, _names, grad_step, eval_step = build_model_and_step(B, device=dev)
    params = [torch.tensor(l, device=dev) for l in leaves]
    opt = torch.optim.Adam(params, lr=FEATURE["lr"])
    train_iter, test_iter, _, _ = load_data(B, 1, 0)
    batches = [(torch.as_tensor(X, device=dev), torch.as_tensor(y, device=dev))
               for X, y in train_iter]
    for it in range(FEATURE["acc_iters"]):
        _loss, grads = grad_step(params, *batches[it % len(batches)])
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
    acc = eval_acc(test_iter, [p.cpu().numpy() for p in params], eval_step,
                   device=dev)
    print(f"[phase5] no-kvstore baseline: batch {B}, Adam lr {FEATURE['lr']}, "
          f"{FEATURE['acc_iters']} steps: test accuracy {acc:.4f}", flush=True)
    return acc


def wan_payload(sizes, codec, threshold=0.0, bound=0):
    """Bytes per round the WAN payloads take, from the key sizes and the
    codec, headers excluded: (least, most). Two parties each push their
    aggregate up and pull the global one back. BSC sends each key's
    top max(int(n t), 1) (fp32 value + int32 index; the sampled boundary
    may pick fewer) and pulls back the nonzeros of the sum of both
    parties' selections (at most twice as many)."""
    lo = hi = 0
    for n in sizes:
        if codec == "dense":
            lo += 16 * n
            hi += 16 * n
        elif codec == "fp16" or (codec == "mpq" and n < bound):
            lo += 8 * n
            hi += 8 * n
        else:                               # bsc, or mpq's big keys
            k = max(int(n * threshold), 1)
            lo += 2 * 8                     # one entry each way
            hi += 2 * (8 * k + 8 * min(2 * k, n))
    return lo, hi


def wan_counts():
    """(bytes, messages) the global tier's vans have sent so far."""
    from geomx_tpu_torch import telemetry

    msgs = sum(v for k, v in telemetry.snapshot()["counters"].items()
               if k.startswith("van.messages_sent{") and "tier=global" in k)
    return telemetry.wan_bytes(), msgs


def run_feature(torch, np, mod, argv, tag, rounds, dev, topo_kw=None,
                env=None, batch=None):
    """One feature config over a live two-party HiPS, driven through its
    example's ``run_worker``: the master's part first (optimizer, codec,
    init), then both party workers, each on its own data slice, for
    ``rounds`` rounds of ``batch`` images (FEATURE's by default). ``env``
    holds the variables the example's ``parse_args`` reads. Returns the
    workers' results and the WAN bytes
    and messages per round from the end of round 1 to the end of the
    last."""
    from geomx_tpu_torch import telemetry

    telemetry.enable(True)
    bar = threading.Barrier(2)
    wan, res = {}, {}
    common = ["-bs", str(batch or FEATURE["batch"]), "-ep", str(rounds),
              "--max-iters", str(rounds)] + argv
    with mock.patch.dict(os.environ, env or {}):
        margs = mod.parse_args(common)
        wargs = [mod.parse_args(common + ["-ds", str(w)]) for w in (0, 1)]

    def master(kv):
        mod.run_worker(kv, margs, dev)

    def worker(kv, w):
        def on_round(i):
            if i == 1:              # both between rounds 1 and 2
                bar.wait(JOIN_S)
                if w == 0:
                    wan[0] = wan_counts()
                bar.wait(JOIN_S)

        res[w] = mod.run_worker(kv, wargs[w], dev, on_round=on_round)
        bar.wait(JOIN_S)
        if w == 0:
            wan[1] = wan_counts()

    run_hips(worker, master, tag, barriers=[bar], topo_kw=topo_kw)
    return res, [(b - a) / (rounds - 1) for a, b in zip(wan[0], wan[1])]


def report_feature(np, tag, res, wan, payload, rounds, framing):
    """Print a config's accuracies, rate, step times and WAN bytes and
    messages per round (``wan``); fail on a non-finite loss or WAN bytes
    outside the payload count plus ``framing`` bytes per message."""
    wan_round, msgs = wan
    steps = [res[w]["step_ms"][1:] for w in (0, 1)]   # round 1 warms up
    img_s = 2 * FEATURE["batch"] * (rounds - 1) / max(sum(x) for x in steps) \
        * 1e3
    print(f"[{tag}] test accuracy after {rounds} rounds: worker 0 "
          f"{res[0]['accs'][-1]:.4f}, worker 1 {res[1]['accs'][-1]:.4f}; "
          f"peak of the last 10 {max(res[0]['accs'][-10:]):.4f} / "
          f"{max(res[1]['accs'][-10:]):.4f}", flush=True)
    for w in (0, 1):
        x = steps[w]
        print(f"[{tag}] worker {w} step ms (gradients, wire and update, "
              f"eval excluded) median {statistics.median(x):.3f}, min "
              f"{min(x):.3f}, max {max(x):.3f}; last losses "
              f"{[round(l, 4) for l in res[w]['losses'][-3:]]}", flush=True)
    print(f"[{tag}] {img_s:.1f} img/s (both workers, over the step times), "
          f"{wan_round:.1f} WAN bytes in {msgs:.2f} messages per round "
          f"(payload counted from the shapes {payload[0]}-{payload[1]})",
          flush=True)
    for w in (0, 1):
        if not all(math.isfinite(l) for l in res[w]["losses"]):
            fail(f"{tag}: worker {w} non-finite loss {res[w]['losses']}")
        if not all(np.isfinite(l).all() for l in res[w]["leaves"]):
            fail(f"{tag}: worker {w} non-finite parameters")
    if not payload[0] <= wan_round <= payload[1] + msgs * framing:
        fail(f"{tag}: {wan_round} WAN bytes per round, outside the "
             f"payload count {payload} plus {framing:.1f} bytes of framing "
             f"for each of {msgs:.2f} messages")


def phase5(torch, np, dev="cuda"):
    """The BASELINE.md feature configs over live HiPS, each through its
    example's ``run_worker`` with LeNet at full width, 128 images per
    worker per round: 5a the no-kvstore baseline and vanilla FSA (server
    Adam), 5b HFA (K1 4, K2 2, local Adam), 5c fp16 (multi-precision,
    bf16 compute), BSC, MPQ and MixedSync. Returns the framing bytes per
    key of a WAN message that 5a's dense round measured."""
    from geomx_tpu_torch.examples import cnn, cnn_bsc, cnn_fp16, cnn_hfa, \
        cnn_mpq

    base = phase5_baseline(torch, np, dev)
    acc_r, codec_r, thr = (FEATURE["acc_iters"], FEATURE["codec_rounds"],
                           FEATURE["threshold"])
    chance = FEATURE["chance"]
    # HFA's last iteration syncs the global tier: the parties end equal
    k1k2 = FEATURE["hfa_k1"] * FEATURE["hfa_k2"]
    hfa_r = acc_r // k1k2 * k1k2
    mpq_env = {"MXNET_KVSTORE_SIZE_LOWER_BOUND": str(FEATURE["mpq_bound"])}
    # (tag, example, flags, rounds, topology, env, codec, threshold,
    #  accuracy gate: (accuracy read, floor) or None, replicas
    #  bit-identical). BSC at 0.01 carries no accuracy gate: the
    #  example's recipe is chaotic there and may fall back to chance in
    #  either package (PERF.md, slice 6); the gate runs at 0.2, the
    #  threshold of tests/test_launch_integration.py's calibration
    #  (:104), on the peak of the last 10 rounds as that test reads it.
    configs = [
        ("phase5a fsa", cnn, [], acc_r, None, None, "dense", 0,
         ("final", base - PARITY_TOL_FSA), True),
        ("phase5b hfa", cnn_hfa, [], hfa_r,
         {"use_hfa": True, "hfa_k2": FEATURE["hfa_k2"]},
         {"MXNET_KVSTORE_HFA_K1": str(FEATURE["hfa_k1"])}, "dense", 0,
         ("final", base - PARITY_TOL_HFA), True),
        ("phase5c fp16", cnn_fp16, [], codec_r, None, None, "fp16", 0,
         ("peak10", chance), True),
        ("phase5c bsc", cnn_bsc, ["-cr", str(thr)], codec_r, None, None,
         "bsc", thr, None, True),
        ("phase5c bsc-0.2", cnn_bsc, ["-cr", "0.2"], codec_r, None, None,
         "bsc", 0.2, ("peak10", chance), True),
        ("phase5c mpq", cnn_mpq, ["-cr", str(thr)], codec_r, None, mpq_env,
         "mpq", thr, ("peak10", chance), True),
        ("phase5c mixedsync", cnn, ["-ms"], codec_r,
         {"sync_global": False}, None, "dense", 0, ("peak10", chance),
         False),
    ]
    framing = None
    for (tag, mod, flags, rounds, topo_kw, env, codec, cr, gate,
         lockstep) in configs:
        res, wan = run_feature(torch, np, mod, flags, tag, rounds, dev,
                               topo_kw, env)
        sizes = [l.size for l in res[0]["leaves"]]
        lo, hi = wan_payload(sizes, codec, cr, FEATURE["mpq_bound"])
        if tag.endswith("hfa"):
            # the global tier every K1 * K2 iterations: the syncs inside
            # the counted window, spread over its iterations
            syncs = rounds // k1k2
            lo, hi = lo * syncs / (rounds - 1), hi * syncs / (rounds - 1)
        if framing is None:
            # FSA's dense payload is exact: the rest of its WAN bytes is
            # framing (keys, lengths, meta). The other configs may frame
            # a message with up to twice as much (codec tags, BSC's
            # indices beside its values).
            framing = (wan[0] - lo) / wan[1]
            print(f"[{tag}] {framing:.1f} bytes of framing per WAN message "
                  "over the dense payload", flush=True)
            if framing < 0:
                fail(f"{tag}: {wan[0]} WAN bytes per round, under the dense "
                     f"payload {lo}")
        report_feature(np, tag, res, wan, (lo, hi), rounds, 2 * framing)
        accs = [res[w]["accs"][-1] if gate is None or gate[0] == "final"
                else max(res[w]["accs"][-10:]) for w in (0, 1)]
        if gate is not None and min(accs) < gate[1]:
            fail(f"{tag}: accuracy ({gate[0]}) {accs} below {gate[1]:.4f}")
        if lockstep:
            check_replicas(np, [res[0]["leaves"], res[1]["leaves"]], tag)
        if tag == "phase5a fsa":
            per_key = framing / len(sizes)
    return per_key


def mesh_settings(codec, threshold):
    """The mesh-party tier's settings as a user sets them, scoped to a
    ``with`` block (restored afterwards), and the Config keys
    ``InProcessHiPS`` takes from them."""
    from geomx_tpu_torch import config as cfg_mod

    env = {"GEOMX_PARTY_MESH": "1",
           "GEOMX_PARTY_MESH_SIZE": str(MESH6["ranks"]),
           "GEOMX_MESH_CODEC": codec,
           "GEOMX_WIRE_2BIT_THRESHOLD": repr(threshold)}
    scope = mock.patch.dict(os.environ, env)
    with scope:
        cfg = cfg_mod.load()
    return scope, {"mesh_codec": cfg.mesh_codec,
                   "wire_2bit_threshold": cfg.wire_2bit_threshold}


def intra_party_ms(torch, n, dev):
    """``bench.py`` ``bench_hips_mesh``'s intra-party protocol probe: the
    party mean of a (ranks, n) fp32 stack on the device, median of
    MESH6["probe_reps"] fenced calls (the collective a party of one card
    runs in place of the LAN PS round)."""
    g = torch.randn(MESH6["ranks"], n, generator=torch.Generator()
                    .manual_seed(0)).to(dev)
    g.mean(0)
    samples = []
    for _ in range(MESH6["probe_reps"]):
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        g.mean(0)
        if dev == "cuda":
            torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples)


def mesh_round1_replay(torch, np, grad_step, leaves0, party_batches, codec,
                       dev):
    """Round 1 of the mesh-party BSC round (momentum 0) in plain torch,
    from the initial leaves and each party's first batch: the party
    gradient (the whole party batch's mean for codec "none"; else each
    rank's contiguous shard through the quantized ring, replayed on the
    CPU, over P), scaled by 1/parties, every leaf's top int(size x
    threshold) coordinates kept, summed over the parties as the global
    tier sums them, one SGD step. Shares only the model's ``grad_step``
    and the ring's CPU route with the code under test."""
    from geomx_tpu_torch import config as cfg_mod
    from geomx_tpu_torch.parallel import quant_collectives as qc

    cfg = cfg_mod.load()
    P, nparties = MESH6["ranks"], len(party_batches)
    sizes = [int(l.size) for l in leaves0]
    flat0 = torch.from_numpy(np.concatenate(
        [l.ravel() for l in leaves0]).astype(np.float32)).to(dev)
    agg = torch.zeros_like(flat0)

    def grad(X, y):
        lv = [torch.from_numpy(np.array(l, np.float32)).to(dev)
              for l in leaves0]
        _loss, grads = grad_step(lv, X, y)
        return torch.cat([g.reshape(-1).float() for g in grads])

    for X, y in party_batches:
        if codec == "none":
            g = grad(X, y)
        else:
            rows = X.shape[0] // P
            stack = torch.stack([grad(X[r * rows:(r + 1) * rows],
                                      y[r * rows:(r + 1) * rows])
                                 for r in range(P)]).cpu()
            out, _res = qc.ring_all_reduce(
                stack, qc.zero_residual(P, stack.shape[1], codec,
                                        cfg.mesh_block, device="cpu"),
                size=P, codec=codec, block=cfg.mesh_block,
                threshold=cfg.wire_2bit_threshold)
            g = out[0].to(dev) / P
        u = g / nparties
        off = 0
        for sz in sizes:
            seg = u[off:off + sz]
            idx = torch.topk(seg.abs(), max(int(sz * LENET["threshold"]),
                                            1))[1] + off
            agg.index_add_(0, idx, u[idx])
            off += sz
    return flat0 - LENET["lr"] * agg


def disp_err(np, got, want, init):
    """||got - want|| / ||want - init||: an error against the size of
    the displacement from ``init`` (flat float64)."""
    got, want, init = (np.asarray(a, np.float64) for a in (got, want, init))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want - init))


def mesh_lenet(torch, np, fa, tb, codec, dev="cuda"):
    """One run of ``bench_hips_mesh``'s recipe at ``codec``: two mesh
    parties of MESH6["ranks"] ranks on ``dev`` (both parties' meshes on
    it), DeviceResidentTrainer, BSC 0.02, lr 0.05, party batch ranks x
    128, LENET["rounds"] rounds, then the accuracy, LENET["timed"]
    ``step_timed`` rounds and MESH6["thr_rounds"] timed rounds."""
    from geomx_tpu_torch import telemetry
    from geomx_tpu_torch.examples.utils import build_model_and_step, eval_acc
    from geomx_tpu_torch.io import load_data
    from geomx_tpu_torch.trainer_device import DeviceResidentTrainer

    B = MESH6["ranks"] * LENET["batch"]
    R = LENET["rounds"]
    telemetry.enable(True)
    leaves0, _names, grad_step, eval_step = build_model_and_step(
        B, device=dev)
    scope, extra = mesh_settings(codec, MESH6["lenet_2bit_threshold"])
    warm = threading.Lock()
    bar = threading.Barrier(2)
    res, tel, counts = {}, {}, {}
    tag = f"phase6a {codec}"

    def worker(kv, w):
        tr = DeviceResidentTrainer(
            list(leaves0), kv, grad_step, threshold=LENET["threshold"],
            learning_rate=LENET["lr"], momentum=0.0, device=dev)
        if tr._mesh_quant != (codec != "none"):
            fail(f"{tag}: the trainer did not take the {codec} mesh round")
        train_iter, test_iter, _, _ = load_data(B, 2, w)
        batches = [(torch.as_tensor(X, device=dev),
                    torch.as_tensor(y, device=dev)) for X, y in train_iter]
        with warm:          # no kv round inside: it would wait on the peer
            tr.warmup(*batches[0])
        bar.wait(JOIN_S)
        if w == 0:
            reset([fa.LAUNCHES, tb.LAUNCHES])
        bar.wait(JOIN_S)
        losses = [tr.step(*batches[0])]
        round1 = np.concatenate([l.ravel() for l in tr.leaves])
        losses += [tr.step(*batches[it % len(batches)])
                   for it in range(1, R)]
        bar.wait(JOIN_S)
        if w == 0:
            counts.update(fa.LAUNCHES, **tb.LAUNCHES)
        acc = eval_acc(test_iter, tr.leaves, eval_step, device=dev)
        timed = [tr.step_timed(*batches[j % len(batches)])[1]
                 for j in range(LENET["timed"])]
        bar.wait(JOIN_S)
        if w == 0:
            snap = telemetry.snapshot()
            tel[0] = (telemetry.wan_bytes(snap), telemetry.mesh_bytes(snap))
        bar.wait(JOIN_S)
        t0 = time.perf_counter()
        for i in range(MESH6["thr_rounds"]):
            tr.step(*batches[i % len(batches)])
        if dev == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        bar.wait(JOIN_S)
        if w == 0:
            snap = telemetry.snapshot()
            tel[1] = (telemetry.wan_bytes(snap), telemetry.mesh_bytes(snap))
        res[w] = dict(acc=acc, losses=losses, timed=timed, wall=wall,
                      leaves=tr.leaves, round1=round1, batch1=batches[0])

    with scope:
        run_hips(worker, init_keys(np, leaves0), tag, barriers=[bar],
                 topo_kw={"party_mesh_size": MESH6["ranks"], "device": dev,
                          "extra_cfg": extra})
        want1 = mesh_round1_replay(
            torch, np, grad_step, leaves0,
            [res[w]["batch1"] for w in (0, 1)], codec, dev).cpu().numpy()
    flat0 = np.concatenate([l.ravel() for l in leaves0])
    err1 = disp_err(np, res[0]["round1"], want1, flat0)
    n = MESH6["thr_rounds"]
    wan_round = (tel[1][0] - tel[0][0]) / n
    mesh_round = (tel[1][1] - tel[0][1]) / n
    img_s = n * B * 2 / max(r["wall"] for r in res.values())
    print(f"[{tag}] LeNet, 2 parties x {MESH6['ranks']} ranks on {dev}, "
          f"party batch {B}, BSC {LENET['threshold']}, lr {LENET['lr']}, "
          f"mesh settings {extra}", flush=True)
    print(f"[{tag}] test accuracy after {R} rounds: party 0 "
          f"{res[0]['acc']:.4f}, party 1 {res[1]['acc']:.4f}; losses of "
          f"rounds 1, {R // 2}, {R}: "
          f"{[round(res[0]['losses'][i], 4) for i in (0, R // 2 - 1, -1)]}",
          flush=True)
    print(f"[{tag}] {img_s:.1f} img/s over {n} rounds (both parties), "
          f"{wan_round:.1f} WAN bytes and {mesh_round:.1f} mesh bytes per "
          f"round", flush=True)
    print(f"[{tag}] launches in the {R} rounds {counts}", flush=True)
    print(f"[{tag}] round 1's leaves against the plain replay of the round "
          f"(parties' batches, party mean, 1/parties, top-k, global sum, "
          f"SGD): displacement error {err1:.3e} by relative norm (gate "
          f"{MESH6['round1_tol']}; a wrong party-mean or 1/parties scale "
          f"reads 0.5 or more, a dropped round 1.0)", flush=True)
    for w in (0, 1):
        print(f"[{tag}] party {w} step_timed medians of {LENET['timed']} "
              f"rounds (ms) {medians(res[w]['timed'])}", flush=True)
    for w in (0, 1):
        if not all(math.isfinite(x) for x in res[w]["losses"]):
            fail(f"{tag}: party {w} non-finite loss")
    check_replicas(np, [res[0]["leaves"], res[1]["leaves"]], tag)
    if not np.array_equal(res[0]["round1"], res[1]["round1"]):
        fail(f"{tag}: the parties' leaves differ after round 1")
    if not err1 <= MESH6["round1_tol"]:
        fail(f"{tag}: round 1 is {err1} off its plain replay by relative "
             f"norm of the displacement, over {MESH6['round1_tol']}")
    return dict(acc=[res[0]["acc"], res[1]["acc"]], img_s=img_s,
                wan=wan_round, mesh=mesh_round, launches=counts,
                round1_err=err1,
                wire_ms=[medians(res[w]["timed"])["wire_ms"] for w in (0, 1)])


def phase6a(torch, np, fa, tb, wire_4a, dev="cuda"):
    """``bench.py`` ``bench_hips_mesh`` on the card: the main path's
    recipe over mesh parties, with GEOMX_MESH_CODEC none and 2bit."""
    from geomx_tpu_torch.examples.utils import build_model_and_step

    leaves0 = build_model_and_step(LENET["batch"], device=dev)[0]
    total = sum(l.size for l in leaves0)
    probe = intra_party_ms(torch, total, dev)
    print(f"[phase6a] intra_party_protocol_ms {probe:.4f} (party mean of a "
          f"({MESH6['ranks']}, {total}) fp32 stack, median of "
          f"{MESH6['probe_reps']}), beside phase 4a's measured wire "
          f"{wire_4a} ms on this card", flush=True)
    runs = {c: mesh_lenet(torch, np, fa, tb, c, dev)
            for c in ("none", "2bit")}
    none, q = runs["none"], runs["2bit"]
    ratio = none["mesh"] / max(q["mesh"], 1e-9)
    print(f"[phase6a] mesh bytes per round: none {none['mesh']:.1f}, 2bit "
          f"{q['mesh']:.1f} ({ratio:.2f}x fewer)", flush=True)
    for codec, floor in (("none", MESH6["acc_none"]),
                         ("2bit", MESH6["acc_2bit"])):
        acc = runs[codec]["acc"]
        if min(acc) < floor:
            fail(f"phase6a {codec}: accuracy {acc} below {floor}")
    if dev == "cuda" and q["launches"]["two_bit"] == 0:
        fail("phase6a 2bit: two_bit_kernel never launched")
    if ratio < 14.0:
        fail(f"phase6a: 2bit moves {q['mesh']} mesh bytes per round, not "
             f"14x below none's {none['mesh']}")
    return dict(runs=runs, probe_ms=probe)


def phase6b(torch, np, fa, tb, dev="cuda"):
    """The 59M decoder on mesh parties: 2 parties x MESH6["ranks"] ranks
    on the card, 8 sequences per rank, the 2-bit ring, BSC 0.01 on the
    party tier, lr 0.05, momentum 0.9; 1 warm-up round, MESH6["tf_rounds"]
    counted ``step_timed`` rounds, 1 profiled round. Returns the launches
    of each kernel per round."""
    from torch.profiler import ProfilerActivity, profile

    from geomx_tpu_torch import telemetry
    from geomx_tpu_torch.examples.transformer_bsc_device import (
        build_transformer_grad_step, synth_batch)
    from geomx_tpu_torch.trainer_device import DeviceResidentTrainer

    R, P = MESH6["tf_rounds"], MESH6["ranks"]
    B = P * BATCH
    telemetry.enable(True)
    leaves0, grad_step = build_transformer_grad_step(
        **MODEL, compute_dtype=torch.bfloat16, device=dev, attn="auto")
    scope, extra = mesh_settings("2bit", PARTY_THRESHOLD)
    warm = threading.Lock()
    bar = threading.Barrier(2)
    bar3 = threading.Barrier(3)     # the two parties and this thread
    res, counts, tel, prof = {}, {}, {}, {}

    def worker(kv, w):
        tr = DeviceResidentTrainer(
            list(leaves0), kv, grad_step, threshold=HIPS_TF["threshold"],
            learning_rate=HIPS_TF["lr"], momentum=HIPS_TF["momentum"],
            device=dev)
        rng = np.random.default_rng(1234 + w)
        batches = [torch.as_tensor(synth_batch(rng, B, MODEL["seq_len"],
                                               MODEL["vocab"]), device=dev)
                   for _ in range(R + 1)]
        with warm:          # no kv round inside: it would wait on the peer
            tr.warmup(batches[0], None)
        warmup = tr.step(batches[R], None)
        bar.wait(JOIN_S)
        if w == 0:
            reset([fa.LAUNCHES, tb.LAUNCHES])
            snap = telemetry.snapshot()
            tel[0] = (telemetry.wan_bytes(snap), telemetry.mesh_bytes(snap))
        bar.wait(JOIN_S)
        timed = [tr.step_timed(batches[j], None) for j in range(R)]
        bar.wait(JOIN_S)
        if w == 0:
            counts.update(fa.LAUNCHES, **tb.LAUNCHES)
            snap = telemetry.snapshot()
            tel[1] = (telemetry.wan_bytes(snap), telemetry.mesh_bytes(snap))
        bar3.wait(JOIN_S)           # this thread starts the profiler
        bar3.wait(JOIN_S)
        phases = tr.step_timed(batches[0], None)[1]
        if w == 0:
            prof["phases"] = phases
        bar3.wait(JOIN_S)           # this thread stops it
        res[w] = dict(warmup=warmup, losses=[t[0] for t in timed],
                      phases=[t[1] for t in timed], leaves=tr.leaves,
                      round1=batches[R], k=tr.k)

    def profile_one_round():
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if dev == "cuda" else [])
        bar3.wait(JOIN_S)
        with profile(activities=acts) as p:
            t = time.perf_counter()
            bar3.wait(JOIN_S)
            bar3.wait(JOIN_S)
            prof["wall"] = (time.perf_counter() - t) * 1e3
        prof["p"] = p

    with scope:
        run_hips(worker, init_keys(np, leaves0), "phase6b",
                 barriers=[bar, bar3], main_fn=profile_one_round,
                 topo_kw={"party_mesh_size": P, "device": dev,
                          "extra_cfg": extra})
    per_round = {k: v / R for k, v in counts.items()}
    wan_round = (tel[1][0] - tel[0][0]) / R
    mesh_round = (tel[1][1] - tel[0][1]) / R
    print(f"[phase6b] transformer of {sum(l.size for l in leaves0)} params, "
          f"2 parties x {P} ranks on {dev}, {BATCH} sequences per rank, "
          f"mesh settings {extra}, selection {res[0]['k']} per party",
          flush=True)
    for w in (0, 1):
        print(f"[phase6b] party {w} warm-up loss {res[w]['warmup']:.6f}, "
              f"counted losses {res[w]['losses']}", flush=True)
        print(f"[phase6b] party {w} step_timed medians of {R} rounds (ms) "
              f"{medians(res[w]['phases'])}", flush=True)
    print(f"[phase6b] {wan_round:.1f} WAN bytes and {mesh_round:.1f} mesh "
          "bytes per round", flush=True)
    print(f"[phase6b] launches per round (both parties) {per_round}",
          flush=True)
    tc = None
    if dev == "cuda":
        tc = profile_summary(prof["p"].key_averages(), prof["wall"],
                             prof["phases"], "phase6b profile")
    for w in (0, 1):
        if not all(math.isfinite(x) for x in
                   [res[w]["warmup"]] + res[w]["losses"]):
            fail(f"phase6b: party {w} non-finite loss")
    if dev == "cuda":
        want = 2 * P * MODEL["depth"]
        for key in KERNELS:
            if counts[key] != want * R:
                fail(f"phase6b: {key} launched {counts[key]} times in {R} "
                     f"rounds, expected {want} per round")
        if counts["two_bit"] == 0:
            fail("phase6b: two_bit_kernel never launched")
        if tc is not None:
            for name, n in tc.items():
                if n != want:
                    fail(f"phase6b profile: {name} ran {n} times in the "
                         f"round, expected {want}")
    check_replicas(np, [res[0]["leaves"], res[1]["leaves"]], "phase6b")

    # round 1 (the warm-up round, from the initial leaves) against the
    # same step with plain attention: the mean of the ranks' shard losses
    def plain_attn(q, k, v):
        return fa.flash_fwd_plain(q, k, v, causal=True)[0]

    _, plain_step = build_transformer_grad_step(
        **MODEL, compute_dtype=torch.bfloat16, device=dev, attn=plain_attn,
        init_leaves=leaves0)
    ref = [torch.as_tensor(l, device=dev) for l in leaves0]
    toks = res[0]["round1"].reshape(P, BATCH, -1)
    ref_loss = sum(float(plain_step(ref, toks[r], None)[0])
                   for r in range(P)) / P
    rel = abs(res[0]["warmup"] - ref_loss) / abs(ref_loss)
    print(f"[phase6b] round-1 loss {res[0]['warmup']:.6f} vs plain "
          f"attention {ref_loss:.6f}: rel diff {rel:.3e}", flush=True)
    if rel > 2e-2:
        fail(f"phase6b: round-1 loss differs from the plain-attention "
             f"step by {rel}")
    return per_round


# ---------------------------------------------------------------------------
# phase 7: every role its own process, through the port's launch recipes
# ---------------------------------------------------------------------------

WORKER_TAG = "phase7_worker "      # the line a --worker process ends with
ACC_RE = r"\[Iteration (\d+)\] Test Acc (\d+\.\d+)"
LOSS_RE = r"\[Iteration (\d+)\] Loss (\S+)"


def worker_mode(argv):
    """``chip_smoke.py --worker <module> [args]``: run the example
    ``module``'s ``main(args)`` in this process (a worker of a recipe,
    which appends the module and its arguments to WORKER_LAUNCH), then
    print one JSON line: the devices it resolved, whether the card held
    its tensors, the port's kernel launches, and the sha256 of the
    parameters it ended with (its ``DeviceResidentTrainer``'s, or what
    ``run_worker`` returned)."""
    import importlib

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from geomx_tpu_torch import _device
    from geomx_tpu_torch import trainer_device as td
    from geomx_tpu_torch.ops import flash_attention as fa
    from geomx_tpu_torch.ops import two_bit as tb

    module, args = argv[0], argv[1:]
    devices, trainers, returned = [], [], []
    resolve = _device.resolve_device

    def resolve_recorded(device=None):
        d = resolve(device)
        devices.append(str(d))
        return d

    init = td.DeviceResidentTrainer.__init__

    def init_recorded(self, *a, **kw):
        init(self, *a, **kw)
        trainers.append(self)

    _device.resolve_device = resolve_recorded
    td.DeviceResidentTrainer.__init__ = init_recorded
    mod = importlib.import_module(module)
    if hasattr(mod, "run_worker"):
        run_worker = mod.run_worker

        def run_worker_recorded(*a, **kw):
            out = run_worker(*a, **kw)
            returned.append(out)
            return out

        mod.run_worker = run_worker_recorded
    reset([fa.LAUNCHES, tb.LAUNCHES])
    t = time.perf_counter()
    mod.main(args)
    leaves = (trainers[0].leaves if trainers else
              returned[0]["leaves"] if returned and returned[0] else None)
    digest = (hashlib.sha256(b"".join(np.asarray(l).tobytes()
                                      for l in leaves)).hexdigest()[:16]
              if leaves is not None else None)
    if leaves is not None and os.environ.get("PHASE7_LEAVES"):
        np.savez(os.path.join(os.environ["LOG_DIR"],
                              f"leaves_{os.getpid()}.npz"),
                 *[np.asarray(l) for l in leaves])
    on_card = (torch.cuda.is_available() and torch.cuda.is_initialized()
               and torch.cuda.max_memory_allocated() > 0)
    print(WORKER_TAG + json.dumps({
        "module": module, "role": "master" if os.environ.get(
            "DMLC_ROLE_MASTER_WORKER") else "worker",
        "devices": sorted(set(devices)), "card": bool(on_card),
        "launches": {**fa.LAUNCHES, **tb.LAUNCHES}, "digest": digest,
        "pid": os.getpid(),
        "main_s": round(time.perf_counter() - t, 3)}), flush=True)


_PORTS_LOCK = threading.Lock()
_PORTS_GIVEN = set()


def free_ports(n):
    """``n`` free ports for a recipe's schedulers, below the kernel's
    ephemeral range: a recipe's many processes bind ephemeral ports of
    their own while its schedulers start, and one of them must not take
    a scheduler's port first. No port is handed out twice, so recipes
    launched at once never share one."""
    import random
    import socket

    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768
    out = []
    with _PORTS_LOCK:
        while len(out) < n:
            port = random.randrange(10000, low)
            if port in _PORTS_GIVEN:
                continue
            with socket.socket() as s:
                try:
                    s.bind(("127.0.0.1", port))
                except OSError:
                    continue
            _PORTS_GIVEN.add(port)
            out.append(port)
    return out


def launch(tag, argv, dev, timeout, env=None):
    """Run a recipe (``argv``, from the repository's root) in a session of
    its own, every worker through ``worker_mode``, logs under
    logs/chip_smoke/<tag>. On a timeout, kill the process group and fail;
    fail on a non-zero exit or a process left behind. Returns the
    foreground worker's output and each log's text by file name."""
    import signal

    root = os.path.dirname(os.path.abspath(__file__))
    log_dir = os.path.join(root, "logs", "chip_smoke", tag)
    shutil.rmtree(log_dir, ignore_errors=True)
    os.makedirs(log_dir)
    full = dict(os.environ)
    full.update(env or {})
    full.update({
        **dict(zip(("GPORT", "CPORT", "APORT", "BPORT"),
                   map(str, free_ports(4)))),
        "LOG_DIR": log_dir, "PYTHON": sys.executable,
        "WORKER_LAUNCH": f"{sys.executable} {os.path.abspath(__file__)} "
                         "--worker"})
    if dev == "cpu":
        argv = argv + ["--cpu"]
    t = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=root, env=full, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)

    def logs_in_dir():
        return sorted(n for n in os.listdir(log_dir) if n.endswith(".log"))

    def tails(out):
        for name in logs_in_dir():
            with open(os.path.join(log_dir, name)) as f:
                text = f.read()
            print(f"--- {tag} {name} (tail)\n{text[-1500:]}", file=sys.stderr)
        print(f"--- {tag} foreground (tail)\n{out[-3000:]}", file=sys.stderr)

    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        tails(out)
        fail(f"phase7 {tag}: the recipe did not finish in {timeout} s")
    left = False
    try:
        os.killpg(proc.pid, 0)
        left = True
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    if proc.returncode != 0 or left:
        tails(out)
        fail(f"phase7 {tag}: exit code {proc.returncode}"
             + (", processes left behind" if left else ""))
    logs = {"foreground": out}
    for name in logs_in_dir():
        with open(os.path.join(log_dir, name)) as f:
            logs[name] = f.read()
    print(f"[phase7 {tag}] {' '.join(argv[:4])} ...: clean exit of every "
          f"process in {time.perf_counter() - t:.1f} s", flush=True)
    return logs


def workers_of(logs, mesh=False):
    """The party workers' texts in data-slice order (the last one ran in
    the foreground), and the master's."""
    pre = "mesh_" if mesh else ""
    n = 2 if mesh else 4
    ws = [logs[f"{pre}w{i}.log"] for i in range(n - 1)] + [logs["foreground"]]
    return ws, logs[f"{pre}master.log"]


def report(text, tag, who, dev):
    """The ``worker_mode`` line of process ``who``, printed and checked:
    on the card every device it resolved is cuda and the card held its
    tensors."""
    import re

    found = [l for l in text.splitlines() if l.startswith(WORKER_TAG)]
    if len(found) != 1:
        fail(f"phase7 {tag} {who}: no worker report in\n{text[-2000:]}")
    rep = json.loads(found[0][len(WORKER_TAG):])
    print(f"[phase{tag}] {who}: devices {rep['devices']}, card "
          f"{rep['card']}, launches {rep['launches']}, parameters sha256 "
          f"{rep['digest']}, main {rep['main_s']} s", flush=True)
    if dev == "cuda" and (rep["devices"] != ["cuda"] or not rep["card"]):
        fail(f"phase7 {tag} {who}: did not run on the card: {rep}")
    rep["step_timed"] = [json.loads(m) for m in
                         re.findall(r"^step_timed (\{.*\})$", text, re.M)]
    return rep


def lockstep(values, tag, what):
    """Every worker printed the same sequence (FSA: one global model)."""
    if not values[0] or any(v != values[0] for v in values):
        fail(f"phase7 {tag}: the workers' {what} differ or are missing: "
             f"{values}")


def recipe_on_threads(argv, dev):
    """7a's recipe with every role on threads of this process: the
    example's ``main(argv)`` on each node of a 2 x 2 ``InProcessHiPS``,
    the master first, then the party workers on data slices 0-3 in the
    recipe's order (``InProcessHiPS.workers`` is rank-ordered per party).
    Returns each worker's final parameters, as ``worker_mode`` reads
    them."""
    import contextlib
    import io
    import logging

    import torch

    import geomx_tpu_torch.kvstore as kvmod
    from geomx_tpu_torch import trainer_device as td
    from geomx_tpu_torch.examples import cnn_bsc_device

    node = threading.local()
    trainers = {}
    init = td.DeviceResidentTrainer.__init__

    def init_recorded(self, *a, **kw):
        init(self, *a, **kw)
        trainers[node.w] = self

    def master(kv):
        node.kv = kv
        cnn_bsc_device.main(argv)

    def worker(kv, w):
        node.kv, node.w = kv, w
        cnn_bsc_device.main(argv + ["--data-slice-idx", str(w)])

    quiet = logging.NullHandler()
    logging.getLogger().addHandler(quiet)      # main's basicConfig: a no-op
    threads = torch.get_num_threads()
    if dev == "cpu":
        # the CPU's reductions follow the thread count: the recipe's
        torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS") or 2))
    try:
        with mock.patch.object(kvmod, "create",
                               lambda name="local", device=None: node.kv), \
                mock.patch.object(td.DeviceResidentTrainer, "__init__",
                                  init_recorded), \
                contextlib.redirect_stdout(io.StringIO()):
            run_hips(worker, master, "phase7a threads",
                     topo_kw={"workers_per_party": 2})
    finally:
        logging.getLogger().removeHandler(quiet)
        torch.set_num_threads(threads)
    if dev == "cuda":
        torch.cuda.synchronize()
    return [trainers[w].leaves for w in range(4)]


def sha16(np, leaves):
    return hashlib.sha256(b"".join(np.asarray(l).tobytes()
                                   for l in leaves)).hexdigest()[:16]


def phase7a(dev, in_process):
    """The main path's recipe as separate processes: cnn_bsc_device (BSC
    0.02, lr 0.05, 128 images per worker) through launch_hips, and the
    same recipe on threads of this process, which must end on the same
    parameters, bit for bit."""
    import re

    import numpy as np

    from geomx_tpu_torch.examples.utils import build_model_and_step

    P = PHASE7
    argv = ["-bs", str(LENET["batch"]), "-ep", "1000", "--max-iters",
            str(P["lenet_rounds"]), "--timed", str(P["timed"])]
    logs = launch("7a", ["bash", "-c", HIPS_ENV + ' && launch_hips "$@"',
                         "launch_hips",
                         "geomx_tpu_torch.examples.cnn_bsc_device", *argv],
                  dev, P["timeout_7a"], env={"PHASE7_LEAVES": "1"})
    ws, master = workers_of(logs)
    reps = [report(w, "7a", f"worker {i}", dev)
            for i, w in enumerate(ws)]
    report(master, "7a", "master", dev)
    accs = [[float(a) for _i, a in re.findall(ACC_RE, w)] for w in ws]
    lockstep(accs, "7a", "per-round accuracies")
    lockstep([[r["digest"]] for r in reps], "7a", "parameter digests")
    if len(accs[0]) != P["lenet_rounds"]:
        fail(f"phase7a: {len(accs[0])} rounds, not {P['lenet_rounds']}")
    if any(len(r["step_timed"]) != P["timed"] for r in reps):
        fail(f"phase7a: a worker did not print {P['timed']} step_timed "
             "rounds")
    last, peak = accs[0][-1], max(accs[0])
    print(f"[phase7a] LeNet main path, 12 processes (2 parties x 2 workers), "
          f"{P['lenet_rounds']} rounds: identical accuracies on all 4 "
          f"workers, last {last:.4f} (floor {P['acc_last']:.4f}), peak "
          f"{peak:.4f} (floor {P['acc_peak']:.4f}), every 20th "
          f"{accs[0][19::20]}; parameters sha256 {reps[0]['digest']} on "
          f"all 4", flush=True)
    for w, r in enumerate(reps):
        print(f"[phase7a] worker {w} step_timed medians of "
              f"{len(r['step_timed'])} rounds (ms) "
              f"{medians(r['step_timed'])}", flush=True)
    print(f"[phase7a] beside phase 4a (every role on threads of one "
          f"process, 2 workers) step_timed medians (ms) "
          f"{in_process}", flush=True)
    # a wrong separate-process round (the recipe's wiring, a role's
    # settings, a worker's data slice) moves the parameters off the
    # in-process run's: the trajectory is deterministic (cuDNN fp32,
    # exact sums of two addends at each tier)
    t = time.perf_counter()
    twin = recipe_on_threads(argv + (["--cpu"] if dev == "cpu" else []),
                             dev)
    with np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "logs", "chip_smoke", "7a",
                              f"leaves_{reps[0]['pid']}.npz")) as z:
        procs = [z[f"arr_{i}"] for i in range(len(z.files))]
    leaves0 = build_model_and_step(LENET["batch"], device=dev)[0]
    flat = [np.concatenate([np.ravel(l) for l in ls])
            for ls in (procs, twin[0], leaves0)]
    err = disp_err(np, flat[0], flat[1], flat[2])
    digests = [sha16(np, ls) for ls in twin]
    print(f"[phase7a] the same recipe on threads of this process "
          f"({time.perf_counter() - t:.1f} s): parameters sha256 "
          f"{digests} against the processes' {reps[0]['digest']}; "
          f"displacement error {err:.3e} by relative norm", flush=True)
    if any(d != reps[0]["digest"] for d in digests):
        fail(f"phase7a: the separate processes ended on other parameters "
             f"than the same recipe on threads ({reps[0]['digest']} against "
             f"{digests}; displacement error {err})")
    if last < P["acc_last"] or peak < P["acc_peak"]:
        fail(f"phase7a: accuracy last {last} / peak {peak} below the floors "
             f"{P['acc_last']} / {P['acc_peak']}")


def phase7b(dev, in_process):
    """The 59M transformer through run_transformer_bsc.sh: 3 counted
    rounds and 2 step_timed rounds per worker."""
    import re

    P = PHASE7
    steps = P["tf_rounds"] + P["timed_tf"]
    logs = launch("7b", [
        "bash", "geomx_tpu_torch/scripts/run_transformer_bsc.sh",
        "--dim", str(MODEL["dim"]), "--depth", str(MODEL["depth"]),
        "--heads", str(MODEL["heads"]), "--vocab", str(MODEL["vocab"]),
        "--seq-len", str(MODEL["seq_len"]), "-bs", str(BATCH),
        "--max-iters", str(P["tf_rounds"]), "--timed", str(P["timed_tf"])],
        dev, P["timeout_7b"])
    ws, master = workers_of(logs)
    reps = [report(w, "7b", f"worker {i}", dev)
            for i, w in enumerate(ws)]
    report(master, "7b", "master", dev)
    losses = [[float(x) for _i, x in re.findall(LOSS_RE, w)] for w in ws]
    for w, l in enumerate(losses):
        if len(l) != P["tf_rounds"] or not all(math.isfinite(x) for x in l):
            fail(f"phase7b: worker {w} losses {l}")
        if len(reps[w]["step_timed"]) != P["timed_tf"]:
            fail(f"phase7b: worker {w} did not print {P['timed_tf']} "
                 "step_timed rounds")
        print(f"[phase7b] worker {w} losses {l} step_timed medians of "
              f"{len(reps[w]['step_timed'])} rounds (ms) "
              f"{medians(reps[w]['step_timed'])}", flush=True)
    lockstep([[r["digest"]] for r in reps], "7b", "parameter digests")
    per_step = {key: [r["launches"][key] / steps for r in reps]
                for key in KERNELS}
    if dev == "cuda":
        for key, n in per_step.items():
            if any(x != MODEL["depth"] for x in n):
                fail(f"phase7b: {key} launched {n} times per step per "
                     f"worker, expected {MODEL['depth']}")
    wire = [medians(r["step_timed"])["wire_ms"] for r in reps]
    print(f"[phase7b] 59M transformer, 12 processes: step_timed wire "
          f"medians {wire} ms on the 4 workers, beside phase 4b's in-process "
          f"wire {in_process['wire_ms']} ms (2 workers on threads of one "
          f"process); parameters sha256 {reps[0]['digest']} on all 4",
          flush=True)
    return {key: sum(r["launches"][key] for r in reps)
            for key in (*KERNELS, "two_bit")}


def phase7c(dev):
    """run_mesh_hips.sh with GEOMX_MESH_CODEC=2bit (the ring threshold of
    phase 6a's LeNet runs): LeNet, two parties of 2 ranks, each party ONE
    worker process."""
    import re

    P = PHASE7
    logs = launch("7c", ["bash", "geomx_tpu_torch/scripts/run_mesh_hips.sh",
                         "--max-iters", str(P["mesh_rounds"]), "-bs",
                         str(2 * LENET["batch"])], dev, P["timeout_short"],
                  env={"GEOMX_MESH_CODEC": "2bit",
                       "GEOMX_WIRE_2BIT_THRESHOLD":
                           repr(MESH6["lenet_2bit_threshold"])})
    ws, master = workers_of(logs, mesh=True)
    reps = [report(w, "7c", f"worker {i}", dev)
            for i, w in enumerate(ws)]
    report(master, "7c", "master", dev)
    accs = [[float(a) for _i, a in re.findall(ACC_RE, w)] for w in ws]
    lockstep(accs, "7c", "per-round accuracies")
    lockstep([[r["digest"]] for r in reps], "7c", "parameter digests")
    launches = [r["launches"]["two_bit"] for r in reps]
    print(f"[phase7c] 2 mesh parties x 2 ranks (2bit ring), 9 processes, "
          f"{P['mesh_rounds']} rounds: accuracies {accs[0]} on both "
          f"parties, two_bit launches {launches} per party worker",
          flush=True)
    if len(accs[0]) != P["mesh_rounds"]:
        fail(f"phase7c: {len(accs[0])} rounds, not {P['mesh_rounds']}")
    if dev == "cuda" and (min(launches) == 0 or len(set(launches)) != 1):
        fail(f"phase7c: two_bit launches per party worker {launches}")
    return {key: sum(r["launches"][key] for r in reps)
            for key in (*KERNELS, "two_bit")}, accs[0], reps[0]["digest"]


def phase7d(dev):
    """One short run of each WAN feature's recipe, all five at once (each
    its own ports, logs and process group): liveness, lockstep and clean
    exits."""
    import re
    from concurrent.futures import ThreadPoolExecutor

    P = PHASE7
    runs = (("p3", ["--max-iters", str(P["short"])], {}, ACC_RE),
            ("inter_ts", ["--max-iters", str(P["short"])], {}, ACC_RE),
            ("dgt", ["--max-iters", str(P["short"])], {"ENABLE_DGT": "1"},
             ACC_RE),
            ("multi_gps", ["--max-iters", str(P["short"])], {}, ACC_RE),
            ("esync", ["-r", str(P["short"]), "-lr", "0.01"], {},
             r"()final acc=(\d+\.\d+)"))
    with ThreadPoolExecutor(len(runs)) as pool:
        futures = [pool.submit(
            launch, f"7d-{recipe}",
            ["bash", f"geomx_tpu_torch/scripts/run_{recipe}.sh", *args],
            dev, P["timeout_short"], env) for recipe, args, env, _ in runs]
        all_logs = [f.result() for f in futures]
    digests = {}
    for (recipe, _args, _env, pattern), logs in zip(runs, all_logs):
        ws, master = workers_of(logs)
        reps = [report(w, f"7d-{recipe}", f"worker {i}", dev)
                for i, w in enumerate(ws)]
        report(master, f"7d-{recipe}", "master", dev)
        accs = [[float(a) for _i, a in re.findall(pattern, w)] for w in ws]
        lockstep(accs, f"7d-{recipe}", "accuracies")
        want = 1 if recipe == "esync" else P["short"]
        if len(accs[0]) != want:
            fail(f"phase7d {recipe}: {len(accs[0])} accuracy lines, not "
                 f"{want}")
        print(f"[phase7d] {recipe}: accuracies {accs[0]} on all 4 workers",
              flush=True)
        digests[recipe] = reps[0]["digest"]
    # P3's slices, the inter-TS overlay and MultiGPS's shards reorder and
    # regroup the same sums of two terms: the same parameters, bit for
    # bit (DGT's UDP blocks may be lost, so it is printed, not held)
    print(f"[phase7d] parameters sha256 by recipe {digests}", flush=True)
    lockstep([[digests[r]] for r in ("p3", "inter_ts", "multi_gps")], "7d",
             "parameters across P3, inter-TS and MultiGPS")


def curve_gap(losses, ref):
    """The largest relative gap between two loss curves, step by step."""
    return max(abs(a - b) / abs(b) for a, b in zip(losses, ref))


def plants8():
    """Faults planted for one ``train_transformer`` run each, that the
    loss-curve check of phase 8a must catch: (name, flags, module,
    attribute, replacement). None changes the step-1 loss but the first."""
    from geomx_tpu_torch.parallel import grad_accum
    from geomx_tpu_torch.parallel import ring_attention as ra

    accumulate, block = grad_accum.accumulate_gradients, ra._block_attn

    def summed(grad_fn, n, **kw):
        fn = accumulate(grad_fn, n, **kw)

        def run(params, *batch):
            loss, grads = fn(params, *batch)
            return loss * n, [g * n for g in grads]

        return run

    def first_only(grad_fn, n, **kw):
        fn = accumulate(grad_fn, n, **kw)

        def run(params, *batch):
            loss, _ = fn(params, *batch)
            mb = batch[0].shape[0] // n
            return loss, grad_fn(params, *(a[:mb] for a in batch))[1]

        return run

    def row_sum_detached(q, k, v, mask):
        m, o, l = block(q, k, v, mask)
        return m, o, l.detach()

    mb = ["--tp", "2", "--microbatches", "2", "--remat"]
    return [
        ("microbatches summed, not averaged", mb, grad_accum,
         "accumulate_gradients", summed),
        ("the mean loss, the first microbatch's gradient only", mb,
         grad_accum, "accumulate_gradients", first_only),
        ("ring attention's softmax row-sum detached", ["--tp", "2", "--sp",
                                                       "2"], ra,
         "_block_attn", row_sum_detached)]


def phase8a(torch, np, fa, tb, dev="cuda"):
    """``train_transformer`` at its defaults in three configurations: one
    rank; tp 2 with 2 microbatches, remat and checkpoints every 10 steps,
    then a resume from step 10 that must reproduce steps 11-20; tp 2 x sp
    2 (ring attention). Finite losses that fall, the whole loss curve
    within ``curve_tol`` of configuration 1's step by step, flash
    launches per step as reckoned (on the CPU attention is dense: none),
    none of ``two_bit``. Then each fault of :func:`plants8` once: the
    curve check must reject it. Returns the launch counts (total by
    kernel, and per step by configuration)."""
    import tempfile

    from geomx_tpu_torch.examples import train_transformer as ex

    iters, depth = PHASE8["iters"], int(tf8_depth())
    ckpt = tempfile.mkdtemp(prefix="phase8a-")
    mb = 2
    configs = {
        "1": ([], (depth, depth, depth)),
        "2": (["--tp", "2", "--microbatches", str(mb), "--remat",
               "--ckpt-dir", ckpt, "--ckpt-every", str(PHASE8["ckpt_every"])],
              # per microbatch: the forward twice (remat reruns it in the
              # backward), dQ and dK/dV once, per block
              (mb * 2 * depth, mb * depth, mb * depth)),
        "3": (["--tp", "2", "--sp", "2"], (0, 0, 0)),
    }
    cpu = ["--cpu"] if dev == "cpu" else []
    counters = [fa.LAUNCHES, tb.LAUNCHES]
    total = {k: 0 for c in counters for k in c}

    def counted(argv):
        reset(counters)
        res = ex.main(argv)
        counts = {k: v for c in counters for k, v in c.items()}
        for k in total:
            total[k] += counts[k]
        return res, counts

    per_step, results = {}, {}
    try:
        for name, (flags, reckoned) in configs.items():
            argv = TF8 + flags + ["--max-iters", str(iters)] + cpu
            res, counts = counted(argv)
            want = dict(zip(("fwd", "dq", "dkv"), reckoned)) if dev == "cuda" \
                else {k: 0 for k in fa.LAUNCHES}
            want["two_bit"] = 0
            per_step[name] = {k: counts[k] / iters for k in counts}
            losses = res["losses"]
            print(f"[phase8a] config {name} {flags}: losses {losses}",
                  flush=True)
            print(f"[phase8a] config {name}: step-1 loss {losses[0]!r}, last "
                  f"{losses[-1]!r}, median step ms "
                  f"{statistics.median(res['step_ms']):.3f} (first "
                  f"{res['step_ms'][0]:.1f}), launches per step "
                  f"{per_step[name]} (reckoned {want})", flush=True)
            if not all(math.isfinite(x) for x in losses) \
                    or not losses[-1] < losses[0]:
                fail(f"phase 8a config {name}: losses {losses}")
            if counts != {k: v * iters for k, v in want.items()}:
                fail(f"phase 8a config {name}: launches {counts} in "
                     f"{iters} steps, reckoned {want} per step")
            results[name] = res
            if dev == "cuda":
                profile_step(torch, ex, argv, f"phase8a-{name}",
                             dict(zip(("fwd", "dq", "dkv"), reckoned)))
        ref = results["1"]["losses"]
        for name, res in results.items():
            gap = curve_gap(res["losses"], ref)
            print(f"[phase8a] config {name}: loss curve vs config 1, largest "
                  f"relative gap {gap:.3e} (tolerance {PHASE8['curve_tol']}"
                  f"); step 1 {abs(res['losses'][0] - ref[0]) / ref[0]:.3e}",
                  flush=True)
            if gap > PHASE8["curve_tol"]:
                fail(f"phase 8a config {name}: loss curve {res['losses']} "
                     f"off config 1's {ref} by up to {gap}")
        # resume: drop the last checkpoint, rerun from step 10
        last = os.path.join(ckpt, str(iters))
        if not os.path.isfile(os.path.join(last, "checkpoint.gxck")):
            fail(f"phase 8a: no checkpoint of step {iters} in {ckpt}")
        shutil.rmtree(last)
        res, _ = counted(TF8 + configs["2"][0] + ["--max-iters", str(iters)]
                         + cpu)
        want = results["2"]["losses"][PHASE8["ckpt_every"]:]
        diff = max(abs(a - b) for a, b in zip(res["losses"], want))
        print(f"[phase8a] resume from step {res['start'] - 1}: losses "
              f"{res['losses']}; the uninterrupted run's {want}; max abs "
              f"diff {diff!r}", flush=True)
        if res["start"] != PHASE8["ckpt_every"] + 1 or res["losses"] != want:
            fail(f"phase 8a: the resumed run's losses differ from the "
                 f"uninterrupted run's by up to {diff}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    # the check's power: each planted fault must fail it (not counted)
    for what, flags, module, attr, planted in plants8():
        with mock.patch.object(module, attr, planted):
            res = ex.main(TF8 + flags + ["--max-iters", str(iters)] + cpu)
        gap = curve_gap(res["losses"], ref)
        step1 = abs(res["losses"][0] - ref[0]) / ref[0]
        print(f"[phase8a] planted fault ({what}; {flags}): losses "
              f"{res['losses']}; largest relative gap to config 1 "
              f"{gap:.3e}; step 1 {step1:.3e}", flush=True)
        if not gap > PHASE8["curve_tol"]:
            fail(f"phase 8a: the loss-curve check passes a planted fault "
                 f"({what}): gap {gap}")
    return total, per_step


def profile_step(torch, ex, argv, tag, per_step):
    """Where a ``train_transformer`` step's time goes: the example's own
    step built anew, two warm-up steps, one traced (:func:`traced`): the
    device's busy share of the step's wall time, its largest kernels.
    Read only from a window that holds the step's flash launches as
    reckoned (``per_step``, {launch key: count}) and every launch the
    host made (:func:`complete`); else "not measured"."""
    run = ex.build(ex.parse_args(argv), torch.device("cuda"))
    for _ in range(2):
        float(run["step"]())
    expect = {KERNELS[k][2]: n for k, n in per_step.items()}
    for _ in range(PROFILE_TRIES):
        events, wall, _ = traced(torch, lambda: float(run["step"]()))
        ok, seen = complete(events, expect)
        ok_all, seen_all = complete(events)
        if ok and ok_all:
            profile_summary(events, wall, {}, tag)
            return
    print(f"[{tag}] device time not measured: the last of "
          f"{PROFILE_TRIES} traced steps held flash launches {seen} "
          f"(reckoned {expect}) and kernels {seen_all}", flush=True)


def tf8_depth():
    """The depth phase 8a's model runs at (the example's default unless
    ``TF8`` sets one)."""
    return TF8[TF8.index("--depth") + 1] if "--depth" in TF8 else 4


def rel_close(got, want, tol):
    """(max abs error, max |want|, ok): every element within
    ``tol * max|want|`` of the fp32 reference."""
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return err, scale, err <= tol * scale


def row_close(got, want, tol, floor=ROW_FLOOR):
    """(worst ratio, ok): each row's (last axis) max abs error over the
    larger of that row's max |want| and ``floor`` x the tensor's, within
    ``tol``. Against one max over the tensor, late rows of causal
    attention (|o| near T^-1/2) would pass with any error; the floor
    keeps rows that cancel to near zero (dQ's first queries) from
    reading bf16 rounding as a fault."""
    got, want = got.float(), want.float()
    err = (got - want).abs().amax(-1)
    scale = want.abs().amax(-1).clamp_min(floor * want.abs().max().item())
    ratio = (err / scale).max().item()
    return ratio, ratio <= tol


def fwd_bwd(torch, fn, qkv, do, dtype):
    """[out, dq, dk, dv] of ``fn`` on ``qkv`` cast to ``dtype``, the
    backward from the cotangent ``do``."""
    xs = [x.to(dtype).requires_grad_() for x in qkv]
    out = fn(*xs)
    return [out.detach()] + list(torch.autograd.grad(out, xs, do.to(dtype)))


def phase8b(torch, fa, dev="cuda"):
    """Ring attention where it matters: B 2, H 8, D 32, T 4096 over sp 4,
    bf16, causal. Ring attention's and the flash kernels' forward and
    q/k/v gradients against fp32 dense attention on the same (bf16)
    values, and the device time of both (CUDA events around back-to-back
    calls, and the profiler's from a window that saw every launch)."""
    from geomx_tpu_torch.models.transformer import dense_attention
    from geomx_tpu_torch.parallel.mesh import make_mesh
    from geomx_tpu_torch.parallel.ring_attention import make_ring_attention

    c = PHASE8["ring"]
    B, T, H, D, sp = c["B"], c["T"], c["H"], c["D"], c["sp"]
    g = torch.Generator(device=dev).manual_seed(88)
    q, k, v, do = (torch.randn(B, T, H, D, device=dev, generator=g)
                   .to(torch.bfloat16) for _ in range(4))
    ring = make_ring_attention(make_mesh(sp, sp=sp, device=dev), causal=True)

    def flash(q, k, v):
        return fa.flash_attention(q, k, v, causal=True)

    def dense32(q, k, v):
        return dense_attention(q, k, v, causal=True)

    ref = fwd_bwd(torch, dense32, (q, k, v), do, torch.float32)
    times = {}
    for name, fn in (("ring", ring), ("flash", flash)):
        got = fwd_bwd(torch, fn, (q, k, v), do, torch.bfloat16)
        for what, a, b, tol in zip(("out", "dq", "dk", "dv"), got, ref,
                                   PHASE8["ring_tol"]):
            err, scale, ok = rel_close(a, b, tol)
            print(f"[phase8b] {name} {what} vs fp32 dense: max abs err "
                  f"{err:.4e} (max |ref| {scale:.4e}, tolerance {tol} x "
                  f"max |ref|)", flush=True)
            if not bool(torch.isfinite(a).all()) or not ok:
                fail(f"phase 8b: {name} {what} max abs err {err} beyond "
                     f"{tol} x {scale}")
        if dev == "cuda":
            # CUDA events over back-to-back calls (host work included)
            # beside the profiler's device time, which a session can miss
            xs = [x.clone().requires_grad_() for x in (q, k, v)]

            def fwd():
                return fn(q, k, v)

            def fwd_bwd_call():
                return torch.autograd.grad(fn(*xs), xs, do)

            # the profiler's reading counts only from a whole window:
            # flash's launches as reckoned, or as many kernels as launched
            fl = (None, None) if name == "ring" else (
                {KERNELS["fwd"][2]: 1},
                {KERNELS[k][2]: 1 for k in ("fwd", "dq", "dkv")})
            times[name] = [time_ms(fwd, 10), time_ms(fwd_bwd_call, 10),
                           device_ms(torch, fwd, 5, fl[0], whole=True)[0],
                           device_ms(torch, fwd_bwd_call, 5, fl[1],
                                     whole=True)[0]]
            print(f"[phase8b] {name} at B{B} T{T} H{H} D{D} bf16 causal"
                  f"{' sp ' + str(sp) if name == 'ring' else ''}: event ms "
                  f"forward {times[name][0]:.4f}, forward+backward "
                  f"{times[name][1]:.4f}; device ms forward "
                  f"{shown(times[name][2])}, forward+backward "
                  f"{shown(times[name][3])}", flush=True)
    return times


def phase8c(torch, np, fa, dev="cuda"):
    """``train_moe`` at its defaults, ep 1 and ep 2: step-1 losses agree,
    the aux loss is finite, the CE falls; dense attention, so no flash
    launch."""
    from geomx_tpu_torch.examples import train_moe

    runs = {}
    for ep in (1, 2):
        reset([fa.LAUNCHES])
        argv = MOE8 + ["--ep", str(ep), "--max-iters",
                       str(PHASE8["iters"])] + (["--cpu"] if dev == "cpu"
                                                else [])
        res = train_moe.main(argv)
        runs[ep] = res
        print(f"[phase8c] ep {ep}: ce {res['ce']}", flush=True)
        print(f"[phase8c] ep {ep}: aux {res['aux']}; median step ms "
              f"{statistics.median(res['step_ms']):.3f}; flash launches "
              f"{dict(fa.LAUNCHES)}", flush=True)
        if not all(math.isfinite(x) for x in res["ce"] + res["aux"]) \
                or not res["ce"][-1] < res["ce"][0]:
            fail(f"phase 8c ep {ep}: ce {res['ce']}, aux {res['aux']}")
        if any(fa.LAUNCHES.values()):
            fail(f"phase 8c: flash launches {fa.LAUNCHES} on a dense path")
    a, b = runs[1]["ce"][0], runs[2]["ce"][0]
    rel = abs(a - b) / abs(a)
    print(f"[phase8c] step-1 ce ep 1 {a!r}, ep 2 {b!r}: rel diff {rel:.3e}",
          flush=True)
    if rel > PHASE8["moe_tol"]:
        fail(f"phase 8c: step-1 ce differs between ep 1 and ep 2 by {rel}")


def phase8d(torch, np, dev="cuda"):
    """FSDP on LeNet at dp 8 against ``DataParallelTrainer`` (10 steps,
    within 2e-4; shard fraction below 0.6), and the GPipe pipeline at pp
    4, M 6 against the stages applied in sequence (fp32, outputs and
    gradients within 1e-5)."""
    import copy
    import functools

    from geomx_tpu_torch._device import exact_cudnn
    from geomx_tpu_torch.io import load_data
    from geomx_tpu_torch.models import create_cnn
    from geomx_tpu_torch.parallel.fsdp import FSDPTrainer
    from geomx_tpu_torch.parallel.mesh import make_mesh
    from geomx_tpu_torch.parallel.pipeline import make_pipeline_fn
    from geomx_tpu_torch.parallel.train_step import DataParallelTrainer

    if dev == "cuda":
        exact_cudnn()
    mesh = make_mesh(8, device=dev)
    model = create_cnn()
    replica = copy.deepcopy(model)
    fsdp = FSDPTrainer(model, functools.partial(torch.optim.Adam, lr=3e-3),
                       mesh)
    repl = DataParallelTrainer(replica, torch.optim.Adam(
        replica.parameters(), lr=3e-3), mesh)
    frac = fsdp.param_shard_fraction()
    train_iter, _, _, _ = load_data(64, num_workers=1)
    l_f, l_r = [], []
    for i, (X, y) in enumerate(train_iter):
        l_f.append(fsdp.step(X, y))
        l_r.append(repl.step(X, y))
        if i + 1 >= PHASE8["fsdp_steps"]:
            break
    diff = max(abs(a - b) for a, b in zip(l_f, l_r))
    print(f"[phase8d] FSDP dp 8 losses {l_f}; DataParallelTrainer {l_r}; "
          f"max abs diff {diff:.3e}; param_shard_fraction {frac:.4f}",
          flush=True)
    if frac >= 0.6 or not np.allclose(l_f, l_r, rtol=2e-4, atol=2e-4) \
            or not l_f[-1] < l_f[0]:
        fail(f"phase 8d: FSDP losses {l_f} vs DP {l_r}, fraction {frac}")

    S, M, mb, Dp = PHASE8["pp"], PHASE8["M"], 16, 256
    g = torch.Generator(device=dev).manual_seed(84)
    w = (0.1 * torch.randn(S, Dp, Dp, device=dev, generator=g))
    b = 0.1 * torch.randn(S, Dp, device=dev, generator=g)
    x = torch.randn(M, mb, Dp, device=dev, generator=g)

    def stage(params, h):
        sw, sb = params
        return torch.tanh(h @ sw + sb)

    def sequential(params, x_mb):
        sw, sb = params
        outs = []
        for m in range(x_mb.shape[0]):
            h = x_mb[m]
            for s in range(sw.shape[0]):
                h = stage((sw[s], sb[s]), h)
            outs.append(h)
        return torch.stack(outs)

    pipe = make_pipeline_fn(make_mesh(S, pp=S, device=dev), stage)
    res = {}
    for name, fn in (("pipeline", pipe), ("sequential", sequential)):
        pw, pb = (t.clone().requires_grad_() for t in (w, b))
        out = fn((pw, pb), x)
        grads = torch.autograd.grad((out * torch.cos(out)).sum(), (pw, pb))
        res[name] = [out.detach()] + list(grads)
    for what, a, c in zip(("out", "dw", "db"), res["pipeline"],
                          res["sequential"]):
        err = (a - c).abs().max().item()
        print(f"[phase8d] pipeline pp {S} M {M} {what} vs sequential: max "
              f"abs err {err:.3e} (max |ref| {c.abs().max().item():.3e})",
              flush=True)
        if not bool(((a - c).abs() <= 1e-5 * (1 + c.abs())).all()):
            fail(f"phase 8d: pipeline {what} off by {err}")


# -- phase 9: the quantized combined wire and the chaos layer --------------

def wire_plan(np, kv, keys):
    """The worker's push entries ((key, shard) in layer order) and the
    codec of each, as ``KVStoreDist.push_pull_async`` plans them (its
    ``_shards`` and ``plan_chunks`` with the wire's ``chunk_codec``):
    a list of (key, offset, length, codec)."""
    from geomx_tpu_torch.kvstore.frontier import plan_chunks

    entries = [(k, sh) for k in keys for sh in kv._key_info[k].shards]
    chunks = plan_chunks(
        list(range(len(entries))), [sh.length * 4 for _k, sh in entries],
        kv.cfg.p3_slice_bytes,
        codec_for=kv._wire.chunk_codec if kv._wire.enabled() else None)
    out = []
    for ch in chunks:
        for i in ch.items:
            k, sh = entries[i]
            out.append((k, sh.offset, sh.length, ch.codec))
    return out


def wire_replay(torch, np, grads, plan, starts, thr, warm):
    """The four legs of every round, replayed on the host (the oracle of
    ``tests/test_quant_wire.py``, ``_qd``, per element on its entry's
    codec): per party agg = leg(g); WAN forward wan = leg(agg); global
    S = wan_0 + wan_1; one global response rsp = leg(S); party response
    out = leg(rsp). Raw legs are exact, fp16 legs round to half, 2-bit
    legs quantize with error feedback, each leg its own residual stream
    carried over the rounds. ``grads[w][r]``: worker w's flat gradient of
    round r; returns the aggregate of each round from ``warm`` on. A
    2-bit leg is ``_qd``'s quantize and dequantize in one elementwise
    step (the residual takes the value, gives up +-thr past +-thr, and
    the receiver sees what it gave up): the same operations on each
    element, without the 4-per-byte pack, as CPU tensor ops (fp32
    elementwise arithmetic and round-to-nearest-even halves, as numpy's,
    on every core: at 59M elements numpy's float16 casts alone took 22 s
    of four rounds)."""
    n = grads[0][0].size
    code = np.zeros(n, np.uint8)            # 0 raw, 1 fp16, 2 2bit
    for k, off, length, codec in plan:
        a = starts[k] + off
        code[a:a + length] = {"": 0, "fp16": 1, "2bit": 2}[codec]
    present = set(np.unique(code).tolist())
    code = torch.from_numpy(code)
    f16 = lambda x: x.half().float()  # noqa: E731
    t = torch.tensor(thr, dtype=torch.float32)
    zero = torch.zeros((), dtype=torch.float32)
    res = {}

    def qd(leg, x):
        r = res.setdefault(leg, torch.zeros(n, dtype=torch.float32))
        r += x
        got = torch.where(r > t, t, torch.where(r < -t, -t, zero))
        r -= got
        return got

    outs = []
    for rnd in range(len(grads[0])):
        g = [torch.from_numpy(grads[0][rnd]), torch.from_numpy(grads[1][rnd])]
        # each codec's chain over the whole vector (an element keeps its
        # codec every round, so the chains' values elsewhere are never
        # read), then each element from its own codec's chain
        chain = {}
        if 0 in present:
            chain[0] = g[0] + g[1]
        if 1 in present:
            chain[1] = f16(f16(g[0]) + f16(g[1]))
        if 2 in present:
            wan = [qd(("fwd", p), qd(("push", p), g[p])) for p in (0, 1)]
            rsp = qd("grsp", wan[0] + wan[1])
            parts = [qd(("prsp", p), rsp) for p in (0, 1)]
            if not torch.equal(parts[0], parts[1]):
                fail("phase9a replay: the two party responses differ")
            chain[2] = parts[0]
        out = None
        for c, v in chain.items():
            out = v if out is None else torch.where(code == c, v, out)
        if rnd >= warm:
            outs.append(out.numpy())
    return outs


def wan_by_codec_payload(plan, parties=2):
    """Bytes per round each codec's WAN payloads take, headers excluded:
    every party forwards each entry up and takes the global response
    back, raw 4 B, fp16 2 B and 2-bit a quarter byte per element plus the
    4-byte threshold."""
    out = {}
    for _k, _off, n, codec in plan:
        c = codec or "raw"
        b = {"raw": 4 * n, "fp16": 2 * n, "2bit": -(-n // 4) + 4}[c]
        out[c] = out.get(c, 0) + 2 * parties * b
    return out


def quant_wire_round(torch, np, fa, tb, policy, leaves0, grad_step, dev):
    """One policy of 9a: 2 parties x 1 worker, aggregator mode, the
    59M decoder's gradient leaves pushed as tensors on ``dev`` through
    ``push_pull_async`` and SGD on the aggregate; 1 warm-up and
    PHASE9["rounds"] counted rounds."""
    from geomx_tpu_torch import telemetry
    from geomx_tpu_torch.examples.transformer_bsc_device import synth_batch

    P = PHASE9
    R, warm = P["warm"] + P["rounds"], P["warm"]
    keys = list(range(len(leaves0)))
    bar = threading.Barrier(2)
    res, counts, wan = {}, {}, {}
    telemetry.enable(True)

    def worker(kv, w):
        leaves = [torch.as_tensor(np.asarray(l), device=dev).clone()
                  for l in leaves0]
        batch = torch.as_tensor(synth_batch(
            np.random.default_rng(4321 + w), BATCH, MODEL["seq_len"],
            MODEL["vocab"]), device=dev)
        outs = [np.zeros(np.shape(l), np.float32) for l in leaves0]
        for k, o in zip(keys, outs):
            kv.init(k, o.copy())
        kv.wait()
        grads_host, aggs, losses, split = [], [], [], []
        for rnd in range(R):
            if rnd == warm:
                bar.wait(JOIN_S)
                if w == 0:
                    reset([fa.LAUNCHES, tb.LAUNCHES])
                    telemetry.reset()
                    telemetry.enable(True)
                bar.wait(JOIN_S)
            t0 = time.perf_counter()
            loss, grads = grad_step(leaves, batch, None)
            grads = [g.detach().float().contiguous() for g in grads]
            if dev == "cuda":
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            fut = kv.push_pull_async(keys, grads, outs)
            t2 = time.perf_counter()
            fut.wait(timeout=JOIN_S)
            t3 = time.perf_counter()
            with torch.no_grad():
                for leaf, o in zip(leaves, outs):
                    leaf.sub_(torch.from_numpy(o).to(dev),
                              alpha=P["lr"] / 2)
            if dev == "cuda":
                torch.cuda.synchronize()
            t4 = time.perf_counter()
            losses.append(float(loss))
            split.append({"compute_ms": (t1 - t0) * 1e3,
                          "encode_d2h_ms": (t2 - t1) * 1e3,
                          "wire_ms": (t3 - t2) * 1e3,
                          "apply_ms": (t4 - t3) * 1e3})
            grads_host.append(np.concatenate(
                [g.cpu().numpy().ravel() for g in grads]))
            if rnd >= warm:
                aggs.append(np.concatenate([o.ravel() for o in outs]))
        bar.wait(JOIN_S)
        if w == 0:
            counts.update(fa.LAUNCHES, **tb.LAUNCHES)
            wan["bytes"], wan["msgs"] = wan_counts()
            wan["by_codec"] = telemetry.wan_bytes_by_codec()
            wan["plan"] = wire_plan(np, kv, keys)
        bar.wait(JOIN_S)
        # the loss after the last round's update (the 2-bit legs pass a
        # coordinate only once its residual has built up over rounds)
        losses.append(float(grad_step(leaves, batch, None)[0]))
        res[w] = dict(grads=grads_host, aggs=aggs, losses=losses,
                      split=split[warm:],
                      leaves=[l.cpu().numpy() for l in leaves])

    run_hips(worker, init_keys(np, [np.zeros(np.shape(l), np.float32)
                                    for l in leaves0]),
             f"phase9a {policy or 'raw'}",
             barriers=[bar],
             topo_kw={"device": dev, "extra_cfg": {
                 "wire_codec": policy,
                 "wire_2bit_threshold": P["threshold"],
                 "size_lower_bound": P["size_lower_bound"],
                 "p3_slice_bytes": P["slice_bytes"]}})
    return res, counts, wan


def phase9a(torch, np, fa, tb, dense, dev="cuda"):
    """The quantized combined wire at the 59M decoder's width:
    ``GEOMX_WIRE_CODEC`` "", fp16, 2bit and mpq in turn over a live 2 x 1
    HiPS, P3 chunks of 4 MiB. Every counted round's aggregate on both
    workers against the host replay of the four legs, the replicas bit
    for bit, the two_bit launches against the plan's 2-bit entries, the
    WAN bytes against the payload counted from the shapes and codecs,
    2bit at least 4x below raw, falling losses; the step split beside
    phase 4b's dense wire. Returns the launches of each policy's counted
    rounds."""
    from geomx_tpu_torch.examples.transformer_bsc_device import \
        build_transformer_grad_step

    P = PHASE9
    leaves0, grad_step = build_transformer_grad_step(
        **MODEL, compute_dtype=torch.bfloat16, device=dev, attn="auto")
    sizes = [int(np.asarray(l).size) for l in leaves0]
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    R, warm = P["warm"] + P["rounds"], P["warm"]
    launches, wan_of, n2bit = {}, {}, {}
    raw_framing = None
    for policy in P["policies"]:
        name = policy or "raw"
        t = time.perf_counter()
        res, counts, wan = quant_wire_round(torch, np, fa, tb, policy,
                                            leaves0, grad_step, dev)
        plan = wan["plan"]
        n2bit[name] = sum(1 for e in plan if e[3] == "2bit")
        launches[name] = counts
        # the aggregates against the host replay, every counted round
        t_r = time.perf_counter()
        want = wire_replay(torch, np, [res[0]["grads"], res[1]["grads"]],
                           plan, starts, P["threshold"], warm)
        for w in (0, 1):
            for rnd, (a, b) in enumerate(zip(res[w]["aggs"], want)):
                if not np.array_equal(a, b):
                    bad = int(np.count_nonzero(a != b))
                    fail(f"phase9a {name}: worker {w} round {warm + rnd}: "
                         f"{bad} of {a.size} aggregate elements differ from "
                         "the host replay of the four legs")
        replay_s = time.perf_counter() - t_r
        check_replicas(np, [res[0]["leaves"], res[1]["leaves"]],
                       f"phase9a {name}")
        # the kernel once per 2-bit entry, per worker and round
        want_tb = 2 * P["rounds"] * n2bit[name] if dev == "cuda" else 0
        if counts["two_bit"] != want_tb:
            fail(f"phase9a {name}: two_bit launched {counts['two_bit']} "
                 f"times in {P['rounds']} rounds of 2 workers, expected "
                 f"{want_tb} ({n2bit[name]} 2-bit entries per push)")
        want_fa = 2 * MODEL["depth"] * P["rounds"] if dev == "cuda" else 0
        for key in KERNELS:
            if counts[key] != want_fa:
                fail(f"phase9a {name}: {key} launched {counts[key]} times, "
                     f"expected {want_fa}")
        # WAN bytes per round against the payload from shapes and codecs
        per_round = wan["bytes"] / P["rounds"]
        msgs = wan["msgs"] / P["rounds"]
        payload = wan_by_codec_payload(plan)
        got = {c: v / P["rounds"] for c, v in wan["by_codec"].items()}
        framing = (per_round - sum(payload.values())) / max(msgs, 1)
        if raw_framing is None:
            raw_framing = framing
        wan_of[name] = per_round
        for l in (0, 1):
            x = res[l]["losses"][warm:]
            if not all(math.isfinite(v) for v in x) or not x[-1] < x[0]:
                fail(f"phase9a {name}: worker {l} counted losses {x} are "
                     "not finite and falling")
        print(f"[phase9a] {name}: {len(plan)} entries per push, "
              f"{n2bit[name]} of them 2-bit; losses "
              f"{[round(v, 5) for v in res[0]['losses']]} (worker 0), "
              f"{[round(v, 5) for v in res[1]['losses']]} (worker 1); "
              f"launches in the {P['rounds']} counted rounds {counts}",
              flush=True)
        print(f"[phase9a] {name}: WAN {per_round:.1f} bytes in {msgs:.1f} "
              f"messages per round, by codec "
              f"{ {c: round(v, 1) for c, v in got.items()} }, payload from "
              f"the shapes {payload}, framing {framing:.1f} B per message; "
              f"replay of {R} rounds {replay_s:.1f} s, run "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        for w in (0, 1):
            print(f"[phase9a] {name}: worker {w} split medians of "
                  f"{P['rounds']} rounds (ms) {medians(res[w]['split'])}",
                  flush=True)
        for c in set(payload) | set(got):
            lo = payload.get(c, 0)
            hi = lo + msgs * 2 * max(raw_framing, 0.0)
            if not lo <= got.get(c, 0) <= hi:
                fail(f"phase9a {name}: {got.get(c, 0)} {c} WAN bytes per "
                     f"round, outside the payload {lo} plus twice the raw "
                     f"run's {raw_framing:.1f} B of framing per message")
        del res
    if dense is not None:
        print(f"[phase9a] phase 4b's dense wire (ms, pipelined BSC "
              f"trainer, same run) {dense['wire_ms']}", flush=True)
    ratio = wan_of["raw"] / wan_of["2bit"]
    print(f"[phase9a] WAN bytes per round {wan_of}; raw / 2bit "
          f"{ratio:.2f}x; 2-bit entries per push {n2bit}", flush=True)
    if ratio < 4.0:
        fail(f"phase9a: 2bit moves {ratio:.2f}x fewer WAN bytes than raw, "
             "below the 4x gate (bench.py:1140-1148)")
    if not (n2bit["fp16"] == n2bit["raw"] == 0
            and 0 < n2bit["mpq"] < n2bit["2bit"]):
        fail(f"phase9a: 2-bit entries per push {n2bit}: expected none for "
             "raw and fp16 and fewer for mpq than for 2bit")
    return launches


def phase9b(torch, np, tb, dev="cuda"):
    """``bench.py`` ``_quant_wire_parity`` on the card: 2 workers of a
    linear regression (d 256, 64 samples each), 200 rounds of the
    combined wire with the gradients as tensors on ``dev``, SGD on the
    aggregate; the 2-bit wire's final loss within QUANT_PARITY_TOL of
    the raw wire's. Returns the 2-bit run's two_bit launches."""
    P = PHASE9["parity"]
    losses, launches = {}, {}
    for policy in ("", "2bit"):
        out_l = {}

        def worker(kv, w):
            d, n = P["d"], P["n"]
            w_true = (np.random.RandomState(7).randn(d)
                      / np.sqrt(d)).astype(np.float32)
            rng = np.random.RandomState(42 + w)
            X = torch.as_tensor(rng.randn(n, d).astype(np.float32),
                                device=dev)
            y = X @ torch.as_tensor(w_true, device=dev)
            wv = torch.zeros(d, device=dev)
            kv.init(0, np.zeros(d, np.float32))
            kv.wait()
            out = np.zeros(d, np.float32)
            for _ in range(P["rounds"]):
                grad = (2.0 / n) * (X.T @ (X @ wv - y))
                kv.push_pull_async(0, grad, out).wait(timeout=JOIN_S)
                wv -= P["lr"] * torch.from_numpy(out).to(dev) / 2.0
            r = X @ wv - y
            out_l[w] = float((r * r).mean())

        def master(kv):
            kv.init(0, np.zeros(P["d"], np.float32))
            kv.wait()

        reset([tb.LAUNCHES])
        run_hips(worker, master, f"phase9b {policy or 'raw'}",
                 topo_kw={"device": dev, "extra_cfg": {
                     "wire_codec": policy,
                     "wire_2bit_threshold": P["threshold"]}})
        launches[policy or "raw"] = tb.LAUNCHES["two_bit"]
        losses[policy or "raw"] = (out_l[0] + out_l[1]) / 2
    gap = losses["2bit"] - losses["raw"]
    print(f"[phase9b] linear regression d {P['d']}, {P['rounds']} rounds: "
          f"final loss raw {losses['raw']:.6f}, 2bit {losses['2bit']:.6f} "
          f"(gap {gap:.6f}, gate {PHASE9['parity_tol']}); two_bit launches "
          f"{launches}", flush=True)
    want = 2 * P["rounds"] if dev == "cuda" else 0
    if launches["2bit"] != want or launches["raw"] != 0:
        fail(f"phase9b: two_bit launches {launches}, expected {want} for "
             "2bit (one per push) and none for raw")
    if not math.isfinite(gap) or gap > PHASE9["parity_tol"]:
        fail(f"phase9b: the 2-bit wire's loss is {gap} above the raw "
             f"wire's, over the {PHASE9['parity_tol']} gate")
    return launches["2bit"]


def phase9c(dev):
    """Two cases of ``run_chaos_matrix.sh`` as separate processes, every
    worker through ``--worker``, all at once: quant-wire (the 2-bit wire
    under drops and duplicates, resender and wire sanitizer on) beside the
    same recipe with an empty plan, and server-kill (party A's server
    crashed by ``CHAOS_PLAN_SERVER_A``, a replacement restoring the
    snapshot). Every role exits 0, every worker completes every round in
    lockstep, no sanitizer marker in any log. Returns the two_bit
    launches of the worker processes."""
    import re
    from concurrent.futures import ThreadPoolExecutor

    P = PHASE9
    root = os.path.dirname(os.path.abspath(__file__))
    base = os.path.join(root, "logs", "chip_smoke")
    thr = {"GEOMX_WIRE_2BIT_THRESHOLD": repr(P["matrix_threshold"])}
    runs = (("quant-wire", "quant-wire", thr),
            ("clean/quant-wire", "quant-wire",
             {"FAULT_FREE": "1", "PORT_OFFSET": "300", **thr}),
            ("server-kill", "server-kill", {}))
    iters = ["--max-iters", str(P["matrix_iters"])]
    with ThreadPoolExecutor(len(runs)) as pool:
        futures = [pool.submit(
            launch, tag,
            ["bash", "geomx_tpu_torch/scripts/run_chaos_matrix.sh", *iters],
            dev, P["timeout_9c"],
            {"CASES": case, "LOG_ROOT": os.path.dirname(
                os.path.join(base, tag)), **env})
            for tag, case, env in runs]
        all_logs = [f.result() for f in futures]
    out = {}
    for (tag, case, _env), logs in zip(runs, all_logs):
        marked = [n for n, text in logs.items()
                  if "SANITIZER VIOLATION" in text]
        if marked:
            fail(f"phase9c {tag}: sanitizer violations in {marked}")
        ws, master = workers_of(logs)
        reps = [report(w, f"9c {tag}", f"worker {i}", dev)
                for i, w in enumerate(ws)]
        report(master, f"9c {tag}", "master", dev)
        accs = [[float(a) for _i, a in re.findall(ACC_RE, w)] for w in ws]
        lockstep(accs, f"9c {tag}", "per-round accuracies")
        if len(accs[0]) != P["matrix_iters"]:
            fail(f"phase9c {tag}: {len(accs[0])} rounds, not "
                 f"{P['matrix_iters']}")
        if len(set(accs[0])) == 1:
            fail(f"phase9c {tag}: the accuracy never moved: {accs[0]}")
        lockstep([[r["digest"]] for r in reps], f"9c {tag}",
                 "parameter digests")
        out[tag] = dict(launches=[r["launches"]["two_bit"] for r in reps],
                        digest=reps[0]["digest"], acc=accs[0][-1],
                        respawn="server_A_respawn.log" in logs and any(
                            "crashing van" in text for text in logs.values()))
        print(f"[phase9c] {tag}: every role exited 0, {len(ws)} workers in "
              f"lockstep for {P['matrix_iters']} rounds, last accuracy "
              f"{accs[0][-1]:.4f}, two_bit launches per worker process "
              f"{out[tag]['launches']}, parameters sha256 "
              f"{out[tag]['digest']}", flush=True)
    if not out["server-kill"]["respawn"]:
        fail("phase9c server-kill: the crash did not fire or no "
             "replacement server ran")
    same = out["quant-wire"]["digest"] == out["clean/quant-wire"]["digest"]
    print(f"[phase9c] quant-wire under drops and duplicates "
          f"{out['quant-wire']['digest']}, fault-free "
          f"{out['clean/quant-wire']['digest']}: "
          + ("the same parameters" if same else
             "the parameters differ (the resender replays the bytes as "
             "built, so they were expected to be equal)"), flush=True)
    return sum(sum(o["launches"]) for o in out.values())


def zoo_batch(torch, name, B, dev, gen):
    """A seeded batch for zoo model ``name``: NHWC images or token ids,
    and labels (per token for the language models)."""
    V = 1000
    if name.endswith("_lm"):
        X = torch.randint(0, V, (B, PHASE10["seq"]), generator=gen)
        y = torch.randint(0, V, (B, PHASE10["seq"]), generator=gen)
    else:
        s = 299 if name == "inceptionv3" else 224
        X = torch.randn(B, s, s, 3, generator=gen)
        y = torch.randint(0, V, (B,), generator=gen)
    return X.to(dev), y.to(dev)


def zoo_step(torch, net, table, name):
    """The examples' train step on a zoo module: ``(leaves, X, y, rng) ->
    (loss, gradient leaves)`` in flax layouts, train mode."""
    from geomx_tpu_torch.models import convert

    def step(leaves, X, y, rng):
        leaves = [l.detach().requires_grad_(True) for l in leaves]
        kw = {} if name.endswith("_lm") else {"train": True, "rng": rng}
        logits = torch.func.functional_call(
            net, convert.zoo_params_from_flax(table, leaves), (X,), kw)
        logp = torch.log_softmax(logits.to(leaves[0].dtype), -1)
        loss = -logp.gather(-1, y[..., None].long()).mean()
        return loss, torch.autograd.grad(loss, leaves)

    return step


def step_times(torch, fn, reps, dev, warmup=2):
    """ms of each of ``reps`` calls of ``fn`` (after ``warmup``): CUDA
    events around the call after a synchronize on the card, the host's
    clock on the CPU; and the losses ``fn`` returned."""
    ms, losses = [], []
    for i in range(warmup + reps):
        if dev == "cuda":
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            loss = fn()
            b.record()
            torch.cuda.synchronize()
            took = a.elapsed_time(b)
        else:
            t = time.perf_counter()
            loss = fn()
            took = (time.perf_counter() - t) * 1e3
        if i >= warmup:
            ms.append(took)
            losses.append(float(loss.detach()))
    return ms, losses


def phase10a(torch, np, dev="cuda"):
    """The zoo at published widths: parameter counts against the JAX
    package's, the card's float32 train step against float64 on the CPU
    from the same leaves (dropout off on both: its masks are each
    device's own), and the step's time at batch 32."""
    import copy
    from unittest import mock

    from geomx_tpu_torch._device import exact_cudnn
    from geomx_tpu_torch.models import convert, zoo

    if dev == "cuda":
        exact_cudnn()
    out = {}
    for name in ZOO10:
        lm = name.endswith("_lm")
        kw = {} if lm else {"input_shape": (299, 299, 3) if
                            name == "inceptionv3" else (224, 224, 3)}
        net = zoo.get_model(name, num_classes=1000, **kw)
        n = sum(p.numel() for p in net.parameters())
        print(f"[phase10a] {name}: {n:,} parameters (the JAX package: "
              f"{JAX_PARAMS[name]:,})", flush=True)
        if n != JAX_PARAMS[name]:
            fail(f"phase10a {name}: {n} parameters, the JAX package has "
                 f"{JAX_PARAMS[name]}")
        table = convert.zoo_leaves(net)
        leaves = [torch.tensor(l) for l in convert.zoo_flax_leaves(net)]
        gen = torch.Generator().manual_seed(10)
        X, y = zoo_batch(torch, name, PHASE10["check_batch"], "cpu", gen)
        ref = copy.deepcopy(net).double()
        with mock.patch.object(zoo, "dropout", lambda x, *a, **k: x):
            r_loss, r_grads = zoo_step(torch, ref, table, name)(
                [l.double() for l in leaves], X, y, None)
            ref = ref.to(dev)       # the same step in float64 on the card
            d_loss, d_grads = zoo_step(torch, ref, table, name)(
                [l.double().to(dev) for l in leaves], X.to(dev), y.to(dev),
                None)
            del ref
            # the CPU's own float32 step (torch's native convolutions):
            # how far float32 itself lands from float64 here
            mkldnn = torch.backends.mkldnn.enabled
            torch.backends.mkldnn.enabled = False
            try:
                c_loss, c_grads = zoo_step(torch, net, table, name)(
                    leaves, X, y, None)
            finally:
                torch.backends.mkldnn.enabled = mkldnn
            net = net.to(dev)
            t_loss, t_grads = zoo_step(torch, net, table, name)(
                [l.to(dev) for l in leaves], X.to(dev), y.to(dev), None)
        r_loss, d_loss, t_loss, c_loss = (float(v.detach()) for v in
                                          (r_loss, d_loss, t_loss, c_loss))
        whole = math.sqrt(sum(float((g * g).sum()) for g in r_grads))
        f64_worst = 0.0
        for (path, _n, _k), g, r in zip(table, d_grads, r_grads):
            err = float((g.cpu() - r).norm())
            bound = PHASE10["f64_tol"] * (float(r.norm()) + whole)
            f64_worst = max(f64_worst, err / bound)
            if not err <= bound:
                fail(f"phase10a {name}: float64 gradient {path} on the card "
                     f"off by {err:.3e} from the CPU's, over {bound:.3e}")
        if not abs(d_loss - r_loss) <= PHASE10["f64_tol"] * abs(r_loss):
            fail(f"phase10a {name}: float64 loss {d_loss} on the card, "
                 f"{r_loss} on the CPU")
        worst, worst_path, err2, cpu2, within = 0.0, "", 0.0, 0.0, 0
        for (path, _n, _k), g, c, r in zip(table, t_grads, c_grads,
                                           r_grads):
            err = float((g.double().cpu() - r).norm())
            cpu = float((c.double() - r).norm())
            err2, cpu2 = err2 + err * err, cpu2 + cpu * cpu
            within += err <= PHASE10["grad_tol"] * float(r.norm())
            ratio = err / max(float(r.norm()), 1e-300)
            if ratio > worst:
                worst, worst_path = ratio, path
        grad_rel, cpu_rel = math.sqrt(err2) / whole, math.sqrt(cpu2) / whole
        rel = abs(t_loss - r_loss) / abs(r_loss)
        cpu_loss = abs(c_loss - r_loss) / abs(r_loss)
        if not (math.isfinite(t_loss) and rel <= max(
                PHASE10["loss_tol"], PHASE10["whole_factor"] * cpu_loss)):
            fail(f"phase10a {name}: loss {t_loss} on the card, {r_loss} in "
                 f"float64 on the CPU, {c_loss} in float32 there")
        # the float32 gradient is gated where float32 can meet the bound:
        # where the CPU's own float32 step lands within it
        gated = cpu_rel <= PHASE10["grad_tol"]
        if gated and not grad_rel <= max(PHASE10["grad_tol"],
                                         PHASE10["whole_factor"] * cpu_rel):
            fail(f"phase10a {name}: float32 gradient {grad_rel:.3e} (relative "
                 f"norm) from float64; the CPU's float32 {cpu_rel:.3e}")
        # the step at batch 32 (dropout on, its generator on the card)
        Xb, yb = zoo_batch(torch, name, PHASE10["time_batch"], dev, gen)
        dl = [l.to(dev) for l in leaves]
        step = zoo_step(torch, net, table, name)
        rng = torch.Generator(device=dev).manual_seed(7)

        ms, losses = step_times(torch, lambda: step(dl, Xb, yb, rng)[0],
                                PHASE10["time_reps"], dev)
        if not all(math.isfinite(l) for l in losses):
            fail(f"phase10a {name}: non-finite loss at batch "
                 f"{PHASE10['time_batch']}")
        med = statistics.median(ms)
        unit = "sequences" if lm else "images"
        out[name] = {"params": n, "step_ms": med, "loss_rel": rel,
                     "grad_rel": grad_rel, "cpu_grad_rel": cpu_rel,
                     "gated": gated}
        print(f"[phase10a] {name}: float64 on {dev} = on the CPU (worst leaf "
              f"at {f64_worst:.2e} of its bound); float32 loss {t_loss:.6f} "
              f"on {dev}, {r_loss:.6f} in float64 (rel {rel:.2e}; the CPU's "
              f"float32 {cpu_loss:.2e}); float32 gradient {grad_rel:.2e} "
              f"from float64 (relative norm; the CPU's float32 "
              f"{cpu_rel:.2e}; {within} of {len(table)} leaves within "
              f"{PHASE10['grad_tol']} of their norm, the worst "
              f"{worst_path} at {worst:.2e}; "
              f"{'gated' if gated else 'not gated: float32 itself is off'}"
              f"); train "
              f"step (forward + backward) "
              f"at batch {PHASE10['time_batch']}: median {med:.3f} ms of "
              f"{len(ms)}, min {min(ms):.3f}, "
              f"{PHASE10['time_batch'] / med * 1e3:.1f} {unit}/s",
              flush=True)
        del net, dl, Xb, yb, leaves
        if dev == "cuda":
            torch.cuda.empty_cache()
    return out


def phase10b(torch, np, framing_per_key, dev="cuda"):
    """examples/cnn.py --model resnet50 -dt cifar10 through live HiPS:
    two parties x one worker, server Adam, the combined dense round."""
    from geomx_tpu_torch.examples import cnn

    tag, rounds, B = "phase10b", PHASE10["hips_rounds"], PHASE10["hips_batch"]
    res, (wan_round, msgs) = run_feature(
        torch, np, cnn, ["--model", "resnet50", "-dt", "cifar10"], tag,
        rounds, dev, batch=B)
    sizes = [l.size for l in res[0]["leaves"]]
    if (len(sizes), sum(sizes)) != (161, PHASE10["resnet50_cifar_params"]):
        fail(f"{tag}: {len(sizes)} leaves of {sum(sizes)} parameters, "
             "not ResNet-50's 161 of 23,520,842")
    payload = wan_payload(sizes, "dense")[0]
    leg = 4 * sum(sizes)
    # a combined round's message frames each of its keys (5a measured the
    # framing over LeNet's 10); as phase 5 allows its codecs, up to twice
    framing = 2 * framing_per_key * len(sizes)
    check_replicas(np, [res[0]["leaves"], res[1]["leaves"]], tag)
    for w in (0, 1):
        if not all(math.isfinite(l) for l in res[w]["losses"]):
            fail(f"{tag}: worker {w} non-finite loss {res[w]['losses']}")
    steps = [res[w]["step_ms"][1:] for w in (0, 1)]     # round 1 warms up
    img_s = 2 * B * (rounds - 1) / max(sum(x) for x in steps) * 1e3
    wire = [statistics.median(res[w]["wire_ms"][1:]) for w in (0, 1)]
    step = [statistics.median(x) for x in steps]
    print(f"[{tag}] ResNet-50 (CIFAR stem) {len(sizes)} leaves, "
          f"{sum(sizes):,} parameters: {leg:,} bytes a leg per worker; "
          f"{wan_round:.1f} WAN bytes in {msgs:.2f} messages per round "
          f"(payload {payload:,} = 4 legs, framing "
          f"{(wan_round - payload) / msgs:.1f} bytes a message, "
          f"{(wan_round - payload) / msgs / len(sizes):.2f} a key; 5a's "
          f"{framing_per_key:.2f} a key)", flush=True)
    print(f"[{tag}] per-round wire ms (combined push_pull) median "
          f"{wire[0]:.3f} / {wire[1]:.3f}; step ms (gradients + wire) "
          f"median {step[0]:.3f} / {step[1]:.3f}; {img_s:.1f} img/s (both "
          f"workers); losses {[round(l, 4) for l in res[0]['losses']]}",
          flush=True)
    if not payload <= wan_round <= payload + msgs * framing:
        fail(f"{tag}: {wan_round} WAN bytes per round, not the dense "
             f"payload {payload} of the 161 leaves plus {framing:.1f} bytes "
             f"of framing for each of {msgs:.2f} messages")
    return {"wire_ms": wire, "step_ms": step, "img_s": img_s,
            "wan_round": wan_round}


def phase10c(torch, np, dev="cuda"):
    """The records path on the card: raw CIFAR-shaped records (class =
    dominant channel) through ImageRecordIter + ImageAugmenter (random
    crop and mirror) + PrefetchIter into build_model_and_step("resnet18",
    num_classes=3), Adam at lr 1e-3 (``torch.optim.Adam`` stands in for
    optax: a yardstick). Pillow is made unimportable for the phase: raw
    records need none."""
    import tempfile
    from unittest import mock

    from geomx_tpu_torch.examples.utils import build_model_and_step
    from geomx_tpu_torch.io import (ImageAugmenter, ImageRecordIter,
                                    IRHeader, MXRecordIO, PrefetchIter,
                                    pack_array)

    B = PHASE10["record_batch"]
    rng = np.random.RandomState(0)
    with tempfile.TemporaryDirectory() as d, \
            mock.patch.dict(sys.modules, {"PIL": None}):
        path = os.path.join(d, "cifar.rec")
        with MXRecordIO(path, "w") as w:
            for i in range(PHASE10["records"]):
                cls = i % 3
                img = rng.randint(0, 64, (32, 32, 3), np.uint8)
                img[..., cls] = rng.randint(160, 256, (32, 32), np.uint8)
                w.write(pack_array(IRHeader(0, float(cls), i, 0), img))
        aug = ImageAugmenter((32, 32, 3), rand_crop=True, rand_mirror=True,
                             seed=5)
        it = ImageRecordIter(path, (32, 32, 3), batch_size=B, shuffle=True,
                             aug=aug, seed=5)
        leaves, _n, grad_step, _e = build_model_and_step(
            B, input_shape=(32, 32, 3), model="resnet18", num_classes=3,
            device=dev)
        params = [torch.tensor(l, device=dev) for l in leaves]
        opt = torch.optim.Adam(params, lr=1e-3)
        losses = []
        for _ in range(PHASE10["record_epochs"]):
            for X, y in PrefetchIter(it, prefetch=2):
                loss, grads = grad_step(
                    params, torch.as_tensor(X, device=dev),
                    torch.as_tensor(y.astype(np.int64), device=dev))
                for p, g in zip(params, grads):
                    p.grad = g
                opt.step()
                losses.append(float(loss))
    print(f"[phase10c] {PHASE10['records']} raw records, "
          f"{len(losses)} Adam steps of {B} through the reader, the "
          f"augmenter and the prefetcher: losses "
          f"{[round(l, 4) for l in losses]}", flush=True)
    if len(losses) != 12 or not all(math.isfinite(l) for l in losses):
        fail(f"phase10c: {len(losses)} steps, losses {losses}")
    if not losses[-1] < losses[0]:
        fail(f"phase10c: the loss did not fall: {losses}")


PHASE11_TAG = "phase11b_rank "      # the line a --party-rank process ends with


def phase11a(torch, np, qc, pmesh, dev="cuda"):
    """geomx_tpu_torch/scripts/run_mesh_multihost.sh with 2 and then 4
    processes, every codec in turn in one group, n = 1<<16 (the
    JAX script's): every process's output bit-identical to every other's
    and to the one-process QuantRingReducer on a PartyMesh of the same P
    fed the same seeded rows (none: within PHASE11["none_tol"] of the
    largest magnitude), two_bit launched in every process under 2bit.
    Returns the two_bit launches of every process, by P."""
    import re

    P11 = PHASE11
    n = P11["n"]

    def run(P):
        tag = f"11a-P{P}"
        out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "logs", "chip_smoke", f"{tag}-out")
        shutil.rmtree(out_dir, ignore_errors=True)
        os.makedirs(out_dir)
        logs = launch(tag, ["bash",
                            "geomx_tpu_torch/scripts/run_mesh_multihost.sh",
                            str(P)], dev, P11["timeout"],
                      env={"COORD": f"127.0.0.1:{free_ports(1)[0]}",
                           "CODECS": " ".join(MESH_CODECS), "N": str(n),
                           "OUT_DIR": out_dir})
        return logs["foreground"], out_dir

    results = {P: run(P) for P in P11["sizes"]}
    launches = {}
    for P, (text, out_dir) in results.items():
        for line in text.splitlines():
            if line.startswith("proc ") or line.startswith("==="):
                print(f"[phase11a P={P}] {line}", flush=True)
        if len(re.findall(r"global_worker=True", text)) != 1:
            fail(f"phase11a P={P}: not exactly one global worker")
        rows = np.stack([np.random.RandomState(r).randn(1, n).astype(
            np.float32)[0] for r in range(P)])
        mesh = pmesh.make_party_mesh(P, device=dev)
        for codec in MESH_CODECS:
            want = qc.QuantRingReducer(mesh, codec, n, mean=True).reduce(
                torch.from_numpy(rows).to(dev))[0].cpu().numpy()
            got = [np.load(os.path.join(out_dir, f"proc{r}_{codec}.npy"))
                   for r in range(P)]
            if any(not np.array_equal(g, got[0]) for g in got):
                fail(f"phase11a P={P} {codec}: the processes' outputs differ")
            err = float(np.abs(got[0] - want).max())
            if codec == "none":
                if err > P11["none_tol"] * float(np.abs(want).max()):
                    fail(f"phase11a P={P} none: {err} from one process's")
            elif err != 0.0:
                fail(f"phase11a P={P} {codec}: {err} from the one-process "
                     "ring, not bit for bit")
            print(f"[phase11a P={P}] {codec}: {P} processes bit-identical, "
                  f"max |process - one-process ring| {err}", flush=True)
        counts = [int(c) for c in
                  re.findall(r"codec=2bit .* two_bit=(\d+)", text)]
        print(f"[phase11a P={P}] two_bit launches per process under 2bit: "
              f"{counts}", flush=True)
        if len(counts) != P or (dev == "cuda" and min(counts) == 0):
            fail(f"phase11a P={P}: two_bit launches {counts}")
        launches[P] = counts
    return launches


def party_rank(argv):
    """``chip_smoke.py --party-rank <json>``: one rank of 11b's party,
    this process one of its ranks (the GEOMX_MESH_* settings in the
    environment): phase 3d's model, batches and warm-up, then the counted
    steps through ``DataParallelTrainer.step`` with the 2-bit ring across
    the processes. Prints one JSON line: rank, losses, launches and the
    split of each step, and the sha256 of the final parameters."""
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from geomx_tpu_torch import config as cfg_mod
    from geomx_tpu_torch.examples.transformer_bsc_device import synth_batch
    from geomx_tpu_torch.kvstore.mesh_party import maybe_init_multihost
    from geomx_tpu_torch.models.transformer import (Transformer,
                                                    make_attention)
    from geomx_tpu_torch.ops import flash_attention as fa
    from geomx_tpu_torch.ops import two_bit as tb
    from geomx_tpu_torch.parallel import mesh as pmesh
    from geomx_tpu_torch.parallel import quant_collectives as qc
    from geomx_tpu_torch.parallel.train_step import DataParallelTrainer

    a = json.loads(argv[0])
    model_cfg, dev = a["model"], a["dev"]
    if not maybe_init_multihost(cfg_mod.load()):
        fail("party rank: the GEOMX_MESH_* settings formed no group")
    t = time.perf_counter()
    mesh = pmesh.make_party_mesh(0, device=dev)
    model = Transformer(vocab=model_cfg["vocab"], dim=model_cfg["dim"],
                        depth=model_cfg["depth"], heads=model_cfg["heads"],
                        max_len=model_cfg["seq_len"],
                        attn_fn=make_attention("auto"),
                        compute_dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(42))
    tr = DataParallelTrainer(model, torch.optim.SGD(model.parameters(),
                                                    lr=a["lr"]),
                             mesh, num_classes=model_cfg["vocab"])
    n = sum(p.numel() for p in tr.params)
    rng = np.random.default_rng(4321)
    batches = [synth_batch(rng, a["batch"], model_cfg["seq_len"],
                           model_cfg["vocab"])
               for _ in range(a["warm_index"] + 1)]
    # phase 3d's warm-up step on a throwaway reducer: the counted run
    # starts at zero residual from the same parameters as 3d's
    warm = batches[a["warm_index"]]
    tr.step(warm[:, :-1], warm[:, 1:], reducer=qc.QuantRingReducer(
        mesh, "2bit", n, mean=True, threshold=a["threshold"]))
    red = qc.QuantRingReducer(mesh, "2bit", n, mean=True,
                              threshold=a["threshold"])
    setup = time.perf_counter() - t
    counters = [fa.LAUNCHES, tb.LAUNCHES]
    reset(counters)
    losses, launches, splits = [], [], []
    for toks in batches[:a["steps"]]:
        before = {k: v for c in counters for k, v in c.items()}
        timings = {}
        losses.append(tr.step(toks[:, :-1], toks[:, 1:], reducer=red,
                              timings=timings))
        launches.append({k: v - before[k] for c in counters
                         for k, v in c.items()})
        splits.append({k: round(v * 1e3, 3) for k, v in timings.items()})
    digest = param_digest(tr.params)
    finite = all(bool(torch.isfinite(p).all()) for p in tr.params)
    print(PHASE11_TAG + json.dumps({
        "rank": mesh.rank, "size": mesh.size, "device": str(mesh.device),
        "params": n, "losses": losses, "launches": launches,
        "split_ms": splits, "digest": digest, "finite": finite,
        "setup_s": round(setup, 1),
        "wire_bytes_per_round": red.wire_bytes_per_round()}), flush=True)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def phase11b(np, losses3d, digest3d, dev="cuda"):
    """Phase 3d's configuration with each of its two ranks a process of
    its own: the 59M decoder at full width, phase 3d's batches (8 a
    step, 4 per rank), its warm-up step, then PHASE11["steps"] counted
    steps of local grads, the 2-bit ring across the processes
    (threshold PARTY_THRESHOLD, mean) and SGD. Checks the launches per
    process and step (MODEL["depth"] of each flash kernel, PARTY
    two_bit: one per hop's quantize), the ranks' losses and parameters
    identical, their parameters equal to phase 3d's one-process party's
    after as many steps from the same seeds (``digest3d``), and the
    losses within PHASE11["loss_tol"] of 3d's. Returns the launches per
    process per step."""
    import signal

    P11 = PHASE11
    arg = json.dumps({"model": MODEL, "dev": dev, "lr": PARTY_LR,
                      "batch": BATCH, "steps": P11["steps"],
                      "warm_index": STEPS, "threshold": PARTY_THRESHOLD})
    coord = f"127.0.0.1:{free_ports(1)[0]}"
    t = time.perf_counter()
    procs = []
    for r in range(PARTY):
        env = dict(os.environ, GEOMX_MESH_COORDINATOR=coord,
                   GEOMX_MESH_NUM_PROCS=str(PARTY), GEOMX_MESH_PROC_ID=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--party-rank", arg],
            env=env, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, start_new_session=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, P11["timeout"] - (time.perf_counter() - t)))
                [0])
    except subprocess.TimeoutExpired:
        for p in procs:
            os.killpg(p.pid, signal.SIGKILL)
        for p in procs:
            print(p.communicate()[0][-3000:], file=sys.stderr)
        fail(f"phase11b: the party did not finish in {P11['timeout']} s")
    reps = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        found = [l for l in out.splitlines() if l.startswith(PHASE11_TAG)]
        if p.returncode != 0 or len(found) != 1:
            print(out[-4000:], file=sys.stderr)
            fail(f"phase11b: rank process {r} exited {p.returncode}")
        reps.append(json.loads(found[0][len(PHASE11_TAG):]))
    wall = time.perf_counter() - t
    want = {"two_bit": PARTY, **{k: MODEL["depth"] for k in KERNELS}}
    for rep in reps:
        print(f"[phase11b] rank {rep['rank']} of {rep['size']} on "
              f"{rep['device']}: {rep['params']} params, set-up + warm-up "
              f"{rep['setup_s']} s, losses {rep['losses']}, parameters "
              f"sha256 {rep['digest']}", flush=True)
        for i, (counts, split) in enumerate(zip(rep["launches"],
                                                rep["split_ms"])):
            print(f"[phase11b] rank {rep['rank']} step {i + 1}: launches "
                  f"{counts}; local_grads {split['local_grads']} ms, "
                  f"quantize {split['quantize']}, D2H + gloo + H2D "
                  f"{split['hop']}, dequantize {split['dequantize']}, "
                  f"apply {split['apply']}", flush=True)
            if dev == "cuda" and counts != want:
                fail(f"phase11b rank {rep['rank']} step {i + 1}: launches "
                     f"{counts}, expected {want}")
        if not rep["finite"] or not all(math.isfinite(v)
                                        for v in rep["losses"]):
            fail(f"phase11b rank {rep['rank']}: non-finite")
    if any(r["losses"] != reps[0]["losses"] or r["digest"] != reps[0]["digest"]
           for r in reps):
        fail("phase11b: the ranks' losses or parameters differ")
    gaps = [abs(a - b) for a, b in zip(reps[0]["losses"], losses3d)]
    print(f"[phase11b] losses {reps[0]['losses']} against phase 3d's one-"
          f"process party {losses3d[:len(gaps)]}: largest gap {max(gaps)} "
          f"(bound {P11['loss_tol']}); parameters sha256 "
          f"{reps[0]['digest']}, 3d's after {P11['steps']} steps "
          f"{digest3d}; {PARTY} processes, {wall:.1f} s", flush=True)
    if max(gaps) > P11["loss_tol"]:
        fail(f"phase11b: losses {max(gaps)} from phase 3d's")
    if reps[0]["digest"] != digest3d:
        fail(f"phase11b: parameters {reps[0]['digest']} after "
             f"{P11['steps']} steps, phase 3d's {digest3d}")
    return [r["launches"] for r in reps]


def phase11c(dev, accs7c, digest7c):
    """Phase 7c's recipe with MESH_PROCS=2: LeNet, 2 parties x 2 rank
    processes (12 processes), GEOMX_MESH_CODEC=2bit at 7c's threshold and
    rounds. Every rank prints the accuracy: the four must be in
    lockstep, their parameters equal, both equal to 7c's (``accs7c``,
    ``digest7c``: the same recipe with each party one process), two_bit
    launched in each, every role's exit code 0. Returns the launches
    summed over the ranks."""
    import re

    P = PHASE7
    root = os.path.dirname(os.path.abspath(__file__))
    codes_file = os.path.join(root, "logs", "chip_smoke", "11c-exit-codes")
    if os.path.exists(codes_file):
        os.remove(codes_file)
    mport = free_ports(2)
    logs = launch("11c", ["bash", "geomx_tpu_torch/scripts/run_mesh_hips.sh",
                          "--max-iters", str(P["mesh_rounds"]), "-bs",
                          str(2 * LENET["batch"])], dev, P["timeout_short"],
                  env={"MESH_PROCS": "2", "GEOMX_MESH_CODEC": "2bit",
                       "GEOMX_WIRE_2BIT_THRESHOLD":
                           repr(MESH6["lenet_2bit_threshold"]),
                       "MPORT_A": str(mport[0]), "MPORT_B": str(mport[1]),
                       "EXIT_CODES_FILE": codes_file})
    ranks = {"party 0 rank 0": logs["mesh_w0.log"],
             "party 0 rank 1": logs["mesh_w0_p1.log"],
             "party 1 rank 0": logs["foreground"],
             "party 1 rank 1": logs["mesh_w1_p1.log"]}
    reps = {who: report(text, "11c", who, dev) for who, text in ranks.items()}
    report(logs["mesh_master.log"], "11c", "master", dev)
    accs = [[float(a) for _i, a in re.findall(ACC_RE, t)]
            for t in ranks.values()]
    lockstep(accs, "11c", "per-round accuracies")
    lockstep([[r["digest"]] for r in reps.values()], "11c",
             "parameter digests")
    with open(codes_file) as f:
        codes = [line.split()[-1] for line in f.read().split("\n") if line]
    launches = [r["launches"]["two_bit"] for r in reps.values()]
    print(f"[phase11c] 2 mesh parties x 2 rank processes (2bit ring), "
          f"{len(codes)} processes, exit codes {codes}; {P['mesh_rounds']} "
          f"rounds: accuracies {accs[0]} on all four ranks; phase 7c's "
          f"(each party one process) {accs7c}; parameters sha256 "
          f"{reps['party 0 rank 0']['digest']}, 7c's {digest7c}; two_bit "
          f"launches per rank {launches}", flush=True)
    if len(codes) != 12 or any(c != "0" for c in codes):
        fail(f"phase11c: exit codes {codes}")
    if len(accs[0]) != P["mesh_rounds"]:
        fail(f"phase11c: {len(accs[0])} rounds, not {P['mesh_rounds']}")
    if accs[0] != accs7c:
        fail(f"phase11c: accuracies {accs[0]}, phase 7c's {accs7c}")
    if reps["party 0 rank 0"]["digest"] != digest7c:
        fail(f"phase11c: parameters {reps['party 0 rank 0']['digest']}, "
             f"phase 7c's {digest7c}")
    if dev == "cuda" and (min(launches) == 0 or len(set(launches)) != 1):
        fail(f"phase11c: two_bit launches per rank {launches}")
    return {key: sum(r["launches"][key] for r in reps.values())
            for key in (*KERNELS, "two_bit")}


def phase12(dev="cuda"):
    """The card's self-check (``geomx_tpu_torch/tools/chip_sanity.py``):
    bit-exact copies and bitcasts of the packed wire's patterns, fp32
    matmul and convolution error by TF32 setting, honest blocking, and
    the device trainer's BSC cycle against its numpy oracle. Each probe's
    verdict on a line of its own; any red probe, or more than
    PHASE12_LIMIT_S, fails the run."""
    from geomx_tpu_torch.tools.chip_sanity import PROBES, run_chip_sanity

    out = run_chip_sanity(dev)
    mm, blk = out["matmul_precision"], out["blocking_honest"]
    events = (None if blk["t_events_s"] is None
              else blk["t_events_s"] * 1e3)
    detail = {
        "transfer_bitexact": f"modes {out['transfer_bitexact']['modes']}, "
                             f"corrupted "
                             f"{out['transfer_bitexact']['corrupted']}",
        "bitcast_on_device": f"ops {out['bitcast_on_device']['checked']}, "
                             f"corrupted "
                             f"{out['bitcast_on_device']['corrupted']}",
        "matmul_precision": "; ".join(
            f"{op} err default {mm[f'{op}_err_default']:.3e} tf32 "
            f"{mm[f'{op}_err_tf32']:.3e} exact {mm[f'{op}_err_exact']:.3e} "
            f"process {mm[f'{op}_err_process']:.3e} (default / exact "
            f"{mm[f'{op}_ratio']:.1f})" for op in ("matmul", "conv"))
            + f"; the process runs under {mm['process_settings']}",
        "blocking_honest": f"{blk['iters']} chained 2048^3 bf16 matmuls: "
                           f"synchronize {blk['t_sync_s'] * 1e3:.3f} ms, "
                           + ("events not measured, " if events is None
                              else f"events {events:.3f} ms, ")
                           + f"value fetch {blk['t_value_s'] * 1e3:.3f} ms, "
                           f"implied {blk['implied_tflops']:.1f} TFLOP/s",
        "bsc_oracle": f"{out['bsc_oracle']['rounds']} rounds, max drift "
                      f"{out['bsc_oracle']['max_param_drift']:.3e}, finite "
                      f"{out['bsc_oracle']['device_finite']}",
    }
    for name in PROBES:
        verdict = "ok" if out[name]["ok"] else "RED"
        print(f"[phase12] {name} {verdict}: {detail[name]}", flush=True)
    print(f"[phase12] {out['device']}: {len(PROBES)} probes in "
          f"{out['wall_s']:.1f} s", flush=True)
    red = [name for name in PROBES if not out[name]["ok"]]
    if red:
        fail(f"phase12: red probe(s) {red}: "
             f"{ {name: out[name] for name in red} }")
    if out["wall_s"] > PHASE12_LIMIT_S:
        fail(f"phase12: the probes took {out['wall_s']:.1f} s, over "
             f"{PHASE12_LIMIT_S} s")
    return out


def tool_lines(fn, *args, **kw):
    """``fn(*args, **kw)``, each line it prints printed again as a
    ``[phase13]`` line (a tool's bare JSON rows would otherwise stand
    beside the script's own JSON lines); returns what ``fn`` returned."""
    import contextlib
    import io

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            return fn(*args, **kw)
    finally:
        for line in buf.getvalue().splitlines():
            print(f"[phase13] {line}", flush=True)


def launched(counters, fn, *args, **kw):
    """(what ``fn(*args, **kw)`` returned, the launches it made by kernel
    key of ``counters``)."""
    before = {k: n for c in counters for k, n in c.items()}
    out = fn(*args, **kw)
    return out, {k: n - before[k] for c in counters for k, n in c.items()}


def add_to(total, counts):
    for k, n in counts.items():
        total[k] = total.get(k, 0) + n


def phase13a(torch, fa, dev="cuda"):
    """``attention_bench``'s rows at its defaults and at the 59M decoder's
    attention: per row the launches of each flash kernel (a timed chain
    of ``attn_iters`` calls after one warm-up call, forward then
    forward+backward), finite positive times, and SDPA timed by the same
    chain as a yardstick. On the row's own inputs and a seeded
    cotangent, flash's output within phase 1's bf16 tolerance of bf16
    dense attention's, and its out, dq, dk and dv against fp32 dense
    attention by ``row_close``. Returns the launches."""
    from geomx_tpu_torch.models.transformer import dense_attention
    from geomx_tpu_torch.tools import attention_bench as ab

    F = torch.nn.functional

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True).transpose(1, 2)

    it = PHASE13["attn_iters"]
    on_card = torch.device(dev).type == "cuda"
    want = ({"fwd": 2 * (it + 1), "dq": it + 1, "dkv": it + 1} if on_card
            else dict.fromkeys(fa.LAUNCHES, 0))
    total = {}
    for B, H, D, seqs in PHASE13["attn"]:
        for T in seqs:
            row, n = launched([fa.LAUNCHES], ab.bench_row, T, B, H, D, dev,
                              it)
            add_to(total, n)
            q, k, v = ab.inputs(B, T, H, D, dev)
            do = torch.randn(q.shape, generator=torch.Generator().manual_seed(
                3)).to(device=dev, dtype=q.dtype)
            # fwd_bwd marks a tensor of its dtype as requiring grad:
            # detached views keep q, k, v free of it for SDPA's chain
            got = fwd_bwd(torch, fa.flash_attention,
                          [x.detach() for x in (q, k, v)], do, torch.bfloat16)
            err = float((got[0].float()
                         - dense_attention(q, k, v).float()).abs().max())
            ref = fwd_bwd(torch, dense_attention, (q, k, v), do,
                          torch.float32)
            rows = {w: row_close(a, b, tol) for w, a, b, tol in zip(
                ("out", "dq", "dk", "dv"), got, ref, PHASE13["attn_tol"])}
            del ref
            lib = {"sdpa_fwd_ms": ab._time(sdpa, q, k, v, it),
                   "sdpa_fwdbwd_ms": ab._time(ab._grad(sdpa), q, k, v, it)}
            print(f"[phase13] attention {json.dumps(row)}; SDPA (yardstick) "
                  f"fwd {lib['sdpa_fwd_ms']:.4f} ms, fwd+bwd "
                  f"{lib['sdpa_fwdbwd_ms']:.4f} ms; flash - dense max abs "
                  f"{err:.3e}; against fp32 dense, worst row error over "
                  f"max(row max, {ROW_FLOOR} x tensor max) "
                  + ", ".join(f"{w} {r:.4f}" for w, (r, _ok) in rows.items())
                  + f"; launches {n}", flush=True)
            if n != want:
                fail(f"phase13a T {T}: launches {n}, expected {want}")
            if not err <= TOL["bfloat16"]:
                fail(f"phase13a T {T}: flash is {err} from dense attention, "
                     f"over {TOL['bfloat16']}")
            bad = {w: r for (w, (r, ok)), t in zip(rows.items(), got)
                   if not (ok and bool(torch.isfinite(t).all()))}
            if bad:
                fail(f"phase13a T {T}: flash against fp32 dense attention "
                     f"beyond {PHASE13['attn_tol']} (worst row ratios): "
                     f"{bad}")
            times = [row[k] for k in ("dense_fwd_ms", "flash_fwd_ms",
                                      "dense_fwdbwd_ms", "flash_fwdbwd_ms")]
            if not all(math.isfinite(t) and t > 0 for t in times):
                fail(f"phase13a T {T}: times {times}")
    return total


def bsc_divergence(np, mag, hidx, cidx, boundary, kth):
    """Where the host codec's BSC selection ``hidx`` and the card's
    exact top-k ``cidx`` of magnitudes ``mag`` differ, and whether the
    host's rule accounts for each difference. The host takes the first
    ``k`` indices, in index order, whose magnitude reaches its sampled
    ``boundary``: an index in its set only lies between the boundary and
    the ``kth`` largest magnitude; one in the card's only either falls
    short of the boundary or, where the host's count reached k, lies
    after the host's last index. Returns (host only, card only,
    accounted for)."""
    host_only = np.setdiff1d(hidx, cidx)
    card_only = np.setdiff1d(cidx, hidx)
    capped = hidx.size == cidx.size and card_only > hidx.max()
    ok = (np.all((mag[host_only] >= boundary) & (mag[host_only] <= kth))
          and np.all((mag[card_only] < boundary) | capped))
    return host_only.size, card_only.size, bool(ok)


def phase13b(torch, np, tb, dev="cuda"):
    """``compress_bench``'s rows at its defaults and at the 59M decoder's
    whole gradient: the ``two_bit`` launches of each timed size (one
    warm-up and ``repeat`` calls), and at every size, on the tool's own
    first outputs (one step from zero state), the card's fp16 cast and
    2-bit bytes and residual against the host codec's bit for bit, and
    its BSC selection against the exact top-k of the same values: the
    same k, every value whose magnitude is above the k-th's selected,
    only values that reach it selected (``torch.topk`` may take any of a
    tie at the k-th), the values equal. The host BSC codec picks from a
    sampled boundary; its set against the card's is printed, and each
    index in one only must lie where the host's rule puts it
    (``bsc_divergence``). Returns the launches."""
    from geomx_tpu_torch import compression as host
    from geomx_tpu_torch.tools import compress_bench as cb

    on_card = torch.device(dev).type == "cuda"
    threshold = 0.01
    total = {}
    runs = [(n, 5) for n in PHASE13["compress_sizes"]]
    runs.append((PHASE13["big"], PHASE13["big_repeat"]))
    for n, repeat in runs:
        keep = {}
        res, got = launched([tb.LAUNCHES], cb.run_compress_bench, [n],
                            threshold, repeat, dev, keep)
        add_to(total, got)
        print(f"[phase13] compress {json.dumps(res[0])}; launches {got}",
              flush=True)
        if got["two_bit"] != (repeat + 1 if on_card else 0):
            fail(f"phase13b size {n}: two_bit launches {got}")
        o = keep.pop(n)
        grad = o["grad"]
        if not np.array_equal(o["fp16_device"].view(np.uint16),
                              o["fp16_host"].view(np.uint16)):
            fail(f"phase13b size {n}: fp16 bytes differ from numpy's")
        (packed, res_d), (hpacked, hres) = o["2bit_device"], o["2bit_host"]
        if not (np.array_equal(packed, hpacked)
                and np.array_equal(res_d.view(np.uint32),
                                   hres.view(np.uint32))):
            fail(f"phase13b size {n}: 2-bit bytes or residual differ from "
                 f"the host codec's")
        vals, idx = o["bsc_device"]
        idx = idx.astype(np.int64)
        hidx = o["bsc_host"][1].astype(np.int64)
        k = max(int(n * threshold), 1)
        mag = np.abs(grad)
        kth = np.partition(mag, n - k)[n - k]
        above = np.flatnonzero(mag > kth)
        ok = (idx.size == k == np.unique(idx).size
              and np.all(mag[idx] >= kth)
              and np.isin(above, idx).all()
              and np.array_equal(vals.view(np.uint32),
                                 grad[idx].view(np.uint32)))
        boundary = host.bsc_sample_boundary(grad, threshold,
                                            np.random.default_rng(42))
        h_only, c_only, why = bsc_divergence(np, mag, hidx, idx, boundary,
                                             kth)
        print(f"[phase13] compress size {n}: fp16 and 2-bit (bytes, "
              f"residual) equal the host codec's; BSC k {k}, {above.size} "
              f"above the k-th magnitude {kth:.6f}, the card's selection "
              f"{'is' if ok else 'is NOT'} the exact top-k; the host "
              f"codec's boundary {boundary:.6f} (0.5% sample) selected "
              f"{hidx.size}: {h_only} in the host's set only, {c_only} in "
              f"the card's only, "
              f"{'all' if why else 'NOT all'} where the host's boundary "
              f"and its cap of k put them", flush=True)
        if not ok:
            fail(f"phase13b size {n}: BSC selection is not the exact top-k")
        if not why:
            fail(f"phase13b size {n}: the card's and the host codec's BSC "
                 f"sets differ where the host's boundary does not account "
                 f"for it")
    return total


def phase13c(dev="cuda"):
    """``ps_bench``'s sizes for ``ps_s`` seconds each and
    ``server_bench``'s thread counts for ``server_s`` each: every rate
    positive."""
    from geomx_tpu_torch.tools import ps_bench, server_bench

    ps = []
    for n in ps_bench.SIZES:
        ps.append(ps_bench.bench_size(n, PHASE13["ps_s"], dev))
        print(f"[phase13] ps {json.dumps(ps[-1])}", flush=True)
    srv = tool_lines(server_bench.sweep, PHASE13["server_s"], dev)
    bad = [r for r in ps if not r["rounds_per_s"] > 0] \
        + [r for r in srv if not r["rounds_per_s"] > 0]
    if bad:
        fail(f"phase13c: rates not positive: {bad}")


def phase13d(tb, dev="cuda"):
    """``wire_bench``: per-key against batched at both layouts, the
    sparse wire at the cnn layout, the overlap at the transformer layout
    under each wire codec and slice size (with the host profiler's spans
    of each, serial and pipelined rounds together), and the loss bench's
    five policies on the two-party WAN plan, where the raw policy must
    reach its target. Returns the launches."""
    from geomx_tpu_torch import profiler
    from geomx_tpu_torch.tools import wire_bench as wb
    from geomx_tpu_torch.tools.chaos_sim import SHAPES

    cpu = ["--cpu"] if dev == "cpu" else []
    total = {}
    for layout, rounds in PHASE13["rounds"].items():
        tool_lines(wb.main, ["--layout", layout, "--rounds", str(rounds)]
                   + cpu)
    tool_lines(wb.main, ["--sparse", "--rounds",
                         str(PHASE13["rounds"]["cnn"])] + cpu)
    shapes = wb.layout_shapes("transformer")
    R = PHASE13["overlap_rounds"]
    for sb in PHASE13["slices"]:
        for codec in PHASE13["codecs"]:
            profiler.reset()
            profiler.set_config(aggregate_stats=True)
            profiler.set_state("run")
            try:
                (serial, piped, chunks), n = launched(
                    [tb.LAUNCHES], wb.run_overlap, shapes, R, sb,
                    {"wire_codec": codec} if codec else None, "", dev)
            finally:
                profiler.set_state("stop")
            spans = host_spans(profiler, 2 * R, top=8)
            profiler.reset()
            add_to(total, n)
            row = {"codec": codec or "raw", "slice_bytes": sb,
                   "chunks": chunks, "serial_ms_per_round": round(serial, 2),
                   "pipelined_ms_per_round": round(piped, 2),
                   "two_bit_launches": n["two_bit"]}
            print(f"[phase13] overlap transformer {json.dumps(row)}",
                  flush=True)
            print(f"[phase13]   host spans, ms per round (serial and "
                  f"pipelined rounds together): "
                  + ", ".join(f"{k} {v:.2f}" for k, v in spans),
                  flush=True)
    L = PHASE13["loss"]
    extra = {"shape_plan": "@" + os.path.join(SHAPES, L["shape"]),
             "shape_seed": -1}
    loss = tool_lines(wb.loss_bench, L["parties"], L["size"], L["target"],
                      L["max_rounds"], extra, 2, wb.LOSS_POLICIES, dev)
    if loss["raw"]["rounds_to_target"] is None:
        fail(f"phase13d: the raw policy did not reach {L['target']} in "
             f"{L['max_rounds']} rounds: {loss['raw']}")
    return total


def phase13e(dev="cuda"):
    """``overlay_bench`` at 16 parties on hetero16, 1 round: direct and
    overlay weights bit-exact (the tool raises otherwise)."""
    from geomx_tpu_torch.tools import overlay_bench as ob

    O = PHASE13["overlay"]
    cpu = ["--cpu"] if dev == "cpu" else []
    tool_lines(ob.main, ["--parties", str(O["parties"]), "--rounds",
                         str(O["rounds"])] + cpu)


def phase13(torch, np, fa, tb, dev="cuda"):
    """The repo's measurement tools over the port (13a-13e); the lap is
    held to ``limit_s``. Returns the launches of each kernel key."""
    t0 = time.perf_counter()
    total, laps = {}, {}

    def sub(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        laps[name] = round(time.perf_counter() - t, 1)
        return out

    add_to(total, sub("13a", phase13a, torch, fa, dev))
    add_to(total, sub("13b", phase13b, torch, np, tb, dev))
    sub("13c", phase13c, dev)
    add_to(total, sub("13d", phase13d, tb, dev))
    sub("13e", phase13e, dev)
    lap = time.perf_counter() - t0
    print(f"[phase13] the six tools in {lap:.1f} s ({laps}); kernel "
          f"launches {total}", flush=True)
    if lap > PHASE13["limit_s"]:
        fail(f"phase13: {lap:.1f} s, over {PHASE13['limit_s']} s")
    return total


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isfile(os.path.join(root, "geomx_tpu_torch",
                                       "__init__.py")):
        fail("run chip_smoke.py from a checkout of the repository")
    sys.path.insert(0, root)
    import numpy as np

    from geomx_tpu_torch.ops import _cuda
    from geomx_tpu_torch.ops import flash_attention as fa
    from geomx_tpu_torch.ops import two_bit as tb
    from geomx_tpu_torch.parallel import mesh as pmesh
    from geomx_tpu_torch.parallel import quant_collectives as qc

    # phase 0: the card, the kernels' build, the float32 matmul mode
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    t = time.perf_counter()
    logs = _cuda.build(["flash_attention", "two_bit"])
    print(f"[phase0] built {len(logs)} CUDA source(s) for sm_90a in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    for src in ("flash_attention", "two_bit"):
        # ptxas -v per kernel: registers, shared memory, spills (the log of
        # the build that made the library, this run's or an earlier one's)
        fn = None
        for line in _cuda._target(src).with_suffix(".log").read_text() \
                .splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif fn and ("Used" in line or "spill" in line):
                print(f"[phase0] {fn}: {line.strip()}", flush=True)
    sass_check(_cuda, fa.TC_HEAD_DIMS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[phase0] matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        print(f"[time] {name} {now - clock[0]:.1f} s", flush=True)
        clock[0] = now

    phase12()
    lap("phase12")
    errs, times, library, dev, library_dev, bnd = phase1(torch, fa)
    d32 = phase1_d32(torch, fa)
    lap("phase1")
    _launches, n_params = phase2(torch, np, fa)
    lap("phase2")
    tb_ms, tb_plain, tb_dev, tb_bound = phase3a(torch, tb, pmesh, n_params)
    phase3b(torch, np, qc, pmesh)
    phase3c(torch, np, qc, pmesh)
    tb_launches, losses3d, digest3d = phase3d(torch, np, fa, tb, qc, pmesh)
    lap("phase3")
    main_path = phase4a(torch, np, fa, tb)
    lap("phase4a")
    hips_launches, dense = phase4b(torch, np, fa, tb)
    lap("phase4b")
    phase4b_bsc(torch, np, dense)
    lap("phase4b-bsc")
    framing5 = phase5(torch, np)
    lap("phase5")
    mesh6a = phase6a(torch, np, fa, tb, main_path["wire_ms"])
    lap("phase6a")
    mesh6b = phase6b(torch, np, fa, tb)
    lap("phase6b")
    phase7a("cuda", main_path["step_timed"])
    lap("phase7a")
    procs7b = phase7b("cuda", dense)
    lap("phase7b")
    procs7c, accs7c, digest7c = phase7c("cuda")
    lap("phase7c")
    phase7d("cuda")
    lap("phase7d")
    launches8, per_step8 = phase8a(torch, np, fa, tb)
    lap("phase8a")
    phase8b(torch, fa)
    lap("phase8b")
    phase8c(torch, np, fa)
    lap("phase8c")
    phase8d(torch, np)
    lap("phase8d")
    launches9a = phase9a(torch, np, fa, tb, dense)
    lap("phase9a")
    launches9b = phase9b(torch, np, tb)
    lap("phase9b")
    launches9c = phase9c("cuda")
    lap("phase9c")
    # phase 10, the image-classification path: it reaches no kernel of
    # the port (the zoo's convolutions are cuDNN's, as XLA's are in the
    # JAX package); the counts show it launched none
    reset([fa.LAUNCHES, tb.LAUNCHES])
    phase10a(torch, np)
    lap("phase10a")
    phase10b(torch, np, framing5)
    lap("phase10b")
    phase10c(torch, np)
    lap("phase10c")
    launches10 = {**fa.LAUNCHES, **tb.LAUNCHES}
    print(f"[phase10] kernel launches on the image-classification path: "
          f"{launches10}", flush=True)
    # phase 11, a party over several processes: every rank's launches
    # are counted in its own process, from zero
    launches11a = phase11a(torch, np, qc, pmesh)
    lap("phase11a")
    launches11b = phase11b(np, losses3d, digest3d)
    lap("phase11b")
    launches11c = phase11c("cuda", accs7c, digest7c)
    lap("phase11c")
    # phase 13, the measurement tools: launches counted from the tools'
    # own runs, not from the checks beside them
    launches13 = phase13(torch, np, fa, tb)
    lap("phase13")

    table = [{
        "name": name, "route": "cuda", "source": SOURCE, "replaces": where,
        "launches": hips_launches[key], "max_abs_err": errs[key],
        "ms": times[key][0], "plain_ms": times[key][1],
        "bound_ms": bnd[key][0], "bound_by": bnd[key][1],
        "library_ms": library[key], "kernel": kernel,
        "device_ms": dev[key] if dev[key] is not None else "not measured",
        "library_device_ms": (library_dev[key] if library_dev[key] is not None
                              else "not measured"),
        "launches_by_phase": {
            "4b": hips_launches[key],
            **{f"6a-{c}": r["launches"][key]
               for c, r in mesh6a["runs"].items()},
            "6b_per_round": mesh6b[key], "7b": procs7b[key],
            "7c": procs7c[key], "8a": launches8[key],
            "8a_per_step": {c: n[key] for c, n in per_step8.items()},
            "9a": {c: n[key] for c, n in launches9a.items()},
            "10": launches10[key],
            "11b_per_process_step": [[c[key] for c in rank]
                                     for rank in launches11b],
            "11c": launches11c[key], "13": launches13[key]},
        "d32": d32[key],
    } for key, (name, where, kernel) in KERNELS.items()]
    table.append({
        "name": TWO_BIT[0], "route": "cuda", "source": TWO_BIT[1],
        "replaces": TWO_BIT[2], "launches": tb_launches,
        "max_abs_err": 0.0, "ms": tb_ms, "plain_ms": tb_plain,
        "bound_ms": tb_bound, "bound_by": "bytes", "library_ms": None,
        "kernel": "two_bit_kernel",
        "device_ms": tb_dev if tb_dev is not None else "not measured",
        "library_device_ms": None,
        "launches_by_phase": {
            "3d": tb_launches,
            **{f"6a-{c}": r["launches"]["two_bit"]
               for c, r in mesh6a["runs"].items()},
            "6b_per_round": mesh6b["two_bit"], "7b": procs7b["two_bit"],
            "7c": procs7c["two_bit"], "8a": launches8["two_bit"],
            "9a": {c: n["two_bit"] for c, n in launches9a.items()},
            "9b": launches9b, "9c": launches9c,
            "10": launches10["two_bit"],
            "11a_per_process": {f"P{P}": c for P, c in launches11a.items()},
            "11b_per_process_step": [[c["two_bit"] for c in rank]
                                     for rank in launches11b],
            "11c": launches11c["two_bit"], "13": launches13["two_bit"]}})
    print(card, flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker_mode(sys.argv[2:])
    elif sys.argv[1:2] == ["--party-rank"]:
        party_rank(sys.argv[2:])
    else:
        sys.exit(main())
