#!/bin/bash
# Single-host HiPS demo: 12 processes, 3 parties — the 59M transformer
# through the device-resident Bi-Sparse trainer, the port's counterpart of
# scripts/run_transformer_bsc.sh. Workers run on the CUDA card (the
# FlashAttention-2 kernels of geomx_tpu_torch/ops). Small-model smoke on
# the CPU:
#   bash geomx_tpu_torch/scripts/run_transformer_bsc.sh --cpu --dim 64 \
#        --depth 2 --heads 4 --vocab 256 --seq-len 64 --max-iters 10
# a 59M bootstrap takes a while per worker; the finished parties must
# out-wait it at the barriers (env-tunable; config.py)
export PS_BARRIER_TIMEOUT=${PS_BARRIER_TIMEOUT:-1800}
export PS_OP_TIMEOUT=${PS_OP_TIMEOUT:-900}
cd "$(dirname "$0")"
source ./hips_env.sh
launch_hips geomx_tpu_torch.examples.transformer_bsc_device "$@"
