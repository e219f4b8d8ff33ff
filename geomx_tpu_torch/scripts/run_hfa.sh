#!/bin/bash
# HFA: K1 local steps per sync, global sync every K2 rounds; the port's
# counterpart of scripts/run_hfa.sh (reference: scripts/cpu/run_hfa.sh).
# Workers run on the CUDA card; pass --cpu to run them on the CPU.
export MXNET_KVSTORE_USE_HFA=1
export MXNET_KVSTORE_HFA_K1=${MXNET_KVSTORE_HFA_K1:-2}
export MXNET_KVSTORE_HFA_K2=${MXNET_KVSTORE_HFA_K2:-2}
cd "$(dirname "$0")"
source ./hips_env.sh
launch_hips geomx_tpu_torch.examples.cnn_hfa "$@"
