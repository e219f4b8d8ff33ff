#!/bin/bash
# HiPS demo with DGT (Differential Gradient Transmission) on the inter-DC
# tier, the port's counterpart of scripts/run_dgt.sh (reference:
# scripts/cpu/run_dgt.sh). Pass --cpu to run the workers on the CPU.
# ENABLE_DGT=1: unimportant blocks over lossy UDP channels
#            2: unimportant blocks over TCP (QoS queues only)
#            3: unimportant blocks 4-bit quantized over TCP
export ENABLE_DGT=${ENABLE_DGT:-1}
export DMLC_UDP_CHANNEL_NUM=${DMLC_UDP_CHANNEL_NUM:-3}
export DGT_BLOCK_SIZE=${DGT_BLOCK_SIZE:-4096}
export DMLC_K=${DMLC_K:-0.8}
export DGT_CONTRI_ALPHA=${DGT_CONTRI_ALPHA:-0.3}
cd "$(dirname "$0")"
source ./hips_env.sh
launch_hips geomx_tpu_torch.examples.cnn "$@"
