#!/bin/bash
# HiPS demo with P3 priority-based parameter propagation enabled, the
# port's counterpart of scripts/run_p3.sh (reference: scripts/cpu/run_p3.sh
# — ENABLE_P3=1 on every node). Pass --cpu to run the workers on the CPU.
export ENABLE_P3=1
cd "$(dirname "$0")"
source ./hips_env.sh
launch_hips geomx_tpu_torch.examples.cnn "$@"
