#!/bin/bash
# MultiGPS demo: two global servers load-balance the global tier, the
# port's counterpart of scripts/run_multi_gps.sh (reference:
# scripts/cpu/run_multi_gps.sh — DMLC_NUM_GLOBAL_SERVER=2). 13 processes.
# Pass --cpu to run the workers on the CPU.
NGS=2
cd "$(dirname "$0")"
source ./hips_env.sh
launch_hips geomx_tpu_torch.examples.cnn "$@"
