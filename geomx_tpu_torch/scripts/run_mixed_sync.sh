#!/bin/bash
# Single-host HiPS demo with MixedSync (dist_async on the global tier),
# the port's counterpart of scripts/run_mixed_sync.sh (reference:
# scripts/cpu/run_mixed_sync.sh). Pass --cpu to run the workers on the CPU.
cd "$(dirname "$0")"
source ./hips_env.sh
launch_hips geomx_tpu_torch.examples.cnn --mixed-sync "$@"
