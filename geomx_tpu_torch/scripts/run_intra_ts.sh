#!/bin/bash
# HiPS demo with intra-DC TSEngine (worker-to-worker gradient merge and
# model relay overlays built by the scheduler), the port's counterpart of
# scripts/run_intra_ts.sh (reference: scripts/cpu/run_intra_tsengine.sh).
# Pass --cpu to run the workers on the CPU.
export ENABLE_INTRA_TS=1
export MAX_GREED_RATE_TS=${MAX_GREED_RATE_TS:-0.9}
cd "$(dirname "$0")"
source ./hips_env.sh
launch_hips geomx_tpu_torch.examples.cnn "$@"
