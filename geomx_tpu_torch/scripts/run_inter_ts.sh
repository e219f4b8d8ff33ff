#!/bin/bash
# HiPS demo with inter-DC TSEngine (party-to-party aggregate merge and
# global model relay on the WAN tier), the port's counterpart of
# scripts/run_inter_ts.sh (reference: scripts/cpu/run_inter_tsengine.sh).
# Pass --cpu to run the workers on the CPU.
export ENABLE_INTER_TS=1
export MAX_GREED_RATE_TS=${MAX_GREED_RATE_TS:-0.9}
cd "$(dirname "$0")"
source ./hips_env.sh
launch_hips geomx_tpu_torch.examples.cnn "$@"
