#!/bin/bash
# ESync: state-server-balanced local steps + synchronous model averaging,
# the port's counterpart of scripts/run_esync.sh. Pass --cpu to run the
# workers on the CPU.
cd "$(dirname "$0")"
source ./hips_env.sh
launch_hips geomx_tpu_torch.examples.cnn_esync "$@"
