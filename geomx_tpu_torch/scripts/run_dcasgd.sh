#!/bin/bash
# Single-host HiPS demo with DCASGD (dist_async + delay compensation on
# the global tier), the port's counterpart of scripts/run_dcasgd.sh
# (reference: scripts/cpu/run_dcasgd.sh). Pass --cpu to run the workers
# on the CPU.
cd "$(dirname "$0")"
source ./hips_env.sh
launch_hips geomx_tpu_torch.examples.cnn --dcasgd "$@"
