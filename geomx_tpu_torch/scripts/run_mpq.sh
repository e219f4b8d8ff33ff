#!/bin/bash
# Single-host HiPS demo: 12 processes, 3 parties, the port's counterpart
# of scripts/run_mpq.sh (reference: scripts/cpu/run_mpq.sh).
# Workers run on the CUDA card; pass --cpu to run them on the CPU.
cd "$(dirname "$0")"
source ./hips_env.sh
launch_hips geomx_tpu_torch.examples.cnn_mpq "$@"
