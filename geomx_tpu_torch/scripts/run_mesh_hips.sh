#!/bin/bash
# Single-host mesh-party HiPS demo, the port's counterpart of
# scripts/run_mesh_hips.sh: 2 data parties, each ONE worker process whose
# party mesh of MESH_SIZE ranks shares its device, so the van sees one
# worker per party (DMLC_NUM_ALL_WORKER=2):
#   central party: global scheduler + global server + master worker +
#                  central scheduler
#   data party:    scheduler + server + ONE mesh worker process
# GEOMX_MESH_CODEC=int8|2bit|fp16 routes the intra-party gradient mean
# through the quantized ring (2bit: the two_bit CUDA kernel on the card).
# MESH_PROCS=2 makes each party's ranks processes of a gloo group (12
# processes; hips_env.sh launch_mesh_hips): the ring's hops become
# point-to-point sends between them, and every rank prints the accuracy.
# Pass --cpu to run the workers on the CPU.
MESH_SIZE=${MESH_SIZE:-2}
cd "$(dirname "$0")"
source ./hips_env.sh
launch_mesh_hips geomx_tpu_torch.examples.cnn "$@"
