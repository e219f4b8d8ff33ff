#!/bin/bash
# A party over several processes, the port's counterpart of
# scripts/run_mesh_multihost.sh: NPROC processes join ONE party through
# torch.distributed (gloo) from the settings
# kvstore.mesh_party.maybe_init_multihost reads (GEOMX_MESH_COORDINATOR /
# GEOMX_MESH_NUM_PROCS / GEOMX_MESH_PROC_ID). Each process
# (python -m geomx_tpu_torch.tools.mesh_multihost) checks that the group
# forms, that every process agrees on its size and that process 0 alone
# is the party's van-speaking global worker, then runs the quantized
# ring all-reduce across the processes and prints its link bytes per
# round, the sha256 of its output and its two_bit launches. Unlike the
# JAX script nothing is gated: gloo runs the ring on the CPU and on the
# card alike.
#
# Usage: ./run_mesh_multihost.sh [nproc] [the module's flags: --cpu ...]
#   GEOMX_MESH_CODEC=int8|2bit|fp16|none picks the ring codec
#   CODECS="int8 2bit ..."     several codecs in turn, in one group
#   N=65536                    elements per row
#   COORD=host:port            the coordinator address
#   OUT_DIR=dir                each process saves its outputs there
# Runs on the CUDA card unless --cpu is passed. Exits with the first
# non-zero exit code of the processes.
cd "$(dirname "$0")"
REPO_DIR="$(cd ../.. && pwd)"
export PYTHONPATH="$REPO_DIR${PYTHONPATH:+:$PYTHONPATH}"
export OMP_NUM_THREADS=${OMP_NUM_THREADS:-2}
PYTHON=${PYTHON:-python}
NPROC=2
FLAGS=()
for a in "$@"; do
  case "$a" in
    -*) FLAGS+=("$a") ;;
    *) NPROC=$a ;;
  esac
done
COORD=${COORD:-127.0.0.1:12357}
CODECS=${CODECS:-${GEOMX_MESH_CODEC:-int8}}
[ -n "${OUT_DIR:-}" ] && FLAGS+=(--out-dir "$OUT_DIR")

PIDS=()
for pid in $(seq 0 $((NPROC - 1))); do
  env GEOMX_MESH_COORDINATOR=$COORD \
      GEOMX_MESH_NUM_PROCS=$NPROC \
      GEOMX_MESH_PROC_ID=$pid \
      $PYTHON -m geomx_tpu_torch.tools.mesh_multihost \
      --codecs $CODECS --n "${N:-65536}" "${FLAGS[@]}" &
  PIDS+=($!)
done

RC=0
for p in "${PIDS[@]}"; do
  wait "$p" || { r=$?; [ $RC -eq 0 ] && RC=$r; }
done
if [ $RC -ne 0 ]; then
  echo "=== mesh multihost: FAILED (exit $RC) ==="
  exit $RC
fi
echo "=== mesh multihost: OK (nproc=$NPROC codecs=$CODECS) ==="
