#!/bin/bash
# Shared topology wiring for the port's single-host HiPS demo, the
# counterpart of scripts/hips_env.sh: 12 processes, 3 parties (central
# party with global scheduler + global server + master worker +
# scheduler; two data parties with scheduler + server + 2 workers each).
# Usage: source hips_env.sh; launch_hips <worker module> [extra args...]
#
# What differs from the JAX package's recipes is the framework seam only:
# - infrastructure roles run `python -m geomx_tpu_torch.kvstore_server`
#   (importing geomx_tpu_torch never enters the server loop);
# - workers run `python -m <worker module>`, on the CUDA card unless the
#   caller passes --cpu (no --cpu is baked in);
# - logs go to $LOG_DIR (default <repo>/logs/torch_hips), one file per
#   role, so a JAX run and a port run never overwrite each other;
# - every process gets OMP_NUM_THREADS=2 unless the caller sets it
#   (twelve processes with torch's default threads oversubscribe the
#   cores: 3 s per LeNet round instead of 0.07);
# - launch_hips and launch_mesh_hips reap every background role after the
#   foreground worker returns, and return the first non-zero exit code.
#
# WORKER_LAUNCH (default "$PYTHON -m") is the command a worker's module
# name is appended to, so a wrapper can run a worker's module; INFRA
# (default "-m geomx_tpu_torch.kvstore_server") is what $PYTHON runs for
# the infrastructure roles.
#
# Multi-host simulation: set HOST_CENTRAL / HOST_A / HOST_B to distinct
# addresses and each party's nodes ADVERTISE that address via
# DMLC_NODE_HOST, as in the JAX package's recipe.

REPO_DIR="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"
export PYTHONPATH="$REPO_DIR${PYTHONPATH:+:$PYTHONPATH}"
export OMP_NUM_THREADS=${OMP_NUM_THREADS:-2}
export MKL_NUM_THREADS=${MKL_NUM_THREADS:-$OMP_NUM_THREADS}
GPORT=${GPORT:-9092}; CPORT=${CPORT:-9093}; APORT=${APORT:-9094}; BPORT=${BPORT:-9095}
PYTHON=${PYTHON:-python}
WORKER_LAUNCH=${WORKER_LAUNCH:-"$PYTHON -m"}
INFRA=${INFRA:-"-m geomx_tpu_torch.kvstore_server"}
LOG_DIR=${LOG_DIR:-$REPO_DIR/logs/torch_hips}
mkdir -p "$LOG_DIR"
# NGS>1 = MultiGPS: several global servers share the central party
# (reference: scripts/cpu/run_multi_gps.sh, DMLC_NUM_GLOBAL_SERVER=2)
NGS=${NGS:-1}
HOST_CENTRAL=${HOST_CENTRAL:-127.0.0.1}
HOST_A=${HOST_A:-127.0.0.1}
HOST_B=${HOST_B:-127.0.0.1}
# advertise only when off plain loopback
NH_CENTRAL=$([ "$HOST_CENTRAL" = "127.0.0.1" ] || echo "DMLC_NODE_HOST=$HOST_CENTRAL")
NH_A=$([ "$HOST_A" = "127.0.0.1" ] || echo "DMLC_NODE_HOST=$HOST_A")
NH_B=$([ "$HOST_B" = "127.0.0.1" ] || echo "DMLC_NODE_HOST=$HOST_B")

GLOBALS="DMLC_PS_GLOBAL_ROOT_URI=$HOST_CENTRAL DMLC_PS_GLOBAL_ROOT_PORT=$GPORT \
DMLC_NUM_GLOBAL_SERVER=$NGS DMLC_NUM_GLOBAL_WORKER=2"

# pids of this launch's background roles, reaped by reap_hips
HIPS_PIDS=""

# one data-party server. If CHAOS_PLAN_SERVER_A is set, party A's
# server (and only it) runs under that fault plan: a node/tier match
# alone cannot single it out (every party's server is local id 8).
# Used by both launch_hips and launch_mesh_hips.
launch_hips_party_server() {
  local PPORT="$1" PHOST="$2" NH_P="$3" NWORK="$4" LOG="$5"
  local PLAN=()
  if [ "$PPORT" = "$APORT" ] && [ -n "${CHAOS_PLAN_SERVER_A:-}" ]; then
    PLAN=("PS_FAULT_PLAN=$CHAOS_PLAN_SERVER_A")
  fi
  env $(echo $GLOBALS) $NH_P DMLC_ROLE=server \
    DMLC_PS_ROOT_URI=$PHOST DMLC_PS_ROOT_PORT=$PPORT \
    DMLC_NUM_SERVER=1 DMLC_NUM_WORKER=$NWORK \
    "${PLAN[@]}" \
    $PYTHON $INFRA > "$LOG" 2>&1 &
  HIPS_PIDS="$HIPS_PIDS $!"
}

# wait for every background role; the first non-zero code wins. With
# EXIT_CODES_FILE set, every role's code is appended there, one line
# each ("foreground <code>", then "<pid> <code>").
reap_hips() {
  local rc="$1" p r
  [ -n "${EXIT_CODES_FILE:-}" ] && echo "foreground $rc" >> "$EXIT_CODES_FILE"
  for p in $HIPS_PIDS; do
    wait "$p"; r=$?
    [ -n "${EXIT_CODES_FILE:-}" ] && echo "$p $r" >> "$EXIT_CODES_FILE"
    [ "$r" != 0 ] && [ "$rc" = 0 ] && rc=$r
  done
  HIPS_PIDS=""
  return "$rc"
}

launch_hips() {
  local module="$1"; shift
  local extra="$@"

  # central party -----------------------------------------------------
  env $(echo $GLOBALS) $NH_CENTRAL DMLC_ROLE_GLOBAL=global_scheduler \
    $PYTHON $INFRA > "$LOG_DIR/gsched.log" 2>&1 &
  HIPS_PIDS="$HIPS_PIDS $!"
  env $NH_CENTRAL DMLC_ROLE=scheduler DMLC_PS_ROOT_URI=$HOST_CENTRAL DMLC_PS_ROOT_PORT=$CPORT \
    DMLC_NUM_SERVER=$NGS DMLC_NUM_WORKER=1 \
    $PYTHON $INFRA > "$LOG_DIR/csched.log" 2>&1 &
  HIPS_PIDS="$HIPS_PIDS $!"
  for g in $(seq 1 $NGS); do
    env $(echo $GLOBALS) $NH_CENTRAL DMLC_ROLE_GLOBAL=global_server DMLC_ROLE=server \
      DMLC_PS_ROOT_URI=$HOST_CENTRAL DMLC_PS_ROOT_PORT=$CPORT \
      DMLC_NUM_SERVER=$NGS DMLC_NUM_WORKER=1 DMLC_ENABLE_CENTRAL_WORKER=0 \
      DMLC_NUM_ALL_WORKER=4 \
      $PYTHON $INFRA > "$LOG_DIR/gserver$g.log" 2>&1 &
    HIPS_PIDS="$HIPS_PIDS $!"
  done
  env $NH_CENTRAL DMLC_ROLE=worker DMLC_ROLE_MASTER_WORKER=1 \
    DMLC_PS_ROOT_URI=$HOST_CENTRAL DMLC_PS_ROOT_PORT=$CPORT \
    DMLC_NUM_SERVER=$NGS DMLC_NUM_WORKER=1 DMLC_NUM_ALL_WORKER=4 \
    $WORKER_LAUNCH $module $extra > "$LOG_DIR/master.log" 2>&1 &
  HIPS_PIDS="$HIPS_PIDS $!"

  # data parties ------------------------------------------------------
  local slice=0 rc=0
  local PHOST NH_P
  for PPORT in $APORT $BPORT; do
    if [ "$PPORT" = "$APORT" ]; then PHOST=$HOST_A; NH_P=$NH_A; else PHOST=$HOST_B; NH_P=$NH_B; fi
    env $NH_P DMLC_ROLE=scheduler DMLC_PS_ROOT_URI=$PHOST DMLC_PS_ROOT_PORT=$PPORT \
      DMLC_NUM_SERVER=1 DMLC_NUM_WORKER=2 \
      $PYTHON $INFRA > "$LOG_DIR/sched_$PPORT.log" 2>&1 &
    HIPS_PIDS="$HIPS_PIDS $!"
    launch_hips_party_server "$PPORT" "$PHOST" "$NH_P" 2 "$LOG_DIR/server_$PPORT.log"
    # PS_SORT_KEY pins each worker's local rank (worker $w -> local id
    # 9/11 deterministically)
    for w in 0 1; do
      if [ "$PPORT" = "$BPORT" ] && [ "$w" = "1" ]; then
        # last worker runs in the foreground (reference pattern)
        env $NH_P DMLC_ROLE=worker DMLC_PS_ROOT_URI=$PHOST DMLC_PS_ROOT_PORT=$PPORT \
          DMLC_NUM_SERVER=1 DMLC_NUM_WORKER=2 DMLC_NUM_ALL_WORKER=4 \
          PS_SORT_KEY=$w PYTHONUNBUFFERED=1 \
          $WORKER_LAUNCH $module --data-slice-idx $slice $extra
        rc=$?
      else
        env $NH_P DMLC_ROLE=worker DMLC_PS_ROOT_URI=$PHOST DMLC_PS_ROOT_PORT=$PPORT \
          DMLC_NUM_SERVER=1 DMLC_NUM_WORKER=2 DMLC_NUM_ALL_WORKER=4 \
          PS_SORT_KEY=$w \
          $WORKER_LAUNCH $module --data-slice-idx $slice $extra > "$LOG_DIR/w$slice.log" 2>&1 &
        HIPS_PIDS="$HIPS_PIDS $!"
      fi
      slice=$((slice+1))
    done
  done
  reap_hips "$rc"
}

# mesh-party topology (scripts/run_mesh_hips.sh): 9 processes, 2 data
# parties, each ONE worker process whose party mesh of MESH_SIZE ranks
# shares that worker's device (parallel.mesh.PartyMesh); the van sees one
# worker per party, so DMLC_NUM_ALL_WORKER=2 (= parties). Unlike the JAX
# recipe there is no XLA_FLAGS device count: the ranks are not devices.
#
# MESH_PROCS (default 1, the layout above) > 1 makes each data party's
# ranks processes: MESH_PROCS worker processes per party join one gloo
# group (GEOMX_MESH_COORDINATOR at the party's host and port MPORT_A /
# MPORT_B, default APORT+100 / BPORT+100; GEOMX_MESH_NUM_PROCS,
# GEOMX_MESH_PROC_ID), the party mesh is MESH_PROCS ranks, and only
# process 0 gets DMLC_ROLE=worker: it is the party's global worker and
# speaks the van, the others compute their rows and join the ring. Their
# logs are mesh_w<slice>_p<id>.log. With 2: 12 processes.
launch_mesh_hips() {
  local module="$1"; shift
  local extra="$@"
  local nproc=${MESH_PROCS:-1}
  export GEOMX_PARTY_MESH=1
  if [ "$nproc" -gt 1 ]; then
    export GEOMX_PARTY_MESH_SIZE=$nproc
  else
    export GEOMX_PARTY_MESH_SIZE=${MESH_SIZE:-2}
  fi

  # central party -----------------------------------------------------
  env $(echo $GLOBALS) $NH_CENTRAL DMLC_ROLE_GLOBAL=global_scheduler \
    $PYTHON $INFRA > "$LOG_DIR/mesh_gsched.log" 2>&1 &
  HIPS_PIDS="$HIPS_PIDS $!"
  env $NH_CENTRAL DMLC_ROLE=scheduler DMLC_PS_ROOT_URI=$HOST_CENTRAL DMLC_PS_ROOT_PORT=$CPORT \
    DMLC_NUM_SERVER=1 DMLC_NUM_WORKER=1 \
    $PYTHON $INFRA > "$LOG_DIR/mesh_csched.log" 2>&1 &
  HIPS_PIDS="$HIPS_PIDS $!"
  env $(echo $GLOBALS) $NH_CENTRAL DMLC_ROLE_GLOBAL=global_server DMLC_ROLE=server \
    DMLC_PS_ROOT_URI=$HOST_CENTRAL DMLC_PS_ROOT_PORT=$CPORT \
    DMLC_NUM_SERVER=1 DMLC_NUM_WORKER=1 DMLC_ENABLE_CENTRAL_WORKER=0 \
    DMLC_NUM_ALL_WORKER=2 \
    $PYTHON $INFRA > "$LOG_DIR/mesh_gserver.log" 2>&1 &
  HIPS_PIDS="$HIPS_PIDS $!"
  env $NH_CENTRAL DMLC_ROLE=worker DMLC_ROLE_MASTER_WORKER=1 \
    DMLC_PS_ROOT_URI=$HOST_CENTRAL DMLC_PS_ROOT_PORT=$CPORT \
    DMLC_NUM_SERVER=1 DMLC_NUM_WORKER=1 DMLC_NUM_ALL_WORKER=2 \
    $WORKER_LAUNCH $module $extra > "$LOG_DIR/mesh_master.log" 2>&1 &
  HIPS_PIDS="$HIPS_PIDS $!"

  # data parties (one mesh worker each) -------------------------------
  local slice=0 rc=0
  local PHOST NH_P
  for PPORT in $APORT $BPORT; do
    if [ "$PPORT" = "$APORT" ]; then PHOST=$HOST_A; NH_P=$NH_A; else PHOST=$HOST_B; NH_P=$NH_B; fi
    env $NH_P DMLC_ROLE=scheduler DMLC_PS_ROOT_URI=$PHOST DMLC_PS_ROOT_PORT=$PPORT \
      DMLC_NUM_SERVER=1 DMLC_NUM_WORKER=1 \
      $PYTHON $INFRA > "$LOG_DIR/mesh_sched_$PPORT.log" 2>&1 &
    HIPS_PIDS="$HIPS_PIDS $!"
    launch_hips_party_server "$PPORT" "$PHOST" "$NH_P" 1 "$LOG_DIR/mesh_server_$PPORT.log"
    local MESH_ENV="" k
    if [ "$nproc" -gt 1 ]; then
      local MPORT=${MPORT_A:-$((APORT + 100))}
      [ "$PPORT" = "$BPORT" ] && MPORT=${MPORT_B:-$((BPORT + 100))}
      MESH_ENV="GEOMX_MESH_COORDINATOR=$PHOST:$MPORT GEOMX_MESH_NUM_PROCS=$nproc"
      # the party's other ranks: no van role, they join the group only
      for k in $(seq 1 $((nproc - 1))); do
        env $NH_P $MESH_ENV GEOMX_MESH_PROC_ID=$k \
          $WORKER_LAUNCH $module --data-slice-idx $slice $extra > "$LOG_DIR/mesh_w${slice}_p$k.log" 2>&1 &
        HIPS_PIDS="$HIPS_PIDS $!"
      done
      MESH_ENV="$MESH_ENV GEOMX_MESH_PROC_ID=0"
    fi
    if [ "$PPORT" = "$BPORT" ]; then
      # last worker runs in the foreground (reference pattern)
      env $NH_P $MESH_ENV DMLC_ROLE=worker DMLC_PS_ROOT_URI=$PHOST DMLC_PS_ROOT_PORT=$PPORT \
        DMLC_NUM_SERVER=1 DMLC_NUM_WORKER=1 DMLC_NUM_ALL_WORKER=2 \
        PYTHONUNBUFFERED=1 \
        $WORKER_LAUNCH $module --data-slice-idx $slice $extra
      rc=$?
    else
      env $NH_P $MESH_ENV DMLC_ROLE=worker DMLC_PS_ROOT_URI=$PHOST DMLC_PS_ROOT_PORT=$PPORT \
        DMLC_NUM_SERVER=1 DMLC_NUM_WORKER=1 DMLC_NUM_ALL_WORKER=2 \
        $WORKER_LAUNCH $module --data-slice-idx $slice $extra > "$LOG_DIR/mesh_w$slice.log" 2>&1 &
      HIPS_PIDS="$HIPS_PIDS $!"
    fi
    slice=$((slice+1))
  done
  reap_hips "$rc"
}
