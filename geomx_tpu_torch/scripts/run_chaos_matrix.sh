#!/bin/bash
# Chaos matrix of the port: the counterpart of scripts/run_chaos_matrix.sh,
# with the same eleven cases, fault plans, seeds and ports. The HiPS
# demo (12 processes, 3 parties; the mesh case 9) runs under seeded
# fault plans; every random decision is drawn from PS_SEED-derived
# streams (geomx_tpu_torch/ps/faults.py), so a failing case reproduces
# exactly by re-running with the same seed. The resender is always on:
# the point of each case is that training still completes despite the
# injected faults.
#
# Cases:
#   loss        20% data-frame drop on every link
#   wan-jitter  added latency + jitter on half the frames, 5% duplicates
#   partition   server id 8 cut off from everyone for 3s mid-run
#   overlap     drops + reordering + duplicates, P3 slicing; wire and
#               lock sanitizers on
#   quant-wire  2-bit quantized combined wire (error-feedback residuals)
#               under drops + duplicates; wire sanitizer on
#   shaped-16p  16 in-process parties on the heterogeneous WAN plan
#               (shapes/hetero16.json): stragglers, one flapping party
#               server, 2-bit codecs on the thin legs; sanitizer on
#   shaped-16p-health    the same with the health plane: the faulted
#               run must raise the planned anomalies, a clean run none
#   shaped-16p-adaptive  the same with the transport controller and a
#               mid-run squeeze of one uplink
#   dist-sync-mesh  mesh-party tier: int8 quantized ring intra-party +
#               2-bit quantized van; party A's server killed mid-run
#   worker-kill both data parties' worker 0 crashes at round 3; elastic
#               membership resizes the round to the survivors
#   server-kill party A's server crashes mid-round; survivors keep
#               training and a respawned server restores the snapshot
#
# What differs from the JAX package's matrix is the framework seam:
# workers run `python -m geomx_tpu_torch.examples.cnn` on the CUDA card
# unless the caller passes the CPU flag among the worker args (none is
# baked in); the shaped cases run `python -m
# geomx_tpu_torch.tools.chaos_sim`, on the card unless CHAOS_SIM_ARGS
# holds its CPU flag; infrastructure roles run `python -m
# geomx_tpu_torch.kvstore_server`; and each case's logs, flight-recorder
# dumps and telemetry go under $LOG_ROOT/<case> (default
# <repo>/logs/chaos_matrix), where they stay.
#
# Usage: geomx_tpu_torch/scripts/run_chaos_matrix.sh [worker args...]
#   PS_SEED=<n> picks the schedule (default 7); CASES="loss server-kill"
#   runs only the named cases; PORT_OFFSET=<n> moves every case's ports
#   (two matrices at once); FAULT_FREE=1 runs the cases that take one
#   plan for every role (all but the shaped and kill cases) with an
#   empty plan, each case's comparison run.
cd "$(dirname "$0")"
SEED=${PS_SEED:-7}
FAILED=0
OFF=${PORT_OFFSET:-0}
REPO=$(cd ../.. && pwd)
SHAPES=$(pwd)/shapes
LOG_ROOT=${LOG_ROOT:-$REPO/logs/chaos_matrix}
PYTHON=${PYTHON:-python}

wanted() {
  [ -z "${CASES:-}" ] && return 0
  case " $CASES " in *" $1 "*) return 0 ;; esac
  return 1
}

# per-case directories: logs ($LOG_DIR, read by hips_env.sh), flight
# recorder dumps and telemetry snapshots
case_dirs() {
  export LOG_DIR=$LOG_ROOT/$1
  rm -rf "$LOG_DIR"
  mkdir -p "$LOG_DIR/flightrec" "$LOG_DIR/telemetry"
  export GEOMX_FLIGHTREC_DIR=$LOG_DIR/flightrec
  export GEOMX_TELEMETRY=1 GEOMX_TELEMETRY_DIR=$LOG_DIR/telemetry
}

# fail the case on any marker of the named sanitizers in its logs
check_markers() {
  local name="$1"; shift
  local marker
  for marker in "$@"; do
    if grep -l "$marker-SANITIZER VIOLATION" "$LOG_ROOT/$name"/*.log \
         2>/dev/null; then
      echo "=== chaos[$name] FAILED: $marker sanitizer violations (see logs above) ==="
      FAILED=1
    fi
  done
}

report() {
  if [ "$2" -eq 0 ]; then
    echo "=== chaos[$1] OK ==="
  else
    echo "=== chaos[$1] FAILED (re-run with PS_SEED=$SEED to reproduce; logs in $LOG_ROOT/$1) ==="
    FAILED=1
  fi
}

run_case() {
  local name="$1" plan="$2" port_base="$3"; shift 3
  wanted "$name" || return 0
  [ -n "${FAULT_FREE:-}" ] && plan='[]'
  port_base=$((port_base + OFF))
  echo "=== chaos[$name] seed=$SEED ==="
  (
    case_dirs "$name"
    export PS_SEED=$SEED
    export PS_FAULT_PLAN="$plan"
    # retransmit layer: short timeout so drops heal fast, an overall
    # delivery deadline so a wedged run fails loudly instead of hanging
    export PS_RESEND=1 PS_RESEND_TIMEOUT=500 PS_RESEND_DEADLINE=120
    # distinct ports per case: no TIME_WAIT clashes between cases
    export GPORT=$port_base CPORT=$((port_base + 1)) \
           APORT=$((port_base + 2)) BPORT=$((port_base + 3))
    source ./hips_env.sh
    launch_hips geomx_tpu_torch.examples.cnn "$@"
  )
  report "$name" $?
}

# the respawned party-A server of the kill cases: once the crashed
# server's log shows the crash and its heartbeats have lapsed
# (PS_HEARTBEAT_TIMEOUT), a replacement registers, is handed the dead
# slot (is_recovery) and restores the snapshot; PS_EPOCH_GRACE holds the
# dead-node declaration off until then, so the party's workers
# retransmit their round to the replacement instead of failing fast
respawn_party_a() {
  local crashed_log="$1" nwork="$2" log="$3"
  ( for _ in $(seq 600); do
      grep -q "crashing van" "$crashed_log" 2>/dev/null && break
      sleep 0.5
    done
    sleep $((PS_HEARTBEAT_TIMEOUT + 2))
    env $(echo $GLOBALS) DMLC_ROLE=server \
      DMLC_PS_ROOT_URI=$HOST_A DMLC_PS_ROOT_PORT=$APORT \
      DMLC_NUM_SERVER=1 DMLC_NUM_WORKER=$nwork \
      $PYTHON $INFRA > "$log" 2>&1
  ) &
  RESPAWN_PID=$!
}

# a kill case's exit: the run's code, then the replacement's; a crash
# that never fired (the run ended first) fails the case
reap_respawn() {
  local rc="$1" crashed_log="$2"
  if ! grep -q "crashing van" "$crashed_log" 2>/dev/null; then
    echo "the planned crash did not fire before the run ended"
    kill "$RESPAWN_PID" 2>/dev/null
    [ "$rc" = 0 ] && rc=1
  fi
  wait "$RESPAWN_PID" || [ "$rc" != 0 ] || rc=$?
  exit "$rc"
}

run_case loss \
  '[{"type": "drop", "p": 0.2}]' \
  9490 "$@"

run_case wan-jitter \
  '[{"type": "delay", "delay_s": 0.02, "jitter_s": 0.03, "p": 0.5},
    {"type": "dup", "p": 0.05}]' \
  9590 "$@"

run_case partition \
  '[{"type": "partition", "between": [8, "*"], "start_s": 5.0, "duration_s": 3.0}]' \
  9690 "$@"

# drops, reordering and duplicates with P3 slicing; the wire and lock
# sanitizers ride along (no kills, so membership never churns)
export GEOMX_OVERLAP=1 P3_SLICE_BYTES=131072 GEOMX_WIRE_SANITIZER=1 \
       GEOMX_LOCK_SANITIZER=1
run_case overlap \
  '[{"type": "drop", "p": 0.1},
    {"type": "reorder", "window": 4},
    {"type": "dup", "p": 0.05}]' \
  9790 "$@"
unset GEOMX_OVERLAP P3_SLICE_BYTES GEOMX_WIRE_SANITIZER \
      GEOMX_LOCK_SANITIZER
wanted overlap && check_markers overlap WIRE LOCK

# quantized wire under loss: retransmits must replay the packed bytes
# as built (a retry that re-drained a residual would corrupt the error
# feedback), so the bar is the same as overlap: training completes and
# the wire sanitizer stays silent
export GEOMX_WIRE_CODEC=2bit
export GEOMX_OVERLAP=1 P3_SLICE_BYTES=131072 GEOMX_WIRE_SANITIZER=1
run_case quant-wire \
  '[{"type": "drop", "p": 0.1},
    {"type": "dup", "p": 0.05}]' \
  10090 "$@"
unset GEOMX_WIRE_CODEC GEOMX_OVERLAP P3_SLICE_BYTES GEOMX_WIRE_SANITIZER
wanted quant-wire && check_markers quant-wire WIRE

# shaped 16-party chaos, in one process (tools/chaos_sim.py's
# counterpart): exits non-zero on any sanitizer marker, incomplete
# worker, missed or false health event, or an idle controller
shaped_case() {
  local name="$1"; shift
  wanted "$name" || return 0
  echo "=== chaos[$name] seed=$SEED ==="
  mkdir -p "$LOG_ROOT/$name"
  PS_SEED=$SEED $PYTHON -m geomx_tpu_torch.tools.chaos_sim \
    --parties 16 --seed "$SEED" --shape "$SHAPES/hetero16.json" \
    ${CHAOS_SIM_ARGS:-} "$@" 2>&1 | tee "$LOG_ROOT/$name/chaos_sim.log"
  report "$name" "${PIPESTATUS[0]}"
}
( cd "$REPO" && shaped_case shaped-16p ); [ $? -eq 0 ] || FAILED=1
( cd "$REPO" && shaped_case shaped-16p-health --health ); [ $? -eq 0 ] || FAILED=1
( cd "$REPO" && shaped_case shaped-16p-adaptive --controller ); [ $? -eq 0 ] || FAILED=1

# quantized mesh + quantized van under a remote-server kill: 2 parties
# x a 2-rank party mesh, the int8 ring intra-party, the 2-bit combined
# wire on the van, party A's server crashed mid-run (at=60 recv frames,
# past init, while the ring residuals are warm) and respawned; every
# ring residual must reset before the retried round and the wire
# sanitizer stay silent through kill and recovery
if wanted dist-sync-mesh; then
  echo "=== chaos[dist-sync-mesh] seed=$SEED ==="
  (
    case_dirs dist-sync-mesh
    export PS_SEED=$SEED
    export PS_RESEND=1 PS_RESEND_TIMEOUT=500 PS_RESEND_DEADLINE=120
    export PS_HEARTBEAT_INTERVAL=1 PS_HEARTBEAT_TIMEOUT=3 PS_EPOCH_GRACE=60
    export PS_SNAPSHOT_DIR=$LOG_DIR/snapshots PS_SNAPSHOT_INTERVAL=1
    export GEOMX_MESH_CODEC=int8 GEOMX_WIRE_CODEC=2bit
    export GEOMX_OVERLAP=1 P3_SLICE_BYTES=131072 GEOMX_WIRE_SANITIZER=1
    # scoped by hips_env.sh to party A's server alone
    export CHAOS_PLAN_SERVER_A='[{"type": "crash", "node": 8, "at": 60, "on": "recv", "tier": "local"}]'
    export GPORT=$((10190 + OFF)) CPORT=$((10191 + OFF)) \
           APORT=$((10192 + OFF)) BPORT=$((10193 + OFF))
    source ./hips_env.sh
    respawn_party_a "$LOG_DIR/mesh_server_$APORT.log" 1 \
      "$LOG_DIR/mesh_server_A_respawn.log"
    launch_mesh_hips geomx_tpu_torch.examples.cnn "$@"
    reap_respawn $? "$LOG_DIR/mesh_server_$APORT.log"
  )
  report dist-sync-mesh $?
  check_markers dist-sync-mesh WIRE
fi

# elastic membership: both data parties' worker 0 (local id 9) dies at
# the start of training round 3 (cnn.py's kv.notify_round drives the
# at_round trigger; the master worker is also local id 9 but exits
# after init, before any round). Heartbeats declare the corpses dead,
# each party's server re-sizes the round countdown to the survivors,
# and the remaining worker per party completes the run. All three
# sanitizers ride along: membership churn is what the state sanitizer
# mirrors.
export PS_HEARTBEAT_INTERVAL=1 PS_HEARTBEAT_TIMEOUT=3
export PS_OP_TIMEOUT=120
export GEOMX_WIRE_SANITIZER=1 GEOMX_LOCK_SANITIZER=1 GEOMX_STATE_SANITIZER=1
run_case worker-kill \
  '[{"type": "crash", "node": 9, "at_round": 3, "tier": "local"}]' \
  9890 "$@"
unset PS_HEARTBEAT_INTERVAL PS_HEARTBEAT_TIMEOUT PS_OP_TIMEOUT
unset GEOMX_WIRE_SANITIZER GEOMX_LOCK_SANITIZER GEOMX_STATE_SANITIZER
wanted worker-kill && check_markers worker-kill WIRE LOCK STATE

# elastic membership + durable recovery: party A's server crashes on
# its 50th local data frame (mid-round). Its workers' in-flight rounds
# fail fast once the declaration lands; party B and the global tier
# keep training; a replacement server then takes the dead slot
# (is_recovery) and restores party A's state from the snapshot.
if wanted server-kill; then
  echo "=== chaos[server-kill] seed=$SEED ==="
  (
    case_dirs server-kill
    export PS_SEED=$SEED
    export PS_RESEND=1 PS_RESEND_TIMEOUT=500 PS_RESEND_DEADLINE=120
    export PS_HEARTBEAT_INTERVAL=1 PS_HEARTBEAT_TIMEOUT=3 PS_EPOCH_GRACE=60
    export PS_SNAPSHOT_DIR=$LOG_DIR/snapshots PS_SNAPSHOT_INTERVAL=1
    export GEOMX_WIRE_SANITIZER=1 GEOMX_LOCK_SANITIZER=1 GEOMX_STATE_SANITIZER=1
    # scoped by hips_env.sh to party A's server alone (party B's server
    # and the global servers' local role are local id 8 too)
    export CHAOS_PLAN_SERVER_A='[{"type": "crash", "node": 8, "at": 50, "on": "recv", "tier": "local"}]'
    export GPORT=$((9990 + OFF)) CPORT=$((9991 + OFF)) \
           APORT=$((9992 + OFF)) BPORT=$((9993 + OFF))
    source ./hips_env.sh
    respawn_party_a "$LOG_DIR/server_$APORT.log" 2 \
      "$LOG_DIR/server_A_respawn.log"
    launch_hips geomx_tpu_torch.examples.cnn "$@"
    reap_respawn $? "$LOG_DIR/server_$APORT.log"
  )
  report server-kill $?
  check_markers server-kill WIRE LOCK STATE
fi

exit $FAILED
