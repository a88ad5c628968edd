#!/usr/bin/env bash
# Config #4: Llama-3-70B tensor parallel over several GPU hosts. Run THIS
# SCRIPT ON EVERY HOST; each host's worker starts one rank per local card,
# and the ranks join one world at the coordinator (a TCP store on host 0).
# Host 0 additionally runs the store + frontend.
#
# Usage (per host):
#   MODEL_DIR=/models/llama3-70b HOST_INDEX=$(hostname | sed 's/.*-//') \
#   COORD=host0-ip NUM_HOSTS=16 ./llama70b-multihost.sh
set -euo pipefail
MODEL_DIR="${MODEL_DIR:?set MODEL_DIR}"
HOST_INDEX="${HOST_INDEX:?set HOST_INDEX (0..NUM_HOSTS-1)}"
COORD="${COORD:?set COORD (host 0 ip)}"
NUM_HOSTS="${NUM_HOSTS:-16}"
# global mesh over the hosts: dp=1, tp=total cards
CHIPS_PER_HOST="${CHIPS_PER_HOST:-4}"
MESH="1,$((NUM_HOSTS * CHIPS_PER_HOST))"
export DYNTPU_STORE_ADDR="$COORD:4222"

if [ "$HOST_INDEX" = "0" ]; then
  python -m dynamo_tpu_torch.runtime.store --host 0.0.0.0 --port 4222 &
  sleep 1
  python -m dynamo_tpu_torch.frontend --port 8000 --router-mode round_robin &
fi
# host 0 is the leader (schedules + serves); hosts 1..N-1 are followers
# replaying the leader's step plans over the step_stream endpoint
python -m dynamo_tpu_torch.worker --model 70b --weights "$MODEL_DIR" \
    --mesh "$MESH" --max-model-len 8192 \
    --coordinator "$COORD:8476" --num-hosts "$NUM_HOSTS" \
    --host-index "$HOST_INDEX" &
wait
