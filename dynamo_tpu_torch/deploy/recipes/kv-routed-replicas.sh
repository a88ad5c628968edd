#!/usr/bin/env bash
# Config #2: N replicated port workers behind the KV-cache-aware router.
# Usage: MODEL_DIR=... REPLICAS=4 ./kv-routed-replicas.sh
set -euo pipefail
MODEL_DIR="${MODEL_DIR:?set MODEL_DIR}"
REPLICAS="${REPLICAS:-2}"
MESH="${MESH:-1,1}"
STORE="${STORE:-127.0.0.1:4222}"
export DYNTPU_STORE_ADDR="$STORE"

python -m dynamo_tpu_torch.runtime.store --host 0.0.0.0 --port "${STORE##*:}" &
sleep 1
for i in $(seq 1 "$REPLICAS"); do
  python -m dynamo_tpu_torch.worker --weights "$MODEL_DIR" --mesh "$MESH" &
done
python -m dynamo_tpu_torch.frontend --port 8000 --router-mode kv \
    --busy-threshold 0.95 &
wait
