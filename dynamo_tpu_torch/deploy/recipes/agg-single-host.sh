#!/usr/bin/env bash
# Config #1: aggregated serving on one GPU host (BASELINE.md config 1):
# the store, one worker over a (dp, tp) mesh of the host's cards, and the
# frontend, all port processes. The worker runs on the card by default.
# Usage: MODEL_DIR=/models/llama3-8b MESH=1,4 ./agg-single-host.sh
set -euo pipefail
MODEL_DIR="${MODEL_DIR:?set MODEL_DIR to an HF checkpoint dir}"
MESH="${MESH:-1,4}"
STORE="${STORE:-127.0.0.1:4222}"
export DYNTPU_STORE_ADDR="$STORE"

python -m dynamo_tpu_torch.runtime.store --host 0.0.0.0 --port "${STORE##*:}" &
sleep 1
python -m dynamo_tpu_torch.worker --weights "$MODEL_DIR" --mesh "$MESH" \
    --kvbm-host-blocks 4096 &
python -m dynamo_tpu_torch.frontend --port 8000 --router-mode round_robin &
wait
