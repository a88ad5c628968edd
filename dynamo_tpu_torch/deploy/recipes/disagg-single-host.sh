#!/usr/bin/env bash
# Config #3: disaggregated prefill/decode on one GPU host (xPyD; the
# reference's disagg-single-node recipe shape:
# recipes/llama-3-70b/vllm/disagg-single-node), on port processes.
# Usage: MODEL_DIR=... PREFILL=1 DECODE=1 ./disagg-single-host.sh
set -euo pipefail
MODEL_DIR="${MODEL_DIR:?set MODEL_DIR}"
PREFILL="${PREFILL:-1}"
DECODE="${DECODE:-1}"
MESH="${MESH:-1,2}"
STORE="${STORE:-127.0.0.1:4222}"
export DYNTPU_STORE_ADDR="$STORE"

python -m dynamo_tpu_torch.runtime.store --host 0.0.0.0 --port "${STORE##*:}" &
sleep 1
for i in $(seq 1 "$PREFILL"); do
  python -m dynamo_tpu_torch.worker --weights "$MODEL_DIR" --mesh "$MESH" \
      --disagg-mode prefill &
done
for i in $(seq 1 "$DECODE"); do
  python -m dynamo_tpu_torch.worker --weights "$MODEL_DIR" --mesh "$MESH" \
      --disagg-mode decode --min-remote-prefill-tokens 64 \
      --kvbm-host-blocks 4096 &
done
python -m dynamo_tpu_torch.frontend --port 8000 --router-mode kv &
wait
