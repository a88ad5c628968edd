"""A tiny benchmark in a temporary checkout: its own ``BENCHMARK.json``,
tiny float32 configurations, tiny mixes and cells, and the real metric
readers and architectures, run on the CPU with the kernels' plain
versions."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {
    "source": "tiny test configuration", "reduced": [], "assumed": {},
    "model_type": "mistral",
    "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
    "num_attention_heads": 8, "num_key_value_heads": 4, "head_dim": 16,
    "vocab_size": 512, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
    "tie_word_embeddings": False, "torch_dtype": "float32",
    "engine": {"num_blocks": 256, "max_num_batched_tokens": 128,
               "prefill_buckets": [16, 32, 64, 128], "max_model_len": 256,
               "max_num_seqs": 8, "decode_buckets": [8],
               "attention_impl": "kernel"},
}
TINY_MOE = dict(TINY, model_type="mixtral", num_local_experts=4,
                num_experts_per_tok=2)
# every configuration of the tiny benchmark, by name
CONFIGS = {"tiny": TINY, "tiny-moe": TINY_MOE}
MIXES = {
    "tiny-open": {"loop": "open", "arrivals": "poisson",
                  "isl": {"dist": "lognormal", "median": 40, "sigma": 0.5,
                          "min": 16, "max": 150},
                  "osl": {"dist": "uniform", "min": 4, "max": 12},
                  "check_requests": 3, "drain_s": 30},
    "tiny-closed": {"loop": "closed", "clients": 4,
                    "isl": {"dist": "lognormal", "median": 24, "sigma": 0.5,
                            "min": 8, "max": 64},
                    "osl": {"dist": "uniform", "min": 8, "max": 24},
                    "first_osl": {"dist": "uniform", "min": 2, "max": 24},
                    "requests_per_client": 40, "ramp_s": 0.5,
                    "check_requests": 3},
}
PER_LAYER = ["queue_wait_p50_ms", "prefill_p50_ms", "decode_batch_mean",
             "mfu.decode-heavy"]


def bench_json(cells):
    return {
        "command": ["python3", "portbench/run.py"], "paths": ["portbench"],
        "run_seconds": 2,
        "configs": [
            {"name": name, "source": "test", "reduced": [], "why": "test",
             "file": f"portbench/configs/{name}.json"} for name in CONFIGS],
        "workloads": [{"name": n, "config": c, "traffic": t, "chips": 1,
                       "why": "test"} for n, c, t in cells],
        "end_to_end": [
            {"name": "output_tok_s", "unit": "tokens/s", "better": "higher",
             "bound": 0.05, "source": "host_clock",
             "workloads": [n for n, _, t in cells if "closed" in t]},
            {"name": "ttft_p95_ms", "unit": "ms", "better": "lower",
             "bound": 0.1, "source": "host_clock",
             "workloads": [n for n, _, t in cells if "open" in t]},
            {"name": "itl_p95_ms", "unit": "ms", "better": "lower",
             "bound": 0.1, "source": "host_clock"},
            {"name": "setup_s", "unit": "s", "better": "lower",
             "bound": 0.25, "source": "host_clock"}],
        "per_layer": [{"name": m, "unit": "ms", "better": "lower",
                       "source": "program_span", "layer": "test",
                       "moves": "itl_p95_ms"} for m in PER_LAYER],
    }


@pytest.fixture
def checkout(tmp_path):
    """A checkout holding the tiny benchmark; returns its root."""
    return make_checkout(tmp_path)


def make_checkout(tmp_path):
    pb = tmp_path / "portbench"
    for d in ("configs", "traffic", "cells"):
        (pb / d).mkdir(parents=True)
    for d in ("metrics", "arch", "reference"):
        shutil.copytree(ROOT / "portbench" / d, pb / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for name, cfg in CONFIGS.items():
        (pb / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for name, mix in MIXES.items():
        (pb / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    cells = [("tiny.open", "tiny", "tiny-open"),
             ("tiny.closed", "tiny", "tiny-closed"),
             ("tiny-moe.closed", "tiny-moe", "tiny-closed")]
    for name, _, _ in cells:
        (pb / "cells" / f"{name}.json").write_text(json.dumps(
            {"limits": {"max_logit_gap": 1e-3}}))
    (pb / "cells" / "tiny.open.json").write_text(json.dumps(
        {"rate_rps": 8.0, "limits": {"max_logit_gap": 1e-3}}))
    # an expert cell compares the mean gap, as the Mixtral cell does
    (pb / "cells" / "tiny-moe.closed.json").write_text(json.dumps(
        {"limits": {"mean_logit_gap": 1e-4}}))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench_json(cells)))
    return tmp_path
