"""The harness end to end on the CPU, at a tiny size: the contract's result
line, parts found by name, the isolation checks."""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys

import pytest

from portbench import run as bench
from portbench import spec
from portbench.tests.conftest import ROOT

CONTRACT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def run_cell(root, name, capsys, *extra, seed=2**31 + 11, seconds=2,
             trace=0):
    args = bench.parse(["--workload", name, "--seed", str(seed),
                        "--seconds", str(seconds), "--trace", str(trace),
                        *extra])
    rc = bench.run(args, spec.load(root, name), "cpu")
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    return rc, line, err


@pytest.mark.parametrize("name", ["tiny.open", "tiny.closed",
                                  "tiny-moe.closed"])
def test_a_run_prints_a_contract_line(checkout, capsys, name):
    rc, line, err = run_cell(checkout, name, capsys)
    assert rc == 0
    assert CONTRACT_KEYS <= set(line)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    want = {m["name"] for m in spec.load(checkout, name).end_to_end}
    assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    # the numbers compared close standard error, each beside its limit
    (compared,) = line["checks"]
    last = err.strip().splitlines()[-1]
    assert last.startswith(f"check {compared} ") and " limit " in last


def test_a_traced_run_reads_its_per_layer_metrics(checkout, capsys):
    rc, line, _ = run_cell(checkout, "tiny.open", capsys, trace=1)
    assert rc == 0 and line["correct"] is True
    # on the CPU only the span and counter readers find something; the
    # device readers return nothing and their metrics are left out
    assert {"queue_wait_p50_ms", "prefill_p50_ms",
            "decode_batch_mean"} <= set(line["metrics"])
    assert "mfu.decode-heavy" not in line["metrics"]
    assert line["metrics"]["decode_batch_mean"]["value"] >= 1


def test_new_mix_and_metric_are_found_by_name(checkout, capsys):
    """A cell, a mix and a metric that later work adds are new files and
    new entries: no file the harness has is edited."""
    pb = checkout / "portbench"
    (pb / "traffic" / "burst.json").write_text(json.dumps({
        "loop": "open", "isl": {"dist": "fixed", "value": 24},
        "osl": {"dist": "fixed", "value": 6}, "check_requests": 2,
        "drain_s": 30}))
    (pb / "cells" / "tiny.burst.json").write_text(json.dumps(
        {"rate_rps": 6.0, "limits": {"max_logit_gap": 1e-3}}))
    (pb / "metrics" / "requests_seen.py").write_text(
        "def read(r):\n    return float(len(r.results))\n")
    bench_json = json.loads((checkout / "BENCHMARK.json").read_text())
    bench_json["workloads"].append({"name": "tiny.burst", "config": "tiny",
                                    "traffic": "burst", "chips": 1,
                                    "why": "test"})
    bench_json["per_layer"].append({
        "name": "requests_seen", "unit": "requests", "better": "higher",
        "source": "host_clock", "layer": "test", "moves": "itl_p95_ms",
        "workloads": ["tiny.burst"]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench_json))
    rc, line, _ = run_cell(checkout, "tiny.burst", capsys, trace=1)
    assert rc == 0 and line["correct"] is True
    assert line["metrics"]["requests_seen"]["value"] == 12
    assert line["attempted"] == 12


# a copy of the Mistral block under a new model_type; each copy says on
# standard error that it was called
_TRACED = {
    "arch": "\n\n_shapes = shapes\n\n\ndef shapes(c):\n"
            "    import sys\n    print('mistral2 arch', file=sys.stderr)\n"
            "    return _shapes(c)\n",
    "reference": "\n\n_head = head\n\n\ndef head(params, cfg):\n"
                 "    import sys\n"
                 "    print('mistral2 reference', file=sys.stderr)\n"
                 "    return _head(params, cfg)\n",
}


def test_new_architecture_is_found_by_name(checkout, capsys):
    """An architecture that later work adds is new files: its
    ``arch/<model_type>.py``, its ``reference/<model_type>.py`` and a
    configuration that names the ``model_type``, with a cell; no file the
    harness has is edited. Here a renamed copy of the Mistral block."""
    pb = checkout / "portbench"
    for part, traced in _TRACED.items():
        text = (ROOT / "portbench" / part / "mistral.py").read_text()
        (pb / part / "mistral2.py").write_text(text + traced)
    cfg = json.loads((pb / "configs" / "tiny.json").read_text())
    cfg["model_type"] = "mistral2"
    (pb / "configs" / "tiny2.json").write_text(json.dumps(cfg))
    (pb / "cells" / "tiny2.open.json").write_text(json.dumps(
        {"rate_rps": 8.0, "limits": {"max_logit_gap": 1e-3}}))
    bench_json = json.loads((checkout / "BENCHMARK.json").read_text())
    bench_json["configs"].append({
        "name": "tiny2", "source": "test", "reduced": [], "why": "test",
        "file": "portbench/configs/tiny2.json"})
    bench_json["workloads"].append({"name": "tiny2.open", "config": "tiny2",
                                    "traffic": "tiny-open", "chips": 1,
                                    "why": "test"})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench_json))
    rc, line, err = run_cell(checkout, "tiny2.open", capsys, trace=1)
    assert rc == 0 and line["correct"] is True and line["failed"] == 0
    assert "mistral2 arch" in err and "mistral2 reference" in err
    assert line["metrics"]["prefill_p50_ms"]["value"] > 0


def test_an_unknown_architecture_is_refused(checkout):
    """A configuration whose ``model_type`` has no files of its own is not
    served as another architecture: the run stops before it starts."""
    cfg = json.loads((checkout / "portbench" / "configs" / "tiny.json")
                     .read_text())
    for bad in (dict(cfg, model_type="llama"),
                {k: v for k, v in cfg.items() if k != "model_type"}):
        with pytest.raises(SystemExit):
            spec.arch(checkout / "portbench", bad)
        with pytest.raises(SystemExit):
            spec.reference(checkout / "portbench", bad)


def test_a_limit_exceeded_is_not_correct(checkout, capsys):
    cells = checkout / "portbench" / "cells"
    (cells / "tiny.closed.json").write_text(json.dumps(
        {"limits": {"max_logit_gap": -1.0}}))
    rc, line, _ = run_cell(checkout, "tiny.closed", capsys)
    assert rc == 0 and line["correct"] is False
    assert line["checks"]["max_logit_gap"]["limit"] == -1.0


def test_no_card_no_result():
    """Without a CUDA device the run exits non-zero and prints nothing on
    standard output; so does a directory without the program."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "mistral7b.decode-heavy", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_needs_the_program(tmp_path):
    import shutil

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "mistral7b.decode-heavy", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120, env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and proc.stdout == ""


FORBIDDEN = {"jax", "jaxlib", "flax", "dynamo_tpu"}


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = list((ROOT / "portbench").rglob("*.py"))
    assert files
    for f in files:
        assert not top_level_imports(f) & FORBIDDEN, f
    for f in (ROOT / "portbench" / "reference").glob("*.py"):
        assert "dynamo_tpu_torch" not in top_level_imports(f), f


# harness keys and keys every architecture's config.json has: not the
# Mistral block's own
_GENERAL_KEYS = {"source", "deployment", "reduced", "assumed", "engine",
                 "model_type", "torch_dtype", "architectures"}


def _mistral_names():
    """The Mistral / Mixtral configurations' keys and the block's leaf
    names."""
    from portbench.arch import mistral

    names = set()
    for f in (ROOT / "portbench" / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        if cfg.get("model_type") in ("mistral", "mixtral"):
            names |= set(cfg) - _GENERAL_KEYS
            names |= {n.split("/")[-1] for n, _, _ in
                      mistral.leaf_shapes(mistral.shapes(cfg))}
    return names


def test_the_shared_modules_name_no_architecture():
    """The harness's shared code holds no key or leaf of the Mistral block:
    those live in ``arch/`` and ``reference/<model_type>.py`` alone, so
    that a new architecture is new files."""
    names = _mistral_names()
    assert {"num_local_experts", "num_experts_per_tok", "intermediate_size",
            "w_router", "wq", "lm_head", "rms_norm_eps"} <= names
    pb = ROOT / "portbench"
    shared = [*pb.glob("*.py"), pb / "reference" / "check.py",
              pb / "reference" / "model.py", *(pb / "metrics").glob("*.py")]
    assert len(shared) > 10
    pattern = re.compile(r"(?<![A-Za-z0-9_])(%s)(?![A-Za-z0-9_])"
                         % "|".join(map(re.escape, sorted(names))))
    for f in shared:
        found = sorted(set(pattern.findall(f.read_text())))
        assert not found, f"{f.relative_to(ROOT)} names {found}"


def test_nothing_a_run_loads_is_jax(tmp_path):
    """A whole tiny run in a fresh process: no module of the JAX stack or
    the JAX package is loaded by its end (top-level names compared
    whole: the port's name begins with the JAX package's)."""
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
from pathlib import Path
from portbench.tests.conftest import make_checkout
from portbench import run as bench, spec
root = make_checkout(Path({str(tmp_path)!r}))
args = bench.parse(["--workload", "tiny-moe.closed", "--seed", "4",
                    "--seconds", "1", "--trace", "1"])
assert bench.run(args, spec.load(root, "tiny-moe.closed"), "cpu") == 0
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "dynamo_tpu_torch" in loaded
    assert not loaded & FORBIDDEN
