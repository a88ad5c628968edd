"""The PyTorch port stands alone: no module of ``dynamo_tpu_torch`` (nor
``chip_smoke.py``) imports JAX, the JAX package, or a package the card's
machine lacks (``tokenizers``, ``aiohttp`` and ``prometheus_client`` among
them: the port has its own replacements), and ``triton`` is never imported
at module level. Its entry
points refuse to fall back to the CPU when no device is given and no GPU is
present, and engine construction refuses the paths this slice does not
serve. The distributed entry points refuse every flag whose path is not
ported yet and accept every router mode, the KV-movement flags and the
settings of the prefix cache, the disaggregated handoff and preemption, and
the store and the frontend never load ``torch``."""

import ast
import asyncio
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dynamo_tpu_torch import run as trun
from dynamo_tpu_torch.engine import EngineConfig, InferenceEngine, ModelConfig
from dynamo_tpu_torch.engine.config import check_supported

ROOT = Path(__file__).resolve().parent.parent
# a byte-level BPE tokenizer.json with no merges: enough for the launcher
TOKENIZER_STUB = (
    '{"added_tokens": [], "normalizer": null, "pre_tokenizer": '
    '{"type": "ByteLevel", "add_prefix_space": false}, "post_processor": '
    'null, "decoder": {"type": "ByteLevel"}, "model": {"type": "BPE", '
    '"vocab": {"a": 0, "b": 1}, "merges": []}}')
FILES = sorted((ROOT / "dynamo_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
# never imported anywhere: JAX, the JAX package, and what the card's
# machine does not install (or no record says it does)
FORBIDDEN = {"jax", "jaxlib", "dynamo_tpu", "xxhash", "msgpack",
             "ml_dtypes", "tokenizers", "aiohttp", "prometheus_client",
             "safetensors", "grpc", "benchmarks"}
# the modules of the KV-movement slice (each scanned like every other)
KV_MOVEMENT = ["disagg/__init__.py", "disagg/protocol.py", "disagg/ici.py",
               "disagg/handlers.py", "kvbm/__init__.py", "kvbm/host_pool.py",
               "kvbm/manager.py", "kvbm/distributed.py",
               "runtime/barrier.py", "runtime/preemption.py",
               "prefix/manager.py"]
# the loader and MoE slice's modules
LOADER_AND_MOE = ["engine/safetensors.py", "engine/weights.py",
                  "parallel/__init__.py", "parallel/moe.py"]
# the planner, aggregator, mocker and replay slice's modules
PLANNER_AND_REPLAY = ["llm/recorder.py", "planner/predictors.py",
                      "planner/interpolation.py", "planner/core.py",
                      "planner/connector.py", "planner/orchestrator.py",
                      "planner/profiler.py",
                      "planner/kubernetes_connector.py",
                      "planner/__main__.py", "metrics_aggregator.py",
                      "mocker/__init__.py", "mocker/engine.py",
                      "mocker/cluster.py", "mocker/__main__.py",
                      "replay/__init__.py", "replay/datagen.py",
                      "replay/trace.py", "replay/driver.py",
                      "replay/scoreboard.py", "replay/__main__.py",
                      "utils/httpclient.py"]
# imported only inside the function that launches a kernel
NOT_AT_MODULE_LEVEL = {"triton"}


def _imports(tree):
    """(top-level package, at module level?) for every absolute import; an
    import under ``if``/``try`` at module level counts as module level, one
    inside a function or class body does not."""
    found = []

    def visit(node, top):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Import):
                for a in child.names:
                    found.append((a.name.split(".")[0], top))
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                found.append((child.module.split(".")[0], top))
            visit(child, top and not isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                        ast.ClassDef)))

    visit(tree, True)
    return found


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_module_imports_stand_alone(path):
    for name, top in _imports(ast.parse(path.read_text())):
        assert name not in FORBIDDEN, f"{path.name} imports {name}"
        if top:
            assert name not in NOT_AT_MODULE_LEVEL, \
                f"{path.name} imports {name} at module level"


def test_scan_covers_the_kv_movement_modules():
    scanned = {p.relative_to(ROOT / "dynamo_tpu_torch").as_posix()
               for p in FILES if "dynamo_tpu_torch" in p.parts}
    assert set(KV_MOVEMENT) <= scanned
    for rel in KV_MOVEMENT:
        names = {n for n, _ in _imports(ast.parse(
            (ROOT / "dynamo_tpu_torch" / rel).read_text()))}
        assert not names & FORBIDDEN, rel


def test_scan_covers_the_loader_and_moe_modules():
    """The checkpoint loader, the port's safetensors reader and the MoE
    package are scanned like every other module: none imports
    ``safetensors``, ``ml_dtypes`` or JAX."""
    scanned = {p.relative_to(ROOT / "dynamo_tpu_torch").as_posix()
               for p in FILES if "dynamo_tpu_torch" in p.parts}
    assert set(LOADER_AND_MOE) <= scanned
    for rel in LOADER_AND_MOE:
        names = {n for n, _ in _imports(ast.parse(
            (ROOT / "dynamo_tpu_torch" / rel).read_text()))}
        assert not names & FORBIDDEN, rel


def test_scan_covers_the_planner_and_replay_modules():
    scanned = {p.relative_to(ROOT / "dynamo_tpu_torch").as_posix()
               for p in FILES if "dynamo_tpu_torch" in p.parts}
    assert set(PLANNER_AND_REPLAY) <= scanned
    for rel in PLANNER_AND_REPLAY:
        names = {n for n, _ in _imports(ast.parse(
            (ROOT / "dynamo_tpu_torch" / rel).read_text()))}
        assert not names & FORBIDDEN, (rel, names & FORBIDDEN)


def test_scan_sees_nested_imports():
    tree = ast.parse("import os\n"
                     "def f():\n    import triton\n"
                     "try:\n    import jax\nexcept ImportError:\n    pass\n")
    assert sorted(_imports(tree)) == [("jax", True), ("os", True),
                                      ("triton", False)]


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_engine_without_device_raises_on_a_cpu_machine(no_gpu):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(ModelConfig.tiny(), EngineConfig(num_blocks=16))


def test_engine_asked_for_cuda_raises_on_a_cpu_machine(no_gpu):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(ModelConfig.tiny(), EngineConfig(num_blocks=16),
                        device="cuda")


def test_run_without_device_raises_on_a_cpu_machine(no_gpu, tmp_path):
    batch = tmp_path / "b.jsonl"
    batch.write_text('{"token_ids": [1, 2], "max_tokens": 2}\n')
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.main([f"in=batch:{batch}", "out=engine", "--model", "tiny"])


def test_run_http_without_device_raises_on_a_cpu_machine(no_gpu, tmp_path):
    tok = tmp_path / "tok.json"
    tok.write_text(TOKENIZER_STUB)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.main(["in=http", "out=engine", "--model", "tiny",
                   "--tokenizer", str(tok), "--port", "0"])


def test_importing_the_port_loads_nothing_forbidden():
    """Every module of the port imported in a fresh interpreter (the HTTP
    frontend, the tokenizer reader, the metrics and tracing copies among
    them) leaves no forbidden package in ``sys.modules``."""
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in (ROOT / "dynamo_tpu_torch").rglob("*.py")
        if p.name != "__main__.py")
    # the port's own xxh3 stands in for xxhash, and the KV router is the
    # one module that needed both it and the codec
    assert {"dynamo_tpu_torch.utils.xxh3",
            "dynamo_tpu_torch.router.kv_router"} <= set(mods)
    assert {"dynamo_tpu_torch." + m[:-3].replace("/", ".")
            for m in KV_MOVEMENT if not m.endswith("__init__.py")} \
        <= set(mods)
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + f"bad = {sorted(FORBIDDEN | NOT_AT_MODULE_LEVEL)!r}\n"
            "print(sorted(m for m in bad if m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("knob", [
    dict(mesh_shape=(1, 2)), dict(pp_stages=2),
    dict(sp_prefill_threshold=1024),
], ids=lambda k: next(iter(k)))
def test_unserved_paths_are_refused(knob):
    eng = EngineConfig(num_blocks=16, **knob)
    with pytest.raises(NotImplementedError):
        check_supported(eng)
    with pytest.raises(NotImplementedError):
        InferenceEngine(ModelConfig.tiny(), eng, device="cpu")


def test_spec_mode_is_served():
    eng = EngineConfig(num_blocks=16, spec_mode="ngram")
    check_supported(eng)
    engine = InferenceEngine(ModelConfig.tiny(), eng, device="cpu")
    assert engine.pipeline_depth == 1
    assert engine.scheduler.spec_plan_window == eng.spec_k + 1
    assert engine._ctl["hist"].shape == (eng.max_num_seqs + 1,
                                         eng.max_model_len + 1)


@pytest.mark.parametrize("knob", [
    dict(weight_dtype="int8"), dict(kv_dtype="fp8"),
], ids=lambda k: next(iter(k)))
def test_quantized_paths_are_served(knob):
    eng = EngineConfig(num_blocks=16, **knob)
    check_supported(eng)
    engine = InferenceEngine(ModelConfig.tiny(), eng, device="cpu")
    if "kv_dtype" in knob:
        assert set(engine.cache) == {"k", "v", "ks", "vs"}
    else:
        assert isinstance(engine.params["layers"]["wq"], dict)


# ------------------------- the distributed entry points ------------------


def test_worker_without_device_raises_on_a_cpu_machine():
    """``python -m dynamo_tpu_torch.worker`` with no ``--device`` on a
    machine without a GPU: the engine is built before the store is dialled,
    so the refusal comes first."""
    assert not torch.cuda.is_available()
    out = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.worker", "--model", "tiny",
         "--store-addr", "127.0.0.1:9"], cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


@pytest.mark.parametrize("flags", [
    ["--mesh", "1,2"], ["--pp", "2"],
    ["--attention-impl", "auto"], ["--mm-encoder"],
    ["--mm-encode-component", "encoder"], ["--coordinator", "h0:1234"],
    ["--num-hosts", "2"], ["--model", "70b"],
], ids=lambda f: f[0].lstrip("-") + ("" if len(f) == 1 else f"={f[1]}"))
def test_worker_refuses_unserved_flags(flags):
    from dynamo_tpu_torch import worker

    args = worker.parse_args(["--device", "cpu", *flags])
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        asyncio.run(worker.run_worker(args))


def test_worker_weights_without_a_checkpoint_raises_as_jax_does(tmp_path):
    """``--weights`` is served: a directory that holds no checkpoint raises
    ``FileNotFoundError`` from the loader, as the JAX worker's does."""
    from dynamo_tpu.engine import weights as jw
    from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
    from dynamo_tpu_torch import worker

    missing = str(tmp_path / "ckpt")
    args = worker.parse_args(["--device", "cpu", "--weights", missing])
    worker.check_supported(args)
    with pytest.raises(FileNotFoundError, match="no \\*.safetensors"):
        asyncio.run(worker.run_worker(args))
    with pytest.raises(FileNotFoundError, match="no \\*.safetensors"):
        jw.load_hf_params(missing, JaxModelConfig.tiny())


@pytest.mark.parametrize("flags", [
    ["--disagg-mode", "prefill"], ["--disagg-mode", "decode"],
    ["--disagg-queue"], ["--kvbm-host-blocks", "64"], ["--kvbm-remote"],
    ["--kvbm-disk-dir", "/tmp/g3"], ["--kvbm-distributed"],
    ["--kvbm-group", "g"],
], ids=lambda f: f[0].lstrip("-") + ("" if len(f) == 1 else f"={f[1]}"))
def test_worker_serves_kv_movement_flags(flags):
    from dynamo_tpu_torch import worker

    args = worker.parse_args(["--device", "cpu", *flags])
    worker.check_supported(args)


def test_worker_serves_spec_mode():
    from dynamo_tpu_torch import worker

    args = worker.parse_args(["--device", "cpu", "--spec-mode", "ngram",
                              "--spec-k", "3"])
    worker.check_supported(args)
    assert (args.spec_mode, args.spec_k) == ("ngram", 3)


def test_worker_maps_the_jax_attention_names():
    from dynamo_tpu_torch import worker

    for name, impl in (("pallas", "kernel"), ("einsum", "einsum")):
        args = worker.parse_args(["--attention-impl", name])
        worker.check_supported(args)
        assert worker.ATTENTION_IMPLS[args.attention_impl] == impl


@pytest.mark.parametrize("flags", [["--grpc-port", "9000"]],
                         ids=["grpc-port"])
def test_frontend_refuses_unserved_flags(flags):
    from dynamo_tpu_torch.frontend import __main__ as frontend

    with pytest.raises(NotImplementedError):
        asyncio.run(frontend.run_frontend(frontend.parse_args(flags)))


@pytest.mark.parametrize("mode", ["round_robin", "random", "kv"])
def test_frontend_serves_every_router_mode(mode):
    from dynamo_tpu_torch.frontend import __main__ as frontend

    frontend.check_supported(frontend.parse_args(["--router-mode", mode]))


@pytest.mark.parametrize("env", [
    "DYNTPU_SYSTEM_ENABLED", "DYNTPU_HEALTH_CHECK_ENABLED",
    "DYNTPU_PLANNER_APPLY_DEGRADATION", "DYNTPU_PREFIX_ENABLED"])
def test_runtime_serves_control_plane_settings(monkeypatch, env):
    from dynamo_tpu_torch.utils.config import RuntimeConfig, check_supported

    monkeypatch.setenv(env, "1")
    cfg = RuntimeConfig.from_settings()
    check_supported(cfg)
    assert getattr(cfg, env[len("DYNTPU_"):].lower()) is True


def test_routed_pipeline_refuses_a_multimodal_card():
    from dynamo_tpu_torch.llm.discovery import ModelDeploymentCard
    from dynamo_tpu_torch.llm.entrypoint import build_routed_pipeline

    card = ModelDeploymentCard(name="m", tokenizer_json=TOKENIZER_STUB,
                               runtime_config={"multimodal": {
                                   "tokens_per_image": 16}})
    with pytest.raises(NotImplementedError, match="multimodal"):
        build_routed_pipeline(card, client=None)


def test_store_and_frontend_never_touch_the_gpu():
    """The store, the frontend, its KV router (with the prefix package it
    imports) and a routed pipeline load no ``torch`` at all, so they cannot
    initialise CUDA (nor stall the frontend's loop on torch's import)."""
    code = (
        "import sys\n"
        "import dynamo_tpu_torch.runtime.store\n"
        "import dynamo_tpu_torch.frontend.__main__\n"
        "import dynamo_tpu_torch.router.kv_router\n"
        "import dynamo_tpu_torch.prefix\n"
        "from dynamo_tpu_torch.llm.discovery import ModelDeploymentCard\n"
        "from dynamo_tpu_torch.llm.entrypoint import build_routed_pipeline\n"
        f"card = ModelDeploymentCard(name='m', tokenizer_json={TOKENIZER_STUB!r})\n"
        "build_routed_pipeline(card, client=None)\n"
        "print('torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
