"""The PyTorch port stands alone: no module of ``dynamo_tpu_torch`` (nor
``chip_smoke.py``) imports JAX, the JAX package, or a package the card's
machine lacks (``tokenizers``, ``aiohttp`` and ``prometheus_client`` among
them: the port has its own replacements), and ``triton`` is never imported
at module level. Its entry
points refuse to fall back to the CPU when no device is given and no GPU is
present, and engine construction refuses the paths this slice does not
serve. The distributed entry points refuse every flag whose path is not
ported yet and accept every router mode, the KV-movement and multimodal
flags and the settings of the prefix cache, the disaggregated handoff and
preemption, and the store and the frontend (its multimodal and embeddings
pieces included), the scale watcher and the graph controller never load
``torch``."""

import ast
import asyncio
import re
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
             "safetensors", "grpc", "google", "pyarrow", "benchmarks",
             "orbax"}
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
# the engine-tuning slice's modules (autotune, ladders, the capture watch,
# on-demand profiles)
TUNING = ["engine/autotune.py", "engine/ladder.py",
          "observability/compilewatch.py", "observability/profiling.py"]
# the embeddings and multimodal slice's modules
MULTIMODAL = ["multimodal/__init__.py", "multimodal/__main__.py",
              "multimodal/encoder.py", "multimodal/processor.py",
              "multimodal/wire.py"]
# the KServe gRPC and host hot-loop slice's modules (the port's own HTTP/2,
# HPACK, protobuf codec and gRPC, and the C++ library's loader)
KSERVE_AND_NATIVE = ["kserve/__init__.py", "kserve/grpc.py",
                     "kserve/messages.py", "kserve/service.py",
                     "native/__init__.py", "utils/protowire.py",
                     "utils/hpack.py", "utils/http2.py", "ops/_build.py"]
# the task tracker, checkpoint and dynalint slice's modules
TASKS_CHECKPOINT_LINT = ["runtime/tasks.py", "engine/weights.py",
                         "analysis/__init__.py", "analysis/__main__.py",
                         "analysis/core.py", "analysis/rules.py",
                         "analysis/rules_hostsync.py",
                         "analysis/rules_recompile.py",
                         "analysis/rules_async.py",
                         "analysis/rules_kernels.py",
                         "analysis/rules_sharding.py",
                         "analysis/baseline.py"]
# the deployment layer's modules (the scale watcher and the graph
# controller run beside the workers, as the store and the frontend do)
DEPLOY = ["deploy/__init__.py", "deploy/scale_watcher.py",
          "deploy/controller.py"]
# the C++ standard library headers a host source may include
CXX_STD_HEADERS = {"cstdint", "cstring", "cstddef", "cstdlib",
                   "unordered_map", "vector", "algorithm", "utility",
                   "array", "string", "memory", "limits"}
# imported only inside the function that launches a kernel
NOT_AT_MODULE_LEVEL = {"triton"}
# what must not be in ``sys.modules`` after importing the port: the bare
# ``google`` namespace package may be there before any import (a site
# ``.pth`` file of another google package loads it), so protobuf is named
LOADED_FORBIDDEN = (FORBIDDEN - {"google"}) | {"google.protobuf"} \
    | NOT_AT_MODULE_LEVEL


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


def test_scan_covers_the_tuning_modules():
    """The tuning slice's modules are scanned like every other; the two
    observability modules, which control-plane processes load, import no
    torch at module level."""
    scanned = {p.relative_to(ROOT / "dynamo_tpu_torch").as_posix()
               for p in FILES if "dynamo_tpu_torch" in p.parts}
    assert set(TUNING) <= scanned
    for rel in TUNING:
        found = _imports(ast.parse(
            (ROOT / "dynamo_tpu_torch" / rel).read_text()))
        assert not {n for n, _ in found} & FORBIDDEN, rel
        if rel.startswith("observability/"):
            assert ("torch", True) not in found, rel


def test_scan_covers_the_multimodal_modules():
    """The multimodal modules are scanned like every other: none imports
    ``xxhash`` (the processor hashes with the port's own XXH3) nor JAX;
    the processor, the wire arrays and the package's ``__init__``, which
    the frontend loads, import no torch at all."""
    scanned = {p.relative_to(ROOT / "dynamo_tpu_torch").as_posix()
               for p in FILES if "dynamo_tpu_torch" in p.parts}
    assert set(MULTIMODAL) <= scanned
    for rel in MULTIMODAL:
        found = _imports(ast.parse(
            (ROOT / "dynamo_tpu_torch" / rel).read_text()))
        assert not {n for n, _ in found} & FORBIDDEN, rel
        if rel in ("multimodal/__init__.py", "multimodal/processor.py",
                   "multimodal/wire.py"):
            assert "torch" not in {n for n, _ in found}, rel


def test_scan_covers_the_kserve_and_native_modules():
    """The KServe gRPC modules and the native loader are scanned like every
    other: none imports ``grpc``, ``google`` (protobuf), ``pyarrow``,
    ``xxhash`` nor JAX, and none imports torch (the frontend loads them)."""
    scanned = {p.relative_to(ROOT / "dynamo_tpu_torch").as_posix()
               for p in FILES if "dynamo_tpu_torch" in p.parts}
    assert set(KSERVE_AND_NATIVE) <= scanned
    for rel in KSERVE_AND_NATIVE:
        found = {n for n, _ in _imports(ast.parse(
            (ROOT / "dynamo_tpu_torch" / rel).read_text()))}
        assert not found & FORBIDDEN, (rel, found & FORBIDDEN)
        assert "torch" not in found, rel


def test_scan_covers_the_tasks_checkpoint_and_analysis_modules():
    """The task tracker, the checkpoint twin and the port's dynalint are
    scanned like every other module: none imports ``orbax``,
    ``safetensors`` nor JAX; the tracker (the frontend loads ``runtime``)
    and the linter (plain ``ast``) import no torch at all."""
    scanned = {p.relative_to(ROOT / "dynamo_tpu_torch").as_posix()
               for p in FILES if "dynamo_tpu_torch" in p.parts}
    assert set(TASKS_CHECKPOINT_LINT) <= scanned
    for rel in TASKS_CHECKPOINT_LINT:
        found = {n for n, _ in _imports(ast.parse(
            (ROOT / "dynamo_tpu_torch" / rel).read_text()))}
        assert not found & FORBIDDEN, (rel, found & FORBIDDEN)
        if rel != "engine/weights.py":
            assert "torch" not in found, rel


def test_scan_covers_the_deploy_modules():
    """The scale watcher and the graph controller are scanned like every
    other module: none imports ``msgpack``, ``aiohttp``, JAX or the JAX
    package, and none imports torch."""
    scanned = {p.relative_to(ROOT / "dynamo_tpu_torch").as_posix()
               for p in FILES if "dynamo_tpu_torch" in p.parts}
    assert set(DEPLOY) <= scanned
    for rel in DEPLOY:
        found = {n for n, _ in _imports(ast.parse(
            (ROOT / "dynamo_tpu_torch" / rel).read_text()))}
        assert not found & FORBIDDEN, (rel, found & FORBIDDEN)
        assert "torch" not in found, rel


def test_watcher_and_controller_load_nothing_of_jax_or_torch():
    """Imported and run to their parsers in a fresh interpreter, the scale
    watcher and the graph controller leave neither ``torch`` nor anything
    of ``dynamo_tpu``, ``msgpack`` or ``aiohttp`` in ``sys.modules``."""
    code = (
        "import sys\n"
        "from dynamo_tpu_torch.deploy import controller, scale_watcher\n"
        "scale_watcher.parse_args(['--', 'sleep', '1'])\n"
        "controller.GraphController(controller.KubernetesAPI(\n"
        "    controller.KubeConfig(base_url='http://127.0.0.1:1',\n"
        "                          namespace='ns')), image='i')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('torch', 'dynamo_tpu', 'msgpack', 'aiohttp', 'jax'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_host_sources_include_only_the_standard_library():
    """``csrc/*.cpp`` build with the host compiler alone: every
    ``#include`` is a C++ standard header or a file of ``csrc/`` (no
    pyarrow's vendored ``xxhash.h``, which the JAX library needs)."""
    csrc = ROOT / "dynamo_tpu_torch" / "csrc"
    sources = sorted(csrc.glob("*.cpp"))
    assert [p.name for p in sources] == ["dynamo_native.cpp"]
    for path in sources:
        for line in path.read_text().splitlines():
            m = re.match(r'\s*#\s*include\s*([<"])([^>"]+)[>"]', line)
            if not m:
                continue
            if m.group(1) == "<":
                assert m.group(2) in CXX_STD_HEADERS, (path.name, line)
            else:
                assert (csrc / m.group(2)).exists(), (path.name, line)


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
            + f"bad = {sorted(LOADED_FORBIDDEN)!r}\n"
            "print(sorted(m for m in bad if m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("knob", [
    dict(mesh_shape=(1, 3, 2), sp_prefill_threshold=64),
    dict(mesh_shape=(3, 1), sp_prefill_threshold=64),
], ids=["mesh_shape_3d", "sp_on_dp3"])
def test_unserved_paths_are_refused(knob):
    """An sp prefill over a seq column (dp * fsdp ranks) that is not a
    power of two is refused, on a 3-D mesh as on a 2-D one (item 6.8);
    (dp, tp) and (dp, fsdp, tp) meshes, sequence-parallel prefill and
    pipeline stages are served (below)."""
    eng = EngineConfig(num_blocks=16, **knob)
    with pytest.raises(NotImplementedError, match="item 6.8"):
        check_supported(eng)
    with pytest.raises(NotImplementedError):
        InferenceEngine(ModelConfig.tiny(), eng, device="cpu")


@pytest.mark.parametrize("knob", [
    dict(mesh_shape=(2, 1)), dict(mesh_shape=(2, 2)),
    dict(mesh_shape=(2, 1), sp_prefill_threshold=1024),
    dict(pp_stages=2), dict(mesh_shape=(1, 2, 2)),
    dict(mesh_shape=(2, 2, 1), sp_prefill_threshold=64),
], ids=["mesh_shape_dp", "mesh_shape_dp_tp", "sp_prefill_threshold",
        "pp_stages", "mesh_shape_fsdp", "sp_on_dp_fsdp"])
def test_data_and_sequence_parallel_paths_are_served(knob):
    """A data-parallel mesh, a 3-D (dp, fsdp, tp) mesh,
    ``sp_prefill_threshold`` and pipeline stages pass the check; the
    engine needs a world of every rank of the mesh (or pp ranks)
    (tests/test_torch_{sequence_parallel,fsdp,pp_serving}.py build them),
    and without one construction says so."""
    eng = EngineConfig(num_blocks=16, **knob)
    check_supported(eng)
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        InferenceEngine(ModelConfig.tiny(), eng, device="cpu")


def test_sp_threshold_on_one_rank_keeps_the_chunked_path():
    """On a one-rank mesh the threshold turns nothing on (the JAX engine
    builds its sp prefill only for a mesh of more than one device)."""
    engine = InferenceEngine(ModelConfig.tiny(), EngineConfig(
        num_blocks=16, max_model_len=64, sp_prefill_threshold=8),
        device="cpu")
    assert engine._sp_prefill_fn is None
    assert not engine.scheduler.sp_enabled


def test_tensor_parallel_mesh_is_served():
    """``mesh_shape=(1, 2)`` passes the check; building its engine needs a
    world of two ranks (tests/test_torch_tensor_parallel.py builds them),
    and without one construction says so."""
    eng = EngineConfig(num_blocks=16, mesh_shape=(1, 2))
    check_supported(eng)
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        InferenceEngine(ModelConfig.tiny(), eng, device="cpu")
    assert ModelConfig.llama3_70b().num_layers == 80


def _single_rank_calls(engine):
    """Each single-rank path on ``engine``, served: what it returns."""
    import numpy as np

    from dynamo_tpu_torch.engine.engine import EngineCore, Request

    cfg, eng = engine.model_config, engine.config
    payload = {key: torch.zeros((cfg.num_layers, 1, cfg.num_kv_heads,
                                 eng.block_size, cfg.head_dim_))
               for key in ("k", "v")}

    async def mm():
        try:
            return [o.token_id async for o in EngineCore.submit(
                engine, Request(
                    request_id="m", token_ids=[1, 2, 3], max_tokens=2,
                    mm_positions=[0],
                    mm_embeddings=np.ones((1, cfg.hidden_size), np.float32),
                    mm_hash_token_ids=[0x80000001, 2, 3]))]
        finally:
            await engine.stop()

    return {
        "extract": lambda: asyncio.run(engine.extract_kv_blocks([1])),
        "inject": lambda: asyncio.run(engine.inject_kv_blocks([1], payload)),
        "kvbm": lambda: engine.attach_kvbm(),
        "evacuation": engine.evacuable_seats,
        "embed": lambda: asyncio.run(engine.embed([[1, 2]])),
        "mm": lambda: asyncio.run(mm()),
    }


# the plan each path emits, then the collectives it leads into (a KV
# extract joins K and V on the leader over the tp row, an inject
# broadcasts both, an mm
# chunk its embeddings; embed's sums ride the tp row's all_reduce)
_PATH_EVENTS = {
    "extract": [("plan", "kx"), ("gather", "kv_gather"),
                ("gather", "kv_gather")],
    "inject": [("plan", "ki"), ("broadcast", "kv_deliver"),
               ("broadcast", "kv_deliver")],
    "kvbm": [], "evacuation": [],
    "embed": [("plan", "emb")],
    # (of an mm request's plans, its chunk's: the decode plans follow)
    "mm": [("plan", "mrp"), ("broadcast", "mm_deliver")],
}


def _served_on_a_faked_rank(monkeypatch, what, tp):
    """A one-rank engine marked as a rank of a world of two (``tp`` of
    them on its tp row), with a recording plan sink: the path is served,
    each plan is emitted before the collective it leads into, and no
    collective reaches a peer (the engine's groups hold one rank)."""
    from dynamo_tpu_torch.parallel import comm

    engine = InferenceEngine(ModelConfig.tiny(), EngineConfig(
        num_blocks=16, max_model_len=64, decode_buckets=(4,),
        max_num_seqs=4), device="cpu")
    engine.world = 2               # what a rank of a (1, 2) / (2, 1) world
    engine.tp = tp                 # holds
    events = []
    engine.step_sink = lambda kind, arrays: events.append(("plan", kind))
    for name in ("gather", "broadcast"):
        orig = getattr(comm, name)

        def tap(*a, _orig=orig, _name=name, **kw):
            events.append((_name, kw.get("op")))
            return _orig(*a, **kw)
        monkeypatch.setattr(comm, name, tap)
    comm.reset_stats()
    out = _single_rank_calls(engine)[what]()
    stats = dict(comm.STATS)
    if what == "mm":
        events = [e for e in events if e[1] in ("mrp", "mm_deliver")]
    assert events == _PATH_EVENTS[what]
    assert not any(v for k, v in stats.items() if k.endswith("_calls"))
    return engine, out


def _check_served(engine, what, out):
    cfg = engine.model_config
    if what == "extract":
        assert out["k"].shape == (cfg.num_layers, 1, cfg.num_kv_heads, 16,
                                  cfg.head_dim_)
    elif what == "inject":
        assert out is None and not engine.cache["k"][0][1].any()
    elif what == "kvbm":
        assert out is engine.kvbm is not None
    elif what == "evacuation":
        assert out == []
    elif what == "embed":
        assert len(out) == 1 and len(out[0]) == cfg.hidden_size
    else:
        assert len(out) == 2 and engine.num_mm_prefills == 1


@pytest.mark.parametrize("what", [
    "extract", "inject", "kvbm", "evacuation", "embed", "mm",
])
def test_tensor_parallel_engine_refuses_the_single_rank_paths(
        what, monkeypatch):
    """Under tp > 1 the engine serves KV movement, the KVBM tiers,
    preemption evacuation, embeddings and multimodal prefill (nothing of
    them is refused any more, as in the JAX engine on a one-host mesh):
    each path emits its plan (``kx``, ``ki``, ``emb``, ``mrp``) before
    the collective it leads into. tests/test_torch_mesh_paths.py runs
    them on a world of ranks against the JAX engine."""
    engine, out = _served_on_a_faked_rank(monkeypatch, what, tp=2)
    _check_served(engine, what, out)


@pytest.mark.parametrize("what", [
    "extract", "inject", "kvbm", "evacuation", "embed", "mm",
])
def test_data_parallel_engine_refuses_the_single_rank_paths(
        what, monkeypatch):
    """A rank of a (2, 1) world has ``tp == 1``: the paths key on the
    mesh's ranks, so it serves them by the same plans, every dp row taking
    the same inject."""
    engine, out = _served_on_a_faked_rank(monkeypatch, what, tp=1)
    assert engine.tp == 1
    _check_served(engine, what, out)


def test_multimodal_prefill_plan_is_refused_by_name():
    """``mrp`` (multimodal prefill on a multi-rank engine) is served: a
    follower replays it as an mm packed prefill whose embeddings arrive
    by delivery (a one-rank world delivers nothing); an unknown kind is
    an error, and an ``rsp`` plan needs the sp prefill."""
    import numpy as np

    from dynamo_tpu_torch.engine import model as model_lib
    from dynamo_tpu_torch.parallel.multihost import replay_plan

    engine = InferenceEngine(ModelConfig.tiny(), EngineConfig(
        num_blocks=16, max_model_len=64), device="cpu")
    T, W = 16, 2
    M = T + W + model_lib.PP_SCALARS
    pint = np.zeros((1, M + T), np.int32)
    pint[0, :4] = [5, 6, 7, 8]
    pint[0, T:T + 1] = 1
    pint[0, T + W:T + W + 4] = (4, 0, engine.config.max_num_seqs, 0)
    pint[0, M] = 1
    replay_plan(engine, "mrp", {"pint": pint, "tw": np.array([T, W]),
                                "st": np.array([0])})
    assert engine.num_replayed == {"mrp": 1}
    assert engine.num_mm_prefills == 1
    assert engine.cache["k"][0][1].any()
    with pytest.raises(ValueError, match="unknown plan kind"):
        replay_plan(engine, "zz", {})
    with pytest.raises(RuntimeError, match="sp_prefill_threshold"):
        replay_plan(engine, "rsp", {"tw": [8, 2]})


@pytest.mark.parametrize("mesh", ["1,2,2", "2,2,1"])
def test_run_refuses_mesh_by_name(mesh, tmp_path):
    """``--mesh D,N`` is served (tests/test_torch_mesh_launch.py runs
    it); three numbers raise the JAX launcher's ``ValueError``, as its
    ``dp, tp = ...split(",")`` does."""
    batch = tmp_path / "b.jsonl"
    batch.write_text('{"token_ids": [1, 2], "max_tokens": 2}\n')
    with pytest.raises(ValueError, match="too many values to unpack"):
        trun.main([f"in=batch:{batch}", "out=engine", "--model", "tiny",
                   "--device", "cpu", "--mesh", mesh])


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
    ["--mesh", "2,1", "--disagg-mode", "prefill"], ["--mesh", "1,2,2"],
    ["--mesh", "1,2", "--disagg-mode", "prefill"],
    ["--mesh", "1,2", "--kvbm-host-blocks", "64"],
    ["--mesh", "1,2", "--mm-encoder"],
    ["--mesh", "2,1", "--kvbm-host-blocks", "64"],
    ["--mesh", "2,1", "--mm-encoder"],
    ["--pp", "2", "--disagg-mode", "prefill"],
    ["--pp", "2", "--kvbm-host-blocks", "64"],
    ["--pp", "2", "--mm-encoder"],
], ids=lambda f: "+".join(
    a.lstrip("-") if i % 2 == 0 else f"={a}" for i, a in enumerate(f)
).replace("+=", "="))
def test_worker_refuses_unserved_flags(flags):
    """Still refused: a 3-number ``--mesh`` (the JAX worker's
    ``ValueError``), and on a pipeline-parallel worker the
    disaggregated, KVBM and multimodal paths (the JAX pp engine refuses
    each). On a single-host ``--mesh`` worker they are served (its
    followers join by plans); spread over two hosts, disaggregation and
    the KVBM tiers are refused in the JAX worker's words, and multimodal
    EPD is served."""
    from dynamo_tpu_torch import worker

    args = worker.parse_args(["--device", "cpu", *flags])
    if "1,2,2" in flags:
        # the JAX worker's dp, tp = ...split(",") (a 3-D mesh is served
        # through EngineConfig, as in JAX)
        with pytest.raises(ValueError, match="too many values to unpack"):
            asyncio.run(worker.run_worker(args))
        return
    if args.pp > 1:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            asyncio.run(worker.run_worker(args))
        return
    worker.check_supported(args)
    spread = worker.parse_args(["--device", "cpu", *flags, "--num-hosts",
                                "2", "--coordinator", "h0:1234"])
    if spread.mm_encoder:
        worker.check_supported(spread)
    else:
        with pytest.raises(SystemExit, match="aggregated path only"):
            worker.check_supported(spread)


@pytest.mark.parametrize("flags", [
    ["--mesh", "1,2"], ["--coordinator", "h0:1234", "--mesh", "1,2"],
    ["--num-hosts", "2", "--mesh", "1,2"], ["--model", "70b"],
    ["--pp", "2"],
], ids=lambda f: f[0].lstrip("-") + f"={f[1]}")
def test_worker_serves_tensor_parallel_flags(flags):
    """``--mesh 1,N``, ``--coordinator``, ``--num-hosts``, ``--model
    70b`` and the pipeline's ``--pp S`` are served
    (tests/test_torch_multihost.py and tests/test_torch_pp_serving.py run
    the worlds): a world of tp (or pp) ranks."""
    from dynamo_tpu_torch import worker
    from dynamo_tpu_torch.parallel.multihost import MultihostConfig

    args = worker.parse_args(["--device", "cpu", *flags])
    worker.check_supported(args)
    assert worker.MODEL_PRESETS[args.model]() is not None
    ranks = worker.mesh_shape(args)[1] * args.pp
    mh = MultihostConfig(coordinator=args.coordinator or "127.0.0.1:1",
                         num_hosts=args.num_hosts, world_size=ranks)
    mh.check()
    assert mh.per_host == ranks // args.num_hosts


@pytest.mark.parametrize("flags", [
    ["--mesh", "2,1"], ["--mesh", "2,2"],
    ["--num-hosts", "2", "--mesh", "2,2"],
], ids=lambda f: "+".join(a.lstrip("-") for a in f))
def test_worker_serves_data_parallel_meshes(flags):
    """``--mesh D,N`` with D > 1 is served: a world of D*N ranks, split
    over the hosts (tests/test_torch_multihost.py runs a (2, 1) one)."""
    from dynamo_tpu_torch import worker
    from dynamo_tpu_torch.parallel.multihost import MultihostConfig

    args = worker.parse_args(["--device", "cpu", *flags])
    worker.check_supported(args)
    dp, tp = worker.mesh_shape(args)
    mh = MultihostConfig(coordinator="127.0.0.1:1",
                         num_hosts=args.num_hosts, world_size=dp * tp)
    mh.check()
    assert mh.per_host * args.num_hosts == dp * tp


@pytest.mark.parametrize("flags", [["--mesh", "1,2"], ["--model", "70b"],
                                   ["--mesh", "2,1"]],
                         ids=["mesh", "model", "mesh_dp"])
def test_profiler_still_refuses_tensor_parallel(flags):
    """The profiler serves ``--mesh D,N`` (tests/test_torch_mesh_launch.py
    profiles one): the check passes it. ``--model 70b`` stays refused:
    141 GB of bf16 weights fit no 80 GB card, whatever the mesh."""
    from dynamo_tpu_torch.planner import profiler

    args = profiler.parse_args(["--device", "cpu", *flags])
    if args.model != "70b":
        profiler.check_supported(args)
        assert profiler.parse_mesh_flag(args.mesh) == tuple(
            int(x) for x in flags[1].split(","))
        return
    with pytest.raises(NotImplementedError, match="141 GB"):
        profiler.check_supported(args)


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


def test_worker_serves_attention_impl_auto():
    """``--attention-impl auto`` is served (autotune): the worker passes it
    to the engine, which probes on a card and resolves to einsum on the
    CPU, as the JAX worker does off a TPU."""
    from dynamo_tpu_torch import worker

    args = worker.parse_args(["--device", "cpu", "--attention-impl", "auto"])
    worker.check_supported(args)
    assert worker.ATTENTION_IMPLS[args.attention_impl] == "auto"
    engine = InferenceEngine(ModelConfig.tiny(), EngineConfig(
        num_blocks=64, max_model_len=256, attention_impl="auto"),
        device="cpu")
    assert engine.attention_impl_choice["impl"] == "einsum"
    assert engine.config.attention_impl_decode == "einsum"


def test_worker_maps_the_jax_attention_names():
    from dynamo_tpu_torch import worker

    for name, impl in (("pallas", "kernel"), ("einsum", "einsum")):
        args = worker.parse_args(["--attention-impl", name])
        worker.check_supported(args)
        assert worker.ATTENTION_IMPLS[args.attention_impl] == impl


@pytest.mark.parametrize("flags,port", [(["--grpc-port", "9000"], 9000)],
                         ids=["grpc-port"])
def test_frontend_serves_the_grpc_port(flags, port):
    """``--grpc-port`` is served (queue A item 7d): the flag passes
    ``check_supported``; ``--grpc-port 0`` picks a free port and leaving
    the flag out serves no gRPC."""
    from dynamo_tpu_torch.frontend import __main__ as frontend

    args = frontend.parse_args(flags)
    frontend.check_supported(args)
    assert args.grpc_port == port
    assert frontend.parse_args(["--grpc-port", "0"]).grpc_port == 0
    assert frontend.parse_args([]).grpc_port is None


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


@pytest.mark.parametrize("flags", [
    ["--mm-encoder"], ["--mm-encode-component", "encoder"],
    ["--mm-encoder", "--mm-image-size", "224", "--mm-patch-size", "14"],
], ids=["mm-encoder", "mm-encode-component", "mm-encoder-224"])
def test_worker_serves_multimodal_flags(flags):
    """``--mm-*`` is served (queue A item 7c): the flags pass
    ``check_supported`` and keep the JAX package's defaults."""
    from dynamo_tpu_torch import worker

    args = worker.parse_args(["--device", "cpu", *flags])
    worker.check_supported(args)
    assert args.mm_image_size in (32, 224)
    assert args.mm_patch_size in (8, 14)


def test_routed_pipeline_serves_a_multimodal_card():
    """A card that advertises multimodal serving gets the multimodal
    preprocessor in front of the text one."""
    from dynamo_tpu_torch.llm.discovery import ModelDeploymentCard
    from dynamo_tpu_torch.llm.entrypoint import build_routed_pipeline
    from dynamo_tpu_torch.multimodal.processor import (
        MultimodalPreprocessor, MultimodalProcessor,
    )

    card = ModelDeploymentCard(name="m", tokenizer_json=TOKENIZER_STUB,
                               runtime_config={"multimodal": {
                                   "tokens_per_image": 16}})
    tok = card.load_tokenizer()
    pipe = build_routed_pipeline(
        card, client=None, tokenizer=tok,
        mm_processor=MultimodalProcessor(tok, 16, encode_client=object()))
    pre = pipe._operators[0]
    assert isinstance(pre, MultimodalPreprocessor)
    assert pre.inner.tokenizer is tok


def test_frontend_multimodal_and_embeddings_pieces_never_load_torch():
    """What the frontend builds for a multimodal and embeddings card (the
    multimodal processor and preprocessor, the wire arrays, the embeddings
    pipeline) loads no ``torch``; importing the encoder module loads
    it."""
    code = (
        "import sys\n"
        "import dynamo_tpu_torch.multimodal as mm\n"
        "from dynamo_tpu_torch.multimodal.processor import "
        "MultimodalProcessor, content_token\n"
        "from dynamo_tpu_torch.llm.discovery import ModelDeploymentCard\n"
        "from dynamo_tpu_torch.llm.entrypoint import (\n"
        "    EmbeddingsPipeline, build_routed_pipeline)\n"
        "import numpy as np\n"
        f"card = ModelDeploymentCard(name='m', tokenizer_json={TOKENIZER_STUB!r},\n"
        "    runtime_config={'multimodal': {'tokens_per_image': 4}})\n"
        "tok = card.load_tokenizer()\n"
        "build_routed_pipeline(card, client=None, tokenizer=tok,\n"
        "    mm_processor=MultimodalProcessor(tok, 4, encode_client=1))\n"
        "EmbeddingsPipeline(card, client=None, tokenizer=tok)\n"
        "mm.array_from_wire(mm.array_to_wire(np.zeros(3)))\n"
        "content_token(np.zeros((2, 2, 3)), 0)\n"
        "before = 'torch' in sys.modules\n"
        "import dynamo_tpu_torch.multimodal.encoder\n"
        "print(before, 'torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False True"


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
