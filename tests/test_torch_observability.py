"""The port's flight recorder, report and trace assembler against the JAX
package's: the FLOPs model and parameter counts are equal, the card's peak
table matches its data sheet, one sequence of step records gives both
packages' ``StepStats`` the same snapshot, both ``report``s render and
both ``assemble``s join the same JSONL alike, and a port engine's
``generate`` records the JAX engine's three stage spans with its attribute
keys. CPU."""

import asyncio
import dataclasses
import json

import numpy as np
import pytest

from dynamo_tpu import tracing as jtracing
from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import InferenceEngine as JaxEngine
from dynamo_tpu.observability import flops as jflops
from dynamo_tpu.observability import report as jreport
from dynamo_tpu.observability import stepstats as jstepstats
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu.tracing import assemble as jassemble
from dynamo_tpu_torch import tracing
from dynamo_tpu_torch.engine import model as model_lib
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import InferenceEngine
from dynamo_tpu_torch.observability import flops, report, stepstats
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.tracing import assemble

CONFIGS = ("tiny", "llama3_1b", "tiny_tied")


def _configs(name):
    if name == "tiny_tied":
        return (dataclasses.replace(ModelConfig.tiny(),
                                    tie_word_embeddings=True),
                dataclasses.replace(JaxModelConfig.tiny(),
                                    tie_word_embeddings=True))
    return getattr(ModelConfig, name)(), getattr(JaxModelConfig, name)()


@pytest.mark.parametrize("name", CONFIGS)
def test_flops_model_equals_jax(name):
    cfg, jcfg = _configs(name)
    assert flops.param_count(cfg) == jflops.param_count(jcfg)
    assert flops.active_param_count(cfg) == jflops.active_param_count(jcfg)
    fm, jfm = flops.FlopsModel(cfg), jflops.FlopsModel(jcfg)
    for tokens, ctx in ((1, 1), (16, 9000), (512, 131328), (7, 0)):
        assert fm.step_flops(tokens, ctx) == jfm.step_flops(tokens, ctx)
    for isl, osl in ((512, 64), (1, 1), (4000, 300)):
        assert fm.sequence_flops(isl, osl) == jfm.sequence_flops(isl, osl)
        assert (fm.sequence_context_sum(isl, osl)
                == jfm.sequence_context_sum(isl, osl))


@pytest.mark.parametrize("name", ("tiny", "tiny_tied"))
def test_param_count_matches_init_params(name):
    """The analytic count is exact against the port's real parameter
    tree."""
    import torch

    cfg, _ = _configs(name)
    params = model_lib.init_params(torch.Generator().manual_seed(0), cfg)
    leaves = [params["embed"], params["final_norm"],
              *params["layers"].values()]
    if "lm_head" in params:
        leaves.append(params["lm_head"])
    assert flops.param_count(cfg) == sum(t.numel() for t in leaves)


def test_peak_flops_table():
    sxm, pcie = "NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe"
    assert flops.peak_flops(sxm, "cuda") == 989.4e12
    assert flops.peak_flops(sxm, "cuda", "bfloat16") == 989.4e12
    assert flops.peak_flops(sxm, "cuda", "int8") == 1978.9e12
    assert flops.peak_flops(sxm, "cuda", "fp8") == 1978.9e12
    assert flops.peak_flops(pcie, "cuda") == 756e12
    assert flops.peak_flops(pcie, "cuda", "int8") == 1513e12
    assert flops.peak_flops(pcie, "cuda", "fp8") == 1513e12
    # unknown CUDA names take the SXM numbers; other platforms the CPU
    # nominal, as the JAX table does off its TPUs
    assert flops.peak_flops("NVIDIA X1", "cuda") == flops.DEFAULT_PEAK
    assert flops.peak_flops("", "cpu") == flops.CPU_PEAK == jflops.CPU_PEAK
    assert flops.peak_flops(sxm, "cpu", "int8") == flops.CPU_PEAK


def _records(mod):
    R = mod.StepRecord
    return [
        R(kind=mod.PREFILL, t_dispatch=100.0, t_land=100.1, bucket=32,
          rows=1, live_rows=1, padded_tokens=32, real_tokens=20,
          goodput_tokens=20, context_sum=210),
        R(kind=mod.DECODE, t_dispatch=100.1, t_land=100.3, bucket=8,
          rows=8, live_rows=5, padded_tokens=32, real_tokens=20,
          goodput_tokens=17, context_sum=900),
        R(kind=mod.PREFILL, t_dispatch=100.3, t_land=100.35, bucket=16,
          rows=1, live_rows=1, padded_tokens=16, real_tokens=9,
          goodput_tokens=9, context_sum=9 * 20 + 45),
        R(kind=mod.DECODE, t_dispatch=100.35, t_land=104.0, bucket=8,
          rows=8, live_rows=8, padded_tokens=8, real_tokens=8,
          goodput_tokens=8, context_sum=300),
    ]


def test_stepstats_snapshot_equals_jax(tmp_path):
    """One record sequence, one clock: both recorders give the same
    snapshots, occupancy and JSONL."""
    snaps = {}
    for name, mod, fmod, cfg in (
            ("port", stepstats, flops, ModelConfig.llama3_1b()),
            ("jax", jstepstats, jflops, JaxModelConfig.llama3_1b())):
        clock = {"t": 100.0}
        path = tmp_path / f"{name}.jsonl"
        stats = mod.StepStats(fmod.FlopsModel(cfg), peak_flops=989.4e12,
                              window_s=3.0, jsonl_path=str(path),
                              clock=lambda: clock["t"])
        seen = []
        for rec in _records(mod):
            stats.commit(rec)
            clock["t"] = rec.t_land + 0.5
            seen.append(stats.snapshot(max_age_s=0.0))
        seen.append(stats.bucket_occupancy())
        stats.mark_warmup_done()
        seen.append(stats.snapshot(max_age_s=0.0))
        stats.close()
        snaps[name] = (seen, path.read_text())
    assert snaps["port"] == snaps["jax"]
    assert snaps["port"][0][-3]["mfu_decode"] > 0.0


def _stepstats_lines():
    rng = np.random.default_rng(7)
    lines, t = [], 0.0
    for i in range(12):
        kind = ("prefill", "decode")[i % 2]
        real = int(rng.integers(1, 64))
        lines.append({
            "kind": kind, "t_dispatch": t, "t_land": t + 0.01 * (i + 1),
            "padded_tokens": 64, "real_tokens": real,
            "goodput_tokens": real - (i % 3),
            "flops_dispatched": 64e9, "flops_real": real * 1e9,
            "flops_goodput": (real - (i % 3)) * 1e9})
        t += 0.02
    return lines


def test_report_equals_jax(tmp_path, capsys):
    records = _stepstats_lines()
    assert report.render_report(records) == jreport.render_report(records)
    assert report.render_report([]) == jreport.render_report([])
    path = tmp_path / "steps.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in records))
    assert report.main([str(path)]) == 0
    ours = capsys.readouterr().out
    assert jreport.main([str(path)]) == 0
    assert ours == capsys.readouterr().out
    assert ours.startswith("engine flight recorder")


def _span_lines():
    rng = np.random.default_rng(3)
    names = ("frontend.request", "router.select", "worker.queue",
             "engine.prefill", "engine.decode")
    spans = []
    for t in range(3):
        tid = f"{t:032x}"
        root = f"{t:016x}"
        t0 = 1.7e9 + t
        for i, name in enumerate(names):
            sid = root if i == 0 else f"{t:08x}{i:08x}"
            spans.append({
                "trace_id": tid, "span_id": sid,
                "parent_span_id": None if i == 0 else root,
                "name": name, "start_unix": t0 + 0.01 * i,
                "duration_s": float(rng.uniform(0.001, 0.2)),
                "status": "ok" if i != 3 or t != 1 else "error",
                "attrs": {"i": i} if i % 2 else {}})
    # the slow-dump path can export a span twice
    return spans + [spans[0]]


def test_assemble_equals_jax(tmp_path, capsys):
    spans = _span_lines()
    path = tmp_path / "spans.jsonl"
    path.write_text("".join(json.dumps(s) + "\n" for s in spans))
    loaded = assemble.load_spans([str(path)])
    assert loaded == jassemble.load_spans([str(path)])
    assert len(loaded) == len(spans) - 1
    groups = assemble.group_traces(loaded)
    assert groups == jassemble.group_traces(loaded)
    for tid, ss in groups.items():
        ours = assemble.assemble_trace(ss)
        assert ours == jassemble.assemble_trace(ss)
        assert assemble.render_trace(ours) == jassemble.render_trace(ours)
    assert (assemble.stage_percentiles(loaded)
            == jassemble.stage_percentiles(loaded))
    assert (assemble.render_summary(assemble.stage_percentiles(loaded))
            == jassemble.render_summary(
                jassemble.stage_percentiles(loaded)))
    for argv in ([str(path)], [str(path), "--json"],
                 [str(path), "--summary"], [str(path), "--trace-id",
                                            f"{1:032x}"]):
        assert assemble.main(argv) == 0
        ours = capsys.readouterr().out
        assert jassemble.main(argv) == 0
        assert ours == capsys.readouterr().out, argv
    assert assemble.main([str(path), "--trace-id", "f" * 32]) == 1


ENG = dict(block_size=4, num_blocks=64, max_num_seqs=4,
           max_num_batched_tokens=64, max_model_len=128,
           decode_buckets=(8,), prefill_buckets=(16,))


def _stage_spans(engine, tracing_mod, ctx):
    tracer = tracing_mod.reset()

    async def run():
        try:
            outs = [o async for o in engine.generate(
                {"token_ids": [3, 1, 4, 1, 5], "max_tokens": 5}, ctx)]
        finally:
            await engine.stop()
        return outs

    outs = asyncio.run(run())
    spans = tracer.get_trace(ctx.trace.trace_id)
    tracing_mod.reset()
    return outs, {s.name: sorted(s.attrs) for s in spans}


def test_generate_records_the_jax_stage_spans():
    """worker.queue, engine.prefill and engine.decode, as the JAX engine
    records them, less the flight recorder's attributes the JAX engine
    puts on its decode span (``mfu``, ``goodput_tok_s``,
    ``padding_waste_ratio``): the port's recorder gauges carry them."""
    engine = InferenceEngine(ModelConfig.tiny(), EngineConfig(**ENG),
                             device="cpu")
    outs, ours = _stage_spans(engine, tracing, Context())
    # the recorder's 10-s window, read before the JAX engine's build and
    # run can outlast it
    snap = engine.obs_snapshot()
    jengine = JaxEngine(JaxModelConfig.tiny(), JaxEngineConfig(**ENG))
    _, want = _stage_spans(jengine, jtracing, JaxContext())
    assert len(outs) == 5 and outs[-1]["finished"]
    assert set(ours) == set(want) == {"worker.queue", "engine.prefill",
                                      "engine.decode"}
    recorder = ("goodput_tok_s", "mfu", "padding_waste_ratio")
    assert set(recorder) <= set(want["engine.decode"])
    for name in want:
        assert ours[name] == [a for a in want[name] if a not in recorder]
    assert ours["engine.decode"] == ["num_tokens"]
    assert snap["goodput_tok_s"] > 0.0 and snap["total_steps"] > 0
    for key in ("stalls_total", "stall_dead", "pressure_level",
                "pressure_peak", "pressure_spills_total",
                "pressure_shed_total", "stall_quarantined_shapes"):
        assert key in snap
    engine.mark_obs_warmup_done()
    assert engine.obs_snapshot()["total_steps"] == 0


def test_recorder_off_and_stepstats_capture(monkeypatch, tmp_path):
    """``DYNTPU_OBS_ENABLED=0`` turns the recorder off; with
    ``DYNTPU_OBS_STEPSTATS_PATH`` every landed record is one JSON line
    that the report renders."""
    monkeypatch.setenv("DYNTPU_OBS_ENABLED", "0")
    off = InferenceEngine(ModelConfig.tiny(), EngineConfig(**ENG),
                          device="cpu")
    assert off.obs is None and off.obs_snapshot() == {}
    monkeypatch.setenv("DYNTPU_OBS_ENABLED", "1")
    path = tmp_path / "steps.jsonl"
    monkeypatch.setenv("DYNTPU_OBS_STEPSTATS_PATH", str(path))
    engine = InferenceEngine(ModelConfig.tiny(), EngineConfig(**ENG),
                             device="cpu")
    outs, _ = _stage_spans(engine, tracing, Context())
    with open(path) as fh:
        records = report.load_records(fh)
    kinds = [r["kind"] for r in records]
    assert kinds[0] == "prefill" and "decode" in kinds
    assert sum(r["goodput_tokens"] for r in records
               if r["kind"] == "decode") == len(outs) - 1
    assert all(r["t_land"] >= r["t_dispatch"] > 0 for r in records)
    assert "decode" in report.render_report(records)
