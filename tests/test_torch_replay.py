"""The port's trace replay (``dynamo_tpu_torch/replay/``) held against the
JAX package's on the CPU:

* ``generate_trace`` and ``generate_gauntlet_trace`` dump byte-identical
  JSONL for seeds 0–3 (every CLI scenario and a storm config), and the
  port's ``datagen`` copies equal ``benchmarks.datagen``;
* the scoreboard's check functions, tier table, digest, recovery windows
  and the assembled scoreboard equal JAX's on the same synthetic outcomes
  (tolerance: none);
* ``run_cluster_replay`` on the ``smoke`` scenario: the port's engines,
  holding the JAX tiny tree (``params_from_numpy``), give the JAX run's
  ``outcome_digest``, and every cross-check of the port's scoreboard
  passes. The test swaps ``dynamo_tpu_torch.engine.engine.InferenceEngine``
  for one that loads that tree on the CPU; the driver is unchanged.

Wall-clock percentiles are not asserted.
"""

import asyncio
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from benchmarks import datagen as bdg
from dynamo_tpu.engine import config as jcfg
from dynamo_tpu.engine import model as jm
from dynamo_tpu.replay import __main__ as jmain
from dynamo_tpu.replay import driver as jdrv
from dynamo_tpu.replay import scoreboard as jsb
from dynamo_tpu.replay import trace as jtr
from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.replay import __main__ as tmain
from dynamo_tpu_torch.replay import datagen as tdg
from dynamo_tpu_torch.replay import driver as tdrv
from dynamo_tpu_torch.replay import scoreboard as tsb
from dynamo_tpu_torch.replay import trace as ttr

SEEDS = [0, 1, 2, 3]


def _storm_cfg(mod, seed):
    return mod.TraceConfig(
        seed=seed, num_requests=70, duration_s=5.0, outlier_ratio=0.1,
        abort_storm_start_frac=0.2, abort_storm_end_frac=0.5,
        reconnect_storm_start_frac=0.6, reconnect_storm_end_frac=0.9,
        preempt_at_frac=0.4, kill_at_frac=0.5, store_flap_at_frac=0.8,
    )


def _card_cfg(mod, seed):
    """The card's traffic: the bursty scenario at ISL 512 / OSL 64."""
    return dataclasses.replace(
        (jmain if mod is jtr else tmain).scenario_config("bursty", seed),
        isl=512, osl=64, vocab_size=32000, prefix_ratio=0.5)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", ["smoke", "bursty", "flagship", "storm",
                                  "card", "gauntlet"])
def test_trace_jsonl_byte_identical(tmp_path, kind, seed):
    def make(mod, main):
        if kind == "gauntlet":
            return mod.generate_gauntlet_trace(seed)
        if kind == "storm":
            return mod.generate_trace(_storm_cfg(mod, seed))
        if kind == "card":
            return mod.generate_trace(_card_cfg(mod, seed))
        return mod.generate_trace(main.scenario_config(kind, seed))

    jt, tt = make(jtr, jmain), make(ttr, tmain)
    jtr.dump_jsonl(jt, str(tmp_path / "j.jsonl"))
    ttr.dump_jsonl(tt, str(tmp_path / "t.jsonl"))
    assert (tmp_path / "t.jsonl").read_bytes() \
        == (tmp_path / "j.jsonl").read_bytes()
    back = ttr.load_jsonl(str(tmp_path / "j.jsonl"))
    assert [dataclasses.asdict(r) for r in back.requests] \
        == [dataclasses.asdict(r) for r in tt.requests]
    assert back.meta == tt.meta


def test_unknown_fault_site_refused_as_jax():
    for mod in (jtr, ttr):
        cfg = mod.TraceConfig(fault_waves=(mod.FaultWaveSpec(
            name="w", at_frac=0.1, rules=({"site": "nowhere",
                                           "kind": "drop"},)),))
        with pytest.raises(ValueError, match="not in the replay site"):
            mod.generate_trace(cfg)
    assert ttr.FAULT_SITES == jtr.FAULT_SITES


@pytest.mark.parametrize("cfg", [
    {}, {"isl": 512, "prefix_ratio": 0.5, "vocab_size": 32000, "seed": 9},
    {"num_requests": 7, "isl": 3, "groups": 1, "branches": 5,
     "prefix_ratio": 1.0, "seed": 2},
    {"isl": 100, "prefix_ratio": 0.0, "seed": 4},
])
def test_datagen_copies_equal_benchmarks(cfg):
    want = bdg.generate_prefix_dataset(bdg.PrefixDatasetConfig(**cfg))
    got = tdg.generate_prefix_dataset(tdg.PrefixDatasetConfig(**cfg))
    assert [dataclasses.asdict(r) for r in got] \
        == [dataclasses.asdict(r) for r in want]
    assert tdg.prefix_ground_truth(got) == bdg.prefix_ground_truth(want)
    vals = [float(x) for x in np.random.default_rng(3).uniform(0, 9, 37)]
    for q in (0, 1, 50, 90, 99, 100):
        assert tdg.percentile(vals, q) == bdg.percentile(vals, q)
    assert tdg.percentile([], 50) == bdg.percentile([], 50)


# --------------------------- synthetic outcomes ---------------------------


def _outcomes(mod, seed=0, n=30):
    rng = np.random.default_rng(seed)
    out, spans = [], []
    for i in range(n):
        osl = int(rng.integers(2, 9))
        o = mod.RequestOutcome(
            request_id=f"r{i}", tenant=f"tenant{i % 2}", pool=i % 3,
            tier=int(rng.integers(0, 2)), isl=int(rng.integers(8, 64)),
            osl=osl, arrival_s=float(rng.uniform(0, 6)), trace_id=f"t{i}")
        kind = rng.choice(["ok", "ok", "ok", "abort", "error", "short",
                           "resumed", "none"])
        o.ttft_s = float(rng.uniform(0.01, 3.0))
        o.itls = [float(x) for x in rng.uniform(0.001, 0.8, osl - 1)]
        o.tokens = [int(x) for x in rng.integers(2, 200, osl)]
        o.submissions = [(o.isl, osl)]
        o.finish_reason = "length"
        if kind == "abort":
            o.aborted, o.finish_reason = True, "aborted"
            o.tokens = o.tokens[:2]
        elif kind == "error":
            o.error, o.finish_reason = "EngineError: gone", None
        elif kind == "short":
            o.tokens = o.tokens[:-1]
        elif kind == "resumed":
            o.resumes = 1
            o.submissions = [(o.isl, 2), (o.isl + 2, osl - 2)]
        elif kind == "none":
            o.finish_reason = None
        out.append(o)
        q = float(rng.uniform(0, 0.3))
        p = float(rng.uniform(0, 0.3))
        spans += [{"trace_id": f"t{i}", "name": "worker.queue",
                   "duration_s": q},
                  {"trace_id": f"t{i}", "name": "engine.prefill",
                   "duration_s": p},
                  {"trace_id": f"t{i}", "name": "migration.attempt",
                   "duration_s": q + p}]
        if i % 7 == 0:
            spans.append({"trace_id": f"t{i}", "name": "engine.prefill",
                          "duration_s": p})
    return out, spans


def _trace(mod, seed=0):
    cfg = mod.TraceConfig(
        seed=seed, num_requests=30, duration_s=6.0, preempt_at_frac=0.3,
        kill_at_frac=0.5, store_flap_at_frac=0.7,
        fault_waves=(mod.FaultWaveSpec(
            name="relaywave", at_frac=0.2, clear_frac=0.6,
            rules=({"site": "worker.stream", "kind": "truncate",
                    "times": 1},)),))
    return mod.generate_trace(cfg)


def _run(mod, outcomes, spans, seed=0):
    return mod.ReplayRunResult(
        outcomes=outcomes, elapsed_s=4.25, time_scale=2.0,
        events_fired=[{"kind": "preempt", "at_s": 1.8}],
        recorder_goodput_tokens=900.0, recorder_steps=120.0,
        prefix_hits_blocks=12, prefix_queries_blocks=80, block_size=4,
        chips=2, device_kind="cpu", platform="cpu", spans=spans,
        preempt={"notices": 1, "evacuated_peer": 0, "spilled": 0,
                 "fallbacks": 1, "seats": 2},
        num_kills=1, seed=seed,
        faults_fired={"worker.stream/truncate": 1, "store.call/drop": 2,
                      "engine.stall/delay": 1},
        evidence={"migration_retries": 1.0, "store_call_errors": 0.0,
                  "engine_stalls": 1.0},
        prefix_index_hit_tokens=48.0, prefix_index_queries=80.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scoreboard_checks_equal_jax(seed):
    (jo, spans), (to, _) = _outcomes(jdrv, seed), _outcomes(tdrv, seed)
    jt, tt = _trace(jtr, seed), _trace(ttr, seed)
    tol_kw = dict(ttft_span_slack_s=0.05, min_ttft_samples=2)
    jtol, ttol = jsb.CheckTolerances(**tol_kw), tsb.CheckTolerances(**tol_kw)
    assert tsb.outcome_digest(to) == jsb.outcome_digest(jo)
    assert tsb.cross_check_ttft(to, spans, ttol) \
        == jsb.cross_check_ttft(jo, spans, jtol)
    for rec in (0.0, 400.0, 900.0, 1e5):
        assert tsb.cross_check_tokens(to, rec, 48.0, ttol) \
            == jsb.cross_check_tokens(jo, rec, 48.0, jtol)
    assert tsb.token_loss_accounting(to) == jsb.token_loss_accounting(jo)
    assert tsb.wave_recovery(tt, to) == jsb.wave_recovery(jt, jo)
    assert tsb.wave_recovery(tt, to, window_s=0.25) \
        == jsb.wave_recovery(jt, jo, window_s=0.25)
    assert tsb._tier_table(to, tt.tiers(), 4.25) \
        == jsb._tier_table(jo, jt.tiers(), 4.25)
    ev = {"migration_retries": 1.0, "store_call_errors": 0.0}
    fired = {"worker.stream/truncate": 1, "store.call/drop": 2,
             "preempt.notice/drop": 1, "mystery.site/drop": 1}
    assert tsb.cross_check_fault_attribution(fired, ev) \
        == jsb.cross_check_fault_attribution(fired, ev)
    assert tsb.SITE_EVIDENCE == jsb.SITE_EVIDENCE
    assert tsb.SITE_KIND_EVIDENCE == jsb.SITE_KIND_EVIDENCE
    jrun, trun = _run(jdrv, jo, spans, seed), _run(tdrv, to, spans, seed)
    assert tsb.cross_check_prefix_vs_index(trun, ttol) \
        == jsb.cross_check_prefix_vs_index(jrun, jtol)
    want = jsb.build_scoreboard(jt, jrun, jtol)
    got = tsb.build_scoreboard(tt, trun, ttol)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


def test_scoreboard_roofline_reads_the_served_width():
    """A run at Llama-3.2-1B width on a card: the ideal chip-seconds use
    that model's FLOPs and the card's peak (one engine = one chip)."""
    from dynamo_tpu_torch.engine.config import ModelConfig
    from dynamo_tpu_torch.observability.flops import FlopsModel, peak_flops

    to, spans = _outcomes(tdrv, 0)
    run = _run(tdrv, to, spans)
    run.device_kind, run.platform, run.chips = "NVIDIA H100 80GB HBM3", \
        "cuda", 1
    run.model = ModelConfig.llama3_1b()
    rep = tsb.build_scoreboard(_trace(ttr), run)
    done = [o for o in to if o.error is None and not o.aborted
            and o.finish_reason is not None]
    ideal = sum(FlopsModel(run.model).sequence_flops(o.isl, len(o.tokens))
                for o in done) / peak_flops(run.device_kind, "cuda")
    out = sum(len(o.tokens) for o in done)
    assert rep["ideal_chip_seconds_per_1m_output_tokens"] == round(
        ideal / (out / 1e6), 6)
    assert rep["chip_seconds"] == 4.25


def test_replay_settings_default_to_the_reference():
    jset, tset = jdrv.ReplaySettings(), tdrv.ReplaySettings()
    want = dataclasses.asdict(jset)
    got = dataclasses.asdict(tset)
    assert got.pop("model") is None and got.pop("device") is None
    assert got == want
    assert tdrv._decode_buckets(4) == (4, 8)
    assert tdrv._decode_buckets(16) == (4, 8, 16)


def test_replay_cli_without_device_raises_on_a_cpu_machine(monkeypatch,
                                                          tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.main(["--scenario", "smoke", "--out", str(tmp_path)])


# ----------------------------- cluster replay -----------------------------


@pytest.fixture
def jax_tiny_engines(monkeypatch):
    """Port engines on the CPU holding the JAX engine's tiny tree (the
    JAX engine draws it from ``PRNGKey(seed)``)."""
    real = teng.InferenceEngine

    def engine(model_cfg, eng_cfg, seed=0, device=None):
        jc = jcfg.ModelConfig.tiny(vocab_size=model_cfg.vocab_size)
        tree = jax.tree.map(np.asarray,
                            jm.init_params(jax.random.PRNGKey(seed), jc))
        return real(model_cfg, eng_cfg, seed=seed, device="cpu",
                    params=params_from_numpy(tree, model_cfg, "cpu"))

    monkeypatch.setattr(teng, "InferenceEngine", engine)


@pytest.mark.parametrize("seed", [7, 3])
def test_smoke_replay_digest_equals_jax(tmp_path, seed, jax_tiny_engines):
    async def both():
        out = {}
        for side, tr, drv, sb, main in (
                ("jax", jtr, jdrv, jsb, jmain),
                ("port", ttr, tdrv, tsb, tmain)):
            trace = tr.generate_trace(main.scenario_config("smoke", seed))
            work = tmp_path / side
            work.mkdir()
            run = await drv.run_cluster_replay(
                trace, drv.ReplaySettings(time_scale=4.0),
                workdir=str(work))
            out[side] = sb.build_scoreboard(trace, run)
        return out

    reps = asyncio.run(both())
    jrep, trep = reps["jax"], reps["port"]
    assert trep["outcome_digest"] == jrep["outcome_digest"]
    assert trep["ok"], trep["checks"]
    for name, check in trep["checks"].items():
        assert check["ok"], (name, check)
    assert (trep["requests"], trep["completed"], trep["aborted"],
            trep["errors"]) == (jrep["requests"], jrep["completed"],
                                jrep["aborted"], jrep["errors"])
    assert trep["chips"] == jrep["chips"] == 2
    assert trep["device_kind"] == "cpu"
    assert trep["preempt"]["notices"] == 1
    assert trep["prefix_hit_rate"] is not None
    json.dumps(trep)


class _DropAfter:
    """A routing sink that serves 6 tokens, numbering each attempt's frames
    from ``index`` 0 as the engine does, and drops the first attempt after
    3 (``unavailable``): ``Migration`` re-issues the rest with the 3
    carried tokens appended to the prompt."""

    def __init__(self, transport, drop_after=3):
        self.transport = transport
        self.drop_after = drop_after
        self.requests = []

    async def generate(self, request, context):
        self.requests.append(dict(request))
        first = len(self.requests) == 1
        n = self.drop_after if first else int(request["max_tokens"])
        base = 100 + len(request["token_ids"])
        for i in range(n):
            last = not first and i == n - 1
            yield {"token_ids": [base + i], "index": i, "finished": last,
                   "finish_reason": "length" if last else None}
        if first:
            raise self.transport.EngineError("dropped",
                                             self.transport.ERR_UNAVAILABLE)


def test_driver_drops_a_migrated_streams_carried_tokens_in_both():
    """ROADMAP queue C finding (g), pinned in both packages: ``Migration``
    re-issues with the carried tokens appended and ``max_tokens`` cut, the
    re-issue's frames are numbered from ``index`` 0 again, and
    ``_drive_one`` keys one attempt's tokens by ``index``: the re-issue's 3
    tokens overwrite the 3 carried ones, so the outcome holds 3 of the 6
    tokens the stream delivered, with ``finish_reason`` ``length``."""
    from dynamo_tpu.llm import migration as jmig
    from dynamo_tpu.runtime import transport as jtransport
    from dynamo_tpu_torch.llm import migration as tmig
    from dynamo_tpu_torch.runtime import transport as ttransport

    async def drive(drv, tr, mig_mod, transport):
        sink = _DropAfter(transport)
        mig = mig_mod.Migration(sink, migration_limit=3, backoff_base_s=0.0)
        req = tr.TraceRequest(request_id="r0", arrival_s=0.0, tenant="t0",
                              pool=0, token_ids=[1, 2, 3, 4], osl=6, tier=0)
        outcome = drv.RequestOutcome(
            request_id=req.request_id, tenant=req.tenant, pool=req.pool,
            tier=req.tier, isl=req.isl, osl=req.osl,
            arrival_s=req.arrival_s)
        await drv._drive_one(req, mig, outcome, drv.ReplaySettings(),
                             asyncio.get_running_loop())
        return sink.requests, outcome

    got = {}
    for side, drv, tr, mig_mod, transport in (
            ("jax", jdrv, jtr, jmig, jtransport),
            ("port", tdrv, ttr, tmig, ttransport)):
        got[side] = asyncio.run(drive(drv, tr, mig_mod, transport))
    for side, (requests, outcome) in got.items():
        # the stream itself was whole: 3 tokens, then the re-issue's 3
        assert requests == [
            {"token_ids": [1, 2, 3, 4], "max_tokens": 6, "ignore_eos": True},
            {"token_ids": [1, 2, 3, 4, 104, 105, 106], "max_tokens": 3,
             "ignore_eos": True}], side
        assert outcome.error is None, (side, outcome.error)
        # the finding: the carried tokens are lost
        assert outcome.tokens == [107, 108, 109], side
        assert outcome.finish_reason == "length", side
        assert outcome.submissions == [(4, 3)], side
        assert outcome.resumes == outcome.reconnects == 0, side
    assert got["jax"][1].tokens == got["port"][1].tokens
