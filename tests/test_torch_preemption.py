"""The port's preemption coordinator (``runtime/preemption.py``) and the
engine's evacuation hooks held against the JAX package: seat records and
the journal; a notice with a co-resident peer (the seat's KV moves over the
device plane and the stream goes on to equal the run that was not
preempted); a notice with no peer (sealed blocks spill to the host tier and
the re-admission prefill is served from it); a fallback (journal only);
``PreemptionReport`` counts, modes and bytes equal JAX's for each. The
quantized spill finding about the reference is pinned in both packages: the
spill carries the pages without their scales, so a quantized seat's spilled
blocks fail to onboard and the resume re-prefills from scratch, with the
right tokens. CPU, ``ModelConfig.tiny``."""

import asyncio

import jax
import numpy as np
import pytest

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JModelConfig
from dynamo_tpu.engine.engine import InferenceEngine as JEngine
from dynamo_tpu.engine.engine import Request as JRequest
from dynamo_tpu.kvbm.host_pool import HostBlockPool as JHostBlockPool
from dynamo_tpu.kvbm.manager import KvbmConfig as JKvbmConfig
from dynamo_tpu.runtime import preemption as jpre
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import InferenceEngine, Request
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.kvbm.host_pool import HostBlockPool
from dynamo_tpu_torch.kvbm.manager import KvbmConfig
from dynamo_tpu_torch.runtime import preemption as tpre

MC_KW = dict(vocab_size=256)
ENG_KW = dict(num_blocks=64, block_size=4, max_model_len=128,
              max_num_batched_tokens=128, prefill_buckets=(128,),
              decode_buckets=(4, 8), max_num_seqs=4)
PROMPT = [7, 3, 11, 42, 9, 100, 55, 2, 91, 13, 77, 5, 31, 8, 60, 24,
          17, 45, 88, 6, 29, 73, 50, 12]


class _FakeSeq:
    def __init__(self, sid="s0", seed=-1):
        self.seq_id = sid
        self.prompt_ids = [1, 2, 3, 4, 5]
        self.output_ids = [6, 7, 8]
        self.num_computed = 7
        self.max_tokens = 8
        self.temperature = 0.0
        self.top_k = 0
        self.top_p = 1.0
        self.seed = seed
        self.eos_token_ids = frozenset([2])


@pytest.mark.parametrize("seed", [-1, 17])
def test_seat_records_equal_jax(seed):
    want = jpre.SeatRecord.from_seq(_FakeSeq(seed=seed))
    got = tpre.SeatRecord.from_seq(_FakeSeq(seed=seed))
    assert vars(got) == vars(want)
    for fn in ("peer_request", "resume_request"):
        g, w = vars(getattr(got, fn)()), vars(getattr(want, fn)())
        # the JAX request's multimodal fields (not ported) stay unset
        assert g == {k: w[k] for k in g}
        assert all(w[k] is None for k in set(w) - set(g))
    assert got.first_token() == want.first_token() == 8


def test_journal_equals_jax():
    journals = [jpre.SeatJournal(cap=3), tpre.SeatJournal(cap=3)]
    for j in journals:
        for i in range(5):
            j.record(_FakeSeq(sid=f"s{i}"))
        j.record(_FakeSeq(sid="s4"))
    jj, tj = journals
    assert (len(tj), tj.evictions) == (len(jj), jj.evictions) == (3, 2)
    assert list(tj._records) == list(jj._records)
    assert tj.get("s4").generation == jj.get("s4").generation == 1


# ------------------------------ scenarios --------------------------------


@pytest.fixture(scope="module")
def tree():
    engine = JEngine(JModelConfig.tiny(**MC_KW), JEngineConfig(**ENG_KW),
                     seed=0)
    return jax.tree.map(np.asarray, engine.params)


def make_engine(pkg, tree, **kw):
    if pkg == "jax":
        return JEngine(JModelConfig.tiny(**MC_KW),
                       JEngineConfig(**dict(ENG_KW, **kw)), seed=0)
    mc = ModelConfig.tiny(**MC_KW)
    return InferenceEngine(mc, EngineConfig(**dict(ENG_KW, **kw)),
                           params=params_from_numpy(tree, mc, "cpu"),
                           device="cpu")


def mk_req(pkg, rid, max_tokens=8):
    cls = JRequest if pkg == "jax" else Request
    return cls(request_id=rid, token_ids=list(PROMPT),
               max_tokens=max_tokens, ignore_eos=True)


async def collect(aiter):
    """Tokens + finish reason, index-keyed: the evacuation finish frame
    re-carries the last token and must not double-count."""
    toks, reason = {}, None
    async for out in aiter:
        if out.token_id >= 0:
            toks[out.index] = out.token_id
        if out.finished:
            reason = out.finish_reason
    return [toks[i] for i in sorted(toks)], reason


async def drive_until(engine, req, after_tokens):
    progress = {"n": 0}

    async def run():
        toks, reason = {}, None
        async for out in engine.submit(req):
            if out.token_id >= 0:
                toks[out.index] = out.token_id
            progress["n"] = len(toks)
            if out.finished:
                reason = out.finish_reason
        return [toks[i] for i in sorted(toks)], reason

    task = asyncio.create_task(run())
    while progress["n"] < after_tokens and not task.done():
        await asyncio.sleep(0.002)
    return task


# what a record holds apart from the KV frontier (how many tokens landed
# before the seat was parked depends on thread timing, in either package)
STABLE = ("seq_id", "prompt_ids", "max_tokens", "temperature", "top_k",
          "top_p", "seed", "eos_token_ids", "generation")


def report_summary(mod, report):
    return {
        "counts": {m: report.count(m) for m in (mod.PEER, mod.SPILL,
                                                mod.FALLBACK, mod.FINISHED)},
        "notice_lost": report.notice_lost,
        "deadline_blown": report.deadline_blown,
        "moved": [r.bytes_moved > 0 for r in report.results],
        "records": [{k: getattr(r.record, k) for k in STABLE}
                    for r in report.results],
        "frontier_ok": [
            r.record.num_computed
            == len(r.record.prompt_ids) + len(r.record.output_ids) - 1
            for r in report.results],
    }


async def scenario(pkg, tree, mode, kv_dtype="bf16"):
    """Drive one seat two tokens in, send a notice, then resume the seat
    where the report says: on the peer (PEER), on a fresh engine sharing
    the spilled host pool (SPILL) or on a fresh engine from the journal
    record (FALLBACK). Returns the pieces both packages must agree on."""
    mod = jpre if pkg == "jax" else tpre
    kw = dict(kv_dtype=kv_dtype)
    src = make_engine(pkg, tree, **kw)
    ref = make_engine(pkg, tree, **kw)
    peer = make_engine(pkg, tree, **kw) if mode == "peer" else None
    resume = make_engine(pkg, tree, **kw)
    pool = None
    if mode == "spill":
        pool = (JHostBlockPool if pkg == "jax" else HostBlockPool)(128)
        resume.attach_kvbm((JKvbmConfig if pkg == "jax" else KvbmConfig)(
            host_blocks=128))
        resume.kvbm.host_pool = pool
    coord = mod.PreemptionCoordinator(src, peer=peer, host_pool=pool,
                                      notice_grace_s=0.0)
    try:
        want, _ = await collect(ref.submit(mk_req(pkg, "r0")))
        task = await drive_until(src, mk_req(pkg, "r0"), 2)
        report = await coord.notice("test")
        got, reason = await task
        res = report.results[0]
        # what the spill itself put in the pool (the resume engine's own
        # offloads add full payloads later)
        spilled_keys = (sorted({k for h in pool._mem
                                for k in pool._mem[h]}) if pool else [])
        if res.mode == mod.PEER:
            tail, _ = await collect(peer.resume_prefilled(
                res.dst_seq, res.record.first_token()))
            stream = got + tail[1:]
        else:
            tail, _ = await collect(resume.submit(
                res.record.resume_request()))
            stream = got + tail
        onboarded = (resume.kvbm.stats.onboarded_blocks
                     if resume.kvbm is not None else 0)
        return {
            "reason": reason, "stream": stream, "want": want,
            "report": report_summary(mod, report),
            "coord": (coord.num_notices, coord.num_evacuated,
                      coord.num_spilled, coord.num_fallbacks),
            "onboarded": onboarded > 0, "spilled_keys": spilled_keys,
            "src_running": len(src.scheduler.running),
        }
    finally:
        for e in (src, ref, peer, resume):
            if e is not None:
                await e.stop()


@pytest.mark.parametrize("mode", ["peer", "spill", "fallback"])
def test_evacuation_equals_jax(tree, mode):
    want = asyncio.run(scenario("jax", tree, mode))
    got = asyncio.run(scenario("port", tree, mode))
    assert got == want
    assert got["reason"] == "evacuated"
    assert got["stream"] == got["want"]
    assert got["src_running"] == 0
    counts = got["report"]["counts"]
    assert counts[{"peer": tpre.PEER, "spill": tpre.SPILL,
                   "fallback": tpre.FALLBACK}[mode]] == 1
    assert got["report"]["frontier_ok"] == [True]
    if mode == "spill":
        assert got["onboarded"]              # re-admission served from cache
    if mode in ("peer", "spill"):
        assert got["report"]["moved"] == [True]


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_spill_leaves_scales_behind_in_both(tree, kv_dtype):
    """The reference's ``_to_host`` spills only "k"/"v": a quantized seat's
    spilled blocks lack their scales, the onboard's scatter finds no "ks"
    and fails, the engine logs it and prefills from scratch — the stream is
    still right, and nothing was onboarded. The port does the same."""
    want = asyncio.run(scenario("jax", tree, "spill", kv_dtype))
    got = asyncio.run(scenario("port", tree, "spill", kv_dtype))
    assert got == want
    assert got["spilled_keys"] == ["k", "v"]
    assert got["onboarded"] is False
    assert got["stream"] == got["want"]


def test_notice_is_idempotent_and_lost_notices_are_reported(tree):
    from dynamo_tpu.runtime import faults as jfaults
    from dynamo_tpu_torch.runtime import faults as tfaults

    async def run(pkg):
        mod = jpre if pkg == "jax" else tpre
        src = make_engine(pkg, tree)
        coord = mod.PreemptionCoordinator(src, notice_grace_s=0.0)
        try:
            first = await coord.notice("one")
            second = await coord.notice("two")
            return (coord.num_notices, first.results, second.results,
                    first.notice_lost)
        finally:
            await src.stop()

    assert asyncio.run(run("port")) == asyncio.run(run("jax")) == \
        (1, [], [], False)
    assert tfaults.DROP == jfaults.DROP
