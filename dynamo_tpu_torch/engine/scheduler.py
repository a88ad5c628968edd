"""Continuous-batching scheduler with paged-block accounting.

A copy of ``dynamo_tpu.engine.scheduler`` (pure Python, no device), prefix
caching included.

Faithful to the vLLM semantics the reference encodes compactly in its mocker
(ref: lib/llm/src/mocker/scheduler.rs:240 and kv_manager.rs:507): waiting and
running queues, a per-step token budget with chunked prefill, a free-block
watermark on admission, LRU eviction of sealed (hash-keyed) blocks, prefix
caching by chained sequence hash, and preemption-by-recompute when the pool
runs dry. KV events (stored/removed, ref: lib/llm/src/kv_router/
protocols.rs) are emitted for the router's radix indexer.

Token/KV invariants:
- ``num_computed`` = tokens whose KV is written to the cache.
- During prefill, chunks advance ``num_computed`` through the prompt; the
  chunk that completes the prompt also samples the first output token.
- During decode, the step feeds ``all_tokens[num_computed]`` (writing its KV)
  and samples the next token, so ``total = num_computed + 1`` between steps.
"""

from __future__ import annotations

import enum
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import (
    Any, Callable, Deque, Dict, List, Optional, Sequence as Seq, Tuple,
)

from ..tokens import TokenBlockSequence
from ..utils.hotpath import hot_path
from ..utils.logging import get_logger
from .config import EngineConfig

log = get_logger("engine.scheduler")

TRASH_BLOCK = 0  # physical block 0 absorbs padding writes; never allocated


class KvEvent:
    """KV cache event for the router indexer (stored / removed)."""

    __slots__ = ("kind", "blocks")

    def __init__(self, kind: str, blocks: List[dict]):
        self.kind = kind      # "stored" | "removed" | "cleared"
        self.blocks = blocks  # [{"seq_hash", "parent", "block_hash"}] / hashes

    def to_dict(self) -> dict:
        return {"kind": self.kind, "blocks": self.blocks}


class BlockPool:
    """Reference-counted physical block pool with hash-keyed reuse.

    Sealed blocks (content-complete, keyed by chained sequence hash) become
    *evictable* instead of free when their refcount drops to zero, forming the
    prefix cache; eviction is LRU (ref: mocker/evictor.rs).
    """

    def __init__(self, num_blocks: int,
                 on_event: Optional[Callable[[KvEvent], None]] = None):
        self.num_blocks = num_blocks
        self._free: Deque[int] = deque(range(1, num_blocks))  # 0 = trash
        self._ref: Dict[int, int] = {}
        self._hash_of: Dict[int, int] = {}         # block -> seq_hash
        self._parent_of: Dict[int, Optional[int]] = {}
        self._cached: Dict[int, int] = {}           # seq_hash -> block
        self._evictable: "OrderedDict[int, int]" = OrderedDict()  # block -> hash
        self.on_event = on_event

    # -- capacity --

    @property
    def num_free(self) -> int:
        return len(self._free) + len(self._evictable)

    @property
    def usage(self) -> float:
        usable = self.num_blocks - 1
        return 1.0 - self.num_free / usable if usable else 1.0

    # -- allocation --

    def allocate(self) -> Optional[int]:
        if self._free:
            bid = self._free.popleft()
            self._ref[bid] = 1
            return bid
        if self._evictable:
            bid, seq_hash = self._evictable.popitem(last=False)  # LRU
            self._cached.pop(seq_hash, None)
            self._emit(KvEvent("removed", [seq_hash]))
            self._hash_of.pop(bid, None)
            self._parent_of.pop(bid, None)
            self._ref[bid] = 1
            return bid
        return None

    def lookup(self, seq_hash: int) -> Optional[int]:
        """Prefix-cache hit: reuse a sealed block by sequence hash."""
        bid = self._cached.get(seq_hash)
        if bid is None:
            return None
        if bid in self._evictable:
            del self._evictable[bid]
            self._ref[bid] = 1
        else:
            self._ref[bid] += 1
        return bid

    def contains(self, seq_hash: int) -> bool:
        return seq_hash in self._cached

    def adopt(self, seq_hash: int, block_hash: int,
              parent: Optional[int]) -> Optional[int]:
        """Allocate a block and register it as sealed WITHOUT any sequence
        owning it — the KVBM onboard path (G2/G3 → G1). Returned with
        refcount 1 so it cannot be evicted while the caller injects the KV;
        ``release_adopted`` afterwards makes it an evictable cache hit."""
        if seq_hash in self._cached:
            return None
        bid = self.allocate()
        if bid is None:
            return None
        self.seal(bid, seq_hash, block_hash, parent)
        return bid

    def release_adopted(self, bid: int) -> None:
        self.decref(bid)  # refcount 0 + sealed → evictable (cached)

    def discard_adopted(self, bid: int) -> None:
        """Back out an ``adopt`` whose KV injection failed: unregister the
        hash so the block can never be served as a prefix hit, then free it.
        (Releasing it normally would poison the prefix cache with blocks
        whose KV was never written.)"""
        seq_hash = self._hash_of.pop(bid, None)
        self._parent_of.pop(bid, None)
        if seq_hash is not None and self._cached.get(seq_hash) == bid:
            del self._cached[seq_hash]
            self._emit(KvEvent("removed", [seq_hash]))
        self._ref.pop(bid, None)
        self._free.append(bid)

    def incref(self, bid: int) -> None:
        self._ref[bid] += 1

    def decref(self, bid: int) -> None:
        self._ref[bid] -= 1
        if self._ref[bid] > 0:
            return
        del self._ref[bid]
        seq_hash = self._hash_of.get(bid)
        if seq_hash is not None and self._cached.get(seq_hash) == bid:
            self._evictable[bid] = seq_hash   # keep content for reuse
        else:
            self._free.append(bid)

    def seal(self, bid: int, seq_hash: int, block_hash: int,
             parent: Optional[int]) -> None:
        """Register a content-complete block for prefix reuse."""
        if seq_hash in self._cached:
            return  # identical content already cached under another block
        self._hash_of[bid] = seq_hash
        self._parent_of[bid] = parent
        self._cached[seq_hash] = bid
        self._emit(KvEvent("stored", [
            {"seq_hash": seq_hash, "block_hash": block_hash,
             "parent": parent, "block_id": bid}
        ]))

    def clear(self) -> None:
        """Drop the prefix cache. Blocks still referenced by running
        sequences stay allocated (their hash registrations are removed, so
        on release they are freed rather than kept for reuse); evictable
        blocks return to the free list."""
        for bid in self._evictable:
            self._free.append(bid)
        self._evictable.clear()
        self._cached.clear()
        self._hash_of.clear()
        self._parent_of.clear()
        self._emit(KvEvent("cleared", []))

    def _emit(self, event: KvEvent) -> None:
        if self.on_event is not None:
            self.on_event(event)


class SeqStatus(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    RUNNING = "running"
    # parked for live KV evacuation (runtime/preemption.py): no new
    # windows are planned for the seat, its blocks stay pinned until the
    # transfer lands, and it is not a recompute-preemption victim
    EVACUATING = "evacuating"
    FINISHED = "finished"


@dataclass
class SchedSeq:
    """Scheduler-side state of one sequence."""

    seq_id: str
    prompt_ids: List[int]
    max_tokens: int
    eos_token_ids: frozenset
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = -1          # -1 = unseeded (engine rng)
    # multimodal: placeholder positions + their embedding rows [N, D]
    mm_positions: Optional[list] = None
    mm_embeddings: Optional[object] = None
    arrival: float = field(default_factory=time.monotonic)
    # tracing stamps (monotonic): first time a prefill chunk was scheduled,
    # and when the first output token was emitted — the engine derives the
    # worker.queue / engine.prefill / engine.decode span windows from these
    t_scheduled: Optional[float] = None
    t_first_token: Optional[float] = None
    status: SeqStatus = SeqStatus.WAITING
    output_ids: List[int] = field(default_factory=list)
    block_table: List[int] = field(default_factory=list)
    num_computed: int = 0
    num_sealed_blocks: int = 0
    finish_reason: Optional[str] = None
    token_seq: Optional[TokenBlockSequence] = None
    preemptions: int = 0
    # disagg: keep blocks alive after finish until the KV is extracted
    # (prefill worker side; released via Scheduler.release_held)
    hold_blocks: bool = False
    # disagg: reservation epoch stamped by EngineCore.reserve_sequence —
    # a transfer carrying a stale epoch must never scatter into these
    # blocks (they may have been recycled to another request)
    kv_epoch: int = 0
    # ---- pipelined (run-ahead) serving state ----
    # device token-ring slot (-1 = unassigned); see model.raw_decode_window_fn
    slot: int = -1
    # slot held when this seq was last preempted (engine kills the seat)
    preempted_slot: int = -1
    # dispatched-but-unlanded work (speculative scheduling reads through it)
    pending_prompt: int = 0   # prefill chunk tokens in flight
    pending_first: int = 0    # 1 while the prompt-completing sample is in flight
    pending_decode: int = 0   # decode tokens in flight
    # speculative decoding accounting (engine-updated; surfaces as
    # engine.decode span attributes)
    spec_drafted: int = 0
    spec_accepted: int = 0

    @property
    def pending_total(self) -> int:
        return self.pending_prompt + self.pending_first + self.pending_decode

    @property
    def total_tokens(self) -> int:
        return len(self.prompt_ids) + len(self.output_ids)

    def all_tokens(self) -> List[int]:
        return self.prompt_ids + self.output_ids

    @property
    def prompt_len(self) -> int:
        return len(self.prompt_ids)

    @property
    def prefill_done(self) -> bool:
        # during decode the newest token's KV is always pending
        return self.num_computed >= self.prompt_len


@dataclass
class PrefillChunk:
    seq: SchedSeq
    start: int  # first token index in this chunk
    length: int
    # snapshot of completes_prompt at schedule time (the live property is
    # unstable once pipelined decode windows append outputs)
    final: bool = False

    @property
    def completes_prompt(self) -> bool:
        # a chunk that reaches the end of *known* tokens transitions the
        # sequence to decode (covers both fresh prompts and recompute after
        # preemption, where outputs are re-prefilled too)
        return self.start + self.length >= self.seq.total_tokens


@dataclass
class DecodeRow:
    """One decode seat in a window, snapshotted at schedule time (the seq's
    live fields may run ahead by the time the window lands)."""

    seq: SchedSeq
    base: int        # input position (num_computed seen through pendings)
    accepted: int    # tokens this window contributes (<= decode_steps)
    tok_host: int    # input token when the host knows it, else 0
    tok_src: int     # 1 = read the device ring, 0 = tok_host
    slot: int


@dataclass
class ScheduledBatch:
    prefills: List[PrefillChunk] = field(default_factory=list)
    decode_rows: List[DecodeRow] = field(default_factory=list)
    preempted: List[SchedSeq] = field(default_factory=list)
    # observability: StepRecords the engine attaches at dispatch and
    # commits at landing — riding the batch keeps attribution correct
    # with several pipelined windows in flight
    obs_records: List = field(default_factory=list)
    # the engine loop's stamps of this batch's phases (engine._LoopStamps),
    # set only while the tracer has a sink
    loop_stamps: Any = None

    @property
    def decodes(self) -> List[SchedSeq]:
        # derived view — decode_rows is the single source of truth
        return [r.seq for r in self.decode_rows]

    @property
    def is_empty(self) -> bool:
        return not self.prefills and not self.decode_rows


@dataclass
class SchedulerStats:
    """ForwardPassMetrics-equivalent snapshot (ref: kv_router/protocols.rs:48)."""

    num_running: int = 0
    num_waiting: int = 0
    kv_usage: float = 0.0
    num_total_blocks: int = 0
    prefix_cache_hits: int = 0
    prefix_cache_queries: int = 0


class Scheduler:
    """Admission + step planning over the block pool."""

    def __init__(self, config: EngineConfig,
                 on_event: Optional[Callable[[KvEvent], None]] = None):
        self.config = config
        self.pool = BlockPool(config.num_blocks, on_event=on_event)
        self.waiting: Deque[SchedSeq] = deque()
        self.running: List[SchedSeq] = []
        self.stats = SchedulerStats(num_total_blocks=config.num_blocks - 1)
        # device token-ring slots (pipelined serving); slot max_num_seqs is
        # the trash slot and is never handed out
        self._free_slots: Deque[int] = deque(range(config.max_num_seqs))
        # finished seqs with windows still in flight: blocks + slot live
        # until the engine reaps them (a landed window may still scatter
        # into their blocks)
        self.zombies: List[SchedSeq] = []
        # set by the engine once it has actually built an sp prefill step —
        # config alone isn't enough (a single-device mesh can't ring), and
        # emitting a whole-prompt chunk the engine must run densely would
        # bypass max_num_batched_tokens entirely
        self.sp_enabled = False
        # speculative decoding: when set (spec_k + 1), decode windows are
        # planned this many tokens wide instead of decode_steps — the spec
        # window may land anywhere from 1 to spec_k+1 of them; the engine
        # clears it again on adaptive auto-disable
        self.spec_plan_window: Optional[int] = None
        # adaptive prefill bucket ladder (engine/ladder.py) when the
        # engine enables it: chunk caps snap DOWN to a live rung so a
        # chunked-prefill cap retired from the grid doesn't keep padding
        # chunks up to a stale bucket
        self.prefill_ladder = None
        # prefix cache manager hook: called with (queried_hashes,
        # matched_hashes) after every admission-time prefix match so the
        # radix index keeps its own hit accounting (the replay
        # prefix_vs_index cross-check compares the two)
        self.on_prefix_match: Optional[
            Callable[[List[int], List[int]], None]] = None

    # -- admission --

    def add(self, seq: SchedSeq) -> None:
        if seq.token_seq is None:  # the KVBM onboard path pre-builds it
            seq.token_seq = TokenBlockSequence.from_tokens(
                seq.prompt_ids, self.config.block_size
            )
        self.waiting.append(seq)

    def abort(self, seq: SchedSeq, reason: str = "aborted") -> None:
        if seq.status == SeqStatus.FINISHED:
            return
        self._finish(seq, reason)

    # -- planning --

    @hot_path
    def schedule(self) -> ScheduledBatch:
        batch = ScheduledBatch()
        budget = self.config.max_num_batched_tokens
        bs = self.config.block_size

        # 1. decodes: every running sequence advances up to ``decode_steps``
        # tokens per round (multi-token windows amortise the host↔device
        # roundtrip; capacity is reserved for the whole window up front).
        # Scheduling reads *through* in-flight work (pending_*): a window
        # can be planned before the previous one lands, with the input
        # token fed from the device ring (run-ahead pipelining).
        window = self.spec_plan_window or max(1, self.config.decode_steps)
        if self.config.block_lookahead:
            # SYNCHRONISED lookahead: when any running seq's runway drops
            # below half the lookahead, top up EVERY running seq to the
            # full lookahead in the same round — growth then lands in ONE
            # device-state delta (2 uploads) per cycle instead of one
            # per seq per round (the uploads are the serving bottleneck
            # on remote-PJRT, ~15 ms of serial channel time each)
            la = self.config.block_lookahead * bs
            trigger = False
            for seq in self.running:
                if seq.status is not SeqStatus.RUNNING:
                    continue
                base = (seq.num_computed + seq.pending_prompt
                        + seq.pending_decode)
                if base >= self.config.max_model_len:
                    continue
                if len(seq.block_table) * bs - base < max(window, la // 2):
                    trigger = True
                    break
            if trigger:
                for seq in self.running:
                    if seq.status is not SeqStatus.RUNNING:
                        continue
                    base = (seq.num_computed + seq.pending_prompt
                            + seq.pending_decode)
                    tgt = min(base + window - 1 + la,
                              self.config.max_model_len - 1)
                    while (len(seq.block_table) * bs <= tgt
                           and self._can_allocate(1)):
                        bid = self.pool.allocate()
                        if bid is None:
                            break
                        seq.block_table.append(bid)
        for seq in list(self.running):
            if budget <= 0:
                break
            if seq.status is not SeqStatus.RUNNING:
                continue  # preempted by an earlier seq's _ensure_slot
            base = seq.num_computed + seq.pending_prompt + seq.pending_decode
            quota = seq.max_tokens - (
                len(seq.output_ids) + seq.pending_first + seq.pending_decode
            )
            accepted = min(window, quota, self.config.max_model_len - base)
            if accepted <= 0:
                continue  # a length-finish is landing; nothing to add
            if seq.slot < 0:
                if not self._free_slots:
                    continue  # all slots zombie-held; retry after reaping
                seq.slot = self._free_slots.popleft()
            if not self._ensure_slot(seq, base + accepted - 1, batch):
                continue  # seq was preempted (or is pinned by pendings)
            tok_src = 1 if (seq.pending_first or seq.pending_decode) else 0
            tok_host = 0 if tok_src else seq.all_tokens()[base]
            batch.decode_rows.append(DecodeRow(
                seq=seq, base=base, accepted=accepted,
                tok_host=tok_host, tok_src=tok_src, slot=seq.slot,
            ))
            seq.pending_decode += accepted
            budget -= 1

        # 2. chunked prefill from the waiting queue, FIFO.  A prefill that
        # completed admission already moved into self.running, so only count
        # in-flight prefills that are NOT yet running to avoid double-counting
        def active_seqs() -> int:
            running_ids = {s.seq_id for s in self.running}
            return len(self.running) + len(
                {c.seq.seq_id for c in batch.prefills} - running_ids
            )

        while (self.waiting and budget > 0
               and active_seqs() < self.config.max_num_seqs):
            seq = self.waiting[0]
            if seq.status == SeqStatus.WAITING:
                self._match_prefix(seq)
                seq.status = SeqStatus.PREFILL
            if seq.slot < 0:
                if not self._free_slots:
                    break  # all slots zombie-held; admit after reaping
                seq.slot = self._free_slots.popleft()
            target = seq.total_tokens  # prompt (+ outputs when recomputing)
            # schedule *through* chunks still in flight (pipelined prefill)
            start = seq.num_computed + seq.pending_prompt
            remaining = target - start
            sp_thresh = self.config.sp_prefill_threshold
            sp_intent = (self.sp_enabled and sp_thresh
                         and start == 0
                         and remaining >= sp_thresh)
            if sp_intent:
                # sequence-parallel prefill: the whole fresh prompt goes as
                # one chunk (the engine shards its T axis over the mesh);
                # it may exceed the per-step token budget by design
                chunk = remaining
            else:
                # chunk ≤ budget, so a partial chunk always exhausts the
                # budget and the loop cannot schedule a token range twice.
                # Also never exceed the largest compiled prefill bucket —
                # that lets max_num_batched_tokens run past the bucket so
                # decode seats don't force prompt splits (a 512 prompt
                # split 448+64 costs a full extra dispatch + uploads).
                max_bucket = max(self.config.prefill_buckets)
                eff_cap = max_bucket
                pct = self.config.prefill_chunk_tokens
                if pct > 0:
                    # chunked prefill: slice long prompts into pct-token
                    # chunks interleaved with running decodes, instead of
                    # one whole-prompt stall. Never below a block so chunk
                    # boundaries can't strand a partial block's worth of
                    # budget forever.
                    eff_cap = min(max_bucket, max(pct, bs))
                    if self.prefill_ladder is not None:
                        # snap to the largest live rung ≤ cap: every chunk
                        # pads up to a compiled bucket, so an off-grid cap
                        # burns (bucket - cap) tokens per dispatch
                        rung = self.prefill_ladder.rung_at_most(eff_cap)
                        if rung is not None and rung >= bs:
                            eff_cap = rung
                chunk = min(budget, remaining, eff_cap)
                if (chunk < remaining and chunk < eff_cap
                        and batch.prefills):
                    # fragment caused by earlier prefills eating the
                    # budget: the tail would cost a whole extra dispatch
                    # (padded to a full bucket) — defer this prompt to
                    # the next round, which grants a fresh budget. The
                    # FIRST prefill of a batch never defers, so budget-
                    # limited chunked prefill still makes progress.
                    break
            # blocks needed to hold [start, start + chunk)
            have = len(seq.block_table)
            need = (start + chunk + bs - 1) // bs - have
            if not self._can_allocate(need):
                # shrink the chunk to what fits above the watermark
                chunk = self._max_affordable_chunk(seq, chunk, start)
                if sp_intent and chunk < remaining:
                    # can't host the full prompt → it can't ring; fall back
                    # to budgeted chunking rather than a giant dense chunk
                    chunk = min(budget, chunk)
                if chunk <= 0:
                    break  # pool exhausted; try again next step
                need = (start + chunk + bs - 1) // bs - have
            ok = True
            for _ in range(need):
                bid = self.pool.allocate()
                if bid is None:
                    ok = False
                    break
                seq.block_table.append(bid)
            if not ok:
                break
            final = start + chunk >= target
            if seq.t_scheduled is None:
                seq.t_scheduled = time.monotonic()
            batch.prefills.append(
                PrefillChunk(seq=seq, start=start, length=chunk,
                             final=final)
            )
            seq.pending_prompt += chunk
            budget -= chunk
            if final:
                seq.pending_first = 1
                self.waiting.popleft()
                self.running.append(seq)
                seq.status = SeqStatus.RUNNING

        self._refresh_stats()
        return batch

    # -- post-step bookkeeping (called by the engine executor) --

    @hot_path
    def on_prefill_executed(self, chunk: PrefillChunk,
                            sampled: Optional[int]) -> None:
        seq = chunk.seq
        seq.num_computed += chunk.length
        seq.pending_prompt = max(0, seq.pending_prompt - chunk.length)
        self._seal_complete_blocks(seq)
        if chunk.final and sampled is not None:
            seq.pending_first = 0
            self._append_token(seq, sampled)

    @hot_path
    def on_decode_executed(self, seq: SchedSeq, sampled: int) -> None:
        seq.num_computed += 1
        seq.pending_decode = max(0, seq.pending_decode - 1)
        self._seal_complete_blocks(seq)
        self._append_token(seq, sampled)

    def on_tokens_discarded(self, seq: SchedSeq, n: int,
                            first: bool = False, prompt: int = 0) -> None:
        """A landed window carried ``n`` decode tokens (plus optionally a
        prefill chunk / the prompt-completing sample) that were NOT
        applied — the seq finished or was aborted mid-flight. Clears their
        pendings and reaps the seq once nothing references its blocks/slot
        anymore."""
        if n:
            seq.pending_decode = max(0, seq.pending_decode - n)
        if prompt:
            seq.pending_prompt = max(0, seq.pending_prompt - prompt)
        if first:
            seq.pending_first = 0
        if (seq.status == SeqStatus.FINISHED and seq.pending_total == 0
                and seq in self.zombies):
            self.reap(seq)

    def reap(self, seq: SchedSeq) -> None:
        """Release a finished seq's blocks and ring slot once no in-flight
        window can touch them."""
        if seq in self.zombies:
            self.zombies.remove(seq)
        if not seq.hold_blocks:
            self._release_blocks(seq)
        self._free_slot(seq)
        self._refresh_stats()

    def finish(self, seq: SchedSeq, reason: str) -> None:
        self._finish(seq, reason)

    def check_stop(self, seq: SchedSeq) -> Optional[str]:
        if not seq.output_ids:
            return None
        last = seq.output_ids[-1]
        if last in seq.eos_token_ids:
            return "stop"
        if len(seq.output_ids) >= seq.max_tokens:
            return "length"
        if seq.total_tokens >= self.config.max_model_len:
            return "length"
        return None

    # -- internals --

    @hot_path
    def _append_token(self, seq: SchedSeq, token: int) -> None:
        seq.output_ids.append(token)
        assert seq.token_seq is not None
        seq.token_seq.append(token)

    def _seal_complete_blocks(self, seq: SchedSeq) -> None:
        """Seal blocks whose KV is fully computed AND content-complete."""
        assert seq.token_seq is not None
        bs = self.config.block_size
        computed_blocks = seq.num_computed // bs
        sealable = min(computed_blocks, len(seq.token_seq.blocks))
        for i in range(seq.num_sealed_blocks, sealable):
            tb = seq.token_seq.blocks[i]
            self.pool.seal(
                seq.block_table[i], tb.sequence_hash, tb.block_hash,
                tb.parent_sequence_hash,
            )
        seq.num_sealed_blocks = max(seq.num_sealed_blocks, sealable)

    def _match_prefix(self, seq: SchedSeq) -> None:
        """Prefix-cache lookup at admission (chained sequence hashes)."""
        if not self.config.enable_prefix_caching or seq.num_computed:
            return
        assert seq.token_seq is not None
        bs = self.config.block_size
        # leave at least one token to compute so the step produces logits
        max_match = (seq.total_tokens - 1) // bs
        matched: List[int] = []
        queried_hashes: List[int] = []
        matched_hashes: List[int] = []
        for i, tb in enumerate(seq.token_seq.blocks[:max_match]):
            self.stats.prefix_cache_queries += 1
            queried_hashes.append(tb.sequence_hash)
            bid = self.pool.lookup(tb.sequence_hash)
            if bid is None:
                break
            self.stats.prefix_cache_hits += 1
            matched.append(bid)
            matched_hashes.append(tb.sequence_hash)
        seq.block_table = matched
        seq.num_computed = len(matched) * bs
        seq.num_sealed_blocks = len(matched)
        if self.on_prefix_match is not None:
            self.on_prefix_match(queried_hashes, matched_hashes)

    def _ensure_slot(self, seq: SchedSeq, position: int,
                     batch: ScheduledBatch) -> bool:
        """Make sure a physical slot exists for ``position``; preempt the
        lowest-priority sequence (LIFO) when the pool is dry."""
        bs = self.config.block_size
        needed_blocks = position // bs + 1
        while len(seq.block_table) < needed_blocks:
            bid = self.pool.allocate()
            if bid is not None:
                seq.block_table.append(bid)
                continue
            victim = self._pick_victim(seq)
            if victim is None or victim is seq:
                if seq.pending_total > 0:
                    # in-flight windows still scatter into this seq's
                    # blocks — recompute-preemption would corrupt them.
                    # Skip this round; landing windows free capacity.
                    return False
                self._preempt(seq, batch)
                return False
            # victims always have pending_total == 0, so they can never be
            # in this batch's decode rows (rows set pending_decode at
            # planning time) — no batch cleanup needed
            self._preempt(victim, batch)
        return True

    def _pick_victim(self, requester: SchedSeq) -> Optional[SchedSeq]:
        # LIFO, but a seq with in-flight windows is unpreemptible: freeing
        # its blocks while a dispatched window scatters into them corrupts
        # whichever seq the pool hands them to next. EVACUATING seats are
        # likewise pinned: a transfer is reading their blocks.
        for cand in reversed(self.running):
            if cand is requester:
                continue
            if cand.status is not SeqStatus.RUNNING:
                continue
            if cand.pending_total == 0:
                return cand
        return None

    def preempt_recompute(self, seq: SchedSeq) -> int:
        """Preempt a quiesced seq back to the waiting queue: release its
        blocks and slot, reset computed state so admission re-prefills the
        full token history (prompt + outputs, byte-identical continuation).
        Returns the autopilot slot the seq held — the engine must mark it
        dead before the blocks recycle. Public entry for the stall
        watchdog and the HBM-pressure ladder."""
        assert seq.pending_total == 0, "preempting a seq with inflight work"
        log.info("preempting seq %s (recompute)", seq.seq_id)
        # the engine must kill the device autopilot seat before these
        # blocks recycle — preempted_slot carries the slot it held
        seq.preempted_slot = seq.slot
        slot = seq.slot
        self._release_blocks(seq)
        self._free_slot(seq)
        seq.num_computed = 0
        seq.num_sealed_blocks = 0
        seq.preemptions += 1
        seq.status = SeqStatus.WAITING
        if seq in self.running:
            self.running.remove(seq)
        # a mid-prefill seq (non-final chunk) never left the waiting deque;
        # re-adding it would double-schedule the prompt
        if seq not in self.waiting:
            self.waiting.appendleft(seq)
        return slot

    def _preempt(self, seq: SchedSeq, batch: ScheduledBatch) -> None:
        self.preempt_recompute(seq)
        batch.preempted.append(seq)

    def _release_blocks(self, seq: SchedSeq) -> None:
        for bid in seq.block_table:
            self.pool.decref(bid)
        seq.block_table = []

    def _free_slot(self, seq: SchedSeq) -> None:
        if seq.slot >= 0:
            self._free_slots.append(seq.slot)
            seq.slot = -1

    def _finish(self, seq: SchedSeq, reason: str) -> None:
        seq.status = SeqStatus.FINISHED
        seq.finish_reason = reason
        if seq in self.running:
            self.running.remove(seq)
        if seq in self.waiting:
            self.waiting.remove(seq)
        if seq.pending_total > 0:
            # in-flight windows still scatter into these blocks; the engine
            # reaps via on_tokens_discarded once they land
            if seq not in self.zombies:
                self.zombies.append(seq)
        else:
            if not seq.hold_blocks:
                self._release_blocks(seq)
            self._free_slot(seq)
        self._refresh_stats()

    def release_held(self, seq: SchedSeq) -> None:
        """Free a finished hold_blocks sequence after KV extraction."""
        self._release_blocks(seq)
        self._refresh_stats()

    # -- disagg decode-side admission (remote prefill) --

    def reserve(self, seq: SchedSeq) -> bool:
        """Pre-allocate blocks covering the prompt for KV injection
        (the decode side of disagg: the reference decode worker's engine
        pre-allocates blocks NIXL writes into, ref: disagg_serving.md
        §Efficient KV Transfer). Returns False (no side effects) when the
        pool can't cover it above the watermark."""
        seq.token_seq = TokenBlockSequence.from_tokens(
            seq.prompt_ids, self.config.block_size
        )
        bs = self.config.block_size
        need = (seq.prompt_len + bs - 1) // bs
        if not self._can_allocate(need):
            return False
        for _ in range(need):
            bid = self.pool.allocate()
            if bid is None:  # watermark said yes but pool is fragmented-dry
                self._release_blocks(seq)
                return False
            seq.block_table.append(bid)
        return True

    def admit_prefilled(self, seq: SchedSeq, first_token: int) -> None:
        """Activate a reserved sequence whose prompt KV was injected and
        whose first token was sampled remotely: seal prefix blocks (emitting
        stored events — this worker now owns those blocks) and enter the
        decode loop."""
        seq.num_computed = seq.prompt_len
        if seq.t_scheduled is None:
            # remote prefill: activation is the first scheduling event
            seq.t_scheduled = time.monotonic()
        self._seal_complete_blocks(seq)
        self._append_token(seq, first_token)
        seq.status = SeqStatus.RUNNING
        self.running.append(seq)
        self._refresh_stats()

    def _can_allocate(self, need: int) -> bool:
        watermark_blocks = self.config.watermark * (self.config.num_blocks - 1)
        return self.pool.num_free - need >= watermark_blocks

    def _max_affordable_chunk(self, seq: SchedSeq, want: int,
                              start: Optional[int] = None) -> int:
        bs = self.config.block_size
        watermark_blocks = int(
            self.config.watermark * (self.config.num_blocks - 1)
        )
        affordable = self.pool.num_free - watermark_blocks
        if affordable <= 0:
            return 0
        if start is None:
            start = seq.num_computed + seq.pending_prompt
        have_capacity = len(seq.block_table) * bs - start
        return min(want, have_capacity + affordable * bs)

    def _refresh_stats(self) -> None:
        self.stats.num_running = len(self.running)
        self.stats.num_waiting = len(self.waiting)
        self.stats.kv_usage = self.pool.usage
