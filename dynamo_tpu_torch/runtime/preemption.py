"""Preemption-tolerant serving: maintenance-notice KV evacuation.

TPU slices are reclaimed with notice (maintenance events, spot preemption,
autoscaler scale-downs). A worker that simply dies forfeits every in-flight
seat's KV — each interrupted request pays a full re-prefill somewhere else.
This module turns a notice into an **evacuating drain**:

1. A maintenance notice arrives (``SIGUSR1``, ``POST /preempt`` on the
   system server, or a direct :meth:`PreemptionCoordinator.notice` call).
2. Every decoding seat is journaled (prompt, emitted tokens, sampling
   state, KV progress) in a :class:`SeatJournal` ring — the record alone
   is enough to resume the request byte-identically anywhere, so even a
   botched hand-off degrades to Migration-style recompute, never to a
   dropped request.
3. Seats are parked (``SeqStatus.EVACUATING``: no new windows, blocks
   pinned), quiesced, and their KV is streamed to a peer decode worker
   over the device plane into an epoch-guarded reservation — the receiver
   continues mid-stream from the journaled sampling position. With no
   peer available, sealed blocks spill to the kvbm host pool (and the
   store remote tier when configured) so the re-admitted request's
   prefill is served from cache instead of recomputed.
4. The planner hears about the notice (a ``preemption`` planner event) and
   treats it as a proactive scale signal, compensating capacity before
   the dying worker drops out of the fleet.

Fault seams (``runtime.faults``): ``preempt.notice`` (``drop`` = notice
lost, the kill lands cold) and ``preempt.evacuate`` (``drop`` = a seat's
hand-off fails → journal fallback; ``delay`` = slow evacuation racing the
deadline). The chaos storms in ``mocker.cluster`` drive both.

A copy of ``dynamo_tpu.runtime.preemption`` on this package's engine and
device plane. Its host spill keeps the JAX package's behaviour to the byte:
only the ``"k"``/``"v"`` pages of each sealed block go to the host pool,
so a quantized seat's scales are left behind there too (ROADMAP.md records
what that does at onboarding in both packages).
"""

from __future__ import annotations

import asyncio
import signal as _signal
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils.logging import get_logger
from . import faults
from .tasks import spawn_logged

log = get_logger("preemption")

PEER = "peer"            # KV streamed to a peer reservation
SPILL = "spill"          # sealed blocks spilled to the host/remote tier
FALLBACK = "fallback"    # journal-only: resume is a full re-prefill
FINISHED = "finished"    # seat completed naturally while quiescing


@dataclass
class SeatRecord:
    """Everything needed to resume one seat byte-identically elsewhere.

    ``num_computed`` is the KV frontier at quiesce time: tokens before it
    have KV on the source device; ``all_tokens()[num_computed]`` is the
    first token the receiver re-emits. Sampling is keyed on (seed,
    absolute position), so carrying the seed reproduces the tail exactly
    whether the KV moved or the receiver re-prefills from the record.
    """

    seq_id: str
    prompt_ids: List[int]
    output_ids: List[int]
    num_computed: int
    max_tokens: int
    temperature: float
    top_k: int
    top_p: float
    seed: int                       # device-range seed (-1 = unseeded)
    eos_token_ids: Tuple[int, ...]
    generation: int = 0             # times this seat has been evacuated
    spec_drafted: int = 0
    spec_accepted: int = 0

    @classmethod
    def from_seq(cls, seq, generation: int = 0) -> "SeatRecord":
        return cls(
            seq_id=seq.seq_id,
            prompt_ids=list(seq.prompt_ids),
            output_ids=list(seq.output_ids),
            num_computed=seq.num_computed,
            max_tokens=seq.max_tokens,
            temperature=seq.temperature,
            top_k=seq.top_k,
            top_p=seq.top_p,
            seed=seq.seed,
            eos_token_ids=tuple(seq.eos_token_ids),
            generation=generation,
        )

    @property
    def all_tokens(self) -> List[int]:
        return list(self.prompt_ids) + list(self.output_ids)

    def _wire_sampling(self) -> dict:
        return {
            "temperature": self.temperature,
            "top_k": self.top_k,
            "top_p": self.top_p,
            "seed": None if self.seed < 0 else self.seed,
            "eos_token_ids": tuple(self.eos_token_ids),
            "ignore_eos": not self.eos_token_ids,
        }

    def peer_request(self):
        """Request for the receiving worker's epoch-guarded reservation:
        the computed prefix rides as prompt (its KV arrives by transfer),
        the budget covers the re-emitted splice token plus the remainder."""
        from ..engine.engine import Request

        total = len(self.prompt_ids) + len(self.output_ids)
        remaining = self.max_tokens - len(self.output_ids)
        return Request(
            request_id=self.seq_id,
            token_ids=self.all_tokens[: self.num_computed],
            max_tokens=max(1, remaining + (total - self.num_computed)),
            **self._wire_sampling(),
        )

    def first_token(self) -> int:
        """The token sampled at the KV frontier — the receiver's index-0
        (re-emitted) output."""
        return self.all_tokens[self.num_computed]

    def resume_request(self):
        """Migration-style resume on ANY worker: the full emitted history
        becomes the prompt (a kvbm-attached engine serves the spilled
        blocks as prefix hits), budget shrinks by what was delivered."""
        from ..engine.engine import Request

        return Request(
            request_id=self.seq_id,
            token_ids=self.all_tokens,
            max_tokens=max(1, self.max_tokens - len(self.output_ids)),
            **self._wire_sampling(),
        )


class SeatJournal:
    """Bounded ring of :class:`SeatRecord` keyed by seq id. The cap bounds
    host memory when storms journal faster than resumes consume; the
    oldest record is the one a live resume is least likely to still need."""

    def __init__(self, cap: int = 256):
        self.cap = max(1, cap)
        self._records: Dict[str, SeatRecord] = {}
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._records)

    def record(self, seq, generation: int = 0) -> SeatRecord:
        prev = self._records.get(seq.seq_id)
        if prev is not None:
            generation = max(generation, prev.generation + 1)
        rec = SeatRecord.from_seq(seq, generation=generation)
        self._records.pop(seq.seq_id, None)
        self._records[seq.seq_id] = rec
        while len(self._records) > self.cap:
            oldest = next(iter(self._records))
            del self._records[oldest]
            self.evictions += 1
        return rec

    def pop(self, seq_id: str) -> Optional[SeatRecord]:
        return self._records.pop(seq_id, None)

    def get(self, seq_id: str) -> Optional[SeatRecord]:
        return self._records.get(seq_id)


@dataclass
class EvacResult:
    """One seat's evacuation outcome. ``PEER`` results carry the live
    reservation — stream the continuation with
    ``peer.resume_prefilled(dst_seq, record → first_token)``; every other
    mode resumes from ``record.resume_request()``."""

    record: SeatRecord
    mode: str
    dst_seq: Any = None
    bytes_moved: int = 0


@dataclass
class PreemptionReport:
    notice_lost: bool = False
    deadline_blown: bool = False
    results: List[EvacResult] = field(default_factory=list)

    def count(self, mode: str) -> int:
        return sum(1 for r in self.results if r.mode == mode)


class PreemptionCoordinator:
    """Maintenance-notice listener + evacuating drain for one engine.

    ``peer`` is a co-resident decode engine to receive KV (the launcher's
    P/D pairs, or the chaos harness's second engine); ``host_pool`` /
    ``remote`` are the no-peer spill tiers (default: the engine's attached
    kvbm manager's, when present). ``on_event`` receives the planner-bound
    ``preemption`` event dict.
    """

    def __init__(
        self,
        engine,
        *,
        worker_key: str = "worker",
        peer=None,
        plane=None,
        host_pool=None,
        remote=None,
        notice_grace_s: float = 2.0,
        evac_deadline_s: float = 30.0,
        journal_cap: int = 256,
        on_event: Optional[Callable[[dict], None]] = None,
    ):
        self.engine = engine
        self.worker_key = worker_key
        self.peer = peer
        self.plane = plane
        self._host_pool = host_pool
        self._remote = remote
        self.notice_grace_s = notice_grace_s
        self.evac_deadline_s = evac_deadline_s
        self.journal = SeatJournal(journal_cap)
        self.on_event = on_event
        self.num_notices = 0
        self.num_evacuated = 0
        self.num_spilled = 0
        self.num_fallbacks = 0
        self._noticed = False

    # ------------------------- notice entry ----------------------------

    async def notice(self, reason: str = "maintenance") -> PreemptionReport:
        """Handle a maintenance notice: journal + grace + evacuate.

        Idempotent per process lifetime — a second notice while the first
        drain runs (or after it) returns an empty report instead of
        double-evacuating."""
        report = PreemptionReport()
        rule = faults.active("preempt.notice", self.worker_key)
        if rule is not None and rule.kind == faults.DROP:
            # the notice never reached us: the kill will land cold and
            # recovery rides the journal/migration path alone
            log.warning("maintenance notice LOST (fault injection)")
            report.notice_lost = True
            return report
        if self._noticed:
            return report
        self._noticed = True
        self.num_notices += 1
        seats = self.engine.evacuable_seats()
        log.warning(
            "maintenance notice (%s): %d evacuable seats, grace %.1fs, "
            "deadline %.1fs", reason, len(seats), self.notice_grace_s,
            self.evac_deadline_s,
        )
        if self.on_event is not None:
            try:  # proactive scale signal for the planner
                self.on_event({
                    "kind": "preemption",
                    "worker": self.worker_key,
                    "reason": reason,
                    "seats": len(seats),
                })
            except Exception:
                log.exception("preemption planner event failed")
        # journal BEFORE the grace wait: if the kill beats the deadline,
        # the records already hold everything a cold resume needs
        for seq in seats:
            self.journal.record(seq)
        if self.notice_grace_s > 0:
            await asyncio.sleep(self.notice_grace_s)
        await self.evacuate(report)
        return report

    # --------------------------- evacuation ----------------------------

    async def evacuate(
        self, report: Optional[PreemptionReport] = None
    ) -> PreemptionReport:
        """Evacuate every evacuable seat within ``evac_deadline_s``. Seats
        the deadline cuts off are finished locally on their journal record
        (mode ``FALLBACK``) — bounded wait, nothing leaks."""
        report = report or PreemptionReport()
        deadline = time.monotonic() + self.evac_deadline_s
        for seq in self.engine.evacuable_seats():
            budget = deadline - time.monotonic()
            if budget <= 0:
                report.deadline_blown = True
                report.results.append(self._fallback(seq))
                continue
            try:
                res = await asyncio.wait_for(
                    self._evacuate_seat(seq), timeout=budget
                )
            except asyncio.TimeoutError:
                report.deadline_blown = True
                res = self._fallback(seq)
            except Exception:
                log.exception("evacuating seat %s failed", seq.seq_id)
                res = self._fallback(seq)
            report.results.append(res)
        log.info(
            "evacuation done: %d peer, %d spill, %d fallback, %d finished",
            report.count(PEER), report.count(SPILL),
            report.count(FALLBACK), report.count(FINISHED),
        )
        return report

    async def _evacuate_seat(self, seq) -> EvacResult:
        parked = self.engine.park_for_evacuation(seq.seq_id)
        if parked is None:
            # raced a natural finish (or an abort) — the journal record
            # is stale; whatever happened already flushed to the client
            return EvacResult(record=self.journal.record(seq), mode=FINISHED)
        if not await self.engine.wait_quiesced(seq):
            self.engine.unpark(seq)
            raise RuntimeError(f"seat {seq.seq_id} never quiesced")
        if seq.status.name == "FINISHED":
            # an inflight window landed the seat's final token while we
            # quiesced: its blocks are already freed, nothing to move
            return EvacResult(record=self.journal.record(seq),
                              mode=FINISHED)
        # re-journal at the quiesced frontier: num_computed is now stable
        # and output_ids include every token that will reach the client
        rec = self.journal.record(seq)
        rule = faults.active("preempt.evacuate", seq.seq_id)
        if rule is not None:
            if rule.kind == faults.DROP:
                log.warning("evacuation of %s dropped (fault injection)",
                            seq.seq_id)
                return self._fallback(seq)
            await faults.maybe_delay(rule)
        if self.peer is not None:
            res = await self._to_peer(seq, rec)
            if res is not None:
                return res
        if self._spill_pool() is not None:
            res = await self._to_host(seq, rec)
            if res is not None:
                return res
        return self._fallback(seq)

    async def _to_peer(self, seq, rec: SeatRecord) -> Optional[EvacResult]:
        """Stream the seat's KV into an epoch-guarded peer reservation."""
        dst_seq = self.peer.reserve_sequence(rec.peer_request())
        if dst_seq is None:
            log.warning("peer pool cannot host seat %s — spilling",
                        seq.seq_id)
            return None
        try:
            from ..disagg.ici import DevicePlane, multi_rank

            nb = len(dst_seq.block_table)
            if multi_rank(self.engine) or multi_rank(self.peer):
                # a rank of a world moves KV only through its extract /
                # inject, whose plans bring every rank in: host-staged,
                # never the device plane
                data = await self.engine.extract_kv_blocks(
                    list(seq.block_table[:nb]))
                await self.peer.inject_kv_blocks(
                    list(dst_seq.block_table), data,
                    seq_id=dst_seq.seq_id, epoch=dst_seq.kv_epoch)
                moved = sum(a.numel() * a.element_size()
                            for a in data.values())
            else:
                plane = self.plane
                if plane is None:
                    plane = self.plane = DevicePlane()
                moved = await plane.transfer(
                    self.engine, list(seq.block_table[:nb]),
                    self.peer, list(dst_seq.block_table),
                    dst_seq_id=dst_seq.seq_id, dst_epoch=dst_seq.kv_epoch,
                )
        except asyncio.CancelledError:
            # deadline cancelled us mid-transfer: the reservation must not
            # outlive the attempt or it leaks on the receiver
            self.peer.cancel_reservation(dst_seq)
            raise
        except Exception:
            log.exception("device transfer for seat %s failed", seq.seq_id)
            self.peer.cancel_reservation(dst_seq)
            return None
        self.engine.finish_evacuated(seq)
        self.num_evacuated += 1
        return EvacResult(record=rec, mode=PEER, dst_seq=dst_seq,
                          bytes_moved=moved)

    async def _to_host(self, seq, rec: SeatRecord) -> Optional[EvacResult]:
        """No peer: spill the seat's sealed blocks to the host pool (and
        the remote tier), so the resume's prefill is mostly cache hits."""
        pool = self._spill_pool()
        bs = self.engine.config.block_size
        nsealed = min(seq.num_computed // bs, len(seq.block_table))
        if seq.token_seq is not None:
            nsealed = min(nsealed, len(seq.token_seq.blocks))
        if nsealed == 0 or seq.token_seq is None:
            return None
        try:
            data = await self.engine.extract_kv_blocks(
                list(seq.block_table[:nsealed])
            )
        except Exception:
            log.exception("KV extract for seat %s failed", seq.seq_id)
            return None
        import torch

        moved = 0
        for i in range(nsealed):
            block = {
                "k": data["k"][:, i].clone(
                    memory_format=torch.contiguous_format),
                "v": data["v"][:, i].clone(
                    memory_format=torch.contiguous_format),
            }
            moved += block["k"].nbytes + block["v"].nbytes
            h = seq.token_seq.blocks[i].sequence_hash
            pool.put(h, block)
            if self._remote is not None:
                try:
                    await self._remote.put(h, block)
                except Exception:
                    log.exception("remote spill failed for %x", h)
        self.engine.finish_evacuated(seq)
        self.num_spilled += 1
        return EvacResult(record=rec, mode=SPILL, bytes_moved=moved)

    def _fallback(self, seq) -> EvacResult:
        """Hand-off failed or out of time: close the seat locally; the
        journal record alone resumes it (full re-prefill) elsewhere."""
        rec = self.journal.get(seq.seq_id) or self.journal.record(seq)
        self.engine.unpark(seq)  # no-op unless parked
        self.engine.finish_evacuated(seq)
        self.num_fallbacks += 1
        return EvacResult(record=rec, mode=FALLBACK)

    def _spill_pool(self):
        if self._host_pool is not None:
            return self._host_pool
        kvbm = getattr(self.engine, "kvbm", None)
        if kvbm is not None:
            if self._remote is None:
                self._remote = kvbm.remote
            return kvbm.host_pool
        return None


def install_preemption_signal(
    coordinator: PreemptionCoordinator,
    *,
    loop: Optional[asyncio.AbstractEventLoop] = None,
    sig: int = _signal.SIGUSR1,
    then: Optional[Callable[[], None]] = None,
) -> None:
    """Wire the cloud maintenance notice (delivered as ``SIGUSR1`` by the
    node agent) to the coordinator. SIGTERM stays with
    ``runtime.signals`` — termination is a drain, a notice is a move.
    ``then`` runs after the evacuation settles (serving chains the
    graceful drain there: evacuate first, then leave)."""
    loop = loop or asyncio.get_running_loop()

    async def _notice() -> None:
        await coordinator.notice("signal")
        if then is not None:
            then()

    loop.add_signal_handler(
        sig, lambda: spawn_logged(_notice(), name="preempt-notice")
    )
