"""Radix-tree prefix index over the tiered KV cache.

The global prefix cache's source of truth: WHICH prefix blocks exist,
WHICH tier holds each one (G1 device HBM pages, G2 byte-bounded host
pool, G4 store remote tier), and on WHICH worker. The engine-side
:class:`~dynamo_tpu.prefix.manager.PrefixCacheManager` feeds it from
pool/kvbm events; the router feeds a cluster-wide replica from
``RouterEvent`` streams and scores workers by longest cached prefix.

Keying (why this is a radix tree without storing token edges): block
keys are the *chained* sequence hashes from ``tokens.py`` —
``xxh3_64(parent_seq_hash || token_bytes)`` — so equal keys imply equal
full prefixes and a node's key doubles as its path digest. Edges are
just ``parent seq_hash -> child seq_hash`` links; a divergent
continuation of a shared prefix inserts a new child under the shared
parent, which is the radix split without ever copying the shared run.
Only complete blocks are hashed (``compute_block_hashes_for_seq``
ignores the ragged tail), so partial trailing blocks can never be
indexed — the block-aligned boundary invariant the tests pin.

Recency uses a logical clock (monotone per-index counter), never wall
time, so eviction order is a pure function of the operation sequence —
seeded churn schedules replay deterministically.

A copy of ``dynamo_tpu.prefix.radix``: the KV router's cluster replica fed
by ``RouterEvent`` streams, and the engine-side index of
``prefix/manager.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

TIER_G1 = "g1"   # device HBM paged cache (the engine's BlockPool)
TIER_G2 = "g2"   # host LRU pool (block- and byte-bounded)
TIER_G4 = "g4"   # cluster-shared store remote tier
TIERS = (TIER_G1, TIER_G2, TIER_G4)

# Routing score weight per tier: a G1 hit serves immediately; G2/G4 hits
# save the prefill FLOPs but pay an onboard copy, so they count for less
# when ranking workers by longest cached prefix.
DEFAULT_TIER_WEIGHTS = {TIER_G1: 1.0, TIER_G2: 0.75, TIER_G4: 0.5}


@dataclass
class RadixNode:
    """One complete prefix block. ``seq_hash`` is both the node key and
    the prefix digest of its whole root path (chained hashing)."""

    seq_hash: int
    block_hash: int
    parent: Optional[int]
    depth: int                       # blocks from the root (>= 1)
    children: Set[int] = field(default_factory=set)
    # tier -> workers holding this block in that tier
    holders: Dict[str, Set[int]] = field(
        default_factory=lambda: {t: set() for t in TIERS})
    last_use: int = 0                # logical clock, not wall time

    def workers(self, tier: Optional[str] = None) -> Set[int]:
        if tier is not None:
            return self.holders[tier]
        out: Set[int] = set()
        for ws in self.holders.values():
            out |= ws
        return out

    def empty(self) -> bool:
        return not any(self.holders.values())


@dataclass
class PrefixMatch:
    """Longest-leading-run match for one request's hash chain."""

    blocks: int = 0                  # matched leading complete blocks
    nodes: List[RadixNode] = field(default_factory=list)
    # per-worker weighted score over that worker's own leading run
    scores: Dict[int, float] = field(default_factory=dict)
    # per-worker unweighted leading blocks (any tier on that worker)
    worker_blocks: Dict[int, int] = field(default_factory=dict)


class RadixPrefixIndex:
    """Block-aligned radix prefix index with per-node tier/worker state.

    Deterministic by construction: insertion order only affects logical
    clock values, and every tie in eviction breaks on ``seq_hash`` — the
    same operation sequence always evicts the same subtrees.
    """

    def __init__(self, block_size: int,
                 tier_weights: Optional[Dict[str, float]] = None):
        if block_size <= 0:
            raise ValueError("block_size must be positive")
        self.block_size = block_size
        self.tier_weights = dict(tier_weights or DEFAULT_TIER_WEIGHTS)
        self._nodes: Dict[int, RadixNode] = {}
        self._roots: Set[int] = set()
        # children inserted before their parent, keyed by the missing
        # parent hash — adopted when the parent arrives
        self._orphans: Dict[int, Set[int]] = {}
        self._clock = 0
        # accounting the replay scoreboard cross-checks against the
        # scheduler's own measured hit counters (prefix_vs_index)
        self.hit_tokens_total = 0
        self.queries_total = 0
        self.evictions_total = 0
        self.inserted_total = 0

    def __len__(self) -> int:
        return len(self._nodes)

    def __contains__(self, seq_hash: int) -> bool:
        return seq_hash in self._nodes

    def get(self, seq_hash: int) -> Optional[RadixNode]:
        return self._nodes.get(seq_hash)

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # ------------------------------ insert -----------------------------

    def insert(self, seq_hash: int, block_hash: int,
               parent: Optional[int], tier: str, worker: int) -> RadixNode:
        """Index one sealed block for ``worker`` in ``tier``.

        The radix split is implicit: a continuation diverging after a
        shared run adds a child under the shared parent node; the shared
        nodes are reused, never copied. A parent evicted from the index
        leaves the child as a detached root (depth restarts) — matching
        still works because lookups walk the request's own hash chain.
        """
        if tier not in TIERS:
            raise ValueError(f"unknown tier {tier!r}")
        node = self._nodes.get(seq_hash)
        if node is None:
            pnode = self._nodes.get(parent) if parent is not None else None
            node = RadixNode(
                seq_hash=seq_hash, block_hash=block_hash, parent=parent,
                depth=(pnode.depth + 1) if pnode is not None else 1,
            )
            self._nodes[seq_hash] = node
            if pnode is not None:
                pnode.children.add(seq_hash)
            else:
                self._roots.add(seq_hash)
                if parent is not None:
                    self._orphans.setdefault(parent, set()).add(seq_hash)
            # adopt any children that arrived before this node; their
            # subtrees were rooted at depth 1 while detached, so re-walk
            # them — depths must be a pure function of the final tree,
            # not of insertion order
            for c in sorted(self._orphans.pop(seq_hash, ())):
                child = self._nodes.get(c)
                if child is not None and child.parent == seq_hash:
                    node.children.add(c)
                    self._roots.discard(c)
                    self._redepth(c, node.depth + 1)
            self.inserted_total += 1
        node.holders[tier].add(worker)
        node.last_use = self._tick()
        return node

    def _redepth(self, seq_hash: int, depth: int) -> None:
        stack = [(seq_hash, depth)]
        while stack:
            h, d = stack.pop()
            node = self._nodes.get(h)
            if node is None:
                continue
            node.depth = d
            stack.extend((c, d + 1) for c in node.children)

    # ------------------------- tier transitions ------------------------

    def mark(self, seq_hash: int, tier: str, worker: int) -> bool:
        """Record that ``worker`` now holds the block in ``tier`` (e.g.
        an offload landed it in G2). No-op if the node is unknown."""
        node = self._nodes.get(seq_hash)
        if node is None:
            return False
        node.holders[tier].add(worker)
        node.last_use = self._tick()
        return True

    def unmark(self, seq_hash: int, tier: str,
               worker: Optional[int] = None) -> bool:
        """Drop ``worker``'s (or every worker's) holding in ``tier``;
        prunes the node once no tier holds it anywhere."""
        node = self._nodes.get(seq_hash)
        if node is None:
            return False
        if worker is None:
            node.holders[tier].clear()
        else:
            node.holders[tier].discard(worker)
        self._prune_if_empty(node)
        return True

    def drop_worker(self, worker: int) -> int:
        """Purge every holding of ``worker`` (worker removed from the
        fleet). Returns nodes touched."""
        touched = 0
        for node in list(self._nodes.values()):
            hit = False
            for ws in node.holders.values():
                if worker in ws:
                    ws.discard(worker)
                    hit = True
            if hit:
                touched += 1
                self._prune_if_empty(node)
        return touched

    def clear_worker_tier(self, worker: int, tier: str) -> int:
        """Drop every ``tier`` holding of ``worker`` (pool cleared)."""
        n = 0
        for node in list(self._nodes.values()):
            if worker in node.holders[tier]:
                node.holders[tier].discard(worker)
                n += 1
                self._prune_if_empty(node)
        return n

    def _prune_if_empty(self, node: RadixNode) -> None:
        """Remove hold-free leaves, walking up: an interior hold-free
        node stays as structure while any descendant is still held."""
        while node is not None and node.empty() and not node.children:
            self._nodes.pop(node.seq_hash, None)
            self._roots.discard(node.seq_hash)
            if node.parent is not None:
                waiting = self._orphans.get(node.parent)
                if waiting is not None:
                    waiting.discard(node.seq_hash)
                    if not waiting:
                        del self._orphans[node.parent]
            parent = (self._nodes.get(node.parent)
                      if node.parent is not None else None)
            if parent is not None:
                parent.children.discard(node.seq_hash)
            node = parent

    # ------------------------------ match ------------------------------

    def find_matches(self, hashes: Sequence[int]) -> PrefixMatch:
        """Longest-leading-run match of a request's chained hash chain.

        ``scores[w]`` sums tier weights over worker ``w``'s own leading
        run (its best tier per block), so a worker holding 8 G1 blocks
        outranks one holding 8 G4 blocks — the router feeds these into
        ``select_worker`` in place of the flat overlap counts. Counts as
        one query for the hit-rate accounting.
        """
        self.queries_total += 1
        match = PrefixMatch()
        alive: Optional[Set[int]] = None   # workers with an unbroken run
        for h in hashes:
            node = self._nodes.get(h)
            if node is None or node.empty():
                break
            match.blocks += 1
            match.nodes.append(node)
            node.last_use = self._tick()
            here = node.workers()
            alive = set(here) if alive is None else (alive & here)
            if not alive:
                # the global chain continues (someone holds this block)
                # but no single worker holds the whole run — per-worker
                # scores stop growing, global match keeps walking
                continue
            for w in alive:
                best = 0.0
                for tier in TIERS:
                    if w in node.holders[tier]:
                        best = max(best, self.tier_weights.get(tier, 0.0))
                match.scores[w] = match.scores.get(w, 0.0) + best
                match.worker_blocks[w] = match.worker_blocks.get(w, 0) + 1
        return match

    def longest_prefix_blocks(self, hashes: Sequence[int],
                              tier: Optional[str] = None,
                              worker: Optional[int] = None) -> int:
        """Leading blocks of ``hashes`` held (optionally: in ``tier``,
        by ``worker``). Read-only — no recency touch, no query count."""
        n = 0
        for h in hashes:
            node = self._nodes.get(h)
            if node is None:
                break
            if tier is not None:
                ws = node.holders[tier]
            else:
                ws = node.workers()
            if worker is not None:
                if worker not in ws:
                    break
            elif not ws:
                break
            n += 1
        return n

    # --------------------------- hit accounting ------------------------

    def record_hit_blocks(self, hashes: Iterable[int], tier: str,
                          worker: int) -> int:
        """Count served-from-cache blocks, verifying each against the
        index's own tier state — the independent accounting the replay
        ``prefix_vs_index`` cross-check compares with the scheduler's
        measured hits. Returns hit tokens credited."""
        tokens = 0
        for h in hashes:
            node = self._nodes.get(h)
            if node is None or worker not in node.holders[tier]:
                continue
            node.last_use = self._tick()
            tokens += self.block_size
        self.hit_tokens_total += tokens
        return tokens

    # ------------------------------ evict ------------------------------

    def _subtree(self, seq_hash: int) -> List[RadixNode]:
        out: List[RadixNode] = []
        stack = [seq_hash]
        while stack:
            node = self._nodes.get(stack.pop())
            if node is None:
                continue
            out.append(node)
            stack.extend(sorted(node.children))
        return out

    def lru_subtree(self, tier: str, worker: Optional[int] = None,
                    exclude_roots: Optional[Set[int]] = None) -> List[int]:
        """Pick the LRU eviction victim for one tier WITHOUT mutating.

        Let ``sub_last(n)`` be the most recent use anywhere in ``n``'s
        held subtree. A node is a candidate victim root when evicting
        its whole subtree removes only cold state: its parent is not
        held (or the parent's subtree contains something strictly more
        recent — i.e. this subtree is maximal among all-cold subtrees).
        The candidate with the oldest ``sub_last`` wins, so a whole cold
        conversation branch goes at once while a hot shared run is never
        punched through. Ties break on ``seq_hash``; recency is the
        logical clock, so the choice is a pure function of the operation
        sequence. Returns the subtree's held hashes, root first (empty =
        nothing evictable)."""
        def held(n: RadixNode) -> bool:
            ws = n.holders[tier]
            return (worker in ws) if worker is not None else bool(ws)

        sub_last: Dict[int, int] = {}

        def compute_sub_last(h: int) -> int:
            cached = sub_last.get(h)
            if cached is not None:
                return cached
            node = self._nodes[h]
            last = node.last_use if held(node) else 0
            for c in node.children:
                last = max(last, compute_sub_last(c))
            sub_last[h] = last
            return last

        candidates: List[Tuple[int, int]] = []
        for node in self._nodes.values():
            if not held(node):
                continue
            if exclude_roots and node.seq_hash in exclude_roots:
                continue
            mine = compute_sub_last(node.seq_hash)
            pnode = (self._nodes.get(node.parent)
                     if node.parent is not None else None)
            if pnode is not None and held(pnode) \
                    and compute_sub_last(pnode.seq_hash) <= mine:
                continue   # parent's subtree is just as cold — not maximal
            candidates.append((mine, node.seq_hash))
        if not candidates:
            return []
        candidates.sort()
        victim = candidates[0][1]
        return [n.seq_hash for n in self._subtree(victim) if held(n)]

    def evict_lru_subtree(self, tier: str,
                          worker: Optional[int] = None) -> List[int]:
        """LRU-by-subtree eviction: :meth:`lru_subtree` then drop the
        tier holdings for the whole victim subtree. Returns the evicted
        hashes (caller demotes/frees the actual payloads)."""
        evicted = self.lru_subtree(tier, worker)
        for h in evicted:
            node = self._nodes.get(h)
            if node is None:
                continue
            if worker is None:
                node.holders[tier].clear()
            else:
                node.holders[tier].discard(worker)
        # prune leaf-first so interior nodes see updated children sets
        for h in reversed(evicted):
            node = self._nodes.get(h)
            if node is not None:
                self._prune_if_empty(node)
        self.evictions_total += len(evicted)
        return evicted

    # --------------------------- router events -------------------------

    def apply_event(self, worker_id: int, event: dict) -> None:
        """Feed one ``RouterEvent`` payload (``{"kind", "blocks"}``).

        ``stored`` blocks carry the prefix-node digest chain
        (``digest`` = chained seq_hash; ``parent`` links) plus an
        optional ``tier`` (default G1 — engine pool events). The router
        keeps a cluster replica of this index from these alone.
        """
        kind = event.get("kind")
        if kind == "stored":
            for b in event.get("blocks", ()):
                h = b.get("digest", b.get("seq_hash"))
                if h is None:
                    continue
                self.insert(int(h), int(b.get("block_hash", h)),
                            b.get("parent"), b.get("tier", TIER_G1),
                            worker_id)
        elif kind == "removed":
            for h in event.get("blocks", ()):
                self.unmark(int(h), event.get("tier", TIER_G1), worker_id)
        elif kind == "cleared":
            self.clear_worker_tier(worker_id, event.get("tier", TIER_G1))

    # ------------------------------ stats ------------------------------

    def tier_blocks(self, tier: str,
                    worker: Optional[int] = None) -> int:
        if worker is None:
            return sum(1 for n in self._nodes.values()
                       if n.holders[tier])
        return sum(1 for n in self._nodes.values()
                   if worker in n.holders[tier])

    def stats(self) -> Dict[str, float]:
        return {
            "prefix_nodes": float(len(self._nodes)),
            "prefix_hit_tokens_total": float(self.hit_tokens_total),
            "prefix_queries_total": float(self.queries_total),
            "prefix_evictions_total": float(self.evictions_total),
            "prefix_inserted_total": float(self.inserted_total),
        }

    def check_invariants(self) -> None:
        """Structural invariants (tests call this after churn): parent
        links and children sets agree, roots are exactly the parentless
        nodes, no node is hold-free AND childless."""
        for h, node in self._nodes.items():
            assert node.seq_hash == h
            if node.parent is not None and node.parent in self._nodes:
                assert h in self._nodes[node.parent].children, \
                    f"{h:x} missing from parent children"
            else:
                assert h in self._roots, f"{h:x} detached but not a root"
            for c in node.children:
                assert c in self._nodes, f"{h:x} has dangling child {c:x}"
                assert self._nodes[c].parent == h
            assert not (node.empty() and not node.children), \
                f"{h:x} is hold-free and childless — should be pruned"
        for r in self._roots:
            assert r in self._nodes
