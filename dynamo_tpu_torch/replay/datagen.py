"""The parts of the benchmark data generators that the replay traces use:
prefix-structured prompts, their ground-truth prefix accounting, and the
nearest-rank percentile the scoreboard reports.

Copies of ``PrefixDatasetConfig``, ``GeneratedRequest``,
``generate_prefix_dataset``, ``prefix_ground_truth`` and ``percentile`` from
``benchmarks/datagen.py``, kept in the port so it imports nothing outside
itself: the same config and seed give the same prompts.

The prefix generator builds a tree of shared prefixes: ``groups`` root
prefixes, each with ``branches`` second-level continuations, each yielding
requests whose leading tokens repeat across the group. ``prefix_ratio`` of
every prompt is shared content.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List


@dataclass
class PrefixDatasetConfig:
    num_requests: int = 128
    isl: int = 256                 # total prompt tokens
    prefix_ratio: float = 0.5      # leading fraction shared within a group
    groups: int = 4                # distinct root prefixes
    branches: int = 2              # second-level shared continuations
    vocab_size: int = 10_000
    vocab_offset: int = 100        # keep clear of special ids
    seed: int = 0


@dataclass
class GeneratedRequest:
    token_ids: List[int]
    group: int
    branch: int
    # shared-segment lengths of this prompt's ``[group | branch | tail]``
    # layout — carried so consumers can compute the ground-truth prefix
    # dedup without re-deriving the generator's split arithmetic
    group_len: int = 0
    branch_len: int = 0


def generate_prefix_dataset(
    cfg: PrefixDatasetConfig,
) -> List[GeneratedRequest]:
    """Prompts with controlled prefix sharing.

    Layout per prompt: ``[group prefix | branch prefix | unique tail]``
    where the two shared segments together cover ``prefix_ratio`` of the
    prompt (2/3 group-shared, 1/3 branch-shared).
    """
    rng = random.Random(cfg.seed)

    def toks(n: int) -> List[int]:
        return [rng.randrange(cfg.vocab_offset,
                              cfg.vocab_offset + cfg.vocab_size)
                for _ in range(n)]

    shared = max(0, min(cfg.isl, int(cfg.isl * cfg.prefix_ratio)))
    group_len = (shared * 2) // 3
    branch_len = shared - group_len
    tail_len = cfg.isl - shared

    group_prefixes = [toks(group_len) for _ in range(cfg.groups)]
    branch_prefixes = [
        [toks(branch_len) for _ in range(cfg.branches)]
        for _ in range(cfg.groups)
    ]
    out: List[GeneratedRequest] = []
    for i in range(cfg.num_requests):
        g = rng.randrange(cfg.groups)
        b = rng.randrange(cfg.branches)
        out.append(GeneratedRequest(
            token_ids=(group_prefixes[g] + branch_prefixes[g][b]
                       + toks(tail_len)),
            group=g, branch=b,
            group_len=group_len, branch_len=branch_len,
        ))
    return out


def prefix_ground_truth(dataset: List[GeneratedRequest]) -> dict:
    """Ground-truth shared-prefix accounting over an actual sampled dataset.

    ``shared_tokens_total`` counts every shared-segment token as prompted;
    ``shared_tokens_dedup`` counts each distinct (group) and (group, branch)
    prefix once — what a perfect prefix cache stores. The difference,
    ``prefix_hit_potential_tokens``, is the denominator a measured
    prefix-hit rate should be judged against: tokens a perfect cache would
    NOT recompute."""
    total_prompt = sum(len(r.token_ids) for r in dataset)
    shared_total = sum(r.group_len + r.branch_len for r in dataset)
    groups = {}
    branches = {}
    for r in dataset:
        groups[r.group] = r.group_len
        branches[(r.group, r.branch)] = r.branch_len
    dedup = sum(groups.values()) + sum(branches.values())
    return {
        "total_prompt_tokens": total_prompt,
        "shared_tokens_total": shared_total,
        "shared_tokens_dedup": dedup,
        "prefix_hit_potential_tokens": max(0, shared_total - dedup),
    }


def percentile(values: List[float], q: float) -> float:
    if not values:
        return 0.0
    vals = sorted(values)
    idx = min(len(vals) - 1, int(round(q / 100.0 * (len(vals) - 1))))
    return vals[idx]
