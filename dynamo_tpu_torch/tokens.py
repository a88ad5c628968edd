"""Block-aligned token sequences with rolling content hashes.

A copy of ``dynamo_tpu.tokens`` (the prefix-cache key math behind the
scheduler's block reuse, the engine's KV events and the KV router's index;
ref: lib/tokens/src/lib.rs:14-27 and lib/llm/src/tokens.rs:44,388,479) on
this package's own xxh3-64 in place of ``xxhash``. A prompt's chain of
block hashes (``compute_block_hashes_for_seq``, what the KV router runs
per routing decision) runs in the C++ library (``native/``, built from
``csrc/dynamo_native.cpp``), with no fallback; the chain in Python
(``plain_block_hashes_for_seq``, on ``utils/xxh3.py``) stays beside it as
its plain version. The engine's ``TokenBlockSequence`` seals its blocks one
at a time in Python, as the JAX one does. The chain is ``xxh3_64(
parent_seq_hash_le_u64 || token_bytes_u32_le, seed=1337)`` (root blocks
hash their token bytes alone), so the hashes equal the JAX package's bit
for bit: JAX and port processes share one store, and a router of either
package indexes the KV events that workers of either package publish.

Two hash kinds per block:
- ``block_hash``: the hash of the block's own token bytes (u32 LE).
- ``sequence_hash``: chains the parent block's sequence hash with this block's
  token bytes, so equal sequence hashes imply equal full prefixes. This is the
  key used for KV block reuse and radix-tree matching.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence

from . import native
from .utils.xxh3 import xxh3_64

HASH_SEED = 1337

Token = int
BlockHash = int
SequenceHash = int


def _tokens_to_bytes(tokens: Sequence[int]) -> bytes:
    return struct.pack(f"<{len(tokens)}I", *tokens)


def _hash64(payload: bytes) -> int:
    return xxh3_64(payload, HASH_SEED)


def compute_block_hash(tokens: Sequence[int]) -> BlockHash:
    """Content hash of one block's tokens (u32 little-endian), xxh3-64/1337."""
    return _hash64(_tokens_to_bytes(tokens))


def compute_sequence_hash(
    parent: Optional[SequenceHash], tokens: Sequence[int]
) -> SequenceHash:
    """Rolling prefix hash: chain parent sequence hash with this block's bytes."""
    if parent is None:
        return compute_block_hash(tokens)
    return _hash64(struct.pack("<Q", parent) + _tokens_to_bytes(tokens))


def compute_block_hashes_for_seq(
    tokens: Sequence[int], block_size: int
) -> list[SequenceHash]:
    """Sequence hashes for every *complete* block of ``tokens``.

    The router-side hot path (same role as the reference's
    ``compute_block_hash_for_seq``, indexer.rs:125, but chained — see module
    docstring): only full blocks participate in prefix matching; the ragged
    tail is ignored. Runs in the C++ library; equal to
    :func:`plain_block_hashes_for_seq`.
    """
    if len(tokens) < block_size:
        return []
    return native.sequence_hashes(tokens, block_size, HASH_SEED)


def plain_block_hashes_for_seq(
    tokens: Sequence[int], block_size: int
) -> list[SequenceHash]:
    """:func:`compute_block_hashes_for_seq` in Python, block by block."""
    out: list[SequenceHash] = []
    parent: Optional[SequenceHash] = None
    for start in range(0, len(tokens) - block_size + 1, block_size):
        parent = compute_sequence_hash(parent, tokens[start : start + block_size])
        out.append(parent)
    return out


@dataclass(frozen=True)
class TokenBlock:
    """One complete, immutable block of tokens with its chained hashes."""

    tokens: tuple[int, ...]
    block_hash: BlockHash
    sequence_hash: SequenceHash
    parent_sequence_hash: Optional[SequenceHash]

    @staticmethod
    def build(
        tokens: Sequence[int], parent: Optional[SequenceHash]
    ) -> "TokenBlock":
        return TokenBlock(
            tokens=tuple(tokens),
            block_hash=compute_block_hash(tokens),
            sequence_hash=compute_sequence_hash(parent, tokens),
            parent_sequence_hash=parent,
        )


@dataclass
class TokenBlockSequence:
    """A growing token sequence chunked into fixed-size hashed blocks.

    Mirrors the reference's ``TokenBlockSequence`` (lib/llm/src/tokens.rs:479):
    append tokens one at a time or in bulk; every time a block fills, it is
    sealed into a ``TokenBlock`` with a rolling sequence hash. The ragged tail
    (``partial_tokens``) stays mutable until sealed.
    """

    block_size: int
    blocks: list[TokenBlock] = field(default_factory=list)
    partial_tokens: list[int] = field(default_factory=list)

    def __post_init__(self):
        if self.block_size <= 0:
            raise ValueError("block_size must be positive")

    @staticmethod
    def from_tokens(tokens: Sequence[int], block_size: int) -> "TokenBlockSequence":
        seq = TokenBlockSequence(block_size=block_size)
        seq.extend(tokens)
        return seq

    def __len__(self) -> int:
        return len(self.blocks) * self.block_size + len(self.partial_tokens)

    @property
    def total_tokens(self) -> int:
        return len(self)

    def tokens(self) -> list[int]:
        out: list[int] = []
        for b in self.blocks:
            out.extend(b.tokens)
        out.extend(self.partial_tokens)
        return out

    def last_sequence_hash(self) -> Optional[SequenceHash]:
        return self.blocks[-1].sequence_hash if self.blocks else None

    def sequence_hashes(self) -> list[SequenceHash]:
        return [b.sequence_hash for b in self.blocks]

    def append(self, token: int) -> Optional[TokenBlock]:
        """Append one token; returns the sealed block if this filled one."""
        self.partial_tokens.append(token)
        if len(self.partial_tokens) == self.block_size:
            block = TokenBlock.build(self.partial_tokens, self.last_sequence_hash())
            self.blocks.append(block)
            self.partial_tokens = []
            return block
        return None

    def extend(self, tokens: Iterable[int]) -> list[TokenBlock]:
        """Append many tokens; returns all blocks sealed along the way."""
        sealed: list[TokenBlock] = []
        for t in tokens:
            b = self.append(t)
            if b is not None:
                sealed.append(b)
        return sealed

    def truncate(self, num_tokens: int) -> None:
        """Drop tokens beyond ``num_tokens`` (used by migration/backtrack)."""
        if num_tokens >= len(self):
            return
        all_tokens = self.tokens()[:num_tokens]
        self.blocks = []
        self.partial_tokens = []
        self.extend(all_tokens)
