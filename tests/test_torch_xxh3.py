"""The port's pure-Python XXH3-64 (``dynamo_tpu_torch.utils.xxh3``) against
``xxhash.xxh3_64_intdigest``: every length from 0 to 2,048 bytes (every
length class: 0, 1-3, 4-8, 9-16, 17-128, 129-240 and the long path over
several stripes and blocks), longer inputs up to 8 KB in steps, the edge
seeds (0, 1, 1337, 2**63, 2**64 - 1, and the masked -1 and 2**64 + 5), and
hypothesis-drawn bytes and seeds. Then the two values built on it: the KV
block hashes of ``tokens.py`` and the trace head-sampling decision of
``tracing/collector.py``, each equal to the JAX package's."""

import random

import pytest
import xxhash
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu import tokens as jtokens
from dynamo_tpu.tracing.collector import SpanCollector as JaxSpanCollector
from dynamo_tpu_torch import tokens as ttokens
from dynamo_tpu_torch.tracing.collector import SpanCollector
from dynamo_tpu_torch.utils.xxh3 import xxh3_64

SEEDS = [0, 1, 1337, 2 ** 63, 2 ** 64 - 1, -1, 2 ** 64 + 5]
DATA = random.Random(0).randbytes(8192)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lengths", [(0, 241), (241, 1025), (1025, 2049)],
                         ids=["0-240", "241-1024", "1025-2048"])
def test_every_length_equals_xxhash(seed, lengths):
    for n in range(*lengths):
        data = DATA[:n]
        assert xxh3_64(data, seed) == xxhash.xxh3_64_intdigest(
            data, seed=seed), (n, seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_long_inputs_equal_xxhash(seed):
    # 1,024 bytes make one block of 16 stripes over the 192-byte secret
    for n in [*range(2049, 8193, 61), 3072, 3073, 4096, 8191, 8192]:
        data = DATA[-n:]
        assert xxh3_64(data, seed) == xxhash.xxh3_64_intdigest(
            data, seed=seed), (n, seed)


def test_seeds_mask_to_64_bits_like_xxhash():
    data = DATA[:72]
    assert xxh3_64(data, -1) == xxh3_64(data, 2 ** 64 - 1)
    assert xxh3_64(data, 2 ** 64 + 5) == xxh3_64(data, 5)
    assert xxh3_64(data) == xxhash.xxh3_64_intdigest(data)


@settings(max_examples=300, deadline=None)
@given(data=st.binary(max_size=1500),
       seed=st.integers(min_value=-(2 ** 65), max_value=2 ** 66))
def test_drawn_bytes_and_seeds_equal_xxhash(data, seed):
    assert xxh3_64(data, seed) == xxhash.xxh3_64_intdigest(data, seed=seed)


def test_block_hashes_equal_the_reference():
    """Tokens 0..31 at block size 16: the JAX package's sequence hashes."""
    want = [15310707395893867146, 7844343420941177057]
    assert ttokens.compute_block_hashes_for_seq(list(range(32)), 16) == want
    assert jtokens.compute_block_hashes_for_seq(list(range(32)), 16) == want


@pytest.mark.parametrize("block_size", [4, 16, 64])
def test_block_and_sequence_hashes_match_jax(block_size):
    """64- and 72-byte blocks (block size 16) take the 17-128 byte path,
    256- and 264-byte ones (block size 64) the long path."""
    rng = random.Random(block_size)
    tokens = [rng.randrange(128256) for _ in range(8 * block_size + 3)]
    assert ttokens.compute_block_hashes_for_seq(tokens, block_size) == \
        jtokens.compute_block_hashes_for_seq(tokens, block_size)
    seq = ttokens.TokenBlockSequence.from_tokens(tokens, block_size)
    jseq = jtokens.TokenBlockSequence.from_tokens(tokens, block_size)
    assert [(b.block_hash, b.sequence_hash, b.parent_sequence_hash)
            for b in seq.blocks] == \
        [(b.block_hash, b.sequence_hash, b.parent_sequence_hash)
         for b in jseq.blocks]


@pytest.mark.parametrize("ratio, salt", [(0.5, 0), (0.3, 7), (0.9, -3)])
def test_trace_sampling_decisions_equal_jax(ratio, salt):
    """At ratio 0.5 and salt 0 (and two other settings), every decision
    equals the JAX collector's."""
    port = SpanCollector(sample_ratio=ratio, sample_salt=salt)
    ref = JaxSpanCollector(sample_ratio=ratio, sample_salt=salt)
    rng = random.Random(salt)
    ids = [f"{i:032x}" for i in range(64)] + [
        rng.randbytes(16).hex() for _ in range(256)]
    assert [port.sampled(t) for t in ids] == [ref.sampled(t) for t in ids]
