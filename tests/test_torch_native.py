"""The port's C++ host hot loops (``csrc/dynamo_native.cpp`` through
``dynamo_tpu_torch.native``) against ``xxhash``, the JAX package's native
library (``dynamo_tpu.native``) and the port's plain Python: every case of
``tests/test_native.py`` on both libraries; ``xxh3_64`` at every length
0..4,096 and beyond several 1,024-byte blocks of stripes, seeds 0, 1337 and
2**64 - 1; a hypothesis state machine of stored, removed and cleared events
on which the C++ and the Python ``KvIndexer`` (and the JAX one) agree;
``content_token`` equal to JAX's; and a broken build (no compiler, a bad
source) that raises, with no fallback."""

import shutil

import numpy as np
import pytest
import xxhash
from hypothesis import settings
from hypothesis import strategies as st
from hypothesis.stateful import RuleBasedStateMachine, invariant, rule

from dynamo_tpu import native as jnative
from dynamo_tpu import tokens as JT
from dynamo_tpu.multimodal.processor import content_token as jax_content_token
from dynamo_tpu.router.indexer import KvIndexer as JaxKvIndexer
from dynamo_tpu.router.indexer import RouterEvent as JaxRouterEvent
from dynamo_tpu_torch import native, tokens
from dynamo_tpu_torch.multimodal.processor import content_token
from dynamo_tpu_torch.ops import _build
from dynamo_tpu_torch.router.indexer import KvIndexer, RouterEvent
from dynamo_tpu_torch.utils.xxh3 import xxh3_64 as plain_xxh3_64

SEEDS = [0, 1337, 2 ** 64 - 1]


@pytest.fixture(params=["port", "jax"])
def lib(request):
    """The C++ library of either package: (block_hashes, PrefixIndex)."""
    if request.param == "port":
        return native.block_hashes, native.NativePrefixIndex
    if not jnative.available():
        pytest.skip("the JAX package's native library does not build here")
    return jnative.block_hashes, jnative.NativePrefixIndex


# ------------------------- tests/test_native.py ----------------------------


def test_block_hashes_match_python(lib):
    block_hashes, _ = lib
    toks = list(range(1, 100))
    bs = 8
    bh, sh = block_hashes(toks, bs, tokens.HASH_SEED)
    want_seq = tokens.plain_block_hashes_for_seq(toks, bs)
    assert [int(x) for x in sh] == want_seq == \
        JT.compute_block_hashes_for_seq(toks, bs)
    want_block = [tokens.compute_block_hash(toks[i * bs:(i + 1) * bs])
                  for i in range(len(toks) // bs)]
    assert [int(x) for x in bh] == want_block


def test_block_hashes_partial_tail_ignored(lib):
    block_hashes, _ = lib
    bh, sh = block_hashes([1, 2, 3], 4, tokens.HASH_SEED)
    assert len(bh) == 0 and len(sh) == 0
    assert tokens.compute_block_hashes_for_seq([1, 2, 3], 4) == []


def test_prefix_index_longest_match(lib):
    ix = lib[1]()
    a, b, c, x = 11, 22, 33, 99
    ix.stored(1, [a, b, c])
    ix.stored(2, [a, b])
    ix.stored(3, [x])
    assert ix.num_blocks == 4
    assert ix.find_matches([a, b, c]) == {1: 3, 2: 2}
    assert ix.find_matches([a]) == {1: 1, 2: 1}
    assert ix.find_matches([x]) == {3: 1}
    assert ix.find_matches([c]) == {1: 1}


def test_prefix_index_remove_and_clear(lib):
    ix = lib[1]()
    ix.stored(1, [5, 6])
    ix.stored(2, [5])
    ix.removed(1, [6])
    assert ix.find_matches([5, 6]) == {1: 1, 2: 1}
    ix.clear_worker(1)
    assert ix.find_matches([5, 6]) == {2: 1}
    assert ix.num_blocks == 1


def test_prefix_index_refcounted_duplicates(lib):
    ix = lib[1]()
    ix.stored(1, [7])
    ix.stored(1, [7])
    ix.removed(1, [7])
    assert ix.find_matches([7]) == {1: 1}
    ix.removed(1, [7])
    assert ix.find_matches([7]) == {}


def test_hashing_large_sequence_randomised(lib):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 2 ** 31, size=4096).tolist()
    _, sh = lib[0](toks, 16, tokens.HASH_SEED)
    assert [int(v) for v in sh] == tokens.plain_block_hashes_for_seq(toks, 16)
    assert tokens.compute_block_hashes_for_seq(toks, 16) == \
        JT.compute_block_hashes_for_seq(toks, 16)


def test_full_u32_token_ids_hash_alike():
    """Ids with the top bit set (``content_token``'s) hash as u32, as in
    the Python chain."""
    toks = [0xFFFFFFFF, 0x80000000, 0, 1] * 8
    assert tokens.compute_block_hashes_for_seq(toks, 16) == \
        tokens.plain_block_hashes_for_seq(toks, 16) == \
        JT.compute_block_hashes_for_seq(toks, 16)


# --------------------------------- xxh3 ------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_xxh3_64_every_length_to_4096(seed):
    data = np.random.default_rng(seed & 0xFFFF).integers(
        0, 256, 4096 + 64, dtype=np.uint8).tobytes()
    for n in range(4097):
        assert native.xxh3_64(data[:n], seed) == \
            xxhash.xxh3_64_intdigest(data[:n], seed=seed), n
    # the same lengths at an odd offset (unaligned loads)
    for n in range(0, 4097, 61):
        assert native.xxh3_64(data[3:3 + n], seed) == \
            xxhash.xxh3_64_intdigest(data[3:3 + n], seed=seed), n


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [4097, 5000, 8191, 8192, 8193, 65536,
                               1_000_003])
def test_xxh3_64_beyond_many_stripe_blocks(seed, n):
    data = np.random.default_rng(n).integers(0, 256, n,
                                             dtype=np.uint8).tobytes()
    want = xxhash.xxh3_64_intdigest(data, seed=seed)
    assert native.xxh3_64(data, seed) == want
    if n <= 8193:
        assert plain_xxh3_64(data, seed) == want


def test_xxh3_64_masks_the_seed_as_xxhash_does():
    for seed in (-1, 2 ** 64, 2 ** 70 + 5):
        assert native.xxh3_64(b"abc" * 100, seed) == \
            xxhash.xxh3_64_intdigest(b"abc" * 100, seed=seed & (2 ** 64 - 1))


def test_content_token_equals_jax():
    rng = np.random.default_rng(3)
    for shape in [(32, 32, 3), (7, 5, 3), (224, 224, 3), (1, 1, 1)]:
        img = rng.standard_normal(shape).astype(np.float32)
        for index in (0, 1, 5):
            assert content_token(img, index) == jax_content_token(img, index)
    # a float64 image hashes as its float32 bytes in both
    img = rng.standard_normal((4, 4, 3))
    assert content_token(img, 2) == jax_content_token(img, 2)


# ------------------------- the indexer, stateful ---------------------------


class IndexerMachine(RuleBasedStateMachine):
    """Stored (duplicates included), removed and cleared events in any
    order; the C++-backed, the Python and the JAX ``KvIndexer`` agree on
    every match and on ``dump_events``."""

    def __init__(self):
        super().__init__()
        self.native = KvIndexer(16)
        self.plain = KvIndexer(16, use_native=False)
        self.jax = JaxKvIndexer(16)
        self.chains = [list(range(100 * c, 100 * c + 8)) for c in range(3)]

    def apply(self, worker, kind, blocks):
        for ix in (self.native, self.plain):
            ix.apply_event(RouterEvent(worker, kind, tuple(blocks)))
        self.jax.apply_event(JaxRouterEvent(worker, kind, tuple(blocks)))

    @rule(worker=st.integers(0, 3), chain=st.integers(0, 2),
          n=st.integers(1, 8), dicts=st.booleans())
    def stored(self, worker, chain, n, dicts):
        hashes = self.chains[chain][:n]
        blocks = [{"seq_hash": h, "block_hash": h, "parent": None}
                  for h in hashes] if dicts else hashes
        self.apply(worker, "stored", blocks)

    @rule(worker=st.integers(0, 3), chain=st.integers(0, 2),
          lo=st.integers(0, 7), n=st.integers(1, 4))
    def removed(self, worker, chain, lo, n):
        self.apply(worker, "removed", self.chains[chain][lo:lo + n])

    @rule(worker=st.integers(0, 3))
    def cleared(self, worker):
        self.apply(worker, "cleared", ())

    @rule(worker=st.integers(0, 3))
    def worker_gone(self, worker):
        for ix in (self.native, self.plain, self.jax):
            ix.remove_worker(worker)

    @invariant()
    def agree(self):
        for chain in self.chains:
            for n in (1, 4, 8):
                want = self.plain.find_matches(chain[:n]).scores
                assert self.native.find_matches(chain[:n]).scores == want
                assert self.jax.find_matches(chain[:n]).scores == want
            assert self.native.find_matches(chain[1:]).scores == \
                self.plain.find_matches(chain[1:]).scores
        assert self.native.num_blocks() == self.plain.num_blocks() \
            == self.jax.num_blocks()
        assert sorted((e.worker_id, e.blocks) for e in
                      self.native.dump_events()) == sorted(
            (e.worker_id, e.blocks) for e in self.plain.dump_events())


TestIndexerMachine = IndexerMachine.TestCase
TestIndexerMachine.settings = settings(max_examples=60,
                                       stateful_step_count=25,
                                       deadline=None)


def test_find_matches_for_tokens_agrees():
    toks = list(range(64))
    ixs = [KvIndexer(16), KvIndexer(16, use_native=False)]
    for ix in ixs:
        ix.apply_event(RouterEvent(
            7, "stored", tuple(tokens.plain_block_hashes_for_seq(toks, 16))))
    assert [ix.find_matches_for_tokens(toks + [1]).scores for ix in ixs] \
        == [{7: 4}, {7: 4}]


# ------------------------------ a broken build -----------------------------


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    """An empty build tree and no library loaded yet."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(native, "_lib", None)
    return tmp_path


def _no_fallback():
    """Every entry point raises; none answers from Python."""
    for call in (lambda: native.xxh3_64(b"x"),
                 lambda: tokens.compute_block_hashes_for_seq(
                     list(range(32)), 16),
                 lambda: KvIndexer(16),
                 lambda: content_token(np.zeros((2, 2, 3)), 0)):
        with pytest.raises(RuntimeError) as e:
            call()
        yield str(e.value)


def test_no_compiler_raises(fresh_build, monkeypatch):
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setenv("PATH", str(fresh_build))   # no g++ there
    assert shutil.which("g++") is None
    messages = list(_no_fallback())
    assert all("compiler 'g++' not found" in m for m in messages)


def test_bad_source_raises_with_the_compiler_output(fresh_build,
                                                    monkeypatch):
    src = fresh_build / "csrc"
    src.mkdir()
    good = (_build.SRC_DIR / "dynamo_native.cpp").read_text()
    (src / "dynamo_native.cpp").write_text(
        good.replace("extern \"C\" {", "extern \"C\" { this is not C++;", 1))
    monkeypatch.setattr(_build, "SRC_DIR", src)
    messages = list(_no_fallback())
    assert all("failed for csrc/dynamo_native.cpp" in m and "error" in m
               for m in messages)
    assert not list((fresh_build / "build").glob("*.tmp"))


def test_the_library_lands_in_the_build_tree(fresh_build):
    assert native.xxh3_64(b"abc", 1) == xxhash.xxh3_64_intdigest(b"abc",
                                                                 seed=1)
    built = list((fresh_build / "build").glob("dynamo_native-*.so"))
    assert len(built) == 1
    took = _build.build_all(["dynamo_native"])
    assert took == {"dynamo_native": 0.0}    # already built: no compile
