"""Global prefix cache: radix-tree prefix index over the tiered KVBM
(G1 HBM / G2 host / G4 store) with prefix-aware routing support.

A copy of ``dynamo_tpu.prefix``: the index is the KV router's cluster
replica and, through ``manager.py``, the engine's own prefix cache."""

from .manager import PrefixCacheConfig, PrefixCacheManager
from .radix import (
    DEFAULT_TIER_WEIGHTS, TIER_G1, TIER_G2, TIER_G4, TIERS, PrefixMatch,
    RadixNode, RadixPrefixIndex,
)

__all__ = [
    "DEFAULT_TIER_WEIGHTS", "TIER_G1", "TIER_G2", "TIER_G4", "TIERS",
    "PrefixCacheConfig", "PrefixCacheManager", "PrefixMatch", "RadixNode",
    "RadixPrefixIndex",
]
