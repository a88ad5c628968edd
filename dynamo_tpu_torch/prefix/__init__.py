"""Global prefix cache: the radix-tree prefix index over the tiered KV
cache (G1 HBM / G2 host / G4 store). This package holds the index only, as
the KV router's cluster replica; the engine-side manager waits for its slice
(ROADMAP.md queue A, item 4)."""

from .radix import (
    DEFAULT_TIER_WEIGHTS, TIER_G1, TIER_G2, TIER_G4, TIERS, PrefixMatch,
    RadixNode, RadixPrefixIndex,
)

__all__ = [
    "DEFAULT_TIER_WEIGHTS", "TIER_G1", "TIER_G2", "TIER_G4", "TIERS",
    "PrefixMatch", "RadixNode", "RadixPrefixIndex",
]
