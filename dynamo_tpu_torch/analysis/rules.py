"""Rule registry: every dynalint rule, addressable by code or family."""

from __future__ import annotations

from typing import List, Sequence

from .core import Rule
from .rules_hostsync import RULES as _HOSTSYNC
from .rules_recompile import RULES as _RECOMPILE
from .rules_async import RULES as _ASYNC
from .rules_kernels import RULES as _KERNELS
from .rules_sharding import RULES as _SHARDING

ALL_RULES: List[Rule] = [
    *_HOSTSYNC,    # DT1xx host-sync in hot paths
    *_RECOMPILE,   # DT2xx capture hazards
    *_ASYNC,       # DT3xx async discipline
    *_KERNELS,     # DT4xx kernel binding contracts
    *_SHARDING,    # DT5xx sharding consistency
]


def rules_for(selectors: Sequence[str]) -> List[Rule]:
    """Resolve ``--select`` patterns: exact codes ("DT302") or prefixes
    ("DT3", "DT30")."""
    if not selectors:
        return list(ALL_RULES)
    out = [r for r in ALL_RULES
           if any(r.code == s or r.code.startswith(s) for s in selectors)]
    if not out:
        known = ", ".join(r.code for r in ALL_RULES)
        raise ValueError(f"no rules match {list(selectors)}; known: {known}")
    return out
