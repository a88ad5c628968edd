"""Speculative-decoding accounting (ref: protocols.rs:48 ``SpecDecodeStats``
inside ``ForwardPassMetrics``). A copy of ``dynamo_tpu.spec.stats``.

``drafted`` counts draft tokens fed to a verify window, ``accepted`` the
ones the target model confirmed, ``emitted`` every token a spec window
landed (accepted drafts + the bonus/corrective token), ``windows`` the
number of verify windows run. Serialisation defaults absent fields to
zero so mixed-version clusters (workers without spec) aggregate cleanly.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class SpecDecodeStats:
    drafted: int = 0
    accepted: int = 0
    emitted: int = 0
    windows: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0

    def to_dict(self) -> dict:
        return {
            "drafted": int(self.drafted),
            "accepted": int(self.accepted),
            "emitted": int(self.emitted),
            "windows": int(self.windows),
            "acceptance_rate": float(self.acceptance_rate),
        }

    @classmethod
    def from_dict(cls, d) -> "SpecDecodeStats":
        d = d or {}
        return cls(
            drafted=int(d.get("drafted", 0)),
            accepted=int(d.get("accepted", 0)),
            emitted=int(d.get("emitted", 0)),
            windows=int(d.get("windows", 0)),
        )
