"""Baseline file: grandfathered findings that don't fail the build (a copy
of ``dynamo_tpu.analysis.baseline``; the port's baseline lives in this
package, beside this module).

A finding is identified by ``(code, path, symbol, snippet-hash)`` — not by
line number, so unrelated edits above a grandfathered site don't invalidate
the baseline, while any edit to the flagged line itself (or moving it to a
different function) surfaces the finding again for a fresh look.  Entries
carry a count: introducing a *second* identical violation in the same
function is a new finding even when one copy is baselined.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Tuple

from .core import Finding

BASELINE_VERSION = 1
DEFAULT_BASELINE_NAME = "dynalint-baseline.json"
DEFAULT_BASELINE = Path(__file__).resolve().parent / DEFAULT_BASELINE_NAME


def fingerprint(f: Finding) -> Tuple[str, str, str, str]:
    snip = hashlib.sha1(" ".join(f.snippet.split()).encode()).hexdigest()[:16]
    return (f.code, f.path, f.symbol, snip)


@dataclass
class Baseline:
    entries: Dict[Tuple[str, str, str, str], int] = field(default_factory=dict)

    @property
    def total(self) -> int:
        return sum(self.entries.values())

    # ------------------------------ io ----------------------------------

    @classmethod
    def load(cls, path: Path) -> "Baseline":
        if not Path(path).exists():
            return cls()
        data = json.loads(Path(path).read_text(encoding="utf-8"))
        entries: Dict[Tuple[str, str, str, str], int] = {}
        for e in data.get("findings", []):
            key = (e["code"], e["path"], e["symbol"], e["snippet_hash"])
            entries[key] = entries.get(key, 0) + int(e.get("count", 1))
        return cls(entries)

    @classmethod
    def from_findings(cls, findings: List[Finding]) -> "Baseline":
        b = cls()
        for f in findings:
            key = fingerprint(f)
            b.entries[key] = b.entries.get(key, 0) + 1
        return b

    def save(self, path: Path) -> None:
        rows = [
            {"code": c, "path": p, "symbol": s, "snippet_hash": h, "count": n}
            for (c, p, s, h), n in sorted(self.entries.items())
        ]
        Path(path).write_text(json.dumps({
            "version": BASELINE_VERSION,
            "comment": ("grandfathered dynalint findings; regenerate with "
                        "python -m dynamo_tpu_torch.analysis --update-baseline"),
            "findings": rows,
        }, indent=2) + "\n", encoding="utf-8")

    # --------------------------- matching -------------------------------

    def partition(
        self, findings: List[Finding]
    ) -> Tuple[List[Finding], List[Finding], int]:
        """Split into (new, baselined) and count stale baseline entries.

        Counts are consumed: N baselined copies absorb at most N findings
        with the same fingerprint.  Stale = baseline entries that matched
        nothing (the violation was fixed — time to regenerate).
        """
        budget = dict(self.entries)
        new: List[Finding] = []
        old: List[Finding] = []
        for f in findings:
            key = fingerprint(f)
            if budget.get(key, 0) > 0:
                budget[key] -= 1
                old.append(f)
            else:
                new.append(f)
        stale = sum(n for n in budget.values() if n > 0)
        return new, old, stale
