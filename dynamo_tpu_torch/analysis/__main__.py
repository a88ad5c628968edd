"""dynalint CLI for the port — ``python -m dynamo_tpu_torch.analysis``.

Exit codes: 0 clean (modulo baseline), 1 new findings, 2 usage error. The
default paths are the ``dynamo_tpu_torch`` package, the default baseline
``dynamo_tpu_torch/analysis/dynalint-baseline.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from .baseline import DEFAULT_BASELINE, Baseline
from .core import AnalysisConfig, Finding, run_paths
from .rules import ALL_RULES, rules_for


def find_repo_root(start: Path) -> Path:
    """Walk up to the checkout root (where pyproject.toml lives)."""
    cur = start.resolve()
    for candidate in [cur, *cur.parents]:
        if (candidate / "pyproject.toml").exists():
            return candidate
    return cur


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m dynamo_tpu_torch.analysis",
        description="dynalint: PyTorch/CUDA/async hot-path static "
                    "analysis of the port",
    )
    ap.add_argument("paths", nargs="*", type=Path,
                    help="files/dirs to analyze (default: the "
                         "dynamo_tpu_torch package)")
    ap.add_argument("--check", action="store_true",
                    help="CI mode: identical analysis, terse summary")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline to the current finding set")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="baseline file (default: dynamo_tpu_torch/"
                         "analysis/dynalint-baseline.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignoring the baseline")
    ap.add_argument("--select", default="",
                    help="comma-separated rule codes/prefixes, e.g. "
                         "DT3,DT102")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)

    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.code}  {rule.name}\n    {rule.rationale}")
        return 0

    try:
        rules = rules_for([s for s in args.select.split(",") if s])
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    pkg_dir = Path(__file__).resolve().parent.parent  # dynamo_tpu_torch/
    root = find_repo_root(pkg_dir)
    paths = args.paths or [pkg_dir]
    config = AnalysisConfig(root=root)

    findings = run_paths(paths, rules, config)

    baseline_path = args.baseline or DEFAULT_BASELINE
    if args.update_baseline:
        Baseline.from_findings(findings).save(baseline_path)
        print(f"dynalint: baseline written to {baseline_path} "
              f"({len(findings)} grandfathered findings)")
        return 0

    if args.no_baseline:
        new, old, stale = findings, [], 0
    else:
        baseline = Baseline.load(baseline_path)
        new, old, stale = baseline.partition(findings)

    if args.format == "json":
        print(json.dumps({
            "new": [vars(f) for f in new],
            "baselined": len(old),
            "stale_baseline_entries": stale,
        }, indent=2))
    else:
        for f in new:
            print(f.render())
        summary = (f"dynalint: {len(new)} new finding(s), "
                   f"{len(old)} baselined, {stale} stale baseline entr"
                   f"{'y' if stale == 1 else 'ies'}")
        print(summary)
        if new:
            print("fix the findings, suppress intentional ones with "
                  "`# dynalint: disable=DTxxx`, or regenerate the baseline "
                  "with --update-baseline", file=sys.stderr)
        elif stale:
            print("note: stale entries mean grandfathered findings were "
                  "fixed — run --update-baseline to shrink the baseline",
                  file=sys.stderr)

    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
