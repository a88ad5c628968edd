"""Finding a cell's parts by name: ``BENCHMARK.json`` at the root of the
checkout names the cell's configuration, traffic mix and metrics; each part
is a file of its own under ``portbench/``:

- ``BENCHMARK.json`` ``configs[].file``: the configuration as run (its
  published ``config.json`` keys, and ``engine``: the engine's settings);
- ``traffic/<traffic>.json``: the mix's parameters (``traffic.py``);
- ``cells/<cell>.json``, if there is one: the cell's own values, merged
  over the mix (a fixed rate), and the limits of its comparison;
- ``metrics/<metric>.py``: the reader of a per-layer metric (``read(r)``).

A later cell, mix or metric is a new file and a new entry, never an edit.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file's contents
    mix: dict             # the traffic mix with the cell's values merged
    limits: dict          # name of each number compared -> its limit
    end_to_end: List[dict]
    per_layer: List[dict]
    bench_dir: Path       # the checkout's portbench/


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(root: Path, name: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    bench_dir = root / "portbench"
    mix = json.loads(
        (bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    own = bench_dir / "cells" / f"{name}.json"
    extra = json.loads(own.read_text()) if own.exists() else {}
    limits = extra.pop("limits", {})
    mix.update(extra)
    return Cell(
        name=name, chips=int(w["chips"]), config=config, mix=mix,
        limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        bench_dir=bench_dir,
    )


def reader(bench_dir: Path, metric: str) -> Callable:
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = bench_dir / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def readers(cell: Cell) -> Dict[str, Callable]:
    return {m["name"]: reader(cell.bench_dir, m["name"])
            for m in cell.per_layer}
