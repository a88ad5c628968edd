"""Finding a cell's parts by name: ``BENCHMARK.json`` at the root of the
checkout names the cell's configuration, traffic mix and metrics; each part
is a file of its own under ``portbench/``:

- ``BENCHMARK.json`` ``configs[].file``: the configuration as run (its
  published ``config.json`` keys, and ``engine``: the engine's settings);
- ``traffic/<traffic>.json``: the mix's parameters (``traffic.py``);
- ``cells/<cell>.json``, if there is one: the cell's own values, merged
  over the mix (a fixed rate), and the limits of its comparison;
- ``metrics/<metric>.py``: the reader of a per-layer metric (``read(r)``);
- ``arch/<model_type>.py`` and ``reference/<model_type>.py``, by the
  configuration's own ``model_type``: the architecture. ``arch`` gives
  ``shapes(config)`` (the sizes its counts take, with ``vocab``, the
  vocabulary held and drawn from by the traffic, and ``elem_bytes``),
  ``model_config(config, ModelConfig)``, ``leaf_shapes(shapes)`` (the
  weight leaves in draw order), ``step_flops(shapes, record)`` and
  ``attn_bound_s(shapes, peaks, record)`` of one landed ``StepRecord``;
  ``reference`` its plain float32 block (``reference/model.py`` says what
  the block gives).

A later cell, mix, metric or architecture is a new file and a new entry,
never an edit.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
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


def _module(bench_dir: Path, part: str, name: str) -> ModuleType:
    """``<part>/<name>.py`` under the checkout's ``portbench/``, loaded
    from its path as ``portbench.<part>.<name>``, which it replaces in
    ``sys.modules`` (a dataclass looks its module up there)."""
    path = bench_dir / part / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"portbench: no {part}/{name}.py")
    full = f"portbench.{part}.{name}"
    spec = importlib.util.spec_from_file_location(full, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[full] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(bench_dir: Path, metric: str) -> Callable:
    """The ``read`` function of ``metrics/<metric>.py``."""
    return _module(bench_dir, "metrics", metric).read


def _model_type(config: dict) -> str:
    if "model_type" not in config:
        raise SystemExit("portbench: a configuration names no model_type")
    return config["model_type"]


def arch(bench_dir: Path, config: dict) -> ModuleType:
    """``arch/<model_type>.py`` of the configuration."""
    return _module(bench_dir, "arch", _model_type(config))


def reference(bench_dir: Path, config: dict) -> ModuleType:
    """``reference/<model_type>.py``: the architecture's plain block."""
    return _module(bench_dir, "reference", _model_type(config))


def readers(cell: Cell) -> Dict[str, Callable]:
    return {m["name"]: reader(cell.bench_dir, m["name"])
            for m in cell.per_layer}
