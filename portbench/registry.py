"""Find a cell's pieces by name, so that a new cell, configuration or
metric is new files and entries only:

- `BENCHMARK.json` at the checkout's root lists the metrics (unit,
  better, layer, moves, the cells that report each) and the cells;
- `portbench/cells/<cell>.json`: its configuration, traffic and chips;
- `portbench/configs/<config>.json`: the deployment's sizes;
- `portbench/traffic/<kind>.py`: the driver of a traffic kind;
- `portbench/metrics/<metric>.py`: the reader of one metric, a
  `read(record)` that returns a number, or None where it finds nothing.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from typing import Callable, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")


def _name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    return name


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str):
    """The module at `path`, loaded once a process under `name`."""
    mod = sys.modules.get(name)
    if mod is not None and Path(getattr(mod, "__file__", "")) == path:
        return mod
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def cell(name: str, here: Path = HERE) -> dict:
    return _json(here / "cells" / f"{_name(name)}.json")


def config(name: str, here: Path = HERE) -> dict:
    return _json(here / "configs" / f"{_name(name)}.json")


def driver_class(kind: str, here: Path = HERE):
    path = here / "traffic" / f"{_name(kind)}.py"
    return _module(path, f"portbench.traffic.{kind}").Driver


def reader(metric: str, here: Path = HERE) -> Callable:
    path = here / "metrics" / f"{_name(metric)}.py"
    return _module(path, f"portbench_metric_{metric}").read


def metrics_for(bench: dict, cell_name: str, trace: bool) -> List[dict]:
    """The metrics a run of the cell reports: with trace off its
    end-to-end metrics, with trace on its per-layer metrics."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if cell_name in m.get("workloads", [cell_name])]
