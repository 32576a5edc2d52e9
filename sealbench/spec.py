"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout, the configuration file it names, ``traffic/<mix>.json``,
``cells/<workload>.json`` (the cell's limit) and ``metrics/<name>.py``
(one reader a per-layer metric). A cell, a mix or a metric is added by
adding files and entries; no file here needs an edit."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file, as it is run
    mix: dict             # the traffic mix
    check: dict           # the cell's limit and the readings behind it
    end_to_end: List[dict]
    per_layer: List[dict]


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    return Cell(workload, int(w["chips"]), _json(root / conf["file"]),
                _json(HERE / "traffic" / f"{w['traffic']}.json"),
                _json(HERE / "cells" / f"{workload}.json"),
                [m for m in bench["end_to_end"] if applies(m)],
                [m for m in bench["per_layer"] if applies(m)])


def reader(name: str):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"sealbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

