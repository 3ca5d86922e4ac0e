"""Cells, configurations, traffic mixes and metric readers, found by the
names in ``BENCHMARK.json``.

* a cell's sizes and check limits: ``workloads/<cell>.json``;
* a configuration: the ``file`` its entry names, and its plain reference
  ``reference/<config's "reference">.py``;
* a traffic mix: ``traffic/<traffic>.json``, whose ``driver`` names the
  generator ``traffic/<driver>.py``;
* a per-layer metric: ``metrics/<metric>.py``, whose ``read(run)``
  returns the value or None.

A later cell, configuration, mix or metric is new files and new entries,
and no edit here.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def load_module(path: Path):
    """The module in ``path`` (any file name)."""
    name = "bench_" + re.sub(r"\W", "_", str(path.relative_to(path.parents[1])))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    params: dict
    end_to_end: list
    per_layer: list
    home: Path

    def driver(self):
        return load_module(self.home / "traffic"
                           / f"{self.traffic['driver']}.py")

    def reference(self):
        return load_module(self.home / "reference"
                           / f"{self.config['reference']}.py")

    def reader(self, metric: str):
        return load_module(self.home / "metrics" / f"{metric}.py")


class Bench:
    """``BENCHMARK.json`` at ``root`` with the files under ``home``."""

    def __init__(self, root: Path, home: Path = HERE):
        self.root = Path(root)
        self.home = Path(home)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> Cell:
        w = next((w for w in self.spec["workloads"] if w["name"] == name),
                 None)
        if w is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        (c,) = [c for c in self.spec["configs"] if c["name"] == w["config"]]
        config = json.loads((self.root / c["file"]).read_text())
        traffic = json.loads((self.home / "traffic"
                              / f"{w['traffic']}.json").read_text())
        params = json.loads((self.home / "workloads"
                             / f"{name}.json").read_text())
        e2e = [m for m in self.spec["end_to_end"]
               if name in m.get("workloads", [name])]
        moved = {m["name"] for m in e2e}
        layer = [m for m in self.spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
        return Cell(name=name, chips=int(w["chips"]), config=config,
                    traffic=traffic, params=params, end_to_end=e2e,
                    per_layer=layer, home=self.home)
