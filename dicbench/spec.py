"""BENCHMARK.json and the files it names, found by name.

A cell of BENCHMARK.json names a configuration (configs/<file> as the
entry says), a traffic mix (mixes/<traffic>.json) and has a file of its
own, cells/<cell>.json, with the limits of its correctness check.  A
configuration's domain kind names domains/<kind>.py, a mix's motion kind
motions/<kind>.py, its deformation and reference the reference's chain
reference/chains/<deformation>_<reference>.py, and a per-layer metric
<name> metrics/<name>.py.  Each is loaded from its file in the cell's
checkout.  A new cell, configuration, mix, motion or metric is new files
and new entries: no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file's object, "name" added
    mix: dict  # the mix file's object, "name" added
    checks: dict  # {number: limit}
    end_to_end: list  # the entries of the metrics this cell reports
    per_layer: list
    root: Path = ROOT  # the checkout the files came from


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json, with its files read."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = dict(_json(root / conf["file"]), name=conf["name"])
    here = root / "dicbench"
    mix = dict(_json(here / "mixes" / f"{w['traffic']}.json"),
               name=w["traffic"])
    checks = _json(here / "cells" / f"{name}.json")["checks"]

    def mine(m):
        return name in m.get("workloads", [name])

    return Cell(name, int(w["chips"]), config, mix, checks,
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)], root)


def load(folder: str, name: str, root: Path = ROOT):
    """The module dicbench/<folder>/<name>.py of the checkout `root`,
    loaded from its file."""
    path = root / "dicbench" / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {folder} module {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        "dicbench." + folder.replace("/", ".") + "." + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
