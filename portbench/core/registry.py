"""BENCHMARK.json and the files it names.

A cell (an entry of "workloads") names a configuration and a traffic
mix. The configuration's file is the one its "configs" entry gives; a
traffic mix is traffic/<name>.json, whose "op" names the operation
ops/<op>.py (a module with a class Op, see core/op.py), and every
metric, end to end or per layer, is read by metrics/<name>.py (a module
with read(run) -> float or None), all beside this package, so that a
cell, a mix, an operation or a metric is added with files and entries
alone.
"""
from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, List, NamedTuple

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG_DIR)


class Metric(NamedTuple):
    name: str
    unit: str
    read: Callable


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict           # the configuration file's contents
    traffic: dict          # the traffic file's contents
    end_to_end: List[Metric]
    per_layer: List[Metric]
    pkg_dir: str = PKG_DIR  # where its traffic's operation is found


def _module(pkg_dir: str, kind: str, name: str):
    path = os.path.join(pkg_dir, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_%s_%s" % (kind, name.replace(".", "_").replace("-", "_")),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reader(pkg_dir: str, name: str) -> Callable:
    return _module(pkg_dir, "metrics", name).read


def op_class(name: str, pkg_dir: str = PKG_DIR):
    """The class Op of ops/<name>.py."""
    return _module(pkg_dir, "ops", name).Op


def _reports(entry: dict, cell: str, cell_e2e: set) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves", entry["name"]) in cell_e2e


def build(name: str, chips: int, config_file: str, traffic: str,
          end_to_end: List[dict], per_layer: List[dict],
          pkg_dir: str = PKG_DIR) -> Cell:
    """A cell from its parts: the configuration's file, the traffic mix's
    name and the metric entries it reports."""
    with open(config_file) as f:
        config = json.load(f)
    with open(os.path.join(pkg_dir, "traffic", traffic + ".json")) as f:
        mix = json.load(f)
    return Cell(name, int(chips), config, mix,
                [Metric(m["name"], m["unit"], _reader(pkg_dir, m["name"]))
                 for m in end_to_end],
                [Metric(m["name"], m["unit"], _reader(pkg_dir, m["name"]))
                 for m in per_layer], pkg_dir)


def load(cell_name: str, root: str = ROOT, pkg_dir: str = PKG_DIR) -> Cell:
    """The cell of BENCHMARK.json named cell_name (KeyError if none)."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    wl = {w["name"]: w for w in bench["workloads"]}[cell_name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell_name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"] if _reports(m, cell_name, names)]
    return build(cell_name, wl["chips"],
                 os.path.join(root, cfg_entry["file"]), wl["traffic"], e2e,
                 per, pkg_dir)
