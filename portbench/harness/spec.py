"""Finds every piece of a cell by its name in BENCHMARK.json: the cell's
configuration file (`configs[].file`), its traffic mix
(`traffic/<traffic>.json`), its scene generator (`scenes/<generator>.py`)
and the readers of its per-layer metrics (`metrics/<metric>.py`). A new
cell, configuration, mix or metric is a new file and new entries in
BENCHMARK.json; no file here changes."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    build_scene: Callable


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def _module(path, name):
    name = "".join(c if c.isalnum() else "_" for c in name)
    if not os.path.exists(path):
        raise FileNotFoundError(f"{name}: no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: str = ROOT) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: str = ROOT) -> Cell:
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[w["config"]]
    config = _load_json(os.path.join(root, conf["file"]))
    traffic = _load_json(os.path.join(root, "portbench", "traffic",
                                      w["traffic"] + ".json"))
    gen = config["scene"]["generator"]
    scene_mod = _module(os.path.join(root, "portbench", "scenes",
                                     gen + ".py"), f"portbench_scene_{gen}")
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=config, traffic_name=w["traffic"], traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)],
                build_scene=scene_mod.build)


def readers(metrics: List[dict], root: str = ROOT) -> Dict[str, Callable]:
    """name -> read(run) of each per-layer metric."""
    return {m["name"]: _module(os.path.join(root, "portbench", "metrics",
                                            m["name"] + ".py"),
                               f"portbench_metric_{m['name']}").read
            for m in metrics}
