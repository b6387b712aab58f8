"""Finding a cell's files by the names in ``BENCHMARK.json``.

A checkout's root holds ``BENCHMARK.json``; a configuration is the file its
entry names, a traffic mix ``benchmark/traffic/<mix>.json``, a per-layer
metric ``benchmark/metrics/<metric>.py`` and a cell's correctness limits
``benchmark/limits/<cell>.json``. A new cell, mix, configuration or metric
is new files and new entries; nothing here changes for it.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Any, Dict, List, Mapping, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Cell:
    root: str
    bench: Dict[str, Any]
    workload: Dict[str, Any]
    config: Dict[str, Any]       # the configuration file as run
    traffic: Dict[str, Any]      # the traffic mix's parameters
    limits: Dict[str, float]     # number compared -> its limit

    @property
    def name(self) -> str:
        return self.workload["name"]

    def end_to_end(self) -> List[Dict[str, Any]]:
        return [m for m in self.bench["end_to_end"] if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> List[Dict[str, Any]]:
        """Every per-layer metric this cell reports: those that list it, and
        those that list no cells but move an end-to-end metric it reports."""
        mine = {m["name"] for m in self.end_to_end()}
        out = []
        for m in self.bench["per_layer"]:
            if "workloads" in m:
                if self.name in m["workloads"]:
                    out.append(m)
            elif m["moves"] in mine:
                out.append(m)
        return out


def _read_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load(name: str, root: Optional[str] = None) -> Cell:
    root = root or ROOT
    bench = _read_json(os.path.join(root, "BENCHMARK.json"))
    workloads = {w["name"]: w for w in bench["workloads"]}
    if name not in workloads:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(workloads)})")
    w = workloads[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _read_json(os.path.join(root, "benchmark", "traffic", f"{w['traffic']}.json"))
    limits = _read_json(os.path.join(root, "benchmark", "limits", f"{name}.json"))
    return Cell(root, bench, w, config, traffic, limits)


def metric_reader(cell: Cell, metric: str):
    """The ``read(ctx)`` of ``benchmark/metrics/<metric>.py``."""
    path = os.path.join(cell.root, "benchmark", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def run_config(cell: Cell, seed: int):
    """The program's ``RunConfig``: its defaults, the configuration's model,
    observation and action widths, and the traffic mix's sections."""
    from dotaclient_tpu_torch.config import RunConfig

    base = json.loads(RunConfig().to_json())
    cfg = cell.config
    base["model"].update({k: v for k, v in cfg.items() if k in base["model"]})
    base["obs"].update(cfg.get("obs", {}))
    base["actions"].update(cfg.get("actions", {}))
    for section, values in cell.traffic.get("run_config", {}).items():
        if isinstance(values, Mapping):
            base[section].update(values)
        else:
            base[section] = values
    base["seed"] = seed
    base["env"]["seed"] = seed
    return RunConfig.from_json(json.dumps(base))
