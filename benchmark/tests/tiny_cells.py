"""A checkout copy holding a tiny cell made from new files alone: a
configuration, a traffic mix, a limits file and (optionally) a per-layer
metric, each added beside the benchmark's own and named in a copy of
``BENCHMARK.json``."""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional

from benchmark.cells import ROOT

TINY_TRAIN = "tiny_train_league"


def make_root(tmp: str, dtype: str = "float32", metric: Optional[Dict[str, str]] = None,
              limits: Optional[Dict[str, Dict[str, float]]] = None) -> str:
    """A checkout copy under ``tmp`` with the tiny training cell.
    ``metric`` ({name: source}) adds per-layer metric files listed for it;
    ``limits`` replaces its limits (default: the full cell's)."""
    root = os.path.join(tmp, "checkout")
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bdir = os.path.join(root, "benchmark")

    def put(rel: str, obj) -> None:
        with open(os.path.join(bdir, rel), "w") as f:
            json.dump(obj, f)

    def read(rel: str):
        with open(os.path.join(bdir, rel)) as f:
            return json.load(f)

    small = {"hidden_dim": 16, "unit_embed_dim": 8, "dtype": dtype}
    put("configs/tiny128.json", {**read("configs/lstm128.json"), **small, "name": "tiny128"})
    train = read("traffic/league5v5_fused.json")
    train["run_config"]["env"]["n_envs"] = 2
    train["run_config"]["env"]["max_dota_time"] = 3.0     # short games: episodes end inside the check
    train["profiled_iterations"] = 1
    put("traffic/tiny_league.json", train)
    bench["configs"] += [
        {"name": "tiny128", "source": "test", "file": "benchmark/configs/tiny128.json", "reduced": [], "why": "test"}]
    bench["workloads"] += [
        {"name": TINY_TRAIN, "config": "tiny128", "traffic": "tiny_league", "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "train_league5v5_lstm128" in m.get("workloads", []):
            m["workloads"].append(TINY_TRAIN)
    for name, source in (metric or {}).items():
        with open(os.path.join(bdir, "metrics", f"{name}.py"), "w") as f:
            f.write(source)
        bench["per_layer"].append({"name": name, "unit": "count", "better": "higher", "source": "host_clock",
                                   "layer": "learner loop", "moves": "trained_frames_per_s",
                                   "workloads": [TINY_TRAIN]})
    put(f"limits/{TINY_TRAIN}.json", (limits or {}).get(TINY_TRAIN) or read("limits/train_league5v5_lstm128.json"))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root
