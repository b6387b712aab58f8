"""The port stands alone: it imports neither JAX nor the JAX package."""

import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "dotaclient_tpu_torch"

# an importer that refuses jax, flax, ml_dtypes and the JAX package,
# installed before anything of the port is imported
_BLOCKER = r"""
import importlib, pkgutil, sys
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "ml_dtypes", "dotaclient_tpu")
for name in list(sys.modules):
    if name.split(".")[0] in BANNED:
        del sys.modules[name]
class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError(f"banned import: {name}")
        return None
sys.meta_path.insert(0, Blocker())
import dotaclient_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dotaclient_tpu_torch.__path__, "dotaclient_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(n.split(".")[0] in BANNED for n in sys.modules), "a banned module got in"
print(" ".join(names))
print(len(names))
"""

# modules that must be among those imported with JAX blocked (the league
# slice's, the buffered learner's and the run record's, beside the count of
# all of them)
LEAGUE_MODULES = ("dotaclient_tpu_torch.league", "dotaclient_tpu_torch.league.pool",
                  "dotaclient_tpu_torch.league.evaluation", "dotaclient_tpu_torch.league.__main__",
                  "dotaclient_tpu_torch.train.demo")
BUFFERED_MODULES = ("dotaclient_tpu_torch.buffer", "dotaclient_tpu_torch.buffer.trajectory_buffer",
                    "dotaclient_tpu_torch.train.advantage", "dotaclient_tpu_torch.train.health",
                    "dotaclient_tpu_torch.train.snapshot", "dotaclient_tpu_torch.transport.queues",
                    "dotaclient_tpu_torch.utils.faults")
RUNRECORD_MODULES = ("dotaclient_tpu_torch.utils.metrics", "dotaclient_tpu_torch.utils.profiling",
                     "dotaclient_tpu_torch.utils.schema", "dotaclient_tpu_torch.outcome.aggregator",
                     "dotaclient_tpu_torch.utils.fleet", "dotaclient_tpu_torch.utils.telemetry",
                     "dotaclient_tpu_torch.utils.utilization", "dotaclient_tpu_torch.utils.tracing",
                     "dotaclient_tpu_torch.utils.checkpoint")


def port_sources():
    return sorted(p for p in PORT.rglob("*") if p.suffix in {".py", ".cu", ".cuh"}) + [ROOT / "chip_smoke.py"]


def test_port_imports_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKER], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert out.returncode == 0, out.stderr[-2000:]
    names, count = out.stdout.splitlines()[-2:]
    assert int(count) >= 65  # every module of the port, the league's, the buffered learner's and the run record's
    for group in (LEAGUE_MODULES, BUFFERED_MODULES, RUNRECORD_MODULES):
        assert set(group) <= set(names.split())


# the router and its CLI with torch blocked as well: a router process holds
# no CUDA context
_NO_TORCH = r"""
import sys
BANNED = ("torch", "jax", "jaxlib", "flax", "dotaclient_tpu")
class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError(f"banned import: {name}")
        return None
sys.meta_path.insert(0, Blocker())
from dotaclient_tpu_torch.serve import SessionRouter, route_call
from dotaclient_tpu_torch.serve import router
from dotaclient_tpu_torch.utils import alerts, fleet
assert router.main(["--backends", "127.0.0.1:9", "--interval", "0.05", "--duration", "0.3"]) == 0
assert not any(n.split(".")[0] in BANNED for n in sys.modules)
print("router without torch")
"""


def test_router_runs_without_torch():
    out = subprocess.run(
        [sys.executable, "-c", _NO_TORCH], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.splitlines()[-1] == "router without torch"
    assert json.loads(out.stdout.splitlines()[-2])["router_backend_deaths"] == 0.0


@pytest.mark.parametrize("pattern", [r"\bjax\b", r"\bflax\b", r"dotaclient_tpu\.", r"from dotaclient_tpu import"])
def test_no_port_source_names_jax(pattern):
    offenders = [
        f"{p.relative_to(ROOT)}:{i}"
        for p in port_sources()
        for i, line in enumerate(p.read_text().splitlines(), 1)
        if re.search(pattern, line)
    ]
    assert not offenders, offenders


def test_kernels_build_for_hopper_from_package_sources():
    """The build is pinned to sm_90a, reads only sources in the package and
    writes only inside it."""
    from dotaclient_tpu_torch.ops import build

    assert "-gencode=arch=compute_90a,code=sm_90a" in build.CUDA_FLAGS
    for path in build.source_paths():
        assert pathlib.Path(path).is_file()
        assert pathlib.Path(path).resolve().is_relative_to(PORT)
    assert pathlib.Path(build.BUILD_DIR).resolve().is_relative_to(PORT)
