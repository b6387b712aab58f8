"""The port stands alone: it imports neither JAX nor the JAX package."""

import importlib.util
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
import importlib, importlib.util, pkgutil, sys
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
if importlib.util.find_spec("grpc") is None:   # the gRPC service alone needs grpc
    names.remove("dotaclient_tpu_torch.envs.service")
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
                     "dotaclient_tpu_torch.utils.checkpoint", "dotaclient_tpu_torch.utils.trace_report")
EXTERNAL_MODULES = ("dotaclient_tpu_torch.actor.__main__", "dotaclient_tpu_torch.actor.vec_runtime",
                    "dotaclient_tpu_torch.actor.window_stats", "dotaclient_tpu_torch.actor.backoff",
                    "dotaclient_tpu_torch.envs.vec_lane_sim", "dotaclient_tpu_torch.features.vec_featurizer",
                    "dotaclient_tpu_torch.transport.socket_transport", "dotaclient_tpu_torch.transport.serialize",
                    "dotaclient_tpu_torch.transport", "dotaclient_tpu_torch.models.convert",
                    "dotaclient_tpu_torch.outcome.records")
SCALAR_MODULES = ("dotaclient_tpu_torch.envs.lane_sim", "dotaclient_tpu_torch.envs.env_api",
                  "dotaclient_tpu_torch.envs.service", "dotaclient_tpu_torch.features",
                  "dotaclient_tpu_torch.features.featurizer", "dotaclient_tpu_torch.features.reward",
                  "dotaclient_tpu_torch.actor", "dotaclient_tpu_torch.actor.runtime",
                  "dotaclient_tpu_torch.transport.shm_transport")
CORE_MODULES = ("dotaclient_tpu_torch.parallel", "dotaclient_tpu_torch.parallel.expert",
                "dotaclient_tpu_torch.models.moe", "dotaclient_tpu_torch.models.transformer",
                "dotaclient_tpu_torch.utils.tree")
WIRE_MODULES = ("dotaclient_tpu_torch.native", "dotaclient_tpu_torch.native.build")
DATA_PARALLEL_MODULES = ("dotaclient_tpu_torch.parallel.distributed", "dotaclient_tpu_torch.parallel.mesh",
                         "dotaclient_tpu_torch.parallel.sharding", "dotaclient_tpu_torch.parallel.sequence",
                         "dotaclient_tpu_torch.parallel.pipeline", "dotaclient_tpu_torch.parallel.collectives")
TOOLS_MODULES = ("dotaclient_tpu_torch.train.bench_configs", "dotaclient_tpu_torch.train.curriculum",
                 "dotaclient_tpu_torch.utils.outcome_report", "dotaclient_tpu_torch.utils.fleet_status",
                 "dotaclient_tpu_torch.utils.utilization_report", "dotaclient_tpu_torch.utils.chaos_run")
# the static checks (the whole lint package), their CLIs, the multi-GPU
# preflight and the learner's per-op numerics checks
CHECKS_MODULES = ("dotaclient_tpu_torch.lint", "dotaclient_tpu_torch.lint.__main__", "dotaclient_tpu_torch.lint.core",
                  "dotaclient_tpu_torch.lint.host_sync", "dotaclient_tpu_torch.lint.ownership",
                  "dotaclient_tpu_torch.lint.telemetry_drift", "dotaclient_tpu_torch.lint.config_drift",
                  "dotaclient_tpu_torch.lint.alert_drift", "dotaclient_tpu_torch.utils.check_host_sync",
                  "dotaclient_tpu_torch.utils.check_telemetry_schema", "dotaclient_tpu_torch.utils.run_multichip",
                  "dotaclient_tpu_torch.train.checkify")
# the bench and what only it uses
BENCH_MODULES = ("dotaclient_tpu_torch.bench", "dotaclient_tpu_torch.transport.bench_producer",
                 "dotaclient_tpu_torch.utils.bench_trajectory")


def port_sources():
    return sorted(p for p in PORT.rglob("*") if p.suffix in {".py", ".cu", ".cuh", ".cc", ".sh"}) + [ROOT / "chip_smoke.py"]


def test_port_imports_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKER], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert out.returncode == 0, out.stderr[-2000:]
    names, count = out.stdout.splitlines()[-2:]
    # every module of the port: the league's, the buffered learner's, the
    # run record's (the trace plane's among them), the external actors',
    # the scalar path's (the gRPC service's only where grpc is installed)
    # the transformer and MoE cores', the data-parallel slice's, the
    # tools beside the package (the bench, the curriculum, the consoles and
    # the chaos supervisor) and the static checks, their CLIs and the
    # preflight, and the bench
    has_grpc = importlib.util.find_spec("grpc") is not None
    assert int(count) >= 104 + has_grpc
    for group in (LEAGUE_MODULES, BUFFERED_MODULES, RUNRECORD_MODULES, EXTERNAL_MODULES, SCALAR_MODULES,
                  CORE_MODULES, WIRE_MODULES, DATA_PARALLEL_MODULES, TOOLS_MODULES, CHECKS_MODULES, BENCH_MODULES):
        assert set(group) - ({"dotaclient_tpu_torch.envs.service"} if not has_grpc else set()) <= set(names.split())


# the card's paths with grpc blocked: the card machine may lack it, and only
# the gRPC service imports it
_NO_GRPC = r"""
import sys
class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "grpc":
            raise ImportError(f"banned import: {name}")
        return None
sys.meta_path.insert(0, Blocker())
import dotaclient_tpu_torch.envs, dotaclient_tpu_torch.actor.runtime, dotaclient_tpu_torch.actor.__main__
import dotaclient_tpu_torch.train.learner, dotaclient_tpu_torch.league.evaluation, dotaclient_tpu_torch.serve.__main__
import dotaclient_tpu_torch.transport.shm_transport
assert not any(n.split(".")[0] == "grpc" for n in sys.modules)
print("card paths without grpc")
"""


def test_card_paths_import_without_grpc():
    out = subprocess.run(
        [sys.executable, "-c", _NO_GRPC], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.splitlines()[-1] == "card paths without grpc"


# the router and its CLI with torch blocked as well: a router process holds
# no CUDA context (nor do the trace plane and its report, which the socket
# lane imports)
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
from dotaclient_tpu_torch.utils import alerts, fleet, trace_report, tracing
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


# the bench's producer child with torch blocked, shipping through both
# lanes: it is up in milliseconds, so the bench's window measures the
# transport
_PRODUCER_NO_TORCH = r"""
import os, sys, threading
BANNED = ("torch", "jax", "jaxlib", "flax", "dotaclient_tpu")
class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError(f"banned import: {name}")
        return None
sys.meta_path.insert(0, Blocker())
from dotaclient_tpu_torch.transport import bench_producer
from dotaclient_tpu_torch.transport.shm_transport import ShmTransportServer
from dotaclient_tpu_torch.transport.socket_transport import TransportServer
got = []
for lane in ("socket", "shm"):
    if lane == "socket":
        server = TransportServer(port=0)
        addr = f"{server.address[0]}:{server.address[1]}"
    else:
        server = ShmTransportServer(name=f"bench-pkg-{os.getpid()}", slots=1, ring_bytes=1 << 20,
                                    weights_bytes=1 << 16)
        addr = server.address
    rc = []
    t = threading.Thread(target=lambda: rc.append(bench_producer.main(
        ["--lane", lane, "--addr", addr, "--frames", "25", "--bytes", "4096"])))
    t.start()
    n = 0
    for _ in range(300):
        n += len(server._drain(25, timeout=0.05))
        if n >= 25:
            break
    t.join(30)
    server.close()
    got.append((lane, n, rc))
assert not any(n.split(".")[0] in BANNED for n in sys.modules)
print(got)
"""


def test_bench_producer_runs_without_torch():
    out = subprocess.run(
        [sys.executable, "-c", _PRODUCER_NO_TORCH], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.splitlines()[-1] == "[('socket', 25, [0]), ('shm', 25, [0])]"


# the three report consoles with torch blocked: they read a run record and
# start in milliseconds
_CONSOLES_NO_TORCH = r"""
import os, sys, tempfile
BANNED = ("torch", "jax", "jaxlib", "flax", "dotaclient_tpu")
class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError(f"banned import: {name}")
        return None
sys.meta_path.insert(0, Blocker())
from dotaclient_tpu_torch.utils import fleet_status, outcome_report, utilization_report
path = tempfile.mkstemp(suffix=".jsonl")[1]
rcs = [m.main([path]) for m in (outcome_report, fleet_status, utilization_report)]
os.unlink(path)
assert not any(n.split(".")[0] in BANNED for n in sys.modules)
print(rcs)
"""


def test_consoles_run_without_torch():
    out = subprocess.run(
        [sys.executable, "-c", _CONSOLES_NO_TORCH], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert out.returncode == 0, out.stderr[-2000:]
    # an empty record: no curves and no fold, the fleet board still renders
    assert out.stdout.splitlines()[-1] == "[1, 0, 1]"


@pytest.mark.parametrize("pattern", [r"\bjax\b", r"\bflax\b", r"dotaclient_tpu\.", r"from dotaclient_tpu import"])
def test_no_port_source_names_jax(pattern):
    # the transformer and MoE cores' modules and the data-parallel slice's among them
    assert {PORT / "parallel" / "expert.py", PORT / "models" / "moe.py", PORT / "models" / "transformer.py",
            PORT / "utils" / "tree.py"} <= set(port_sources())
    assert {PORT / "parallel" / f"{m.rsplit('.', 1)[1]}.py" for m in DATA_PARALLEL_MODULES} <= set(port_sources())
    # the static checks and their CLIs among them, the gate's shell script too
    assert {PORT / "lint" / f"{m}.py" for m in ("__init__", "__main__", "core", "host_sync", "ownership",
                                                   "telemetry_drift", "config_drift", "alert_drift")} \
        | {PORT / "utils" / "ci_gate.sh", PORT / "utils" / "run_multichip.py"} <= set(port_sources())
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


# the wire with JAX and the JAX package blocked: the native codec builds
# from the port's own source and loads from the port's build directory,
# and AMQP imports; nothing under dotaclient_tpu/native is mapped
_NATIVE = _BLOCKER.split("import dotaclient_tpu_torch\n")[0] + r"""
import json
import numpy as np
import dotaclient_tpu_torch.native as native
from dotaclient_tpu_torch.transport import AmqpTransport, serialize
lib = native.load_library()
assert lib is not None, native.build.load_error
payload = serialize.encode_rollout_bytes({"x": np.arange(4, dtype=np.float32)}, 1, 0, 0, 1, 0.0)
assert serialize.decode_rollout_bytes(payload)[1]["x"].tolist() == [0.0, 1.0, 2.0, 3.0]
with open("/proc/self/maps") as f:
    maps = f.read()
assert not any(n.split(".")[0] in BANNED for n in sys.modules)
print(json.dumps({"lib": lib._name, "reference_mapped": "dotaclient_tpu/native" in maps,
                  "calls": serialize.codec_calls(), "amqp": AmqpTransport.EXPERIENCE_QUEUE}))
"""


def test_native_codec_and_amqp_import_without_jax_from_the_ports_own_files():
    out = subprocess.run(
        [sys.executable, "-c", _NATIVE], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.splitlines()[-1])
    assert pathlib.Path(got["lib"]).resolve().is_relative_to(PORT / "native" / "_build")
    assert not got["reference_mapped"] and got["amqp"] == "experience"
    assert got["calls"] == {"native_encodes": 1, "native_decodes": 1, "proto_fallbacks": 0}
    from dotaclient_tpu_torch.native import build

    assert pathlib.Path(build.SOURCE).resolve().is_relative_to(PORT)
    # no port source names the reference's library or its directory's files
    offenders = [f"{p.relative_to(ROOT)}:{i}" for p in port_sources()
                 for i, line in enumerate(p.read_text().splitlines(), 1)
                 if "libdota_native" in line or re.search(r"[\"']dotaclient_tpu[\"'], *[\"']native", line)]
    assert not offenders, offenders
