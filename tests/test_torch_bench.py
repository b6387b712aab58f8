"""The port's bench (``dotaclient_tpu_torch/bench.py``) against the
reference's ``bench.py``, and its helpers: the transport producer and the
trajectory tool.

The quantize stage's wire bytes equal the JAX package's codec's on the same
``example_batch`` row; the advantage stage's parity digest is 1; the CLI's
line at ``--smoke --device cpu`` carries every key of the reference's line
(read from ``bench.py``'s own source); a stage that raises makes the CLI
exit 1 with the error in its line; the anchor lives where it is told and
names its card; the producer child ships its frames through both lanes; and
the port's trajectory tool prints the reference tool's line on records of
both shapes.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dotaclient_tpu.config import default_config as jax_default_config
from dotaclient_tpu.train import example_batch as jax_example_batch
from dotaclient_tpu.transport.serialize import encode_rollout_bytes as jax_encode_rollout_bytes
from dotaclient_tpu.transport.serialize import rollout_wire_kwargs as jax_rollout_wire_kwargs
from dotaclient_tpu_torch import bench
from dotaclient_tpu_torch.config import default_config
from dotaclient_tpu_torch.train.learner import smoke_config
from dotaclient_tpu_torch.utils import bench_trajectory

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def smoke_run(dtype=None):
    config = smoke_config(default_config())
    if dtype is not None:
        config = dataclasses.replace(config, model=dataclasses.replace(config.model, dtype=dtype))
    return bench.Run(config, CPU, bench.SMOKE, 0)


def reference_keys():
    """The reference line's keys and the ``stages[...]`` it assigns, read
    from ``bench.py``'s ``main``."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    line = next(n for n in ast.walk(main) if isinstance(n, ast.Dict)
                and any(isinstance(k, ast.Constant) and k.value == "metric" for k in n.keys))
    stages = {t.slice.value for n in ast.walk(main) if isinstance(n, ast.Assign) for t in n.targets
              if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name) and t.value.id == "stages"
              and isinstance(t.slice, ast.Constant)}
    return {k.value for k in line.keys}, stages


def jax_frames(port_config):
    """The JAX codec's f32 and bf16 frames of ``example_batch``'s row at the
    port config's chunk length."""
    cfg = jax_default_config()
    cfg = dataclasses.replace(cfg, ppo=dataclasses.replace(cfg.ppo, rollout_len=port_config.ppo.rollout_len))
    bf16 = dataclasses.replace(cfg, transport=dataclasses.replace(cfg.transport, rollout_wire_dtype="bfloat16"))
    row = jax.tree.map(lambda x: np.asarray(x[0]), jax_example_batch(cfg, batch=1))
    T = cfg.ppo.rollout_len
    return {label: bytes(jax_encode_rollout_bytes(row, 0, 0, 0, T, 0.0, **jax_rollout_wire_kwargs(c)))
            for label, c in (("f32", cfg), ("bf16", bf16))}


@pytest.mark.parametrize("case", ["smoke_stage", "default_frames"])
def test_quantize_bytes_equal_the_jax_codecs(case):
    """The stage's bytes per frame at both widths and their ratio equal the
    JAX package's ``encode_rollout_bytes`` on the same row (exact): the
    whole stage at the smoke sizes, the frames alone at the default T=16."""
    if case == "smoke_stage":
        run = smoke_run()
        out = bench.bench_quantize(run)
        got = (out["wire_bytes_per_frame_f32"], out["wire_bytes_per_frame_bf16"], out["rollout_compression"])
        assert out["ingest_consume_fps_f32"] > 0 and out["optimizer_ratio"] > 0
        config = run.config
    else:
        config = default_config()
        frames = bench.rollout_frames(config)
        got = (len(frames["f32"]), len(frames["bf16"]), round(len(frames["f32"]) / len(frames["bf16"]), 2))
    ref = jax_frames(config)
    assert got == (len(ref["f32"]), len(ref["bf16"]), round(len(ref["f32"]) / len(ref["bf16"]), 2))
    assert got[2] >= 1.8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_advantage_parity_digest_is_1(dtype):
    """The pass's f32 advantages bitwise the in-step formula's, and the two
    train steps' losses within 1e-5 relative, at both compute dtypes."""
    out = bench.advantage_parity(smoke_run(dtype))
    assert out["parity_bitwise_adv"] == 1.0 and out["parity"] == 1.0
    assert out["parity_loss_delta"] <= 1e-5


def test_cli_line_carries_every_key_of_the_references(tmp_path):
    """``--smoke --device cpu`` on the headline and two cheap stages: exit
    0, one JSON line on stdout with every key of the reference's line and
    every ``stages`` key it assigns, the headline's numbers finite and above
    0, the stages not selected null."""
    anchor = tmp_path / "anchor.json"
    out = subprocess.run(
        [sys.executable, "-m", "dotaclient_tpu_torch.bench", "--smoke", "--device", "cpu", "--stage", "headline",
         "--stage", "quantize", "--stage", "transport", "--anchor", str(anchor)],
        cwd=ROOT, capture_output=True, text=True, timeout=600, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    keys, stage_keys = reference_keys()
    assert keys <= set(line) and stage_keys <= set(line["stages"])
    assert len(keys) == 24 and len(stage_keys) == 23
    for k in ("value", "end_to_end_frames_per_sec", "fused_frames_per_sec", "fused_k8_frames_per_sec",
              "actor_frames_per_sec"):
        assert np.isfinite(line[k]) and line[k] > 0, k
    assert line["vs_baseline"] == 1.0 and json.loads(anchor.read_text())["depth"] == "smoke"
    assert line["quantize"]["rollout_compression"] == line["stages"]["rollout_compression"] >= 1.8
    assert line["transport"]["shm_vs_socket"] > 0
    assert line["stall"] is None and line["stages"]["stall_async_recovery"] is None
    assert line["host"]["device_kind"] == "cpu" and line["host"]["torch"] == torch.__version__
    assert "actor_collect_ema_s" in line["stages"] and "learner_assemble_ema_s" not in line["stages"]
    assert os.path.exists(line["telemetry_jsonl"])
    os.unlink(line["telemetry_jsonl"])


def test_a_failing_stage_exits_1_with_its_error(monkeypatch, capsys):
    def boom(run):
        raise RuntimeError("boom")

    monkeypatch.setitem(bench.STAGES, "quantize", (boom, bench.STAGES["quantize"][1]))
    assert bench.main(["--smoke", "--device", "cpu", "--stage", "quantize"]) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["quantize"] == {"error": "RuntimeError: boom"}
    assert line["stages"]["rollout_compression"] is None and line["value"] is None


def test_no_device_and_no_card_raises():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--smoke", "--stage", "quantize"])


def test_anchor_in_its_place_and_of_its_card(tmp_path):
    """The first run writes the anchor where it is told (1.0); a later run
    reads it; another card, power limit or depth gives None. The repo's
    ``bench_anchor.json`` is never the default and is never touched."""
    repo_anchor = os.path.join(ROOT, "bench_anchor.json")
    with open(repo_anchor, "rb") as f:
        before = f.read()
    host = bench.host_fingerprint(CPU)
    path = str(tmp_path / "sub" / "anchor.json")
    assert bench.vs_baseline(path, 100.0, host, "smoke") == 1.0
    assert json.loads(open(path).read())["host"] == host
    assert bench.vs_baseline(path, 150.0, host, "smoke") == 1.5
    for other in ({**host, "device_kind": "NVIDIA H100 80GB HBM3"}, {**host, "power_limit": "350.00 W"},
                  {**host, "device_count": 4}):
        assert bench.vs_baseline(path, 150.0, other, "smoke") is None
    assert bench.vs_baseline(path, 150.0, host, "full") is None
    assert json.loads(open(path).read())["frames_per_sec"] == 100.0
    assert os.path.dirname(bench.DEFAULT_ANCHOR) == os.path.join(ROOT, "runs")
    with open(repo_anchor, "rb") as f:
        assert f.read() == before


@pytest.mark.parametrize("lane", ["socket", "shm"])
def test_producer_ships_its_frames_through_the_ports_servers(lane, tmp_path):
    from dotaclient_tpu_torch.transport import ShmTransportServer, TransportServer

    n, payload = 40, bytes(range(256)) * 8
    if lane == "socket":
        server = TransportServer(port=0)
        addr = f"{server.address[0]}:{server.address[1]}"
    else:
        server = ShmTransportServer(name=f"bench-test-{os.getpid()}", slots=2, ring_bytes=1 << 20,
                                    weights_bytes=1 << 16)
        addr = server.address
    proc = subprocess.Popen([sys.executable, "-m", "dotaclient_tpu_torch.transport.bench_producer", "--lane", lane,
                             "--addr", addr, "--frames", str(n), "--payload-hex", payload.hex()],
                            cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT})
    got = []
    try:
        for _ in range(200):
            got += [bytes(p) for _, p in server._drain(n, timeout=0.1)]
            if len(got) >= n:
                break
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
        server.close()
    assert got == [payload] * n


def write_records(d):
    """Records of the port's shape: flat lines and a driver wrapper, two of
    one card and one of another, and one unreadable file."""
    host = {"platform": "Linux-x", "python": "3.12.3", "device_kind": "NVIDIA H100 80GB HBM3", "device_count": 1,
            "power_limit": "700.00 W", "card": "NVIDIA H100 80GB HBM3, 700.00 W", "torch": "2.11.0+cu128",
            "cuda": "12.8"}
    other = {**host, "device_kind": "cpu", "power_limit": None, "card": None, "cuda": None}
    recs = {
        "BENCH_p01.json": {"value": 1000.0, "unit": "frames/sec", "vs_baseline": 1.0, "host": host,
                           "stages": {"health_overhead": 0.01, "advantage_speedup": 1.3, "serve_parity": 1.0}},
        "BENCH_p02.json": {"n": 2, "cmd": "x", "rc": 0, "tail": "", "parsed": {
            "value": 50.0, "unit": "frames/sec", "vs_baseline": None, "host": other,
            "stages": {"health_overhead": 0.2, "advantage_speedup": 1.1}}},
        "BENCH_p03.json": {"value": 1100.0, "unit": "frames/sec", "vs_baseline": 1.1, "host": host,
                           "stages": {"health_overhead": 0.09, "advantage_speedup": 1.0, "serve_parity": 1.0}},
    }
    for name, body in recs.items():
        (d / name).write_text(json.dumps(body))
    (d / "BENCH_p04.json").write_text("{not json")


def trajectory_line(out):
    return next(ln for ln in out.splitlines() if ln.startswith("BENCH_TRAJECTORY "))


@pytest.mark.parametrize("gate", [False, True])
def test_trajectory_prints_the_reference_tools_line(tmp_path, capsys, gate):
    write_records(tmp_path)
    flags = ["--dir", str(tmp_path)] + (["--gate"] if gate else [])
    ref = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "bench_trajectory.py"), *flags],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    rc = bench_trajectory.main(flags)
    port = capsys.readouterr().out
    assert rc == ref.returncode == (1 if gate else 0)
    assert trajectory_line(port) == trajectory_line(ref.stdout)
    assert port.splitlines() == ref.stdout.splitlines()
    line = json.loads(trajectory_line(port)[len("BENCH_TRAJECTORY "):])
    assert [c["headline_ratio"] for c in line["headline_comparisons"]] == [1.1]
    assert line["skipped_unreadable"] == 1


def test_trajectory_compares_no_record_of_the_jax_package(tmp_path, capsys):
    """A record whose host names no torch (the repo's own BENCH_*.json are
    the JAX package's) is skipped, never compared with the port's."""
    write_records(tmp_path)
    jax_host = {"platform": "Linux-x", "device_kind": "TPU v5 lite", "device_count": 1, "forced_host": False,
                "jax": "0.4.30", "libtpu": None}
    (tmp_path / "BENCH_p00.json").write_text(json.dumps({"value": 9e9, "unit": "frames/sec", "host": jax_host,
                                                         "stages": {"health_overhead": 0.5}}))
    assert bench_trajectory.main(["--dir", str(tmp_path)]) == 0
    line = json.loads(trajectory_line(capsys.readouterr().out)[len("BENCH_TRAJECTORY "):])
    assert line["skipped_unreadable"] == 2 and "BENCH_p00.json" not in json.dumps(line)
    assert [s["value"] for s in line["ratio_stages"]["health_overhead"]] == [0.01, 0.2, 0.09]
