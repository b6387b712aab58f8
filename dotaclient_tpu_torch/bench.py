"""The port's benchmark line: PPO optimizer frames/s and the thirteen stages.

Counterpart of the reference's ``bench.py``, for the port on a CUDA card.
The headline is the learner's hot path: ``train/ppo.py``'s train step
(sequence forward, GAE, loss, backward, Adam) on a device-resident batch of
``default_config()``'s B x T. Beside it, on the same line:
``end_to_end_frames_per_sec`` (the buffered learner at 128 games against the
easy bot: the device rollout, the ring, the update), the fused learner's
frames/s at one and at eight iterations a call, and ``actor_frames_per_sec``
(``DeviceActor.collect`` alone). ``stages`` carries the e2e run's per-span
breakdown, read from its run record, and each stage's headline ratio.

The stages, in the reference's order, each with its variants, depth,
best-of rule and output keys: transport (socket against shm lanes, a child
producer process; the weights fanout), stall (the buffered loop with
publishes, checkpoints and log lines, sync against async snapshots, against
the loop without them), health, trace, fleet, outcome and utilization (the
fused loop with each plane off against on), quantize (the bf16 rollout
wire), advantage (the one-pass advantage plane against the in-step
recompute, and its parity digest), multichip and fused_multichip (through
``utils/run_multichip.py``'s probes), serve (the continuous-batching
server's curve over batch windows, and its parity digest) and serve_fleet
(a routed fleet through a backend's death, and the re-home digest).

Prints ONE JSON line with the reference's keys plus ``host``, the card's
fingerprint. ``vs_baseline`` is the headline against the anchor file
(``--anchor``; the first run on a card and depth writes it), null when the
anchor was taken on another card, power limit or depth. A stage that raises
gets ``{"error": ...}`` under its key, as in the reference, but the CLI
then exits 1: no failure is hidden behind exit 0.

Usage:
    python -m dotaclient_tpu_torch.bench                        # all, on the card, the reference's depth
    python -m dotaclient_tpu_torch.bench --stage headline --stage stall
    python -m dotaclient_tpu_torch.bench --smoke --device cpu   # the learner's --smoke sizes, a few steps

``--smoke`` trains at the learner's ``--smoke`` sizes (4 games, chunks of 8,
batches of 8) for a few steps a variant, at the default model's widths; it
keeps each stage's own shapes (the advantage stage's E=16 M=2 T=4 B=64, the
serve curve's 16 clients). Its numbers check the path, they measure
nothing. Without ``--device cpu`` every stage runs on the card and raises
without one.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import platform
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# git-ignored (runs/): the port never writes the repo's bench_anchor.json
DEFAULT_ANCHOR = os.path.join(REPO, "runs", "bench_anchor_torch.json")


@dataclasses.dataclass(frozen=True)
class Depth:
    """How long each measurement runs: the reference's numbers, or
    ``--smoke``'s few steps. Warm-up steps, timed steps a segment, and the
    segments whose best is kept."""

    name: str
    # the traffic of the learner stages: games, the ring, game length
    envs: int
    capacity: int
    min_fill: int
    max_dota_time: float
    opt_warm: int
    opt_steps: int
    trials: int
    e2e_warm: int
    e2e_steps: int
    fused_warm: int
    k8_warm: int
    k8_steps: int
    collects: int
    transport_trials: int
    frames_16k: int
    frames_full: int
    publishes: int
    stall_warm: int
    plane_warm: int
    plane_steps: int
    plane_trials: int
    ingest_batches: int
    quant_steps: int
    adv_batches: int
    adv_batches_t16: int
    adv_trials: int
    overlap_steps: int
    probe_steps: int
    probe_parity_steps: int
    fused_probe_steps: int
    serve_requests: int
    serve_trials: int
    fleet_requests: int


FULL = Depth(name="full", envs=128, capacity=512, min_fill=128, max_dota_time=120.0, opt_warm=3, opt_steps=50,
             trials=3, e2e_warm=20, e2e_steps=100, fused_warm=10, k8_warm=16, k8_steps=100, collects=20,
             transport_trials=3, frames_16k=4000, frames_full=1500, publishes=12, stall_warm=30, plane_warm=10,
             plane_steps=100, plane_trials=2, ingest_batches=6, quant_steps=60, adv_batches=12, adv_batches_t16=8,
             adv_trials=3, overlap_steps=64, probe_steps=8, probe_parity_steps=3, fused_probe_steps=4,
             serve_requests=40, serve_trials=2, fleet_requests=60)
SMOKE = Depth(name="smoke", envs=4, capacity=32, min_fill=8, max_dota_time=60.0, opt_warm=1, opt_steps=2,
              trials=1, e2e_warm=2, e2e_steps=2, fused_warm=1, k8_warm=8, k8_steps=8, collects=2,
              transport_trials=1, frames_16k=200, frames_full=50, publishes=3, stall_warm=2, plane_warm=1,
              plane_steps=2, plane_trials=1, ingest_batches=1, quant_steps=2, adv_batches=1, adv_batches_t16=1,
              adv_trials=1, overlap_steps=4, probe_steps=2, probe_parity_steps=2, fused_probe_steps=2,
              serve_requests=4, serve_trials=1, fleet_requests=20)


@dataclasses.dataclass
class Run:
    """What every stage gets: the base config, the device, the depth and the
    seed of the params and learners."""

    config: Any
    device: Any
    depth: Depth
    seed: int = 0


# -- helpers ------------------------------------------------------------------------------------------


def sync(device) -> None:
    """Wait for the card (a timed segment ends when its work has)."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fresh_state(config, run: Run, device=None):
    """A TrainState over a fresh policy with the seed's params, on the
    run's device or ``device``."""
    import torch

    from dotaclient_tpu_torch.models.policy import init_params, make_policy
    from dotaclient_tpu_torch.train.ppo import init_train_state

    policy = make_policy(config.model, config.obs, config.actions, device=device or run.device)
    init_params(policy, torch.Generator().manual_seed(run.seed))
    return init_train_state(policy, config.ppo)


def seeded_batch(config, B: int, rng: np.random.Generator, device):
    """``example_batch`` made non-degenerate as the reference's: normal unit
    features, rewards at 0.1 scale, negative behaviour log-probs."""
    import torch

    from dotaclient_tpu_torch.train.ppo import example_batch

    T = config.ppo.rollout_len
    batch = example_batch(config, B, device=device)
    batch["obs"]["units"] = torch.from_numpy(
        rng.normal(size=tuple(batch["obs"]["units"].shape)).astype(np.float32)).to(device)
    batch["rewards"] = torch.from_numpy((rng.normal(size=(B, T)) * 0.1).astype(np.float32)).to(device)
    batch["behavior_logp"] = torch.from_numpy(-np.abs(rng.normal(size=(B, T))).astype(np.float32)).to(device)
    return batch


def traffic(run: Run, **extra):
    """The learner stages' config: the depth's games against the easy bot
    and its ring (the reference's 128 games, a ring of 512 filled to 128)."""
    c, d = run.config, run.depth
    return dataclasses.replace(
        c,
        env=dataclasses.replace(c.env, n_envs=d.envs, opponent="scripted_easy", max_dota_time=d.max_dota_time),
        buffer=dataclasses.replace(c.buffer, capacity_rollouts=d.capacity, min_fill=d.min_fill),
        **extra,
    )


def best_of(trials: int, segment: Callable[[], float]) -> float:
    """The best of ``trials`` rates: capability, not luck, on a shared host."""
    return max(segment() for _ in range(trials))


def train_rate(learner, steps: int, frames_per_step: Optional[int] = None) -> float:
    """One timed ``train(steps)`` segment: ``frames_per_step x steps``, or
    the frames the call trained, over the host clock."""
    t0 = time.perf_counter()
    out = learner.train(steps)
    dt = time.perf_counter() - t0
    return (steps * frames_per_step if frames_per_step is not None else out["frames_trained"]) / dt


def overhead(off: float, on: float) -> float:
    """The share of throughput a plane costs, clamped at 0 (host noise)."""
    return round(max(0.0, 1.0 - on / off), 4) if off else 1.0


def plane_steps_per_sec(run: Run, cfg) -> float:
    """A fused learner on ``cfg``: warm-up, then the best of the depth's
    segments in steps/s."""
    from dotaclient_tpu_torch.train.learner import Learner

    d = run.depth
    learner = Learner(cfg, actor="fused", seed=run.seed, device=run.device)
    try:
        learner.train(d.plane_warm)   # settle
        return round(best_of(d.plane_trials, lambda: train_rate(learner, d.plane_steps, 1)), 2)
    finally:
        learner.close()


# -- the headline ---------------------------------------------------------------------------------------


def bench_headline(run: Run) -> Dict[str, Any]:
    """The optimizer frames/s on a device batch, the buffered learner end to
    end (its run record's spans), the fused learner at 1 and 8 iterations a
    call, and the device actor's collect alone."""
    from dotaclient_tpu_torch.train.learner import Learner
    from dotaclient_tpu_torch.train.ppo import make_train_step

    config, dev, d = run.config, run.device, run.depth
    B, T = config.ppo.batch_rollouts, config.ppo.rollout_len
    state = fresh_state(config, run)
    step = make_train_step(config)
    batch = seeded_batch(config, B, np.random.default_rng(0), dev)

    def opt_segment(n):
        nonlocal state
        t0 = time.perf_counter()
        for _ in range(n):
            state, m = step(state, batch)
        sync(dev)
        return B * T * n / (time.perf_counter() - t0)

    opt_segment(run.depth.opt_warm)
    frames_per_sec = best_of(d.trials, lambda: opt_segment(d.opt_steps))
    del state

    e2e_config = traffic(run, log_every=10_000)
    # the run record of the e2e learner: the line's per-span breakdown
    fd, telemetry_path = tempfile.mkstemp(suffix=".jsonl", prefix="tpu_dota_torch_bench_telemetry_")
    os.close(fd)
    learner = Learner(e2e_config, actor="device", seed=run.seed, device=dev, metrics_jsonl=telemetry_path)
    try:
        learner.train(d.e2e_warm)   # the first collects and the ring's fill
        e2e_fps = best_of(d.trials, lambda: train_rate(learner, d.e2e_steps, B * T))

        fused = Learner(e2e_config, actor="fused", seed=run.seed, device=dev)
        try:
            fused.train(d.fused_warm)
            fused_fps = best_of(d.trials, lambda: train_rate(fused, d.e2e_steps, fused.device_actor.n_lanes * T))
        finally:
            fused.close()
        # eight iterations a call: frames_trained (the call overshoots the
        # request in strides of 8)
        k8 = Learner(dataclasses.replace(e2e_config, steps_per_dispatch=8), actor="fused", seed=run.seed,
                     device=dev)
        try:
            k8.train(d.k8_warm)
            k8_fps = best_of(d.trials, lambda: train_rate(k8, d.k8_steps))
        finally:
            k8.close()

        da = learner.device_actor
        da.collect(learner.policy)
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(d.collects):
            da.collect(learner.policy)
        sync(dev)
        actor_fps = d.collects * da.n_lanes * T / (time.perf_counter() - t0)
    finally:
        learner.close()
    return {"frames_per_sec": frames_per_sec, "end_to_end_frames_per_sec": e2e_fps, "fused_frames_per_sec": fused_fps,
            "fused_k8_frames_per_sec": k8_fps, "actor_frames_per_sec": actor_fps,
            "stages": record_stages(telemetry_path), "telemetry_jsonl": telemetry_path}


# the e2e run record's keys under the line's names (the reference's list;
# the port emits no learner/assemble span, so that key stays absent)
RECORD_STAGES = (
    ("actor_collect_ema_s", "span/actor/collect/ema_s"),
    ("buffer_stage_ema_s", "span/buffer/stage/ema_s"),
    ("buffer_insert_ema_s", "span/buffer/insert/ema_s"),
    ("buffer_sample_ema_s", "span/buffer/sample/ema_s"),
    ("learner_assemble_ema_s", "span/learner/assemble/ema_s"),
    ("learner_dispatch_ema_s", "span/learner/dispatch/ema_s"),
    ("learner_prefetch_ema_s", "span/learner/prefetch/ema_s"),
    ("prefetch_hit_rate", "learner/prefetch_hit_rate"),
    ("overlap_fraction", "learner/overlap_fraction"),
    ("metrics_fetch_ema_s", "span/learner/metrics_fetch/ema_s"),
    ("buffer_occupancy", "buffer/occupancy"),
    ("queue_depth", "transport/queue_depth"),
    ("weight_staleness", "actor/weight_staleness"),
)


def record_stages(path: str) -> Dict[str, float]:
    """The last record line's spans and pipeline gauges, where present."""
    try:
        with open(path) as f:
            lines = f.read().splitlines()
        last = json.loads(lines[-1])["scalars"] if lines else {}
    except (OSError, ValueError, KeyError, IndexError):
        return {}
    return {label: round(float(last[key]), 6) for label, key in RECORD_STAGES
            if key in last and last[key] is not None}


# -- the stages -----------------------------------------------------------------------------------------


def bench_transport(run: Run) -> Dict[str, Any]:
    """Transport stage, on the host: a child producer process
    (``transport/bench_producer.py``, no torch) ships rollout frames
    through loopback TCP and through the shm ring, each drained with the
    raw server-side drain, at the benchmark config's full chunk and at 16
    KiB. ``shm_vs_socket`` is the geometric mean of the per-size ratios,
    each the best of the depth's interleaved trials. Then the weights
    fanout: 8 in-process actors on one ``TransportServer``, the publish's
    host time (an enqueue a connection) and the lag until every actor sees
    the last version."""
    from dotaclient_tpu_torch.models.convert import to_flax
    from dotaclient_tpu_torch.transport import ShmTransportServer, SocketTransport, TransportServer, encode_weights

    config, d = run.config, run.depth
    full_frame = rollout_frames(config)["f32"]

    def run_lane(lane: str, tag: str, n_frames: int, frame_bytes: int) -> float:
        if lane == "socket":
            server = TransportServer(port=0, max_rollouts=4 * n_frames)
            addr = f"{server.address[0]}:{server.address[1]}"
        else:
            server = ShmTransportServer(name=f"bench-{os.getpid()}-{tag}", slots=2,
                                        ring_bytes=config.transport.shm_ring_bytes, weights_bytes=1 << 20)
            addr = server.address
        proc = subprocess.Popen(
            [sys.executable, "-m", "dotaclient_tpu_torch.transport.bench_producer", "--lane", lane, "--addr", addr,
             "--frames", str(n_frames), "--bytes", str(frame_bytes)],
            cwd=REPO, env={**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")},
        )
        got, base, t0 = 0, 0, None
        t_spawn = time.perf_counter()
        deadline = time.time() + 120
        batch = None
        try:
            while got < n_frames and time.time() < deadline:
                batch = server._drain(4 * n_frames, timeout=1.0)
                if batch:
                    if t0 is None:   # the clock starts at the first arrival, not the spawn
                        t0 = time.perf_counter()
                        base = len(batch)
                    got += len(batch)
            fps = 0.0
            if t0 is not None and got > base:
                fps = (got - base) / (time.perf_counter() - t0)
            elif got:   # one drain took everything: the spawn's latency included
                fps = got / (time.perf_counter() - t_spawn)
            if got < n_frames:
                raise RuntimeError(f"{lane} lane: {got} of {n_frames} frames of {frame_bytes} B arrived")
        finally:
            batch = None   # release the zero-copy views before the server goes
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()   # never leave a spinning producer behind
                proc.wait(timeout=10)
            server.close()
        return fps

    sizes = {"16k": (16384, d.frames_16k), "full": (len(full_frame), d.frames_full)}
    lanes: Dict[str, Any] = {}
    for label, (nbytes, n_frames) in sizes.items():
        socket_fps, shm_fps = 0.0, 0.0
        for trial in range(d.transport_trials):   # interleaved: noise hits both lanes
            socket_fps = max(socket_fps, run_lane("socket", f"s{label}{trial}", n_frames, nbytes))
            shm_fps = max(shm_fps, run_lane("shm", f"m{label}{trial}", n_frames, nbytes))
        lanes[label] = {"frame_bytes": nbytes, "socket_fps": round(socket_fps, 1), "shm_fps": round(shm_fps, 1),
                        "ratio": round(shm_fps / socket_fps, 2) if socket_fps else 0.0}
    ratios = [v["ratio"] for v in lanes.values()]
    # a size that failed to measure (ratio 0) fails the headline
    headline = round(float(np.exp(np.mean(np.log(ratios)))), 2) if ratios and all(r > 0 for r in ratios) else 0.0

    # -- the weights fanout at 8 actors --
    host_params = to_flax(fresh_state(config, run, "cpu").policy.state_dict())
    n_actors = 8
    server = TransportServer(port=0)
    host, port = server.address[:2]
    actors = [SocketTransport(host, port) for _ in range(n_actors)]
    try:
        deadline = time.time() + 10
        while server.n_connected < n_actors and time.time() < deadline:
            time.sleep(0.01)
        publish_s = []
        for v in range(1, d.publishes + 1):
            msg = encode_weights(host_params, v, wire_dtype=config.transport.wire_dtype)
            t0 = time.perf_counter()
            server.publish_weights(msg)
            publish_s.append(time.perf_counter() - t0)
            time.sleep(0.03)
        t0 = time.perf_counter()
        deadline = time.time() + 30
        while time.time() < deadline:
            if all((a.latest_weights().version if a.latest_weights() else 0) == d.publishes for a in actors):
                break
            time.sleep(0.01)
        delivery_s = time.perf_counter() - t0
    finally:
        for a in actors:
            a.close()
        server.close()
    return {
        "socket_rollout_fps": lanes["full"]["socket_fps"],
        "shm_rollout_fps": lanes["full"]["shm_fps"],
        "shm_vs_socket": headline,
        "rollout_lanes": lanes,
        "fanout_actors": n_actors,
        "fanout_publish_p50_s": round(sorted(publish_s)[len(publish_s) // 2], 6),
        "fanout_delivery_lag_s": round(delivery_s, 4),
        "fanout_wire_bytes_f32": len(encode_weights(host_params, 1).SerializeToString()),
        "fanout_wire_bytes_bf16": len(encode_weights(host_params, 1, wire_dtype="bfloat16").SerializeToString()),
    }


def bench_stall(run: Run) -> Dict[str, Any]:
    """Stall stage: the buffered loop's steps/s with its side effects on (a
    weights publish every 10 batches onto a socket transport, a checkpoint
    every 25 steps, a log line every 10), sync against async snapshots,
    against the loop with none of them. The bar is ``async_recovery`` >=
    0.9 of that ceiling. On the card the engine's copies run on a stream
    and a thread of their own (``train/snapshot.py``), so the async loop
    issues on while a save's host copy lands; the sync loop waits for it.
    Checkpoints go to /dev/shm where it is writable: the stage measures the
    loop's stall, not the disk."""
    from dotaclient_tpu_torch.config import LearnerConfig
    from dotaclient_tpu_torch.train.learner import Learner
    from dotaclient_tpu_torch.transport import TransportServer

    d = run.depth
    base = traffic(run)
    out: Dict[str, Any] = {}
    tmp = tempfile.mkdtemp(prefix="tpu_dota_torch_bench_stall_",
                           dir="/dev/shm" if os.access("/dev/shm", os.W_OK) else None)
    try:
        for label in ("disabled", "sync", "async"):
            if label == "disabled":
                # no checkpoint directory, no log boundary in range, the
                # in-process transport (no mid-run publish): the ceiling
                cfg, transport, ckdir = dataclasses.replace(base, log_every=10 ** 9), None, None
            else:
                cfg = dataclasses.replace(base, log_every=10, checkpoint_every=25,
                                          learner=LearnerConfig(async_snapshots=label == "async"))
                transport, ckdir = TransportServer(port=0), os.path.join(tmp, label)
            try:
                learner = Learner(cfg, actor="device", seed=run.seed, device=run.device, transport=transport,
                                  checkpoint_dir=ckdir)
                try:
                    # the warm-up crosses every boundary kind (log 10,
                    # publish 10, checkpoint 25) before the clock starts
                    learner.train(d.stall_warm, refresh_every=10)

                    def segment():
                        t0 = time.perf_counter()
                        learner.train(d.plane_steps, refresh_every=10)
                        return d.plane_steps / (time.perf_counter() - t0)

                    out[f"{label}_steps_per_sec"] = round(best_of(d.plane_trials, segment), 2)
                finally:
                    learner.close()
            finally:
                if transport is not None:
                    transport.close()
        ceiling = out["disabled_steps_per_sec"]
        out["sync_recovery"] = round(out["sync_steps_per_sec"] / ceiling, 3) if ceiling else 0.0
        out["async_recovery"] = round(out["async_steps_per_sec"] / ceiling, 3) if ceiling else 0.0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def bench_health(run: Run) -> Dict[str, Any]:
    """Health stage: the fused loop's steps/s with the training-health
    probe off and on (its scalar ops in the update, a verdict submitted a
    call). Bar: ``health_overhead`` <= 0.02."""
    from dotaclient_tpu_torch.config import HealthConfig

    base = traffic(run, log_every=10 ** 9)   # no boundaries: the probe is the subject
    out: Dict[str, Any] = {}
    for label, enabled in (("off", False), ("on", True)):
        out[f"{label}_steps_per_sec"] = plane_steps_per_sec(
            run, dataclasses.replace(base, health=HealthConfig(enabled=enabled)))
    out["health_overhead"] = overhead(out["off_steps_per_sec"], out["on_steps_per_sec"])
    return out


def bench_trace(run: Run) -> Dict[str, Any]:
    """Trace stage: the fused loop's steps/s with pipeline tracing off,
    sampled (``telemetry.trace_sample_n``'s default) and on every chunk.
    Off costs one pointer test a site (the tracer is captured at
    construction). Bar: ``trace_overhead`` (sampled) <= 0.02; every-chunk
    is reported beside it. The tracer is process state, removed in a
    ``finally``."""
    from dotaclient_tpu_torch.utils import tracing

    base = traffic(run, log_every=10 ** 9)   # no boundaries: tracing is the subject
    out: Dict[str, Any] = {}
    tmp = tempfile.mkdtemp(prefix="tpu_dota_torch_bench_trace_",
                           dir="/dev/shm" if os.access("/dev/shm", os.W_OK) else None)
    try:
        for label, sample in (("off", None), ("sampled", None), ("every", 1)):
            tracing.configure(None if label == "off" else os.path.join(tmp, f"{label}.jsonl"), sample_n=sample)
            out[f"{label}_steps_per_sec"] = plane_steps_per_sec(run, base)
    finally:
        tracing.configure(None)
        shutil.rmtree(tmp, ignore_errors=True)
    out["trace_overhead"] = overhead(out["off_steps_per_sec"], out["sampled_steps_per_sec"])
    out["trace_overhead_every"] = overhead(out["off_steps_per_sec"], out["every_steps_per_sec"])
    return out


def _with_feeder(counters_of: Callable[[int], Tuple[Dict[str, float], Dict[str, float]]], tick_hook=None):
    """A live ``FleetAggregator`` at a 50 ms cadence (100x the production
    interval) and a thread feeding it 4 synthetic peers' encoded snapshots
    every 50 ms; returns (stop, the aggregator)."""
    from dotaclient_tpu_torch.utils.fleet import FleetAggregator, encode_snapshot

    agg = FleetAggregator(interval_s=0.05, emit_event=None)
    if tick_hook is not None:
        agg.add_tick_hook(tick_hook)
    agg.start()
    stop = threading.Event()

    def feed() -> None:
        seq = 0
        while not stop.wait(0.05):
            seq += 1
            counters, gauges = counters_of(seq)
            for peer in range(4):
                agg.ingest(encode_snapshot(peer, "actor", seq, counters, gauges))

    feeder = threading.Thread(target=feed, name="bench-fleet-feeder", daemon=True)
    feeder.start()

    def halt() -> None:
        stop.set()
        feeder.join(timeout=2.0)
        agg.stop()

    return halt


def bench_fleet(run: Run) -> Dict[str, Any]:
    """Fleet stage: the fused loop's steps/s with the fleet plane off and
    on: a live aggregator merging 4 synthetic peers' encoded snapshots and
    evaluating the alert rules every 50 ms. The train thread does nothing
    of the fleet's. Bar: ``fleet_overhead`` <= 0.02."""
    from dotaclient_tpu_torch.utils import telemetry

    base = traffic(run, log_every=10 ** 9)   # no boundaries: the fleet plane is the subject
    out: Dict[str, Any] = {}
    for label in ("off", "on"):
        halt = None
        try:
            if label == "on":
                halt = _with_feeder(lambda seq: ({"actor/env_steps": 512.0 * seq, "transport/reconnects_total": 0.0},
                                                 {"actor/weight_refresh_lag": 1.0}))
            out[f"{label}_steps_per_sec"] = plane_steps_per_sec(run, base)
        finally:
            if halt is not None:
                halt()
        if label == "on":
            out["snapshots_merged"] = telemetry.get_registry().snapshot().get("fleet/snapshots_total", 0.0)
    out["fleet_overhead"] = overhead(out["off_steps_per_sec"], out["on_steps_per_sec"])
    return out


def bench_outcome(run: Run) -> Dict[str, Any]:
    """Outcome stage: the fused loop's steps/s with the outcome plane's
    learner side off and on: the fleet aggregator merging 4 peers'
    outcome-bearing snapshots with the ``OutcomeAggregator``'s windowed
    curves hooked into every 50 ms tick. The episode counts and lengths
    the rollout extracts on the card are part of the rollout in both
    variants: masked sums and a histogram's scatter-add issued beside its
    other statistics. Bar: ``outcome_overhead`` <= 0.02."""
    from dotaclient_tpu_torch.outcome.aggregator import OutcomeAggregator
    from dotaclient_tpu_torch.outcome.records import REWARD_TERMS
    from dotaclient_tpu_torch.utils import telemetry

    base = traffic(run, log_every=10 ** 9)   # no boundaries: the outcome plane is the subject

    def counters(seq):
        episodes = 4.0 * seq
        return ({"outcome/episodes/vs_scripted": episodes, "outcome/wins/vs_scripted": episodes * 0.6,
                 "outcome/ep_len_sum": episodes * 150.0, "outcome/ep_len_hist/07": episodes,
                 **{f"outcome/reward_sum/{t}": episodes for t in REWARD_TERMS}}, {})

    out: Dict[str, Any] = {}
    for label in ("off", "on"):
        halt = None
        # everything that starts a thread sits inside the try: a failed
        # learner still tears the feeder and the aggregator down
        try:
            if label == "on":
                halt = _with_feeder(counters, tick_hook=OutcomeAggregator(window_s=5.0).tick)
            out[f"{label}_steps_per_sec"] = plane_steps_per_sec(run, base)
        finally:
            if halt is not None:
                halt()
        if label == "on":
            snap = telemetry.get_registry().snapshot()
            out["snapshots_merged"] = snap.get("fleet/snapshots_total", 0.0)
            out["win_rate_vs_scripted"] = round(snap.get("outcome/win_rate/vs_scripted", 0.0), 4)
    out["outcome_overhead"] = overhead(out["off_steps_per_sec"], out["on_steps_per_sec"])
    return out


def bench_utilization(run: Run) -> Dict[str, Any]:
    """Utilization stage: the fused loop's steps/s with the phase
    accountant off (the module knob ``utilization.enabled``: every site a
    pointer test) and on (the default: clock pairs at the phase boundaries,
    a fold at train boundaries). Bar: ``utilization_overhead`` <= 0.02. The
    on variant also reports the duty cycle. The knob is restored in a
    ``finally``."""
    from dotaclient_tpu_torch.utils import telemetry, utilization

    base = traffic(run, log_every=10 ** 9)   # no boundaries: the accountant is the subject
    out: Dict[str, Any] = {}
    for label in ("off", "on"):
        utilization.enabled = label == "on"
        try:
            out[f"{label}_steps_per_sec"] = plane_steps_per_sec(run, base)
        finally:
            utilization.enabled = True
        if label == "on":
            snap = telemetry.get_registry().snapshot()
            out["duty_cycle"] = round(snap.get("util/duty_cycle", 0.0), 4)
            out["util_armed"] = snap.get("util/armed", 0.0)
    out["utilization_overhead"] = overhead(out["off_steps_per_sec"], out["on_steps_per_sec"])
    return out


def rollout_frames(config) -> Dict[str, bytes]:
    """One benchmark-config chunk (``example_batch``'s row) through
    ``encode_rollout_bytes`` on the f32 wire and on the bf16 wire."""
    from dotaclient_tpu_torch.train.ppo import example_batch
    from dotaclient_tpu_torch.transport.serialize import encode_rollout_bytes, rollout_wire_kwargs
    from dotaclient_tpu_torch.utils.tree import tree_map

    T = config.ppo.rollout_len
    row = tree_map(lambda t: t[0].numpy(), example_batch(config, 1, device="cpu"))
    return {label: bytes(encode_rollout_bytes(row, 0, 0, 0, T, 0.0, **rollout_wire_kwargs(cfg)))
            for label, cfg in quantize_configs(config).items()}


def quantize_configs(config) -> Dict[str, Any]:
    return {"f32": config, "bf16": dataclasses.replace(
        config, transport=dataclasses.replace(config.transport, rollout_wire_dtype="bfloat16"))}


def bench_quantize(run: Run) -> Dict[str, Any]:
    """Quantize stage: the rollout plane on the bf16 wire against f32. The
    wire bytes of one chunk both ways (``rollout_compression``, bar >=
    1.8); decode -> ``add`` -> ``take`` frames/s into each ring (the bf16
    ring stores narrow and widens at ``take``), the best of the depth's
    interleaved trials; and the optimizer's frames/s through each ring's
    held take and requeue (the narrow path within 2% of f32), the train
    step made once and shared."""
    from dotaclient_tpu_torch.buffer.trajectory_buffer import TrajectoryBuffer
    from dotaclient_tpu_torch.train.ppo import make_train_step
    from dotaclient_tpu_torch.transport.serialize import decode_rollout_bytes

    config, dev, d = run.config, run.device, run.depth
    B, T = config.ppo.batch_rollouts, config.ppo.rollout_len
    cfgs = quantize_configs(config)
    frames = rollout_frames(config)
    out: Dict[str, Any] = {
        "wire_bytes_per_frame_f32": len(frames["f32"]),
        "wire_bytes_per_frame_bf16": len(frames["bf16"]),
        "rollout_compression": round(len(frames["f32"]) / len(frames["bf16"]), 2) if frames["bf16"] else 0.0,
    }
    buffers = {k: TrajectoryBuffer(cfg, device=dev) for k, cfg in cfgs.items()}

    def fill(label):
        decoded = []
        for i in range(B):
            meta, arrays = decode_rollout_bytes(frames[label])
            meta["rollout_id"] = i
            decoded.append((meta, arrays))
        buffers[label].add(decoded, current_version=0)

    def ingest_consume(label: str, n_batches: int) -> float:
        t0 = time.perf_counter()
        for _ in range(n_batches):
            fill(label)
            if buffers[label].take(batch_size=B) is None:
                raise RuntimeError(f"the {label} ring gave no batch after {B} rows")
        sync(dev)
        return n_batches * B / (time.perf_counter() - t0)

    ingest = {"f32": 0.0, "bf16": 0.0}
    for label in ingest:   # warm-up: the first staging and gathers of each width
        ingest_consume(label, 1)
    for _ in range(d.trials):   # interleaved: noise hits both widths
        for label in ingest:
            ingest[label] = max(ingest[label], ingest_consume(label, d.ingest_batches))
    out["ingest_consume_fps_f32"] = round(ingest["f32"], 1)
    out["ingest_consume_fps_bf16"] = round(ingest["bf16"], 1)

    step = make_train_step(config)
    states = {k: fresh_state(config, run) for k in cfgs}
    for label in cfgs:   # one batch parked in each ring for take/requeue
        fill(label)

    def optimizer_loop(label: str, n_steps: int) -> float:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            batch, ticket = buffers[label].take(batch_size=B, hold=True)
            states[label], _ = step(states[label], batch)
            buffers[label].requeue(ticket)   # the same rows gather again
        sync(dev)
        return n_steps * B * T / (time.perf_counter() - t0)

    opt = {"f32": 0.0, "bf16": 0.0}
    for label in opt:
        optimizer_loop(label, d.opt_warm)
    for _ in range(d.plane_trials):
        for label in opt:
            opt[label] = max(opt[label], optimizer_loop(label, d.quant_steps))
    out["optimizer_fps_f32"] = round(opt["f32"], 1)
    out["optimizer_fps_bf16"] = round(opt["bf16"], 1)
    out["optimizer_ratio"] = round(opt["bf16"] / opt["f32"], 4) if opt["f32"] else 0.0
    return out


def advantage_parity(run: Run) -> Dict[str, Any]:
    """The one-pass plane's parity digest on the run's config: the pass's
    f32 output bitwise the in-step estimator's formula
    (``advantages_and_returns``) on the same params and batch, and the
    train step's loss on the precomputed advantages within 1e-5 relative
    of the recompute step's."""
    import torch

    from dotaclient_tpu_torch.train.advantage import advantages_and_returns, make_advantage_pass
    from dotaclient_tpu_torch.train.ppo import make_train_step

    config, dev = run.config, run.device
    B = config.ppo.batch_rollouts
    batch = seeded_batch(config, B, np.random.default_rng(3), dev)
    f32_cfg = dataclasses.replace(config, ppo=dataclasses.replace(config.ppo, advantage_dtype="float32"))
    s_re, s_op = fresh_state(config, run), fresh_state(config, run)
    adv, ret = make_advantage_pass(s_op.policy, f32_cfg)(batch)
    adv_ref, ret_ref = advantages_and_returns(s_re.policy, batch, config.ppo)
    bitwise = bool(torch.equal(adv, adv_ref) and torch.equal(ret, ret_ref))
    step = make_train_step(config)
    _, m_re = step(s_re, batch)
    _, m_op = step(s_op, {**batch, "advantages": adv, "returns": ret})
    loss_re, loss_op = float(m_re["loss"]), float(m_op["loss"])
    delta = abs(loss_re - loss_op)
    losses_ok = delta <= 1e-5 * max(1e-3, abs(loss_re))
    return {"parity_bitwise_adv": 1.0 if bitwise else 0.0, "parity_loss_delta": delta,
            "parity": 1.0 if bitwise and losses_ok else 0.0}


def bench_advantage(run: Run) -> Dict[str, Any]:
    """Advantage stage: the one-pass advantage plane at E x M >= 4, the
    in-step recompute against the pass (serial) and the pass issued behind
    the previous epoch step (overlap), optimizer frames/s on a fixed device
    batch, the best of the depth's interleaved trials. The headline shape
    is the deep-epoch short chunk, E=16 M=2 T=4 B=64, where the plane's
    removal of the bootstrap slot and the estimator from every update shows;
    E=4 M=2 T=16 B=32 is reported beside it (``*_t16``). Bar:
    ``advantage_speedup`` >= 1.15. Then the parity digest, and
    ``advantage/overlap_fraction`` from a short buffered learner run."""
    from dotaclient_tpu_torch.train.advantage import make_advantage_pass
    from dotaclient_tpu_torch.train.learner import Learner
    from dotaclient_tpu_torch.train.ppo import make_epoch_step
    from dotaclient_tpu_torch.utils import telemetry

    config, dev, d = run.config, run.device, run.depth

    def measure(E, M, T, B, n_batches):
        cfg = dataclasses.replace(config, ppo=dataclasses.replace(
            config.ppo, epochs_per_batch=E, minibatches=M, rollout_len=T, batch_rollouts=B))
        batch = seeded_batch(cfg, B, np.random.default_rng(0), dev)
        epoch = make_epoch_step(cfg)
        prng = np.random.default_rng(7)

        def perms():
            return np.stack([prng.permutation(B) for _ in range(E)]).astype(np.int32)

        def run_recompute(state, n):
            for _ in range(n):
                state, _ = epoch(state, batch, perms())
            return state

        def run_onepass(state, n):
            # serial: the pass runs at consume time, before the update
            apass = make_advantage_pass(state.policy, cfg)
            for _ in range(n):
                adv, ret = apass(batch)
                state, _ = epoch(state, {**batch, "advantages": adv, "returns": ret}, perms())
            return state

        def run_overlap(state, n):
            # batch N+1's pass issued right behind batch N's epoch step, on
            # its output params (the learner's prefetch order)
            apass = make_advantage_pass(state.policy, cfg)
            adv, ret = apass(batch)
            for i in range(n):
                state, _ = epoch(state, {**batch, "advantages": adv, "returns": ret}, perms())
                if i + 1 < n:
                    adv, ret = apass(batch)
            return state

        runners = {"recompute": run_recompute, "onepass": run_onepass, "overlap": run_overlap}
        states = {k: fresh_state(cfg, run) for k in runners}
        for k, fn in runners.items():   # settle
            states[k] = fn(states[k], 1)
        sync(dev)
        best = {k: 0.0 for k in runners}
        for _ in range(d.adv_trials):   # interleaved: noise hits every variant
            for k, fn in runners.items():
                t0 = time.perf_counter()
                states[k] = fn(states[k], n_batches)
                sync(dev)
                best[k] = max(best[k], n_batches * E * B * T / (time.perf_counter() - t0))
        return {k: round(v, 1) for k, v in best.items()}

    head = measure(E=16, M=2, T=4, B=64, n_batches=d.adv_batches)
    t16 = measure(E=4, M=2, T=16, B=32, n_batches=d.adv_batches_t16)

    def speedup(r):
        return round(max(r["overlap"], r["onepass"]) / r["recompute"], 3) if r["recompute"] else 0.0

    out: Dict[str, Any] = {
        "headline_shape": "E=16 M=2 T=4 B=64",
        **{f"{k}_fps": v for k, v in head.items()},
        **{f"{k}_fps_t16": v for k, v in t16.items()},
        # the better of the two schedules: either is the plane
        "advantage_speedup": speedup(head),
        "advantage_speedup_t16": speedup(t16),
        **advantage_parity(run),
    }

    lcfg = dataclasses.replace(traffic(run, log_every=8),
                               ppo=dataclasses.replace(config.ppo, epochs_per_batch=4, minibatches=2))
    learner = Learner(lcfg, actor="device", seed=run.seed, device=dev)
    try:
        learner.train(d.overlap_steps)
        snap = telemetry.get_registry().snapshot()
        out["advantage_overlap"] = round(snap.get("advantage/overlap_fraction", 0.0), 4)
        out["advantage_passes"] = snap.get("advantage/passes_total", 0.0)
        out["advantage_pass_ms"] = round(snap.get("advantage/pass_ms", 0.0), 3)
    finally:
        learner.close()
    return out


def multichip_world(run: Run) -> int:
    """The world of the multichip stages: every card, and 2 ranks sharing
    one (over gloo) on a machine with one card or on the CPU."""
    import torch

    return max(2, torch.cuda.device_count()) if run.device.type == "cuda" else 2


def run_multichip(run: Run, args: List[str], timeout: float) -> Dict[str, Any]:
    """``utils/run_multichip.py`` as a child; its JSON line."""
    device = ["--device", "cpu"] if run.device.type == "cpu" else []
    proc = subprocess.run([sys.executable, "-m", "dotaclient_tpu_torch.utils.run_multichip", *args, *device],
                          cwd=REPO, capture_output=True, text=True, timeout=timeout,
                          env={**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")})
    line = next((ln for ln in reversed(proc.stdout.splitlines()) if ln.strip().startswith("{")), None)
    if line is None:
        raise RuntimeError(f"run_multichip {' '.join(args)} printed no JSON (rc {proc.returncode}): "
                           f"{proc.stdout[-400:]} {proc.stderr[-400:]}")
    out = json.loads(line)
    if out.get("skipped"):
        raise RuntimeError(f"run_multichip {' '.join(args)} skipped: {out.get('reason', 'unknown')}")
    if proc.returncode != 0 and not out.get("mode") == "fused-parity":
        raise RuntimeError(f"run_multichip {' '.join(args)} failed (rc {proc.returncode}): {out}")
    return out


def bench_multichip(run: Run) -> Dict[str, Any]:
    """Multichip stage: the data-parallel epoch step (E x M > 1: the
    minibatch gathers and an all-reduce an update) at world 1 and world N,
    each ``run_multichip --probe`` in fresh processes: optimizer frames/s and
    the parity digest. ``multichip_parity`` is 1 iff world N's per-step
    losses are within 1e-3 relative of world 1's and its param L1 within
    1e-5 relative (the all-reduce reorders sums). ``scaling_efficiency``
    (fps_N / fps_1) / N is reported only: ranks sharing one card over gloo
    cannot scale."""
    n = multichip_world(run)
    results = {}
    for world in (1, n):
        where = ["--force-host", str(world)] if run.device.type == "cpu" else ["--devices", str(world)]
        results[world] = run_multichip(run, ["--probe", *where, "--steps", str(run.depth.probe_steps),
                                             "--parity-steps", str(run.depth.probe_parity_steps)], timeout=900)
    one, many = results[1], results[n]
    fps_1, fps_n = one["optimizer_frames_per_sec"], many["optimizer_frames_per_sec"]
    l1, ln = one["parity"]["losses"], many["parity"]["losses"]
    losses_ok = len(l1) == len(ln) and all(abs(a - b) <= 1e-3 * max(1e-3, abs(a)) for a, b in zip(l1, ln))
    c1, cn = one["parity"]["param_l1"], many["parity"]["param_l1"]
    checksum_ok = abs(c1 - cn) <= 1e-5 * max(1.0, abs(c1))
    return {
        "n_devices": n,
        "backend": many["backend"],
        "optimizer_fps_1dev": fps_1,
        f"optimizer_fps_{n}dev": fps_n,
        "scaling_efficiency": round(fps_n / fps_1 / n, 4) if fps_1 else 0.0,
        "multichip_parity": 1.0 if losses_ok and checksum_ok else 0.0,
        "parity_losses_1dev": l1,
        f"parity_losses_{n}dev": ln,
        "parity_param_l1_delta": abs(c1 - cn),
        "lstm_seq_launches": one["lstm_seq_launches"] + many["lstm_seq_launches"],
    }


def bench_fused_multichip(run: Run) -> Dict[str, Any]:
    """Fused multichip stage: the lane-sharded fused iteration at world 1
    and world N through ``run_multichip --fused-parity N`` (the verdict the
    gate runs): the digest's losses and param L1 at reassociation
    tolerance and the lanes split over the ranks
    (``fused_multichip_parity``), with frames/s timed after the digest
    (``fused_scaling_efficiency``, reported only)."""
    n = multichip_world(run)
    verdict = run_multichip(run, ["--fused-parity", str(n), "--steps", str(run.depth.fused_probe_steps)],
                            timeout=1800)
    probes = verdict.get("probes", {})
    return {
        "n_devices": n,
        "optimizer_fps_1dev": probes.get("1", {}).get("optimizer_frames_per_sec", 0.0),
        f"optimizer_fps_{n}dev": (probes.get(str(n)) or [{}])[0].get("optimizer_frames_per_sec", 0.0),
        "fused_multichip_parity": 1.0 if verdict.get("ok") else 0.0,
        "fused_scaling_efficiency": verdict.get("scaling_efficiency", 0.0),
        "lane_sharded": bool(verdict.get("lane_sharded")),
        "parity": verdict.get("parity"),
        "lanes": verdict.get("lanes"),
        "device": verdict.get("device"),
        "lstm_seq_launches": verdict.get("lstm_seq_launches", 0),
    }


def serve_params(config, run: Run) -> Dict[str, Any]:
    """The inference policy's params: the training policy's from the seed,
    the value head sliced off."""
    from dotaclient_tpu_torch.serve import slice_train_params

    return slice_train_params(fresh_state(config, run, "cpu").policy.state_dict())


def bench_serve(run: Run) -> Dict[str, Any]:
    """Serve stage: for each batch window (0.5 and 4 ms) a ``PolicyServer``
    on the card serves 16 loadgen clients (``serve/loadgen.py``: threads of
    sequential requests, a carry slot each), the best of the depth's trials
    by actions/s; the headline pair is the best window's. Then the parity
    digest: a max_batch 1, zero-window server answers a deterministic
    stream, and every reply must equal, bitwise, what ``reference_step``
    gives for the same obs, slot, reset and dispatch index."""
    from dotaclient_tpu_torch.serve import PolicyServer, ServeClient, ServeEngine, make_inference_policy
    from dotaclient_tpu_torch.serve.loadgen import run_loadgen, synthetic_obs
    from dotaclient_tpu_torch.utils import telemetry

    config, dev, d = run.config, run.device, run.depth
    params = serve_params(config, run)
    n_clients = 16
    out: Dict[str, Any] = {"windows": {}}
    best = (0.0, None)
    for window in (0.5, 4.0):
        cfg = dataclasses.replace(config, serve=dataclasses.replace(
            config.serve, batch_window_ms=window, max_batch=n_clients, max_slots=2 * n_clients))
        reg = telemetry.Registry()
        engine = ServeEngine(cfg, make_inference_policy(cfg, device=dev), params, registry=reg, device=dev)
        try:
            server = PolicyServer(engine, cfg, port=0, registry=reg)
            try:
                host, port = server.address[:2]
                run_loadgen(host, port, cfg, n_clients=4, requests_per_client=4)   # warm-up
                result = {"actions_per_sec": 0.0}
                for _ in range(d.serve_trials):
                    trial = run_loadgen(host, port, cfg, n_clients=n_clients, requests_per_client=d.serve_requests)
                    if trial["actions_per_sec"] > result["actions_per_sec"]:
                        result = trial
            finally:
                server.close()
        finally:
            engine.stop()
        if result.get("errors"):
            raise RuntimeError(f"serve window {window} ms: {result['errors']} errors: {result['error_sample']}")
        out["windows"][f"{window}ms"] = {k: result.get(k, 0) for k in
                                         ("actions_per_sec", "p50_ms", "p99_ms", "replies", "errors")}
        if result["actions_per_sec"] > best[0]:
            best = (result["actions_per_sec"], f"{window}ms")
    headline = out["windows"].get(best[1], {"actions_per_sec": 0.0, "p99_ms": 0.0})
    out["actions_per_sec"] = headline["actions_per_sec"]
    out["p99_ms"] = headline["p99_ms"]
    out["best_window"] = best[1]

    cfg = dataclasses.replace(config, serve=dataclasses.replace(
        config.serve, batch_window_ms=0.0, max_batch=1, max_slots=4))
    reg = telemetry.Registry()
    engine = ServeEngine(cfg, make_inference_policy(cfg, device=dev), params, registry=reg, device=dev)
    n_parity = 8
    try:
        server = PolicyServer(engine, cfg, port=0, registry=reg)
        try:
            rng = np.random.default_rng(123)
            stream = [synthetic_obs(cfg, rng) for _ in range(n_parity)]
            client = ServeClient(*server.address[:2], cfg)
            served = []
            try:
                for i, obs in enumerate(stream):
                    client.step(obs, reset=(i == 0))
                    served.append((client.last_packed.copy(), client.last_dispatch_idx))
            finally:
                client.close()
            # the replay: the same dispatch function, slot, reset and
            # dispatch index, on a carry store of its own
            carries = engine.initial_carries()
            mismatches = 0
            for i, obs in enumerate(stream):
                packed, _, carries = engine.reference_step([obs], [client.slot], [1.0 if i == 0 else 0.0], carries,
                                                           served[i][1])
                mismatches += int(not np.array_equal(packed[0], served[i][0]))
        finally:
            server.close()
    finally:
        engine.stop()
    out["parity_requests"] = n_parity
    out["parity_mismatches"] = mismatches
    out["parity"] = 1.0 if mismatches == 0 else 0.0
    return out


def bench_serve_fleet(run: Run) -> Dict[str, Any]:
    """Serve-fleet stage: two backends and a hot spare behind a
    ``SessionRouter``; 8 router-mode loadgen clients attach through it,
    then, once they step, backend 0 dies abruptly. actions/s over the whole run (the
    kill included); the blackout is each client's worst reply latency
    completed after the kill, its p99 the headline; every request must
    complete (``complete``). Then ``run_rehome_parity`` on the card: the
    carry-shadow re-home resumes bit-exact."""
    from dotaclient_tpu_torch.serve import PolicyServer, ServeEngine, SessionRouter, make_inference_policy
    from dotaclient_tpu_torch.serve.loadgen import run_loadgen, run_rehome_parity
    from dotaclient_tpu_torch.utils import telemetry

    config, dev, d = run.config, run.device, run.depth
    n_clients, n_requests = 8, d.fleet_requests
    cfg = dataclasses.replace(config, serve=dataclasses.replace(
        config.serve, batch_window_ms=0.5, max_batch=n_clients, max_slots=2 * n_clients, carry_shadow=True,
        request_deadline_s=30.0, request_retries=20, router_probe_s=0.1, router_dead_after_s=0.4))
    params = serve_params(config, run)
    engines, servers, regs, router = [], [], [], None
    out: Dict[str, Any] = {}
    try:
        for _ in range(3):
            regs.append(telemetry.Registry())
            engines.append(ServeEngine(cfg, make_inference_policy(cfg, device=dev), params, registry=regs[-1],
                                       device=dev))
            servers.append(PolicyServer(engines[-1], cfg, port=0, registry=regs[-1]))
        addrs = [tuple(s.address[:2]) for s in servers]
        rreg = telemetry.Registry()
        router = SessionRouter(cfg, addrs[:2], spares=[addrs[2]], registry=rreg)
        rhost, rport = router.address[:2]

        def gauge(key):
            return rreg.counters_and_gauges()[1].get(key, 0.0)

        deadline = time.time() + 15.0
        while time.time() < deadline and not (gauge("router/backends_live") >= 2
                                              and gauge("router/spares_available") >= 1):
            time.sleep(0.05)
        result: Dict[str, Any] = {}

        def drive():
            result.update(run_loadgen(rhost, rport, cfg, n_clients=n_clients, requests_per_client=n_requests,
                                      router=True, max_reconnects=20, collect_samples=True, think_s=0.005))

        t = threading.Thread(target=drive, daemon=True)
        t.start()
        # the kill lands once the fleet is stepping: the clients start their
        # requests together once every one has attached (a kill during an
        # attach fails it, and a client re-homes a session, not an attach)
        deadline = time.time() + 30.0
        while time.time() < deadline and t.is_alive() and (
                gauge("router/sessions_active") < n_clients
                or sum(r.snapshot().get("serve/requests_total", 0.0) for r in regs[:2]) < 1):
            time.sleep(0.02)
        t_kill = time.monotonic()
        servers[0].close()
        engines[0].stop()
        t.join(timeout=180.0)
        worst: Dict[int, float] = {}   # client -> its worst reply latency after the kill
        for t_end, latency, ci in result.get("samples", ()):
            if t_end >= t_kill:
                worst[ci] = max(worst.get(ci, 0.0), latency)
        blackouts = sorted(worst.values())
        n = len(blackouts)
        out.update({
            "actions_per_sec": result.get("actions_per_sec", 0.0),
            "replies": result.get("replies", 0),
            "errors": result.get("errors", 0),
            "error_sample": result.get("error_sample", []),
            "deadline_errors": result.get("deadline_errors", 0),
            "sessions_rehomed": result.get("sessions_rehomed", 0),
            "blackout_p99_ms": round(blackouts[min(n - 1, int(n * 0.99))] * 1e3, 3) if n else 0.0,
            "spares_promoted": int(rreg.counters_and_gauges()[0].get("router/spares_promoted_total", 0)),
        })
        out["complete"] = 1.0 if (result.get("replies", 0) == n_clients * n_requests and not result.get("errors")
                                  and result.get("sessions_rehomed", 0) >= 1) else 0.0
    finally:
        if router is not None:
            router.close()
        for srv in servers:
            srv.close()
        for eng in engines:
            eng.stop()
    digest = run_rehome_parity(seed=0, device=dev)
    out["rehome_parity"] = {k: v for k, v in digest.items() if not isinstance(v, (list, dict))}
    out["rehome_parity_ok"] = 1.0 if digest.get("parity") == "bitwise" else 0.0
    return out


# stage -> (function, the ``stages`` keys it fills: (line key, its result key, the value when absent))
STAGES: Dict[str, Tuple[Callable[[Run], Dict[str, Any]], Tuple[Tuple[str, str, float], ...]]] = {
    "transport": (bench_transport, ()),
    "stall": (bench_stall, (("stall_sync_recovery", "sync_recovery", 0.0),
                            ("stall_async_recovery", "async_recovery", 0.0))),
    "health": (bench_health, (("health_overhead", "health_overhead", 1.0),)),
    "trace": (bench_trace, (("trace_overhead", "trace_overhead", 1.0),)),
    "fleet": (bench_fleet, (("fleet_overhead", "fleet_overhead", 1.0),)),
    "outcome": (bench_outcome, (("outcome_overhead", "outcome_overhead", 1.0),)),
    "utilization": (bench_utilization, (("utilization_overhead", "utilization_overhead", 1.0),)),
    "quantize": (bench_quantize, (("rollout_compression", "rollout_compression", 0.0),
                                  ("quantize_optimizer_ratio", "optimizer_ratio", 0.0))),
    "advantage": (bench_advantage, (("advantage_speedup", "advantage_speedup", 0.0),
                                    ("advantage_overlap", "advantage_overlap", 0.0),
                                    ("advantage_parity", "parity", 0.0))),
    "multichip": (bench_multichip, (("multichip_parity", "multichip_parity", 0.0),
                                    ("scaling_efficiency", "scaling_efficiency", 0.0))),
    "fused_multichip": (bench_fused_multichip, (("fused_multichip_parity", "fused_multichip_parity", 0.0),
                                                ("fused_scaling_efficiency", "fused_scaling_efficiency", 0.0))),
    "serve": (bench_serve, (("serve_actions_per_sec", "actions_per_sec", 0.0), ("serve_p99_ms", "p99_ms", 0.0),
                            ("serve_parity", "parity", 0.0))),
    "serve_fleet": (bench_serve_fleet, (("serve_fleet_actions_per_sec", "actions_per_sec", 0.0),
                                        ("serve_fleet_blackout_p99_ms", "blackout_p99_ms", 0.0),
                                        ("serve_fleet_complete", "complete", 0.0),
                                        ("serve_fleet_rehome_parity", "rehome_parity_ok", 0.0))),
}
STAGE_NAMES = ("headline", *STAGES)


# -- the card's fingerprint and the anchor ----------------------------------------------------------------


def card_line() -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit``'s first line, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def host_fingerprint(device) -> Dict[str, Any]:
    """Which numbers are comparable across records: absolute frames/s only
    between like fingerprints (the same card at the same power limit, the
    same count, torch and CUDA), within-run ratios everywhere."""
    import torch

    smi = card_line() if device.type == "cuda" else None
    return {
        "platform": platform.platform(),
        "python": platform.python_version(),
        "device_kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "device_count": torch.cuda.device_count() if device.type == "cuda" else 1,
        "power_limit": smi.rsplit(",", 1)[1].strip() if smi and "," in smi else None,
        "card": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }


def same_card(a: Optional[Dict[str, Any]], b: Optional[Dict[str, Any]]) -> bool:
    keys = ("device_kind", "device_count", "power_limit")
    return bool(a) and bool(b) and all(a.get(k) == b.get(k) for k in keys)


def vs_baseline(path: str, value: float, host: Dict[str, Any], depth: str) -> Optional[float]:
    """The headline over the anchor's; the first run writes the anchor
    (1.0). An anchor of another card, power limit or depth gives None."""
    anchor = None
    if os.path.exists(path):
        try:
            with open(path) as f:
                anchor = json.load(f)
        except (OSError, json.JSONDecodeError):
            anchor = None
    if anchor is None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"frames_per_sec": value, "host": host, "depth": depth,
                       "recorded_at": time.strftime("%Y-%m-%d %H:%M:%S")}, f)
        return 1.0
    if not same_card(anchor.get("host"), host) or anchor.get("depth") != depth or not anchor.get("frames_per_sec"):
        return None
    return round(value / anchor["frames_per_sec"], 3)


# -- the line -------------------------------------------------------------------------------------------


def run_bench(run: Run, stages: List[str], anchor: str) -> Tuple[Dict[str, Any], bool]:
    """The selected stages in the reference's order -> (the line, whether
    any failed). A stage not selected is null, its ``stages`` keys too."""
    failed = False
    line: Dict[str, Any] = {"metric": "ppo_optimizer_frames_per_sec", "value": None, "unit": "frames/sec",
                            "vs_baseline": None, "end_to_end_frames_per_sec": None, "fused_frames_per_sec": None,
                            "fused_k8_frames_per_sec": None, "actor_frames_per_sec": None}
    stage_line: Dict[str, Any] = {}
    host = host_fingerprint(run.device)
    telemetry_path = None
    if "headline" in stages:
        try:
            head = bench_headline(run)
        except Exception as e:  # noqa: BLE001 - written under its key; the CLI exits 1
            traceback.print_exc()
            line["error"] = f"{type(e).__name__}: {e}"
            failed = True
        else:
            line.update({k: round(head[k], 1) for k in ("end_to_end_frames_per_sec", "fused_frames_per_sec",
                                                        "fused_k8_frames_per_sec", "actor_frames_per_sec")})
            line["value"] = round(head["frames_per_sec"], 1)
            line["vs_baseline"] = vs_baseline(anchor, head["frames_per_sec"], host, run.depth.name)
            stage_line.update(head["stages"])
            telemetry_path = head["telemetry_jsonl"]
    results: Dict[str, Any] = {}
    for name, (fn, keys) in STAGES.items():
        if name not in stages:
            results[name] = None
            stage_line.update({k: None for k, _, _ in keys})
            continue
        t0 = time.perf_counter()
        try:
            results[name] = fn(run)
        except Exception as e:  # noqa: BLE001 - written under its key; the CLI exits 1
            traceback.print_exc()
            results[name] = {"error": f"{type(e).__name__}: {e}"}
            failed = True
            stage_line.update({k: None for k, _, _ in keys})
        else:
            results[name]["wall_s"] = round(time.perf_counter() - t0, 3)
            stage_line.update({k: results[name].get(rk, default) for k, rk, default in keys})
        print(f"bench: stage {name}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    line.update({"stages": stage_line, "host": host, **results, "telemetry_jsonl": telemetry_path})
    return line, failed


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the current CUDA card; 'cpu' must be asked for)")
    p.add_argument("--seed", type=int, default=0, help="the params' and learners' seed")
    p.add_argument("--smoke", action="store_true",
                   help="the learner's --smoke sizes and a few steps a variant: checks the path, measures nothing")
    p.add_argument("--stage", action="append", choices=STAGE_NAMES, default=None,
                   help="run this stage (repeatable; default: the headline and every stage)")
    p.add_argument("--anchor", type=str, default=DEFAULT_ANCHOR,
                   help="the anchor file vs_baseline reads (written by the first run on a card and depth)")
    args = p.parse_args(argv)

    from dotaclient_tpu_torch.config import default_config
    from dotaclient_tpu_torch.device import resolve_device
    from dotaclient_tpu_torch.train.learner import smoke_config

    device = resolve_device(args.device)
    config = dataclasses.replace(default_config(), seed=args.seed)
    if args.smoke:
        config = smoke_config(config)
    run = Run(config, device, SMOKE if args.smoke else FULL, args.seed)
    stages = args.stage or list(STAGE_NAMES)
    # the learners' console lines go to stderr: stdout carries the line alone
    with contextlib.redirect_stdout(sys.stderr):
        line, failed = run_bench(run, [s for s in STAGE_NAMES if s in stages], args.anchor)
    print(json.dumps(line), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
