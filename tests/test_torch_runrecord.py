"""The port learner's run record against the JAX package's: the telemetry
sinks and ``load_jsonl``, ``MetricsLogger``'s lines, the outcome curves, the
learner's utilization plane, the fleet snapshot codec and aggregator, the
memory gauge, best-model rotation on both learners, the learner CLI's record
against ``scripts/check_telemetry_schema.py``'s tiers (and the port's copy
of them), its key union against the JAX learner's, and the demo's record
flags. Host arithmetic throughout: every comparison is exact."""

import dataclasses
import json
import math
import os
import sys

import pytest
import torch

from dotaclient_tpu.outcome.aggregator import OutcomeAggregator as JaxOutcomeAggregator
from dotaclient_tpu.train.learner import Learner as JaxLearner
from dotaclient_tpu.utils import fleet as jfleet
from dotaclient_tpu.utils import telemetry as jtel
from dotaclient_tpu.utils import tracing as jtracing
from dotaclient_tpu.utils import utilization as jutil
from dotaclient_tpu.utils.metrics import MetricsLogger as JaxMetricsLogger
from dotaclient_tpu_torch.outcome.aggregator import OutcomeAggregator
from dotaclient_tpu_torch.train import demo as pdemo
from dotaclient_tpu_torch.train import learner as plearner
from dotaclient_tpu_torch.utils import fleet, schema, telemetry, tracing, utilization
from dotaclient_tpu_torch.utils.metrics import MetricsLogger
from scripts import check_telemetry_schema as script
from tests.test_torch_common import tiny_configs

# keys of the JAX learner's record that the port's has not, each with its
# ROADMAP item: the per-program compile counters of instrument_jit (item 8:
# a recompile and CUDA-event timer in torch)
WAIVED = {
    "compile/": "ROADMAP queue 1, item 8",
}
PORTED_COMPILE_KEYS = ("compile/compiles_total", "compile/retraces_total", "compile/compile_time_s_total")
TIERS = ("REQUIRED_KEYS", "SNAPSHOT_KEYS", "HEALTH_KEYS", "TRACE_KEYS", "ADVANTAGE_KEYS", "FLEET_KEYS",
         "OUTCOME_KEYS", "UTILIZATION_KEYS", "MULTICHIP_KEYS")


def waived(key):
    return key not in PORTED_COMPILE_KEYS and any(key.startswith(k) for k in WAIVED)


def record_keys(path):
    keys = set()
    for line in telemetry.load_jsonl(path):
        keys |= set(json.loads(line).get("scalars", {}))
    return keys


def run_config(cfg, best_min_episodes=10):
    """The smoke's device-mode sizes at the tiny model: 4 games of 4 s
    (so episodes end), chunks of 8, batches of 8, a log line every step.
    A window (a log step: 2 collects of 4 games) holds at most 8 ended
    games, so only the scenario's forced window of 10 qualifies for
    best/."""
    return dataclasses.replace(
        cfg,
        env=dataclasses.replace(cfg.env, n_envs=4, max_dota_time=4.0),
        ppo=dataclasses.replace(cfg.ppo, rollout_len=8, batch_rollouts=8),
        buffer=dataclasses.replace(cfg.buffer, capacity_rollouts=32, min_fill=8),
        log_every=1, checkpoint_every=1_000_000, checkpoint_best_min_episodes=best_min_episodes,
    )


# -- the two learners, run once ----------------------------------------------------------------


def best_scenario(learner, cfg, make, ckdir, init_from_step):
    """tests/test_checkpoint_pipeline.py's best-rotation scenario on one
    learner, with rotation switched on as a ``checkpoint_dir`` would: no
    stray best/ before a qualifying save; a forced 0.9 window saved; real
    windows that do not displace it; best/ as an init_from source; the
    marker inherited on resume, frozen (inf) on an unreadable meta."""
    best_dir = os.path.join(ckdir, "best")
    learner._best_dir = best_dir
    out = {"stray": learner.ckpt_best is not None or os.path.exists(best_dir)}
    learner.train(4)
    learner._best_win = -1.0
    learner.device_actor._recent = {"episodes": 10.0, "wins": 9.0, "ep_return_sum": 0.0}
    stats = learner.device_actor.stats()
    learner._maybe_save_best(stats)
    out["peak"] = (stats["win_rate_recent"], learner._best_win, learner.ckpt_best.latest_step())
    learner.train(3)   # real windows of ~0 wins
    learner.ckpt_best.wait()
    out["after"] = (learner._best_win, learner.ckpt_best.latest_step())
    with open(os.path.join(best_dir, "best_meta.json")) as f:
        out["meta"] = json.load(f)
    out["init_from_step"] = init_from_step(make(init_from=best_dir))
    out["resumed"] = make(checkpoint_dir=ckdir, restore=True)._best_win
    with open(os.path.join(best_dir, "best_meta.json"), "w") as f:
        f.write("{torn")
    out["frozen"] = make(checkpoint_dir=ckdir, restore=True)._best_win
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX learner (device mode, the tiny model, its record in a
    JSONL) trained 2 steps, then the best scenario; the port learner's
    scenario on the same config; the port CLI's smoke record."""
    root = tmp_path_factory.mktemp("runrecord")
    jcfg, pcfg = (run_config(c) for c in tiny_configs())
    jtel.get_registry().clear()   # the JAX learner records the process-wide registry
    jpath = str(root / "jax.jsonl")
    jl = JaxLearner(jcfg, actor="device", seed=3, metrics_jsonl=jpath)
    jl.train(2)
    out = {"jax_keys": record_keys(jpath)}
    out["jax_best"] = best_scenario(
        jl, jcfg, lambda **kw: JaxLearner(jcfg, actor="device", seed=3, **kw), str(root / "jax_ck"),
        lambda learner: learner._init_from_step)
    jl._snap_engine.stop()
    make = lambda **kw: plearner.Learner(pcfg, actor="device", seed=3, device="cpu",  # noqa: E731
                                         registry=telemetry.Registry(), **kw)
    pl = make()
    pl.train(2)
    out["port_best"] = best_scenario(pl, pcfg, make, str(root / "port_ck"), lambda learner: learner.init_from_step)
    pl.close()
    path = str(root / "port.jsonl")
    assert plearner.main(["--smoke", "--steps", "2", "--device", "cpu", "--metrics-jsonl", path]) == 0
    out["port_lines"] = telemetry.load_jsonl(path)
    out["port_keys"] = record_keys(path)
    return out


@pytest.mark.parametrize("tier", TIERS)
def test_port_smoke_record_passes_each_tier(runs, tier):
    """`--smoke --steps 2 --metrics-jsonl` at the base tier plus each of
    the snapshot, health, trace, advantage, fleet, outcome, utilization and
    multichip tiers, by the script's own check."""
    extra = () if tier == "REQUIRED_KEYS" else getattr(script, tier)
    assert script.validate_lines(runs["port_lines"], extra_required=extra) == []
    assert schema.validate_lines(runs["port_lines"], extra) == []


def test_port_record_covers_the_jax_learners_keys(runs):
    missing = sorted(k for k in runs["jax_keys"] - runs["port_keys"] if not waived(k))
    assert missing == []
    # every waiver is used: each stands for keys the JAX record has
    for prefix in WAIVED:
        assert any(k.startswith(prefix) for k in runs["jax_keys"] - runs["port_keys"]), prefix
    assert len(runs["port_lines"]) == 3   # two log lines and the closing one


def test_best_rotation_as_the_reference(runs):
    j, p = runs["jax_best"], runs["port_best"]
    assert j == p
    assert p["stray"] is False
    assert p["peak"] == (pytest.approx(0.9), pytest.approx(0.9), 6)
    assert p["after"] == (pytest.approx(0.9), 6)
    assert p["meta"] == {"win_rate_recent": 0.9, "step": 6}
    assert p["init_from_step"] == 6 and p["resumed"] == 0.9 and p["frozen"] == math.inf


@pytest.mark.parametrize("name", ("REQUIRED_KEYS", "TIMER_LEAVES", "SNAPSHOT_KEYS", "HEALTH_KEYS", "TRACE_KEYS",
                                  "ADVANTAGE_KEYS", "FLEET_KEYS", "OUTCOME_KEYS", "UTILIZATION_KEYS",
                                  "MULTICHIP_KEYS"))
def test_schema_copy_equals_the_script(name):
    assert getattr(schema, name) == getattr(script, name)


def test_schema_copy_flags_what_the_script_flags():
    good = json.dumps({"ts": 1.0, "step": 0, "scalars": {k: 0.0 for k in schema.REQUIRED_KEYS}})
    bad = [good.replace('"step": 0', '"step": -1'), "{not json",
           json.dumps({"ts": 1.0, "step": 0, "scalars": {"span/x/mean_s": 0.0}}), json.dumps({"event": "ALERT"})]
    for lines in ([good], bad, [good, *bad], []):
        assert bool(schema.validate_lines(lines)) == bool(script.validate_lines(lines))


# -- telemetry: the sinks, load_jsonl, clear ------------------------------------------------------


@pytest.mark.parametrize("blob", [b"", b"a\n", b"a\nb\n", b"a\nb", b"a\n\n", b"torn", b'a\n{"x": 1',
                                  b"\xc3\xa9\n\xff"])
def test_load_jsonl_drops_a_torn_tail_as_the_reference(tmp_path, blob):
    path = tmp_path / "x.jsonl"
    path.write_bytes(blob)
    assert telemetry.load_jsonl(str(path)) == jtel.load_jsonl(str(path))


@pytest.mark.parametrize("text", ["", "a\n", "a\nb", "no newline", "a\nb\nc"])
def test_sink_seals_a_torn_tail_as_the_reference(tmp_path, text):
    got = []
    for name, sink in (("port", telemetry.JsonlSink), ("jax", jtel.JsonlSink)):
        path = tmp_path / name
        path.write_text(text)
        sink(str(path)).close()
        got.append(path.read_text())
    assert got[0] == got[1]


def registries():
    """The same metrics in a port and a JAX registry."""
    out = []
    for mod in (telemetry, jtel):
        r = mod.Registry()
        r.gauge("transport/queue_depth").set(5.0)
        r.counter("actor/frames_shipped").inc(64)
        for s in (0.001, 0.004, 0.0005):
            r.timer("span/learner/dispatch").observe(s)
        out.append(r)
    return out


def test_registry_clear_as_the_reference():
    for r in registries():
        assert r.snapshot()
        r.clear()
        assert r.snapshot() == {} and r.counters_and_gauges() == ({}, {})


def test_console_sink_elides_telemetry_keys_as_the_reference(capsys):
    lines = []
    for sink in (telemetry.ConsoleSink(t0=0.0), jtel.ConsoleSink(t0=0.0)):
        sink.emit(3, {"loss": 0.5, "transport/queue_depth": 5.0, "entropy": 3.14159})
        lines.append(capsys.readouterr().out.split("] ", 1)[1])
    assert lines[0] == lines[1] == "step 3: entropy=3.142 loss=0.5\n"


def test_metrics_logger_lines_as_the_reference(tmp_path, capsys):
    """The JSONL lines (``ts`` removed), the console, the closing line and
    the event channel, from the same scalars and registry contents."""
    outs = {}
    for name, cls, reg in (("port", MetricsLogger, registries()[0]), ("jax", JaxMetricsLogger, registries()[1])):
        path = str(tmp_path / f"{name}.jsonl")
        logger = cls(jsonl=path, registry=reg)
        merged = logger.log(3, {"loss": 0.25, "nan": float("nan")})
        logger.log_files_only(4, {"optimizer_steps": 4.0})
        logger.emit_event({"event": "ALERT", "rule": "x", "state": "firing"})
        logger.close()
        console = capsys.readouterr().out
        lines = [json.loads(x) for x in open(path)]
        for line in lines:
            assert isinstance(line.pop("ts"), float)
        outs[name] = (lines, console.split("] ", 1)[1], sorted(merged))
    assert outs["port"] == outs["jax"]
    lines, console, _ = outs["port"]
    assert lines[0]["scalars"]["nan"] is None and lines[0]["scalars"]["transport/queue_depth"] == 5.0
    assert "queue_depth" not in console and console.count("step ") == 1 and "ALERT {" in console


def test_tensorboard_sink_degrades_without_tensorboardx(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    for cls, mod in ((MetricsLogger, telemetry), (JaxMetricsLogger, jtel)):
        assert mod.TensorBoardSink.create("/nonexistent/tb") is None
        logger = cls(logdir="/nonexistent/tb", console=False, registry=mod.Registry())
        logger.log(1, {"loss": 0.1})
        logger.close()
        out = capsys.readouterr().out
        assert out.count("tensorboardX not installed") == 2 and "WARNING" in out


def test_tensorboard_sink_writes_with_tensorboardx(tmp_path):
    pytest.importorskip("tensorboardX")
    logger = MetricsLogger(logdir=str(tmp_path), console=False, registry=telemetry.Registry())
    logger.log(1, {"loss": 0.1})
    logger.close()
    assert any(n.startswith("events.out.tfevents") for n in os.listdir(tmp_path))


# -- the outcome curves ----------------------------------------------------------------------------

# (now, counter increments): scripted games arm the stream, the league
# bucket stays below min_episodes, a fleet peer's mirror joins, the window
# slides past 120 s, the one-step episodes trip the anomaly
OUTCOME_FEED = (
    (0.0, {}),
    (10.0, {"outcome/episodes/vs_scripted": 6.0, "outcome/wins/vs_scripted": 2.0, "outcome/ep_len_hist/05": 6.0,
            "outcome/reward_sum/win": -3.0}),
    (20.0, {"outcome/episodes/vs_scripted": 4.0, "outcome/wins/vs_scripted": 3.0, "outcome/ep_len_hist/06": 4.0,
            "outcome/episodes/vs_league": 3.0, "outcome/wins/vs_league": 1.0, "outcome/reward_sum/xp": 2.5}),
    (30.0, {"fleet/a1/outcome/episodes/vs_league": 7.0, "fleet/a1/outcome/wins/vs_league": 7.0,
            "fleet/a1/outcome/ep_len_hist/02": 7.0}),
    (45.0, {}),
    (200.0, {"outcome/episodes/vs_scripted": 9.0, "outcome/ep_len_hist/00": 9.0, "outcome/wins/vs_scripted": 1.0}),
    (210.0, {"outcome/episodes/vs_selfplay": 8.0, "outcome/wins/vs_selfplay": 4.0,
             "outcome/ep_len_hist/11": 8.0}),
    (500.0, {}),
)


def test_outcome_aggregator_as_the_reference():
    regs = {"port": telemetry.Registry(), "jax": jtel.Registry()}
    aggs = {"port": OutcomeAggregator(registry=regs["port"]), "jax": JaxOutcomeAggregator(registry=regs["jax"])}
    from dotaclient_tpu_torch.outcome import records

    records.ensure_actor_metrics(regs["port"])
    from dotaclient_tpu.outcome import records as jrecords

    jrecords.ensure_actor_metrics(regs["jax"])
    assert regs["port"].snapshot() == regs["jax"].snapshot()
    seen = []
    for now, incs in OUTCOME_FEED:
        for name in ("port", "jax"):
            for key, v in incs.items():
                regs[name].counter(key).inc(v)
            aggs[name].tick(now=now)
        snaps = [{k: v for k, v in regs[n].snapshot().items() if k.startswith("outcome/")} for n in ("port", "jax")]
        assert snaps[0] == snaps[1], now
        seen.append(snaps[0])
    assert seen[0]["outcome/win_rate/overall"] == 0.5 and seen[0]["outcome/stream_age_s"] == -1.0
    assert seen[1]["outcome/win_rate/vs_scripted"] == 0.5   # 6 < min_episodes: the prior holds
    assert seen[2]["outcome/win_rate/vs_scripted"] == 0.5 and seen[3]["outcome/win_rate/vs_league"] == 0.8
    assert seen[5]["outcome/episode_len_anomaly"] == 1.0 and seen[4]["outcome/stream_age_s"] == 15.0


# -- the learner's utilization plane ------------------------------------------------------------


def lu_pair():
    out = []
    for mod, tel in ((utilization, telemetry), (jutil, jtel)):
        reg = tel.Registry()
        lu = mod.LearnerUtilization(mod.ensure_learner_keys(reg))
        lu._acct._window_start = 0.0
        out.append((reg, lu))
    return out


def timeline(name):
    """tests/test_utilization.py's synthetic timelines, as (phases,
    step, now) folds."""
    if name == "duty_cycle":
        return [({"dispatch_inflight": 7.0, "ingest_wait": 1.5, "publish_stall": 0.5}, 100, 10.0)]
    if name == "regression":
        return ([({}, 100 * (i + 1), 10.0 * (i + 1)) for i in range(5)]
                + [({}, 500 + i + 1, 60.0 + 10.0 * i) for i in range(3)])
    if name == "refold":
        return [({}, 100 * (i + 1), 10.0 * (i + 1)) for i in range(6)] + [({}, 600, 90.0)]
    if name == "first_fold":
        return [({}, 50, 10.0)]
    # every phase, and clock noise past the window's end
    return [({p: 1.0 for p in utilization.LEARNER_PHASES}, 10, 5.0),
            ({"gather": 3.0, "checkpoint_stall": 2.5}, 20, 10.0), ({"advantage_pass": 0.5}, 20, 10.0)]


@pytest.mark.parametrize("name", ["duty_cycle", "regression", "refold", "first_fold", "every_phase"])
def test_learner_utilization_as_the_reference(name):
    (preg, plu), (jreg, jlu) = lu_pair()
    assert preg.snapshot() == jreg.snapshot()
    assert preg.snapshot()["util/duty_cycle"] == 1.0 and preg.snapshot()["util/armed"] == 0.0
    for phases, step, now in timeline(name):
        for lu in (plu, jlu):
            for phase, s in phases.items():
                lu.phase(phase, s)
        assert plu.fold(step, now=now) == jlu.fold(step, now=now)
        assert preg.snapshot() == jreg.snapshot()
    if name == "duty_cycle":
        assert preg.snapshot()["util/duty_cycle"] == pytest.approx(0.7)
    if name == "regression":
        assert preg.snapshot()["util/throughput_regression"] == 1.0


def test_make_learner_matches_the_reference_default():
    # the port has no ``enabled`` knob: its accountant is the reference's
    # default, the gauges created at their neutral values (exact)
    reg, jreg = telemetry.Registry(), jtel.Registry()
    assert not hasattr(utilization, "enabled") and jutil.enabled
    assert isinstance(utilization.make_learner(reg), utilization.LearnerUtilization)
    assert isinstance(jutil.make_learner(jreg), jutil.LearnerUtilization)
    assert reg.snapshot() == jreg.snapshot() and reg.snapshot()["util/duty_cycle"] == 1.0


def test_memory_gauge_on_the_cpu():
    reg, jreg = telemetry.Registry(), jtel.Registry()
    assert tracing.update_memory_gauges(reg, "cpu") == 0.0 == jtracing.update_memory_gauges(jreg)
    assert reg.snapshot()["mem/hbm_peak_bytes"] == jreg.snapshot()["mem/hbm_peak_bytes"] == 0.0


# -- the fleet plane --------------------------------------------------------------------------------


def snapshot_inputs(n_outcome=0):
    counters = {"actor/env_steps": 100.0, "transport/reconnects_total": 2.0, "learner/ignored": 1.0,
                **{f"outcome/ep_len_hist/{i:02d}": float(i) for i in range(12)},
                **{f"outcome/reward_sum/t{i:02d}": float(i) for i in range(n_outcome)}}
    gauges = {"actor/weight_refresh_lag": 3.0, "util/actor/ship_wait": 0.25, "serve/p99_latency_ms": 7.5}
    return counters, gauges


@pytest.mark.parametrize("n_outcome", [0, 60])
def test_snapshot_codec_as_the_reference(n_outcome):
    """The same message either way (the JAX package encodes with its native
    codec, so compared parsed), decoded alike by both; past 60 leaves the
    same keys are cut."""
    from dotaclient_tpu.protos import dota_pb2 as jpb

    counters, gauges = snapshot_inputs(n_outcome)
    pb, jb = (mod.encode_snapshot(7, "serve", 3, counters, gauges, pid=42) for mod in (fleet, jfleet))
    pm, jm = jpb.Rollout(), jpb.Rollout()
    pm.ParseFromString(pb)
    jm.ParseFromString(jb)
    assert pm == jm
    for payload in (pb, jb):
        assert fleet.decode_snapshot(payload) == jfleet.decode_snapshot(payload)
    got = fleet.decode_snapshot(pb)
    assert got["peer"] == "s7" and got["pid"] == 42 and got["seq"] == 3
    assert len(got["counters"]) + len(got["gauges"]) == min(60, 5 + 12 + n_outcome)
    assert fleet.decode_snapshot(b"\x00garbage") is None is jfleet.decode_snapshot(b"\x00garbage")


def test_fleet_aggregator_as_the_reference():
    """Eager keys at construction, then the same merge: two peers, one
    restarted under a new pid, one going stale and then forgotten."""
    regs = {"port": telemetry.Registry(), "jax": jtel.Registry()}
    events = {"port": [], "jax": []}
    aggs = {"port": fleet.FleetAggregator(registry=regs["port"], interval_s=1.0, emit_event=events["port"].append),
            "jax": jfleet.FleetAggregator(registry=regs["jax"], interval_s=1.0, emit_event=events["jax"].append)}
    assert regs["port"].snapshot() == regs["jax"].snapshot()
    assert set(fleet.AGG_KEYS) == set(jfleet.AGG_KEYS) and fleet.AGG_KEYS == jfleet.AGG_KEYS
    feed = [(0.0, 0, "actor", 11, {"actor/env_steps": 10.0}, {"actor/weight_refresh_lag": 1.0}),
            (0.5, 1, "actor", 12, {"actor/env_steps": 50.0, "transport/reconnects_total": 1.0}, {}),
            (1.0, 0, "actor", 11, {"actor/env_steps": 30.0}, {"actor/weight_refresh_lag": 4.0}),
            (2.0, 0, "actor", 99, {"actor/env_steps": 5.0}, {"util/actor/ship_wait": 0.5}),
            (3.0, 1, "actor", 12, {"actor/env_steps": 90.0, "transport/frames_corrupt_total": 2.0}, {})]
    ticks = (1.5, 3.5, 12.0, 400.0)
    for name in ("port", "jax"):
        mod = fleet if name == "port" else jfleet
        i = 0
        for now in ticks:
            while i < len(feed) and feed[i][0] <= now:
                t, peer, kind, pid, c, g = feed[i]
                assert aggs[name].ingest(mod.encode_snapshot(peer, kind, i, c, g, pid=pid), recv_ts=t)
                i += 1
            aggs[name].tick(now=now)
        assert not aggs[name].ingest(b"\x00bad")
    assert regs["port"].snapshot() == regs["jax"].snapshot()
    assert events["port"] == events["jax"]
    snap = regs["port"].snapshot()
    assert snap["fleet/a0/actor/env_steps"] == 35.0 and snap["fleet/bad_snapshots_total"] == 1.0
    assert snap["fleet/peers"] == 0.0 and snap["fleet/peers_stale"] == 0.0


# -- the learner's CLI flags and the demo's record ----------------------------------------------------


@pytest.mark.parametrize("flag", [(f, v) for f, v in (
    ("--core", "transformer"), ("--moe-experts", "4"), ("--mesh", "data_parallel=2"), ("--multihost", None),
    ("--dcn-slices", "2"), ("--model-parallel", "2"), ("--listen", "127.0.0.1:7777"), ("--shm-name", "x"),
    ("--amqp-host", "localhost"), ("--wire-dtype", "bfloat16"), ("--rollout-wire-dtype", "bfloat16"), ("--refresh-every", "5"),
    ("--overlap", None), ("--no-vec", None), ("--trace-jsonl", "t.jsonl"), ("--trace-sample", "4"),
    ("--fleet-interval", "1"), ("--checkify", None), ("--compile-cache", "cc"), ("--transport", "socket"))])
def test_learner_refuses_what_is_not_ported(flag, monkeypatch):
    """Every flag the port once refused now reaches what it configures:
    those the external-actor, scalar, core, trace and wire slices ported (``--listen``,
    ``--refresh-every``, ``--overlap``, ``--transport socket``,
    ``--no-vec``, ``--shm-name``, ``--core``, ``--moe-experts``,
    ``--fleet-interval``, ``--trace-jsonl``, ``--trace-sample``,
    ``--amqp-host``, ``--wire-dtype``, ``--rollout-wire-dtype``) and the
    data-parallel slices (``--mesh``, ``--multihost``, ``--dcn-slices``,
    ``--model-parallel``) and the debug and cache flags (``--checkify``,
    ``--compile-cache``) reach the learner, config, runtime, transport or
    build directories they configure; the trace flags reach ``tracing.configure``
    before the learner is built, and its shutdown after; ``--amqp-host``
    reaches the ``AmqpTransport`` of ``--transport amqp``; ``--multihost``
    reaches ``initialize_runtime`` (and the process group's teardown);
    ``--model-parallel 2`` reaches the mesh config; ``--checkify`` the
    learner's ``debug_checkify``; and ``--compile-cache DIR``
    ``use_compile_cache`` (no kernels with ``--device cpu``)."""
    name, value = flag
    argv = ["--smoke", "--device", "cpu", name] + ([value] if value is not None else [])
    if name == "--trace-sample":
        argv += ["--trace-jsonl", "t.jsonl"]   # the sample rate needs a log
    if name == "--amqp-host":
        argv += ["--transport", "amqp"]   # the broker's address is the AMQP transport's
    if name in ("--listen", "--refresh-every", "--overlap", "--transport", "--no-vec", "--shm-name", "--core",
                "--moe-experts", "--fleet-interval", "--trace-jsonl", "--trace-sample", "--amqp-host",
                "--wire-dtype", "--rollout-wire-dtype", "--mesh", "--multihost", "--dcn-slices",
                "--model-parallel", "--checkify", "--compile-cache"):
        built = []
        runtime = []
        monkeypatch.setattr(plearner.pdist, "initialize_runtime", lambda: runtime.append("init"))
        want_mesh = {"--mesh": (2, 1), "--dcn-slices": (-1, 2)}.get(name, (-1, 1))
        interval0 = telemetry.fleet_interval_s
        traced = []
        monkeypatch.setattr(tracing, "configure", lambda path, sample_n=None, registry=None: traced.append(
            (path, sample_n)))
        want_trace = [("t.jsonl", 4 if name == "--trace-sample" else None)] if name.startswith("--trace") else []

        def recording(config, actor, **kw):
            built.append((actor, kw))
            assert config.model.core == ("transformer" if name == "--core" else "lstm")
            assert config.model.moe_experts == (4 if name == "--moe-experts" else 0)
            assert telemetry.fleet_interval_s == (1.0 if name == "--fleet-interval" else interval0)
            assert traced == want_trace
            assert config.transport.wire_dtype == ("bfloat16" if name == "--wire-dtype" else "float32")
            assert config.transport.rollout_wire_dtype == ("bfloat16" if name == "--rollout-wire-dtype" else "float32")
            assert (config.mesh.data_parallel, config.mesh.dcn_slices) == want_mesh
            assert config.mesh.model_parallel == (2 if name == "--model-parallel" else 1)
            assert runtime == (["init"] if name == "--multihost" else [])
            assert kw["debug_checkify"] == (name == "--checkify")
            assert caches == ([("cc", False)] if name == "--compile-cache" else [])
            raise SystemExit(0)

        caches = []
        monkeypatch.setattr(plearner, "use_compile_cache", lambda directory, kernels: caches.append(
            (directory, kernels)))

        monkeypatch.setattr(plearner, "Learner", recording)
        monkeypatch.setattr(plearner, "TransportServer", lambda host, port, **kw: type(
            "Server", (), {"address": (host, int(port)), "close": lambda self: None})())
        brokers = []
        monkeypatch.setattr(plearner, "AmqpTransport", lambda host, port: brokers.append((host, port)) or type(
            "Broker", (), {"close": lambda self: None})())
        with pytest.raises(SystemExit):
            plearner.main(argv)
        actor, kw = built[-1]
        assert actor == {"--transport": "external", "--no-vec": "scalar", "--amqp-host": "external"}.get(
            name, "device")
        assert (kw["transport"] is not None) == (name in ("--transport", "--amqp-host"))
        assert brokers == ([("localhost", 5672)] if name == "--amqp-host" else [])
        assert telemetry.fleet_interval_s == interval0   # restored for the embedding program
        assert traced == want_trace + [(None, None)] * bool(want_trace)   # the log shut down at the end
        return
    raise AssertionError(f"{name} is not among the flags the port reaches")


def test_learner_override_flags_reach_the_config(monkeypatch, capsys):
    built = []

    def recording(config, actor, **kw):
        built.append((config, kw))
        raise SystemExit(0)

    monkeypatch.setattr(plearner, "Learner", recording)
    with pytest.raises(SystemExit):
        plearner.main(["--smoke", "--device", "cpu", "--ppo", "entropy_coef=0.002", "--reward", "win=25",
                       "--serve", "max_batch=16", "--team-size", "2",
                       "--logdir", "tb", "--metrics-jsonl", "m.jsonl"])
    config, kw = built[-1]
    assert config.ppo.entropy_coef == 0.002 and config.reward.win == 25.0 and config.serve.max_batch == 16
    assert config.env.team_size == 2
    assert kw["logdir"] == "tb" and kw["metrics_jsonl"] == "m.jsonl"


@pytest.mark.parametrize("flags,want", [([], 1_000_000_000), (["--logdir", "tb"], 10_000),
                                        (["--logdir", "tb", "--log-every", "5"], 5), (["--log-every", "3"], 3)])
def test_demo_log_every_defaults_as_the_reference(monkeypatch, flags, want):
    seen = []

    def recording(config, **kw):
        seen.append((config.log_every, kw))
        raise SystemExit(0)

    import dotaclient_tpu_torch.train.learner as module

    monkeypatch.setattr(module, "Learner", recording)
    with pytest.raises(SystemExit):
        pdemo.main(["--device", "cpu", *flags])
    assert seen[0][0] == want and seen[0][1]["logdir"] == dict(zip(flags[::2], flags[1::2])).get("--logdir")


def test_demo_writes_its_record(tmp_path, monkeypatch, capsys):
    """--metrics-jsonl with --log-every 1: a line a step and the closing
    ones, with the outcome and utilization tiers; --logdir degrades to one
    warning without tensorboardX."""
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    path = str(tmp_path / "demo.jsonl")
    assert pdemo.main(["--steps", "2", "--n-envs", "2", "--eval-games", "2", "--max-dota-time", "0.4",
                       "--device", "cpu", "--metrics-jsonl", path, "--log-every", "1",
                       "--logdir", str(tmp_path / "tb")]) == 0
    out = capsys.readouterr().out
    assert out.count("tensorboardX not installed") == 1 and out.splitlines()[-1].startswith("DEMO_SUMMARY ")
    lines = telemetry.load_jsonl(path)
    steps = [json.loads(x)["step"] for x in lines]
    assert steps == [1, 2, 2]   # one block of 2 steps: its two log lines and the closing line
    assert script.validate_lines(lines, base_required=(),
                                 extra_required=script.OUTCOME_KEYS + script.UTILIZATION_KEYS) == []

