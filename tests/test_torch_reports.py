"""The port's report consoles against the reference's scripts on the same
run records: ``utils/outcome_report.py``, ``utils/fleet_status.py`` and
``utils/utilization_report.py`` against ``scripts/outcome_report.py``,
``scripts/fleet_status.py`` and ``scripts/utilization_report.py``. Each
canned stream goes through both, and the ``*_STATUS`` dicts, the exit codes
and the console text (its age stamp aside) must be equal: a stream with
outcome counters, fleet mirrors, utilization rows, router keys and alerts; a
torn tail; a non-numeric ``ts``; an empty stream; and one record of the
port's learner CLI (``--smoke --device cpu``)."""

import importlib.util
import json
import os
import re

import pytest

from dotaclient_tpu_torch.train import learner as plearner
from dotaclient_tpu_torch.utils import fleet, fleet_status, outcome_report, telemetry, utilization_report

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONSOLES = {"outcome_report": (outcome_report, "OUTCOME_STATUS"),
            "fleet_status": (fleet_status, "FLEET_STATUS"),
            "utilization_report": (utilization_report, "UTILIZATION_STATUS")}


def script_module(name):
    spec = importlib.util.spec_from_file_location(f"_ref_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def references():
    return {name: script_module(name) for name in CONSOLES}


def run_console(mod, tag, path, capsys):
    rc = mod.main([str(path)])
    out = capsys.readouterr().out
    status = [json.loads(line[len(tag) + 1:]) for line in out.splitlines() if line.startswith(tag + " ")]
    assert len(status) == 1, out
    # the age stamp reads the wall clock when each console renders
    text = re.sub(r"\(last metrics line [^)]*\)", "(age)", out)
    return rc, status[0], text


def both(name, path, references, capsys):
    mod, tag = CONSOLES[name]
    got = run_console(mod, tag, path, capsys)
    want = run_console(references[name], tag, path, capsys)
    assert got == want
    return got


def rich_stream(tmp_path):
    """Two fleet actors through the port's aggregator, outcome counters (the
    learner's and a mirrored peer's), the learner's utilization phases and
    sentinel, a peer's actor phases, router keys, and three alerts (one
    resolved)."""
    reg = telemetry.Registry()
    agg = fleet.FleetAggregator(registry=reg, interval_s=0.1)
    agg.ingest(fleet.encode_snapshot(0, "actor", 0, {"actor/env_steps": 500.0, "transport/reconnects_total": 1.0},
                                     {"actor/weight_refresh_lag": 2.0}, pid=11), recv_ts=1.0)
    agg.ingest(fleet.encode_snapshot(1, "actor", 0, {"actor/env_steps": 300.0},
                                     {"actor/weight_refresh_lag": 4.0}, pid=12), recv_ts=1.0)
    agg.tick(now=1.0)
    path = tmp_path / "learner.jsonl"
    sink = telemetry.JsonlSink(str(path))
    for state, rule, sev, rb in (("fired", "corrupt_frame_rate", "warn", "rb:corrupt-frames"),
                                 ("fired", "fleet_peer_stale", "page", "rb:fleet-peer-stale"),
                                 ("resolved", "fleet_peer_stale", "page", "rb:fleet-peer-stale"),
                                 ("fired", "serve_peer_dead", "page", "rb:serve-peer-dead")):
        sink.emit_event({"event": "ALERT", "state": state, "rule": rule, "severity": sev, "runbook": rb,
                         "value": 1.0, "threshold": 0.5, "summary": "s"})
    early = {"outcome/episodes_total": 0.0, "util/armed": 0.0}
    sink.emit(4, early)
    sc = dict(reg.snapshot())
    sc.update({
        "outcome/episodes_total": 6.0, "outcome/episodes_recent": 6.0, "outcome/episodes/vs_scripted": 6.0,
        "outcome/wins/vs_scripted": 3.0, "outcome/win_rate/vs_scripted": 0.5, "outcome/win_rate/overall": 0.5,
        "outcome/ep_len_sum": 600.0, "outcome/episode_len_p50": 96.0, "outcome/stream_age_s": 3.25,
        "outcome/reward/xp": 0.125, "outcome/reward/win": -1.0,
        "fleet/a7/outcome/episodes/vs_scripted": 4.0, "fleet/a7/outcome/wins/vs_scripted": 1.0,
        "util/armed": 1.0, "util/duty_cycle": 0.42, "util/phase/dispatch_inflight": 0.42, "util/phase/gather": 0.3,
        "util/phase/host_other": 0.28, "util/steps_per_sec_ema": 3.5, "util/steps_per_sec_baseline": 3.75,
        "fleet/a0/util/actor/env_step": 0.25, "fleet/a0/util/actor/other": 0.75,
        "router/backends_live": 2.0, "router/backends_dead": 1.0, "router/spares_available": 0.0,
        "router/sessions_active": 6.0, "router/backend/0/sessions": 4.0, "router/backend/1/sessions": 2.0,
        "router/sessions_rehomed_total": 3.0, "router/spares_promoted_total": 1.0,
        "router/backend_deaths_total": 1.0, "alerts/fired_total": 3.0,
    })
    sink.emit(10, sc)
    sink.close()
    return path


@pytest.mark.parametrize("name", sorted(CONSOLES))
def test_rich_stream_matches_reference(name, tmp_path, references, capsys):
    rc, status, text = both(name, rich_stream(tmp_path), references, capsys)
    if name == "outcome_report":
        # the learner's 6 and the mirrored peer's 4
        assert rc == 0 and status["buckets"]["vs_scripted"] == {"episodes": 10.0, "wins": 4.0}
        assert status["curve_points"] == 1 and "win-rate curves" in text
    elif name == "fleet_status":
        assert rc == 0 and status["peers"] == ["a0", "a1", "a7"]
        assert [a["rule"] for a in status["active_alerts"]] == ["corrupt_frame_rate", "serve_peer_dead"]
        assert status["ok"] is False   # a page is active
        assert status["router"]["backend_sessions"] == {"0": 4, "1": 2}
    else:
        assert rc == 0 and status["ok"] and status["peers"]["a0"]["other"] == 0.75


@pytest.mark.parametrize("name", sorted(CONSOLES))
def test_torn_tail_matches_reference(name, tmp_path, references, capsys):
    path = rich_stream(tmp_path)
    with open(path, "a") as f:
        f.write('{"ts": 3.0, "step": 11, "scal')   # a kill mid-line
    rc, status, _ = both(name, path, references, capsys)
    assert status["step"] == 10
    assert rc == 0


@pytest.mark.parametrize("name", sorted(CONSOLES))
@pytest.mark.parametrize("record", [
    {"ts": "not-a-number", "step": 4, "scalars": {"outcome/episodes_total": 0.0}},
    {"ts": None, "step": "x", "scalars": {}},
], ids=["ts_string", "ts_none"])
def test_non_numeric_ts_matches_reference(name, record, tmp_path, references, capsys):
    path = tmp_path / "learner.jsonl"
    path.write_text(json.dumps(record) + "\n")
    rc, status, _ = both(name, path, references, capsys)
    # no episodes and no fold: the outcome and utilization reports say so
    assert rc == (0 if name == "fleet_status" else 1)


@pytest.mark.parametrize("name", sorted(CONSOLES))
def test_empty_stream_matches_reference(name, tmp_path, references, capsys):
    path = tmp_path / "learner.jsonl"
    path.write_text("")
    rc, status, _ = both(name, path, references, capsys)
    assert rc == (0 if name == "fleet_status" else 1) and status["step"] is None


@pytest.fixture(scope="module")
def learner_record(tmp_path_factory):
    path = tmp_path_factory.mktemp("smoke") / "learner.jsonl"
    assert plearner.main(["--smoke", "--steps", "2", "--device", "cpu", "--metrics-jsonl", str(path)]) == 0
    return path


@pytest.mark.parametrize("name", sorted(CONSOLES))
def test_port_learner_record_matches_reference(name, learner_record, references, capsys):
    rc, status, _ = both(name, learner_record, references, capsys)
    assert status["step"] == 2


def test_missing_file_exits_1(tmp_path, capsys):
    for mod, _ in CONSOLES.values():
        assert mod.main([str(tmp_path / "absent.jsonl")]) == 1
    assert "cannot read" in capsys.readouterr().err


def test_scan_metrics_skips_torn_events_and_bad_envelopes():
    lines = [
        json.dumps({"ts": 1.0, "step": 1, "scalars": {"a": 1.0, "s": "text"}}),
        '{"ts": 2.0, "step": 2, "scal',  # torn
        json.dumps([1, 2]),  # not an object
        json.dumps({"ts": 3.0, "event": "ALERT", "rule": "r", "state": "fired"}),
        json.dumps({"ts": "bad", "step": 3, "scalars": {"b": 2}}),
        json.dumps({"ts": 5.0, "step": "x", "scalars": {"a": 4.0}}),
        json.dumps({"ts": 6.0, "step": 9, "scalars": "not a dict"}),
    ]
    assert len(telemetry.json_records(lines)) == 5
    scan = telemetry.scan_metrics(lines)
    assert scan.points == [(1, {"a": 1.0}), (3, {"b": 2})]
    assert scan.union == {"a": 4.0, "b": 2}
    # a non-numeric ts keeps the last good one; a non-int step is no point
    assert scan.last_ts == 5.0 and scan.last_step == 3
    assert [ev["event"] for ev in scan.events] == ["ALERT"]
