"""The port's chaos supervisor (``utils/chaos_run.py``, the counterpart of
``scripts/chaos_run.py``).

In tier-1: every child command the supervisor builds names a module of the
port and passes only flags that module's parser accepts (each parsed by the
module's own ``main`` up to its ``parse_args``), ``--device`` reaches every
child that takes one, and each scenario's verdict passes on canned evidence
and fails for each of its clauses. Marked ``slow``, as the reference's
``tests/test_chaos.py`` is: the five scenarios end to end with ``--device
cpu``, each a multi-process run of minutes."""

import argparse
import copy
import importlib
import importlib.util
import json
import os
import subprocess
import sys

import pytest

from dotaclient_tpu_torch.utils import chaos_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Parsed(Exception):
    pass


def parse_with_module(argv, monkeypatch):
    """Parse ``argv`` (``[python, -m, module, flags...]``) with the module's
    own ``main`` up to its ``parse_args``; an unknown flag fails."""
    assert argv[0] == sys.executable and argv[1] == "-m"
    module = argv[2]
    assert module.startswith("dotaclient_tpu_torch."), module
    if importlib.util.find_spec(module).submodule_search_locations:
        module += ".__main__"   # a package run with -m
    mod = importlib.import_module(module)

    def parse_args(self, args=None, namespace=None):
        ns, extras = argparse.ArgumentParser.parse_known_args(self, args, namespace)
        assert not extras, f"{argv[2]} does not accept {extras}"
        raise Parsed(ns)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    with pytest.raises(Parsed) as caught:
        mod.main(argv[3:])
    monkeypatch.undo()
    return caught.value.args[0]


def supervisor(tmp_path, *flags):
    args = chaos_run.parse_args(["--workdir", str(tmp_path / "chaos"), *flags])
    return chaos_run.Supervisor(args)


def every_command(sup):
    cmds = {
        "learner": sup.learner_cmd(1, restore=False),
        "learner_restore": sup.learner_cmd(2, restore=True),
        "learner_divergence": sup.learner_cmd(1, restore=False, steps=24,
                                              extra=["--checkpoint-every", "6"]),
        "learner_fleet": sup.learner_cmd(1, restore=False, steps=10 ** 6, extra=["--fleet-interval", "0.5"]),
        "actor": sup.actor_cmd(0),
        "serve": sup.serve_cmd(),
        "router": sup.router_cmd(["127.0.0.1:1", "127.0.0.1:2"], ["127.0.0.1:3"], "/dev/null"),
        "loadgen": sup.loadgen_cmd("127.0.0.1:4"),
    }
    sup.actor_extra = ["--fleet-interval", "0.5", "--max-dota-time", "60"]
    cmds["actor_outcome"] = sup.actor_cmd(1)
    return cmds


@pytest.mark.parametrize("device", [None, "cpu"])
def test_children_name_port_modules_and_accepted_flags(device, tmp_path, monkeypatch):
    sup = supervisor(tmp_path, *(["--device", device] if device else []))
    parsed = {name: parse_with_module(cmd, monkeypatch) for name, cmd in every_command(sup).items()}
    for name in ("learner", "learner_restore", "serve"):
        assert parsed[name].device == device, name
    assert parsed["actor"].platform == ("cpu" if device else "cuda")
    assert parsed["learner_restore"].restore and parsed["learner_restore"].steps == 10
    assert parsed["learner"].transport == "socket" and parsed["learner"].on_crash_checkpoint
    assert parsed["actor_outcome"].max_dota_time == 60 and parsed["actor_outcome"].fleet_interval == 0.5
    assert parsed["loadgen"].router and parsed["loadgen"].clients == 6


def test_children_match_reference_flags(tmp_path):
    """The learner's and the actor's flags are the reference's, with the
    device flag added."""
    ref = chaos_run_reference()
    sup = supervisor(tmp_path, "--device", "cpu")
    rsup = ref.Supervisor(ref_args(ref, tmp_path))
    rsup.port = sup.port
    rsup.workdir, rsup.ckpt_dir = sup.workdir, sup.ckpt_dir
    captured = []

    class Fake:
        def __init__(self, cmd, **kw):
            captured.append(cmd)

    orig = ref.subprocess.Popen
    ref.subprocess.Popen = Fake
    try:
        rsup._spawn_learner(1, restore=True)
        rsup._spawn_actor(0)
    finally:
        ref.subprocess.Popen = orig
    learner, actor = captured
    assert learner[1:2] == ["-m"] and learner[2] == "dotaclient_tpu.train.learner"
    port_learner = sup.learner_cmd(1, restore=True)
    assert port_learner[3:] == learner[3:-3] + ["--device", "cpu"] + learner[-3:]
    assert sup.actor_cmd(0)[3:] == actor[3:] + ["--platform", "cpu"]


def chaos_run_reference():
    spec = importlib.util.spec_from_file_location("_ref_chaos_run", os.path.join(REPO, "scripts", "chaos_run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ref_args(ref, tmp_path):
    """The reference's arguments, parsed by its own ``main``."""
    orig = argparse.ArgumentParser.parse_args

    def parse_args(self, args=None, namespace=None):
        raise Parsed(orig(self, args, namespace))

    argparse.ArgumentParser.parse_args = parse_args
    try:
        with pytest.raises(Parsed) as caught:
            ref.main(["--workdir", str(tmp_path / "ref")])
    finally:
        argparse.ArgumentParser.parse_args = orig
    return caught.value.args[0]


def test_parser_defaults_match_reference(tmp_path):
    ref = vars(ref_args(chaos_run_reference(), tmp_path))
    port = vars(chaos_run.parse_args(["--workdir", str(tmp_path / "ref")]))
    assert port.pop("device") is None
    assert port == ref


# -- the verdicts on canned evidence ------------------------------------------

BASELINE = {"learner1_exit": 0, "saved_step": 12, "learner2_exit": 0, "final_step": 22, "frames_corrupt_total": 3.0,
            "actor_kills": 1, "killed_actor_pid": 101, "trace_chunks_complete": 5, "trace_origin_pids": [100, 101],
            "trace_incarnation_pids": [101, 107]}
DIVERGENCE = {"learner_exit": 0, "final_step": 24, "rollbacks_total": 1.0, "nonfinite_steps_total": 1.0,
              "rollback_events": [{"detected_version": 16, "resumed_version": 20, "published_floor": 14}],
              "leaked_versions": [], "actor_versions_seen": [[2, 4, 14, 20], [2, 22]]}
ALERTS = {"learner_exit": 0, "stale_alert_fired": {"runbook": "rb:fleet-peer-stale", "severity": "page"},
          "corrupt_alert_fired": {"runbook": "rb:corrupt-frames", "severity": "warn"}, "alerts_fired_total": 2.0}
OUTCOME = {"learner_exit": 0, "stale_alert_fired": {"runbook": "rb:outcome-stale", "severity": "page"},
           "outcome_status": {"ok": True}}
FAILOVER = {"loadgen_exit": 0, "loadgen": {"replies": 1200, "errors": 0, "error_sample": [], "sessions_rehomed": 3},
            "dead_alert_fired": {"runbook": "rb:serve-peer-dead"}, "router_spares_promoted": 1.0, "router_exit": 0,
            "backend_exits": [0, 0], "rehome_parity": {"parity": "bitwise"}}


def baseline_verdict(s):
    return chaos_run.baseline_drain_fail(s) or chaos_run.baseline_fail(s, 10)


VERDICTS = {
    "baseline": (BASELINE, baseline_verdict),
    "divergence": (DIVERGENCE, lambda s: chaos_run.divergence_fail(s, 24)),
    "alerts": (ALERTS, lambda s: chaos_run.alerts_fail(s, s.pop("_kills", 1))),
    "outcome": (OUTCOME, lambda s: chaos_run.outcome_fail(s, s.pop("_kills", 1))),
    "serve_failover": (FAILOVER, lambda s: chaos_run.serve_failover_fail(s, 1200)),
}

# (scenario, clause) -> (the change to the passing evidence, a phrase of the failure)
CLAUSES = {
    ("baseline", "drain_exit"): ({"learner1_exit": -15}, "did not drain cleanly"),
    ("baseline", "no_save"): ({"saved_step": None}, "no checkpoint captured"),
    ("baseline", "restored_exit"): ({"learner2_exit": 1}, "restored learner did not complete"),
    ("baseline", "inexact_resume"): ({"final_step": 23}, "resume was not exact"),
    ("baseline", "no_corrupt"): ({"frames_corrupt_total": 0.0}, "corrupt-frame injection was never observed"),
    ("baseline", "no_kill"): ({"actor_kills": 0}, "no actor was killed"),
    ("baseline", "no_trace"): ({"trace_chunks_complete": None, "trace_error": "OSError: x"},
                               "merged trace report failed to build: OSError: x"),
    ("baseline", "no_chunk"): ({"trace_chunks_complete": 0}, "no complete chunk trace"),
    ("baseline", "victim_lost"): ({"trace_origin_pids": [100]}, "do not resolve in the merged trace"),
    ("baseline", "one_incarnation"): ({"trace_incarnation_pids": [101]}, "did not trace under a fresh origin pid"),
    ("divergence", "exit"): ({"learner_exit": 1}, "did not survive the NaN gradient"),
    ("divergence", "target"): ({"final_step": 18}, "did not complete to its target step"),
    ("divergence", "no_rollback"): ({"rollbacks_total": 0.0}, "no divergence rollback"),
    ("divergence", "no_event"): ({"rollback_events": []}, "no divergence rollback"),
    ("divergence", "no_nonfinite"): ({"nonfinite_steps_total": 0.0}, "never counted by the probe"),
    ("divergence", "floor"): ({"rollback_events": [{"detected_version": 16, "resumed_version": 20,
                                                    "published_floor": 16}]}, "on the wire before the rollback"),
    ("divergence", "leaked"): ({"leaked_versions": [17]}, "applied poisoned weight versions [17]"),
    ("divergence", "no_fanout"): ({"actor_versions_seen": [[], []]}, "no actor reported its applied versions"),
    ("alerts", "exit"): ({"learner_exit": 1}, "did not drain cleanly"),
    ("alerts", "stale_runbook"): ({"stale_alert_fired": {"runbook": "rb:x"}}, "staleness alert carries the wrong"),
    ("alerts", "corrupt_runbook"): ({"corrupt_alert_fired": {"runbook": "rb:x"}}, "integrity alert carries the wrong"),
    ("alerts", "fired_total"): ({"alerts_fired_total": 1.0}, "never reached 2"),
    ("alerts", "no_kill"): ({"_kills": 0}, "no actor was killed"),
    ("outcome", "exit"): ({"learner_exit": 1}, "did not drain cleanly"),
    ("outcome", "runbook"): ({"stale_alert_fired": {"runbook": "rb:x"}}, "staleness alert carries the wrong"),
    ("outcome", "no_kill"): ({"_kills": 0}, "no actor was killed"),
    ("outcome", "no_curves"): ({"outcome_status": {"ok": False}}, "OUTCOME_STATUS not ok"),
    ("outcome", "report_error"): ({"outcome_status": None, "report_error": "KeyError: x"}, "KeyError: x"),
    ("serve_failover", "loadgen_exit"): ({"loadgen_exit": 1}, "a game failed or hung"),
    ("serve_failover", "errors"): ({"loadgen": {**FAILOVER["loadgen"], "errors": 2}}, "a game failed or hung"),
    ("serve_failover", "no_loadgen_line"): ({"loadgen": {"replies": None, "errors": None}}, "a game failed or hung"),
    ("serve_failover", "stranded"): ({"loadgen": {**FAILOVER["loadgen"], "replies": 1199}}, "stranded sessions"),
    ("serve_failover", "no_rehome"): ({"loadgen": {**FAILOVER["loadgen"], "sessions_rehomed": 0}},
                                      "no session re-homed"),
    ("serve_failover", "runbook"): ({"dead_alert_fired": {"runbook": "rb:x"}}, "death alert carries the wrong"),
    ("serve_failover", "no_promotion"): ({"router_spares_promoted": 0.0}, "hot spare was never promoted"),
    ("serve_failover", "router_exit"): ({"router_exit": 1}, "did not drain cleanly"),
    ("serve_failover", "backend_exit"): ({"backend_exits": [0, -9]}, "did not drain cleanly"),
    ("serve_failover", "parity"): ({"rehome_parity": {"parity": "diverged"}}, "re-home parity digest failed"),
}


@pytest.mark.parametrize("scenario", sorted(VERDICTS))
def test_verdict_passes_on_canned_evidence(scenario):
    evidence, verdict = VERDICTS[scenario]
    assert verdict(copy.deepcopy(evidence)) is None


@pytest.mark.parametrize("scenario,clause", sorted(CLAUSES))
def test_verdict_fails_on_each_clause(scenario, clause):
    evidence, verdict = VERDICTS[scenario]
    change, phrase = CLAUSES[(scenario, clause)]
    s = copy.deepcopy(evidence)
    for k, v in change.items():
        if v is None and k == "trace_chunks_complete":
            s.pop(k)
        else:
            s[k] = v
    fail = verdict(s)
    assert fail is not None and phrase in fail, fail


def test_no_card_raises_before_a_child(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chaos_run.main(["--workdir", str(tmp_path / "chaos")])
    assert not os.path.exists(tmp_path / "chaos")


# -- end to end on the CPU ----------------------------------------------------

SCENARIO_CHECKS = {
    "baseline": lambda s: s["learner1_exit"] == 0 == s["learner2_exit"] and s["actor_kills"] >= 1
    and s["frames_corrupt_total"] >= 1 and s["final_step"] == s["saved_step"] + 10,
    "divergence": lambda s: s["learner_exit"] == 0 and s["rollbacks_total"] >= 1 and s["final_step"] == 24
    and s["leaked_versions"] == [] and any(s["actor_versions_seen"]),
    "alerts": lambda s: s["stale_alert_fired"]["runbook"] == "rb:fleet-peer-stale"
    and s["stale_alert_fired"]["severity"] == "page" and s["alerts_fired_total"] >= 2,
    "outcome": lambda s: s["stale_alert_fired"]["runbook"] == "rb:outcome-stale" and s["outcome_status"]["ok"],
    "serve_failover": lambda s: s["loadgen"]["errors"] == 0 and s["loadgen"]["sessions_rehomed"] >= 1
    and s["rehome_parity"]["parity"] == "bitwise",
}


@pytest.mark.slow
@pytest.mark.parametrize("scenario", sorted(SCENARIO_CHECKS))
def test_chaos_scenario_end_to_end_on_cpu(scenario, tmp_path):
    env = dict(os.environ)
    env.pop("DOTA_FAULTS", None)
    proc = subprocess.run(
        [sys.executable, "-m", "dotaclient_tpu_torch.utils.chaos_run", "--scenario", scenario, "--workdir",
         str(tmp_path / "chaos"), "--seed", "0", "--timeout", "900", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=960,
    )
    lines = [line for line in proc.stdout.splitlines() if line.startswith("CHAOS_SUMMARY ")]
    assert lines, f"no CHAOS_SUMMARY\nstdout:\n{proc.stdout[-3000:]}\nstderr:\n{proc.stderr[-3000:]}"
    summary = json.loads(lines[-1][len("CHAOS_SUMMARY "):])
    assert proc.returncode == 0 and summary["ok"], summary
    assert SCENARIO_CHECKS[scenario](summary), summary
