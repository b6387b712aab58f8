"""Chaos supervisor: the port's learner and actor processes under a seeded fault plan.

Counterpart of the reference's ``scripts/chaos_run.py``: the same five
scenarios, their pass clauses and their ``CHAOS_SUMMARY`` keys, over the
port's CLIs (``python -m dotaclient_tpu_torch.train.learner``, ``.actor``,
``.serve``, ``.serve.router``, ``.serve.loadgen``). The supervisor drives the
real multi-process topology (actor processes feeding a socket-transport
learner) through the failures production runs see, and restarts a dead
actor as k8s would:

* ``baseline``: an actor SIGKILLed mid-run (and restarted); actor 0's frames
  corrupted on the wire (``DOTA_FAULTS=transport.corrupt_frame@F+G``), which
  the learner must count and drop; the learner SIGTERMed mid-run, which must
  drain (a checkpoint with its pipeline, exit 0) and, relaunched with
  ``--restore``, resume at exactly the saved step. The merged trace must hold
  the killed actor's chunks and its restarted incarnation under a new pid.
* ``divergence``: a NaN gradient (``learner.nan_grad@N``) rolled back to the
  last good checkpoint; the run ends at its target step and no actor ever
  applied a version of the poisoned range.
* ``alerts``: an actor killed and held down fires ``fleet_peer_stale``
  (runbook ``rb:fleet-peer-stale``), which resolves once it is restarted;
  actor 0's corrupt frames fire ``corrupt_frame_rate``.
* ``outcome``: episode outcomes reach the learner over the fleet lane; the
  whole fleet killed and held down fires ``outcome_stream_stale``, which
  resolves on the restarted fleet's episodes; ``utils/outcome_report.py``
  finds curves in the learner's record.
* ``serve_failover``: two serve backends and a hot spare on one tiny
  checkpoint behind the router CLI; a backend SIGKILLed mid-game pages
  ``serve_peer_dead``, the spare is promoted, every game completes with no
  error, and the in-process re-home parity digest stays bitwise.

``--device`` goes to every child (``--device`` to the learner and serve
CLIs, ``--platform`` to the actors); without it they run on the card, and
the supervisor raises without one. Each scenario's verdict is a function of
its summary (``*_fail``), so its clauses are checked apart from a run::

    python -m dotaclient_tpu_torch.utils.chaos_run --workdir /tmp/chaos [--scenario alerts] [--device cpu]

Prints ``CHAOS_SUMMARY {json}``; exit 0 iff the scenario passed.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import signal
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional

from dotaclient_tpu_torch.utils.telemetry import json_records, load_jsonl

# the checkout that holds the package: the children's working directory
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SCENARIOS = ("baseline", "divergence", "alerts", "outcome", "serve_failover")
LEARNER = "dotaclient_tpu_torch.train.learner"
ACTOR = "dotaclient_tpu_torch.actor"
SERVE = "dotaclient_tpu_torch.serve"
ROUTER = "dotaclient_tpu_torch.serve.router"
LOADGEN = "dotaclient_tpu_torch.serve.loadgen"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _latest_ckpt_step(ckpt_dir: str) -> Optional[int]:
    """The largest integer-named subdirectory: a step of the checkpoint layout."""
    try:
        steps = [int(d) for d in os.listdir(ckpt_dir) if d.isdigit()]
    except OSError:
        return None
    return max(steps) if steps else None


def _jsonl_scalars(path: str) -> List[Dict]:
    """The JSON lines of a (possibly live) file; a line torn by a kill or
    mid-write is skipped."""
    try:
        return json_records(load_jsonl(path))
    except OSError:
        return []


def _tagged(path: str, tag: str) -> List:
    """The JSON payloads of a log's ``TAG {json}`` lines."""
    out = []
    try:
        with open(path) as f:
            for line in f:
                if line.startswith(tag + " "):
                    out.append(json.loads(line[len(tag) + 1:]))
    except (OSError, json.JSONDecodeError):
        pass
    return out


def _max_scalar(records: List[Dict], key: str) -> float:
    """The high-water mark of one scalar over a metrics stream."""
    best = 0.0
    for rec in records:
        sc = rec.get("scalars")
        if isinstance(sc, dict):
            best = max(best, sc.get(key) or 0.0)
    return best


# -- the verdicts: each returns the first failed clause, or None -------------


def baseline_drain_fail(s: Dict) -> Optional[str]:
    """The first learner's SIGTERM drain."""
    if s["learner1_exit"] != 0:
        return "learner did not drain cleanly on SIGTERM"
    if not s["saved_step"] or s["saved_step"] < 1:
        return "no checkpoint captured by the drain"
    return None


def baseline_fail(s: Dict, resume_steps: int) -> Optional[str]:
    saved, final = s["saved_step"], s["final_step"]
    if s["learner2_exit"] != 0:
        return "restored learner did not complete cleanly"
    if final != saved + resume_steps:
        return (f"resume was not exact: expected final step {saved + resume_steps} (= saved {saved} + "
                f"{resume_steps}), got {final}")
    if s["frames_corrupt_total"] < 1:
        return "the corrupt-frame injection was never observed by the learner (frames_corrupt_total stayed 0)"
    if s["actor_kills"] < 1:
        return "no actor was killed — schedule never ran"
    if "trace_chunks_complete" not in s:
        return "merged trace report failed to build: " + s.get("trace_error", "unknown")
    if s["trace_chunks_complete"] < 1:
        return "no complete chunk trace survived the run — the trace plane lost the pipeline"
    victim = s.get("killed_actor_pid")
    if victim not in s["trace_origin_pids"]:
        return f"the killed actor's (pid {victim}) shipped chunks do not resolve in the merged trace report"
    pids = s["trace_incarnation_pids"]
    if victim not in pids or len(pids) < 2:
        return f"the restarted actor did not trace under a fresh origin pid (incarnations seen: {pids})"
    return None


def divergence_fail(s: Dict, target: int) -> Optional[str]:
    events = s["rollback_events"]
    if s["learner_exit"] != 0:
        return "learner did not survive the NaN gradient"
    if s["final_step"] != target:
        return (f"run did not complete to its target step after rollback: expected final checkpoint {target}, "
                f"got {s['final_step']}")
    if s["rollbacks_total"] < 1 or not events:
        return "no divergence rollback was recorded"
    if s["nonfinite_steps_total"] < 1:
        return "the NaN step was never counted by the probe"
    if any(ev["published_floor"] >= ev["detected_version"] for ev in events):
        return ("a version at/after the first flagged update was on the wire before the rollback — the publish "
                "gate leaked")
    if s["leaked_versions"]:
        return f"actors applied poisoned weight versions {s['leaked_versions']} — the publish gate leaked"
    if not any(s["actor_versions_seen"]):
        return "no actor reported its applied versions — the fanout (or the graceful actor drain) never happened"
    return None


def alerts_fail(s: Dict, actor_kills: int) -> Optional[str]:
    if s["learner_exit"] != 0:
        return "learner did not drain cleanly on SIGTERM"
    if s["stale_alert_fired"]["runbook"] != "rb:fleet-peer-stale":
        return f"staleness alert carries the wrong runbook anchor: {s['stale_alert_fired']['runbook']!r}"
    if s["corrupt_alert_fired"]["runbook"] != "rb:corrupt-frames":
        return f"integrity alert carries the wrong runbook anchor: {s['corrupt_alert_fired']['runbook']!r}"
    if s["alerts_fired_total"] < 2:
        return f"alerts/fired_total never reached 2 in the metrics stream (saw {s['alerts_fired_total']})"
    if actor_kills < 1:
        return "no actor was killed — the plan never ran"
    return None


def outcome_fail(s: Dict, actor_kills: int) -> Optional[str]:
    if s["learner_exit"] != 0:
        return "learner did not drain cleanly on SIGTERM"
    if s["stale_alert_fired"]["runbook"] != "rb:outcome-stale":
        return f"staleness alert carries the wrong runbook anchor: {s['stale_alert_fired']['runbook']!r}"
    if actor_kills < 1:
        return "no actor was killed — the plan never ran"
    if not s.get("outcome_status") or not s["outcome_status"].get("ok"):
        return ("outcome_report found no usable outcome curves in the learner JSONL: "
                + s.get("report_error", "OUTCOME_STATUS not ok"))
    return None


def serve_failover_fail(s: Dict, expected: int) -> Optional[str]:
    lg = s["loadgen"]
    if s["loadgen_exit"] != 0 or lg.get("errors") is None or lg["errors"]:
        return (f"a game failed or hung through the failover: loadgen rc={s['loadgen_exit']}, "
                f"errors={lg.get('errors')} ({lg.get('error_sample')})")
    if lg.get("replies") != expected:
        return f"stranded sessions: {lg.get('replies')} of {expected} requests answered"
    if (lg.get("sessions_rehomed") or 0) < 1:
        return "no session re-homed — the kill landed after the games finished (widen --serve-requests)"
    if s["dead_alert_fired"]["runbook"] != "rb:serve-peer-dead":
        return f"death alert carries the wrong runbook anchor: {s['dead_alert_fired']['runbook']!r}"
    if s["router_spares_promoted"] < 1:
        return "the hot spare was never promoted"
    if s["router_exit"] != 0 or any(s["backend_exits"]):
        return (f"a surviving serve child did not drain cleanly: router rc={s['router_exit']}, backends "
                f"{s['backend_exits']}")
    if s["rehome_parity"].get("parity") != "bitwise":
        return f"re-home parity digest failed: {s['rehome_parity'].get('parity')}"
    return None


class Supervisor:
    """The launch and restart policy of one learner and N actor processes
    (and, for ``serve_failover``, of the serve fleet)."""

    def __init__(self, args) -> None:
        self.args = args
        self.rng = random.Random(args.seed)
        self.port = _free_port()
        self.workdir = args.workdir
        self.ckpt_dir = os.path.join(self.workdir, "ckpt")
        self.actors: List[Optional[subprocess.Popen]] = [None] * args.actors
        self.learner: Optional[subprocess.Popen] = None
        # serve_failover's children: killed at cleanup, never restarted
        self.serve_children: List[subprocess.Popen] = []
        self.actor_extra: List[str] = []   # a scenario's extra actor flags
        self.actor_restarts = 0
        self.actor_kills = 0
        self.shutting_down = False
        self.deadline = time.monotonic() + args.timeout
        os.makedirs(self.workdir, exist_ok=True)

    # -- the children's commands ---------------------------------------------

    def device_flags(self) -> List[str]:
        """``--device`` for the learner and serve CLIs (none: the card)."""
        return ["--device", self.args.device] if self.args.device is not None else []

    def platform_flags(self) -> List[str]:
        """The actor's ``--platform``: the device's type."""
        dev = self.args.device
        return ["--platform", "cpu" if dev is not None and dev.split(":")[0] == "cpu" else "cuda"]

    def learner_cmd(self, phase: int, restore: bool, steps: Optional[int] = None,
                    extra: Optional[List[str]] = None) -> List[str]:
        cmd = [
            sys.executable, "-m", LEARNER,
            "--steps", str(steps if steps is not None else self.args.steps),
            "--transport", "socket",
            "--listen", f"127.0.0.1:{self.port}",
            "--checkpoint-dir", self.ckpt_dir,
            "--metrics-jsonl", os.path.join(self.workdir, f"learner{phase}.jsonl"),
            "--ppo", "rollout_len=8,batch_rollouts=8,minibatches=2,max_staleness=1000000",
            "--buffer", "capacity_rollouts=64,min_fill=8",
            "--refresh-every", "2",
            "--on-crash-checkpoint",
            # the pipeline traced at every chunk: the merged trace must
            # survive the kills and restarts
            "--trace-jsonl", os.path.join(self.workdir, f"learner{phase}.trace.jsonl"),
            "--trace-sample", "1",
            *self.device_flags(),
        ]
        cmd += extra or []
        if restore:
            cmd += ["--restore", "--steps", str(self.args.resume_steps)]
        return cmd

    def actor_cmd(self, i: int) -> List[str]:
        return [
            sys.executable, "-m", ACTOR,
            "--connect", f"127.0.0.1:{self.port}",
            "--n-envs", "4",
            "--rollout-len", "8",
            "--seed", str(i),
            "--max-reconnects", "10",
            # every incarnation appends to one trace log; events carry the
            # incarnation's pid, and a kill mid-line is the torn line the
            # reader drops
            "--trace-jsonl", os.path.join(self.workdir, f"actor{i}.trace.jsonl"),
            "--trace-sample", "1",
            *self.platform_flags(),
            *self.actor_extra,
        ]

    def serve_cmd(self) -> List[str]:
        return [sys.executable, "-m", SERVE, "--checkpoint", self.ckpt_dir, "--serve-listen", "127.0.0.1:0",
                *self.device_flags()]

    def router_cmd(self, backends: List[str], spares: List[str], jsonl: str) -> List[str]:
        return [sys.executable, "-m", ROUTER, "--listen", "127.0.0.1:0", "--backends", ",".join(backends),
                "--spares", ",".join(spares), "--serve", "router_probe_s=0.2,router_dead_after_s=1.0",
                "--metrics-jsonl", jsonl, "--interval", "0.5"]

    def loadgen_cmd(self, addr: str) -> List[str]:
        # a generous failover budget a request, so a request inside the
        # blackout re-homes instead of missing its deadline: the gate is no
        # error, not no disruption
        a = self.args
        return [sys.executable, "-m", LOADGEN, "--addr", addr, "--router", "--clients", str(a.serve_clients),
                "--requests", str(a.serve_requests), "--think-ms", "20", "--max-reconnects", "10",
                "--serve", "request_deadline_s=30,request_retries=20", "--seed", str(a.seed)]

    # -- process plumbing ----------------------------------------------------

    def _check_deadline(self) -> None:
        if time.monotonic() > self.deadline:
            raise TimeoutError(f"chaos run exceeded --timeout {self.args.timeout}s")

    @staticmethod
    def _env(faults: Optional[str] = None) -> Dict[str, str]:
        env = dict(os.environ)
        env.pop("DOTA_FAULTS", None)   # faults target named children only
        if faults:
            env["DOTA_FAULTS"] = faults
        return env

    def _spawn_learner(self, phase: int, restore: bool, steps: Optional[int] = None, faults: Optional[str] = None,
                       extra: Optional[List[str]] = None) -> subprocess.Popen:
        log = open(os.path.join(self.workdir, f"learner{phase}.log"), "w")
        self.learner = subprocess.Popen(self.learner_cmd(phase, restore, steps, extra), cwd=REPO,
                                        env=self._env(faults), stdout=log, stderr=subprocess.STDOUT)
        return self.learner

    def _spawn_actor(self, i: int) -> subprocess.Popen:
        # actor 0 flips bits: its Fth frame and every Gth after ship with a
        # wrong CRC trailer, which the learner must drop and count in both
        # learner phases
        faults = (f"transport.corrupt_frame@{self.args.corrupt_at}+{self.args.corrupt_every}" if i == 0 else None)
        log = open(os.path.join(self.workdir, f"actor{i}.log"), "a")
        return subprocess.Popen(self.actor_cmd(i), cwd=REPO, env=self._env(faults), stdout=log,
                                stderr=subprocess.STDOUT)

    def _tend_actors(self, skip: tuple = ()) -> None:
        """The restart policy: a dead actor (an exit on transport loss, our
        own SIGKILL) is relaunched, as k8s would. ``skip`` holds an index
        down on purpose."""
        if self.shutting_down:
            return
        for i, p in enumerate(self.actors):
            if i in skip:
                continue
            if p is None or p.poll() is not None:
                if p is not None:
                    self.actor_restarts += 1
                self.actors[i] = self._spawn_actor(i)

    def _stop_actors(self) -> Dict[str, int]:
        """SIGTERM every actor (they flush their partial chunks and exit 0),
        then kill the stragglers."""
        self.shutting_down = True
        clean = 0
        for p in self.actors:
            if p is not None and p.poll() is None:
                p.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + 30
        for p in self.actors:
            if p is None:
                continue
            while p.poll() is None and time.monotonic() < deadline:
                time.sleep(0.2)
            if p.poll() is None:
                p.kill()
                p.wait()
            elif p.returncode == 0:
                clean += 1
        return {"clean_actor_exits": clean}

    def _wait_for_progress(self, proc: subprocess.Popen, jsonl: str, min_step: int) -> int:
        """Block until the learner's record shows step >= ``min_step``;
        returns that step. A learner that exits first fails the run."""
        while True:
            self._check_deadline()
            self._tend_actors()
            for rec in _jsonl_scalars(jsonl):
                if rec.get("step", -1) >= min_step:
                    return rec["step"]
            if proc.poll() is not None:
                raise RuntimeError(f"learner exited rc={proc.returncode} before reaching step {min_step} — see its "
                                   f"log in {self.workdir}")
            time.sleep(0.5)

    def _wait_exit(self, proc: subprocess.Popen, what: str) -> int:
        while proc.poll() is None:
            self._check_deadline()
            self._tend_actors()
            time.sleep(0.5)
        print(f"chaos: {what} exited {proc.returncode}", flush=True)
        return proc.returncode

    def _alert_events(self, jsonl: str) -> List[Dict]:
        """The ALERT lines of a live record in file order (the alert engine
        flushes each, so polling mid-run is sound)."""
        return [rec for rec in _jsonl_scalars(jsonl) if rec.get("event") == "ALERT"]

    def _wait_alert(self, learner: subprocess.Popen, jsonl: str, rule: str, state: str, after_ts: float = 0.0,
                    skip: tuple = ()) -> Dict:
        """Poll the learner's record for an ALERT of ``rule`` in ``state``
        newer than ``after_ts``, tending the actors not in ``skip``. A
        learner that exits fails the run."""
        while True:
            self._check_deadline()
            self._tend_actors(skip=skip)
            for ev in self._alert_events(jsonl):
                if ev.get("rule") == rule and ev.get("state") == state and ev.get("ts", 0.0) > after_ts:
                    return ev
            if learner.poll() is not None:
                raise RuntimeError(f"learner exited rc={learner.returncode} before the {rule!r} alert reached state "
                                   f"{state!r} — see its log in {self.workdir}")
            time.sleep(0.5)

    # -- the scenarios -------------------------------------------------------

    def run(self) -> Dict:
        """``baseline``: kill, corrupt, SIGTERM, restore."""
        a = self.args
        summary: Dict = {"seed": a.seed, "port": self.port}
        jsonl1 = os.path.join(self.workdir, "learner1.jsonl")
        jsonl2 = os.path.join(self.workdir, "learner2.jsonl")

        learner = self._spawn_learner(1, restore=False)
        self._tend_actors()
        # 1) real training, then SIGKILL an actor at a seeded point of its cycle
        self._wait_for_progress(learner, jsonl1, min_step=1)
        time.sleep(self.rng.uniform(0.0, 2.0))
        victim = self.actors[a.actors - 1]
        if victim is not None and victim.poll() is None:
            victim.kill()   # no cleanup: the hard failure
            self.actor_kills += 1
            summary["killed_actor_pid"] = victim.pid
        summary["actor_kills"] = self.actor_kills

        # 2) at the threshold, stop the learner gracefully mid-run
        step_seen = self._wait_for_progress(learner, jsonl1, min_step=a.sigterm_at)
        learner.send_signal(signal.SIGTERM)
        summary["learner1_exit"] = self._wait_exit(learner, "learner phase 1 (SIGTERM drain)")
        summary["saved_step"] = _latest_ckpt_step(self.ckpt_dir)
        summary["sigterm_at_step"] = step_seen
        fail = baseline_drain_fail(summary)
        if fail:
            summary["fail"] = fail
            return summary

        # 3) relaunch with --restore: it resumes at exactly the saved step
        # and runs --resume-steps more (the actors reconnect meanwhile, or
        # run out of retries and are restarted)
        learner = self._spawn_learner(2, restore=True)
        summary["learner2_exit"] = self._wait_exit(learner, "learner phase 2 (restored)")
        summary.update(self._stop_actors())
        summary["final_step"] = _latest_ckpt_step(self.ckpt_dir)
        summary["actor_restarts"] = self.actor_restarts
        summary["frames_corrupt_total"] = _max_scalar(_jsonl_scalars(jsonl1) + _jsonl_scalars(jsonl2),
                                                      "transport/frames_corrupt_total")

        # 4) the merged trace: the killed actor's shipped chunks resolve, and
        # its restarted incarnation traces under a new pid
        try:
            from dotaclient_tpu_torch.utils.trace_report import build_report, load_events

            report = build_report([self.workdir])
            events, _skipped = load_events([os.path.join(self.workdir, f"actor{a.actors - 1}.trace.jsonl")])
            summary["trace_chunks_complete"] = report["chunks_complete"]
            summary["trace_origin_pids"] = report["origin_pids"]
            summary["trace_incarnation_pids"] = sorted({ev.get("pid") for ev in events if ev.get("pid")})
        except Exception as e:  # noqa: BLE001 - reported as a failure by the verdict
            summary["trace_error"] = f"{type(e).__name__}: {e}"
        fail = baseline_fail(summary, a.resume_steps)
        if fail:
            summary["fail"] = fail
        return summary

    def run_divergence(self) -> Dict:
        """``divergence``: a NaN gradient inside the topology is rolled back to
        the last good checkpoint, the run completes to its target step with
        exit 0, and no actor applies a poisoned version.

        The learner's ``HEALTH_ROLLBACK`` lines name each poisoned range
        ``[detected_version, resumed_version)`` and the ``published_floor``
        at the rollback; each actor prints ``ACTOR_VERSIONS_SEEN`` (every
        version it applied) at its graceful exit."""
        a = self.args
        summary: Dict = {"scenario": "divergence", "seed": a.seed, "port": self.port}
        jsonl = os.path.join(self.workdir, "learner1.jsonl")
        target = a.divergence_steps
        learner = self._spawn_learner(1, restore=False, steps=target, faults=f"learner.nan_grad@{a.nan_at}",
                                      extra=["--checkpoint-every", str(a.divergence_checkpoint_every)])
        self._tend_actors()
        summary["learner_exit"] = self._wait_exit(learner, "learner (divergence run)")
        summary.update(self._stop_actors())
        summary["final_step"] = _latest_ckpt_step(self.ckpt_dir)
        summary["actor_restarts"] = self.actor_restarts
        records = _jsonl_scalars(jsonl)
        summary["rollbacks_total"] = _max_scalar(records, "health/rollbacks_total")
        summary["nonfinite_steps_total"] = _max_scalar(records, "health/nonfinite_steps_total")
        events = _tagged(os.path.join(self.workdir, "learner1.log"), "HEALTH_ROLLBACK")
        summary["rollback_events"] = events
        # the union over each actor's incarnations: any of them could have
        # applied a poisoned version
        actor_versions = [sorted({v for seen in _tagged(os.path.join(self.workdir, f"actor{i}.log"),
                                                       "ACTOR_VERSIONS_SEEN") for v in seen})
                          for i in range(a.actors)]
        summary["actor_versions_seen"] = actor_versions
        # [detected_version, resumed_version): the flagged update's version
        # through the last one before the rollback. Versions between the
        # restore point and the detection came from clean steps, and their
        # publish was legitimate
        poisoned = set()
        for ev in events:
            poisoned.update(range(ev["detected_version"], ev["resumed_version"]))
        summary["poisoned_versions"] = sorted(poisoned)
        summary["leaked_versions"] = sorted(poisoned.intersection(v for vs in actor_versions for v in vs))
        fail = divergence_fail(summary, target)
        if fail:
            summary["fail"] = fail
        return summary

    def run_alerts(self) -> Dict:
        """``alerts``: the fleet assembles at a fast cadence; an actor killed
        and held down fires ``fleet_peer_stale`` with its runbook anchor,
        which resolves once it is restarted; actor 0's corrupt frames fire
        ``corrupt_frame_rate``; the learner drains on SIGTERM with
        ``alerts/fired_total`` >= 2 on record."""
        a = self.args
        summary: Dict = {"scenario": "alerts", "seed": a.seed, "port": self.port}
        jsonl = os.path.join(self.workdir, "learner1.jsonl")
        interval = a.fleet_interval
        self.actor_extra = ["--fleet-interval", str(interval)]
        learner = self._spawn_learner(1, restore=False, steps=10 ** 6, extra=["--fleet-interval", str(interval)])
        self._tend_actors()

        # 1) every actor reporting snapshots
        while True:
            self._check_deadline()
            self._tend_actors()
            peers = _max_scalar(_jsonl_scalars(jsonl), "fleet/peers")
            if peers >= a.actors:
                break
            if learner.poll() is not None:
                summary["fail"] = f"learner exited rc={learner.returncode} before the fleet assembled"
                return summary
            time.sleep(0.5)
        summary["fleet_peers_seen"] = peers

        # 2) SIGKILL the victim and hold it down: its silence is the signal
        victim_idx = a.actors - 1
        victim = self.actors[victim_idx]
        if victim is not None and victim.poll() is None:
            victim.kill()
            self.actor_kills += 1
            summary["killed_actor_pid"] = victim.pid
        try:
            fired = self._wait_alert(learner, jsonl, "fleet_peer_stale", "fired", skip=(victim_idx,))
        except (TimeoutError, RuntimeError) as e:
            summary["fail"] = f"staleness alert never fired: {e}"
            return summary
        summary["stale_alert_fired"] = {"runbook": fired.get("runbook"), "severity": fired.get("severity")}

        # 3) restart it (same seed, so the same peer id): the alert resolves
        self._tend_actors()
        try:
            resolved = self._wait_alert(learner, jsonl, "fleet_peer_stale", "resolved", after_ts=fired.get("ts", 0.0))
        except (TimeoutError, RuntimeError) as e:
            summary["fail"] = f"staleness alert did not resolve after restart: {e}"
            return summary
        summary["stale_alert_resolved_after_s"] = round(resolved.get("ts", 0.0) - fired.get("ts", 0.0), 1)

        # 4) the integrity alert: actor 0 has corrupted frames all along
        try:
            corrupt = self._wait_alert(learner, jsonl, "corrupt_frame_rate", "fired")
        except (TimeoutError, RuntimeError) as e:
            summary["fail"] = f"integrity alert never fired: {e}"
            return summary
        summary["corrupt_alert_fired"] = {"runbook": corrupt.get("runbook"), "severity": corrupt.get("severity")}

        # 5) the drain
        learner.send_signal(signal.SIGTERM)
        summary["learner_exit"] = self._wait_exit(learner, "learner (alerts scenario drain)")
        summary.update(self._stop_actors())
        summary["alerts_fired_total"] = _max_scalar(_jsonl_scalars(jsonl), "alerts/fired_total")
        summary["actor_restarts"] = self.actor_restarts
        fail = alerts_fail(summary, self.actor_kills)
        if fail:
            summary["fail"] = fail
        return summary

    def run_outcome(self) -> Dict:
        """``outcome``: one actor's short games feed the learner until episode
        outcomes reach it (``outcome/episodes_total`` > 0, over the fleet
        snapshots). Then every actor is killed and held down: training
        stalls, the fleet tick goes on, and ``outcome_stream_stale`` must
        fire with its runbook anchor, then resolve on the restarted fleet's
        episodes. The learner drains, and ``outcome_report`` finds curves
        in its record."""
        a = self.args
        summary: Dict = {"scenario": "outcome", "seed": a.seed, "port": self.port}
        jsonl = os.path.join(self.workdir, "learner1.jsonl")
        interval = a.fleet_interval
        self.actor_extra = ["--fleet-interval", str(interval), "--max-dota-time", "60"]
        learner = self._spawn_learner(1, restore=False, steps=10 ** 6, extra=["--fleet-interval", str(interval)])
        self._tend_actors()

        # 1) the outcome stream arms: ended episodes in the learner's totals
        while True:
            self._check_deadline()
            self._tend_actors()
            episodes = _max_scalar(_jsonl_scalars(jsonl), "outcome/episodes_total")
            if episodes >= 1:
                break
            if learner.poll() is not None:
                summary["fail"] = f"learner exited rc={learner.returncode} before any episode outcome arrived"
                return summary
            time.sleep(0.5)
        summary["episodes_before_kill"] = episodes

        # 2) SIGKILL every actor and hold them down
        held = tuple(range(a.actors))
        for victim in self.actors:
            if victim is not None and victim.poll() is None:
                victim.kill()
                self.actor_kills += 1
        try:
            fired = self._wait_alert(learner, jsonl, "outcome_stream_stale", "fired", skip=held)
        except (TimeoutError, RuntimeError) as e:
            summary["fail"] = f"outcome staleness alert never fired: {e}"
            return summary
        summary["stale_alert_fired"] = {"runbook": fired.get("runbook"), "severity": fired.get("severity")}

        # 3) restart the fleet; its new episodes resolve the alert
        self._tend_actors()
        try:
            resolved = self._wait_alert(learner, jsonl, "outcome_stream_stale", "resolved",
                                        after_ts=fired.get("ts", 0.0))
        except (TimeoutError, RuntimeError) as e:
            summary["fail"] = f"outcome staleness alert did not resolve after restart: {e}"
            return summary
        summary["stale_alert_resolved_after_s"] = round(resolved.get("ts", 0.0) - fired.get("ts", 0.0), 1)

        # 4) the drain and the report
        learner.send_signal(signal.SIGTERM)
        summary["learner_exit"] = self._wait_exit(learner, "learner (outcome scenario drain)")
        summary.update(self._stop_actors())
        summary["actor_restarts"] = self.actor_restarts
        try:
            from dotaclient_tpu_torch.utils.outcome_report import parse_stream, render

            _text, summary["outcome_status"] = render(*parse_stream(load_jsonl(jsonl)), 40)
        except Exception as e:  # noqa: BLE001 - reported as a failure by the verdict
            summary["outcome_status"] = None
            summary["report_error"] = f"{type(e).__name__}: {e}"
        fail = outcome_fail(summary, self.actor_kills)
        if fail:
            summary["fail"] = fail
        return summary

    # -- serve_failover ------------------------------------------------------

    def _spawn_child(self, name: str, cmd: List[str]) -> subprocess.Popen:
        """A serve-plane child (backend, router, loadgen) with no fault,
        logging to ``<name>.log``."""
        log = open(os.path.join(self.workdir, f"{name}.log"), "w")
        proc = subprocess.Popen(cmd, cwd=REPO, env=self._env(), stdout=log, stderr=subprocess.STDOUT)
        self.serve_children.append(proc)
        return proc

    def _wait_banner(self, proc: subprocess.Popen, log_path: str, tag: str) -> Dict:
        """Poll a child's log for its ``TAG {json}`` start line
        (SERVE_LISTENING, ROUTER_LISTENING)."""
        while True:
            self._check_deadline()
            found = _tagged(log_path, tag)
            if found:
                return found[0]
            if proc.poll() is not None:
                raise RuntimeError(f"child exited rc={proc.returncode} before printing {tag} — see {log_path}")
            time.sleep(0.2)

    def write_tiny_checkpoint(self) -> None:
        """One tiny checkpoint all three backends load: the stored config
        carries the small model (H 8, unit embedding 8, hero embedding 4);
        the observation and action specs stay the default the loadgen's
        requests are drawn from."""
        import dataclasses

        import torch

        from dotaclient_tpu_torch.config import ModelConfig, RunConfig
        from dotaclient_tpu_torch.models.policy import init_params, make_policy
        from dotaclient_tpu_torch.train.ppo import init_train_state
        from dotaclient_tpu_torch.utils.checkpoint import CheckpointManager

        cfg = dataclasses.replace(RunConfig(), model=ModelConfig(unit_embed_dim=8, hidden_dim=8, hero_embed_dim=4))
        policy = make_policy(cfg.model, cfg.obs, cfg.actions, device="cpu")
        init_params(policy, torch.Generator().manual_seed(self.args.seed))
        mgr = CheckpointManager(self.ckpt_dir)
        if not mgr.save(init_train_state(policy, cfg.ppo), cfg, force=True):
            raise RuntimeError("the tiny checkpoint was not saved")
        mgr.close()

    def run_serve_failover(self) -> Dict:
        """``serve_failover``: two serve backends and a hot spare (the same
        process on one tiny checkpoint; the router names the spare) behind
        the router CLI; a loadgen fleet of games attaches through it at a
        game's cadence. Mid-game one backend is SIGKILLed and held down:
        the router's probe declares it dead past the grace window,
        ``serve_peer_dead`` pages with its runbook anchor, the spare is
        promoted and every stranded session re-homes, and the loadgen
        completes every game with no error. Then the re-home parity digest
        (carry shadow) runs in process and must be bitwise."""
        a = self.args
        summary: Dict = {"scenario": "serve_failover", "seed": a.seed}
        # no learner or actor here: _wait_exit must not start actors
        self.shutting_down = True
        self.write_tiny_checkpoint()

        # the fleet: three backends, then the router over them
        backends = [self._spawn_child(f"serve{i}", self.serve_cmd()) for i in range(3)]
        addrs = [self._wait_banner(backends[i], os.path.join(self.workdir, f"serve{i}.log"), "SERVE_LISTENING")
                 for i in range(3)]

        def addr_str(d: Dict) -> str:
            return f"{d['host']}:{d['port']}"

        router_jsonl = os.path.join(self.workdir, "router.jsonl")
        router_proc = self._spawn_child("router", self.router_cmd([addr_str(x) for x in addrs[:2]],
                                                                  [addr_str(addrs[2])], router_jsonl))
        rinfo = self._wait_banner(router_proc, os.path.join(self.workdir, "router.log"), "ROUTER_LISTENING")

        def router_scalar(key: str) -> float:
            # the high-water mark: "reached at least once" tolerates the
            # snapshot cadence's lag
            return _max_scalar(_jsonl_scalars(router_jsonl), key)

        def wait_router(pred, what: str) -> None:
            while not pred():
                self._check_deadline()
                if router_proc.poll() is not None:
                    raise RuntimeError(f"router exited rc={router_proc.returncode} while waiting for {what}")
                time.sleep(0.3)

        wait_router(lambda: router_scalar("router/backends_live") >= 2
                    and router_scalar("router/spares_available") >= 1,
                    "the probes to confirm 2 live backends + 1 spare")

        # live games through the router
        load_proc = self._spawn_child("loadgen", self.loadgen_cmd(addr_str(rinfo)))
        wait_router(lambda: router_scalar("router/sessions_active") >= a.serve_clients, "every game to attach")
        if load_proc.poll() is not None:
            summary["fail"] = "loadgen finished before the kill landed"
            return summary

        # SIGKILL one active backend mid-game and hold it down
        backends[0].kill()
        summary["killed_backend"] = addr_str(addrs[0])
        t_kill = time.time()
        try:
            while True:
                self._check_deadline()
                fired = next((ev for ev in self._alert_events(router_jsonl)
                              if ev.get("rule") == "serve_peer_dead" and ev.get("state") == "fired"), None)
                if fired is not None:
                    break
                if router_proc.poll() is not None:
                    raise RuntimeError(f"router exited rc={router_proc.returncode} before the 'serve_peer_dead' "
                                       "alert reached 'fired'")
                time.sleep(0.3)
        except (TimeoutError, RuntimeError) as e:
            summary["fail"] = f"serve_peer_dead never fired: {e}"
            return summary
        summary["dead_alert_fired"] = {"runbook": fired.get("runbook"), "severity": fired.get("severity"),
                                       "after_s": round(fired.get("ts", t_kill) - t_kill, 1)}

        # every game completes, the re-homed ones too
        summary["loadgen_exit"] = self._wait_exit(load_proc, "serve loadgen")
        loadgen_out: Dict = {}
        for rec in _jsonl_scalars(os.path.join(self.workdir, "loadgen.log")):
            if "replies" in rec:
                loadgen_out = rec
        summary["loadgen"] = {k: loadgen_out.get(k) for k in ("replies", "errors", "error_sample", "deadline_errors",
                                                              "sessions_rehomed", "actions_per_sec", "p99_ms")}

        # drain the survivors: SIGINT, their last lines, clean exits
        for proc in (router_proc, backends[1], backends[2]):
            if proc.poll() is None:
                proc.send_signal(signal.SIGINT)
        summary["router_exit"] = self._wait_exit(router_proc, "router")
        summary["backend_exits"] = [self._wait_exit(backends[i], f"serve{i}") for i in (1, 2)]
        summary["router_sessions_rehomed"] = router_scalar("router/sessions_rehomed_total")
        summary["router_spares_promoted"] = router_scalar("router/spares_promoted_total")
        summary["router_backend_deaths"] = router_scalar("router/backend_deaths_total")

        # the carry half of the re-home contract, in process: bit-exact
        # under carry shadow against reference_step
        from dotaclient_tpu_torch.serve.loadgen import run_rehome_parity

        summary["rehome_parity"] = run_rehome_parity(seed=a.seed, device=a.device)
        fail = serve_failover_fail(summary, a.serve_clients * a.serve_requests)
        if fail:
            summary["fail"] = fail
        return summary

    def cleanup(self) -> None:
        """Kill every child still running (a failed or timed-out plan must
        not leave a learner holding the port) and reap them."""
        self.shutting_down = True
        for p in (*self.actors, self.learner, *self.serve_children):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workdir", default=os.path.join(os.environ.get("TMPDIR", "/tmp"), "tpu-dota-torch-chaos"))
    p.add_argument("--actors", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=500,
                   help="phase-1 step budget (never reached: the SIGTERM lands first, which is the point)")
    p.add_argument("--sigterm-at", type=int, default=10,
                   help="SIGTERM the learner once its metrics stream shows this optimizer step")
    p.add_argument("--resume-steps", type=int, default=10,
                   help="steps the restored learner must run; the final checkpoint must land at saved_step + this")
    p.add_argument("--corrupt-at", type=int, default=3)
    p.add_argument("--corrupt-every", type=int, default=5,
                   help="actor 0 corrupts its corrupt-at'th frame and every corrupt-every'th after")
    p.add_argument("--scenario", choices=SCENARIOS, default="baseline",
                   help="baseline: kill, corrupt, SIGTERM, restore; divergence: a NaN gradient rolled back, the "
                   "target step reached, no poisoned version applied; alerts: a held-down actor fires "
                   "fleet_peer_stale and its restart resolves it, corrupt frames fire the integrity alert; outcome: "
                   "the held-down fleet fires outcome_stream_stale and its restart resolves it; serve_failover: a "
                   "serve backend killed mid-game pages serve_peer_dead, the spare is promoted, every session "
                   "re-homes, the re-home parity digest stays bitwise")
    p.add_argument("--fleet-interval", type=float, default=0.5,
                   help="alerts and outcome: the fleet snapshot and aggregation cadence in seconds")
    p.add_argument("--divergence-steps", type=int, default=24,
                   help="divergence: the optimizer steps the run must complete despite the rollback")
    p.add_argument("--nan-at", type=int, default=8,
                   help="divergence: poison the Nth optimizer batch (learner.nan_grad@N; with minibatches=2 batch "
                   "N lands at step 2N)")
    p.add_argument("--divergence-checkpoint-every", type=int, default=6,
                   help="divergence: the periodic checkpoint cadence (a last good restore point before the NaN)")
    p.add_argument("--serve-clients", type=int, default=6, help="serve_failover: concurrent games")
    p.add_argument("--serve-requests", type=int, default=200,
                   help="serve_failover: requests a game (at a 20 ms think cadence, so the kill lands mid-game)")
    p.add_argument("--device", type=str, default=None,
                   help="every child's torch device (default: the current CUDA card; 'cpu' must be asked for)")
    p.add_argument("--timeout", type=float, default=900.0)
    p.add_argument("--keep-workdir", action="store_true")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    from dotaclient_tpu_torch.device import resolve_device

    resolve_device(args.device)   # no card: raise here, before a child starts
    if os.path.isdir(args.workdir):
        shutil.rmtree(args.workdir)
    sup = Supervisor(args)
    runs = {"baseline": sup.run, "divergence": sup.run_divergence, "alerts": sup.run_alerts,
            "outcome": sup.run_outcome, "serve_failover": sup.run_serve_failover}
    try:
        summary = runs[args.scenario]()
    except (TimeoutError, RuntimeError) as e:
        summary = {"fail": str(e)}
    finally:
        sup.cleanup()
    summary["ok"] = "fail" not in summary
    print("CHAOS_SUMMARY " + json.dumps(summary, sort_keys=True), flush=True)
    if not args.keep_workdir and summary["ok"]:
        shutil.rmtree(args.workdir, ignore_errors=True)
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
