"""The port's static checks (``dotaclient_tpu_torch/lint/``) against the JAX
package's (``dotaclient_tpu/lint/``).

For every pass: a positive fixture (the pass flags its target pattern), a
waiver fixture (``# lint-ok: <rule>(<why>)`` waives it) and a baseline
fixture (the fingerprint suppresses it). Where the reference's pass has a
counterpart, the same fixture source, its paths mapped from
``dotaclient_tpu/`` to ``dotaclient_tpu_torch/``, gives the same
``(line, rule)`` diagnostics under both passes; the race shapes of
``tests/test_lint.py`` run against both shipped ownership maps, moved to
the port's names. The real lint is clean on the port under ``--strict``.
Everything here is pure AST analysis: no torch, no devices.
"""

from __future__ import annotations

import os

import pytest

from dotaclient_tpu.lint import config_drift as ref_config
from dotaclient_tpu.lint import core as ref_core
from dotaclient_tpu.lint import host_sync as ref_host_sync
from dotaclient_tpu.lint import ownership as ref_ownership
from dotaclient_tpu.lint import telemetry_drift as ref_telemetry
from dotaclient_tpu_torch.lint import ALL_RULES
from dotaclient_tpu_torch.lint import alert_drift, config_drift, core, host_sync, ownership, telemetry_drift
from dotaclient_tpu_torch.lint.core import REPO_ROOT, Diagnostic, FileCtx, Rule, fingerprint, load_baseline, run_rules

PACKAGES = {"ref": ref_core, "port": core}


def port_path(path):
    return path.replace("dotaclient_tpu/", "dotaclient_tpu_torch/", 1)


def run_in_memory(rule, files_dict, baseline=(), strict=False, pkg=core):
    """core.run_rules over in-memory sources: (new, suppressed) lists of
    (Diagnostic, fingerprint)."""
    files = {p: pkg.FileCtx(p, src) for p, src in files_dict.items()}
    new, suppressed = [], []
    for d in rule.check(files):
        ctx = files.get(d.path)
        if ctx is not None and d.line and ctx.waived(d.line, rule.id):
            continue
        fp = pkg.fingerprint(d, ctx)
        if not strict and fp in baseline:
            suppressed.append((d, fp))
        else:
            new.append((d, fp))
    return new, suppressed


def lines_rules(found):
    return sorted((d.line, d.rule) for d, _ in found)


def real_files(rule):
    files = {}
    for rel in rule.paths():
        path = os.path.join(REPO_ROOT, rel)
        if os.path.exists(path):
            with open(path) as f:
                files[rel] = FileCtx(rel, f.read())
    return files


# -- the framework core: a copy of the reference's ---------------------------


def fake_rule(pkg):
    class FakeRule(pkg.Rule):
        id = "fake"
        summary = "test"

        def paths(self):
            return ["mod.py"]

        def check(self, files):
            return [pkg.Diagnostic("mod.py", i, "fake", "boom")
                    for i, line in enumerate(files["mod.py"].lines, 1) if "BAD" in line]

    return FakeRule()


CORE_CASES = {
    "plain": "x = BAD\n",
    "waived_here": "x = BAD  # lint-ok: fake(known)\n",
    "waived_above": "# lint-ok: fake(known)\nx = BAD\n",
    "other_rule": "x = BAD  # lint-ok: other-rule(nope)\n",
    "no_why": "x = BAD  # lint-ok: fake()\n",
    "block": "# lint-ok: fake(a long explanation that\n# continues over lines\n# before it)\nx = BAD\n",
    "broken_block": "# lint-ok: fake(why)\ny = 1\nx = BAD\n",
    "drifted": "# pushed down\n\n\nx = BAD\n",
}


@pytest.mark.parametrize("case", sorted(CORE_CASES))
def test_core_waivers_and_fingerprints_equal_the_references(case):
    src = CORE_CASES[case]
    got = {name: run_in_memory(fake_rule(pkg), {"mod.py": src}, pkg=pkg)[0] for name, pkg in PACKAGES.items()}
    assert [(d.line, d.rule, fp) for d, fp in got["port"]] == [(d.line, d.rule, fp) for d, fp in got["ref"]]
    if case in ("waived_here", "waived_above", "block"):
        assert got["port"] == []
    else:
        assert len(got["port"]) == 1


def test_core_baseline_suppresses_and_strict_does_not(tmp_path):
    rule = fake_rule(core)
    (fp_new,) = [fp for _, fp in run_in_memory(rule, {"mod.py": "x = BAD\n"})[0]]
    new, supp = run_in_memory(rule, {"mod.py": "x = BAD\n"}, baseline=(fp_new,))
    assert new == [] and len(supp) == 1
    assert len(run_in_memory(rule, {"mod.py": "x = BAD\n"}, baseline=(fp_new,), strict=True)[0]) == 1
    (tmp_path / "mod.py").write_text("x = BAD\n")
    result = run_rules([rule], str(tmp_path), baseline=[fp_new, "zz|fake|dead", "zz|other|x"])
    assert not result.failed and len(result.suppressed) == 1
    assert result.stale_baseline == ["zz|fake|dead"]
    assert core.DEFAULT_BASELINE == "dotaclient_tpu_torch/lint/baseline.txt"
    assert core.package_py_files()[0].startswith("dotaclient_tpu_torch/")


# -- host-sync -----------------------------------------------------------------


SYNC_SRC = (
    "import numpy as np\n"
    "def hot(m, x):\n"
    "    a = float(m['loss'])\n"
    "    b = float(m['x'])  # host-sync-ok: host int\n"
    "    c = float(m['y'])  # lint-ok: host-sync(host int)\n"
    "    d = np.asarray(x)  # the waiver on the line above covers this one too\n"
    "    e = x.item()\n"
    "    # host-sync-ok: the line above waives\n"
    "    f = np.array(x)\n"
    "    return a, b, c, d, e, f\n"
    "def restore(m):\n"
    "    return float(m)\n"
)


def test_host_sync_flags_the_references_patterns_at_the_same_lines():
    for allowed in (set(), {"restore"}):
        ref = ref_host_sync.scan_source(SYNC_SRC, allowed, "x.py")
        got = host_sync.scan_source(SYNC_SRC, allowed, "x.py")
        assert got == ref and [line for line, _, _ in got] == [3, 7] + ([] if allowed else [12])
        assert host_sync.check_source(SYNC_SRC, allowed, "x.py") == ref_host_sync.check_source(
            SYNC_SRC, allowed, "x.py")


@pytest.mark.parametrize("call, pattern", [
    ("t.cpu()", ".cpu()"), ("t.tolist()", ".tolist()"), ("t.numpy()", ".numpy()"), ("int(t)", "int()"),
    ("bool(t)", "bool()"), ("torch.cuda.synchronize()", "torch.cuda.synchronize()"),
    ("ev.synchronize()", ".synchronize()"), ("t.item()", ".item()"),
])
def test_host_sync_flags_the_torch_spellings(call, pattern):
    src = f"def hot(t, ev):\n    return {call}\n"
    assert host_sync.scan_source(src, set(), "x.py") == [(2, pattern, "hot")]
    assert host_sync.scan_source(src.replace(call, f"{call}  # host-sync-ok: host value"), set(), "x.py") == []
    assert host_sync.scan_source(src.replace(call, f"{call}  # lint-ok: host-sync(host value)"), set(), "x.py") == []
    # the same method with arguments is another call (t.cpu(x) is not a read)
    if call.startswith("t.") and "(" in call:
        assert host_sync.scan_source(src.replace("()", "(1)", 1), set(), "x.py") == []


def test_host_sync_rule_scans_its_module_list_as_the_references_does():
    bad = "def anywhere(m):\n    return float(m)\n"
    ok = "def restore(m):\n    return float(m)\n"
    for ref_rel in ("dotaclient_tpu/train/snapshot.py", "dotaclient_tpu/utils/checkpoint.py"):
        for src in (bad, ok):
            ref = run_in_memory(ref_host_sync.HostSyncRule(), {ref_rel: src}, pkg=ref_core)[0]
            got = run_in_memory(host_sync.HostSyncRule(), {port_path(ref_rel): src})[0]
            assert lines_rules(got) == lines_rules(ref)
    (d, fp), = run_in_memory(host_sync.HostSyncRule(), {"dotaclient_tpu_torch/train/snapshot.py": bad})[0]
    assert "float()" in d.message
    assert run_in_memory(host_sync.HostSyncRule(), {"dotaclient_tpu_torch/train/snapshot.py": bad},
                         baseline=(fp,))[0] == []


def test_host_sync_covers_the_references_thirteen_modules():
    ref = {port_path(p) for p in list(ref_host_sync.ALLOWED_FUNCS) + list(ref_host_sync.SCAN_ONLY_FUNCS)}
    assert set(host_sync.ALLOWED_FUNCS) | set(host_sync.SCAN_ONLY_FUNCS) == ref and len(ref) == 13
    for rel, only in ref_host_sync.SCAN_ONLY_FUNCS.items():
        assert host_sync.SCAN_ONLY_FUNCS[port_path(rel)] == only
    for rel in host_sync.ALLOWED_FUNCS:
        assert os.path.exists(os.path.join(REPO_ROOT, rel)), rel


def test_check_host_sync_cli_is_clean_and_prints_the_references_line(capsys):
    from dotaclient_tpu_torch.utils import check_host_sync

    assert check_host_sync.main([]) == 0
    out = capsys.readouterr().out.strip()
    assert out == "host-sync discipline OK: " + ", ".join(
        sorted(host_sync.ALLOWED_FUNCS) + sorted(host_sync.SCAN_ONLY_FUNCS))


# -- thread-ownership: the race shapes, against both passes --------------------


def race_map(pkg):
    return {"Learner": pkg.ClassMap(
        default_thread="train",
        methods={"_finish_metrics": "engine"},
        attrs={"_pending_best": "lock:_pending_best_lock", "_last_verdict_m": "train",
               "_monitor_state": "lock:_lock"},
        holds={"_fold_locked": ("_lock",)},
    )}


RACES = {
    "pending_best_unlocked": ("class Learner:\n    def _finish_metrics(self, scalars):\n"
                              "        self._pending_best = dict(scalars)\n", 1),
    "pending_best_locked": ("class Learner:\n    def _finish_metrics(self, scalars):\n"
                            "        with self._pending_best_lock:\n            self._pending_best = dict(scalars)\n", 0),
    "last_verdict_cross_thread": ("class Learner:\n    def _finish_metrics(self, scalars):\n"
                                  "        self._last_verdict_m = None\n", 1),
    "fold_outside_lock": "class Learner:\n    def gate(self):\n        return self._monitor_state\n",
    "fold_inside_lock": ("class Learner:\n    def gate(self):\n        with self._lock:\n"
                         "            return self._monitor_state\n    def _fold_locked(self):\n"
                         "        return self._monitor_state\n", 0),
    "closure": ("class Learner:\n    def _make(self):\n        def _finish_metrics(host):\n"
                "            self._last_verdict_m = host\n        return _finish_metrics\n", 1),
    "init_exempt": ("class Learner:\n    def __init__(self):\n        self._pending_best = None\n"
                    "        self._monitor_state = {}\n", 0),
}


@pytest.mark.parametrize("shape", sorted(RACES))
def test_race_shapes_under_a_map_flag_as_the_references(shape):
    src, n = RACES[shape] if isinstance(RACES[shape], tuple) else (RACES[shape], 1)
    ref = ref_ownership.scan_source_with_map("x.py", src, race_map(ref_ownership))
    got = ownership.scan_source_with_map("x.py", src, race_map(ownership))
    assert [(d.line, d.rule, d.message) for d in got] == [(d.line, d.rule, d.message) for d in ref]
    assert len(got) == n


# the shipped maps: the same shape on each package's own names (the
# reference's Learner._finish_metrics is the port's _log_boundary.finish
# closure; lines are kept equal)
SHIPPED_RACES = [
    ("train/learner.py", "class Learner:\n    def _log_boundary(self):\n        def {finish}(host):\n"
     "            self._pending_best = dict(host)\n", 1, "_pending_best_lock"),
    ("train/learner.py", "class Learner:\n    def _log_boundary(self):\n        def {finish}(host):\n"
     "            with self._pending_best_lock:\n                self._pending_best = dict(host)\n", 0, ""),
    ("train/learner.py", "class Learner:\n    def _log_boundary(self):\n        def {finish}(host):\n"
     "            self._last_verdict_m = None\n", 1, "engine thread"),
    ("utils/tracing.py", "class TraceWriter:\n    def enqueue(self, event):\n        self._f.write(str(event))\n",
     1, "producer thread"),
    ("utils/tracing.py", "class TraceWriter:\n    def enqueue(self, event):\n        self._queue.append(event)\n"
     "    def _run(self):\n        self._f.write('x')\n", 0, ""),
    ("utils/fleet.py", "class FleetAggregator:\n    def ingest(self, payload):\n        self._peers['x'] = payload\n"
     "        self._engine.evaluate({})\n", 2, "reader thread"),
    ("utils/fleet.py", "class FleetAggregator:\n    def ingest(self, payload):\n        with self._lock:\n"
     "            self._inbox.append(payload)\n    def tick(self):\n        with self._lock:\n"
     "            batch, self._inbox = self._inbox, []\n        self._peers.clear()\n"
     "        self._engine.evaluate({})\n", 0, ""),
    ("serve/engine.py", "class ServeEngine:\n    def submit(self, req):\n        self._carries[0] = req\n", 1,
     "batcher thread"),
    ("transport/socket_transport.py", "class TransportServer:\n    def _reader_loop(self, conn):\n"
     "        self._rollouts.append(conn)\n", 1, "_roll_cond"),
]


@pytest.mark.parametrize("case", range(len(SHIPPED_RACES)))
def test_race_shapes_against_both_shipped_maps(case):
    rel, src, n, words = SHIPPED_RACES[case]
    ref = ref_ownership.scan_source_with_map(
        "x.py", src.replace("{finish}", "_finish_metrics"), ref_ownership.OWNERSHIP["dotaclient_tpu/" + rel])
    got = ownership.scan_source_with_map(
        "x.py", src.replace("{finish}", "finish"), ownership.OWNERSHIP["dotaclient_tpu_torch/" + rel])
    assert [(d.line, d.rule) for d in got] == [(d.line, d.rule) for d in ref]
    assert len(got) == n and all(words in d.message for d in got)


# the reference's names with no port attribute of their own: the host step
# counter is the port's _steps_done, the model version lives in the train
# state; the fleet's per-peer helpers are one in the port
RENAMED_ATTRS = {"_host_step": "_steps_done", "_host_version": None}
RENAMED_METHODS = {"_finish_metrics": "finish", "_peer_counter": None, "_peer_gauge": None}


def test_shipped_map_mirrors_the_references_class_for_class():
    assert {port_path(p) for p in ref_ownership.OWNERSHIP} == set(ownership.OWNERSHIP)
    for ref_rel, classes in ref_ownership.OWNERSHIP.items():
        port_classes = ownership.OWNERSHIP[port_path(ref_rel)]
        assert set(port_classes) == set(classes)
        for name, rmap in classes.items():
            pmap = port_classes[name]
            assert pmap.default_thread == rmap.default_thread, name
            for attr, spec in rmap.attrs.items():
                attr = RENAMED_ATTRS.get(attr, attr)
                if attr is not None:
                    assert pmap.attrs.get(attr) == spec, (name, attr)
            for method, thread in rmap.methods.items():
                method = RENAMED_METHODS.get(method, method)
                if method is not None:
                    assert pmap.methods.get(method) == thread, (name, method)
            for method, locks in rmap.holds.items():
                assert pmap.holds.get(method) == locks, (name, method)
    # every declared attribute exists in the port's class
    for rel, classes in ownership.OWNERSHIP.items():
        with open(os.path.join(REPO_ROOT, rel)) as f:
            src = f.read()
        for cmap in classes.values():
            for attr in list(cmap.attrs) + [lock[5:] for lock in cmap.attrs.values() if lock.startswith("lock:")]:
                assert f"self.{attr}" in src, (rel, attr)


def test_ownership_waiver():
    src = ("class Learner:\n    def _finish_metrics(self, s):\n"
           "        # lint-ok: thread-ownership(handoff after barrier)\n        self._last_verdict_m = s\n")
    (d,) = ownership.scan_source_with_map("x.py", src, race_map(ownership))
    assert FileCtx("x.py", src).waived(d.line, "thread-ownership")
    rule = ownership.ThreadOwnershipRule()
    bad = "class TraceWriter:\n    def enqueue(self, event):\n        self._f.write(str(event))\n"
    ((_, fp),) = run_in_memory(rule, {"dotaclient_tpu_torch/utils/tracing.py": bad})[0]
    assert run_in_memory(rule, {"dotaclient_tpu_torch/utils/tracing.py": bad}, baseline=(fp,))[0] == []


# -- telemetry-drift ------------------------------------------------------------


EMIT_SRC = (
    "class T:\n"
    "    def go(self):\n"
    "        self._tel.counter('a/one').inc()\n"
    "        with self._tel.span('b/two'):\n"
    "            pass\n"
    "        for key in ('c/three', 'c/four'):\n"
    "            self._tel.gauge(key)\n"
    "        for k in kinds:\n"
    "            self._tel.counter(f'snapshot/{k}_coalesced')\n"
    "    def bad(self, name):\n"
    "        self._tel.counter(f'x/{name}_total')\n"
)


def test_telemetry_extraction_equals_the_references():
    ref = ref_telemetry.extract_emitted({"dotaclient_tpu/x.py": ref_core.FileCtx("dotaclient_tpu/x.py", EMIT_SRC)})
    got = telemetry_drift.extract_emitted({"dotaclient_tpu_torch/x.py": FileCtx("dotaclient_tpu_torch/x.py",
                                                                               EMIT_SRC)})
    assert got[0] == ref[0] == {"a/one", "span/b/two", "c/three", "c/four", "snapshot/publish_coalesced",
                                "snapshot/checkpoint_coalesced", "snapshot/metrics_coalesced"}
    assert sorted(k for k, _, _ in got[1]) == sorted(k for k, _, _ in ref[1])
    assert [(d.line, d.rule) for d in got[2]] == [(d.line, d.rule) for d in ref[2]] == [(11, "telemetry-drift")]
    assert "not statically resolvable" in got[2][0].message


def test_telemetry_extraction_resolves_the_ports_idioms():
    src = ("def go(reg, tel, items):\n"
           "    h = {key: reg.gauge(key) for key in ('u/a', 'u/b')}\n"
           "    for label, name in items:\n"
           "        reg.counter(f'fleet/{label}/{name}').inc()\n"
           "    reg.gauge(f'outcome/ep_len_hist/{3:02d}')\n")
    keys, _, problems = telemetry_drift.extract_emitted({"dotaclient_tpu_torch/x.py": FileCtx(
        "dotaclient_tpu_torch/x.py", src)})
    assert problems == []
    assert {"u/a", "u/b", "fleet/a0/actor/env_steps"} <= keys
    assert {f"outcome/ep_len_hist/{i:02d}" for i in range(12)} <= keys


def test_telemetry_doc_keys_and_drift_directions_equal_the_references():
    doc = ("Keys: `transport/queue_depth`, the set `buffer/dropped_{overflow,stale}`, spans `actor/collect`, "
           "wildcards `league/eval_*` and `snapshot/<kind>_coalesced`; not keys: `envs/lane_sim.py`, "
           "`obs/hero_id`, `deploy/`. `transport/ghost`\n")
    assert telemetry_drift.extract_doc_keys(doc)[0] == ref_telemetry.extract_doc_keys(doc)[0]
    emitted = {"transport/queue_depth", "span/actor/collect", "x/rogue", "buffer/dropped_stale",
               "buffer/dropped_overflow"}
    sites = [(k, 1, "pkg/x.py") for k in sorted(emitted)]
    tiers = {"FAKE_KEYS": ["transport/queue_depth", "buffer/never"],
             "REQUIRED_KEYS": ["span/actor/collect/mean_s"]}
    ref = ref_telemetry.drift_findings(emitted, sites, doc, tiers)
    got = telemetry_drift.drift_findings(emitted, sites, doc, tiers)
    assert sorted((d.line, d.rule, d.context) for d in got) == sorted((d.line, d.rule, d.context) for d in ref)
    assert {d.context for d in got} == {"buffer/never", "transport/ghost", "x/rogue"}


def test_telemetry_port_doc_documents_and_excepts():
    doc = "`transport/queue_depth` `transport/old`\n"
    port_doc = ("`transport/port_only`\n\n## Reference telemetry keys the port does not emit\n\n| key | why |\n|---|---|\n"
                "| `transport/old` | the port has no such stage |\n| `transport/gone` | stale row |\n")
    emitted = {"transport/queue_depth", "transport/port_only"}
    sites = [(k, 1, "pkg/x.py") for k in sorted(emitted)]
    plain = telemetry_drift.drift_findings(emitted, sites, doc, {})
    assert {d.context for d in plain} == {"transport/old", "transport/port_only"}
    got = telemetry_drift.drift_findings(emitted, sites, doc, {}, port_doc_text=port_doc)
    assert [(d.context, "stale exception" in d.message) for d in got] == [("transport/gone", True)]


def test_undocumenting_keys_fails_the_real_pass():
    rule = telemetry_drift.TelemetryDriftRule()
    files = real_files(rule)
    assert rule.check(files) == []
    doc = files[telemetry_drift.ARCHITECTURE_MD]
    files[telemetry_drift.ARCHITECTURE_MD] = FileCtx(
        telemetry_drift.ARCHITECTURE_MD, "\n".join(ln for ln in doc.source.splitlines() if "transport/rollout_" not in ln))
    flagged = {d.context for d in rule.check(files)}
    assert {"transport/rollout_bytes_total", "transport/rollout_raw_bytes_total",
            "transport/rollout_compression_ratio"} <= flagged


def test_learner_utilization_keys_spell_out_the_phases():
    from dotaclient_tpu_torch.utils import telemetry, utilization

    keys = set(utilization.ensure_learner_keys(telemetry.Registry()))
    assert {f"util/phase/{p}" for p in utilization.LEARNER_PHASES} <= keys


# -- config-drift ------------------------------------------------------------------


CFG_SRC = ("import dataclasses\n@dataclasses.dataclass(frozen=True)\nclass BufferConfig:\n"
           "    capacity: int = 4\n    min_fill: int = 2\n")
CLI_SRC = ("def main():\n    import argparse\n    p = argparse.ArgumentParser()\n"
           "    p.add_argument('--steps', type=int)\n    p.add_argument('--buffer', type=str)\n")
TABLE = ("### `--buffer` (BufferConfig)\n\n| knob | default | what |\n|---|---|---|\n"
         "| `capacity` | 4 | slots |\n")
CONFIG_DOCS = {
    "complete": "`--steps` `--buffer`\n" + TABLE + "| `min_fill` | 2 | gate |\n",
    "missing_and_stale_rows": "`--steps` `--buffer`\n" + TABLE + "| `renamed_away` | 0 | gone |\n",
    "undefined_flag": "`--steps` `--buffer` `--does-not-exist`\n" + TABLE + "| `min_fill` | 2 | gate |\n",
    "undocumented_cli_flag": "`--buffer`\n" + TABLE + "| `min_fill` | 2 | gate |\n",
    "table_closed_by_heading": "`--steps` `--buffer`\n" + TABLE + "\n## Later\n\n| `min_fill` | 1 |\n",
}


@pytest.mark.parametrize("case", sorted(CONFIG_DOCS))
def test_config_drift_equals_the_references(case):
    doc = CONFIG_DOCS[case]
    results = []
    for mod, learner in ((ref_config, "dotaclient_tpu/train/learner.py"),
                         (config_drift, "dotaclient_tpu_torch/train/learner.py")):
        assert mod.cli_flags(CLI_SRC) == {"--steps", "--buffer"}
        assert mod.documented_flags(doc) == ref_config.documented_flags(doc)
        assert mod.knob_tables(doc) == ref_config.knob_tables(doc)
        found = mod.drift_findings(mod.dataclass_fields(CFG_SRC), {learner: mod.cli_flags(CLI_SRC)}, doc)
        results.append(sorted((d.line, d.rule, d.context) for d in found if d.context.split(".")[0] == "--buffer"
                              or d.context in ("--steps", "--does-not-exist")))
    assert results[0] == results[1]
    assert bool(results[1]) == (case != "complete")


def test_config_cli_flags_resolve_flags_added_in_a_loop():
    src = ("OPTS = (('--a', 1), ('--b', 2))\n"
           "def main(p):\n"
           "    for flag, cls, example in (('--ppo', 'P', 'x'), ('--reward', 'R', 'y')):\n"
           "        p.add_argument(flag, type=str, help=example)\n"
           "    for flag, n in OPTS:\n"
           "        p.add_argument(flag, type=int)\n"
           "    for flag in ('--c', '--d'):\n"
           "        p.add_argument(flag)\n"
           "    for name in names:\n"
           "        p.add_argument(name)\n")
    assert config_drift.cli_flags(src) == {"--ppo", "--reward", "--a", "--b", "--c", "--d"}
    assert ref_config.cli_flags(src) == set()   # the reference reads literals only
    # the learner's seven override flags, added in such a loop, are all seen
    with open(os.path.join(REPO_ROOT, "dotaclient_tpu_torch/train/learner.py")) as f:
        flags = config_drift.cli_flags(f.read())
    assert {"--ppo", "--reward", "--league", "--buffer", "--health", "--learner", "--serve", "--mesh", "--device",
            "--checkify", "--compile-cache"} <= flags


def test_config_port_doc_exceptions_and_port_flags():
    doc = ("`--steps` `--buffer` `--gate` " + " ".join(f"`{f}`" for f in config_drift.OVERRIDE_FLAGS) + "\n"
           + TABLE + "| `min_fill` | 2 | gate |\n")
    learner = "dotaclient_tpu_torch/train/learner.py"
    flags = {learner: {"--steps", "--buffer", "--device", *config_drift.OVERRIDE_FLAGS}}
    fields = config_drift.dataclass_fields(CFG_SRC)
    plain = {d.context for d in config_drift.drift_findings(fields, flags, doc)}
    assert plain == {"--gate", "--device"}
    port_doc = ("`--device` picks the card\n\n## Reference flags the port does not define\n\n| flag | why |\n"
                "|---|---|\n| `--gate` | waits for the benchmark |\n| `--steps` | stale: defined |\n")
    got = config_drift.drift_findings(fields, flags, doc, port_doc_text=port_doc)
    assert [(d.context, "stale exception" in d.message) for d in got] == [("--steps", True)]


# -- alert-drift ---------------------------------------------------------------------


def test_alert_drift_flags_a_deleted_runbook_row_as_the_reference():
    from dotaclient_tpu.lint import alert_drift as ref_alert

    results = []
    for mod, pkg_core in ((ref_alert, ref_core), (alert_drift, core)):
        rule = mod.AlertDriftRule()
        files = {}
        for rel in rule.paths():
            path = os.path.join(REPO_ROOT, rel)
            if os.path.exists(path):
                with open(path) as f:
                    files[rel] = pkg_core.FileCtx(rel, f.read())
        assert rule.check(files) == []
        rules, _ = mod.extract_rules(files[mod.ALERTS_PY].tree)
        anchor = rules[0]["runbook"]
        doc = files[mod.OPERATIONS_MD]
        files[mod.OPERATIONS_MD] = pkg_core.FileCtx(
            mod.OPERATIONS_MD, "\n".join(ln for ln in doc.source.splitlines() if f"`{anchor}`" not in ln))
        results.append((anchor, sorted((d.rule, d.context) for d in rule.check(files))))
    assert results[0] == results[1] and results[1][1]
    # a rule over a key no port code emits can never fire
    got = alert_drift.rule_key_findings([{"name": "r", "runbook": "rb:x", "key": "ghost/key", "line": 3}], set())
    assert [(d.line, d.context) for d in got] == [(3, "ghost/key")]


# -- the whole lint: the acceptance criterion ------------------------------------


def test_lint_strict_is_clean_on_the_port_and_lists_every_pass(capsys):
    from dotaclient_tpu_torch.lint.__main__ import main

    assert main(["--strict"]) == 0
    out = capsys.readouterr().out
    assert "graftlint OK: 5 passes clean" in out
    assert [cls.id for cls in ALL_RULES] == ["host-sync", "thread-ownership", "telemetry-drift", "config-drift",
                                             "alert-drift"]
    from dotaclient_tpu.lint import ALL_RULES as REF_RULES

    # the reference's order, less the pass with no counterpart
    assert [c.id for c in REF_RULES if c.id != "use-after-donate"] == [c.id for c in ALL_RULES]
    assert main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    assert all(cls.id in listed for cls in ALL_RULES)
    assert main(["--rule", "host-sync"]) == 0
    assert "[rules: host-sync]" in capsys.readouterr().out


def test_baseline_is_empty_and_loadable():
    path = os.path.join(REPO_ROOT, core.DEFAULT_BASELINE)
    assert os.path.exists(path) and load_baseline(path) == []


def test_partial_update_baseline_keeps_other_rules_entries(tmp_path, capsys, monkeypatch):
    """``--rule X --update-baseline`` rewrites X's entries alone: another
    rule's block, its tracking comment included, survives."""
    from dotaclient_tpu_torch.lint import __main__ as cli

    path = str(tmp_path / "baseline.txt")
    core.write_baseline(path, [("a.py|kept-rule|aaaaaaaaaaaa", Diagnostic("a.py", 1, "kept-rule", "kept finding")),
                               ("b.py|host-sync|bbbbbbbbbbbb", Diagnostic("b.py", 2, "host-sync", "regenerated"))])
    assert cli.main(["--rule", "host-sync", "--update-baseline", "--baseline", path]) == 0
    assert "1 entry of non-run rules preserved" in capsys.readouterr().out
    blocks = core.load_baseline_blocks(path)
    assert [fp for _c, fp in blocks] == ["a.py|kept-rule|aaaaaaaaaaaa"]
    assert any("kept finding" in c for c in blocks[0][0])
