"""The port's schema CLI, multi-GPU preflight and gate against the JAX
package's (``scripts/check_telemetry_schema.py``, ``scripts/run_multichip.py``,
``scripts/ci_gate.sh``).

The five tiers the port's ``utils/schema.py`` gained equal the script's key
for key, and the port's CLI gives the script's verdict and lines on the
same records. The preflight classifies each CUDA failure signature into a
SKIP line with a remediation, a hung init included, and never prints a
traceback; on this machine (no card) the real preflight is such a SKIP.
``--force-host 2`` and ``--fused-parity 2`` run on gloo CPU processes at a
tiny model and print ``"ok": true``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

import pytest

from dotaclient_tpu_torch.utils import check_telemetry_schema as cli
from dotaclient_tpu_torch.utils import run_multichip as mc
from dotaclient_tpu_torch.utils import schema

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"unit_embed_dim": 8, "hidden_dim": 8, "hero_embed_dim": 4}


def load_script(name):
    spec = importlib.util.spec_from_file_location(f"ref_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF_SCHEMA = load_script("check_telemetry_schema")
REF_MC = load_script("run_multichip")


@pytest.mark.parametrize("tier", ["SOCKET_TRANSPORT_KEYS", "SHM_TRANSPORT_KEYS", "FAULT_KEYS", "SERVE_KEYS",
                                  "ROUTER_KEYS"])
def test_new_tiers_equal_the_scripts(tier):
    assert getattr(schema, tier) == getattr(REF_SCHEMA, tier)


def record(keys, drop=()):
    scalars = {k: 1.0 for k in keys if k not in drop}
    return json.dumps({"ts": 1.0, "step": 0, "scalars": scalars})


def full_learner_keys():
    keys = set(schema.REQUIRED_KEYS)
    for root in {k.rsplit("/", 1)[0] for k in schema.REQUIRED_KEYS if k.startswith("span/")}:
        keys |= {f"{root}/{leaf}" for leaf in schema.TIMER_LEAVES}
    return keys


@pytest.mark.parametrize("flags, keys, drop", [
    (["--require-router"], schema.ROUTER_KEYS, ()),
    (["--require-router"], schema.ROUTER_KEYS, ("router/backends_dead",)),
    (["--require-serve"], schema.SERVE_KEYS, ()),
    (["--require-transport", "--require-faults", "--require-wire"],
     (*schema.SOCKET_TRANSPORT_KEYS, *schema.FAULT_KEYS, *schema.WIRE_KEYS), ("transport/heartbeats_sent",)),
    (["--require-shm"], schema.SHM_TRANSPORT_KEYS, ()),
    (["--require-snapshot", "--require-multichip"], (*schema.SNAPSHOT_KEYS, *schema.MULTICHIP_KEYS), ()),
])
def test_schema_cli_gives_the_scripts_verdict_and_lines(tmp_path, capsys, flags, keys, drop):
    """The same record, the same flags: the same exit code and the same
    output lines from the port's CLI as from the script."""
    base = set(keys) if flags[0] in ("--require-router", "--require-serve") else full_learner_keys() | set(keys)
    path = tmp_path / "r.jsonl"
    path.write_text(record(base, drop) + "\n" + json.dumps({"event": "ALERT", "rule": "x"}) + "\n")
    outs = []
    for main in (REF_SCHEMA.main, cli.main):
        rc = main(["--path", str(path), *flags])
        outs.append((rc, capsys.readouterr()))
    (rc_ref, ref), (rc_port, port) = outs
    assert (rc_port, port.out, port.err) == (rc_ref, ref.out, ref.err)
    assert rc_port == (1 if drop else 0)


def test_schema_cli_smoke_run_on_the_cpu(capsys):
    """With no --path it runs the port learner's --smoke --steps 2 (here on
    the CPU) into a temporary JSONL and validates every learner tier."""
    rc = cli.main(["--device", "cpu", "--require-snapshot", "--require-health", "--require-trace",
                   "--require-fleet", "--require-outcome", "--require-advantage", "--require-multichip",
                   "--require-utilization"])
    assert rc == 0
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("telemetry schema OK:")


CUDA_FAILURES = {
    "old_driver": "RuntimeError: The NVIDIA driver on your system is too old. CUDA driver version is insufficient "
                  "for CUDA runtime version",
    "no_driver": "RuntimeError: Found no NVIDIA driver on your system. Please check that you have an NVIDIA GPU",
    "no_device": "RuntimeError: CUDA error: no CUDA-capable device is detected",
    "cpu_torch": "AssertionError: Torch not compiled with CUDA enabled",
    "busy": "RuntimeError: CUDA error: CUDA-capable device(s) is/are busy or unavailable",
    "oom": "torch.OutOfMemoryError: CUDA out of memory. Tried to allocate 2.00 GiB",
    "nccl": "torch.distributed.DistBackendError: NCCL error in: ProcessGroupNCCL.cpp:1970, unhandled cuda error",
    "hang": "MULTICHIP_PREFLIGHT_TIMEOUT after 300s\n",
}


@pytest.mark.parametrize("case", sorted(CUDA_FAILURES))
def test_each_cuda_failure_signature_classifies_with_a_remediation(case):
    got = mc.classify_backend_error("Traceback (most recent call last):\n  ...\n" + CUDA_FAILURES[case])
    assert got is not None, case
    reason, remediation = got
    assert reason and "--force-host N" in remediation
    if case == "hang":
        assert "timeout" in reason
    # the reference's signatures are TPU ones: it classifies none of these
    # but the hang, whose marker both share
    assert (REF_MC.classify_backend_error(CUDA_FAILURES[case]) is not None) == (case == "hang")


def test_unknown_breakage_stays_unclassified():
    assert mc.classify_backend_error("ValueError: nope") is None
    assert REF_MC.classify_backend_error("ValueError: nope") is None


AFTER_JOIN = ("Traceback (most recent call last):\n  ...\ntorch.distributed.DistBackendError: NCCL error in: "
              "ProcessGroupNCCL.cpp:3010, invalid usage (run with NCCL_DEBUG=WARN for details)\n"
              "torch.OutOfMemoryError: CUDA out of memory. Tried to allocate 2.00 GiB")


@pytest.mark.parametrize("joined", [False, True])
@pytest.mark.parametrize("job", ["dryrun", "fused_parity"])
def test_only_a_failed_init_is_a_skip(job, joined, capsys, monkeypatch):
    """The same NCCL and out-of-memory text is a SKIP (exit 0) when a rank
    printed it before joining its world, and a failure (exit 1, its tail,
    ``skipped`` false) when the rank had joined: a fault of the path the
    preflight validates is never hidden as a broken environment."""
    outs = [mc.JOINED + "\n", (mc.JOINED + "\n" if joined else "") + AFTER_JOIN]
    monkeypatch.setattr(mc, "_run_world", lambda *a, **k: mc._world([0, 1], outs, False, 900.0))
    rc = mc.preflight(None, 2, model=TINY) if job == "dryrun" else mc.fused_parity(2, device="cpu", model=TINY)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert not line["ok"] and line["skipped"] == (not joined) and rc == (1 if joined else 0)
    if joined:
        assert "invalid usage" in line["tail"] and "reason" not in line
    else:
        assert (line["reason"], line["remediation"]) == mc.classify_backend_error(AFTER_JOIN)


def test_a_timeout_is_a_skip_only_while_a_rank_is_in_its_init():
    joined = [mc.JOINED + "\n", mc.JOINED + "\n"]
    assert mc._world([0, 0], joined, True, 9.0)[3] == ""
    rc, text, results, init = mc._world([0, 0], [joined[0], "loading\n"], True, 9.0)
    assert rc == -1 and results == [None, None] and "MULTICHIP_PREFLIGHT_TIMEOUT" in text
    assert init.startswith("MULTICHIP_PREFLIGHT_TIMEOUT after 9s") and "[rank 1] loading" in init
    assert "[rank 0]" not in init and mc.classify_backend_error(init)[0].startswith("the card's init")


def test_a_real_rank_failing_after_it_joined_is_not_a_skip(capsys):
    """A rank that joined its gloo world and then failed with a message
    that holds an init needle (a model override named after it) exits 1
    with its tail: the rank printed the join marker before its job."""
    assert mc.preflight(None, 1, model={"NCCL error in: x": 1}) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert not line["ok"] and not line["skipped"] and line["rc"] == 1
    assert "unexpected keyword argument 'NCCL error in: x'" in line["tail"]


def test_a_hung_init_becomes_the_skip_marker_not_a_traceback(capsys, monkeypatch):
    rc, out = mc._run_subprocess("import time; time.sleep(60)", timeout=1.0)
    assert rc == -1 and "MULTICHIP_PREFLIGHT_TIMEOUT" in out
    # the preflight turns it (and any classified init failure) into a
    # SKIP line with its remediation, exit 0
    monkeypatch.setattr(mc, "_backend_init_subprocess", lambda: (rc, out))
    assert mc.preflight(None, None) == 0
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert line["skipped"] and not line["ok"] and "timeout" in line["reason"]
    assert {"n_devices", "mode", "rc", "ok", "skipped", "reason", "remediation"} <= set(line)
    assert "MULTICHIP SKIP:" in captured.err and "Traceback" not in captured.err + captured.out


def test_preflight_on_this_machine_is_a_skip():
    """No card here: the real, unpinned init fails and the CLI prints a
    SKIP line with a remediation, exit 0, no traceback."""
    out = subprocess.run([sys.executable, "-m", "dotaclient_tpu_torch.utils.run_multichip"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300, env={**os.environ, "PYTHONPATH": ROOT})
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert out.returncode == 0 and line["skipped"] and line["mode"] == "accelerator", out.stderr[-2000:]
    assert "--force-host N" in line["remediation"] and "Traceback" not in out.stdout + out.stderr


def test_force_host_2_dry_run_on_gloo_cpu_processes(capsys):
    assert mc.preflight(None, 2, model=TINY) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["ok"] and not line["skipped"] and line["mode"] == "forced-host" and line["n_devices"] == 2
    assert line["rc"] == 0 and "params equal on every rank" in line["tail"]


def test_fused_parity_2_on_gloo_cpu_processes(capsys):
    assert mc.fused_parity(2, device="cpu", model=TINY) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["ok"] and line["lane_sharded"] and line["devices"] == [1, 2]
    assert line["parity"]["losses_ok"] and line["parity"]["param_l1_ok"]
    assert line["lanes"] == {"global": 4, "per_rank": [2, 2]}


@pytest.mark.parametrize("flag", ["--probe", "--fused"])
def test_measurements_are_refused_naming_the_roadmap(flag, capsys):
    with pytest.raises(SystemExit) as e:
        mc.main([flag])
    assert e.value.code == 2 and "ROADMAP" in capsys.readouterr().err


def test_ci_gate_script_parses_and_has_the_references_stages():
    path = os.path.join(ROOT, "dotaclient_tpu_torch", "utils", "ci_gate.sh")
    assert subprocess.run(["bash", "-n", path], capture_output=True).returncode == 0
    with open(path) as f:
        port = f.read()
    with open(os.path.join(ROOT, "scripts", "ci_gate.sh")) as f:
        ref = f.read()
    stages = {"tests", "lint", "schema", "schema_smoke", "fused_parity", "router_failover"}
    for stage in stages:
        assert f"report {stage}" in ref and f"report {stage}" in port, stage
    assert "report bench_gate" in ref and "bench_gate" not in port.replace("bench_gate stage", "")
    # a skipped parity fails the stage
    assert """grep -q '"skipped": true'""" in port and "PARITY_RC=1" in port
