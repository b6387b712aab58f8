"""The health guardian's detector, the fault registry and the in-process
transport against the JAX package's.

One verdict stream (a warm-up, an explosion past the band, a NaN, a clear,
stale verdicts of the abandoned timeline) goes through both
``HealthMonitor``s: they must latch the same ``HealthEvent``s and count the
same telemetry. The fault registries parse the same specs and fire on the
same events; the in-process transports drop and replace the same messages.
All host-side: exact equality.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from dotaclient_tpu import config as jconfig
from dotaclient_tpu.train import health as jhealth
from dotaclient_tpu.transport.queues import InProcTransport as JaxInProcTransport
from dotaclient_tpu.utils import faults as jfaults
from dotaclient_tpu.utils import telemetry as jtel
from dotaclient_tpu_torch import config as pconfig
from dotaclient_tpu_torch.protos import dota_pb2 as ppb
from dotaclient_tpu_torch.train import health as phealth
from dotaclient_tpu_torch.transport.queues import InProcTransport
from dotaclient_tpu_torch.utils import faults as pfaults
from dotaclient_tpu_torch.utils import telemetry as ptel

HEALTH_KEYS = ("health/nonfinite_steps_total", "health/ema_breaches_total", "health/rollbacks_total",
               "health/publish_blocked_total", "health/checkpoints_blocked_total", "health/last_good_step",
               "buffer/stale_rejected_total")


def verdict_stream(seed, n=40):
    """(step, loss, grad_norm, health_ok) a step: grad norms near 1 with a
    spike at 5 (inside the warm-up of 10 healthy folds: no latch, but the
    EMA takes it in), an explosion at 25, a NaN loss at 33 and a
    non-finite gradient at 38."""
    rng = np.random.default_rng(seed)
    out = []
    for step in range(1, n + 1):
        loss, gn, ok = float(rng.normal()), float(abs(rng.normal()) * 0.2 + 1.0), 1.0
        if step == 5:
            gn = 500.0
        if step == 25:
            gn = 5000.0
        if step == 33:
            loss, ok = float("nan"), 0.0
        if step == 38:
            gn, ok = float("inf"), 0.0
        out.append((step, loss, gn, ok))
    return out


def monitors(**over):
    jcfg = dataclasses.replace(jconfig.HealthConfig(), warmup_steps=10, explosion_band=100.0, **over)
    pcfg = dataclasses.replace(pconfig.HealthConfig(), warmup_steps=10, explosion_band=100.0, **over)
    jreg, preg = jtel.Registry(), ptel.Registry()
    return (jhealth.HealthMonitor(jcfg, registry=jreg), jreg), (phealth.HealthMonitor(pcfg, registry=preg), preg)


def event_tuple(ev):
    return None if ev is None else (ev.step, ev.version, ev.reason, ev.value)


def same(a, b):
    if a is None or b is None:
        return a is b
    return a[:3] == b[:3] and (a[3] == b[3] or (math.isnan(a[3]) and math.isnan(b[3])))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("path", ["batch", "host"])
def test_monitors_latch_the_same_events(seed, path):
    """Fed through ``submit`` and one ``fold_batch`` a boundary (the
    engine's path, with tensors on the port's side), or through
    ``fold_host`` (the sync path); after each latch both are cleared."""
    (jm, jreg), (pm, preg) = monitors()
    events = {"jax": [], "port": []}
    stream = verdict_stream(seed)
    for i in range(0, len(stream), 4):
        window = stream[i:i + 4]
        for step, loss, gn, ok in window:
            jv = {"loss": np.float32(loss), "grad_norm": np.float32(gn), "health_ok": np.float32(ok)}
            pv = {k: torch.tensor(float(v)) for k, v in jv.items()}
            if path == "batch":
                jm.submit(step, step, jv)
                pm.submit(step, step, pv)
            else:
                jm.fold_host(step, step, jv)
                pm.fold_host(step, step, pv)
        if path == "batch":
            jm.fold_batch(jm.take_pending())
            pm.fold_batch([(g, s, v, {k: t.cpu() for k, t in tree.items()}) for g, s, v, tree in pm.take_pending()])
        for name, mon in (("jax", jm), ("port", pm)):
            ev = event_tuple(mon.unhealthy)
            if ev is not None:
                events[name].append(ev)
                mon.clear()
    assert len(events["port"]) == len(events["jax"]) == 3
    assert all(same(a, b) for a, b in zip(events["port"], events["jax"]))
    assert [e[2] for e in events["port"]] == ["explosion", "nonfinite", "nonfinite"]
    jsnap, psnap = jreg.snapshot(), preg.snapshot()
    for key in HEALTH_KEYS:
        assert psnap[key] == jsnap[key], key


def test_clear_drops_the_abandoned_timeline():
    (jm, _), (pm, _) = monitors()
    for mon, tensor in ((jm, np.float32), (pm, lambda v: torch.tensor(v))):
        mon.submit(5, 5, {"loss": tensor(float("nan")), "grad_norm": tensor(1.0), "health_ok": tensor(0.0)})
        stale = mon.take_pending()
        mon.clear()
        mon.fold_batch(stale)   # folded after the rollback: a no-op
        assert mon.unhealthy is None
        assert mon.note_unrecoverable() and not mon.note_unrecoverable()
    assert phealth.VERDICT_KEYS == jhealth.VERDICT_KEYS
    assert phealth._PENDING_CAP == jhealth._PENDING_CAP


# -- the fault registry -----------------------------------------------------------


@pytest.mark.parametrize("spec", ["learner.nan_grad@3", "checkpoint.fail_write@2+3",
                                  "learner.fail_train_step@1,checkpoint.corrupt_manifest@4",
                                  "transport.delay_send=0.01"])
def test_fault_registry_fires_as_the_reference(spec):
    j, p = jfaults.FaultRegistry(spec), pfaults.FaultRegistry(spec)
    for site in ("learner.nan_grad", "checkpoint.fail_write", "learner.fail_train_step",
                 "checkpoint.corrupt_manifest", "transport.delay_send"):
        assert [p.fire(site) for _ in range(12)] == [j.fire(site) for _ in range(12)], site
        assert p.fired(site) == j.fired(site) and p.value(site, -1.0) == j.value(site, -1.0)


@pytest.mark.parametrize("bad", ["site", "site@0", "site@x", "site=abc"])
def test_fault_spec_errors_as_the_reference(bad):
    with pytest.raises(jfaults.FaultSpecError):
        jfaults.FaultRegistry(bad)
    with pytest.raises(pfaults.FaultSpecError):
        pfaults.FaultRegistry(bad)


def test_configure_installs_and_clears():
    try:
        reg = pfaults.configure("learner.nan_grad@1")
        assert pfaults.get() is reg and reg.fire("learner.nan_grad")
    finally:
        pfaults.configure(None)
    assert pfaults.get() is None


# -- the in-process transport ------------------------------------------------------


def test_inproc_transport_as_the_reference():
    from dotaclient_tpu.protos import dota_pb2 as jpb

    j, p = JaxInProcTransport(max_rollouts=3, registry=jtel.Registry()), InProcTransport(
        max_rollouts=3, registry=ptel.Registry())
    for t, pb in ((j, jpb), (p, ppb)):
        assert t.latest_weights() is None
        for i in range(5):
            t.publish_rollout(pb.Rollout(model_version=i))
        for v in (1, 4, 2):
            t.publish_weights(pb.ModelWeights(version=v))
    assert p.dropped == j.dropped == 2 and p.pending_rollouts == j.pending_rollouts == 3
    got = [r.model_version for r in p.consume_rollouts(10, timeout=0.01)]
    assert got == [r.model_version for r in j.consume_rollouts(10, timeout=0.01)] == [2, 3, 4]
    assert p.latest_weights().version == j.latest_weights().version == 2   # replacement, not max
    assert p.consume_rollouts(1, timeout=0.01) == [] == j.consume_rollouts(1, timeout=0.01)
