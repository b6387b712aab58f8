"""The actor pools' utilization plane and the ops tables, against the JAX
package's.

* A port ``VecActorPool``'s and a scalar ``ActorPool``'s registries carry
  the JAX pools' ``util/actor/*`` key set, and their folds split the wall
  clock into fractions that sum to 1.
* Fleet snapshots carry those keys across, as ``fleet/<peer>/util/actor/*``:
  a port pool's snapshot into the JAX package's ``FleetAggregator``, the
  JAX codec's encoding of it into the port's; and a port learner's
  aggregator shows a port actor's over the socket lane.
* The actor CLI's ``--fleet-interval`` sets its pool's fold cadence, where
  the reference's stays at 5 s: a deliberate difference, pinned.
* ``ALERT_WAIVERS`` equals the reference's.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dotaclient_tpu.actor.runtime import ActorPool as JaxActorPool
from dotaclient_tpu.actor.vec_runtime import VecActorPool as JaxVecActorPool
from dotaclient_tpu.utils import alerts as jalerts
from dotaclient_tpu.utils import fleet as jfleet
from dotaclient_tpu.utils import telemetry as jtel
from dotaclient_tpu.utils import utilization as jutil
from dotaclient_tpu_torch.actor import ActorPool
from dotaclient_tpu_torch.actor.vec_runtime import VecActorPool
from dotaclient_tpu_torch.train import learner as plearner
from dotaclient_tpu_torch.transport.socket_transport import SocketTransport, TransportServer
from dotaclient_tpu_torch.utils import alerts, fleet, telemetry, utilization
from tests.test_torch_common import flax_params, jax_policy, port_policy
from tests.test_torch_external import vec_config
from tests.test_torch_scalar import pool_configs as scalar_pool_configs
from tests.test_torch_vec_actor import pool_configs as vec_pool_configs

WAIT_S = 30.0
PHASES = ("env_step", "featurize", "encode", "ship_wait", "other")


def util_keys(snapshot):
    return {k for k in snapshot if k.startswith("util/actor/")}


def make_pools(kind, seed=3):
    """(JAX pool, port pool, the port pool's registry) of one kind on the
    same config and params."""
    jcfg, pcfg = (vec_pool_configs if kind == "vec" else scalar_pool_configs)("selfplay")
    params = flax_params(jcfg, seed=seed)
    jcls, pcls = (JaxVecActorPool, VecActorPool) if kind == "vec" else (JaxActorPool, ActorPool)
    jpool = jcls(jcfg, jax_policy(jcfg)[0], jax.tree.map(jnp.asarray, params), seed=seed,
                 rollout_sink=[].extend if kind == "vec" else [].append)
    policy = port_policy(pcfg, params)
    reg = telemetry.Registry()
    ppool = pcls(pcfg, policy, dict(policy.state_dict()), seed=seed, rollout_sink=[].extend if kind == "vec"
                 else [].append, device="cpu", registry=reg)
    return jpool, ppool, reg


def run_until_folded(pool, reg, steps=2):
    """Drive ``pool`` until its accountant has folded (the gauges sum to 1)."""
    deadline = time.time() + WAIT_S
    while time.time() < deadline:
        pool.run(steps, refresh_every=1)
        fractions = [reg.snapshot()[f"util/actor/{p}"] for p in PHASES]
        if sum(fractions) > 0.5:
            return fractions
        time.sleep(0.05)
    raise AssertionError("the pool's utilization plane never folded")


@pytest.mark.parametrize("kind", ["vec", "scalar"])
def test_pool_util_keys_match_jax_and_fold_to_one(kind, monkeypatch):
    monkeypatch.setattr(telemetry, "fleet_interval_s", 0.0)   # the fold's floor: every 0.25 s
    jpool, ppool, reg = make_pools(kind)
    assert util_keys(reg.snapshot()) == util_keys(jtel.get_registry().snapshot()) == {
        f"util/actor/{p}" for p in jutil.ACTOR_PHASES}
    assert utilization.ACTOR_PHASES == jutil.ACTOR_PHASES
    fractions = run_until_folded(ppool, reg)
    assert all(0.0 <= f <= 1.0 for f in fractions) and sum(fractions) == pytest.approx(1.0, abs=1e-9)
    # every step's sim and featurize were claimed (a window may close
    # before a chunk ships: encode and ship_wait can read 0)
    assert fractions[0] > 0.0 and fractions[1] > 0.0


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_util_keys_cross_in_fleet_snapshots(direction, monkeypatch):
    monkeypatch.setattr(telemetry, "fleet_interval_s", 0.0)
    _, ppool, reg = make_pools("vec", seed=4)
    run_until_folded(ppool, reg)
    counters, gauges = reg.counters_and_gauges()
    if direction == "port_to_jax":
        payload = fleet.encode_snapshot(7, "actor", 0, counters, gauges, pid=1234)
        out = jtel.Registry()
        agg = jfleet.FleetAggregator(registry=out, interval_s=1.0)
    else:
        payload = jfleet.encode_snapshot(7, "actor", 0, counters, gauges, pid=1234)
        out = telemetry.Registry()
        agg = fleet.FleetAggregator(registry=out, interval_s=1.0)
    assert agg.ingest(payload)
    agg.tick()
    snap = out.snapshot()
    for p in PHASES:
        assert snap[f"fleet/a7/util/actor/{p}"] == gauges[f"util/actor/{p}"]
    assert snap["fleet/peers"] == 1.0 and snap["fleet/agg/ship_wait/max"] == gauges["util/actor/ship_wait"]


def test_port_learner_aggregator_shows_a_port_actors_util_keys(monkeypatch):
    """An external-mode port learner over a ``TransportServer`` and a port
    vec pool shipping fleet snapshots over a ``SocketTransport``: the
    learner's record carries ``fleet/a<seed>/util/actor/*``, folded."""
    monkeypatch.setattr(telemetry, "fleet_interval_s", 0.0)
    server = TransportServer("127.0.0.1", 0)
    lreg = telemetry.Registry()
    learner = plearner.Learner(vec_config(), actor="external", device="cpu", registry=lreg, transport=server)
    transport = None
    try:
        transport = SocketTransport(*server.address)
        areg = telemetry.Registry()
        fleet.configure(peer_id=9, kind="actor", interval_s=0.05, registry=areg)
        try:
            pool = VecActorPool(vec_config(), learner.policy, learner._actor_params_copy(), transport=transport,
                                seed=9, device="cpu", registry=areg)
            deadline = time.time() + WAIT_S
            while time.time() < deadline:
                pool.run(4, refresh_every=1)
                learner.fleet.tick()
                snap = lreg.snapshot()
                if sum(snap.get(f"fleet/a9/util/actor/{p}", 0.0) for p in PHASES) > 0.5:
                    break
                time.sleep(0.05)
        finally:
            fleet.shutdown()
        snap = lreg.snapshot()
        fractions = [snap[f"fleet/a9/util/actor/{p}"] for p in PHASES]
        assert sum(fractions) == pytest.approx(1.0, abs=1e-9) and all(0.0 <= f <= 1.0 for f in fractions)
        assert snap["fleet/peers"] == 1.0
    finally:
        if transport is not None:
            transport.close()
        learner.close()
        server.close()


def test_alert_waivers_equal_the_reference():
    assert alerts.ALERT_WAIVERS == jalerts.ALERT_WAIVERS
    assert not set(alerts.ALERT_WAIVERS) & {r.runbook for r in alerts.RULES}
    assert all(isinstance(v, str) and v for v in alerts.ALERT_WAIVERS.values())


def test_actor_fold_matches_the_reference_on_a_hand_fed_window(monkeypatch):
    """The accountant reads only the host clock: a fold over a hand-fed
    window gives the reference's fractions exactly."""
    monkeypatch.setattr(telemetry, "fleet_interval_s", 0.25)
    preg, jreg = telemetry.Registry(), jtel.Registry()
    p = utilization.make_actor(preg)
    j = jutil.make_actor(jreg, interval_s=0.25)
    for acct in (p, j):
        acct._acct._window_start = 100.0
        acct._last_fold = 100.0
        for name, s in (("env_step", 0.5), ("featurize", 0.25), ("encode", 0.125), ("ship_wait", 0.0625)):
            acct.phase(name, s)
    assert p.maybe_fold(now=100.1) is None and j.maybe_fold(now=100.1) is None   # inside the cadence
    got, want = p.maybe_fold(now=102.0), j.maybe_fold(now=102.0)
    assert got == want and got["other"] == pytest.approx(1.0625 / 2.0)
    assert {k: v for k, v in preg.snapshot().items() if k.startswith("util/")} == {
        k: v for k, v in jreg.snapshot().items() if k.startswith("util/")}
    assert np.isclose(sum(got.values()), 1.0)


class _Stop(Exception):
    pass


def test_actor_cli_fleet_interval_sets_the_pool_fold_cadence(monkeypatch):
    """A deliberate difference from the reference, pinned: the port's actor
    CLI folds its pool's ``util/actor/*`` at the ``--fleet-interval``
    cadence (so a 1 s snapshot cadence ships folded values within a
    second or two), where the reference's pool folds every 5 s
    (``telemetry.fleet_interval_s``) whatever the flag. The port restores
    the global at exit."""
    import signal

    from dotaclient_tpu.actor import __main__ as jactor_cli
    from dotaclient_tpu_torch.actor import __main__ as actor_cli

    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        port_fold, ref_fold = [], []
        monkeypatch.setattr(actor_cli, "_run", lambda args: port_fold.append(
            utilization.make_actor(telemetry.Registry())._interval) or 0)

        def ref_configure(**kwargs):
            # the reference's CLI installs its publisher just before the
            # pool, which builds its accountant from the same global
            ref_fold.append(jutil.make_actor(jtel.Registry())._interval)
            raise _Stop

        monkeypatch.setattr(jfleet, "configure", ref_configure)
        before = telemetry.fleet_interval_s
        for flag in (["--fleet-interval", "2"], []):
            args = ["--connect", "127.0.0.1:1", "--platform", "cpu", *flag]
            assert actor_cli.main(args) == 0
            assert telemetry.fleet_interval_s == before
            with pytest.raises(_Stop):
                jactor_cli.main(args)
        assert port_fold == [2.0, before] and before == 5.0
        assert ref_fold == [5.0, 5.0] and jtel.fleet_interval_s == 5.0
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)
