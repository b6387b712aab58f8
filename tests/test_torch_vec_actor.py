"""The port's host actor path against the JAX package: the numpy simulator,
the batched featurizer and reward, the actor pool and its CLI.

``VecLaneSim``, ``scripted_actions_vec``, ``VecFeaturizer`` and
``VecRewards`` are numpy in both packages, so from the same seed and the
same action stream they must agree bit for bit (200 ticks, 1v1 and 5v5,
scripted bots on some games). ``VecActorPool`` is held against the JAX pool
from the same params, fed the Gumbel noise the JAX pool's key stream draws:
at f32 compute its chunks' observations, actions, rewards, dones and
versions are equal and its log-probs and carries within 1e-5; at the
policy's bf16 compute one device step's log-probs and carries agree within
0.03 (``tests/test_torch_policy.py``'s bf16 tolerance) and the actions
agree wherever the JAX side's sampling margin exceeds that. The chunks'
wire bytes are the JAX encoder's.
"""

import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotaclient_tpu.actor.vec_runtime import VecActorPool as JaxVecActorPool
from dotaclient_tpu.actor.vec_runtime import make_device_step as jax_make_device_step
from dotaclient_tpu.envs import vec_lane_sim as JS
from dotaclient_tpu.features import vec_featurizer as JF
from dotaclient_tpu.models import distributions as JD
from dotaclient_tpu.transport import serialize as J
from dotaclient_tpu_torch.actor import __main__ as actor_cli
from dotaclient_tpu_torch.actor.vec_runtime import VecActorPool, make_device_step
from dotaclient_tpu_torch.envs import vec_lane_sim as PS
from dotaclient_tpu_torch.features import vec_featurizer as PF
from dotaclient_tpu_torch.models.convert import convert, to_flax
from dotaclient_tpu_torch.transport import serialize as S
from dotaclient_tpu_torch.transport.queues import InProcTransport
from dotaclient_tpu_torch.utils import faults, telemetry
from tests.test_torch_common import flax_params, jax_policy, port_policy, small_configs

ATOL = 1e-5
BF16_TOL = 0.03
TICKS = 200


# -- the simulator, the featurizer and the reward ----------------------------------------------------------


def sim_pair(team_size, seed=3, n_games=4, max_dota_time=12.0):
    """The same games in both packages: game 0 hard bot against the agent,
    games 1-2 agent against the easy bot, the rest agent against agent."""
    out = []
    for mod in (JS, PS):
        spec = mod.VecSimSpec(n_games=n_games, team_size=team_size, max_dota_time=max_dota_time)
        hero_ids, control = mod.draft_games(n_games, team_size, (1, 2, 3), "selfplay", seed)
        control[0, :team_size] = 2
        control[1:3, team_size:] = 1
        out.append(mod.VecLaneSim(spec, hero_ids, control, seed=seed))
    return out


def action_stream(sim, n_lanes, rng):
    """Uniform random head indices [L, 5] for the featurizer's lanes."""
    return np.stack([rng.integers(0, 4, n_lanes), rng.integers(0, 9, n_lanes), rng.integers(0, 9, n_lanes),
                     rng.integers(0, sim.spec.max_units, n_lanes), rng.integers(0, 1, n_lanes)], 1).astype(np.int32)


def assert_sims_equal(js, ps, tick):
    for name, v in vars(js).items():
        if isinstance(v, np.ndarray):
            got = getattr(ps, name)
            assert got.dtype == v.dtype and np.array_equal(got, v), (tick, name)


@pytest.mark.parametrize("team_size", [1, 5])
def test_vec_sim_and_scripted_bots_match_jax_bitwise(team_size):
    js, ps = sim_pair(team_size)
    agents = list(range(team_size))
    jf = JF.VecFeaturizer(js, *_specs("jax"), agents)
    pf = PF.VecFeaturizer(ps, *_specs("port"), agents)
    rng, reseed = np.random.default_rng(0), np.random.default_rng(1)
    ended = kills = 0
    for t in range(TICKS):
        dist = js._pairwise_dist()
        np.testing.assert_array_equal(ps._pairwise_dist(), dist)
        want = JS.scripted_actions_vec(js, dist)
        got = PS.scripted_actions_vec(ps, dist)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{t} {k}")
        packed = action_stream(js, jf.n_lanes, rng)
        js.step(jf.actions_to_sim(packed))
        ps.step(pf.actions_to_sim(packed))
        assert_sims_equal(js, ps, t)
        if js.done.any():
            games = np.nonzero(js.done)[0]
            ended += len(games)
            seeds = reseed.integers(0, 2**31 - 1, size=len(games))
            js.reset(games, seeds=seeds)
            ps.reset(games, seeds=seeds)
            assert_sims_equal(js, ps, t)
        kills += int(js.last_hits.sum() + js.deaths.sum())
    assert ended > 0 and kills > 0
    for g in range(js.n_games):
        for team in (2, 3):
            assert ps.world_state(g, team).SerializeToString() == js.world_state(g, team).SerializeToString()


def _specs(pkg):
    cfg = small_configs()[0 if pkg == "jax" else 1]
    return cfg.obs, cfg.actions


@pytest.mark.parametrize("team_size", [1, 5])
def test_vec_featurizer_and_rewards_match_jax_bitwise(team_size):
    js, ps = sim_pair(team_size, seed=9)
    agents = list(range(2 * team_size))   # every player's view, both sides
    jf, pf = JF.VecFeaturizer(js, *_specs("jax"), agents), PF.VecFeaturizer(ps, *_specs("port"), agents)
    weights = dict(small_configs()[1].reward.as_dict(), win=7.0)
    jr, pr = JF.VecRewards(js, agents, weights=weights), PF.VecRewards(ps, agents, weights=weights)
    rng, reseed = np.random.default_rng(2), np.random.default_rng(3)
    for t in range(TICKS):
        want, got = jf.featurize_all(), pf.featurize_all()
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (t, k)
        packed = action_stream(js, jf.n_lanes, rng)
        np.testing.assert_array_equal(list(pf.actions_to_sim(packed).values()),
                                      list(jf.actions_to_sim(packed).values()))
        js.step(jf.actions_to_sim(packed))
        ps.step(pf.actions_to_sim(packed))
        np.testing.assert_array_equal(pr.compute(), jr.compute(), err_msg=str(t))
        assert pr.last_term_sums == jr.last_term_sums
        if js.done.any():
            games = np.nonzero(js.done)[0]
            seeds = reseed.integers(0, 2**31 - 1, size=len(games))
            js.reset(games, seeds=seeds)
            ps.reset(games, seeds=seeds)
            jr.snapshot()
            pr.snapshot()


def test_sim_refuses_a_layout_without_creep_room():
    spec = PS.VecSimSpec(n_games=1, team_size=5, max_units=16)
    with pytest.raises(ValueError, match="creep slots"):
        PS.VecLaneSim(spec, np.ones((1, 10), np.int32), np.zeros((1, 10), np.int32))


# -- the actor pool ------------------------------------------------------------------------------------------


N_ENVS, T = 2, 3


def pool_configs(opponent, dtype="float32", max_dota_time=0.4):
    """Tiny games (0.4 s: 2 steps, so games end inside a 3-step chunk) at
    the small model."""
    return tuple(dataclasses.replace(
        cfg, ppo=dataclasses.replace(cfg.ppo, rollout_len=T),
        env=dataclasses.replace(cfg.env, n_envs=N_ENVS, opponent=opponent, max_dota_time=max_dota_time))
        for cfg in small_configs(dtype))


@functools.lru_cache(maxsize=None)
def noise_fn(sizes, n_lanes):
    """Jitted: the pool's key -> (next key, the Gumbel noise of each head
    [L, n]) as the JAX pool's step draws it (``split`` then
    ``distributions.sample``'s five-way split)."""
    sizes = dict(sizes)

    def draw(key):
        key, sub = jax.random.split(key)
        ks = jax.random.split(sub, 5)
        return key, {h: jax.random.gumbel(k, (n_lanes, sizes[h]), jnp.float32) for h, k in zip(JD.HEADS, ks)}

    return jax.jit(draw)


def pools(opponent, dtype="float32", seed=5, version=3, **kw):
    jcfg, pcfg = pool_configs(opponent, dtype, **kw)
    params = flax_params(jcfg, seed=seed)
    jout, pout = [], []
    jpool = JaxVecActorPool(jcfg, jax_policy(jcfg)[0], jax.tree.map(jnp.asarray, params), seed=seed,
                            version=version, rollout_sink=jout.extend)
    policy = port_policy(pcfg, params)
    ppool = VecActorPool(pcfg, policy, dict(policy.state_dict()), seed=seed, version=version,
                         rollout_sink=pout.extend, device="cpu", registry=telemetry.Registry())
    return jcfg, jpool, ppool, jout, pout


def step_both(jcfg, jpool, ppool, n):
    draw = noise_fn(tuple(sorted(jcfg.actions.head_sizes.items())), jpool.n_lanes)
    for _ in range(n):
        key, noise = draw(jpool._key_dev)
        assert np.array_equal(np.asarray(key), np.asarray(jax.random.split(jpool._key_dev)[0]))
        jpool.step()
        ppool.step(noise={h: torch.from_numpy(np.array(v)) for h, v in noise.items()})


def assert_chunks_match(pout, jout):
    assert len(pout) == len(jout) > 0
    for (pm, pa), (jm, ja) in zip(pout, jout):
        assert pm == jm
        for name, want in J.flatten_tree(ja).items():
            got = S.flatten_tree(pa)[name]
            want = np.asarray(want)
            if name in ("behavior_logp",) or name.startswith("carry0/"):
                np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=name)
            else:
                assert got.dtype == want.dtype and np.array_equal(got, want), name
        assert list(S.flatten_tree(pa)) == list(J.flatten_tree(ja))


@pytest.mark.parametrize("opponent", ["scripted_easy", "selfplay"])
def test_vec_pool_chunks_match_jax(opponent):
    jcfg, jpool, ppool, jout, pout = pools(opponent)
    step_both(jcfg, jpool, ppool, 7)   # games end every 2 steps: step 7 leaves partial chunks
    assert ppool.episodes_done == jpool.episodes_done > 0
    assert_chunks_match(pout, jout)
    # the in-progress chunks too
    jn, pn = len(jout), len(pout)
    assert ppool.flush_partial() == jpool.flush_partial()
    assert_chunks_match(pout[pn:], jout[jn:])
    assert ppool.stats() == jpool.stats()
    assert ppool.drain_stats() == jpool.drain_stats()


def test_vec_pool_chunks_encode_to_the_jax_packages_bytes():
    jcfg, jpool, ppool, jout, pout = pools("selfplay", seed=11)
    step_both(jcfg, jpool, ppool, 4)
    for meta, arrays in pout:
        port = bytes(S.encode_rollout_bytes(arrays, **meta))
        # the two native writers byte for byte; the protobuf codecs' bytes
        # by parse (a map's wire order follows its hash table)
        assert port == bytes(J.encode_rollout_bytes(arrays, **meta))
        want = J.encode_rollout(arrays, **meta)
        assert S.encode_rollout_bytes(arrays, **meta, native=False) == want.SerializeToString()
        assert S.pb.Rollout.FromString(port) == want
        jm, ja = J.decode_rollout_bytes(bytes(J.encode_rollout_bytes(arrays, **meta)), native=False)
        pm, pa = S.decode_rollout_bytes(port)
        assert pm == jm
        for name, v in J.flatten_tree(ja).items():
            np.testing.assert_array_equal(S.flatten_tree(pa)[name], v)


def test_device_step_at_bf16_matches_jax_within_tolerance():
    jcfg, pcfg = pool_configs("selfplay", dtype="bfloat16", max_dota_time=20.0)
    params = flax_params(jcfg, seed=13)
    jpolicy = jax_policy(jcfg)[0]
    policy = port_policy(pcfg, params)
    jpool = JaxVecActorPool(jcfg, jpolicy, jax.tree.map(jnp.asarray, params), seed=13, rollout_sink=[].extend)
    for _ in range(3):   # a few steps in, so the carry is not zero
        jpool.step()
    obs = jpool._pending_obs
    L = jpool.n_lanes
    reset = np.zeros((L,), bool)
    reset[0] = True
    carry = jpool._carry_dev
    key = jax.random.PRNGKey(4)
    (packed, logp, jcarry), _ = jax_make_device_step(jpolicy)(jax.tree.map(jnp.asarray, params), obs, carry, key,
                                                              reset)
    _, noise = noise_fn(tuple(sorted(jcfg.actions.head_sizes.items())), L)(jax.random.PRNGKey(4))
    pstep = make_device_step(policy)
    pcarry = tuple(torch.from_numpy(np.asarray(c, np.float32)).to(torch.bfloat16) for c in carry)
    out, _ = pstep(dict(policy.state_dict()), {k: torch.from_numpy(v) for k, v in obs.items()}, pcarry,
                   torch.from_numpy(reset), noise={h: torch.from_numpy(np.array(v)) for h, v in noise.items()})
    out = out.numpy()
    H = pcfg.model.hidden_dim
    np.testing.assert_allclose(out[:, 6:6 + H], np.asarray(jcarry[0]), atol=BF16_TOL, rtol=0)
    np.testing.assert_allclose(out[:, 6 + H:], np.asarray(jcarry[1]), atol=BF16_TOL, rtol=0)
    assert np.isfinite(out).all()
    # each head's action agrees unless the JAX side's sampling scores
    # (log-prob + noise) put the port's pick within 2 x the tolerance of its
    # own; the joint log-probs of rows that agree, within the tolerance
    keep = jnp.asarray(1.0 - reset, jnp.float32)
    masked = jax.tree.map(lambda t: t * keep.reshape(-1, 1).astype(t.dtype), carry)
    logits, _, _ = jax_policy(jcfg)[1](jax.tree.map(jnp.asarray, params), obs, masked)
    logps = JD._head_logps(logits, jax.tree.map(jnp.asarray, obs))
    packed = np.asarray(packed)
    logps["target_unit"] = JD._select_target_logps(logps, jnp.asarray(packed[:, 0]))
    got = out[:, :5].astype(np.int32)
    for j, h in enumerate(JD.HEADS):
        score = np.asarray(logps[h]) + np.asarray(noise[h])
        rows = np.arange(L)
        gap = score[rows, packed[:, j]] - score[rows, got[:, j]]
        assert np.all((got[:, j] == packed[:, j]) | (gap <= 2 * BF16_TOL)), h
    agree = np.all(got == packed, axis=1)
    assert agree.any()
    np.testing.assert_allclose(out[agree, 5], np.asarray(logp)[agree], atol=BF16_TOL, rtol=0)


def test_refresh_weights_applies_a_jax_frame_and_versions_tag_chunks():
    jcfg, pcfg = pool_configs("selfplay", max_dota_time=20.0)
    params = flax_params(jcfg, seed=2)
    policy = port_policy(pcfg, params)
    t = InProcTransport(registry=telemetry.Registry())
    out = []
    pool = VecActorPool(pcfg, policy, dict(policy.state_dict()), transport=t, seed=1, version=0,
                        rollout_sink=out.extend, device="cpu", registry=telemetry.Registry())
    assert not pool.refresh_weights()   # nothing published yet
    new = flax_params(jcfg, seed=3)
    t.publish_weights(J.encode_weights(new, 6))
    pool.run(2 * T, refresh_every=T)
    assert pool.version == 6 and pool.versions_applied == {0, 6}
    for k, v in convert(new).items():
        assert torch.equal(pool.params[k], v), k
    # chunks started before the refresh carry version 0, after it 6
    assert [m["model_version"] for m, _ in out] == [0] * pool.n_lanes + [6] * pool.n_lanes
    assert not pool.refresh_weights()   # the same version again is a no-op


def test_pool_ships_encoded_chunks_over_a_transport_and_the_nonfinite_fault():
    jcfg, pcfg = pool_configs("scripted_easy", max_dota_time=20.0)
    policy = port_policy(pcfg, flax_params(jcfg, seed=2))

    class Wire:
        def __init__(self):
            self.frames = []

        def publish_rollout_bytes(self, payload):
            self.frames.append(payload)

        def latest_weights(self):
            return None

    wire = Wire()
    faults.configure("actor.nonfinite_payload@2")
    try:
        pool = VecActorPool(pcfg, policy, dict(policy.state_dict()), transport=wire, seed=1, device="cpu",
                            registry=telemetry.Registry())
    finally:
        faults.configure(None)
    pool.run(T, refresh_every=0)
    decoded = [S.decode_rollout_bytes(p) for p in wire.frames]
    assert len(decoded) == pool.n_lanes == pool.rollouts_shipped
    finite = [bool(np.isfinite(a["rewards"]).all()) for _, a in decoded]
    assert finite == [True, False] + [True] * (pool.n_lanes - 2)


def test_league_opponent_lanes_play_their_own_params():
    jcfg, pcfg = pool_configs("league", max_dota_time=20.0)
    policy = port_policy(pcfg, flax_params(jcfg, seed=2))
    out = []
    pool = VecActorPool(pcfg, policy, dict(policy.state_dict()), seed=1, rollout_sink=out.extend, device="cpu",
                        registry=telemetry.Registry())
    assert pool._opponent is not None and pool.n_lanes == N_ENVS * pcfg.env.team_size
    frozen = convert(flax_params(jcfg, seed=7))
    pool.set_opponent(frozen, 4)
    assert pool._opponent._weights == (frozen, 4)
    pool.run(T, refresh_every=0)
    assert len(out) == pool.n_lanes
    with pytest.raises(ValueError, match="no opponent lanes"):
        VecActorPool(pool_configs("selfplay")[1], policy, dict(policy.state_dict()), device="cpu",
                     registry=telemetry.Registry()).set_opponent(frozen, 1)


def test_window_stats_drain_and_outcome_counters():
    jcfg, jpool, ppool, jout, pout = pools("scripted_easy", seed=4)
    step_both(jcfg, jpool, ppool, 6)
    first = ppool.drain_stats()
    assert first["episodes_recent"] == ppool.episodes_done > 0
    assert ppool.drain_stats()["episodes_recent"] == 0.0
    snap = ppool._tel.snapshot()
    assert snap["outcome/episodes/vs_scripted"] == ppool.episodes_done
    assert snap["outcome/episodes_side/radiant"] == ppool.episodes_done
    assert sum(snap[f"outcome/ep_len_hist/{i:02d}"] for i in range(12)) == ppool.episodes_done


def test_pool_published_weights_round_trip_through_to_flax():
    jcfg, pcfg = pool_configs("selfplay")
    params = flax_params(jcfg, seed=8)
    policy = port_policy(pcfg, params)
    frame = S.encode_weights(to_flax(policy.state_dict()), 9)
    pool = VecActorPool(pcfg, policy, {}, transport=type("T", (), {"latest_weights": lambda self: frame})(),
                        seed=0, version=0, rollout_sink=[].extend, device="cpu", registry=telemetry.Registry())
    assert pool.refresh_weights() and pool.version == 9
    for k, v in policy.state_dict().items():
        assert torch.equal(pool.params[k], v), k


# -- the actor CLI -------------------------------------------------------------------------------------------


@pytest.mark.parametrize("extra,item", [
    (["--connect", "shm://lane"], None), (["--amqp", "broker:5672"], "13"),
    (["--connect", "shm://lane", "--rollout-wire-dtype", "bfloat16"], "13"),
    (["--connect", "shm://lane", "--trace-jsonl", "t"], "8"),
    (["--connect", "shm://lane", "--trace-jsonl", "t", "--trace-sample", "4"], "8"),
    (["--connect", "shm://lane", "--fleet-interval", "1"], None),
])
def test_actor_cli_refuses_what_is_not_ported(extra, item, capsys, monkeypatch):
    if item == "8":
        # the trace plane is ported: the flags reach tracing.configure
        # before the connect (and the pool), and the log shuts down at exit
        from dotaclient_tpu_torch.utils import tracing

        traced = []
        monkeypatch.setattr(tracing, "configure", lambda path, sample_n=None, registry=None: traced.append(
            (path, sample_n)))
        assert actor_cli.main(extra + ["--platform", "cpu", "--max-reconnects", "1"]) == 1
        assert "cannot reach the learner" in capsys.readouterr().err
        assert traced == [("t", 4 if "--trace-sample" in extra else None), (None, None)]
        return
    if item is None:
        # ported: shm://NAME attaches to the learner's lane (and
        # --fleet-interval sets the snapshot cadence); with no lane the
        # connect fails like a refused TCP dial and the actor exits 1
        assert actor_cli.main(extra + ["--platform", "cpu", "--max-reconnects", "1"]) == 1
        assert "cannot reach the learner" in capsys.readouterr().err
        return
    # item 13's flags are ported: --amqp and --rollout-wire-dtype reach the
    # transport factory (the broker's address, the config's rollout wire);
    # without pika the AMQP transport raises the reference's error
    seen = []

    def factory(connect, idle_timeout, transport_config, amqp=None):
        seen.append((connect, amqp, transport_config.rollout_wire_dtype))

        def dial():
            raise ConnectionError("no learner here")
        return dial

    monkeypatch.setattr(actor_cli, "transport_factory", factory)
    assert actor_cli.main(extra + ["--platform", "cpu", "--max-reconnects", "1"]) == 1
    assert "cannot reach the learner" in capsys.readouterr().err
    amqp = extra[1] if extra[0] == "--amqp" else None
    assert seen == [(None if amqp else extra[1], amqp, "bfloat16" if "--rollout-wire-dtype" in extra else "float32")]
    if amqp:
        monkeypatch.undo()
        monkeypatch.setitem(sys.modules, "pika", None)
        with pytest.raises(RuntimeError, match="requires pika"):
            actor_cli.main(extra + ["--platform", "cpu", "--max-reconnects", "1"])


def test_actor_cli_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        actor_cli.main(["--connect", "127.0.0.1:9"])
    with pytest.raises(SystemExit):
        actor_cli.main([])   # --connect is required


def test_actor_cli_exits_1_when_the_learner_is_unreachable(capsys):
    import socket

    with socket.socket() as s:   # a port nothing listens on
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert actor_cli.main(["--connect", f"127.0.0.1:{port}", "--platform", "cpu", "--max-reconnects", "1"]) == 1
    assert "cannot reach the learner" in capsys.readouterr().err
