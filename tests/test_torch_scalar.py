"""The port's scalar path against the JAX package: the proto game, the
featurizer and reward, the env API, the scalar actor pool, the learner's
``scalar`` mode and ``evaluate_served``.

``LaneSim``, ``scripted_action``, ``featurize``, ``decode_action``,
``shaped_reward`` and ``DotaEnvCore`` are numpy and protobuf in both
packages, so from the same seed and the same actions they must agree bit for
bit: the same ``WorldState`` bytes over 200 ticks (1v1 and 5v5, scripted bots
and random agent orders, games ending and restarting), the same feature
arrays and dtypes, the same reward terms, the same reply bytes. The
``ActorPool`` is held against the JAX pool from the same params, fed the
Gumbel noise the JAX pool's key stream draws: at f32 its chunks'
observations, actions, rewards, dones and versions are equal and its
log-probs and carries within 1e-5; at the policy's bf16 one step's log-probs
and carries agree within 0.03; its chunks re-encode to the JAX encoder's
bytes. The learner's scalar mode makes one update on the same chunks as the
JAX learner's within ``test_torch_train``'s f32 bounds, and trains and keeps
its books on its own and through its CLI. ``evaluate_served`` plays the same
games as the JAX package's when both clients answer by one fixed function of
the observation, and full games against a port ``PolicyServer``.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotaclient_tpu import features as JF
from dotaclient_tpu.actor.runtime import ActorPool as JaxActorPool
from dotaclient_tpu.actor.runtime import build_game_config as jax_build
from dotaclient_tpu.envs import env_api as JE
from dotaclient_tpu.envs import lane_sim as JL
from dotaclient_tpu.league import evaluation as jax_evaluation
from dotaclient_tpu.protos import dota_pb2 as jpb
from dotaclient_tpu.serve import client as jax_client
from dotaclient_tpu.train.learner import Learner as JaxLearner
from dotaclient_tpu.transport import serialize as J
from dotaclient_tpu_torch import features as PF
from dotaclient_tpu_torch.actor import ActorPool, build_game_config
from dotaclient_tpu_torch.envs import env_api as PE
from dotaclient_tpu_torch.envs import lane_sim as PL
from dotaclient_tpu_torch.league import evaluation as port_evaluation
from dotaclient_tpu_torch.models import convert
from dotaclient_tpu_torch.protos import dota_pb2 as ppb
from dotaclient_tpu_torch.serve import PolicyServer, ServeEngine, make_inference_policy
from dotaclient_tpu_torch.serve import client as port_client
from dotaclient_tpu_torch.train import learner as plearner
from dotaclient_tpu_torch.transport import serialize as S
from dotaclient_tpu_torch.transport.queues import InProcTransport
from dotaclient_tpu_torch.utils import telemetry
from tests.test_torch_buffered import assert_params_close, books, buffered_configs, capture_grads, noisy_mask
from tests.test_torch_common import flax_params, jax_policy, port_policy, small_configs, tiny_configs
from tests.test_torch_vec_actor import noise_fn

ATOL = 1e-5
BF16_TOL = 0.03
TICKS = 200


# -- the game, the featurizer and the reward -------------------------------------------------------------


def game_config_bytes(team_size, seed, max_dota_time=12.0):
    """Radiant agents against Dire bots (hard and easy alternating); in
    5v5 one Radiant hero is a scripted bot too."""
    picks = []
    for i in range(team_size):
        mode = jpb.CONTROL_SCRIPTED_HARD if team_size > 1 and i == team_size - 1 else jpb.CONTROL_AGENT
        picks.append(jpb.HeroPick(team_id=JL.TEAM_RADIANT, hero_id=1 + i % 3, control_mode=mode))
    for i in range(team_size):
        mode = jpb.CONTROL_SCRIPTED_HARD if i % 2 == 0 else jpb.CONTROL_SCRIPTED_EASY
        picks.append(jpb.HeroPick(team_id=JL.TEAM_DIRE, hero_id=1 + (i + 1) % 4, control_mode=mode))
    return jpb.GameConfig(ticks_per_observation=6, max_dota_time=max_dota_time, seed=seed,
                          hero_picks=picks).SerializeToString()


def random_orders(sim, rng):
    """Random orders for the agent heroes as field dicts (some heroes left
    without one, one unknown player id), targets drawn from the live
    units."""
    handles = sorted(sim.units)
    out = []
    for hero in sim.heroes:
        if sim.control_modes[hero.player_id] != jpb.CONTROL_AGENT or rng.random() < 0.1:
            continue
        out.append(dict(player_id=hero.player_id, type=int(rng.integers(0, 4)), move_x=int(rng.integers(0, 9)),
                        move_y=int(rng.integers(0, 9)), target_handle=int(rng.choice(handles)),
                        ability_slot=int(rng.random() < 0.1)))
    out.append(dict(player_id=99, type=1, move_x=8, move_y=4))
    return out


def sim_pairs(team_size, seed):
    """The same games in both packages, restarted with the next seed when
    one ends; yields (tick, JAX game, port game) after each step."""
    rng = np.random.default_rng(seed)
    k = 0
    blob = game_config_bytes(team_size, seed)
    js, ps = JL.LaneSim(jpb.GameConfig.FromString(blob)), PL.LaneSim(ppb.GameConfig.FromString(blob))
    yield -1, js, ps
    for t in range(TICKS):
        orders = random_orders(js, rng)
        js.step({o["player_id"]: jpb.Action(**o) for o in orders})
        ps.step({o["player_id"]: ppb.Action(**o) for o in orders})
        yield t, js, ps
        if js.done:
            assert ps.done
            k += 1
            blob = game_config_bytes(team_size, seed + k)
            js, ps = JL.LaneSim(jpb.GameConfig.FromString(blob)), PL.LaneSim(ppb.GameConfig.FromString(blob))
            yield t, js, ps


@pytest.mark.parametrize("team_size", [1, 5])
def test_lane_sim_and_scripted_bots_match_jax_bitwise(team_size):
    ended = kills = 0
    for t, js, ps in sim_pairs(team_size, seed=3):
        assert (ps.tick, ps.dota_time, ps.game_state, ps.winning_team) == (
            js.tick, js.dota_time, js.game_state, js.winning_team), t
        for team in JL.TEAMS:
            assert ps.world_state(team).SerializeToString() == js.world_state(team).SerializeToString(), (t, team)
        for jh, ph in zip(js.heroes, ps.heroes):
            for mode in (jpb.CONTROL_SCRIPTED_EASY, jpb.CONTROL_SCRIPTED_HARD):
                want = JL.scripted_action(js, jh, mode, 9).SerializeToString()
                assert PL.scripted_action(ps, ph, mode, 9).SerializeToString() == want, (t, jh.player_id, mode)
        ended += js.done
        kills += sum(h.kills + h.last_hits for h in js.heroes)
    assert ended >= 2 and kills > 0


@pytest.mark.parametrize("team_size", [1, 5])
def test_featurizer_reward_and_decode_match_jax_bitwise(team_size):
    jcfg, pcfg = small_configs()
    weights = dict(pcfg.reward.as_dict(), win=7.0, gold=0.003)
    rng = np.random.default_rng(4)
    prev = None
    cast_legal = 0
    for t, js, ps in sim_pairs(team_size, seed=9):
        for team in JL.TEAMS:
            jws, pws = js.world_state(team), ps.world_state(team)
            for hero in js.heroes:
                pid = hero.player_id
                jo = JF.featurize(jws, pid, jcfg.obs, jcfg.actions)
                po = PF.featurize(pws, pid, pcfg.obs, pcfg.actions)
                jd, pd = JF.observation_to_dict(jo), PF.observation_to_dict(po)
                assert list(pd) == list(jd)
                for k, v in jd.items():
                    assert pd[k].dtype == v.dtype and np.array_equal(pd[k], v), (t, pid, k)
                cast_legal += bool(jd["mask_action_type"][3])
                idx = {h: int(rng.integers(0, n)) for h, n in pcfg.actions.head_sizes.items()}
                assert (PF.decode_action(idx, po, pid).SerializeToString()
                        == JF.decode_action(idx, jo, pid).SerializeToString()), (t, pid)
                if prev is not None and prev[2] is js:
                    for w in (None, weights):
                        want = JF.shaped_reward(prev[0][team], jws, pid, weights=w)
                        assert PF.shaped_reward(prev[1][team], pws, pid, weights=w) == want, (t, pid)
        prev = ({tm: js.world_state(tm) for tm in JL.TEAMS}, {tm: ps.world_state(tm) for tm in JL.TEAMS}, js)
    # the reward of an empty world and a stacked batch, too
    empty = (jpb.WorldState(team_id=2), ppb.WorldState(team_id=2))
    assert PF.reward_components(empty[1], empty[1], 0) == JF.reward_components(empty[0], empty[0], 0)
    assert cast_legal > 0


# -- the env API -----------------------------------------------------------------------------------------------


def test_env_core_and_local_env_replies_match_jax_bytewise():
    """Both agent teams act (Dire first, then Radiant, with a foreign
    order each, dropped), games end and restart; every reply's bytes and
    the observe-before-reset failure are the JAX package's."""
    blob = jpb.GameConfig(ticks_per_observation=6, max_dota_time=3.0, seed=5, hero_picks=[
        jpb.HeroPick(team_id=2, hero_id=1, control_mode=jpb.CONTROL_AGENT),
        jpb.HeroPick(team_id=3, hero_id=2, control_mode=jpb.CONTROL_AGENT)]).SerializeToString()
    plain = jpb.GameConfig(seed=8).SerializeToString()   # no picks: the game's default 1v1
    rng = np.random.default_rng(6)
    for jenv, penv, core in ((JE.DotaEnvCore(), PE.DotaEnvCore(), True), (JE.LocalDotaEnv(), PE.LocalDotaEnv(), False)):
        def observe(env, mod, team):
            return env.observe(mod.ObserveRequest(team_id=team) if core else team).SerializeToString()

        assert observe(penv, ppb, 2) == observe(jenv, jpb, 2)   # before a reset: STATUS_FAILED
        assert jpb.ObserveResponse.FromString(observe(jenv, jpb, 2)).status == jpb.STATUS_FAILED
        assert penv.done and jenv.done
        for cfg in (plain, blob, blob):
            assert (penv.reset(ppb.GameConfig.FromString(cfg)).SerializeToString()
                    == jenv.reset(jpb.GameConfig.FromString(cfg)).SerializeToString())
            for t in range(25):
                for team in (3, 2):
                    own, other = (1, 0) if team == 3 else (0, 1)
                    fields = [dict(player_id=own, type=int(rng.integers(0, 4)), move_x=int(rng.integers(0, 9)),
                                   move_y=int(rng.integers(0, 9)), target_handle=int(rng.integers(1, 20))),
                              dict(player_id=other, type=1, move_x=0, move_y=0)]
                    replies = [env.act(mod.Actions(team_id=team, actions=[mod.Action(**f) for f in fields]))
                               .SerializeToString() for env, mod in ((jenv, jpb), (penv, ppb))]
                    assert replies[0] == replies[1]
                for team in (2, 3):
                    assert observe(penv, ppb, team) == observe(jenv, jpb, team), t
                assert penv.done == jenv.done
            assert jenv.done or cfg is plain   # the default game lasts 600 s


# -- the actor pool ----------------------------------------------------------------------------------------------


N_ENVS, T = 2, 3


def pool_configs(opponent, dtype="float32", max_dota_time=0.4):
    """Tiny games (0.4 s: 2 steps, so games end inside a 3-step chunk) at
    the small model."""
    return tuple(dataclasses.replace(
        cfg, ppo=dataclasses.replace(cfg.ppo, rollout_len=T),
        env=dataclasses.replace(cfg.env, n_envs=N_ENVS, opponent=opponent, max_dota_time=max_dota_time))
        for cfg in small_configs(dtype))


def pools(opponent, dtype="float32", seed=5, version=3, **kw):
    jcfg, pcfg = pool_configs(opponent, dtype, **kw)
    params = flax_params(jcfg, seed=seed)
    jout, pout = [], []
    jpool = JaxActorPool(jcfg, jax_policy(jcfg)[0], jax.tree.map(jnp.asarray, params), seed=seed, version=version,
                         rollout_sink=jout.append)
    policy = port_policy(pcfg, params)
    ppool = ActorPool(pcfg, policy, dict(policy.state_dict()), seed=seed, version=version, rollout_sink=pout.append,
                      device="cpu", registry=telemetry.Registry())
    return jcfg, jpool, ppool, jout, pout


def step_both(jcfg, jpool, ppool, n):
    draw = noise_fn(tuple(sorted(jcfg.actions.head_sizes.items())), len(jpool.lanes))
    for _ in range(n):
        key, noise = draw(jpool._key_dev)
        assert np.array_equal(np.asarray(key), np.asarray(jax.random.split(jpool._key_dev)[0]))
        jpool.step()
        ppool.step(noise={h: torch.from_numpy(np.array(v)) for h, v in noise.items()})


def assert_chunks_match(pout, jout):
    assert len(pout) == len(jout) > 0
    for p, j in zip(pout, jout):
        (pm, pa), (jm, ja) = S.decode_rollout(p), J.decode_rollout(j)
        assert pm == jm
        pflat, jflat = S.flatten_tree(pa), J.flatten_tree(ja)
        assert list(pflat) == list(jflat)
        for name, want in jflat.items():
            got, want = pflat[name], np.asarray(want)
            if name == "behavior_logp" or name.startswith("carry0/"):
                np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=name)
            else:
                assert got.dtype == want.dtype and np.array_equal(got, want), name


@pytest.mark.parametrize("opponent", ["scripted_easy", "selfplay"])
def test_actor_pool_chunks_match_jax(opponent):
    jcfg, jpool, ppool, jout, pout = pools(opponent)
    assert ppool.n_lanes == len(jpool.lanes) == N_ENVS * (2 if opponent == "selfplay" else 1)
    step_both(jcfg, jpool, ppool, 7)   # games end every 2 steps: chunks cut by the ends and by T
    assert ppool.episodes_done == jpool.episodes_done > 0
    assert_chunks_match(pout, jout)
    for pl, jl in zip(ppool.lanes, jpool.lanes):   # the chunks in progress
        assert (pl.env_idx, pl.player_id, pl.team_id, pl.version0) == (jl.env_idx, jl.player_id, jl.team_id,
                                                                        jl.version0)
        assert pl.actions == jl.actions and pl.rewards == jl.rewards and pl.dones == jl.dones
        np.testing.assert_allclose(pl.logps, jl.logps, rtol=0, atol=ATOL)
    assert ppool.stats() == jpool.stats()
    assert ppool.drain_stats() == jpool.drain_stats()


def test_actor_pool_chunks_encode_to_the_jax_packages_bytes():
    jcfg, jpool, ppool, jout, pout = pools("selfplay", seed=11)
    step_both(jcfg, jpool, ppool, 4)
    assert pout
    for proto in pout:
        meta, arrays = S.decode_rollout(proto)
        # a map's wire order follows its hash table, so the chunk is held
        # against the JAX encoder in the deterministic (key-sorted) form,
        # and both encoders against each other on one insertion order
        want = J.encode_rollout(arrays, **meta)
        assert proto.SerializeToString(deterministic=True) == want.SerializeToString(deterministic=True)
        assert S.encode_rollout(arrays, **meta).SerializeToString() == want.SerializeToString()


def test_actor_pool_step_at_bf16_matches_jax_within_tolerance():
    jcfg, jpool, ppool, jout, pout = pools("selfplay", dtype="bfloat16", seed=13, max_dota_time=20.0)
    step_both(jcfg, jpool, ppool, 1)
    jc = [np.asarray(c, np.float32) for c in jpool._carry_dev]
    pc = [c.float().numpy() for c in ppool._carry_dev]
    for a, b in zip(pc, jc):
        np.testing.assert_allclose(a, b, atol=BF16_TOL, rtol=0)
        assert np.isfinite(a).all()
    agree = [pl.actions == jl.actions for pl, jl in zip(ppool.lanes, jpool.lanes)]
    assert any(agree)
    for ok, pl, jl in zip(agree, ppool.lanes, jpool.lanes):
        if ok:
            np.testing.assert_allclose(pl.logps, jl.logps, atol=BF16_TOL, rtol=0)


def test_refresh_weights_applies_a_jax_frame_and_versions_tag_chunks():
    jcfg, pcfg = pool_configs("selfplay", max_dota_time=20.0)
    params = flax_params(jcfg, seed=2)
    policy = port_policy(pcfg, flax_params(jcfg, seed=3))
    frame = jpb.ModelWeights.FromString(J.encode_weights(params, 9).SerializeToString())
    out = []
    transport = type("T", (), {"latest_weights": lambda self: ppb.ModelWeights.FromString(frame.SerializeToString())})()
    pool = ActorPool(pcfg, policy, dict(policy.state_dict()), transport=transport, seed=0, version=4,
                     rollout_sink=out.append, device="cpu", registry=telemetry.Registry())
    pool.step()   # one step under version 4: every lane's chunk began under it
    assert pool.refresh_weights() and pool.version == 9 and not pool.refresh_weights()
    for k, v in convert(params).items():
        assert torch.equal(pool.params[k], v), k
    pool.run(2 * T, refresh_every=0)
    versions = [S.decode_rollout(p)[0]["model_version"] for p in out]
    # the chunks that began before the refresh ship with the older version
    assert versions[:pool.n_lanes] == [4] * pool.n_lanes and set(versions[pool.n_lanes:]) == {9}
    pool.set_params(dict(policy.state_dict()), 10)
    assert pool.version == 10 and pool.versions_applied == {4, 9, 10}


def test_actor_pool_refuses_what_it_cannot_run(monkeypatch):
    _, pcfg = pool_configs("scripted_easy")
    policy = port_policy(pcfg, flax_params(small_configs()[0], seed=1))
    sd = dict(policy.state_dict())
    with pytest.raises(NotImplementedError, match="LSTM core only"):
        ActorPool(dataclasses.replace(pcfg, model=dataclasses.replace(pcfg.model, core="transformer")), policy, sd,
                  device="cpu")
    # the narrow rollout wire is ported: the pool ships narrow protos (the
    # bf16 leaves, int8 actions and the marker) to its transport, full
    # width to an in-process sink
    narrow = dataclasses.replace(pcfg, transport=dataclasses.replace(pcfg.transport, rollout_wire_dtype="bfloat16"))
    transport = InProcTransport(registry=telemetry.Registry())
    pool = ActorPool(narrow, policy, sd, transport=transport, device="cpu", registry=telemetry.Registry())
    pool.run(pcfg.ppo.rollout_len)
    protos = transport.consume_rollouts(64, timeout=0.1)
    assert protos and all(p.arrays["__wire_cast__"].data for p in protos)
    meta, arrays = S.decode_rollout(protos[0])
    assert meta["wire_cast"]["obs/units"] == "float32" and arrays["obs"]["units"].dtype == torch.bfloat16
    assert arrays["actions"]["move_x"].dtype == np.int8 and arrays["rewards"].dtype == np.float32
    _, wide = S.decode_rollout(protos[0], upcast=True)
    assert wide["obs"]["units"].dtype == np.float32 and wide["actions"]["move_x"].dtype == np.int32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ActorPool(pcfg, policy, sd)


def test_build_game_config_matches_jax():
    jcfg, pcfg = small_configs()
    for opponent in ("scripted_easy", "scripted_hard", "selfplay", "league"):
        for team_size in (1, 5):
            env = dict(opponent=opponent, team_size=team_size, hero_pool=(1, 2, 3))
            j = dataclasses.replace(jcfg, env=dataclasses.replace(jcfg.env, **env))
            p = dataclasses.replace(pcfg, env=dataclasses.replace(pcfg.env, **env))
            assert build_game_config(p, 17).SerializeToString() == jax_build(j, 17).SerializeToString()


# -- the learner's scalar mode -----------------------------------------------------------------------------------


def scalar_configs(opponent="scripted_easy", max_dota_time=0.4):
    return tuple(dataclasses.replace(cfg, env=dataclasses.replace(cfg.env, opponent=opponent,
                                                                  max_dota_time=max_dota_time))
                 for cfg in buffered_configs(T=3, batch=4, capacity=8, min_fill=4))


def test_scalar_learner_update_matches_jax():
    """The port's scalar pool plays; its protos reach both learners'
    in-process transports; each ingests, takes a batch and makes one
    update: the same books and params within the f32 bounds."""
    jcfg, pcfg = scalar_configs()
    jl = JaxLearner(jcfg, actor="scalar", seed=1)
    pl = plearner.Learner(pcfg, actor="scalar", seed=1, device="cpu", registry=telemetry.Registry())
    pl.policy.load_state_dict(convert(jax.tree.map(np.asarray, jl.state.params)))
    assert pl.pool is pl.host_pool and isinstance(pl.host_pool, ActorPool) and pl._sink is None
    pl.host_pool.set_params(pl._actor_params_copy(), 0)
    pl.host_pool.run(6, refresh_every=0)
    protos = pl.transport.consume_rollouts(64, timeout=1.0)
    assert len(protos) >= pcfg.ppo.batch_rollouts
    for p in protos:
        jl.transport.publish_rollout(jpb.Rollout.FromString(p.SerializeToString()))
        pl.transport.publish_rollout(p)
    seen = capture_grads(pl.state)
    assert jl.ingest() == pl._ingest() == len(protos)
    jl._optimize(jl._next_batch())
    pl._optimize(pl._next_batch())
    assert books(pl.buffer) == books(jl.buffer)
    assert_params_close(pl.policy, jl.state.params, noisy_mask(pl.policy, seen), "one scalar update")
    jl._snap_engine.stop()
    pl.close()


@pytest.mark.parametrize("overlap", [False, True])
def test_scalar_learner_trains_and_keeps_its_books(overlap):
    _, cfg = scalar_configs("selfplay", max_dota_time=2.0)
    cfg = dataclasses.replace(cfg, log_every=2)
    learner = plearner.Learner(cfg, actor="scalar", device="cpu", registry=telemetry.Registry())
    before = {k: v.clone() for k, v in learner.policy.state_dict().items()}
    out = learner.train(4, overlap=overlap, refresh_every=1)
    buf = learner.buffer
    assert out["optimizer_steps"] == 4.0 and np.isfinite(out["loss"]) and out["health_ok"] == 1.0
    assert buf.ingested == 4 * 4 + buf.size + buf.dropped_stale + buf.dropped_overflow
    assert buf.dropped_skew == buf.dropped_nonfinite == buf.dropped_bounds == 0
    assert out["actor_env_steps"] > 0 and out["actor_rollouts_shipped"] >= buf.ingested
    assert any(not torch.equal(v, before[k]) for k, v in learner.policy.state_dict().items())
    assert learner.host_pool.version >= (2 if overlap else 3)   # pushed params
    learner.close()


def test_scalar_learner_refuses_league_and_needs_a_card(monkeypatch):
    _, cfg = scalar_configs("league")
    with pytest.raises(NotImplementedError, match="frozen-opponent lanes"):
        plearner.Learner(cfg, actor="scalar", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plearner.Learner(scalar_configs()[1], actor="scalar")


@pytest.mark.parametrize("flags", [["--actor", "scalar"], ["--no-vec"]])
def test_scalar_learner_cli(flags, tmp_path, capsys):
    jsonl = tmp_path / "r.jsonl"
    assert plearner.main(["--smoke", "--steps", "2", "--device", "cpu", "--metrics-jsonl", str(jsonl)] + flags) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(f"done: 2 steps, {2 * 8 * 8} frames, ")
    last = json.loads(telemetry.load_jsonl(str(jsonl))[-1])["scalars"]
    assert last["actor_env_steps"] > 0 and last["buffer/ingested"] >= 16 and last["optimizer_steps"] == 2.0


# -- evaluate_served ----------------------------------------------------------------------------------------------


def fixed_answer(obs):
    """One action as a fixed function of an observation: a legal action
    type picked by the game clock, a march toward the enemy tower, the
    first legal target."""
    legal = np.flatnonzero(obs["mask_action_type"])
    a = int(legal[int(round(float(obs["globals"][0]) * 3000)) % len(legal)])
    targets = np.flatnonzero(obs["mask_cast_target" if a == 3 else "mask_target_unit"])
    return {"action_type": a, "move_x": 8, "move_y": 4, "target_unit": int(targets[0]) if len(targets) else 0,
            "ability": 0}


class FixedClient:
    """A ``ServeClient`` stand-in that answers ``fixed_answer``."""

    opened = closed = steps = resets = 0

    def __init__(self, host, port, config, **kw):
        type(self).opened += 1

    def step(self, obs, reset=False):
        type(self).steps += 1
        type(self).resets += bool(reset)
        return fixed_answer(obs)

    def close(self):
        type(self).closed += 1


@pytest.mark.parametrize("opponent", ["scripted_hard", "selfplay"])
def test_evaluate_served_plays_the_jax_packages_games(opponent, monkeypatch):
    counts = {}
    outs = {}
    for name, mod, cfg in (("jax", jax_client, small_configs()[0]), ("port", port_client, small_configs()[1])):
        cfg = dataclasses.replace(cfg, env=dataclasses.replace(cfg.env, max_dota_time=2.0))
        client = type(f"Fixed{name}", (FixedClient,), {})
        monkeypatch.setattr(mod, "ServeClient", client)
        run = jax_evaluation.evaluate_served if name == "jax" else port_evaluation.evaluate_served
        outs[name] = run(cfg, ("127.0.0.1", 1), opponent=opponent, n_games=3, seed=4)
        counts[name] = (client.opened, client.closed, client.steps, client.resets)
    assert outs["port"] == outs["jax"] and outs["port"]["episodes"] >= 3
    assert counts["port"] == counts["jax"]
    assert counts["port"][0] == counts["port"][1] == 3 * (2 if opponent == "selfplay" else 1)
    snap = telemetry.get_registry().snapshot()
    assert snap["league/eval_episodes"] == outs["port"]["episodes"]


def test_evaluate_served_plays_full_games_against_a_port_server():
    """The serving plane's first client: full games over the wire against
    a port ``PolicyServer`` on the CPU."""
    jcfg, pcfg = tiny_configs(max_batch=4, batch_window_ms=1.0, max_slots=8)
    pcfg = dataclasses.replace(pcfg, env=dataclasses.replace(pcfg.env, max_dota_time=2.0))
    reg = telemetry.Registry()
    params = convert(flax_params(jcfg, seed=3, value_head=False))
    engine = ServeEngine(pcfg, make_inference_policy(pcfg, device="cpu"), params, registry=reg, device="cpu")
    server = PolicyServer(engine, pcfg, port=0, registry=reg)
    try:
        out = port_evaluation.evaluate_served(pcfg, server.address, opponent="scripted_easy", n_games=2, seed=3)
        assert out["episodes"] >= 2 and 0.0 <= out["win_rate"] <= 1.0
        assert np.isfinite(out["episode_reward_mean"])
        snap = reg.snapshot()
        assert snap["serve/requests_total"] > 0 and snap["serve/dispatches_total"] > 0
    finally:
        server.close()
        engine.stop()
