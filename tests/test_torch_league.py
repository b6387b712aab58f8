"""The port's league: the opponent pool, the frozen-opponent lanes of the
device rollout, the league glue of the fused learner, evaluation, the
league CLI and the demo.

The pool is held against the JAX package's ``OpponentPool`` op for op (the
same uid sequence, exactly). One league chunk is held against the JAX
package's ``DeviceActor._rollout_impl`` with an opponent whose params
differ from the learner's and anchor games present: the test replays JAX's
per-game key stream to get the Gumbel noise of both sides' heads
(``ks[:, 1]`` and ``ks[:, 2]``) and the creep-wave jitter, and hands all of
it to the port. Actions, dones and stats must be equal; observations,
rewards and log-probs agree within 1e-5 at f32 compute. A second chunk
starts from towers at half health, so its timeouts are decided and the
win counts PFSP reads are compared too. Small sizes: the
small f32 model, team size 2, 2 to 4 games, 3-step chunks of 0.4 s games.
"""

import copy
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotaclient_tpu.actor.device_rollout import DeviceActor as JaxDeviceActor
from dotaclient_tpu.league import evaluate as jax_evaluate
from dotaclient_tpu.league.pool import OpponentPool as JaxOpponentPool
from dotaclient_tpu.models import distributions as JD
from dotaclient_tpu.train.learner import Learner as JaxLearner
from dotaclient_tpu_torch import league as pleague
from dotaclient_tpu_torch.actor.device_rollout import DeviceActor
from dotaclient_tpu_torch.envs import torch_lane_sim as S
from dotaclient_tpu_torch.league import __main__ as league_cli
from dotaclient_tpu_torch.models import convert
from dotaclient_tpu_torch.models import distributions as D
from dotaclient_tpu_torch.models.policy import init_params, make_policy
from dotaclient_tpu_torch.train import demo as pdemo
from dotaclient_tpu_torch.train import fused as pfused
from dotaclient_tpu_torch.train import learner as plearner
from dotaclient_tpu_torch.train import ppo as pppo
from dotaclient_tpu_torch.utils import telemetry
from dotaclient_tpu_torch.utils.checkpoint import CheckpointManager
from tests.test_torch_common import flax_params, jax_policy, port_policy, small_configs
from tests.test_torch_rollout import assert_tree_close, jax_randomness, to_np

ATOL = 1e-5
T = 3


def league_configs(n_envs=4, max_dota_time=0.4, **league):
    """(jax, port) configs of a 2v2 league at the small f32 model: 3-step
    chunks of 0.4 s games (2 steps, so every game ends and resets inside a
    chunk); ``league`` overrides LeagueConfig (half the games anchored to
    the two bots by default)."""
    over = {"anchor_prob": 0.5, "anchor_opponent": "mixed", **league}
    out = []
    for cfg in small_configs():
        out.append(dataclasses.replace(
            cfg,
            ppo=dataclasses.replace(cfg.ppo, rollout_len=T),
            env=dataclasses.replace(cfg.env, n_envs=n_envs, team_size=2, hero_pool=(1, 2, 3), opponent="league",
                                    max_dota_time=max_dota_time),
            league=dataclasses.replace(cfg.league, **over),
            log_every=1,
        ))
    return tuple(out)


# -- the pool --------------------------------------------------------------------


def drive_pool(pool, make_params, matchmaking_seed):
    """A fixed script of snapshots, draws and reports (ring eviction
    included): returns the uid sequence the pool drew."""
    rng = np.random.default_rng(matchmaking_seed)
    uids = []
    for step in range(40):
        pool.maybe_snapshot(make_params(step), step, step)
        for _ in range(3):
            _, _, uid = pool.sample_indexed(make_params(-1), step)
            uids.append(uid)
            games = float(rng.integers(0, 5))
            pool.report(uid, float(rng.integers(0, int(games) + 1)), games)
    return uids


@pytest.mark.parametrize("matchmaking", ["uniform", "pfsp"])
def test_pool_draws_the_reference_sequence(matchmaking):
    jcfg, pcfg = league_configs(snapshot_every=3, pool_size=4, matchmaking=matchmaking)
    jpool = JaxOpponentPool(jcfg.league, seed=11)
    ppool = pleague.OpponentPool(pcfg.league, seed=11)
    want = drive_pool(jpool, lambda s: {"w": jnp.full((2,), float(s))}, 5)
    got = drive_pool(ppool, lambda s: {"w": torch.full((2,), float(s))}, 5)
    assert got == want
    assert len(set(want) - {pleague.LIVE}) > 4          # draws spread over evicted and live snapshots
    assert [s.uid for s in ppool.snapshots] == [s.uid for s in jpool.snapshots]
    assert len(ppool) == 4 and ppool.win_rates() == pytest.approx(jpool.win_rates())


def test_pool_snapshots_are_frozen_copies():
    _, pcfg = league_configs(snapshot_every=2)
    pool = pleague.OpponentPool(pcfg.league)
    live = {"w": torch.zeros(3)}
    assert pool.maybe_snapshot(live, 0, 0) and not pool.maybe_snapshot(live, 1, 1)
    live["w"].add_(1.0)                                 # an in-place optimizer step
    assert torch.equal(pool.snapshots[0].params["w"], torch.zeros(3))
    with pytest.raises(ValueError, match="matchmaking"):
        pleague.OpponentPool(dataclasses.replace(pcfg.league, matchmaking="elo"))


# -- one league chunk against the JAX package ----------------------------------------


def port_league_actor(pcfg, params, jactor, js=None):
    """The port's league actor on JAX's world: policy from ``params``, the
    sim state copied from ``js`` (the JAX actor's own by default)."""
    policy = port_policy(pcfg, params)
    actor = DeviceActor(pcfg, policy, seed=5, device="cpu")
    js = jactor.state if js is None else js
    actor.state.sim = S.SimState(**{k: torch.from_numpy(np.array(getattr(js.sim, k))) for k in S.FIELDS})
    return policy, actor


def torch_tree(tree):
    return None if tree is None else {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def decided_towers(jactor, js):
    """``js`` with one tower at half health in each game: the Dire tower
    in games 0, 2 and 3, the Radiant tower in game 1. Every first episode's
    timeout is then decided (tower hp leads the adjudication): a win of
    the learner's side (Radiant) in three games, a loss in one."""
    t = jactor.spec.tower_lo
    health = np.array(js.sim.health)
    health[[0, 2, 3], t + 1] *= 0.5
    health[1, t] *= 0.5
    return js._replace(sim=js.sim._replace(health=jax.device_put(health, js.sim.health.sharding)))


def league_chunk_against_jax(decided=False):
    """One league chunk of the port against JAX's ``_rollout_impl`` from
    the same world and noise, the opponent's params not the learner's:
    asserts every output equal (discrete) or within ATOL, and returns the
    port's stats."""
    jcfg, pcfg = league_configs()
    params, opp = flax_params(jcfg, seed=3), flax_params(jcfg, seed=4)
    jactor = JaxDeviceActor(jcfg, jax_policy(jcfg)[0], seed=5)
    assert jactor.n_anchor_games == 2 and jactor._opp_feat is not None
    js = decided_towers(jactor, jactor.state) if decided else jactor.state
    noise, opp_noise, jitter = jax_randomness(jcfg, jactor.n_lanes, len(jactor.opponent_players) * 4)(
        js.key, js.sim.key)
    j_new, j_chunk, j_stats = jax.jit(jactor._rollout_impl)(
        jax.tree.map(jnp.asarray, params), js, jax.tree.map(jnp.asarray, opp))

    policy, actor = port_league_actor(pcfg, params, jactor, js)
    assert (actor.n_lanes, actor.n_opp_lanes, actor.n_anchor_games) == (8, 8, 2)
    with torch.no_grad():
        p_new, p_chunk, p_stats = actor._rollout_impl(
            policy, actor.state, convert(opp),
            noise=torch_tree(noise), jitter=torch_tree(jitter), opp_noise=torch_tree(opp_noise),
        )
    got, want = to_np(p_chunk), to_np(j_chunk)
    assert float(want["dones"].sum()) > 0
    for h in JD.HEADS:
        np.testing.assert_array_equal(got["actions"][h], want["actions"][h], err_msg=h)
    np.testing.assert_array_equal(got["dones"], want["dones"])
    for k in ("rewards", "behavior_logp", "valid"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL, err_msg=k)
    assert_tree_close(got["obs"], want["obs"], "obs")
    stats, jstats = to_np(p_stats), to_np(j_stats)
    assert_tree_close(stats, jstats, "stats")
    for k in ("episodes", "wins", "league_episodes", "league_wins"):
        np.testing.assert_array_equal(stats[k], jstats[k], err_msg=k)
    # anchor games are left out of the snapshot's record, and both kinds ended
    assert 0 < stats["league_episodes"].sum() < stats["episodes"].sum()
    for k in S.FIELDS:
        w, g = np.asarray(getattr(j_new.sim, k)), getattr(p_new.sim, k).numpy()
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-3, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    for side in ("carry", "opp_carry"):
        for g, w in zip(getattr(p_new, side), getattr(j_new, side)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL, err_msg=side)
    return stats


def test_league_chunk_matches_jax():
    stats = league_chunk_against_jax()
    # 0.4 s games of untouched towers, no kills, no gold: every timeout a tie
    assert stats["wins"].sum() == 0


def test_decided_league_chunk_matches_jax():
    """Teeth for the outcome stats PFSP reads: decided games, some of them
    league games, with the learner's wins and losses equal to JAX's."""
    stats = league_chunk_against_jax(decided=True)
    assert stats["league_wins"].sum() > 0
    assert 0 < stats["wins"].sum() < stats["episodes"].sum()


def record_samples(monkeypatch):
    """Record every ``distributions.sample`` call's actions: in a league
    rollout the calls alternate learner lanes, opponent lanes."""
    calls = []
    sample = D.sample

    def recording(*args, **kw):
        acts, logp = sample(*args, **kw)
        calls.append({h: a.clone() for h, a in acts.items()})
        return acts, logp

    monkeypatch.setattr(D, "sample", recording)
    return calls


def test_the_opponent_params_drive_the_opponent_lanes(monkeypatch):
    """Teeth: the same chunk with the live params in the opponent's place
    changes the opponent lanes' actions and leaves the learner lanes' as
    they were (at step 0, before the opponent's moves reach the world)."""
    jcfg, pcfg = league_configs()
    params, opp = flax_params(jcfg, seed=3), flax_params(jcfg, seed=4)
    jactor = JaxDeviceActor(jcfg, jax_policy(jcfg)[0], seed=5)
    js = jactor.state
    noise, opp_noise, jitter = jax_randomness(jcfg, jactor.n_lanes, 8)(js.key, js.sim.key)
    calls = record_samples(monkeypatch)
    runs = []
    for opponent in ("frozen", "live"):
        policy, actor = port_league_actor(pcfg, params, jactor)
        calls.clear()
        with torch.no_grad():
            actor._rollout_impl(policy, actor.state, convert(opp) if opponent == "frozen" else policy,
                                noise=torch_tree(noise), jitter=torch_tree(jitter), opp_noise=torch_tree(opp_noise))
        assert len(calls) == 2 * T
        runs.append(list(calls))
    frozen, live = runs
    for h in D.HEADS:
        assert torch.equal(frozen[0][h], live[0][h]), h
    assert any(not torch.equal(frozen[1][h], live[1][h]) for h in D.HEADS)


def test_collect_needs_the_opponent_and_counts():
    _, pcfg = league_configs()
    policy = make_policy(pcfg.model, pcfg.obs, pcfg.actions, device="cpu")
    init_params(policy, torch.Generator().manual_seed(0))
    reg = telemetry.Registry()
    actor = DeviceActor(pcfg, policy, seed=1, registry=reg, device="cpu")
    with pytest.raises(ValueError, match="opp_params"):
        actor.collect(policy.state_dict())
    frozen = {k: v.clone() for k, v in policy.state_dict().items()}
    chunk, stats = actor.collect(policy.state_dict(), opp_params=frozen)
    assert chunk["rewards"].shape == (8, T) and stats["league_episodes"].shape == (4,)
    assert (actor.env_steps, actor.rollouts_shipped) == (8 * T, 8)
    snap = reg.snapshot()
    assert snap["actor/frames_shipped"] == 8 * T and snap["actor/rollouts_shipped"] == 8
    actor.reset_recurrent()
    assert all(float(t.abs().sum()) == 0 for t in actor.state.carry + actor.state.opp_carry)


# -- the fused step and the learner --------------------------------------------------


def test_league_fused_equals_collect_then_train():
    _, cfg = league_configs()
    policy = make_policy(cfg.model, cfg.obs, cfg.actions, device="cpu")
    init_params(policy, torch.Generator().manual_seed(3))
    actor = DeviceActor(cfg, policy, seed=3, device="cpu")
    state = pppo.init_train_state(policy, cfg.ppo)
    opp = {k: v + 0.01 for k, v in policy.state_dict().items()}
    actor_state0 = copy.deepcopy(actor.state)
    gen0 = actor.generator.get_state()

    ref_state = state.clone()
    with torch.no_grad():
        ref_actor, chunk, ref_stats = actor._rollout_impl(ref_state.policy, copy.deepcopy(actor_state0), opp)
    ref_state, ref_m = pppo._train_step(cfg.ppo, ref_state, chunk)

    actor.generator.set_state(gen0)
    fused = pfused.make_fused_step(cfg, actor)
    got_state, got_actor, m, stats = fused(state.clone(), copy.deepcopy(actor_state0), opp)
    np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]), rtol=1e-5)
    for (name, g), w in zip(got_state.policy.state_dict().items(), ref_state.policy.state_dict().values()):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6, msg=name)
    for g, w in zip(got_actor.opp_carry, ref_actor.opp_carry):
        torch.testing.assert_close(g, w)
    torch.testing.assert_close(stats["league_episodes"], ref_stats["league_episodes"])


def league_learner(seed=1, **league):
    _, cfg = league_configs(n_envs=2, **{"snapshot_every": 2, "opponent_hold": 2, **league})
    return plearner.Learner(cfg, actor="fused", seed=seed, device="cpu", registry=telemetry.Registry())


def test_learner_league_snapshots_draws_and_reports():
    learner = league_learner(selfplay_prob=0.25)
    initial = {k: v.clone() for k, v in learner.policy.state_dict().items()}
    assert len(learner.league) == 1
    assert all(torch.equal(learner.league.snapshots[0].params[k], v) for k, v in initial.items())
    reported = []
    report = learner._report_league
    learner._report_league = lambda uid, st: (reported.append((uid, float(st["league_episodes"].sum()))),
                                              report(uid, st))
    out = learner.train(6)
    # snapshots at steps 0, 2 and 4; the step-0 one still the initial params
    assert [s.step for s in learner.league.snapshots] == [0, 2, 4]
    assert all(torch.equal(learner.league.snapshots[0].params[k], v) for k, v in initial.items())
    assert out["league_snapshots"] == 3.0 and 0.0 <= out["league_winrate_mean"] <= 1.0
    # the held draw: one opponent for each pair of steps
    assert len(reported) == 6 and all(reported[i][0] == reported[i + 1][0] for i in (0, 2, 4))
    assert any(uid != pleague.LIVE for uid, _ in reported)
    assert not learner._league_pending                  # flushed at the end of train
    for snap in learner.league.snapshots:
        assert snap.games == sum(g for uid, g in reported if uid == snap.uid)


def test_learner_credits_league_wins_to_the_pool():
    """Decided games reach the PFSP record through the flush: with the
    Dire tower at half health in both games, each first episode is the
    learner's win, credited to the step-0 snapshot that every draw picks
    (no mirror draws, no anchor games)."""
    learner = league_learner(selfplay_prob=0.0, anchor_prob=0.0)
    da = learner.device_actor
    health = da.state.sim.health.clone()
    health[:, da.spec.tower_lo + 1] *= 0.5
    da.state.sim = da.state.sim.replace(health=health)
    reported = []
    report = learner._report_league
    learner._report_league = lambda uid, st: (reported.append((uid, st)), report(uid, st))
    learner.train(2)
    assert not learner._league_pending
    assert {uid for uid, _ in reported} == {0}
    wins = sum(float(st["league_wins"].sum()) for _, st in reported)
    games = sum(float(st["league_episodes"].sum()) for _, st in reported)
    snap = learner.league.snapshots[0]
    assert wins >= 2 and (snap.wins, snap.games) == (wins, games)
    assert 0.0 < snap.win_rate < 1.0


def test_learner_refuses_a_hold_shorter_than_the_stride():
    jcfg, pcfg = league_configs(opponent_hold=1)
    jcfg, pcfg = (dataclasses.replace(c, steps_per_dispatch=2) for c in (jcfg, pcfg))
    with pytest.raises(ValueError, match="opponent_hold"):
        JaxLearner(jcfg, actor="fused")
    with pytest.raises(ValueError, match="opponent_hold"):
        plearner.Learner(pcfg, actor="fused", device="cpu")


def test_learner_cli_league(capsys, tmp_path):
    path = str(tmp_path / "run.jsonl")
    assert plearner.main(["--smoke", "--steps", "2", "--opponent", "league", "--league",
                          "snapshot_every=1,pool_size=2", "--device", "cpu", "--metrics-jsonl", path]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("done: 2 steps, ")
    rows = [json.loads(line)["scalars"] for line in open(path)]
    assert rows[-1]["optimizer_steps"] == 2.0 and rows[-1]["league_snapshots"] == 2.0
    with pytest.raises(SystemExit) as e:
        plearner.main(["--smoke", "--league", "snapshot_every=1", "--device", "cpu"])
    assert e.value.code == 2


# -- evaluation, the league CLI and the demo ------------------------------------------


@pytest.mark.parametrize("mode", ["scripted_hard", "league"])
def test_evaluate_counts_full_games_as_the_reference(mode):
    """Every game finishes at least once, and the chunk budget and the
    drain cadence give the reference's episode count (0.4 s games end by
    timeout at a fixed step)."""
    jcfg, pcfg = league_configs(n_envs=2)
    params, opp = flax_params(jcfg, seed=3), flax_params(jcfg, seed=4)
    want = jax_evaluate(jcfg, jax_policy(jcfg)[0], jax.tree.map(jnp.asarray, params), mode,
                        opponent_params=jax.tree.map(jnp.asarray, opp) if mode == "league" else None,
                        n_games=3, seed=2)
    policy = port_policy(pcfg, params)
    got = pleague.evaluate(pcfg, policy, policy.state_dict(), mode,
                           opponent_params=convert(opp) if mode == "league" else None,
                           n_games=3, seed=2, device="cpu")
    assert got["episodes"] == want["episodes"] >= 3
    assert 0.0 <= got["win_rate"] <= 1.0 and np.isfinite(got["episode_reward_mean"])
    snap = telemetry.get_registry().snapshot()
    assert snap["league/eval_episodes"] == got["episodes"] and snap["league/eval_win_rate"] == got["win_rate"]
    # evaluate_served is ported: with no server at the address its first
    # client fails to connect
    with pytest.raises((ConnectionError, OSError)):
        pleague.evaluate_served(dataclasses.replace(pcfg, serve=dataclasses.replace(
            pcfg.serve, request_deadline_s=0.5)), ("127.0.0.1", 1), n_games=1)


def save_checkpoint(path, seed, **model):
    _, cfg = league_configs(n_envs=2)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **model),
                              env=dataclasses.replace(cfg.env, opponent="scripted_easy"))
    learner = plearner.Learner(cfg, actor="fused", seed=seed, device="cpu", registry=telemetry.Registry(),
                               checkpoint_dir=str(path))
    learner.train(1)
    return str(path)


def test_league_cli_from_port_checkpoints(tmp_path, capsys):
    a, b = save_checkpoint(tmp_path / "a", 1), save_checkpoint(tmp_path / "b", 2)
    assert league_cli.main(["--checkpoint", a, "--vs", b, "--games", "2", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["opponent"] == f"checkpoint:{b}@step1" and out["step"] == 1 and out["games"] >= 2
    assert 0.0 <= out["win_rate"] <= 1.0
    assert league_cli.main(["--checkpoint", a, "--games", "2", "--opponent", "scripted_easy",
                            "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["opponent"] == "scripted_easy"
    wide = save_checkpoint(tmp_path / "wide", 3, hidden_dim=16)
    assert league_cli.main(["--checkpoint", a, "--vs", wide, "--games", "2", "--device", "cpu"]) == 2
    assert "another model" in capsys.readouterr().err
    assert CheckpointManager(a, registry=telemetry.Registry()).all_steps() == [1]


def test_demo_cli_on_cpu(capsys):
    assert pdemo.main(["--steps", "2", "--n-envs", "2", "--eval-games", "2", "--team-size", "2",
                       "--max-dota-time", "0.4", "--opponent", "league", "--league", "snapshot_every=1",
                       "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith("DEMO_SUMMARY ")
    summary = json.loads(lines[-1][len("DEMO_SUMMARY "):])
    assert summary["steps"] == 2 and summary["team_size"] == 2 and summary["frames"] == 2 * 16 * 4
    for k in ("init_win_vs_easy", "init_win_vs_hard", "final_win_vs_easy", "final_win_vs_hard",
              "final_win_vs_initial_self"):
        assert 0.0 <= summary[k] <= 1.0, k


@pytest.mark.parametrize("flag", [["--core", "gru"], ["--moe-experts", "4"]])
def test_demo_refuses_what_is_not_ported(flag):
    """The transformer and MoE cores are ported; the demo still refuses a
    core neither package has and experts without the transformer core
    (``make_policy``'s ValueError, as in the JAX package)."""
    if flag[0] == "--core":
        with pytest.raises(SystemExit):
            pdemo.main(["--device", "cpu", *flag])
        return
    with pytest.raises(ValueError, match="requires core='transformer'"):
        pdemo.main(["--device", "cpu", "--n-envs", "2", "--eval-games", "2", *flag])


def test_no_device_and_no_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    _, pcfg = league_configs()
    policy = make_policy(pcfg.model, pcfg.obs, pcfg.actions, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceActor(pcfg, policy)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pleague.evaluate(pcfg, policy, policy.state_dict(), "scripted_hard", n_games=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        league_cli.main(["--checkpoint", "unused"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pdemo.main(["--steps", "1", "--n-envs", "2", "--eval-games", "2"])
