"""The port's device simulator, featurizer and shaped reward against the
JAX package's (``envs/jax_lane_sim.py``, ``features/jax_featurizer.py``).

Both sides start from the same world and get the same creep-wave jitter:
the JAX side draws it from its key, and the test hands the port the numbers
it drew (``jax_jitter``). Integer fields must be equal; float fields agree
within the tolerance ``tests/test_jax_sim.py`` holds the JAX sim to against
the numpy one (rtol 1e-4, atol 1e-3).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotaclient_tpu.config import default_config
from dotaclient_tpu.envs import jax_lane_sim as J
from dotaclient_tpu.envs.vec_lane_sim import VecSimSpec as JSpec
from dotaclient_tpu.features import jax_featurizer as JF
from dotaclient_tpu.features.reward import fold_terms as jax_fold_terms
from dotaclient_tpu.protos import dota_pb2 as pb
from dotaclient_tpu_torch.config import default_config as port_default_config
from dotaclient_tpu_torch.envs import torch_lane_sim as S
from dotaclient_tpu_torch.envs.vec_lane_sim import VecSimSpec
from dotaclient_tpu_torch.features import torch_featurizer as TF

RTOL, ATOL = 1e-4, 1e-3     # float fields (tests/test_jax_sim.py's tolerance)
INT_FIELDS = ("unit_type", "team", "level", "last_hits", "denies", "kills", "deaths", "tick",
              "winning_team", "hero_ids", "control_modes", "alive", "done")


def specs(n, team_size=1, max_dota_time=600.0):
    kw = dict(n_games=n, team_size=team_size, max_units=32, max_dota_time=max_dota_time)
    return JSpec(**kw), VecSimSpec(**kw)


@functools.lru_cache(maxsize=None)
def _jitter_fns(spec):
    """Jitted: the jitter ``jax_lane_sim._spawn_waves`` draws from key
    ``sub``; what ``J.step`` draws for a state's wave (from split(key)[1]);
    what ``J.reset_where`` draws for its fresh games."""
    shape = (spec.n_games, spec.creeps_per_team)

    def from_sub(sub):
        return jnp.stack([
            jax.random.uniform(jax.random.fold_in(sub, i), shape, minval=-40.0, maxval=40.0)
            for i in range(2)
        ])

    def for_step(key):
        return from_sub(jax.random.split(key)[1])

    def for_reset(key):
        return from_sub(jax.random.split(jax.random.split(key)[1])[1])

    return jax.jit(from_sub), jax.jit(for_step), jax.jit(for_reset)


def jax_jitter(spec, sub):
    return torch.from_numpy(np.array(_jitter_fns(spec)[0](sub)))


def step_jitter(spec, jstate):
    return torch.from_numpy(np.array(_jitter_fns(spec)[1](jstate.key)))


def reset_jitter(spec, jstate):
    return torch.from_numpy(np.array(_jitter_fns(spec)[2](jstate.key)))


def to_port(jstate):
    return S.SimState(**{k: torch.from_numpy(np.array(getattr(jstate, k))) for k in S.FIELDS})


def assert_states_close(pstate, jstate, context=""):
    for name in S.FIELDS:
        got = getattr(pstate, name).numpy()
        want = np.asarray(getattr(jstate, name))
        if name in INT_FIELDS:
            np.testing.assert_array_equal(got, want, err_msg=f"{context}: field {name}")
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=f"{context}: field {name}")


def world(n, p0, p1, team_size=1, max_dota_time=600.0, seed=0):
    jspec, pspec = specs(n, team_size, max_dota_time)
    P = 2 * team_size
    hero = np.random.default_rng(seed).integers(1, 4, size=(n, P)).astype(np.int32)
    ctrl = np.full((n, P), pb.CONTROL_AGENT, np.int32)
    ctrl[:, 0] = p0
    ctrl[:, team_size] = p1
    key = jax.random.PRNGKey(seed)
    jstate = jax_init(jspec)(jnp.asarray(hero), jnp.asarray(ctrl), key)
    pstate = S.init_state(pspec, torch.from_numpy(hero), torch.from_numpy(ctrl),
                          jitter=jax_jitter(jspec, jax.random.split(key)[1]))
    return jspec, pspec, jstate, pstate


@functools.lru_cache(maxsize=None)
def jax_step(jspec, scripted=True):
    return jax.jit(lambda s, a: J.step(jspec, s, a, scripted_possible=scripted))


@functools.lru_cache(maxsize=None)
def jax_init(jspec):
    return jax.jit(lambda h, c, k: J.init_state(jspec, h, c, k))


def noop(n, P):
    a = {k: np.zeros((n, P), np.int32) for k in ("type", "move_x", "move_y", "target_slot", "ability")}
    a["type"][:] = -1
    return a


def test_init_state_matches():
    jspec, _, jstate, pstate = world(4, pb.CONTROL_SCRIPTED_EASY, pb.CONTROL_SCRIPTED_HARD, seed=4)
    assert_states_close(pstate, jstate, "init")


def test_scripted_horizon_with_waves():
    """160 steps (32 s: the first wave, the second at 30 s, combat, last
    hits, XP and levels) of scripted easy against scripted hard."""
    jspec, pspec, jstate, pstate = world(4, pb.CONTROL_SCRIPTED_EASY, pb.CONTROL_SCRIPTED_HARD)
    step = jax_step(jspec)
    acts = noop(4, 2)
    jacts = {k: jnp.asarray(v) for k, v in acts.items()}
    pacts = {k: torch.from_numpy(v) for k, v in acts.items()}
    for t in range(160):
        jit = step_jitter(jspec, jstate)
        jstate = step(jstate, jacts)
        pstate = S.step(pspec, pstate, pacts, jitter=jit)
        if t % 40 == 39 or t == 139:
            assert_states_close(pstate, jstate, f"t={t + 1}")
    assert int(np.asarray(jstate.last_hits).sum()) > 0    # the horizon had combat


def test_agent_driven_horizon():
    """Random hero actions for the agent player (attack, cast, move) resolve
    identically."""
    jspec, pspec, jstate, pstate = world(4, pb.CONTROL_AGENT, pb.CONTROL_SCRIPTED_HARD, seed=1)
    step = jax_step(jspec)
    rng = np.random.default_rng(0)
    for t in range(60):
        acts = noop(4, 2)
        acts["type"][:, 0] = rng.integers(0, 4, size=4)
        acts["move_x"][:, 0] = rng.integers(0, 9, size=4)
        acts["move_y"][:, 0] = rng.integers(0, 9, size=4)
        acts["target_slot"][:, 0] = rng.integers(0, 32, size=4)
        jit = step_jitter(jspec, jstate)
        jstate = step(jstate, {k: jnp.asarray(v) for k, v in acts.items()})
        pstate = S.step(pspec, pstate, {k: torch.from_numpy(v) for k, v in acts.items()}, jitter=jit)
    assert_states_close(pstate, jstate, "agent-driven t=60")


def test_selfplay_step_without_scripted_bots():
    jspec, pspec, jstate, pstate = world(4, pb.CONTROL_AGENT, pb.CONTROL_AGENT, seed=2)
    step = jax_step(jspec, scripted=False)
    rng = np.random.default_rng(1)
    for _ in range(30):
        acts = {k: rng.integers(0, 9, size=(4, 2)).astype(np.int32)
                for k in ("type", "move_x", "move_y", "target_slot", "ability")}
        acts["type"] %= 4
        jit = step_jitter(jspec, jstate)
        jstate = step(jstate, {k: jnp.asarray(v) for k, v in acts.items()})
        pstate = S.step(pspec, pstate, {k: torch.from_numpy(v) for k, v in acts.items()},
                        scripted_possible=False, jitter=jit)
    assert_states_close(pstate, jstate, "selfplay t=30")


def test_reset_where_and_timeout():
    """Games time out at a short horizon; reset_where then re-draws the
    done games and keeps the rest."""
    jspec, pspec, jstate, pstate = world(4, pb.CONTROL_SCRIPTED_EASY, pb.CONTROL_SCRIPTED_HARD,
                                         max_dota_time=6.0, seed=3)
    step = jax_step(jspec)
    acts = noop(4, 2)
    for _ in range(31):
        jit = step_jitter(jspec, jstate)
        jstate = step(jstate, {k: jnp.asarray(v) for k, v in acts.items()})
        pstate = S.step(pspec, pstate, {k: torch.from_numpy(v) for k, v in acts.items()}, jitter=jit)
    assert np.asarray(jstate.done).all() and pstate.done.all()
    assert_states_close(pstate, jstate, "timed out")
    mask = np.array([True, False, True, False])
    jit = reset_jitter(jspec, jstate)
    jstate = jax.jit(lambda s, m: J.reset_where(jspec, s, m))(jstate, jnp.asarray(mask))
    pstate = S.reset_where(pspec, pstate, torch.from_numpy(mask), jitter=jit)
    assert_states_close(pstate, jstate, "after reset_where")
    assert not pstate.done[0] and pstate.done[1]


def test_generator_jitter_is_seeded_and_in_range():
    _, pspec = specs(3)
    hero = torch.ones(3, 2, dtype=torch.int32)
    ctrl = torch.ones(3, 2, dtype=torch.int32)
    a, b = (S.init_state(pspec, hero, ctrl, generator=torch.Generator().manual_seed(7)) for _ in range(2))
    torch.testing.assert_close(a.y, b.y, rtol=0, atol=0)
    creeps = a.unit_type == 2
    assert creeps.any() and (a.y[creeps].abs() <= 40.0).all()


# -- featurizer and reward -----------------------------------------------------


def feat_pair(jspec, pspec, players):
    cfg, pcfg = default_config(), port_default_config()
    return (JF.JaxFeaturizer(jspec, cfg.obs, cfg.actions, players),
            TF.TorchFeaturizer(pspec, pcfg.obs, pcfg.actions, players, torch.device("cpu")))


@pytest.mark.parametrize("players", [[0], [1], [0, 1]], ids=["radiant", "dire", "selfplay"])
def test_featurize_and_rewards_match(players):
    """Observations within 1e-6 (bools and ints equal), every reward term
    within 1e-6, and the folded reward bitwise, on the same pair of
    states."""
    jspec, pspec, jstate, _ = world(4, pb.CONTROL_SCRIPTED_EASY, pb.CONTROL_SCRIPTED_HARD, seed=5)
    jf, pf = feat_pair(jspec, pspec, players)
    step = jax_step(jspec)
    acts = {k: jnp.asarray(v) for k, v in noop(4, 2).items()}
    featurize = jax.jit(jf.featurize)
    for t in range(120):
        prev = jstate
        jstate = step(jstate, acts)
        if t % 40 != 39:
            continue
        want_obs = featurize(jstate)
        got_obs = pf.featurize(to_port(jstate))
        for k, want in want_obs.items():
            got, want = got_obs[k].numpy(), np.asarray(want)
            assert got.dtype == want.dtype, k
            if want.dtype == np.float32:
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=k)
            else:
                np.testing.assert_array_equal(got, want, err_msg=k)
        want_terms = JF.shaped_reward_terms(jspec, players, prev, jstate)
        got_terms = TF.shaped_reward_terms(pspec, players, to_port(prev), to_port(jstate))
        assert list(got_terms) == list(want_terms)
        for k in want_terms:
            np.testing.assert_allclose(got_terms[k].numpy(), np.asarray(want_terms[k]), rtol=0, atol=1e-6,
                                       err_msg=k)
        np.testing.assert_array_equal(TF.fold_terms(got_terms).numpy(),
                                      np.asarray(jax_fold_terms(want_terms)))


@pytest.mark.parametrize("players", [[0], [1], [0, 1]], ids=["radiant", "dire", "selfplay"])
def test_actions_to_sim_matches(players):
    jspec, pspec, _, _ = world(4, pb.CONTROL_AGENT, pb.CONTROL_SCRIPTED_EASY)
    jf, pf = feat_pair(jspec, pspec, players)
    rng = np.random.default_rng(len(players))
    packed = np.stack([rng.integers(0, n, size=4 * len(players)) for n in (4, 9, 9, 32, 4)], 1).astype(np.int32)
    want = jf.actions_to_sim(jnp.asarray(packed))
    got = pf.actions_to_sim(torch.from_numpy(packed))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_featurizer_refuses_non_contiguous_players():
    _, pspec = specs(2, team_size=2)
    with pytest.raises(ValueError):
        TF.player_slice([0, 2])


# -- whole episodes: statistics, not trajectories ------------------------------


def full_episodes(team_size, n=16, max_dota_time=300.0, max_steps=1600, seed=0):
    """``n`` games of scripted easy (Radiant) against scripted hard (Dire),
    every hero Shadow Fiend, played by the port's sim with its own seeded
    creep jitter until every game ends or ``max_steps`` steps."""
    _, pspec = specs(n, team_size, max_dota_time)
    P = 2 * team_size
    hero = torch.ones(n, P, dtype=torch.int32)
    ctrl = torch.full((n, P), pb.CONTROL_SCRIPTED_EASY, dtype=torch.int32)
    ctrl[:, team_size:] = pb.CONTROL_SCRIPTED_HARD
    gen = torch.Generator().manual_seed(seed)
    state = S.init_state(pspec, hero, ctrl, generator=gen)
    acts = {k: torch.from_numpy(v) for k, v in noop(n, P).items()}
    for _ in range(max_steps):
        state = S.step(pspec, state, acts, generator=gen)
        if bool(state.done.all()):
            break
    return state


def test_full_episode_statistics():
    """The counterpart of ``tests/test_jax_sim.py``'s
    ``test_full_episode_statistics``, at its thresholds: over whole 300 s
    games (waves spawn, so the jitter draws differ from the reference's and
    trajectories part) hard still beats easy and every game ends."""
    from dotaclient_tpu_torch.envs.lane_sim import TEAM_DIRE

    state = full_episodes(team_size=1)
    assert bool(state.done.all())
    # timeout wins are tower-HP noisy (hard retreats, easy pushes); kills
    # are the robust dominance signal
    hard_wins = int((state.winning_team == TEAM_DIRE).sum())
    assert hard_wins >= 7
    assert int(state.kills[:, 1].sum()) > 5 * int(state.kills[:, 0].sum())


def test_full_episodes_end_at_team_size_2():
    """The same games at 2v2 (BASELINE config 4's team size): every game
    ends inside the step budget."""
    state = full_episodes(team_size=2)
    assert bool(state.done.all())
