"""The port's device rollout, fused iteration and learner.

The rollout is held against the JAX package's ``DeviceActor._rollout_impl``
from the same world and params, fed the same randomness: the test replays
JAX's per-game key stream to get the Gumbel noise of every head and the
creep-wave jitter it drew, and hands both to the port. Actions, dones and
stats must be equal; observations, rewards and log-probs agree within 1e-5
at f32 compute. The fused iteration is held against the port's own
collect-then-train, as ``tests/test_fused.py`` holds the JAX one.
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotaclient_tpu.actor.device_rollout import DeviceActor as JaxDeviceActor
from dotaclient_tpu.models import distributions as JD
from dotaclient_tpu_torch.actor.device_rollout import DeviceActor
from dotaclient_tpu_torch.envs import torch_lane_sim as S
from dotaclient_tpu_torch.models.policy import init_params, make_policy
from dotaclient_tpu_torch.train import fused as pfused
from dotaclient_tpu_torch.train import learner as plearner
from dotaclient_tpu_torch.train import ppo as pppo
from tests.test_torch_common import flax_params, jax_policy, port_policy, small_configs

ATOL = 1e-5
N_ENVS, T = 2, 3


def rollout_configs(opponent, max_dota_time=0.4):
    """A tiny game (0.4 s = 2 steps, so every game ends and resets inside
    a 3-step chunk) at the small f32 model."""
    out = []
    for cfg in small_configs():
        out.append(dataclasses.replace(
            cfg,
            ppo=dataclasses.replace(cfg.ppo, rollout_len=T),
            env=dataclasses.replace(cfg.env, n_envs=N_ENVS, opponent=opponent, max_dota_time=max_dota_time),
            log_every=1,
        ))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def jax_randomness(jcfg, n_lanes, n_opp_lanes=0):
    """Jitted: (per-game keys [N, 2], sim key) -> the noise of every head
    of the learner lanes [T, L, n] (from ``ks[:, 1]``), of the opponent
    lanes [T, L_opp, n] (from ``ks[:, 2]``; None without them) and the
    step and reset jitter [T, 2, N, C] that T steps of ``_rollout_impl``
    draw."""
    N = jcfg.env.n_envs
    C = (jcfg.obs.max_units - (2 * jcfg.env.team_size + 2)) // 2
    sizes = dict(jcfg.actions.head_sizes)

    def from_sub(sub):
        return jnp.stack([jax.random.uniform(jax.random.fold_in(sub, i), (N, C), minval=-40.0, maxval=40.0)
                          for i in range(2)])

    def side_noise(keys, lanes):
        A = lanes // N

        def game_noise(k):
            ks = jax.random.split(k, 5)
            return {h: jax.random.gumbel(kh, (A, sizes[h]), jnp.float32) for h, kh in zip(JD.HEADS, ks)}

        per_game = jax.vmap(game_noise)(keys)
        return {h: per_game[h].reshape(N * A, -1) for h in JD.HEADS}

    def one_step(carry, _):
        keys, sim_key = carry
        ks = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
        keys = ks[:, 0]
        noise = side_noise(ks[:, 1], n_lanes)
        opp_noise = side_noise(ks[:, 2], n_opp_lanes) if n_opp_lanes else {}
        sim_key, sub = jax.random.split(sim_key)
        j_step = from_sub(sub)
        sim_key, sub = jax.random.split(sim_key)
        j_reset = from_sub(jax.random.split(sub)[1])
        return (keys, sim_key), (noise, opp_noise, {"step": j_step, "reset": j_reset})

    def draw(keys, sim_key):
        _, (noise, opp_noise, jitter) = jax.lax.scan(one_step, (keys, sim_key), None,
                                                     length=jcfg.ppo.rollout_len)
        return noise, opp_noise or None, jitter

    return jax.jit(draw)


def to_np(tree):
    if isinstance(tree, dict):
        return {k: to_np(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_np(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return np.asarray(tree)


def assert_tree_close(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_tree_close(got[k], want[k], f"{path}/{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=path)
    else:
        np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("opponent", ["scripted_easy", "selfplay"])
def test_rollout_chunk_matches_jax(opponent):
    jcfg, pcfg = rollout_configs(opponent)
    params = flax_params(jcfg, seed=3)
    jpolicy = jax_policy(jcfg)[0]
    jactor = JaxDeviceActor(jcfg, jpolicy, seed=5)
    jparams = jax.tree.map(jnp.asarray, params)
    js = jactor.state
    noise, _, jitter = jax_randomness(jcfg, jactor.n_lanes)(js.key, js.sim.key)
    j_new, j_chunk, j_stats = jax.jit(jactor._rollout_impl)(jparams, js, jparams)

    policy = port_policy(pcfg, params)
    actor = DeviceActor(pcfg, policy, seed=5, device="cpu")
    assert actor.n_lanes == jactor.n_lanes
    actor.state.sim = S.SimState(**{k: torch.from_numpy(np.array(getattr(js.sim, k))) for k in S.FIELDS})
    with torch.no_grad():
        p_new, p_chunk, p_stats = actor._rollout_impl(
            policy, actor.state,
            noise={h: torch.from_numpy(np.array(v)) for h, v in noise.items()},
            jitter={k: torch.from_numpy(np.array(v)) for k, v in jitter.items()},
        )
    got, want = to_np(p_chunk), to_np(j_chunk)
    assert float(want["dones"].sum()) > 0           # episodes ended inside the chunk
    for h in JD.HEADS:
        np.testing.assert_array_equal(got["actions"][h], want["actions"][h], err_msg=h)
    np.testing.assert_array_equal(got["dones"], want["dones"])
    for k in ("rewards", "behavior_logp", "valid"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL, err_msg=k)
    assert_tree_close(got["obs"], want["obs"], "obs")
    for g, w in zip(got["carry0"], want["carry0"]):
        np.testing.assert_array_equal(g, w)
    assert_tree_close(to_np(p_stats), to_np(j_stats), "stats")
    for k in S.FIELDS:
        w = np.asarray(getattr(j_new.sim, k))
        g = getattr(p_new.sim, k).numpy()
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-3, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    for g, w in zip(p_new.carry, j_new.carry):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)
    np.testing.assert_allclose(p_new.ep_return.numpy(), np.asarray(j_new.ep_return), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(p_new.ep_steps.numpy(), np.asarray(j_new.ep_steps))


# -- the fused iteration (port only) ------------------------------------------


def port_setup(opponent="scripted_easy", max_dota_time=60.0, seed=3, **ppo):
    _, pcfg = rollout_configs(opponent, max_dota_time)
    pcfg = dataclasses.replace(pcfg, ppo=dataclasses.replace(pcfg.ppo, **ppo))
    policy = make_policy(pcfg.model, pcfg.obs, pcfg.actions, device="cpu")
    init_params(policy, torch.Generator().manual_seed(seed))
    actor = DeviceActor(pcfg, policy, seed=seed, device="cpu")
    return pcfg, pppo.init_train_state(policy, pcfg.ppo), actor


def test_fused_equals_collect_then_train():
    cfg, state, actor = port_setup(max_dota_time=0.4)
    actor_state0 = copy.deepcopy(actor.state)
    gen0 = actor.generator.get_state()

    ref_state = state.clone()
    with torch.no_grad():
        ref_actor, chunk, _ = actor._rollout_impl(ref_state.policy, copy.deepcopy(actor_state0))
    ref_state, ref_m = pppo._train_step(cfg.ppo, ref_state, chunk)

    actor.generator.set_state(gen0)
    fused = pfused.make_fused_step(cfg, actor)
    got_state, got_actor, m, stats = fused(state.clone(), copy.deepcopy(actor_state0))
    assert got_state.step == 1
    np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]), rtol=1e-5)
    for (name, g), w in zip(got_state.policy.state_dict().items(), ref_state.policy.state_dict().values()):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6, msg=name)
    for k in S.FIELDS:
        torch.testing.assert_close(getattr(got_actor.sim, k), getattr(ref_actor.sim, k), rtol=1e-5, atol=1e-6)
    assert float(stats["episodes"].sum()) > 0


def test_fused_epochs_and_minibatches():
    """epochs_per_batch=2 x minibatches=2: four updates per call, and every
    lane lands in exactly one minibatch of each epoch."""
    cfg, state, actor = port_setup(opponent="selfplay", epochs_per_batch=2, minibatches=2)
    L = actor.n_lanes
    fused = pfused.make_fused_step(cfg, actor)
    state, actor.state, m, _ = fused(state, actor.state)
    assert state.step == 4 and state.version == 4
    assert float(m["health_ok"]) == 1.0 and np.isfinite(float(m["loss"]))

    lanes = {"rewards": torch.arange(L).float()[:, None], "carry0": (torch.arange(L), torch.arange(L))}
    for step in (0, 2):
        mbs = pfused.lane_minibatches(lanes, step, cfg.seed, L, 2)
        ids = torch.cat([mb["rewards"][:, 0] for mb in mbs]).long()
        assert sorted(ids.tolist()) == list(range(L))
        assert all(torch.equal(mb["carry0"][0], mb["rewards"][:, 0].long()) for mb in mbs)
    again = pfused.lane_minibatches(lanes, 0, cfg.seed, L, 2)
    assert torch.equal(again[0]["rewards"], pfused.lane_minibatches(lanes, 0, cfg.seed, L, 2)[0]["rewards"])


def test_fused_steps_per_dispatch():
    cfg, state, actor = port_setup()
    cfg = dataclasses.replace(cfg, steps_per_dispatch=2)
    fused = pfused.make_fused_step(cfg, actor)
    tick0 = actor.state.sim.tick.clone()
    state, actor.state, m, stats = fused(state, actor.state)
    assert state.step == 2
    torch.testing.assert_close(actor.state.sim.tick, tick0 + 2 * T * cfg.env.ticks_per_observation)
    assert stats["episodes"].shape == (N_ENVS,)


def test_fused_refuses_indivisible_minibatches():
    cfg, _, actor = port_setup(minibatches=3)
    with pytest.raises(ValueError, match="divisible"):
        pfused.make_fused_step(cfg, actor)


# -- the learner ----------------------------------------------------------------


def test_learner_trains_with_frame_accounting():
    _, cfg = rollout_configs("scripted_easy", max_dota_time=0.4)
    learner = plearner.Learner(cfg, actor="fused", seed=1, device="cpu")
    out = learner.train(2)
    assert out["optimizer_steps"] == 2.0
    # the train batch is the lane set, not batch_rollouts
    assert out["frames_trained"] == 2 * learner.device_actor.n_lanes * T
    assert np.isfinite(out["loss"]) and out["health_ok"] == 1.0
    assert out["actor_episodes_done"] > 0 and out["actor_env_steps"] == out["frames_trained"]
    assert learner.state.step == 2


def test_learner_refuses_what_is_not_ported():
    _, cfg = rollout_configs("scripted_easy")
    # every actor mode is ported: the scalar pool is built (it refuses
    # league mode, which needs opponent lanes), and the external mode
    # needs a transport
    scalar = plearner.Learner(cfg, actor="scalar", device="cpu")
    assert scalar.pool is scalar.host_pool and scalar.host_pool.n_lanes == cfg.env.n_envs
    scalar.close()
    with pytest.raises(ValueError, match="needs a transport"):
        plearner.Learner(cfg, actor="external", device="cpu")
    # league mode is ported: it builds its frozen-opponent pool instead
    league = dataclasses.replace(cfg, env=dataclasses.replace(cfg.env, opponent="league"))
    assert len(plearner.Learner(league, actor="fused", device="cpu").league) == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            plearner.Learner(cfg, actor="fused")


def test_learner_smoke_cli_on_cpu(capsys):
    # the default actor is the buffered learner: one step trains one batch
    # of batch_rollouts (8) chunks of rollout_len (8)
    assert plearner.main(["--smoke", "--steps", "1", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(f"done: 1 steps, {8 * 8} frames, ")
    assert plearner.main(["--smoke", "--steps", "1", "--actor", "fused", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(f"done: 1 steps, {4 * 8} frames, ")
