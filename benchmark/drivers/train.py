"""The training driver: the port's fused learner on the cell's traffic.

Set-up builds one ``Learner``, hands it the weights drawn from the seed (the
live policy and the league's opening snapshot), and drives it through its
first ``checked_iterations`` iterations with one ``train`` call, recording
what those iterations produced: each update's loss, the first gradient as
Adam holds it, the params after the last of them, and every action the
rollouts sampled (both sides'). The window is one long ``train`` call that
a wrapper around the fused step stops at the first iteration boundary past
``--seconds``: trained frames over the call's wall time. A traced run then
profiles ``profiled_iterations`` more iterations inside the same call.

The check runs after the learner is closed and freed: the plain reference
follows the recorded actions from the same seed and weights, and the
numbers of ``reference.train.compare`` are held to the cell's limits.
"""

from __future__ import annotations

import dataclasses
import statistics
import sys
import time
from typing import Any, Dict, List, Optional

import torch

from benchmark import yardstick
from benchmark.cells import Cell, run_config
from benchmark.drivers.common import Outcome, free, peak_bytes, sync
from benchmark.reference import train as ref_train
from benchmark.reference.precision import strict_float32
from benchmark.trace import Profiler
from benchmark.weights import make_weights, param_shapes


class Malformed(RuntimeError):
    """The program does not match the cell's configuration."""


def reference_setup(cfg) -> ref_train.Setup:
    """The reference's settings, read off the run's configuration values."""
    env, ppo, lg = cfg.env, cfg.ppo, cfg.league
    if ppo.advantage != "gae" or ppo.adv_norm != "batch" or ppo.epochs_per_batch != 1 or ppo.minibatches > 1:
        raise NotImplementedError("the reference writes out one GAE update a chunk with batch-normalised advantages")
    if ppo.anchor_kl_coef or ppo.kl_target or ppo.value_warmup_steps or lg.anchor_prob:
        raise NotImplementedError("anchor KL, the KL-adaptive rate, the value warm-up and anchor games are not "
                                  "part of the reference")
    return ref_train.Setup(
        n_games=env.n_envs, team_size=env.team_size, hero_pool=tuple(env.hero_pool), opponent=env.opponent,
        max_dota_time=env.max_dota_time, ticks_per_obs=env.ticks_per_observation, max_units=cfg.obs.max_units,
        global_features=cfg.obs.global_features, n_action_types=cfg.actions.n_action_types,
        move_bins=cfg.actions.move_bins, max_abilities=cfg.actions.max_abilities, rollout_len=ppo.rollout_len,
        gamma=ppo.gamma, gae_lambda=ppo.gae_lambda, clip_eps=ppo.clip_eps, value_coef=ppo.value_coef,
        entropy_coef=ppo.entropy_coef, learning_rate=ppo.learning_rate, max_grad_norm=ppo.max_grad_norm,
        adv_norm_floor=ppo.adv_norm_floor, selfplay_prob=lg.selfplay_prob, reward=dict(cfg.reward.as_dict()))


class Recorder:
    """Wraps the learner's fused step and its featurizers' action
    translation for the checked iterations."""

    def __init__(self, learner, n_iters: int) -> None:
        self.learner, self.n = learner, n_iters
        self.losses: List[torch.Tensor] = []
        self.grad1: Dict[str, torch.Tensor] = {}
        self.params: Dict[str, torch.Tensor] = {}
        self.learner_acts: List[torch.Tensor] = []
        self.opp_acts: List[torch.Tensor] = []
        actor = learner.device_actor
        self._feats = [(actor.feat, self.learner_acts)]
        if actor._opp_feat is not None:
            self._feats.append((actor._opp_feat, self.opp_acts))
        for feat, sink in self._feats:
            feat.actions_to_sim = self._recording(feat.actions_to_sim, sink)
        self._orig = learner.fused_step
        learner.fused_step = self._step

    @staticmethod
    def _recording(fn, sink):
        def wrapped(packed):
            sink.append(packed.detach().to(torch.int32).clone())
            return fn(packed)
        return wrapped

    def _step(self, state, actor_state, *args, **kwargs):
        out = self._orig(state, actor_state, *args, **kwargs)
        new_state, _, m, _ = out
        self.losses.append(m["loss"].detach().clone())
        named = list(new_state.policy.named_parameters())
        if len(self.losses) == 1:
            opt = new_state.optimizer
            beta1 = opt.param_groups[0]["betas"][0]
            # no moment means Adam never got a gradient: a zero one
            self.grad1 = {n: (opt.state[p]["exp_avg"].detach().clone() if "exp_avg" in opt.state.get(p, {})
                              else torch.zeros_like(p)) / (1.0 - beta1) for n, p in named}
        if len(self.losses) == self.n:
            self.params = {n: p.detach().clone() for n, p in named}
        return out

    def detach(self) -> List[List[Dict[str, torch.Tensor]]]:
        """Restore the learner; returns the actions per iteration and step."""
        self.learner.fused_step = self._orig
        for feat, _ in self._feats:
            del feat.actions_to_sim
        T = self.learner.config.ppo.rollout_len
        out = []
        for it in range(self.n):
            steps = []
            for t in range(T):
                k = it * T + t
                step = {"learner": self.learner_acts[k]}
                if self.opp_acts:
                    step["opponent"] = self.opp_acts[k]
                steps.append(step)
            out.append(steps)
        return out


class Pacer:
    """The window's wrapper around the fused step: it stamps each call,
    keeps each update's health verdict, profiles the last calls of a traced
    run and asks the learner to stop at the first boundary past the end."""

    def __init__(self, learner, t_end: float, profiled: int) -> None:
        self.learner, self.t_end, self.profiled = learner, t_end, profiled
        self.starts: List[float] = []
        self.health: List[torch.Tensor] = []
        self.first_profiled: Optional[int] = None
        self.profile = None
        self._profiler = Profiler()
        self._orig = learner.fused_step
        learner.fused_step = self._step

    def _step(self, *args, **kwargs):
        t = time.perf_counter()
        self.starts.append(t)
        if self.profiled and self.first_profiled is None and t >= self.t_end:
            self.first_profiled = len(self.starts) - 1
            self._profiler.start()
        out = self._orig(*args, **kwargs)
        if "health_ok" in out[2]:
            self.health.append(out[2]["health_ok"])
        if self.first_profiled is not None:
            if len(self.starts) - self.first_profiled == self.profiled:
                self.profile = self._profiler.stop()
                self.learner.request_stop()
        elif not self.profiled and time.perf_counter() >= self.t_end:
            self.learner.request_stop()
        return out

    def detach(self) -> None:
        self.learner.fused_step = self._orig


def build(cell: Cell, seed: int, device: torch.device, plant=None):
    """The learner of the cell, holding the weights drawn from the seed:
    (learner, run config, the reference's settings, the weights)."""
    from dotaclient_tpu_torch.train.learner import Learner

    cfg = run_config(cell, seed)
    setup = reference_setup(cfg)
    learner = Learner(cfg, actor=cell.traffic["actor"], seed=seed, device=device)
    if plant is not None:
        plant(learner)
    shapes = param_shapes(cell.config, dataclasses.asdict(cfg.obs), dataclasses.asdict(cfg.actions), value_head=True)
    have = {n: tuple(p.shape) for n, p in learner.policy.named_parameters()}
    if have != shapes:
        learner.close()
        raise Malformed(f"the policy's parameters {have} are not the configuration's {shapes}")
    w0 = make_weights(shapes, seed, device)
    with torch.no_grad():
        for n, p in learner.policy.named_parameters():
            p.copy_(w0[n])
        for snap in (learner.league.snapshots if learner.league is not None else []):
            for n, v in snap.params.items():
                v.copy_(w0[n])
    return learner, cfg, setup, w0


def first_iterations(learner, n: int):
    """The checked iterations through one ``train`` call: (losses, the first
    gradient, the params after them, the actions per iteration and step)."""
    rec = Recorder(learner, n)
    learner.train(n)
    actions = rec.detach()
    return [float(x) for x in rec.losses], rec.grad1, rec.params, actions


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device, t_start: float,
        plant=None) -> Outcome:
    tr = cell.traffic
    n_check = int(tr["checked_iterations"])
    t_build = time.perf_counter()
    learner, cfg, setup, w0 = build(cell, seed, device, plant)
    t_first = time.perf_counter()
    prog_losses, prog_grad1, prog_params, actions = first_iterations(learner, n_check)
    sync(device)

    actor = learner.device_actor
    L = actor.n_lanes * actor.lane_shards
    Lo = actor.n_opp_lanes if actor._opp_feat is not None else 0
    T, H = cfg.ppo.rollout_len, cfg.model.hidden_dim
    n_prof = int(tr.get("profiled_iterations", 2)) if trace else 0
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    print(f"bench: set-up {setup_s:.2f} s: start and imports {t_build - t_start:.2f}, learner and weights "
          f"{t_first - t_build:.2f}, {n_check} checked iterations {t0 - t_first:.2f}", file=sys.stderr)
    pacer = Pacer(learner, t0 + seconds, n_prof)
    out = learner.train(10 ** 12)
    window_s = time.perf_counter() - t0
    pacer.detach()
    frames = float(out["frames_trained"])
    health = [float(h) for h in pacer.health]
    peak = peak_bytes(device)
    learner.close()
    del learner, actor
    free(device)

    fwd = yardstick.policy_forward_flops(cell.config, dataclasses.asdict(cfg.obs), dataclasses.asdict(cfg.actions),
                                         value_head=True)
    iter_flops = fwd * ((L + Lo) * T + 3 * L * (T + 1))
    timed = pacer.starts if pacer.first_profiled is None else pacer.starts[:pacer.first_profiled + 1]
    intervals = [b - a for a, b in zip(timed, timed[1:])]
    per_iter = [(L, 1, H, H)] + ([(Lo, 1, H, H)] if Lo else [])
    ctx: Dict[str, Any] = {
        "family": "train",
        "iteration_median_s": statistics.median(intervals) if intervals else None,
        "model_flops": iter_flops * len(intervals),
        "model_seconds": sum(intervals),
        "profiled_lstm_launches": (per_iter * T + [(L, T + 1, H, H)]) * n_prof,
        "profiled_calls": n_prof,
    }
    print(f"bench: window {window_s:.2f} s, {len(pacer.starts)} iterations, {frames:.0f} frames; iterations (ms): "
          + " ".join(f"{1e3 * x:.0f}" for x in intervals), file=sys.stderr)

    t_ref = time.perf_counter()
    strict_float32()
    judge = ref_train.follow(setup, w0, seed, n_check, actions=actions)
    compared = ref_train.compare(prog_losses, prog_grad1, prog_params, judge, w0)
    print(f"bench: reference {time.perf_counter() - t_ref:.2f} s; losses {prog_losses} / {judge.losses}",
          file=sys.stderr)
    return Outcome(
        end_to_end={"trained_frames_per_s": frames / window_s, "setup_s": setup_s},
        attempted=len(pacer.starts), failed=sum(1 for h in health if h < 1.0), compared=compared,
        memory_peak_bytes=peak, profile=pacer.profile, ctx=ctx)
