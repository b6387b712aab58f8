"""The first iterations of self-play PPO, written out: rollouts of the lane
game under the policy (the learner's players, and in a league game the
opponent's players under a frozen snapshot or the live policy), then one
clipped-surrogate update on the chunk with GAE, batch-normalised advantages,
the value loss and the entropy bonus, the gradient clipped to a global norm
and Adam.

``follow`` plays the part of the program (it samples its own actions) or of
the judge (it takes the program's actions and reports how far each lies
below what its own noisy scores would pick). The randomness is the run's:
one generator on the device seeded with the run seed, drawn first for the
opening creep wave, then for each rollout step in the order the learner
lanes' five Gumbel arrays, the opponent lanes' five, the step's wave jitter
and the reset's; the league's first draw (mirror or snapshot) is numpy's
generator seeded with the run seed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from benchmark.reference import policy as P
from benchmark.reference.game import Game, Layout, Side, draft
from benchmark.reference.precision import Arith

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class Setup:
    """What one training cell runs, from its configuration and traffic."""

    n_games: int
    team_size: int
    hero_pool: Sequence[int]
    opponent: str                 # "league" or "selfplay"
    max_dota_time: float
    ticks_per_obs: int
    max_units: int
    global_features: int
    n_action_types: int
    move_bins: int
    max_abilities: int
    rollout_len: int
    gamma: float
    gae_lambda: float
    clip_eps: float
    value_coef: float
    entropy_coef: float
    learning_rate: float
    max_grad_norm: float
    adv_norm_floor: float
    selfplay_prob: float
    reward: Mapping[str, float]

    @property
    def layout(self) -> Layout:
        return Layout(self.n_games, self.team_size, self.max_units, self.ticks_per_obs, self.max_dota_time,
                      self.move_bins)

    @property
    def head_sizes(self) -> Dict[str, int]:
        return {"action_type": self.n_action_types, "move_x": self.move_bins, "move_y": self.move_bins,
                "target_unit": self.max_units, "ability": self.max_abilities}


class Stream:
    """The run's device generator, drawn as the program draws it."""

    def __init__(self, seed: int, lay: Layout, device: torch.device) -> None:
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        self.lay, self.device = lay, device

    def jitter(self) -> torch.Tensor:
        u = torch.rand((2, self.lay.n_games, self.lay.creeps), generator=self.gen, device=self.device)
        return u * 80.0 - 40.0

    def gumbel(self, shape) -> torch.Tensor:
        u = torch.rand(shape, generator=self.gen, device=self.device, dtype=torch.float32)
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))


@dataclasses.dataclass
class Followed:
    losses: List[float]
    grad1: Dict[str, torch.Tensor]       # the clipped gradient of the first update, as Adam got it
    params: Dict[str, torch.Tensor]      # after the last update
    action_gap: float                    # widest gap of a given action below the reference's pick
    actions: List[List[Dict[str, torch.Tensor]]]   # per iteration, per step: {"learner", "opponent"} [lanes, 5]


def _packed(acts: Mapping[str, torch.Tensor]) -> torch.Tensor:
    return torch.stack([acts[h] for h in P.HEADS], dim=1).to(torch.int32)


def _unpack(packed: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {h: packed[:, j].long() for j, h in enumerate(P.HEADS)}


def follow(setup: Setup, params0: Mapping[str, torch.Tensor], seed: int, iterations: int,
           arith: Optional[Arith] = None, actions: Optional[Sequence[Sequence[Mapping[str, torch.Tensor]]]] = None,
           fault: Optional[str] = None) -> Followed:
    """``iterations`` rollouts and updates from ``params0``. ``actions``
    (per iteration, per step, ``{"learner": [L, 5], "opponent": [Lo, 5]}``)
    are followed instead of sampled. ``fault`` plants one in this run:
    ``"half_batch"`` (the update sees the first half of the lanes, its means
    over them) or ``"altered_action"`` (lane 0's first action type of each
    iteration replaced)."""
    ar = arith or Arith("float32")
    dev = next(iter(params0.values())).device
    lay = setup.layout
    if setup.opponent not in ("league", "selfplay"):
        raise NotImplementedError(f"opponent {setup.opponent!r}: scripted bots are not part of the reference")
    league = setup.opponent == "league"
    learners = list(range(setup.team_size)) if league else list(range(lay.players))
    opponents = list(range(setup.team_size, lay.players)) if league else []
    hero_ids = torch.from_numpy(draft(lay.n_games, setup.team_size, setup.hero_pool, seed)).to(dev)
    game = Game(lay, hero_ids)
    side = Side(lay, learners, setup.n_action_types, setup.max_abilities, setup.global_features, dev)
    oside = Side(lay, opponents, setup.n_action_types, setup.max_abilities, setup.global_features, dev) if opponents else None
    stream = Stream(seed, lay, dev)
    state = game.fresh(stream.jitter())
    # the league's opening draw: the mirror (the live policy) or the one
    # snapshot there is, the initial params
    mirror = league and bool(np.random.default_rng(seed).random() < setup.selfplay_prob)
    params = {k: v.detach().clone().float() for k, v in params0.items()}
    snapshot = {k: v.detach().clone().float() for k, v in params0.items()}
    H = params["core.wh"].shape[0]
    L, A = side.lanes, len(learners)
    h = torch.zeros(L, H, device=dev)
    c = torch.zeros(L, H, device=dev)
    Lo = oside.lanes if oside else 0
    oh = torch.zeros(Lo, H, device=dev)
    oc = torch.zeros(Lo, H, device=dev)
    m1 = {k: torch.zeros_like(v) for k, v in params.items()}
    m2 = {k: torch.zeros_like(v) for k, v in params.items()}
    sizes = setup.head_sizes
    T = setup.rollout_len
    losses: List[float] = []
    grad1: Dict[str, torch.Tensor] = {}
    widest = torch.zeros((), device=dev)
    played: List[List[Dict[str, torch.Tensor]]] = []
    for it in range(iterations):
        opp_params = params if mirror else snapshot
        h0, c0 = h.clone(), c.clone()
        rec: Dict[str, list] = {"obs": [], "act": [], "logp": [], "rew": [], "done": []}
        steps: List[Dict[str, torch.Tensor]] = []
        with torch.no_grad():
            for t in range(T):
                noise = {k: stream.gumbel((L, sizes[k])) for k in P.HEADS}
                onoise = {k: stream.gumbel((Lo, sizes[k])) for k in P.HEADS} if oside else None
                jit_step, jit_reset = stream.jitter(), stream.jitter()
                obs = side.observe(state, hero_ids)
                logits, _, h, c = P.step(ar, params, obs, h, c)
                lps = P.head_logps(logits, obs)
                acts = _unpack(actions[it][t]["learner"]) if actions is not None else P.sample(lps, noise)
                if fault == "altered_action" and t == 0:
                    acts = {k: v.clone() for k, v in acts.items()}
                    acts["action_type"][0] = (acts["action_type"][0] + 1) % setup.n_action_types
                widest = torch.maximum(widest, P.action_gaps(lps, noise, acts).amax())
                game_acts = side.to_game(acts)
                step_rec = {"learner": _packed(acts)}
                if oside is not None:
                    oobs = oside.observe(state, hero_ids)
                    ologits, _, oh, oc = P.step(ar, opp_params, oobs, oh, oc)
                    olps = P.head_logps(ologits, oobs)
                    oacts = (_unpack(actions[it][t]["opponent"]) if actions is not None else P.sample(olps, onoise))
                    widest = torch.maximum(widest, P.action_gaps(olps, onoise, oacts).amax())
                    theirs = oside.to_game(oacts)
                    hi = torch.zeros(lay.players, dtype=torch.bool, device=dev)
                    hi[opponents] = True
                    game_acts = {k: torch.where(hi[None, :], theirs[k], v) for k, v in game_acts.items()}
                    step_rec["opponent"] = _packed(oacts)
                steps.append(step_rec)
                after = game.step(state, game_acts, jit_step)
                r = side.reward(state, after, setup.reward)
                done = after["done"]
                state = game.reset_where(after, done, jit_reset)
                keep = 1.0 - done[:, None].expand(lay.n_games, A).reshape(L).float()
                h, c = h * keep[:, None], c * keep[:, None]
                if oside is not None:
                    okeep = 1.0 - done[:, None].expand(lay.n_games, len(opponents)).reshape(Lo).float()
                    oh, oc = oh * okeep[:, None], oc * okeep[:, None]
                rec["obs"].append(obs)
                rec["act"].append(acts)
                rec["logp"].append(P.joint_logp(lps, acts))
                rec["rew"].append(r)
                rec["done"].append(1.0 - keep)
            boot = side.observe(state, hero_ids)
        played.append(steps)
        chunk_obs = {k: torch.cat([torch.stack([o[k] for o in rec["obs"]], dim=1), boot[k][:, None]], dim=1)
                     for k in boot}
        chunk_act = {k: torch.stack([a[k] for a in rec["act"]], dim=1) for k in P.HEADS}
        behavior = torch.stack(rec["logp"], dim=1)
        rewards = torch.stack(rec["rew"], dim=1)
        dones = torch.stack(rec["done"], dim=1)
        keep_rows = slice(0, L // 2) if fault == "half_batch" else slice(0, L)
        loss, grads = _update_grads(setup, ar, params, {k: v[keep_rows] for k, v in chunk_obs.items()},
                                    {k: v[keep_rows] for k, v in chunk_act.items()}, behavior[keep_rows],
                                    rewards[keep_rows], dones[keep_rows], h0[keep_rows], c0[keep_rows])
        losses.append(float(loss))
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        clipped = {k: torch.where(norm < setup.max_grad_norm, g, (g / norm) * setup.max_grad_norm)
                   for k, g in grads.items()}
        if it == 0:
            grad1 = {k: g.clone() for k, g in clipped.items()}
        step_no = it + 1
        b1, b2 = ADAM_BETAS
        for k, g in clipped.items():
            m1[k] = b1 * m1[k] + (1 - b1) * g
            m2[k] = b2 * m2[k] + (1 - b2) * g * g
            mhat = m1[k] / (1 - b1 ** step_no)
            vhat = m2[k] / (1 - b2 ** step_no)
            params[k] = params[k] - setup.learning_rate * mhat / (vhat.sqrt() + ADAM_EPS)
    return Followed(losses, grad1, params, float(widest), played)


def _update_grads(setup: Setup, ar: Arith, params: Mapping[str, torch.Tensor], obs, acts, behavior, rewards, dones,
                  h0, c0):
    """The PPO loss on one chunk [B, T+1] and its gradient."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    B, T = rewards.shape
    resets = torch.zeros(B, T + 1, device=rewards.device)
    resets[:, 1:] = dones
    logits, values, _, _ = P.sequence(ar, leaves, obs, h0, c0, resets)
    logits_t = {k: v[:, :T] for k, v in logits.items()}
    obs_t = {k: v[:, :T] for k, v in obs.items()}
    lps = P.head_logps(logits_t, obs_t)
    logp = P.joint_logp(lps, acts)
    adv, returns = gae(rewards, values.detach(), dones, setup.gamma, setup.gae_lambda)
    n = float(B * T)
    adv = adv - adv.sum() / n
    std = torch.sqrt((adv * adv).sum() / n + 1e-8)
    adv = adv / torch.clamp(std, min=setup.adv_norm_floor)
    ratio = torch.exp(logp - behavior)
    clipped = torch.clamp(ratio, 1.0 - setup.clip_eps, 1.0 + setup.clip_eps)
    policy_loss = -torch.minimum(ratio * adv, clipped * adv).sum() / n
    value_loss = 0.5 * ((values[:, :T] - returns) ** 2).sum() / n
    ent = P.entropy(lps).sum() / n
    loss = policy_loss - setup.entropy_coef * ent + setup.value_coef * value_loss
    names = list(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in names])
    return loss.detach(), dict(zip(names, grads))


def gae(rewards, values, dones, gamma: float, lam: float):
    """(advantages, returns) over [B, T], values [B, T+1]."""
    not_done = 1.0 - dones
    deltas = rewards + gamma * not_done * values[:, 1:] - values[:, :-1]
    acc = torch.zeros_like(deltas[:, 0])
    out = [None] * deltas.shape[1]
    for t in reversed(range(deltas.shape[1])):
        acc = deltas[:, t] + gamma * lam * not_done[:, t] * acc
        out[t] = acc
    adv = torch.stack(out, dim=1)
    return adv, adv + values[:, :-1]


# -- the numbers compared ------------------------------------------------------


def norm_gaps(prog: Mapping[str, torch.Tensor], ref: Mapping[str, torch.Tensor],
              keep: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Per leaf, the gap between the program's norm and the reference's, over
    the reference's norm of that leaf or of the median leaf, whichever is
    larger."""
    names = list(keep if keep is not None else ref)
    ref_n = {k: float(ref[k].norm()) for k in names}
    med = float(np.median(list(ref_n.values()))) if names else 0.0
    out = {}
    for k in names:
        scale = max(ref_n[k], med)
        out[k] = abs(float(prog[k].norm()) - ref_n[k]) / scale if scale > 0 else 0.0
    return out


def moved_leaves(grad1: Mapping[str, torch.Tensor], floor: float = 1e-3) -> List[str]:
    """Leaves whose first gradient in the reference is at least ``floor`` of
    the median leaf's: the others move under Adam by round-off alone."""
    n = {k: float(v.norm()) for k, v in grad1.items()}
    med = float(np.median(list(n.values())))
    return [k for k, v in n.items() if v >= floor * med]


def _finite(x: float) -> float:
    return x if math.isfinite(x) else float("inf")


def compare(prog_losses: Sequence[float], prog_grad1: Mapping[str, torch.Tensor],
            prog_params: Mapping[str, torch.Tensor], judge: Followed,
            params0: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """The numbers that decide ``correct`` for a training cell: each
    update's loss, the first gradient and the change of the params over the
    iterations, each against the judge that followed the program's actions,
    and the widest gap of those actions below the judge's own picks."""
    loss_gap = max(_finite(abs(p - r) / max(abs(r), 1e-12)) for p, r in zip(prog_losses, judge.losses))
    grad_gap = max(_finite(v) for v in norm_gaps(prog_grad1, judge.grad1).values())
    keep = moved_leaves(judge.grad1)
    prog_change = {k: prog_params[k].float() - params0[k].float() for k in keep}
    ref_change = {k: judge.params[k] - params0[k].float() for k in keep}
    change_gap = max(_finite(v) for v in norm_gaps(prog_change, ref_change, keep).values())
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
            "action_gap": _finite(judge.action_gap)}
