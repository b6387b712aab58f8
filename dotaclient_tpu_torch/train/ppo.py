"""PPO: the train state, the optimizer, the loss and one update.

Counterpart of ``dotaclient_tpu/train/ppo.py`` (``TrainState``,
``make_optimizer``, ``init_train_state``, ``ppo_loss``, ``_train_step``,
``fold_scan_metrics``). One update is a sequence forward from the stored
initial carry, the in-step advantage estimate (GAE or V-trace), the clipped
surrogate with value loss, entropy bonus and anchor KL, the gradient, the
reference optimizer's global-norm clip, and Adam.

Where the port keeps state differently, and why:

* The params are the policy module's own; ``TrainState`` holds the module,
  a ``torch.optim.Adam`` and the step and version counters as host ints.
  The host drives every step, so the counters are known there without a
  read from the device, and the gates that depend on them (the
  ``value_warmup_steps`` window, the optimizer re-initialised at its
  boundary, the skipped measurement forwards) are host branches.
* Clipping is optax's ``clip_by_global_norm``, written out: the gradient is
  scaled by ``max_norm / norm`` only when ``norm >= max_norm``, with no
  epsilon (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm).
* Adam is ``torch.optim.Adam`` at eps 1e-8, which computes optax's
  update. The ``kl_target`` controller's learning rate lives in
  ``param_groups``: on CUDA a device tensor, rescaled in place with no read
  on the host, which needs Adam's ``capturable`` mode (step counts on the
  device too); without the controller, or on the CPU, a float.
* Every metric is a 0-d tensor on the params' device; nothing in an update
  reads the device from the host.

A batch that carries precomputed ``advantages`` and ``returns`` (the
one-pass advantage plane, ``train/advantage.py``) trains on them over a
T-step forward; other batches keep the in-step estimator over the full T+1
chunk. ``make_train_step`` and ``make_epoch_step`` are the buffered
learner's updates: one update on a batch, and all ``epochs_per_batch x
minibatches`` updates of one consumed batch over the minibatch rows that
host-drawn permutations select. ``example_batch`` is a zero batch of the
ring's layout.

An MoE core adds the Switch load-balancing term (``_moe_aux_loss``: per
layer ``E x sum_e mean_prob_e x mean_frac_e`` over the valid steps, from the
routing stats ``Policy.sequence`` returns), under the warmup gate with the
other policy terms; a dense or LSTM core's is 0.

Data parallelism: ``_train_step`` and the step makers take a ``group``, the
mesh's batch group, each rank holding its rows of the global batch. The
reference's statistics are global over the batch because GSPMD sees one
array; here they are sums all-reduced over the group and divided by the
global count: the valid count, the advantage's mean and variance, every
masked mean of the loss and its metrics, and the ``kl_target`` controller's
post-update KL. A rank's loss is its own numerators over the global count,
so the gradients summed over the group (one all-reduce of the flattened
gradient) are the global loss's, and the global norm of the clip is taken
after that sum: every rank clips and steps the same tensor, and the params
stay equal across ranks. With no group every reduction is skipped and the
update is the one-card update, bit for bit. An MoE core routes over the
group (``parallel/expert.py``: the global capacity and a token's global
slot), and its load-balancing term, a product of two global means, is
taken from the masked sums all-reduced over the group: each rank's loss
carries the importance sums of its own rows times the global load, so the
ranks' gradients sum to the global term's.

Tensor parallelism: a ``TrainState`` made with a ``model_group`` of m > 1
ranks holds the ``ParamShards`` layout (``parallel/sharding.py``): Adam
steps this rank's 1/m slices of the cut master params, the rank keeps the
slices of their gradients (summed over the batch group), the clip's global
norm is summed over the model group, and after the step the model group
gathers the slices into the policy's whole params. ``optimizer_state_dict``
and ``load_whole`` speak the whole layout, so a checkpoint of any
``model_parallel`` restores at any other.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from dotaclient_tpu_torch.config import ADV_NORM_MODES, ADVANTAGE_MODES, PPOConfig, RunConfig
from dotaclient_tpu_torch.device import DeviceLike, host_index, resolve_device
from dotaclient_tpu_torch.models import distributions as D
from dotaclient_tpu_torch.models.policy import Policy, dummy_obs_batch, initial_carry
from dotaclient_tpu_torch.models.transformer import MoEStats
from dotaclient_tpu_torch.parallel.collectives import Group, all_gather_rows, group_rank, group_size, psum
from dotaclient_tpu_torch.parallel.sharding import ParamShards
from dotaclient_tpu_torch.train.checkify import checked
from dotaclient_tpu_torch.train.gae import gae, vtrace
from dotaclient_tpu_torch.utils.tree import tree_map

# A training batch of rollout chunks:
#   obs tensors           [B, T+1, ...], the bootstrap observation last
#   actions/logp/...      [B, T]
#   carry0                the rollout's initial carry, f32: (c [B, H], h [B, H])
#                         for the LSTM core, (valid [B, W], ((k, v) [B, W, H],)
#                         x n_layers) for the transformer core
#   valid                 [B, T]
Batch = Dict[str, Any]

ADAM_EPS = 1e-8


@dataclasses.dataclass
class TrainState:
    """Learner state: the policy (its params), its optimizer, and the
    optimizer-step and model-version counters; with ``shards`` the
    tensor-parallel layout, whose masters the optimizer steps."""

    step: int
    version: int
    policy: Policy
    optimizer: torch.optim.Adam
    shards: Optional[ParamShards] = None

    def clone(self) -> "TrainState":
        """An independent copy (params, optimizer moments and all) of a
        state without a tensor-parallel layout."""
        if self.shards is not None:
            raise ValueError("a tensor-parallel TrainState holds a process group and is not cloned")
        return copy.deepcopy(self)

    def optimizer_state_dict(self) -> Dict[str, Any]:
        """The optimizer's state dict in the whole layout (a collective over
        the model group when the state is sharded)."""
        sd = self.optimizer.state_dict()
        return self.shards.whole_opt_state(sd) if self.shards is not None else sd

    def load_whole(self, params: Dict[str, torch.Tensor], opt_state: Dict[str, Any]) -> None:
        """Params and an optimizer state dict of the whole layout into this
        state, cut to this rank's slices when it is sharded."""
        self.policy.load_state_dict(params)
        if self.shards is not None:
            self.shards.recut()
            opt_state = self.shards.cut_opt_state(opt_state)
        load_optimizer_state(self.optimizer, opt_state)


def load_optimizer_state(opt: torch.optim.Optimizer, saved: Dict[str, Any]) -> None:
    """``opt.load_state_dict(saved)``, keeping each group's learning rate
    where the live optimizer keeps it: a device tensor that the
    ``kl_target`` controller rescales in place stays that tensor (with the
    saved value), and a float stays a float."""
    lrs = [g["lr"] for g in opt.param_groups]
    opt.load_state_dict(saved)
    for group, live in zip(opt.param_groups, lrs):
        if isinstance(live, torch.Tensor):
            live.copy_(torch.as_tensor(group["lr"]))
            group["lr"] = live
        elif isinstance(group["lr"], torch.Tensor):
            group["lr"] = float(group["lr"])


def make_optimizer(cfg: PPOConfig, params: Sequence[torch.nn.Parameter]) -> torch.optim.Adam:
    """Adam over ``params`` at ``cfg.learning_rate`` (a device tensor on CUDA
    when the ``kl_target`` controller rescales it). Clipping is applied
    by ``_train_step`` before the optimizer sees the gradient."""
    params = list(params)
    tensor_lr = cfg.kl_target > 0 and params[0].device.type == "cuda"
    lr: Any = cfg.learning_rate
    if tensor_lr:
        lr = torch.tensor(cfg.learning_rate, dtype=torch.float32, device=params[0].device)
    return torch.optim.Adam(params, lr=lr, eps=ADAM_EPS, foreach=True, capturable=tensor_lr)


def init_train_state(policy: Policy, cfg: PPOConfig, model_group: Group = None) -> TrainState:
    """A fresh TrainState over ``policy``'s params (used in place); with a
    ``model_group`` of more than one rank, in the tensor-parallel layout
    (the policy's params must already be equal over the group)."""
    if group_size(model_group) > 1:
        shards = ParamShards(policy, model_group)
        return TrainState(step=0, version=0, policy=policy, optimizer=make_optimizer(cfg, shards.masters),
                          shards=shards)
    return TrainState(step=0, version=0, policy=policy,
                      optimizer=make_optimizer(cfg, policy.parameters()))


def _reset_optimizer(opt: torch.optim.Adam, cfg: PPOConfig) -> None:
    """A fresh optimizer state: zero moments and step count, and the
    learning rate back at ``cfg.learning_rate``."""
    opt.state.clear()
    for group in opt.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(cfg.learning_rate)
        else:
            group["lr"] = cfg.learning_rate


def _masked_mean(x: torch.Tensor, valid: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    return (x * valid).sum() / n_valid


def _moe_aux_loss(moe: MoEStats, valid: torch.Tensor, group: Group = None) -> torch.Tensor:
    """The global Switch load-balancing term (``_moe_aux_terms``' second)."""
    return _moe_aux_terms(moe, valid, group)[1]


def _moe_aux_terms(moe: MoEStats, valid: torch.Tensor,
                   group: Group = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Switch load-balancing loss from an MoE core's routing stats:
    per layer ``(probs, frac)``, each ``[T', B, E]`` with T' >= T (the
    bootstrap slot, when the forward ran it, is cut off), masked by
    ``valid [B, T]`` like every other term. 0 for a core without MoE.

    Returns (this rank's term of the loss, the global value). Per layer the
    term is ``E x sum_e mean_p[e] x mean_f[e]``, a product of two global
    means: with a ``group`` the masked ``[E]`` sums and the valid count are
    all-reduced (one all-reduce), the product taken once; the rank's loss
    term is its own importance sums over the global count times the global
    load (no gradient flows through the load), so the ranks' terms and
    gradients sum to the global term's. Without a group both are the
    one-card term."""
    zero = torch.zeros((), device=valid.device)
    if not moe:
        return zero, zero
    T = valid.shape[1]
    w = valid.t()[..., None]                                   # [T, B, 1]
    p_sums = [(probs[:T] * w).sum(dim=(0, 1)) for probs, _ in moe]   # [E] masked importance
    f_sums = [(frac[:T] * w).sum(dim=(0, 1)) for _, frac in moe]     # [E] masked load
    count = valid.sum()
    if group_size(group) > 1:
        summed = psum(torch.cat([count[None], *[p.detach() for p in p_sums], *f_sums]), group)
        count, rest = summed[0], summed[1:]
        E = p_sums[0].shape[0]
        global_p = list(rest[:E * len(moe)].split(E))
        f_sums = list(rest[E * len(moe):].split(E))
    else:
        global_p = p_sums
    denom = torch.clamp(count, min=1.0)
    aux, total = zero, zero
    for p_local, p_global, f in zip(p_sums, global_p, f_sums):
        E = p_local.shape[0]
        mean_f = f / denom
        aux = aux + E * torch.sum((p_local / denom) * mean_f)
        total = total + E * torch.sum((p_global / denom) * mean_f)
    return aux, total


def ppo_loss(
    policy: Policy,
    batch: Batch,
    cfg: PPOConfig,
    step: Optional[int] = None,
    anchor: Optional[Policy] = None,
    use_kernel: bool = True,
    group: Group = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Clipped-surrogate PPO loss over a batch of rollout chunks.

    ``step`` (the optimizer-step counter) enables the critic-only warmup:
    while ``step < cfg.value_warmup_steps`` the policy surrogate, entropy
    and anchor terms are multiplied by 0, so only the value loss trains.
    ``anchor`` (with ``cfg.anchor_kl_coef > 0``) adds the exact conditional
    KL(pi_theta || pi_anchor) per frame from one extra forward of the
    frozen anchor policy. ``use_kernel=False`` runs the LSTM core's plain
    version on CUDA tensors too. A batch with precomputed ``advantages``
    and ``returns`` skips the estimator and runs the forward over the T
    transition steps only (the bootstrap slot fed the estimator alone).
    With a ``group`` the batch is this rank's rows: the returned loss is
    its share of the global loss (its numerators over the global count),
    and the metrics are global."""
    obs = batch["obs"]
    T = batch["rewards"].shape[1]
    valid = batch["valid"].to(torch.float32)
    n_valid = torch.clamp(psum(valid.sum(), group), min=1.0)
    precomputed = "advantages" in batch
    if precomputed:
        obs = {k: v[:, :T] for k, v in obs.items()}

    logits, values, _, moe = policy.sequence(obs, batch["carry0"], batch["dones"], use_kernel=use_kernel,
                                             return_moe=True, group=group)
    moe_aux, moe_aux_global = _moe_aux_terms(moe, valid, group)
    # the trailing slot is the bootstrap step: its value is used, its
    # policy outputs are not
    logits_t = {k: v[:, :T] for k, v in logits.items()}
    obs_t = {k: v[:, :T] for k, v in obs.items()}
    values_t = values[:, :T]

    logp = D.log_prob(logits_t, obs_t, batch["actions"])

    if precomputed:
        # staged at the narrow dtype; constants to the optimizer, as the
        # estimator's outputs are
        adv = batch["advantages"].to(torch.float32)
        returns = batch["returns"].to(torch.float32)
    elif cfg.advantage == "gae":
        adv, returns = gae(batch["rewards"], values.detach(), batch["dones"], cfg.gamma, cfg.gae_lambda)
    elif cfg.advantage == "vtrace":
        adv, returns = vtrace(
            batch["rewards"], values.detach(), batch["dones"], batch["behavior_logp"],
            logp.detach(), cfg.gamma, cfg.vtrace_rho_clip, cfg.vtrace_c_clip,
        )
    else:
        raise ValueError(f"unknown advantage {cfg.advantage!r} (one of {ADVANTAGE_MODES})")
    # advantage normalisation over the valid batch: always centred, and
    # rescaled per cfg.adv_norm with the floor on the scale
    adv = adv - psum((adv * valid).sum(), group) / n_valid
    if cfg.adv_norm == "batch":
        adv_std = torch.sqrt(psum((torch.square(adv) * valid).sum(), group) / n_valid + 1e-8)
        adv = adv / torch.clamp(adv_std, min=cfg.adv_norm_floor)
    elif cfg.adv_norm not in ADV_NORM_MODES:
        raise ValueError(f"unknown adv_norm {cfg.adv_norm!r} (one of {ADV_NORM_MODES})")
    ratio = torch.exp(logp - batch["behavior_logp"])
    clipped = torch.clamp(ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps)
    policy_loss = -_masked_mean(torch.minimum(ratio * adv, clipped * adv), valid, n_valid)
    value_loss = 0.5 * (torch.square(values_t - returns) * valid).sum() / n_valid
    ent = _masked_mean(D.entropy(logits_t, obs_t), valid, n_valid)

    warm = bool(cfg.value_warmup_steps) and step is not None
    policy_on = 1.0 if not warm or step >= cfg.value_warmup_steps else 0.0
    anchor_kl = torch.zeros((), device=values.device)
    if cfg.anchor_kl_coef > 0 and anchor is not None and policy_on:
        # frozen-anchor forward (no gradient); skipped while the warmup
        # window zeroes the policy terms
        with torch.no_grad():
            anchor_logits, _, _ = anchor.sequence(obs, batch["carry0"], batch["dones"], use_kernel=use_kernel,
                                                  group=group)
        a_t = {k: v[:, :T] for k, v in anchor_logits.items()}
        anchor_kl = _masked_mean(D.kl(logits_t, a_t, obs_t), valid, n_valid)

    loss = (
        policy_on * (policy_loss - cfg.entropy_coef * ent + cfg.moe_aux_coef * moe_aux
                     + cfg.anchor_kl_coef * anchor_kl)
        + cfg.value_coef * value_loss
    )
    detached = lambda t: t.detach()  # noqa: E731 - metrics carry no graph
    metrics = {
        "loss": detached(loss),
        "moe_aux": detached(moe_aux_global),
        **({"anchor_kl": detached(anchor_kl)} if cfg.anchor_kl_coef > 0 and anchor is not None else {}),
        # kept for _train_step's post-update KL (popped there)
        **({"_logp": detached(logp)} if cfg.kl_target > 0 else {}),
        "policy_loss": detached(policy_loss),
        "value_loss": detached(value_loss),
        "entropy": detached(ent),
        "approx_kl": detached(_masked_mean(batch["behavior_logp"] - logp, valid, n_valid)),
        "clip_frac": detached(_masked_mean(((ratio - 1.0).abs() > cfg.clip_eps).to(torch.float32), valid, n_valid)),
        "value_mean": detached(_masked_mean(values_t, valid, n_valid)),
        "reward_mean": _masked_mean(batch["rewards"], valid, n_valid),
    }
    if group_size(group) > 1:
        # every reported mean is a sum of the ranks' shares: one all-reduce
        names = [k for k in metrics if k not in ("_logp", "moe_aux")]
        summed = psum(torch.stack([metrics[k] for k in names]), group)
        metrics.update(zip(names, summed.unbind(0)))
    return loss, metrics


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax's global_norm)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float, g_norm: torch.Tensor) -> List[torch.Tensor]:
    """optax's ``clip_by_global_norm``: each gradient becomes
    ``(g / norm) * max_norm`` where ``norm >= max_norm`` and is kept below;
    no epsilon. Device-side select, no read on the host."""
    trigger = g_norm < max_norm
    return [torch.where(trigger, g, (g / g_norm) * max_norm) for g in grads]


def _sum_grads(grads: List[torch.Tensor], group: Group) -> List[torch.Tensor]:
    """The gradients summed over the group: one all-reduce of them
    flattened into one buffer."""
    if group_size(group) == 1:
        return grads
    flat = psum(torch.cat([g.reshape(-1) for g in grads]), group)
    return [part.view_as(g) for part, g in zip(flat.split([g.numel() for g in grads]), grads)]


def _train_step(
    cfg: PPOConfig,
    state: TrainState,
    batch: Batch,
    anchor: Optional[Policy] = None,
    probe: bool = True,
    use_kernel: bool = True,
    group: Group = None,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One PPO update of ``state`` (in place) on ``batch``; returns the
    state and the update's metrics (0-d tensors). ``use_kernel=False``
    runs the LSTM core's plain version on CUDA tensors too, to hold the
    kernel against it. With a ``group`` (the mesh's batch group) ``batch``
    is this rank's rows of the global batch, and the update is the global
    batch's on every rank."""
    policy, opt = state.policy, state.optimizer
    warm = cfg.value_warmup_steps
    policy_on = 1.0 if not warm or state.step >= warm else 0.0
    loss, metrics = ppo_loss(policy, batch, cfg, step=state.step, anchor=anchor, use_kernel=use_kernel,
                             group=group)
    named = [(n, p) for n, p in policy.named_parameters() if p.requires_grad]
    grads = list(torch.autograd.grad(loss, [p for _, p in named]))
    shards = state.shards
    # what the optimizer steps: the params, or the tensor-parallel layout's
    # masters with their slices of the gradient
    params = shards.masters if shards is not None else [p for _, p in named]
    if shards is not None:
        grads = shards.local_grads(grads)
    grads = _sum_grads(grads, group)
    if warm:
        # critic-only warmup: zero every gradient outside the value head,
        # so the behaviour policy stays exactly frozen
        grads = [g if "head_value" in n else g * policy_on for (n, _), g in zip(named, grads)]
        if state.step == warm:
            # at the boundary the frozen params have zero moments while
            # Adam's shared count advanced; a fresh optimizer makes the
            # first live update a first step
            _reset_optimizer(opt, cfg)
    grad_norm = shards.global_norm(grads) if shards is not None else global_norm(grads)
    for p, g in zip(params, clip_by_global_norm(grads, cfg.max_grad_norm, grad_norm)):
        p.grad = g
    opt.step()
    for p in params:
        p.grad = None
    if shards is not None:
        shards.gather()

    if cfg.kl_target > 0:
        # KL-adaptive lr: the post-update policy shift on this batch's
        # actions (k3 estimator) rescales the lr for the next step
        logp_pre = metrics.pop("_logp")
        lr = opt.param_groups[0]["lr"]
        lr_t = lr.clone() if isinstance(lr, torch.Tensor) else torch.tensor(lr, device=loss.device)
        if warm and state.step < warm:
            # the frozen-policy window has post-KL 0 by construction: skip
            # the measurement forward, and hold the lr
            post_kl = torch.zeros((), device=loss.device)
            factor = torch.ones((), device=loss.device)
        else:
            with torch.no_grad():
                T = batch["rewards"].shape[1]
                obs = batch["obs"]
                if "advantages" in batch:
                    # the same T-step window the update trained on
                    obs = {k: v[:, :T] for k, v in obs.items()}
                logits_post, _, _ = policy.sequence(obs, batch["carry0"], batch["dones"], use_kernel=use_kernel,
                                                    group=group)
                logp_post = D.log_prob({k: v[:, :T] for k, v in logits_post.items()},
                                       {k: v[:, :T] for k, v in obs.items()}, batch["actions"])
                d = logp_post - logp_pre
                valid = batch["valid"].to(torch.float32)
                post_kl = (psum((((torch.exp(d) - 1.0) - d) * valid).sum(), group)
                           / torch.clamp(psum(valid.sum(), group), min=1.0))
            t = cfg.kl_target
            factor = torch.where(post_kl > 2.0 * t, cfg.kl_lr_down,
                                 torch.where(post_kl < 0.5 * t, cfg.kl_lr_up, 1.0))
        new_lr = torch.clamp(lr_t * factor, cfg.learning_rate * cfg.kl_lr_min_scale,
                             cfg.learning_rate * cfg.kl_lr_max_scale)
        for g in opt.param_groups:
            if isinstance(g["lr"], torch.Tensor):
                g["lr"].copy_(new_lr)
            else:
                g["lr"] = float(new_lr)   # CPU params: a host float is free to read
        metrics["post_kl"] = post_kl
        metrics["lr"] = lr_t
    metrics["grad_norm"] = grad_norm.detach()
    if probe:
        # health probe: NaN/Inf anywhere in the forward (loss) or the
        # backward (the pre-clip gradient norm)
        metrics["health_ok"] = (torch.isfinite(metrics["loss"]) & torch.isfinite(metrics["grad_norm"])).to(torch.float32)
    state.step += 1
    state.version += 1
    return state, metrics


def fold_scan_metrics(metric_seq: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Reduce a run of updates' metrics to one report: the last update's
    values, except ``health_ok``, which is the minimum over all of them
    (one poisoned update taints the report)."""
    out = dict(metric_seq[-1])
    if "health_ok" in out:
        out["health_ok"] = torch.stack([m["health_ok"] for m in metric_seq]).amin()
    return out


def take_rows(tree: Any, idx: torch.Tensor) -> Any:
    """Rows ``idx`` (a device index tensor) of every leaf of a batch tree
    (nested dicts and tuples of tensors with the row axis first)."""
    if isinstance(tree, dict):
        return {k: take_rows(v, idx) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(take_rows(v, idx) for v in tree)
    return tree.index_select(0, idx)


def make_train_step(config: RunConfig, anchor: Optional[Policy] = None, group: Group = None,
                    debug_checkify: bool = False):
    """``train_step(state, batch) -> (state, metrics)``: one update (in
    place) with the health probe on when ``config.health.enabled``.
    ``anchor`` is required exactly when ``ppo.anchor_kl_coef > 0``. With a
    ``group`` the batch is this rank's rows of the global batch.

    ``debug_checkify`` runs every op of the update (forward, backward and
    the optimizer's step) under ``train/checkify.py``'s checks, which raise
    ``FloatCheckError`` on the first op that produces a NaN or divides by
    zero: the debug numerics mode (it syncs the host on every op), the
    reference's checkify-instrumented step."""
    if (config.ppo.anchor_kl_coef > 0) != (anchor is not None):
        raise ValueError("anchor must be passed exactly when ppo.anchor_kl_coef > 0")
    cfg, probe = config.ppo, config.health.enabled

    def train_step(state: TrainState, batch: Batch):
        return _train_step(cfg, state, batch, anchor=anchor, probe=probe, group=group)

    return checked(train_step) if debug_checkify else train_step


def make_epoch_step(config: RunConfig, anchor: Optional[Policy] = None, group: Group = None,
                    debug_checkify: bool = False):
    """``epoch_step(state, batch, perms) -> (state, metrics)``: all
    ``epochs_per_batch x minibatches`` updates of one consumed batch.

    ``perms`` is ``[E, B]`` (numpy or a tensor), one row order an epoch,
    drawn on the host from the learner's seeded stream; reshaped to
    ``[E*M, B/M]``, row r is the minibatch of update r, the rows the
    reference's staged loop (``ppo.fused_epoch=False``) gathers. With ``minibatches == 1`` every update trains on
    the whole batch and ``perms`` is ignored. Metrics fold by
    ``fold_scan_metrics``: the last update's, ``health_ok`` the minimum.

    With a ``group`` of n ranks, ``batch`` is this rank's ``B / n`` rows
    (rank k holds global rows ``[k B/n, (k+1) B/n)``) and ``perms`` is over
    the global batch, the same on every rank. A minibatch of the reference
    is ``B / M`` global rows cut evenly over the ranks, so with ``M > 1``
    the ranks first gather the whole batch (one all-gather a leaf a call)
    and rank k trains on its k-th block of each minibatch's rows.

    ``debug_checkify`` checks each update as ``make_train_step``'s does
    (the reference's checkify runs its staged loop, a checked step an
    update); the row gathers between them move values and are not
    checked."""
    cfg = config.ppo
    E, M, B = cfg.epochs_per_batch, max(1, cfg.minibatches), cfg.batch_rollouts
    if B % M:
        raise ValueError(f"batch_rollouts {B} not divisible by minibatches {M}")
    mb = B // M
    n, k = group_size(group), group_rank(group)
    if mb % n:
        raise ValueError(f"minibatch size {mb} not divisible by the batch shard count {n}")
    # raises unless anchor is passed exactly when ppo.anchor_kl_coef > 0
    update = make_train_step(config, anchor=anchor, group=group, debug_checkify=debug_checkify)

    def epoch_step(state: TrainState, batch: Batch, perms: Any):
        metric_seq = []
        if M == 1:
            for _ in range(E):
                state, m = update(state, batch)
                metric_seq.append(m)
        else:
            idx = host_index(perms, batch["rewards"].device).reshape(E * M, mb)
            if n > 1:
                batch = tree_map(lambda t: all_gather_rows(t, group), batch)
                idx = idx[:, k * (mb // n):(k + 1) * (mb // n)]
            for r in range(E * M):
                state, m = update(state, take_rows(batch, idx[r]))
                metric_seq.append(m)
        return state, fold_scan_metrics(metric_seq)

    return epoch_step


def example_batch(config: RunConfig, batch: int, device: DeviceLike = None) -> Batch:
    """A zero batch of ``batch`` rows in the layout of a rollout chunk and
    of the trajectory ring: obs ``[batch, T+1, ...]`` (all-legal masks),
    int32 actions, f32 ``behavior_logp``/``rewards``/``dones``, ``valid``
    ones, and ``carry0`` laid out as the policy's ``initial_state``, in
    f32 (the wire's and the ring's carry is always f32)."""
    dev = resolve_device(device)
    T = config.ppo.rollout_len
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "obs": dummy_obs_batch(batch, config.obs, config.actions, time=T + 1, device=dev),
        "actions": {h: torch.zeros((batch, T), dtype=torch.int32, device=dev) for h in config.actions.head_sizes},
        "behavior_logp": torch.zeros((batch, T), **f32),
        "rewards": torch.zeros((batch, T), **f32),
        "dones": torch.zeros((batch, T), **f32),
        "valid": torch.ones((batch, T), **f32),
        "carry0": tree_map(lambda t: torch.zeros(t.shape, **f32), initial_carry(config.model, batch, dev)),
    }
