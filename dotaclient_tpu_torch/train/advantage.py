"""The one-pass advantage plane: one value forward and GAE per consumed batch.

Counterpart of ``dotaclient_tpu/train/advantage.py``. With
``epochs_per_batch x minibatches > 1`` the in-step estimator would rerun the
value forward and the GAE scan in every update, over work that is fixed for
the batch (the estimator reads values with no gradient). This stage runs it
once, when the learner takes the batch from the ring, and hands back
``(advantages, returns)`` at the staging dtype (``ppo.advantage_dtype``,
bf16 by default). ``train/ppo.ppo_loss`` sees the ``advantages`` leaf, skips
its estimator and shortens its forward to the T transition steps.

The pass runs ``Policy.sequence`` under ``torch.no_grad()``, so on the card
its LSTM core is the ``lstm_seq`` kernel (forward only). It reads nothing
on the host and issues behind the update in flight when the learner's
prefetch lane calls it.

GAE only: V-trace's importance ratios need the current policy's log-probs,
which change every update, so ``advantage="vtrace"`` keeps the in-step
recompute, as does fused mode.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from dotaclient_tpu_torch.config import ADVANTAGE_STORE_DTYPES, RunConfig
from dotaclient_tpu_torch.models.policy import Policy
from dotaclient_tpu_torch.train.gae import gae


def one_pass_enabled(config: RunConfig) -> bool:
    """True iff the plane applies: ``ppo.one_pass_advantage`` is on, the
    estimator is GAE, and the batch is trained on more than once
    (``steps_per_batch > 1``). At E x M = 1 the in-step estimator already
    runs once a batch, and a separate pass would add a forward."""
    return (
        config.ppo.one_pass_advantage
        and config.ppo.advantage == "gae"
        and config.ppo.steps_per_batch > 1
    )


def store_dtype(config: RunConfig) -> torch.dtype:
    """Staging dtype of the precomputed advantages and returns."""
    name = config.ppo.advantage_dtype
    if name not in ADVANTAGE_STORE_DTYPES:
        raise ValueError(f"unknown advantage_dtype {name!r} (one of {ADVANTAGE_STORE_DTYPES})")
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def advantages_and_returns(policy: Policy, batch: Any, cfg: Any) -> Tuple[torch.Tensor, torch.Tensor]:
    """The in-step estimator's ops as a stage of their own: the sequence
    forward over the full ``[B, T+1]`` chunk (the trailing slot is the
    bootstrap value), then GAE, both f32 and without a gradient."""
    with torch.no_grad():
        _, values, _ = policy.sequence(batch["obs"], batch["carry0"], batch["dones"])
        return gae(batch["rewards"], values, batch["dones"], cfg.gamma, cfg.gae_lambda)


def make_advantage_pass(policy: Policy, config: RunConfig):
    """``pass(batch) -> (advantages, returns)`` at the staging dtype, with
    the policy's live params."""
    if config.ppo.advantage != "gae":
        raise ValueError(
            "the one-pass advantage plane precomputes GAE only: advantage='vtrace' needs the current "
            "policy's log-probs in every update and keeps the in-step recompute"
        )
    dt = store_dtype(config)
    cfg = config.ppo

    def advantage_pass(batch):
        adv, ret = advantages_and_returns(policy, batch, cfg)
        return adv.to(dt), ret.to(dt)

    return advantage_pass
