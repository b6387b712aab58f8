"""Observations and shaped rewards: the proto featurizer and reward of the
scalar path, and the device and numpy featurizers of the batched paths."""

from dotaclient_tpu_torch.features.featurizer import (
    GLOBAL_FEATURES,
    Observation,
    UNIT_FEATURES,
    decode_action,
    featurize,
    observation_to_dict,
    stack_observations,
)
from dotaclient_tpu_torch.features.reward import WEIGHTS, reward_components, shaped_reward

__all__ = [
    "GLOBAL_FEATURES",
    "Observation",
    "UNIT_FEATURES",
    "WEIGHTS",
    "decode_action",
    "featurize",
    "observation_to_dict",
    "reward_components",
    "shaped_reward",
    "stack_observations",
]
