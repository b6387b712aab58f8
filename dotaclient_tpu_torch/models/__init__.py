"""Policy model, action distribution and the Flax param bridge."""

from dotaclient_tpu_torch.models.convert import convert, flax_param_shapes, random_flax_params, to_flax
from dotaclient_tpu_torch.models.policy import (
    Policy,
    dummy_obs_batch,
    init_params,
    make_policy,
    mask_carry,
)

__all__ = [
    "Policy",
    "convert",
    "dummy_obs_batch",
    "flax_param_shapes",
    "init_params",
    "make_policy",
    "mask_carry",
    "random_flax_params",
    "to_flax",
]
