"""Shared helpers of the PyTorch-port tests (tests/test_torch_*.py; this
module holds no test cases): small configs, numpy inputs from a seed, and
conversions between the two packages."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dotaclient_tpu import config as jax_config
from dotaclient_tpu.models.policy import init_params, make_policy
from dotaclient_tpu.serve.policy_path import make_inference_policy
from dotaclient_tpu_torch import config as port_config
from dotaclient_tpu_torch.models import convert
from dotaclient_tpu_torch.models.policy import Policy
from dotaclient_tpu_torch.serve.policy_path import slice_train_params


def small_configs(dtype="float32", **serve):
    """The same small config in both packages: (jax RunConfig, port RunConfig)."""
    out = []
    for mod in (jax_config, port_config):
        cfg = mod.RunConfig()
        out.append(dataclasses.replace(
            cfg,
            model=mod.ModelConfig(unit_embed_dim=16, hidden_dim=32, hero_embed_dim=8, dtype=dtype),
            serve=dataclasses.replace(cfg.serve, **{"max_batch": 4, "max_slots": 8, **serve}),
        ))
    return tuple(out)


def tiny_configs(dtype="float32", **serve):
    """``small_configs`` at the serving tests' model
    (``tests/test_serve.py``: unit_embed_dim 8, hidden_dim 8, hero_embed_dim
    4), f32 compute by default."""
    out = []
    for mod, cfg in zip((jax_config, port_config), small_configs(dtype, **serve)):
        out.append(dataclasses.replace(
            cfg, model=mod.ModelConfig(unit_embed_dim=8, hidden_dim=8, hero_embed_dim=4, dtype=dtype),
        ))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def jax_policy(jcfg, value_head=True):
    """The flax policy and its step/sequence applies, jitted (one compile
    each instead of one per eager op)."""
    if value_head:
        policy = make_policy(jcfg.model, jcfg.obs, jcfg.actions)
    else:
        policy = make_inference_policy(jcfg)
    step = jax.jit(functools.partial(policy.apply, method="step"))
    sequence = jax.jit(functools.partial(policy.apply, method="sequence"))
    return policy, step, sequence


@functools.lru_cache(maxsize=None)
def flax_shapes(jcfg, value_head=True):
    """The flax param tree's ShapeDtypeStructs, traced by ``init_params``
    without computing it."""
    policy = jax_policy(jcfg, value_head)[0]
    return jax.eval_shape(lambda: init_params(policy, jax.random.PRNGKey(0)))


def flax_params(jcfg, seed=0, value_head=True):
    """A flax param tree (nested dict of numpy arrays) of the JAX policy's
    own structure, filled from ``seed``: kernels N(0, 1/fan_in), biases
    N(0, 0.01) so every bias path is live, embeddings N(0, 1)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        scale = 1.0 / np.sqrt(leaf.shape[0]) if name.endswith("['kernel']") else (
            0.1 if name.endswith("['bias']") else 1.0)
        return (rng.normal(size=leaf.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, flax_shapes(jcfg, value_head))


def port_policy(pcfg, params, value_head=True):
    policy = Policy(pcfg.model, pcfg.obs, pcfg.actions, value_head=value_head, device="cpu")
    policy.load_state_dict(slice_train_params(convert(params)) if not value_head else convert(params))
    return policy


def random_obs(cfg, lead, seed=0):
    """Numpy observations with leading shape ``lead``: some padded units, one
    all-padding row, random legality masks with one fully illegal target
    row, and at least one legal action type everywhere."""
    rng = np.random.default_rng(seed)
    o, a = cfg.obs, cfg.actions
    lead = tuple(lead)
    unit_mask = rng.random(lead + (o.max_units,)) < 0.7
    unit_mask.reshape(-1, o.max_units)[0] = False
    mask_action_type = rng.random(lead + (a.n_action_types,)) < 0.7
    mask_action_type[..., 0] = True
    mask_target = rng.random(lead + (a.max_units,)) < 0.5
    mask_target.reshape(-1, a.max_units)[-1] = False
    return {
        "units": rng.normal(size=lead + (o.max_units, o.unit_features)).astype(np.float32),
        "unit_mask": unit_mask,
        "unit_handles": rng.integers(0, o.max_units, size=lead + (o.max_units,)).astype(np.int32),
        "globals": rng.normal(size=lead + (o.global_features,)).astype(np.float32),
        "hero_id": rng.integers(0, cfg.model.n_hero_ids, size=lead).astype(np.int32),
        "mask_action_type": mask_action_type,
        "mask_target_unit": mask_target,
        "mask_cast_target": rng.random(lead + (a.max_units,)) < 0.5,
        "mask_ability": rng.random(lead + (a.max_abilities,)) < 0.6,
    }


def obs_row(obs, i):
    return {k: v[i] for k, v in obs.items()}


def to_jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def to_torch(tree, device="cpu"):
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in tree.items()}


def np32(t):
    """A tensor or array as f32 numpy (bf16 tensors upcast exactly)."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, dtype=np.float32)
