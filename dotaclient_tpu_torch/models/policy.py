"""Policy: unit encoder -> masked pooling -> recurrent core -> action heads.

Counterpart of ``dotaclient_tpu/models/policy.py``, module for module, so a
Flax param tree converts one to one (``models/convert.py``):

* ``UnitEncoder``: a two-layer MLP shared across unit slots;
* ``_trunk``: masked mean and max pooling over the unit axis (an
  all-padding row pools to 0), the globals projection and the hero
  embedding, concatenated and projected to the core width;
* the core, by ``ModelConfig.core``: ``LSTMCore``, which runs
  ``ops.lstm.lstm_sequence`` (the Hopper kernel on CUDA) with T=1 in
  ``step`` and T>1 in ``sequence``; or ``WindowedTransformerCore``
  (``models/transformer.py``, plain tensor ops, with ``moe.MoEMLP`` FFNs
  when ``moe_experts > 0``), which ``sequence`` steps T times, zeroing the
  carry of the rows whose episode ended the step before, as the reference's
  ``nn.scan`` does;
* ``_heads``: per-head logits in f32, the target head a dot-product
  attention over unit embeddings scaled by sqrt(E), and an f32 value head
  that ``value_head=False`` (the serving path) leaves out.

Params are f32 and compute runs in ``ModelConfig.dtype`` (bf16 by default):
each layer casts its weights to the compute dtype at use, as Flax does. The
LSTM kernel is f32 throughout, so ``LSTMCore`` converts its bf16 input and
carry to f32 at the kernel boundary and its outputs back to bf16; Flax
instead rounds the weights and gates to bf16, so the two agree to bf16
precision, not bitwise.

The LSTM carry keeps Flax's order, ``(c, h)``, in the compute dtype; the
kernel takes ``(h0, c0)``. The transformer carry is the reference's nested
f32 tuple ``(valid, ((k, v), ...))``. Code that holds a carry treats it as a
tree (``utils/tree.py``), never by unpacking it.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dotaclient_tpu_torch.config import ActionSpec, ModelConfig, ObsSpec
from dotaclient_tpu_torch.device import DeviceLike, resolve_device
from dotaclient_tpu_torch.models.moe import MoEMLP
from dotaclient_tpu_torch.models.transformer import (
    Block,
    GRUGate,
    LayerNorm,
    MoEStats,
    WindowedTransformerCore,
    dense,
    transformer_initial_state,
)
from dotaclient_tpu_torch.ops.lstm import lstm_sequence
from dotaclient_tpu_torch.parallel.collectives import Group
from dotaclient_tpu_torch.utils.tree import tree_map

# (c, h) for the LSTM core, Flax's order; (valid, ((k, v), ...)) for the
# transformer core. Leaves have the batch axis first.
Carry = Any
Obs = Mapping[str, torch.Tensor]
CORES = ("lstm", "transformer")


def mask_carry(carry: Carry, keep: torch.Tensor) -> Carry:
    """Multiply every carry leaf by ``keep`` ([B], 0 resets that row)."""
    return tree_map(lambda t: t * keep.reshape((-1,) + (1,) * (t.dim() - 1)).to(t.dtype), carry)


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def initial_carry(model: ModelConfig, batch_size: int, device: DeviceLike = None) -> Carry:
    """The zero carry of ``batch_size`` rows: ``(c, h)`` in the compute
    dtype for the LSTM core, the f32 ``(valid, ((k, v), ...))`` for the
    transformer's."""
    dev = resolve_device(device)
    if model.core == "transformer":
        return transformer_initial_state(model, batch_size, dev)
    shape = (batch_size, model.hidden_dim)
    dtype = _dtype(model.dtype)
    return (torch.zeros(shape, dtype=dtype, device=dev), torch.zeros(shape, dtype=dtype, device=dev))


class UnitEncoder(nn.Module):
    """Per-unit MLP shared across unit slots."""

    def __init__(self, in_features: int, embed_dim: int, device: torch.device) -> None:
        super().__init__()
        self.dense0 = nn.Linear(in_features, embed_dim, device=device)
        self.dense1 = nn.Linear(embed_dim, embed_dim, device=device)

    def forward(self, units: torch.Tensor) -> torch.Tensor:
        return F.relu(dense(self.dense1, F.relu(dense(self.dense0, units))))


class LSTMCore(nn.Module):
    """The recurrent core: packed gate weights in order i, f, g, o."""

    def __init__(self, in_features: int, hidden: int, device: torch.device) -> None:
        super().__init__()
        self.wx = nn.Parameter(torch.zeros(in_features, 4 * hidden, device=device))
        self.wh = nn.Parameter(torch.zeros(hidden, 4 * hidden, device=device))
        self.b = nn.Parameter(torch.zeros(4 * hidden, device=device))

    def forward(
        self, x: torch.Tensor, carry: Carry, resets: torch.Tensor, use_kernel: bool = True
    ) -> Tuple[Carry, torch.Tensor]:
        """x [B, T, D] and carry (c, h) in the compute dtype, resets [B, T]
        -> (new carry (c, h), hs [B, T, H]) in the compute dtype.
        ``use_kernel=False`` runs the plain version on CUDA tensors too."""
        c, h = carry
        dtype = x.dtype
        # kernel boundary: the kernel takes and returns f32
        hs, (hT, cT) = lstm_sequence(
            x.float().contiguous(), h.float().contiguous(), c.float().contiguous(),
            self.wx, self.wh, self.b, resets.float().contiguous(), use_kernel=use_kernel,
        )
        return (cT.to(dtype), hT.to(dtype)), hs.to(dtype)


class Policy(nn.Module):
    """Actor-critic policy with an LSTM or a transformer core.

    ``value_head=False`` is the inference-only path: the same trunk, core and
    action heads, no value head, and a constant-zero value placeholder."""

    def __init__(
        self,
        model: ModelConfig,
        obs_spec: ObsSpec,
        action_spec: ActionSpec,
        value_head: bool = True,
        device: DeviceLike = None,
    ) -> None:
        super().__init__()
        if model.core not in CORES:
            raise ValueError(f"unknown core {model.core!r} (one of {CORES})")
        dev = resolve_device(device)
        self.model = model
        self.obs_spec = obs_spec
        self.action_spec = action_spec
        self.value_head = value_head
        self.compute_dtype = _dtype(model.dtype)
        E, H = model.unit_embed_dim, model.hidden_dim
        self.unit_encoder = UnitEncoder(obs_spec.unit_features, E, dev)
        self.hero_embed = nn.Embedding(model.n_hero_ids, model.hero_embed_dim, device=dev)
        self.globals_proj = nn.Linear(obs_spec.global_features, E, device=dev)
        self.trunk_proj = nn.Linear(3 * E + model.hero_embed_dim, H, device=dev)
        self.core: nn.Module = (
            LSTMCore(H, H, dev) if model.core == "lstm" else WindowedTransformerCore(model, dev)
        )
        hs = action_spec.head_sizes
        self.head_action_type = nn.Linear(H, hs["action_type"], device=dev)
        self.head_move_x = nn.Linear(H, hs["move_x"], device=dev)
        self.head_move_y = nn.Linear(H, hs["move_y"], device=dev)
        self.head_ability = nn.Linear(H, hs["ability"], device=dev)
        self.target_query = nn.Linear(H, E, device=dev)
        if value_head:
            self.head_value = nn.Linear(H, 1, device=dev)

    @property
    def device(self) -> torch.device:
        return self.trunk_proj.weight.device

    # -- shared trunk ------------------------------------------------------

    def _trunk(self, obs: Obs) -> Tuple[torch.Tensor, torch.Tensor]:
        """obs with any leading axes -> (core input [..., H], unit
        embeddings [..., U, E] for the target head)."""
        dtype = self.compute_dtype
        units = obs["units"].to(dtype)
        unit_mask = obs["unit_mask"][..., None].to(dtype)        # [..., U, 1]
        unit_emb = self.unit_encoder(units) * unit_mask           # zero padding
        n_units = unit_mask.sum(dim=-2)                           # [..., 1]
        mean_pool = unit_emb.sum(dim=-2) / torch.clamp(n_units, min=1.0)
        max_pool = torch.where(unit_mask > 0, unit_emb, -1e9).amax(dim=-2)
        max_pool = torch.where(n_units > 0, max_pool, 0.0)      # all-padding row
        g = F.relu(dense(self.globals_proj, obs["globals"].to(dtype)))
        hero = F.embedding(obs["hero_id"].long(), self.hero_embed.weight).to(dtype)
        x = torch.cat([mean_pool, max_pool, g, hero], dim=-1)
        return F.relu(dense(self.trunk_proj, x)), unit_emb

    def _heads(
        self, y: torch.Tensor, unit_emb: torch.Tensor
    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """Core output [..., H] -> per-head f32 logits + value [...]."""
        q = dense(self.target_query, y)                          # [..., E]
        scale = math.sqrt(q.shape[-1])
        target_logits = torch.einsum("...e,...ue->...u", q, unit_emb).float() / scale
        logits = {
            "action_type": dense(self.head_action_type, y).float(),
            "move_x": dense(self.head_move_x, y).float(),
            "move_y": dense(self.head_move_y, y).float(),
            "target_unit": target_logits,
            "ability": dense(self.head_ability, y).float(),
        }
        if self.value_head:
            value = dense(self.head_value, y.float())[..., 0]
        else:
            value = torch.zeros(y.shape[:-1], dtype=torch.float32, device=y.device)
        return logits, value

    # -- public modes ------------------------------------------------------

    def initial_state(self, batch_size: int) -> Carry:
        return initial_carry(self.model, batch_size, self.device)

    def step(
        self, obs: Obs, carry: Carry, group: Group = None
    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, Carry]:
        """Single batched step: obs ``[B, ...]``; the LSTM core runs with T=1.
        ``group``: the batch group an MoE core routes over, when the rows
        are this rank's share of a data-parallel batch."""
        x, unit_emb = self._trunk(obs)
        if self.model.core == "lstm":
            resets = torch.zeros(x.shape[0], 1, dtype=torch.float32, device=x.device)
            carry, ys = self.core(x[:, None], carry, resets)
            y = ys[:, 0]
        else:
            carry, y, _ = self.core(carry, x, group)
        logits, value = self._heads(y, unit_emb)
        return logits, value, carry

    def sequence(
        self, obs: Obs, carry: Carry, dones: Optional[torch.Tensor] = None,
        use_kernel: bool = True, return_moe: bool = False, group: Group = None,
    ):
        """Teacher-forced sequence mode: obs ``[B, T, ...]`` from the stored
        initial carry -> ``(logits, value, carry)``. ``dones`` ([B, T'] with
        T' <= T, episode ended AT step t) zeroes the carry before step t+1,
        as the actor's reset does. ``return_moe`` appends the MoE routing
        stats: per MoE layer ``(probs, frac)``, each ``[T, B, E]`` (an empty
        tuple for the dense and LSTM cores). ``group`` as in ``step``."""
        x, unit_emb = self._trunk(obs)                            # [B, T, H]
        B, T = x.shape[:2]
        resets = torch.zeros(B, T, dtype=torch.float32, device=x.device)
        if dones is not None:
            # step 0 is reset by carry0 itself; step t>0 resets if t-1 done
            resets[:, 1:] = dones[:, : T - 1].float()
        moe: MoEStats = ()
        if self.model.core == "lstm":
            carry, ys = self.core(x, carry, resets, use_kernel=use_kernel)
        else:
            outs: List[torch.Tensor] = []
            steps: List[MoEStats] = []
            for t in range(T):
                carry = mask_carry(carry, 1.0 - resets[:, t])
                carry, y, stats = self.core(carry, x[:, t], group)
                outs.append(y)
                steps.append(stats)
            ys = torch.stack(outs, dim=1)
            moe = tuple((torch.stack([s[layer][0] for s in steps]), torch.stack([s[layer][1] for s in steps]))
                        for layer in range(len(steps[0])))
        logits, value = self._heads(ys, unit_emb)
        if return_moe:
            return logits, value, carry, moe
        return logits, value, carry

    def forward(self, obs: Obs, carry: Carry, group: Group = None):
        """Default = step mode."""
        return self.step(obs, carry, group)


def make_policy(
    model: ModelConfig,
    obs_spec: ObsSpec,
    action_spec: ActionSpec,
    device: DeviceLike = None,
) -> Policy:
    if model.moe_experts > 0 and model.core != "transformer":
        # only the transformer core routes an FFN: an "N-expert" LSTM would
        # mislabel every result
        raise ValueError(
            f"moe_experts={model.moe_experts} requires core='transformer' "
            f"(got core={model.core!r}); the LSTM core has no FFN to route"
        )
    return Policy(model, obs_spec, action_spec, device=device)


@torch.no_grad()
def init_params(policy: Policy, generator: torch.Generator) -> Policy:
    """Fill ``policy`` in place from ``generator`` with the distributions
    Flax's initializers draw (not the same values): Dense kernels
    lecun-normal (a normal truncated at 2 standard deviations, variance
    1/fan_in after truncation), biases zero, the hero embedding normal with
    variance 1/embed_dim (Flax's ``variance_scaling(1, fan_in, normal,
    out_axis=0)``). The LSTM cell's input kernels are lecun-normal and its
    four recurrent kernels orthogonal, each [H, H] gate block on its own,
    with a zero bias. The transformer's LayerNorms start at scale 1 and bias
    0, its attention position bias at 0, each GTrXL gate's ``bg`` at 2 (the
    near-identity start), and an MoE layer's gate and experts lecun-normal
    with each expert's fan-in its own (D for ``w1``, 4H for ``w2``). The
    draws are made on the CPU and copied, so a seed gives the same params on
    every device. Returns ``policy``."""

    def lecun(fan_in: int, *shape: int) -> torch.Tensor:
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        out = torch.empty(*shape)
        nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return out * std

    for name, module in policy.named_modules():
        if isinstance(module, nn.Linear):
            # Linear weight [out, in] is the transposed Flax kernel [in, out]
            module.weight.copy_(lecun(module.in_features, module.in_features,
                                      module.out_features).t())
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, LayerNorm):
            module.scale.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, GRUGate):
            module.bg.fill_(module.bias_init)
        elif isinstance(module, MoEMLP):
            D, E = module.gate.shape
            Fh = module.expert_w1.shape[2]
            module.gate.copy_(lecun(D, D, E))
            module.expert_w1.copy_(lecun(D, E, D, Fh))
            module.expert_w2.copy_(lecun(Fh, E, Fh, D))
            module.expert_b1.zero_()
            module.expert_b2.zero_()
        elif isinstance(module, Block):
            module.pos_bias.zero_()
    emb = policy.hero_embed.weight
    emb.copy_(torch.randn(emb.shape, generator=generator) / math.sqrt(emb.shape[1]))
    core = policy.core
    if not isinstance(core, LSTMCore):
        return policy
    D, G = core.wx.shape
    H = G // 4
    core.wx.copy_(torch.cat([lecun(D, D, H) for _ in range(4)], dim=1))
    blocks = []
    for _ in range(4):
        q = torch.empty(H, H)
        nn.init.orthogonal_(q, generator=generator)
        blocks.append(q)
    core.wh.copy_(torch.cat(blocks, dim=1))
    core.b.zero_()
    return policy


TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.int32): torch.int32,
    np.dtype(bool): torch.bool,
}


def obs_layout(obs_spec: ObsSpec, action_spec: ActionSpec) -> Dict[str, Tuple[Tuple[int, ...], np.dtype]]:
    """Per-leaf row shape and numpy dtype of one observation."""
    return {
        "units": ((obs_spec.max_units, obs_spec.unit_features), np.dtype(np.float32)),
        "unit_mask": ((obs_spec.max_units,), np.dtype(bool)),
        "unit_handles": ((obs_spec.max_units,), np.dtype(np.int32)),
        "globals": ((obs_spec.global_features,), np.dtype(np.float32)),
        "hero_id": ((), np.dtype(np.int32)),
        "mask_action_type": ((action_spec.n_action_types,), np.dtype(bool)),
        "mask_target_unit": ((action_spec.max_units,), np.dtype(bool)),
        "mask_cast_target": ((action_spec.max_units,), np.dtype(bool)),
        "mask_ability": ((action_spec.max_abilities,), np.dtype(bool)),
    }


def dummy_obs_batch(
    batch: int,
    obs_spec: ObsSpec,
    action_spec: ActionSpec,
    time: Optional[int] = None,
    device: DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """Observation tensors of the right shapes: zeros, and all-legal masks."""
    dev = resolve_device(device)
    lead = (batch,) if time is None else (batch, time)
    out = {}
    for name, (shape, dtype) in obs_layout(obs_spec, action_spec).items():
        fill = 1 if name.startswith("mask_") else 0
        out[name] = torch.full(lead + shape, fill, dtype=TORCH_DTYPES[dtype], device=dev)
    return out
