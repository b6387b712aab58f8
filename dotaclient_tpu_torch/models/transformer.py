"""Windowed-attention transformer core with a recurrent KV-cache carry.

Counterpart of ``dotaclient_tpu/models/transformer.py``, module for module:
``GRUGate``, ``Block`` and ``WindowedTransformerCore`` are the reference's
``_GRUGate``, ``_Block`` and core, and ``transformer_initial_state`` its
carry. The core is a recurrent cell, ``(carry, x) -> (carry, y)``, so every
place that holds the LSTM's carry (the device rollout, the ring, the wire,
the serve engine's slots) holds this one too. The carry is the nested tuple
``(valid [B, W], ((k [B, W, H], v [B, W, H]),) x n_layers)``, f32: per layer
a Transformer-XL rolling window of the last ``context_window`` steps' keys
and values (computed in the compute dtype and stored in f32), and a
validity mask. An episode reset zeroes it like the LSTM's: a zero window
attends to nothing but the current step.

A block is pre-LN attention over the window plus the current step, with a
learned per-head bias over the W+1 slots (a slot's age is fixed, so the
table is the whole relative-position code), then a GTrXL gate (Parisotto et
al. 2019) in place of each residual add, its bias starting at 2 so the
block starts near the identity; the FFN is dense (4H, tanh GELU) or
``moe.MoEMLP``. The core's output goes through a last LayerNorm.

Numerics follow Flax: weights cast to the compute dtype at use; LayerNorm
at epsilon 1e-6 with its statistics in f32 (``E[x^2] - E[x]^2``, floored at
0) and its scale and bias applied in f32, the output cast back; attention
logits in f32 (``/ sqrt(dh)``, ``+ pos_bias``, ``-1e9`` where the window is
invalid, softmax in f32), the weights cast back to the compute dtype.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dotaclient_tpu_torch.config import ModelConfig
from dotaclient_tpu_torch.models.moe import MoEMLP
from dotaclient_tpu_torch.parallel.collectives import Group

KV = Tuple[torch.Tensor, torch.Tensor]
# per layer (probs [B, E], frac [B, E]) of an MoE core; empty for a dense one
MoEStats = Tuple[Tuple[torch.Tensor, torch.Tensor], ...]

LN_EPS = 1e-6   # Flax nn.LayerNorm's default (torch's is 1e-5)


def dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """Apply an f32-param Linear in ``x``'s (compute) dtype."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


class LayerNorm(nn.Module):
    """Flax's ``nn.LayerNorm`` over the last axis (params ``scale``, ``bias``)."""

    def __init__(self, dim: int, device: torch.device) -> None:
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mu = x32.mean(dim=-1, keepdim=True)
        var = torch.clamp((x32 * x32).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
        y = (x32 - mu) * (torch.rsqrt(var + LN_EPS) * self.scale) + self.bias
        return y.to(x.dtype)


class GRUGate(nn.Module):
    """The GTrXL gated residual: ``(1 - z) x + z h_hat`` in place of ``x + y``."""

    def __init__(self, dim: int, device: torch.device, bias_init: float = 2.0) -> None:
        super().__init__()
        for name in ("wr", "ur", "wz", "uz", "wg", "ug"):
            setattr(self, name, nn.Linear(dim, dim, bias=False, device=device))
        self.bias_init = bias_init
        self.bg = nn.Parameter(torch.full((dim,), bias_init, device=device))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        r = torch.sigmoid(dense(self.wr, y) + dense(self.ur, x))
        z = torch.sigmoid(dense(self.wz, y) + dense(self.uz, x) - self.bg.to(x.dtype))
        h_hat = torch.tanh(dense(self.wg, y) + dense(self.ug, r * x))
        return (1.0 - z) * x + z * h_hat


class Block(nn.Module):
    """Pre-LN attention block on one step and its KV window."""

    def __init__(self, config: ModelConfig, device: torch.device) -> None:
        super().__init__()
        H, nh = config.hidden_dim, config.n_heads
        if H % nh:
            raise ValueError(f"hidden_dim {H} is not divisible by n_heads {nh}")
        self.n_heads = nh
        self.ln0 = LayerNorm(H, device)
        self.q = nn.Linear(H, H, device=device)
        self.k = nn.Linear(H, H, device=device)
        self.v = nn.Linear(H, H, device=device)
        self.pos_bias = nn.Parameter(torch.zeros(nh, config.context_window + 1, device=device))
        self.o = nn.Linear(H, H, device=device)
        self.gate_attn = GRUGate(H, device)
        self.ln1 = LayerNorm(H, device)
        self.moe: Optional[MoEMLP] = None
        if config.moe_experts > 0:
            self.moe = MoEMLP(H, config.moe_experts, config.moe_capacity_factor, device)
        else:
            self.ffn0 = nn.Linear(H, 4 * H, device=device)
            self.ffn1 = nn.Linear(4 * H, H, device=device)
        self.gate_ffn = GRUGate(H, device)

    def forward(
        self, kv: KV, valid: torch.Tensor, h: torch.Tensor, group: Group = None
    ) -> Tuple[KV, torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
        """kv (k, v) ``[B, W, H]`` f32, valid ``[B, W]`` f32, h ``[B, H]``
        in the compute dtype -> (the rolled kv, h, MoE stats or None).
        ``group``: the batch group the MoE FFN routes over."""
        kc, vc = kv
        B, W = valid.shape
        H = h.shape[-1]
        nh = self.n_heads
        dh = H // nh
        dtype = h.dtype

        hn = self.ln0(h)
        q, k, v = dense(self.q, hn), dense(self.k, hn), dense(self.v, hn)
        keys = torch.cat([kc.to(dtype), k[:, None]], dim=1)                   # [B, W+1, H]
        vals = torch.cat([vc.to(dtype), v[:, None]], dim=1)
        mask = torch.cat([valid, torch.ones_like(valid[:, :1])], dim=1)      # [B, W+1]
        logits = torch.einsum("bhd,bkhd->bhk", q.reshape(B, nh, dh), keys.reshape(B, W + 1, nh, dh)).float()
        logits = logits / math.sqrt(dh) + self.pos_bias[None].float()
        logits = torch.where(mask[:, None, :] > 0, logits, -1e9)
        w = torch.softmax(logits, dim=-1).to(dtype)
        out = torch.einsum("bhk,bkhd->bhd", w, vals.reshape(B, W + 1, nh, dh)).reshape(B, H)
        h = self.gate_attn(h, dense(self.o, out))

        hm = self.ln1(h)
        stats = None
        if self.moe is not None:
            ffn, stats = self.moe(hm, group)
        else:
            ffn = dense(self.ffn1, F.gelu(dense(self.ffn0, hm), approximate="tanh"))
        h = self.gate_ffn(h, ffn)

        # roll the window: drop the oldest slot, append this step in f32
        new_k = torch.cat([kc[:, 1:], k.float()[:, None]], dim=1)
        new_v = torch.cat([vc[:, 1:], v.float()[:, None]], dim=1)
        return (new_k, new_v), h, stats


class WindowedTransformerCore(nn.Module):
    """The recurrent cell: ``(carry, x [B, H]) -> (carry, y [B, H], stats)``,
    ``stats`` the MoE layers' ``(probs, frac)`` (empty for a dense FFN)."""

    def __init__(self, config: ModelConfig, device: torch.device) -> None:
        super().__init__()
        self.blocks = nn.ModuleList([Block(config, device) for _ in range(config.n_layers)])
        self.out_ln = LayerNorm(config.hidden_dim, device)

    def forward(self, carry, x: torch.Tensor, group: Group = None):
        valid, caches = carry
        h = x
        new_caches, stats = [], []
        for block, kv in zip(self.blocks, caches):
            kv, h, st = block(kv, valid, h, group)
            new_caches.append(kv)
            if st is not None:
                stats.append(st)
        # the pre-LN stream is unbounded; the heads read a normalised one
        h = self.out_ln(h)
        new_valid = torch.cat([valid[:, 1:], torch.ones_like(valid[:, :1])], dim=1)
        return (new_valid, tuple(new_caches)), h, tuple(stats)


def transformer_initial_state(config: ModelConfig, batch_size: int, device: torch.device):
    """The zero carry ``(valid [B, W], ((k, v),) x n_layers)``, f32, each
    leaf its own tensor (the serve engine writes its store in place)."""
    W, H = config.context_window, config.hidden_dim
    f32 = dict(dtype=torch.float32, device=device)
    return (
        torch.zeros((batch_size, W), **f32),
        tuple((torch.zeros((batch_size, W, H), **f32), torch.zeros((batch_size, W, H), **f32))
              for _ in range(config.n_layers)),
    )
