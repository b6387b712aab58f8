"""Flax ``Policy`` params -> the port's ``Policy`` state dict.

The Flax tree (a nested dict of numpy arrays, with or without the
``{"params": ...}`` level and with or without ``head_value``) maps one to one:

* a Dense ``kernel [in, out]`` becomes a Linear ``weight [out, in]``;
* ``nn.Embed``'s ``embedding`` becomes the embedding table;
* the ``nn.OptimizedLSTMCell`` core packs its input kernels ``ii/if/ig/io``
  (no bias) into ``core.wx [D, 4H]`` and its hidden kernels ``hi/hf/hg/ho``
  (with bias) into ``core.wh [H, 4H]`` and ``core.b [4H]``, gate order
  i, f, g, o, which is the LSTM kernel's layout;
* the transformer core's ``block_<l>`` is ``core.blocks.<l>``, its
  ``LayerNorm_0``/``LayerNorm_1`` are ``ln0``/``ln1`` and its dense FFN's
  ``Dense_0``/``Dense_1`` are ``ffn0``/``ffn1``; every other name (``q``,
  ``k``, ``v``, ``o``, ``pos_bias``, the gates ``gate_attn``/``gate_ffn``
  with ``wr ur bg wz uz wg ug``, ``moe`` with its expert-major arrays,
  ``out_ln``) is the same on both sides. Kernels transpose; the rest (scale,
  bias, ``bg``, ``pos_bias``, the MoE arrays) is copied as it is.

``to_flax`` is the inverse: the port's state dict back to the Flax tree
(``{"params": {...}}`` of f32 numpy arrays), its keys in the order a Flax
``init_params`` tree has them (modules in call order, ``kernel`` before
``bias``, the LSTM core's ``i<g>`` before ``h<g>`` gate by gate; a
transformer block's params in creation order, ``pos_bias`` after ``v`` and a
gate's ``bg`` after ``ur``), because the weights frame's byte order follows
the tree's (``flatten_tree``): the port's learner then publishes the JAX
package's frames byte for byte at f32.

``flax_param_shapes`` gives the Flax tree's shapes from a config alone, and
``random_flax_params`` fills it from a seed with numpy, so a run on a machine
without JAX can build the same kind of tree a checkpoint holds.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from dotaclient_tpu_torch.config import RunConfig

GATES = ("i", "f", "g", "o")

# Flax Dense module name -> port Linear name
_DENSE = {
    ("unit_encoder", "Dense_0"): "unit_encoder.dense0",
    ("unit_encoder", "Dense_1"): "unit_encoder.dense1",
    ("globals_proj",): "globals_proj",
    ("trunk_proj",): "trunk_proj",
    ("head_action_type",): "head_action_type",
    ("head_move_x",): "head_move_x",
    ("head_move_y",): "head_move_y",
    ("head_ability",): "head_ability",
    ("target_query",): "target_query",
    ("head_value",): "head_value",
}

# the top level of a Flax ``init_params`` tree, in its order (the order the
# modules are first called: trunk, core, target query, heads)
_FLAX_ORDER = ("unit_encoder", "globals_proj", "hero_embed", "trunk_proj", "core", "target_query",
               "head_action_type", "head_move_x", "head_move_y", "head_ability", "head_value")


# a transformer core's sizes: (hidden H, heads, window slots W + 1, layers,
# experts E, 0 for a dense FFN)
TransformerDims = Tuple[int, int, int, int, int]
_GATE_ORDER = ("wr", "ur", "bg", "wz", "uz", "wg", "ug")   # Flax's creation order


def _transformer_layout(dims: TransformerDims) -> List[Tuple[Tuple[str, ...], str, bool, Tuple[int, ...]]]:
    """The transformer core's params in the Flax tree's order: (Flax path
    under ``core``, the port's key under ``core.``, transposed?, Flax
    shape)."""
    H, nh, W1, L, E = dims
    out: List[Tuple[Tuple[str, ...], str, bool, Tuple[int, ...]]] = []

    def dense(src: Tuple[str, ...], port: str, i: int, n: int) -> None:
        out.append((src + ("kernel",), f"{port}.weight", True, (i, n)))
        out.append((src + ("bias",), f"{port}.bias", False, (n,)))

    def norm(src: Tuple[str, ...], port: str) -> None:
        out.append((src + ("scale",), f"{port}.scale", False, (H,)))
        out.append((src + ("bias",), f"{port}.bias", False, (H,)))

    def gate(src: Tuple[str, ...], port: str) -> None:
        for g in _GATE_ORDER:
            if g == "bg":
                out.append((src + ("bg",), f"{port}.bg", False, (H,)))
            else:
                out.append((src + (g, "kernel"), f"{port}.{g}.weight", True, (H, H)))

    for layer in range(L):
        b, pb = (f"block_{layer}",), f"blocks.{layer}"
        norm(b + ("LayerNorm_0",), f"{pb}.ln0")
        for name in ("q", "k", "v"):
            dense(b + (name,), f"{pb}.{name}", H, H)
        out.append((b + ("pos_bias",), f"{pb}.pos_bias", False, (nh, W1)))
        dense(b + ("o",), f"{pb}.o", H, H)
        gate(b + ("gate_attn",), f"{pb}.gate_attn")
        norm(b + ("LayerNorm_1",), f"{pb}.ln1")
        if E:
            m = b + ("moe",)
            for name, shape in (("gate", (H, E)), ("expert_w1", (E, H, 4 * H)), ("expert_b1", (E, 4 * H)),
                                ("expert_w2", (E, 4 * H, H)), ("expert_b2", (E, H))):
                out.append((m + (name,), f"{pb}.moe.{name}", False, shape))
        else:
            dense(b + ("Dense_0",), f"{pb}.ffn0", H, 4 * H)
            dense(b + ("Dense_1",), f"{pb}.ffn1", 4 * H, H)
        gate(b + ("gate_ffn",), f"{pb}.gate_ffn")
    norm(("out_ln",), "out_ln")
    return out


def _transformer_dims(core: Mapping[str, Any]) -> TransformerDims:
    """The sizes of a Flax transformer core subtree."""
    L = sum(1 for k in core if k.startswith("block_"))
    nh, W1 = np.shape(core["block_0"]["pos_bias"])
    moe = core["block_0"].get("moe")
    E = int(np.shape(moe["gate"])[1]) if moe is not None else 0
    return int(np.shape(core["out_ln"]["scale"])[0]), int(nh), int(W1), L, E


def _transformer_dims_sd(sd: Mapping[str, torch.Tensor]) -> TransformerDims:
    """The sizes of the port's transformer core, from its state dict."""
    L = sum(1 for k in sd if k.startswith("core.blocks.") and k.endswith(".pos_bias"))
    nh, W1 = sd["core.blocks.0.pos_bias"].shape
    gate = sd.get("core.blocks.0.moe.gate")
    return int(sd["core.out_ln.scale"].shape[0]), int(nh), int(W1), L, int(gate.shape[1]) if gate is not None else 0


def _params_level(params: Mapping[str, Any]) -> Mapping[str, Any]:
    if not isinstance(params, Mapping):
        raise TypeError(f"expected a param dict, got {type(params).__name__}")
    return params["params"] if "params" in params else params


def _f32(a: Any) -> torch.Tensor:
    if isinstance(a, torch.Tensor):  # a bf16 leaf of a decoded weights frame
        return a.detach().to("cpu", torch.float32, copy=True)
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def convert(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax policy params -> state dict of f32 CPU tensors for ``Policy``
    (``head_value`` is carried over only where the tree has it)."""
    p = _params_level(params)
    out: Dict[str, torch.Tensor] = {}
    for path, name in _DENSE.items():
        node: Any = p
        if path[0] not in p:
            if path == ("head_value",):
                continue
            raise KeyError(f"Flax params lack {'/'.join(path)}")
        for key in path:
            node = node[key]
        out[f"{name}.weight"] = _f32(node["kernel"]).T.contiguous()
        out[f"{name}.bias"] = _f32(node["bias"])
    out["hero_embed.weight"] = _f32(p["hero_embed"]["embedding"])
    core = p["core"]
    if "block_0" in core:
        for flax_path, key, transpose, _ in _transformer_layout(_transformer_dims(core)):
            node: Any = core
            for k in flax_path:
                node = node[k]
            out[f"core.{key}"] = _f32(node).T.contiguous() if transpose else _f32(node)
        return out
    out["core.wx"] = torch.cat([_f32(core[f"i{g}"]["kernel"]) for g in GATES], dim=1)
    out["core.wh"] = torch.cat([_f32(core[f"h{g}"]["kernel"]) for g in GATES], dim=1)
    out["core.b"] = torch.cat([_f32(core[f"h{g}"]["bias"]) for g in GATES])
    return out


def _np32(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's ``Policy`` state dict -> the Flax param tree
    (``{"params": {...}}``, f32 numpy leaves) in ``init_params``' key
    order; ``head_value`` only where the state dict has it. Exactly the
    inverse of :func:`convert` (a transpose and a split: no arithmetic)."""
    sd = state_dict
    dense_of = {path: name for path, name in _DENSE.items()}
    tree: Dict[str, Any] = {}
    for top in _FLAX_ORDER:
        if top == "unit_encoder":
            tree[top] = {sub: {"kernel": _np32(sd[f"{dense_of[(top, sub)]}.weight"].T),
                               "bias": _np32(sd[f"{dense_of[(top, sub)]}.bias"])}
                         for sub in ("Dense_0", "Dense_1")}
        elif top == "hero_embed":
            tree[top] = {"embedding": _np32(sd["hero_embed.weight"])}
        elif top == "core" and "core.wh" not in sd:
            core: Dict[str, Any] = {}
            for flax_path, key, transpose, _ in _transformer_layout(_transformer_dims_sd(sd)):
                node = core
                for k in flax_path[:-1]:
                    node = node.setdefault(k, {})
                t = sd[f"core.{key}"]
                node[flax_path[-1]] = _np32(t.T if transpose else t)
            tree[top] = core
        elif top == "core":
            H = sd["core.wh"].shape[0]
            core = {}
            for k, g in enumerate(GATES):
                cols = slice(k * H, (k + 1) * H)
                core[f"i{g}"] = {"kernel": _np32(sd["core.wx"][:, cols])}
                core[f"h{g}"] = {"kernel": _np32(sd["core.wh"][:, cols]), "bias": _np32(sd["core.b"][cols])}
            tree[top] = core
        elif f"{top}.weight" in sd:
            tree[top] = {"kernel": _np32(sd[f"{top}.weight"].T), "bias": _np32(sd[f"{top}.bias"])}
        elif top != "head_value":
            raise KeyError(f"state dict lacks {top}")
    return {"params": tree}


def flax_param_shapes(config: RunConfig, value_head: bool = True) -> Dict[str, Any]:
    """The Flax ``Policy`` param tree's shapes (``{"params": {...}}``, leaves
    are shape tuples) for ``config``, without JAX."""
    m, o, a = config.model, config.obs, config.actions
    E, H = m.unit_embed_dim, m.hidden_dim

    def dense(i: int, n: int) -> Dict[str, Tuple[int, ...]]:
        return {"kernel": (i, n), "bias": (n,)}

    hs = a.head_sizes
    if m.core == "transformer":
        core: Dict[str, Any] = {}
        dims = (H, m.n_heads, m.context_window + 1, m.n_layers, m.moe_experts)
        for flax_path, _, _, shape in _transformer_layout(dims):
            node = core
            for k in flax_path[:-1]:
                node = node.setdefault(k, {})
            node[flax_path[-1]] = shape
    else:
        core = {**{f"i{g}": {"kernel": (H, H)} for g in GATES}, **{f"h{g}": dense(H, H) for g in GATES}}
    tree: Dict[str, Any] = {
        "unit_encoder": {"Dense_0": dense(o.unit_features, E), "Dense_1": dense(E, E)},
        "hero_embed": {"embedding": (m.n_hero_ids, m.hero_embed_dim)},
        "globals_proj": dense(o.global_features, E),
        "trunk_proj": dense(3 * E + m.hero_embed_dim, H),
        "core": core,
        "head_action_type": dense(H, hs["action_type"]),
        "head_move_x": dense(H, hs["move_x"]),
        "head_move_y": dense(H, hs["move_y"]),
        "head_ability": dense(H, hs["ability"]),
        "target_query": dense(H, E),
    }
    if value_head:
        tree["head_value"] = dense(H, 1)
    return {"params": tree}


def random_flax_params(
    config: RunConfig, seed: int, value_head: bool = True
) -> Dict[str, Any]:
    """A Flax-shaped param tree of f32 numpy arrays drawn from ``seed``:
    kernels, the MoE gate and its expert matrices N(0, 1/fan_in), biases
    N(0, 0.01), everything else (embeddings, LayerNorm scales, gate biases,
    position biases) N(0, 1)."""
    rng = np.random.default_rng(seed)

    def fill(node: Any, name: str = "") -> Any:
        if isinstance(node, dict):
            return {k: fill(v, k) for k, v in sorted(node.items())}
        if name in ("kernel", "gate", "expert_w1", "expert_w2"):
            scale = 1.0 / np.sqrt(node[-2])
        else:
            scale = 0.1 if name in ("bias", "expert_b1", "expert_b2") else 1.0
        return (rng.standard_normal(node) * scale).astype(np.float32)

    return fill(flax_param_shapes(config, value_head))
