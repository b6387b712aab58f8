"""Frozen dataclass configuration tree of the PyTorch port.

A field-for-field copy of the JAX package's ``config.py`` (the port imports
nothing of that package), so one JSON config tree configures either side.
Every knob keeps its name and default; the long rationale behind each lives
beside the original.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping, Tuple


@dataclasses.dataclass(frozen=True)
class ObsSpec:
    """Fixed-shape observation layout: no shape depends on the live unit
    count."""

    max_units: int = 32          # padded unit slots per observation
    unit_features: int = 22      # per-unit feature vector length
    global_features: int = 8     # game-time, team, gold/xp diffs, ...
    max_abilities: int = 4       # ability slots exposed per hero


@dataclasses.dataclass(frozen=True)
class ActionSpec:
    """Discrete multi-head action space."""

    n_action_types: int = 4      # noop / move / attack-unit / cast
    move_bins: int = 9           # discretized move offsets per axis
    max_units: int = 32          # target-unit head size == padded unit slots
    max_abilities: int = 4

    @property
    def head_sizes(self) -> Mapping[str, int]:
        return {
            "action_type": self.n_action_types,
            "move_x": self.move_bins,
            "move_y": self.move_bins,
            "target_unit": self.max_units,
            "ability": self.max_abilities,
        }


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Policy hyper-parameters (LSTM(128) core)."""

    unit_embed_dim: int = 64
    hidden_dim: int = 128        # LSTM hidden size
    n_hero_ids: int = 32         # hero-embedding vocabulary
    hero_embed_dim: int = 16
    core: str = "lstm"           # "lstm" | "transformer"
    n_layers: int = 2
    n_heads: int = 4
    context_window: int = 16
    moe_experts: int = 0
    moe_capacity_factor: float = 2.0
    dtype: str = "bfloat16"      # compute dtype; params stay float32
    param_dtype: str = "float32"


ADV_NORM_MODES = ("batch", "none")
ADVANTAGE_MODES = ("gae", "vtrace")
ADVANTAGE_STORE_DTYPES = ("bfloat16", "float32")


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    value_coef: float = 0.5
    entropy_coef: float = 0.01
    learning_rate: float = 3e-4
    max_grad_norm: float = 0.5
    rollout_len: int = 16        # truncated-BPTT chunk length T
    batch_rollouts: int = 32     # rollouts per optimizer step (B)
    epochs_per_batch: int = 1
    minibatches: int = 1
    max_staleness: int = 4
    moe_aux_coef: float = 0.01
    adv_norm: str = "batch"      # one of ADV_NORM_MODES
    adv_norm_floor: float = 0.0
    advantage: str = "gae"       # one of ADVANTAGE_MODES
    vtrace_rho_clip: float = 1.0
    vtrace_c_clip: float = 1.0
    value_warmup_steps: int = 0
    kl_target: float = 0.0
    anchor_kl_coef: float = 0.0
    kl_lr_down: float = 0.7
    kl_lr_up: float = 1.02
    kl_lr_min_scale: float = 0.01
    kl_lr_max_scale: float = 10.0
    # kept for the reference's configs; the port runs one epoch step either way
    fused_epoch: bool = True
    one_pass_advantage: bool = True
    advantage_dtype: str = "bfloat16"

    @property
    def steps_per_batch(self) -> int:
        return self.epochs_per_batch * max(1, self.minibatches)


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    n_envs: int = 8
    ticks_per_observation: int = 6
    max_dota_time: float = 600.0
    hero_pool: Tuple[int, ...] = (1,)
    team_size: int = 1
    opponent: str = "scripted_easy"
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class RewardConfig:
    """Shaped-reward component weights."""

    xp: float = 0.002
    gold: float = 0.006
    hp: float = 2.0
    enemy_hp: float = 1.0
    last_hits: float = 0.16
    denies: float = 0.12
    kills: float = 1.0
    deaths: float = -1.0
    tower_damage: float = 2.0
    own_tower: float = 2.0
    win: float = 5.0

    def as_dict(self) -> Mapping[str, float]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data_axis: str = "data"
    model_axis: str = "model"
    dcn_axis: str = "dcn"
    data_parallel: int = -1
    model_parallel: int = 1
    dcn_slices: int = 1


@dataclasses.dataclass(frozen=True)
class BufferConfig:
    capacity_rollouts: int = 256
    min_fill: int = 32
    staging_slots: int = 2
    consume_poll_timeout_s: float = 0.001
    max_weight_staleness: int = -1
    reject_nonfinite: bool = True


@dataclasses.dataclass(frozen=True)
class TransportConfig:
    wire_dtype: str = "float32"
    rollout_wire_dtype: str = "float32"
    fanout_max_lag: int = 8
    shm_slots: int = 16
    shm_ring_bytes: int = 8 * 1024 * 1024
    shm_weights_bytes: int = 32 * 1024 * 1024
    poison_frame_limit: int = 8
    heartbeat_interval_s: float = 5.0
    idle_timeout_s: float = 30.0


@dataclasses.dataclass(frozen=True)
class LearnerConfig:
    async_snapshots: bool = True
    snapshot_drain_timeout_s: float = 60.0
    overlap_advantage: bool = True


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    enabled: bool = True
    ema_alpha: float = 0.02
    explosion_band: float = 100.0
    warmup_steps: int = 50
    max_rollbacks: int = 3


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Low-latency policy-serving plane: a continuous-batching engine
    collects per-game step requests until ``batch_window_ms`` elapses or
    ``max_batch`` requests are staged, runs one dispatch over the padded
    batch with server-resident recurrent carries, and replies per game."""

    # Batch-collection deadline; 0 dispatches whatever is pending at once.
    batch_window_ms: float = 2.0
    # Rows per dispatch (the padded batch's static shape).
    max_batch: int = 64
    # Server-resident carry slots = concurrently attached games.
    max_slots: int = 256
    request_wire_dtype: str = "float32"
    weights_poll_s: float = 0.5
    # Base seed of the sampling stream: dispatch i draws its noise from a
    # generator seeded from (seed, i), the stream reference_step replays.
    seed: int = 0
    request_deadline_s: float = 10.0
    request_retries: int = 4
    router_probe_s: float = 1.0
    router_dead_after_s: float = 3.0
    # Replies carry the updated carry row; a re-homed session resends it.
    carry_shadow: bool = False


@dataclasses.dataclass(frozen=True)
class LeagueConfig:
    enabled: bool = False
    pool_size: int = 8
    snapshot_every: int = 200
    selfplay_prob: float = 0.5
    matchmaking: str = "pfsp"
    pfsp_power: float = 2.0
    opponent_hold: int = 64
    anchor_prob: float = 0.0
    anchor_opponent: str = "scripted_hard"
    anchor_easy_share: float = 0.5


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Top-level config tree."""

    obs: ObsSpec = ObsSpec()
    actions: ActionSpec = ActionSpec()
    model: ModelConfig = ModelConfig()
    ppo: PPOConfig = PPOConfig()
    env: EnvConfig = EnvConfig()
    reward: RewardConfig = RewardConfig()
    mesh: MeshConfig = MeshConfig()
    buffer: BufferConfig = BufferConfig()
    transport: TransportConfig = TransportConfig()
    learner: LearnerConfig = LearnerConfig()
    health: HealthConfig = HealthConfig()
    serve: ServeConfig = ServeConfig()
    league: LeagueConfig = LeagueConfig()
    checkpoint_dir: str = "checkpoints"
    checkpoint_every: int = 100
    checkpoint_best_min_episodes: int = 50
    steps_per_dispatch: int = 1
    log_every: int = 10
    seed: int = 0

    def replace(self, **kwargs: Any) -> "RunConfig":
        return dataclasses.replace(self, **kwargs)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "RunConfig":
        raw = json.loads(text)
        return cls(
            obs=ObsSpec(**raw["obs"]),
            actions=ActionSpec(**raw["actions"]),
            model=ModelConfig(**raw["model"]),
            ppo=PPOConfig(**raw["ppo"]),
            env=EnvConfig(**{**raw["env"], "hero_pool": tuple(raw["env"]["hero_pool"])}),
            reward=RewardConfig(**raw.get("reward", {})),
            mesh=MeshConfig(**raw["mesh"]),
            buffer=BufferConfig(**raw["buffer"]),
            transport=TransportConfig(**raw.get("transport", {})),
            learner=LearnerConfig(**raw.get("learner", {})),
            health=HealthConfig(**raw.get("health", {})),
            serve=ServeConfig(**raw.get("serve", {})),
            league=LeagueConfig(**raw["league"]),
            checkpoint_best_min_episodes=raw.get(
                "checkpoint_best_min_episodes",
                cls.checkpoint_best_min_episodes,
            ),
            steps_per_dispatch=raw.get(
                "steps_per_dispatch", cls.steps_per_dispatch
            ),
            **{k: raw[k] for k in ("checkpoint_dir", "checkpoint_every", "log_every", "seed")},
        )


def default_config() -> RunConfig:
    return RunConfig()
