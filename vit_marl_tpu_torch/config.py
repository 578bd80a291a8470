"""Configuration: frozen dataclasses for engine, world, agents, training.

The PyTorch port's own copy of ``vit_marl_tpu/config.py`` (the port imports
nothing of the JAX package).  Field names, defaults and the YAML/dict
override merge (:func:`make_config`, including the string coercion of YAML
1.1 e-notation) are identical, so one YAML file configures both packages.
Fields the port does not read yet (mesh, checkpointing, eval) are kept
so every shipped config loads unchanged.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Any, Dict, List, Optional, Tuple

# --------------------------------------------------------------------------
# Constants (ref: jaxob_constants.py)
# --------------------------------------------------------------------------

MAX_INT32 = 2_147_483_647

INIT_ID = -2          # order id tag for book-initialisation orders
DUMMY_ID = -888_888
EMPTY_SLOT = -1       # value marking an empty book/trade slot

NS_PER_SEC = 1_000_000_000

START_OF_DAY = (34_200, 0)   # 09:30:00
END_OF_DAY = (57_600, 0)     # 16:00:00


class MsgType(IntEnum):
    """LOBSTER message types (ref: jaxob_constants.py:27-34)."""

    LIMIT = 1
    CANCEL = 2
    DELETE = 3
    MATCH = 4
    HIDDEN = 5
    AUCTION = 6
    HALT = 7


class Side(IntEnum):
    """Side convention: bid=+1, ask=-1 (ref: jaxob_constants.py:56-58)."""

    BID = 1
    ASK = -1


class CancelMode(IntEnum):
    """Cancel fallback behaviour (ref: jaxob_constants.py:62-66)."""

    STRICT_BY_ID = 0
    INCLUDE_INITS = 1
    CANCEL_UNIFORM = 2
    CANCEL_UNIFORM_AND_LARGE = 3


class SimulatorMode(IntEnum):
    GENERAL_EXCHANGE = 0
    LOBSTER_INTERPRETER = 1


# Message vector layout, (8,) int32 (ref: jaxob_constants.py:76-83):
#   [type, side, quant, price, order_id, trader_id, time_s, time_ns]
class MsgCol(IntEnum):
    TYPE = 0
    SIDE = 1
    QUANT = 2
    PRICE = 3
    OID = 4
    TID = 5
    TIME_S = 6
    TIME_NS = 7


# Trade log row layout, (8,) int32 (ref: jaxob_constants.py:44-52):
#   [price, +-quant, passive_oid, aggressive_oid, time_s, time_ns,
#    passive_tid, aggressive_tid]; quant sign is -side of the aggressor.
class TradeCol(IntEnum):
    PRICE = 0
    QUANT = 1
    PASS_OID = 2
    AGR_OID = 3
    TIME_S = 4
    TIME_NS = 5
    PASS_TID = 6
    AGR_TID = 7


# --------------------------------------------------------------------------
# Engine config (ref: jaxob_config.py:11-28)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class EngineConfig:
    """Static configuration of the matching engine.

    Frozen + hashable.
    """

    # Capacities default to 128 (reference uses 100, jaxob_config.py:19-20):
    # 128 is sublane-tile-aligned, which keeps the fused Pallas book kernel
    # eligible (WorldEnv.pallas_ok) in every default/YAML config.
    n_orders: int = 128           # capacity per book side
    n_trades: int = 128           # trade-log capacity
    cancel_mode: int = CancelMode.INCLUDE_INITS
    simulator_mode: int = SimulatorMode.GENERAL_EXCHANGE
    init_id: int = INIT_ID
    maxint: int = MAX_INT32
    seed: int = 42


# --------------------------------------------------------------------------
# World config (ref: jaxob_config.py:158-183)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class WorldConfig(EngineConfig):
    """Episode / data-window / world-level configuration."""

    n_data_msg_per_step: int = 100
    window_selector: int = -1        # -1: random window at reset
    ep_type: str = "fixed_steps"     # "fixed_steps" | "fixed_time"
    episode_time: int = 50           # steps (fixed_steps) or seconds (fixed_time)
    day_start: int = 34_200
    day_end: int = 57_600
    book_depth: int = 10             # L2 levels exposed to observations
    n_ticks_in_book: int = 10
    tick_size: int = 100
    trader_id_range_start: int = -100
    placeholder_order_id: int = -9
    last_step_seconds: int = 5
    artificial_id_end_episode: int = -666_666
    order_id_counter_start: int = -200
    shuffle_action_messages: bool = True
    start_resolution: int = 50       # a window starts every n seconds of data
    debug_mode: bool = False
    # data selection
    data_path: str = ""              # empty -> synthetic data
    stock: str = "SYNTH"
    time_period: str = "oneday"
    n_synthetic_days: int = 1
    n_messages_per_synthetic_day: int = 50_000
    cache_dir: str = ""              # empty -> no on-disk caching


# --------------------------------------------------------------------------
# Agent configs (ref: jaxob_config.py:31-154)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class MarketMakingConfig:
    """Market-making agent configuration (ref: jaxob_config.py:31-100)."""

    agent_kind: str = "market_making"
    short_name: str = "MM"
    # "fixed_prices" | "fixed_quants" | "AvSt" | "spread_skew"
    # | "directional_trading" | "simple"
    action_space: str = "spread_skew"
    # "engineered" | "basic" | "simplest"
    observation_space: str = "engineered"
    spread_multiplier: float = 3.0
    skew_multiplier: float = 5.0
    n_ticks_in_book: int = 1
    fixed_quant_value: int = 10
    n_actions: int = 8               # only free for fixed_prices
    time_delay_obs_act: int = 0
    normalize: bool = True
    seconds_before_episode_end: int = 5
    fixed_action_setting: bool = False
    fixed_action: int = 0
    sell_buy_all_option: bool = False
    simple_nothing_action: bool = True
    # reward
    inv_penalty: str = "none"        # "none"|"linear"|"quadratic"|"threshold"
    reward_space: str = "buy_sell_pnl"
    # "zero_inv"|"pnl"|"buy_sell_pnl"|"complex"|"portfolio_value"
    # |"portfolio_value_scaled"|"spooner"|"spooner_damped"|"spooner_scaled"
    # |"delta_netWorth"|"weight_pnl_inventory_pnl"
    reference_price_portfolio_value: str = "mid"
    inv_penalty_lambda: float = 1.0
    inv_penalty_quadratic_factor: float = 50.0
    multiplier_type: str = "tick"
    clip_reward: bool = False
    based_on_mid_price_of_action: bool = True
    exclude_extreme_spreads: bool = False
    inventoryPnL_lambda: float = 0.5
    unrealizedPnL_lambda: float = 0.1
    asymmetrically_dampened_lambda: float = 0.8

    @property
    def num_action_messages(self) -> int:
        """Action (non-cancel) messages per step (ref: jaxob_config.py:75-100)."""
        if self.action_space == "fixed_prices":
            return self.n_actions
        return 2

    @property
    def num_messages(self) -> int:
        """Total messages contributed per step (cancels + actions)."""
        return 2 * self.num_action_messages

    @property
    def num_actions(self) -> int:
        """Size of the discrete action head (ref: jaxob_config.py:75-100)."""
        return {
            "fixed_quants": 8,
            "spread_skew": 6,
            "directional_trading": 3,
            "AvSt": 8,
            "simple": 4,
            "fixed_prices": self.n_actions,
        }[self.action_space]


@dataclass(frozen=True)
class ExecutionConfig:
    """Execution agent configuration (ref: jaxob_config.py:103-154)."""

    agent_kind: str = "execution"
    short_name: str = "EXE"
    task: str = "random"             # "random" | "buy" | "sell"
    # "fixed_quants" | "fixed_prices" | "fixed_quants_complex"
    # | "simplest_case" | "fixed_quants_1msg" | "twap" | "twap_v3"
    # | "policy_blending"
    action_space: str = "fixed_quants_complex"
    # fixed_prices only: "pure" sends the action as quantities; "delta" adds
    # the action to a twapV3 baseline (two-level permuted split, market-order
    # switch in the last 60s; ref: vision_env.py:577-610, jaxob_config.py:107)
    action_type: str = "pure"
    # "engineered" | "basic" | "simplest_case" | "execution_policy"
    observation_space: str = "engineered"
    reward_space: str = "normal"     # "normal"|"finish_fast"|"simplest_case"|"dual_ppo"
    task_size: int = 500
    n_actions: int = 5               # only free for fixed_prices
    fixed_quant_value: int = 10
    n_ticks_in_book: int = 1
    reward_lambda: float = 0.5
    time_delay_obs_act: int = 0
    normalize: bool = True
    seconds_before_episode_end: int = 5
    doom_price_penalty: float = 0.1
    larger_far_touch_quant: bool = False
    # Dual-PPO / vision additions (ref: jaxen/vision_env.py)
    mimic_alpha: float = 0.5         # weight of the TWAP-mimic reward term
    vision_levels: int = 10          # book-image level count
    use_vision_obs: bool = False     # emit {obs, vision_obs} dict observations
    # policy_blending only. The reference places ONLY passive orders at the
    # top-3 own-side levels (vision_env.py:1426-1534), so at short horizons
    # almost nothing fills and the episode-end doom trade dominates the
    # dual_ppo reward — r_comp carries no gradient (the reference never
    # trained this path: '# FIXME: APPLY VISION'). With this DIVERGENCE
    # flag on, blend level 1 crosses the spread (far touch) so fills — and
    # hence r_comp gradient — exist at any horizon; levels 2-3 stay passive.
    blend_aggressive: bool = False

    @property
    def num_action_messages(self) -> int:
        # policy_blending keeps the reference's default of 4 slots
        # (3 level orders + 1 zero row, ref: vision_env.py:1521-1524)
        return {
            "fixed_quants": 4,
            "fixed_quants_complex": 4,
            "fixed_prices": self.n_actions,
            "simplest_case": 2,
            "fixed_quants_1msg": 1,
            "twap": 2,
            "twap_v3": 2,
            "policy_blending": 4,
        }[self.action_space]

    @property
    def num_messages(self) -> int:
        return 2 * self.num_action_messages

    @property
    def num_actions(self) -> int:
        if self.action_space == "policy_blending":
            return 3  # continuous Box(3,) action
        return {
            "fixed_quants": 5,
            "fixed_quants_complex": 13,
            "fixed_prices": self.n_actions,
            "simplest_case": 3,
            "fixed_quants_1msg": 5,
            # the reference pins the twap baseline to a single always-FT
            # action (jaxob_config.py:151 n_actions=1); the NT row of
            # _action_twap's quant table is deliberately unreachable
            "twap": 1,
            "twap_v3": 1,
        }[self.action_space]

    @property
    def is_continuous(self) -> bool:
        return self.action_space == "policy_blending"


AgentConfig = Any  # MarketMakingConfig | ExecutionConfig


@dataclass(frozen=True)
class MultiAgentConfig:
    """World + per-agent-type config aggregate (ref: jaxob_config.py:185-199)."""

    world: WorldConfig = field(default_factory=WorldConfig)
    agents: Tuple[AgentConfig, ...] = field(
        default_factory=lambda: (MarketMakingConfig(), ExecutionConfig())
    )
    n_agents_per_type: Tuple[int, ...] = (1, 1)

    def __post_init__(self):
        assert len(self.agents) == len(self.n_agents_per_type)

    @property
    def num_msgs_per_step(self) -> int:
        """Fixed message budget per env step (ref: marl_env.py:124-133)."""
        total = self.world.n_data_msg_per_step
        for cfg, n in zip(self.agents, self.n_agents_per_type):
            total += cfg.num_messages * n
        return total


# --------------------------------------------------------------------------
# Training config (ref: jaxrl/MARL/config/*.yaml)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class TrainConfig:
    """IPPO training hyper-parameters (ref: config/ippo_rnn_JAXMARL*.yaml)."""

    lr: float = 2.5e-4
    num_envs: int = 256
    num_steps: int = 128
    total_timesteps: float = 1e6
    update_epochs: int = 4
    num_minibatches: int = 4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    ent_coef: float = 0.01
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    anneal_lr: bool = True
    fc_dim: int = 64
    hidden_size: int = 64
    # network per agent type: "gru" | "vit_gru" | "cnn_gru"
    network: Tuple[str, ...] = ("gru", "gru")
    # rollout collection: "auto" (loop on TPU, scan elsewhere) | "scan" |
    # "loop" | "pipeline" (split-batch software pipeline, rl/pipeline.py:
    # env step for one half merged into one program with the policy
    # forward for the other; even NUM_ENVS, single-device only)
    rollout_mode: str = "auto"
    # periodic greedy evaluation on a held-out env (0 = off)
    # (ref: ippo_rnn_JAXMARL.py:579-678 CALC_EVAL)
    eval_every: int = 0
    eval_steps: int = 32
    eval_envs: int = 0               # 0 -> num_envs
    # Held-out evaluation data (ref: ippo_rnn_JAXMARL.py:195-221 builds the
    # eval env on a different timePeriod).  For LOBSTER data set a different
    # time period; for synthetic data a different generator seed.  When both
    # are unset and eval_every is on, a synthetic-data eval env defaults to
    # seed+1 so periodic eval is never in-sample.
    eval_time_period: str = ""
    eval_data_seed: int = -1         # -1 -> auto (world seed + 1 on synthetic)
    # LOBSTER data + unset EVAL_TIME_PERIOD is a hard error (the eval env
    # would silently be in-sample); this opts back in for smoke configs.
    eval_allow_in_sample: bool = False
    vit_preset: str = "tiny"         # "tiny" | "small" | "base" | "micro"
    # The vit_* switches below keep the JAX package's names and defaults so
    # that every YAML file loads to the same values in both packages.  What
    # each one does in the port:
    # - vit_attn_kernel / vit_attn_bwd_kernel: attention forward / backward
    #   through the CUDA kernels of ops/attention_kernel.py; False runs the
    #   XLA-form attention in plain ops (forward) or differentiates it
    #   (backward).
    # - vit_attn_env_block: accepted and unused (the CUDA kernels take any
    #   batch of images).
    # - vit_attn_ln_fold: LN1+QKV+attention in one CUDA kernel; vit_fused_
    #   block: LN1+QKV and proj+LN2+MLP kernels around the XLA-form
    #   attention; vit_fused_block_full (before vit_fused_block): the whole
    #   block in one kernel (ops/block_kernel.py).
    vit_fused_block: bool = False
    vit_fused_block_full: bool = False
    vit_attn_kernel: bool = True
    vit_attn_bwd_kernel: bool = True
    vit_attn_env_block: int = 64
    vit_attn_ln_fold: bool = False
    seed: int = 30
    # distributed
    mesh_shape: Tuple[int, ...] = ()   # () -> single device
    mesh_axes: Tuple[str, ...] = ("data",)
    # checkpointing
    checkpoint_dir: str = ""
    checkpoint_max_to_keep: int = 2
    # save every K updates (the reference saves every update, which for a
    # ViT-sized policy moves ~90 MB of params per update; the final update
    # always saves).  Checkpoints also carry optimizer state for resume —
    # Adam roughly triples the payload — so prefer checkpoint_every >= 10
    # for big networks (the shipped session scripts use 10)
    checkpoint_every: int = 1
    # resume from the latest checkpoint in checkpoint_dir (params +
    # optimizer state + step; the update loop continues at the saved
    # update index).  The reference has no mid-training resume — a killed
    # run restarts at update 0 (SURVEY.md section 5) — but TPU sessions
    # here die to relay outages, so resume is first-class.  Env states and
    # RNG streams restart fresh (on-policy PPO only needs them for the
    # next rollout).
    resume: bool = False
    # logging
    log_backend: str = "print"       # "print" | "jsonl" | "wandb" | "none"
    log_path: str = "metrics.jsonl"
    # per-update observability parity with the reference's wandb callback
    # (ref: ippo_rnn_JAXMARL.py:680-763): per-agent action-distribution
    # percentages + mean/std of every env info field (train and eval).
    # Reductions run on device inside the update jit; disable to shave the
    # last few scalars off the metrics dict.
    log_env_info: bool = True

    @property
    def num_updates(self) -> int:
        return int(self.total_timesteps // (self.num_steps * self.num_envs))

    @property
    def minibatch_size(self) -> int:
        return self.num_envs // self.num_minibatches


# --------------------------------------------------------------------------
# Dict/YAML override merging (tier 2)
# --------------------------------------------------------------------------


def _merge_dataclass(obj, overrides: Dict[str, Any],
                     strict_label: Optional[str] = None,
                     extra_allowed: frozenset = frozenset()):
    """Return a copy of dataclass ``obj`` with matching keys replaced.

    Keys are matched case-insensitively against field names, mirroring the
    reference's lowercased-key YAML merge (ref: ippo_rnn_JAXMARL.py:144-163).
    With ``strict_label`` set, keys that match no field (and are not in
    ``extra_allowed``) raise instead of being silently dropped — a typo'd
    override that does nothing is worse than an error.
    """
    fields = {f.name.lower(): f.name for f in dataclasses.fields(obj)}
    kwargs = {}
    for key, val in overrides.items():
        name = fields.get(key.lower())
        if name is not None:
            # Coerce string values to the field's runtime type: YAML 1.1
            # parses unsigned e-notation ("3.0e6") as a STRING, so every
            # shipped TOTAL_TIMESTEPS loaded as str and num_updates
            # crashed on str//int unless a --set override masked it.
            cur = getattr(obj, name)
            if isinstance(val, str):
                if isinstance(cur, bool):
                    val = val.strip().lower() in ("1", "true", "yes", "on")
                elif isinstance(cur, int):
                    val = int(float(val))
                elif isinstance(cur, float):
                    val = float(val)
            kwargs[name] = val
        elif strict_label and key.lower() not in extra_allowed:
            raise ValueError(
                f"unknown config key {key!r} in {strict_label} (no such "
                f"field on {type(obj).__name__}; known fields: "
                f"{sorted(fields.values())})")
    return dataclasses.replace(obj, **kwargs) if kwargs else obj


_AGENT_KINDS = {
    "marketmaking": MarketMakingConfig,
    "market_making": MarketMakingConfig,
    "mm": MarketMakingConfig,
    "execution": ExecutionConfig,
    "exec": ExecutionConfig,
    "exe": ExecutionConfig,
}


def make_config(raw: Optional[Dict[str, Any]] = None) -> Tuple[MultiAgentConfig, TrainConfig]:
    """Build (MultiAgentConfig, TrainConfig) from a plain-dict config.

    ``raw`` layout (all sections optional)::

        {"WORLD": {...}, "AGENT_CONFIGS": {"MarketMaking": {...},
         "Execution": {...}}, "NUM_AGENTS_PER_TYPE": [1, 1], ...train keys}
    """
    raw = dict(raw or {})
    world = _merge_dataclass(WorldConfig(), raw.get("WORLD", {}),
                             strict_label="WORLD")
    agent_cfgs: List[AgentConfig] = []
    agents_raw = raw.get("AGENT_CONFIGS", {"MarketMaking": {}, "Execution": {}})
    for kind, overrides in agents_raw.items():
        cls = _AGENT_KINDS[kind.lower().replace(" ", "")]
        agent_cfgs.append(_merge_dataclass(
            cls(), overrides or {}, strict_label=f"AGENT_CONFIGS.{kind}"))
    n_per_type = tuple(raw.get("NUM_AGENTS_PER_TYPE", [1] * len(agent_cfgs)))
    ma = MultiAgentConfig(world=world, agents=tuple(agent_cfgs), n_agents_per_type=n_per_type)
    train = _merge_dataclass(
        TrainConfig(), raw, strict_label="top level",
        extra_allowed=frozenset(
            {"world", "agent_configs", "num_agents_per_type"}))
    return ma, train


def load_yaml_config(path: str) -> Tuple[MultiAgentConfig, TrainConfig]:
    """Load a YAML run config (tier-2) and merge onto the dataclasses."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    return make_config(raw)
