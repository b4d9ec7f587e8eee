"""Runtime configuration of the PyTorch port.

A copy of ``alphazero_risk_tpu/config.py``: the port imports nothing of the
JAX package, so it keeps its own ``Config`` with the same fields and
defaults, and the same constants.  Fields that only the JAX package reads
(mesh axis, device replay, compile-time notes) stay so that one config
value means the same thing in both packages.

Defaults mirror the reference's default build exactly:
``STATE_SIMPLE_CARDS=on``, ``FAST_ATTACK_MOBILIZATION=on``,
``INPUT_VECTOR_TYPE_2`` (13 feature planes), 20 residual blocks.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Config:
    # ---- Game rules (reference: src/settings.h:51-57, state.h:22) ----
    land_army_max: int = 32           # max armies on one territory
    min_unit_move: int = 3            # granularity of unit movements
    max_game_rounds: int = 30 + 28    # hard round cap (58)
    allow_yield: bool = True          # losing player yields at 30 enemy lands
    limit_reinforcement_moves: bool = True   # only border lands reinforceable
    limit_attack_moves: bool = False  # force attacking while possible
    mirror_games: bool = True         # pair games share the initial map
    # Reference compile-time flags (CMakeLists.txt:18-21).
    fast_attack_mobilization: bool = True  # move half-stacks instead of 3s
    simple_cards: bool = True         # cards are counts, not per-territory
    round_weighted_value: bool = False

    # ---- MCTS (reference: src/settings.h:45,61-64) ----
    mcts_simulations: int = 32
    cpuct: float = 1.1                # HP_EXPLORATION
    noise_value: float = 0.3          # DIR_NOISE_VALUE (constant policy blend)
    noise_eps: float = 0.25           # DIR_NOISE_EPSI
    temperature_threshold: int = 15 + 28  # sample (vs argmax) below this round
    # Array-MCTS sizing.
    max_nodes: int = 0                # 0 -> derived from mcts_simulations
    max_depth: int = 48               # max in-tree path length per simulation
    use_dirichlet_noise: bool = False  # true Dirichlet at root (ref uses blend)
    tree_reuse: bool = False          # carry the chosen subtree across moves
    #   (self-play path; reference trimNodes semantics,
    #    alphazero_mcts.cpp:229-245)

    # ---- Network (reference: python/src/build_graph.py:30-35) ----
    blocks: int = 20
    filters: int = 256
    value_hidden: int = 256
    l2_coeff: float = 1e-3
    learning_rate: float = 1e-3
    feature_version: int = 2          # INPUT_VECTOR_TYPE_{1,2,3}

    # ---- Training (reference: src/settings.h:59-81) ----
    train_iterations: int = 10_000
    train_iteration_games: int = 1000
    epochs: int = 10
    batch_size: int = 512
    samples_storage_min_batches: int = 1024   # * batch_size samples
    samples_storage_max_batches: int = 16384  # * batch_size samples
    # Largest replay slice uploaded to the device at once by the learner
    # epoch.  The reference streams minibatches from host RAM
    # (alphazero_nn.cpp:351-410); the JAX learner uploads one resident
    # slice and scans minibatches out of it, so a very large buffer must
    # train as consecutive fixed-size chunks.  0 = unlimited.
    train_upload_max_samples: int = 1_500_000
    compare_games: int = 1000
    compare_threshold: float = 0.55
    include_compare_games_train_samples: bool = True
    # Sequential early stopping for the gating arena: cut the arena the
    # moment the accept/reject verdict is statistically decided instead of
    # always playing all compare_games (round-3 finding: t_gate dominated
    # self-play wall-clock 12:1).  z=2.24 ~ one-sided 98.75% each way;
    # set arena_early_stop=False for the reference's full-length behavior.
    arena_early_stop: bool = True
    arena_early_stop_z: float = 2.24
    arena_early_stop_min_games: int = 96
    benchmark_games_random: int = 10
    benchmark_games_script: int = 100
    training_revert_model: bool = True
    data_games_ss: int = 5000
    data_games_sr: int = 5000
    data_train_loops: int = 1000

    # ---- Inference fast path (no reference analog) ----
    fast_infer: bool = False          # actors/arenas run the BN-folded
    #   bf16/int8 trunk (models/fast_infer.py) instead of the Flax forward
    fast_infer_int8: bool = False     # quantize the folded trunk to int8
    device_replay: bool = False       # device-resident replay ring: the
    #   selfplay->train loop never moves samples over the host link
    #   (training/device_replay.py; single-process only)

    # ---- Vectorized execution (replaces thread counts
    # NUMBER_OF_GPUS / NUMBER_OF_CONCURENT_GAMES_PER_GPU / THREADS_PER_MCTS,
    # reference src/settings.h:41-44) ----
    env_batch_per_device: int = 1024  # lockstep games per device
    max_game_steps: int = 4096        # micro-decision cap per game (safety)
    actor_chunk_steps: int = 128      # micro-steps per device dispatch
    #   (bounds single-execution time and allows early stop on all-done)
    dp_axis: str = "dp"               # data-parallel mesh axis name
    # Fortify-source tie-break: True = the reference's exact DFS pre-order
    # first-strict-max (trajectory parity; costs a bounded sequential
    # loop in step), False = lowest-index
    # tie-break (identical play except when two candidate sources tie on
    # max armies)
    exact_fortify_tiebreak: bool = True

    # ---- Paths / IO ----
    checkpoint_dir: str = "checkpoints"
    data_dir: str = "data"
    log_dir: str = "log"

    # ---- Derived ----
    @property
    def samples_storage_min(self) -> int:
        return self.samples_storage_min_batches * self.batch_size

    @property
    def samples_storage_max(self) -> int:
        return self.samples_storage_max_batches * self.batch_size

    @property
    def num_features(self) -> int:
        # 3 army planes + broadcast scalars + 6 phase planes
        # (reference: alphazero_nn_data.h:13-64)
        return {1: 12, 2: 13, 3: 14}[self.feature_version]

    @property
    def num_nodes(self) -> int:
        """Node budget for the array MCTS tree: each simulation expands at
        most one node, +1 for the root (+1 slack); with tree_reuse the
        carried subtree can hold up to another simulations' worth."""
        if self.max_nodes:
            return self.max_nodes
        budget = self.mcts_simulations + 2
        if self.tree_reuse:
            budget += self.mcts_simulations
        return budget

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = Config()

# Action space: 42 territories + skip (reference: alphazero_moves.cpp:3-92).
NUM_LANDS = 42
NUM_ACTIONS = NUM_LANDS + 1
SKIP_ACTION = NUM_LANDS

# Board image layout (reference: state.h:18-19).
MAP_Y = 7
MAP_X = 6

# Players (reference: state.h:13,38).
NUM_PLAYERS = 2
NEUTRAL_PLAYER = 2

# Phases (reference: state.h:49-57).
PH_SETUP = 0
PH_SETUP_NEUTRAL = 1
PH_REINFORCEMENT = 2
PH_ATTACK = 3
PH_ATTACK_MOBILIZATION = 4
PH_FORTIFY = 5
NUM_PHASES = 6

# Game status codes (reference: state.h:123-124, state.cpp:518-565).
STATUS_NOT_ENDED = -1
STATUS_DRAW = -2
