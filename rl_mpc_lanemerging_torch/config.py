"""Typed, frozen configuration system.

The PyTorch port's own copy of ``rl_mpc_lanemerging_tpu/config.py``: the
reference's mutable ``Settings`` class singleton (reference: config.py:7-155)
becomes an immutable, hashable dataclass that every solver/sim function takes
as an argument, so grid shapes and weights are fixed per configuration.

Field names intentionally match the reference's JSON config surface
(reference: config.py + configs/*.json) so the published experiment configs
remain loadable verbatim via :func:`Settings.load_from_file`
(reference: config.py:161-170, including the int-keyed-dict coercion for the
jerk/acceleration action tables, config.py:168-169).
"""

from __future__ import annotations

import dataclasses
import json
import logging
from typing import Any, Tuple

__all__ = ["Settings", "default_settings", "load_settings"]


def _jerk_table(*values: float) -> Tuple[float, ...]:
    return tuple(float(v) for v in values)


@dataclasses.dataclass(frozen=True)
class Settings:
    """All experiment settings; defaults mirror reference config.py:7-155."""

    # --- Task (config.py:10-12) ---
    TASK: str = "ST"
    NUM_EPISODES: int = 2000
    GYM_ENVIRONMENT: str = "sumo-jerk-continuous-v0"

    # --- Logging (config.py:15-20) ---
    LOG_DIR: str = "last_run"
    FULL_LOG_DIR: str = "runs"
    LOG_FILE: str = "out.log"
    LOG_LEVEL: int = logging.INFO
    MODEL_NAME: str = "runs/ddpg_simple_traffic_vary_start_extended"
    INIT_MODEL_NAME: str = ""

    # --- Randomness (config.py:23) ---
    SEED: Any = "Random"  # int or "Random"

    # --- Sim backend selector (config.py:26-27). GUI is meaningless for the
    # vectorized world; kept for config-file compatibility.
    USE_GUI: bool = False
    SYSTEM: str = "Linux"

    # --- Simulation (config.py:30-41) ---
    TICK_LENGTH: float = 0.2
    MAX_POSITIVE_ACCELERATION: float = 4.5
    MAX_NEGATIVE_ACCELERATION: float = -6.0
    MINIMUM_NEGATIVE_JERK: float = -5.0
    MAXIMUM_POSITIVE_JERK: float = 5.0
    MAX_SPEED: float = 30.0
    MERGE_POINT_X: float = -50.0
    CAR_LENGTH: float = 5.0
    USE_ALTERNATE_TRAFFIC_DISTRIBUTION: bool = False
    USE_SIMPLE_TRAFFIC_DISTRIBUTION: bool = True
    TRAFFIC_DENSITY: str = "low"

    # --- Simple traffic distribution (config.py:43-45) ---
    VARY_TRAFFIC_START_TIMES: bool = True
    BASE_TRAFFIC_INTERVAL: float = 1.2
    OTHER_CAR_SPEED: float = 7.0

    # --- Sensors (config.py:48-49) ---
    SENSOR_RADIUS: float = 125.0
    USE_ACCELERATION_OF_OTHER_CARS: bool = True

    # --- Random start speed (config.py:52-56) ---
    START_SPEED: float = 15.0
    RANDOMIZE_START_SPEED: bool = True
    START_SPEED_VARIANCE: float = 5.0
    MIN_START_SPEED: float = 5.0
    MAX_START_SPEED: float = 25.0

    # --- Reward functions (config.py:59-76) ---
    REWARD_FUNCTION: str = "Continuous"
    CRASH_REWARD: float = -10.0
    SUCCESS_REWARD: float = 10.0
    TIME_REWARD: float = -0.1
    WT_SMOOTH: float = 0.1
    WT_SAFE: float = 0.1
    WT_EFFICIENT: float = 0.01
    DESIRED_TTC: float = 3.0
    MIN_FOLLOW_DISTANCE: float = 3.0
    ALT_V_WEIGHT: float = 0.0001
    ALT_A_WEIGHT: float = 0.01
    ALT_J_WEIGHT: float = 0.05
    ALT_D_WEIGHT: float = 0.05

    # --- Tabular RL (config.py:79-91) ---
    JERK_VALUES: Tuple[float, ...] = _jerk_table(-5, -2.5, 0, 2.5, 5)
    TRAINING_TICK_LENGTH: float = 0.2
    MAX_EPISODE_LENGTH: float = 100.0
    STEP_SIZE: float = 0.01
    GAMMA: float = 1.0
    NUM_TRAINING_EPISODES: int = 150000
    STEP_SIZE_HALF_PER_EPISODES: int = 20000
    EVALUATION_PERIOD: int = 2000
    NUM_EVALUATION_EPISODES: int = 100
    EVALUATION_EPISODE_LENGTH: float = 50.0
    EVALUATION_TICK_LENGTH: float = 0.2
    AVOID_UNVISITED_STATES: bool = True

    # --- S-T solver (config.py:94-110) ---
    DESIRED_SPEED: float = 30.0
    USE_CYTHON: bool = True  # kept for config compat; selects the native path
    USE_FAST_ST_SOLVER: bool = True
    S_DISCRETIZATION: float = 0.05
    T_DISCRETIZATION: float = 0.30
    FUTURE_S: float = 150.0
    FUTURE_T: float = 5.0
    START_UNCERTAINTY: float = 0.0
    UNCERTAINTY_PER_SECOND: float = 0.0
    V_WEIGHT: float = 0.5
    A_WEIGHT: float = 10.0
    J_WEIGHT: float = 10.0
    D_WEIGHT: float = 10.0
    MIN_ALLOWED_DISTANCE: float = 5.0
    CRASH_MIN_S: float = 12.0

    # --- DQN (config.py:113-140) ---
    CUDA: bool = False  # reference DQN device flag; kept for CSV-schema compat
    JERK_VALUES_DQN: Tuple[float, ...] = _jerk_table(-5, -2.5, 0, 2.5, 5)
    ACCELERATION_VALUES_DQN: Tuple[float, ...] = _jerk_table(
        -6.0, -5.5, -5.0, -4.5, -4.0, -3.0, -2.5, -2.0, -1.0, -0.5,
        0.0, 0.5, 1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0, 4.5)
    REPLAY_BUFFER_SIZE: int = 50000
    DISCOUNT_FACTOR: float = 0.999
    BATCH_SIZE: int = 50
    TRAINING_EPISODE_LENGTH: float = 50.0
    TRAINING_STEPS_PER_EPISODE: int = 8
    TARGET_NET_FREEZE_PERIOD: int = 500
    LEARNING_RATE: float = 2e-4
    USE_PRIORITIZED_ER: bool = True
    PER_MAX_PRIORITY: float = 4.0
    PER_ALPHA: float = 0.5
    PER_MIN_PRIORITY: float = 1e-6
    EPS_DECAY_RATE: int = 30000
    EPS_DECAY_COEFFICIENT: float = 0.25
    EPS_START: float = 1.0
    EPS_END: float = 0.1
    USE_DROPOUT: bool = False
    DOUBLE_DQN: bool = True
    CLIP_TARGETS: bool = True
    CLIP_MAX_REWARD: float = 10.0
    CLIP_MIN_REWARD: float = -20.0
    CARS_AHEAD: int = 2
    CARS_BEHIND: int = 2
    USE_SPEED_DIFFERENCE: bool = True
    NORMALIZE_VECTOR_INPUT: bool = True
    INVALID_ACTION_PENALTY: float = 0.0

    # --- Prediction (config.py:143) ---
    MAX_PREDICTED_DECELERATION: float = -4.0

    # --- Combined RL+MPC arbiter (config.py:146-155) ---
    ROLLOUT_LENGTH: int = 5
    ST_TEST_ROLLOUTS: int = 5
    USE_MIN_ALLOWED_DISTANCE_IN_COMBINED_SOLVER: bool = True
    LIMIT_DQN_SPEED: bool = False
    TEST_ST_STRICTLY_BETTER: bool = True
    TEST_ROLLOUT_STATE: bool = True
    CHECK_ROLLOUT_CRASH: bool = True
    COMBINATION_MIN_DISTANCE: float = 5.1
    STOP_X: float = 65.0
    REMEMBER_LAST_CHOICE_FOR_SWITCHING_COMBINED: bool = False

    # ------------------------------------------------------------------
    # Batched-framework-only settings (no reference counterpart).  These
    # control the batched execution: how many scenarios run in lockstep per
    # device and how many padded array slots the vectorized world/planner
    # use.
    # ------------------------------------------------------------------
    BATCH_SCENARIOS: int = 128      # scenarios per device in lockstep
    MAX_CARS: int = 48              # padded slots for live traffic cars
    MAX_SENSED_CARS: int = 32       # padded slots for sensed cars in a state
    QP_ITERATIONS: int = 300        # fixed ADMM iterations for the smoother
    SOLVER_DTYPE: str = "float32"   # DP accumulation dtype on device
    # sim-semantics diagnostics (A/B attribution of the sparse-traffic ST
    # jerk gap, VERDICT r3 item 6; "default" / False = production
    # behavior).  DIAG_YIELD_MODE: "always" makes highway cars always
    # splice the merged ego as leader, "never" makes them assert priority
    # unconditionally.  DIAG_NO_PASS_CLAMP_OFF removes the
    # follower-never-passes-leader position clamp.
    DIAG_YIELD_MODE: str = "default"
    DIAG_NO_PASS_CLAMP_OFF: bool = False

    # --- derived static grid shapes -----------------------------------
    @property
    def num_t(self) -> int:
        """Number of planner time samples; mirrors np.arange(0, FUTURE_T +
        T_DISCRETIZATION, T_DISCRETIZATION).size (reference st.py:32)."""
        import numpy as np
        return int(np.arange(0.0, self.FUTURE_T + self.T_DISCRETIZATION,
                             self.T_DISCRETIZATION).size)

    @property
    def num_s(self) -> int:
        """Number of planner s samples; mirrors np.arange(s0, s0 + FUTURE_S +
        S_DISCRETIZATION, S_DISCRETIZATION).size (reference st.py:31)."""
        import numpy as np
        return int(np.arange(0.0, self.FUTURE_S + self.S_DISCRETIZATION,
                             self.S_DISCRETIZATION).size)

    @property
    def ticks_per_plan_step(self) -> int:
        return int(round(self.T_DISCRETIZATION / self.TICK_LENGTH))

    @property
    def fine_horizon(self) -> int:
        """Fine-grid length of the QP smoother; mirrors the sub_length
        computation in reference st.py:590-594."""
        import numpy as np
        t_last = (self.num_t - 1) * self.T_DISCRETIZATION
        sub = int(np.round(t_last / self.TICK_LENGTH + 1))
        if (sub - 1) * self.TICK_LENGTH > t_last:
            sub -= 1
        return sub

    @property
    def obs_dim(self) -> int:
        per_car = 4 if self.USE_ACCELERATION_OF_OTHER_CARS else 3
        return per_car * (self.CARS_AHEAD + self.CARS_BEHIND) + 4

    # ------------------------------------------------------------------
    def replace(self, **kw: Any) -> "Settings":
        return dataclasses.replace(self, **kw)

    def export_settings(self) -> dict:
        """Flat dict of every setting (reference config.py:157-159)."""
        return dataclasses.asdict(self)

    @classmethod
    def load_from_file(cls, filename: str) -> "Settings":
        """Load a reference-format JSON config (reference config.py:161-170).

        Int-keyed dicts (the jerk/acceleration action tables) are coerced to
        dense tuples ordered by key, mirroring config.py:168-169.
        """
        with open(filename, "rb") as fh:
            contents = json.load(fh)
        return cls.from_dict(contents)

    @classmethod
    def from_dict(cls, contents: dict) -> "Settings":
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {}
        unknown = {}
        for item, value in contents.items():
            if isinstance(value, dict):
                keyed = {int(k): v for k, v in value.items()}
                value = tuple(float(keyed[k]) for k in sorted(keyed))
            if item in fields:
                kw[item] = value
            else:
                unknown[item] = value
        if unknown:
            logging.getLogger(__name__).warning(
                "Ignoring unknown settings keys: %s", sorted(unknown))
        return cls(**kw)


def default_settings() -> Settings:
    return Settings()


def load_settings(filename: str | None) -> Settings:
    if filename is None:
        return Settings()
    return Settings.load_from_file(filename)
