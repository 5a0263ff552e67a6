"""The configuration numbers the reference reads.

``DEFAULTS`` is a frozen copy of the paper's defaults (reference config.py)
for every key the reference uses; a configuration file's ``settings``
override them.  :func:`params` returns a plain namespace of the result with
the derived grid sizes.
"""

from __future__ import annotations

import types

import numpy as np

__all__ = ["DEFAULTS", "params"]

DEFAULTS = {
    "TICK_LENGTH": 0.2,
    "MAX_POSITIVE_ACCELERATION": 4.5,
    "MAX_NEGATIVE_ACCELERATION": -6.0,
    "MINIMUM_NEGATIVE_JERK": -5.0,
    "MAXIMUM_POSITIVE_JERK": 5.0,
    "MAX_SPEED": 30.0,
    "CAR_LENGTH": 5.0,
    "SENSOR_RADIUS": 125.0,
    "USE_ACCELERATION_OF_OTHER_CARS": True,
    "START_SPEED": 15.0,
    "RANDOMIZE_START_SPEED": True,
    "START_SPEED_VARIANCE": 5.0,
    "MIN_START_SPEED": 5.0,
    "MAX_START_SPEED": 25.0,
    "DESIRED_SPEED": 30.0,
    "USE_FAST_ST_SOLVER": True,
    "S_DISCRETIZATION": 0.05,
    "T_DISCRETIZATION": 0.30,
    "FUTURE_S": 150.0,
    "FUTURE_T": 5.0,
    "START_UNCERTAINTY": 0.0,
    "UNCERTAINTY_PER_SECOND": 0.0,
    "V_WEIGHT": 0.5,
    "A_WEIGHT": 10.0,
    "J_WEIGHT": 10.0,
    "D_WEIGHT": 10.0,
    "MIN_ALLOWED_DISTANCE": 5.0,
    "CRASH_MIN_S": 12.0,
    "CARS_AHEAD": 2,
    "CARS_BEHIND": 2,
    "USE_SPEED_DIFFERENCE": True,
    "NORMALIZE_VECTOR_INPUT": True,
    "MAX_PREDICTED_DECELERATION": -4.0,
    "ROLLOUT_LENGTH": 5,
    "ST_TEST_ROLLOUTS": 5,
    "LIMIT_DQN_SPEED": False,
    "TEST_ST_STRICTLY_BETTER": True,
    "TEST_ROLLOUT_STATE": True,
    "CHECK_ROLLOUT_CRASH": True,
    "COMBINATION_MIN_DISTANCE": 5.1,
    "STOP_X": 65.0,
    "REMEMBER_LAST_CHOICE_FOR_SWITCHING_COMBINED": False,
    "QP_ITERATIONS": 300,
    "MODEL_NAME": "",
}


def params(settings: dict) -> types.SimpleNamespace:
    """DEFAULTS overridden by ``settings`` (keys the reference does not read
    are ignored), with num_t, num_s and fine_horizon as the paper derives
    them (st.py:31-32, st.py:590-594)."""
    p = dict(DEFAULTS)
    p.update({k: v for k, v in settings.items() if k in DEFAULTS})
    ns = types.SimpleNamespace(**p)
    ns.num_t = int(np.arange(0.0, ns.FUTURE_T + ns.T_DISCRETIZATION,
                             ns.T_DISCRETIZATION).size)
    ns.num_s = int(np.arange(0.0, ns.FUTURE_S + ns.S_DISCRETIZATION,
                             ns.S_DISCRETIZATION).size)
    t_last = (ns.num_t - 1) * ns.T_DISCRETIZATION
    sub = int(np.round(t_last / ns.TICK_LENGTH + 1))
    if (sub - 1) * ns.TICK_LENGTH > t_last:
        sub -= 1
    ns.fine_horizon = sub
    ns.obs_dim = (4 if ns.USE_ACCELERATION_OF_OTHER_CARS else 3) \
        * (ns.CARS_AHEAD + ns.CARS_BEHIND) + 4
    return ns
