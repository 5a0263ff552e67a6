"""The modules a run of the benchmark must not hold: JAX, its libraries
and the JAX package beside the port.  Names are compared by their whole
top-level part (before the first dot): the port's package name begins with
the JAX package's, and is not one of them."""

from __future__ import annotations

import sys
from typing import Iterable, List

__all__ = ["FORBIDDEN", "forbidden_modules"]

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "orbax",
                       "rl_mpc_lanemerging_tpu"})


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The loaded module names (``sys.modules`` by default) whose top-level
    name is forbidden."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)
