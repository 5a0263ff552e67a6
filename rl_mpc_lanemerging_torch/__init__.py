"""rl_mpc_lanemerging_torch — the PyTorch/CUDA port of the RL+MPC
lane-merging framework.

A second package beside ``rl_mpc_lanemerging_tpu`` (the JAX reference).  It
keeps that package's module names and layout; inside, every function works
on tensors with an explicit leading scenario axis, ``lax.scan`` and
``while_loop`` become Python loops, and the one TPU kernel on the main path
(the ST lattice DP) is a CUDA kernel written by hand for Hopper
(``csrc/st_wavefront.cu``).

Entry points run on ``cuda`` unless the caller asks for the CPU; on the CPU
every kernel wrapper takes its plain PyTorch version.
"""

from .config import Settings, default_settings, load_settings

__version__ = "0.1.0"

__all__ = ["Settings", "default_settings", "load_settings", "__version__"]
