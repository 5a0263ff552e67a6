"""Solvers: the ST lattice DP (dense twin and CUDA kernel) and the QP."""
