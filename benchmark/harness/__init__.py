"""The benchmark's harness: finds a cell's files by name, drives the
program's evaluation entry through a measured window, reads the metrics
and decides ``correct``.  It measures ``rl_mpc_lanemerging_torch`` alone."""
