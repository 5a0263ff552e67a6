"""MPC planner: obstacle grid, solver dispatch, QP refine, control."""
