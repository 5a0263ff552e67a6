"""RL agents and the combined RL+MPC arbiter."""
