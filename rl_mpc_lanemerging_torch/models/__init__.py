"""Networks of the RL agents."""
