"""Observations of the RL agents."""
