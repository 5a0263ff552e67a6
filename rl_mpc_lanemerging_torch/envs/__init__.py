"""Batched RL environments over the merge world."""
