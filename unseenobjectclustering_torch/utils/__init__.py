"""Utilities: metrics, masks and result grids, checkpoints and the weight
carry from flax variables."""
