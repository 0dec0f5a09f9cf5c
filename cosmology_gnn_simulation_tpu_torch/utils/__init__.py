"""Utilities (counterpart of ``utils/``): checkpoints and profiling."""
