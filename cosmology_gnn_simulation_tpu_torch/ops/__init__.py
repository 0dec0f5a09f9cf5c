"""Geometry, neighbor search and the hand-written CUDA kernels' wrappers."""
