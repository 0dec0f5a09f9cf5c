"""The benchmark of the PyTorch and CUDA port on one NVIDIA H100."""
