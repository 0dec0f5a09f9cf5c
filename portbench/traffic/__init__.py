"""Traffic generators, read by parameters from ``portbench/workloads/``."""
