"""Command-line entry points (``python -m cosmology_gnn_simulation_tpu_torch.cli.<name>``)."""
