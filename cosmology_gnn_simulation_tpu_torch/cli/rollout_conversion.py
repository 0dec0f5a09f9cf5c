"""``python -m cosmology_gnn_simulation_tpu_torch.cli.rollout_conversion`` —
convert a rollout directory's ``.npy`` trajectories into a valid 6-field
HDF5 dataset (counterpart of ``cli/rollout_conversion.py``; runs on the
CPU)."""

from __future__ import annotations

import argparse
import json
import os

from cosmology_gnn_simulation_tpu_torch.data.hdf5 import read_simulation
from cosmology_gnn_simulation_tpu_torch.evaluation import convert_rollout_to_hdf5


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Convert rollout results to HDF5 format"
    )
    parser.add_argument("--rollout_dir", type=str, required=True)
    parser.add_argument("--original_data", type=str, required=True)
    parser.add_argument("--metadata_path", type=str, required=True)
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--window_size", type=int, default=5)
    args = parser.parse_args(argv)

    for path, label in [
        (args.rollout_dir, "Rollout directory"),
        (args.original_data, "Original data file"),
        (args.metadata_path, "Metadata file"),
    ]:
        if not os.path.exists(path):
            raise FileNotFoundError(f"{label} not found: {path}")

    with open(args.metadata_path) as f:
        metadata = json.load(f)
    original = read_simulation(args.original_data)
    box_size = metadata["box_size"]
    if isinstance(box_size, (list, tuple)):  # one-element-list metadata files
        box_size = box_size[0]
    convert_rollout_to_hdf5(
        args.rollout_dir,
        original,
        float(box_size),
        float(metadata["dt"]),
        args.output,
        window_size=args.window_size,
    )
    print(f"Conversion complete! HDF5 file saved as: {args.output}")


if __name__ == "__main__":
    main()
