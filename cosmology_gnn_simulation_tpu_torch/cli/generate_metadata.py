"""``python -m cosmology_gnn_simulation_tpu_torch.cli.generate_metadata`` —
write ``metadata.json`` for one HDF5 simulation (counterpart of
``cli/generate_metadata.py``)."""

from __future__ import annotations

import argparse

from cosmology_gnn_simulation_tpu_torch.metadata import generate_metadata


def main(argv=None):
    parser = argparse.ArgumentParser(description="Generate metadata for dataset")
    parser.add_argument("--dataset", type=str, required=True,
                        help="Path to HDF5 dataset")
    parser.add_argument("--output", type=str, default="metadata.json",
                        help="Output path for metadata.json")
    args = parser.parse_args(argv)
    generate_metadata(args.dataset, args.output)


if __name__ == "__main__":
    main()
