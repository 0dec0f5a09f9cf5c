"""``python -m cosmology_gnn_simulation_tpu_torch.cli.render_rollout`` — the
rollout entry point (counterpart of ``cli/render_rollout.py``): the JAX
CLI's flags, messages and artifacts (the two ``.npy`` trajectories,
``rollout_summary.txt``, and ``errors.png`` where matplotlib is installed),
plus ``--device`` (default ``cuda``) and ``--dist_backend``.

``main`` parses, loads the metadata, the checkpoint and the HDF5 ground
truth, and hands the arrays to ``render``, the CLI's body on arrays in
memory. ``--spatial_shards P`` runs the halo rollout on a ``(world // P,
P)`` mesh of torchrun's ranks (``torchrun --nproc_per_node=P``), as
``cli.train`` does; rank 0 alone writes the artifacts.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from cosmology_gnn_simulation_tpu_torch.cli.one_step_test import (
    add_model_flags,
    load_model_from_checkpoint,
)
from cosmology_gnn_simulation_tpu_torch.data.hdf5 import read_simulation
from cosmology_gnn_simulation_tpu_torch.evaluation import (
    calculate_rollout_errors,
    write_rollout_summary,
)
from cosmology_gnn_simulation_tpu_torch.featurize import verify_neighbor_exactness
from cosmology_gnn_simulation_tpu_torch.parallel.halo import choose_halo_config, run_halo_rollout
from cosmology_gnn_simulation_tpu_torch.parallel.mesh import spatial_mesh
from cosmology_gnn_simulation_tpu_torch.rollout import rollout
from cosmology_gnn_simulation_tpu_torch.types import (
    NormalizationStats,
    resolve_device,
    tree_map,
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Perform model rollout")
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--test_data", type=str, required=True)
    parser.add_argument("--metadata_path", type=str, required=True)
    parser.add_argument("--output_dir", type=str, default="rollout_results")
    parser.add_argument("--noise_std", type=float, default=0.0,
                        help="Accepted for reference-CLI parity but IGNORED "
                             "(rollouts always run noise-free)")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--no_strict_neighbors", action="store_true",
                        help="Downgrade a failed kNN exactness certificate "
                             "from an error to a warning")
    parser.add_argument("--exactness_guard", type=str, default="flag",
                        choices=["off", "flag", "fallback"],
                        help="Per-step kNN exactness certificate: "
                             "flag = report failing steps; fallback = rerun "
                             "failing steps with exact brute force")
    parser.add_argument("--num_steps", type=int, default=None,
                        help="Steps to simulate (default: full trajectory)")
    parser.add_argument("--cellblock_variable", action="store_true",
                        help="variable per-column slot capacities for the cellblock "
                             "layouts")
    parser.add_argument("--aggregation", type=str, default="auto",
                        choices=["auto", "gather", "cellblock", "cellblock_hybrid"],
                        help="message-passing aggregation: 'gather' (auto), "
                             "'cellblock_hybrid' (the selection-matrix kernel with the "
                             "particle-space carry) or 'cellblock' (slot-space carry)")
    parser.add_argument("--reneighbor_every", type=int, default=1,
                        help="Rebuild the k-NN graph every R steps (R=1 = "
                             "reference semantics; R>1 trades exactness for speed)")
    parser.add_argument("--sorted_state", type=str, default="auto",
                        choices=("auto", "on", "off"),
                        help="carry the gather rollout's state in cell-sorted "
                             "order (identical numerics on tie-free data); auto = off")
    parser.add_argument("--no_fused_tail", action="store_true",
                        help="Disable the fused step-tail kernel K5 (on by default for "
                             "pruned bf16 rollouts on the card; ops/fused_step.py)")
    parser.add_argument("--spatial_shards", type=int, default=0,
                        help="spatially sharded rollout over this many ranks with "
                             "halo exchange (torchrun --nproc_per_node=P or a "
                             "multiple of it; 0/1 = single device)")
    parser.add_argument("--dist_backend", type=str, default=None, choices=["nccl", "gloo"],
                        help="process-group backend (default: NCCL for cuda, gloo for the "
                             "CPU); gloo with --device cuda:0 runs every rank on one card")
    add_model_flags(parser)
    return parser


def parse_args(argv=None) -> argparse.Namespace:
    """Parse and check the flags: a parser error for the brute-force
    fallback with cell-block aggregation (as the JAX CLI)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.aggregation.startswith("cellblock") and args.exactness_guard == "fallback":
        parser.error(
            "--aggregation cellblock supports --exactness_guard flag/off "
            "only: brute-force fallback neighbors can exceed the one-cell "
            "window the selection matrices cover"
        )
    return args


def render(args, params, model_config, stats, ground_truth):
    """The CLI's body after the HDF5 read: the exactness check of the last
    seed frame, the rollout on ``args.device``, the error metrics and the
    artifacts in ``args.output_dir``. ``ground_truth`` holds
    ``Coordinates [T, N, 3]`` and ``InternalEnergy [T, N, 1]`` arrays.
    With ``--spatial_shards P`` every rank runs the halo rollout (its mesh
    joined here; ``params`` and ``stats`` go to the rank's device) and
    returns the errors, and rank 0 alone writes the artifacts. Returns the
    errors."""
    device = resolve_device(args.device)
    spatial = args.spatial_shards or 0
    mesh = None
    if spatial > 1:
        mesh = spatial_mesh(spatial, device, backend=args.dist_backend)
        device = mesh.device
        params = tree_map(lambda t: t.to(device), params)
        stats = stats.to(device)
    writes = mesh is None or mesh.rank == 0
    if writes:
        os.makedirs(args.output_dir, exist_ok=True)
    total_time = ground_truth["Coordinates"].shape[0]
    num_steps = (
        args.num_steps
        if args.num_steps is not None
        else total_time - args.window_size
    )
    verify_neighbor_exactness(
        torch.as_tensor(ground_truth["Coordinates"][args.window_size - 1], device=device),
        args.num_neighbors,
        stats.box_size,
        method=args.neighbor_method,
        strict=not args.no_strict_neighbors,
    )
    print("Performing rollout")
    if spatial > 1:
        hc = choose_halo_config(ground_truth["Coordinates"].shape[1], args.num_neighbors, spatial)
        rollout_data, diag = run_halo_rollout(
            params, model_config, ground_truth["Coordinates"][: args.window_size],
            ground_truth["InternalEnergy"][: args.window_size], stats, num_steps, mesh, hc,
            num_neighbors=args.num_neighbors)
        if diag["overflow"] or diag["stranded"]:
            print(f"WARNING: halo rollout capacity diagnostics {diag} != 0 "
                  "— results are approximate; raise the halo slacks")
    else:
        rollout_data = rollout(
            params,
            model_config,
            ground_truth["Coordinates"][: args.window_size],
            ground_truth["InternalEnergy"][: args.window_size],
            stats,
            num_steps,
            num_neighbors=args.num_neighbors,
            neighbor_method=args.neighbor_method,
            reneighbor_every=args.reneighbor_every,
            exactness_guard=args.exactness_guard,
            aggregation=args.aggregation,
            cellblock_variable=args.cellblock_variable,
            fused_tail=False if args.no_fused_tail else None,
            sorted_state=args.sorted_state,
            device=device,
        )
        rollout_data = {k: v.cpu().numpy() for k, v in rollout_data.items()}
    exactness = rollout_data.pop("neighbor_exactness", None)
    if exactness is not None:
        inexact = int((~exactness.astype(bool)).sum())
        if inexact:
            if args.exactness_guard == "fallback":
                print(f"NOTE: {inexact}/{len(exactness)} steps failed the "
                      "bucketed-kNN certificate and were rerun with exact "
                      "brute force")
            elif args.aggregation.startswith("cellblock"):
                print(f"WARNING: {inexact}/{len(exactness)} rollout steps "
                      "failed the exactness certificate (kNN overflow/"
                      "cell-edge bound, cell-block slot overflow, or dropped "
                      "edges — clustered distribution?). Results are "
                      "approximate on those steps. Remedies: a larger "
                      "cellblock capacity (CellBlockSpec), --aggregation "
                      "gather, or --neighbor_method bruteforce.")
            else:
                print(f"WARNING: {inexact}/{len(exactness)} rollout steps "
                      "failed the kNN exactness certificate (clustered "
                      "distribution?) — neighbor graphs were approximate on "
                      "those steps. Rerun with --exactness_guard fallback "
                      "or --neighbor_method bruteforce.")
        else:
            certificate = (
                "kNN + cell-block exactness certificates"
                if args.aggregation.startswith("cellblock")
                else "kNN exactness certificate"
            )
            print(f"{certificate} held for every rollout step")

    print("Calculating errors")
    errors = calculate_rollout_errors(rollout_data, ground_truth)
    if not writes:
        return errors

    try:
        from cosmology_gnn_simulation_tpu_torch.training.plots import (
            plot_rollout_errors,
        )

        plot_rollout_errors(
            errors,
            os.path.join(args.output_dir, "errors.png"),
            args.window_size,
            stats.box_size,
        )
    except Exception as exc:
        print(f"plotting skipped: {exc}")

    np.save(
        os.path.join(args.output_dir, "rollout_coordinates.npy"),
        rollout_data["Coordinates"],
    )
    np.save(
        os.path.join(args.output_dir, "rollout_temperatures.npy"),
        rollout_data["InternalEnergy"],
    )
    write_rollout_summary(
        os.path.join(args.output_dir, "rollout_summary.txt"),
        errors,
        model_path=args.model_path,
        test_data=args.test_data,
        num_particles=rollout_data["Coordinates"].shape[1],
        window_size=args.window_size,
        num_steps=num_steps,
        dt=stats.dt,
        box_size=stats.box_size,
    )
    print(f"Evaluation complete. Results saved to {args.output_dir}")
    return errors


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    # A halo run's ranks take their card in render: the statistics and the
    # weights wait on the host until then.
    host = "cpu" if (args.spatial_shards or 0) > 1 else device
    with open(args.metadata_path) as f:
        metadata = json.load(f)
    stats = NormalizationStats.from_metadata(metadata, device=host)
    print(f"Using time step (dt): {stats.dt}")
    print(f"Using box size: {stats.box_size}")

    if args.noise_std:
        print("WARNING: --noise_std is ignored by rollout (kept for "
              "reference-CLI parity; rollouts are always noise-free)")
    params, model_config = load_model_from_checkpoint(args.model_path, args, host)
    ground_truth = read_simulation(
        args.test_data, fields=["Coordinates", "InternalEnergy"]
    )
    return render(args, params, model_config, stats, ground_truth)


if __name__ == "__main__":
    main()
