"""``python -m cosmology_gnn_simulation_tpu_torch.cli.train`` — the training
entry point (counterpart of ``cli/train.py``): single device, data-parallel
over the ranks of a process group (``--data_parallel``, launched by
``torchrun --nproc_per_node=G ... --distributed``), or halo-sharded over
them (``torchrun --nproc_per_node=P ... --spatial_shards P``).

``main`` parses, and opens the training and validation data (the HDF5
files, or their ``.cgnn`` caches through the native loader with
``--native_loader``); ``train`` is the CLI's body on those datasets."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from cosmology_gnn_simulation_tpu_torch.config import get_config
from cosmology_gnn_simulation_tpu_torch.data.dataset import SequenceDataset
from cosmology_gnn_simulation_tpu_torch.parallel.mesh import (
    initialize_distributed,
    local_rank,
    make_mesh,
    spatial_mesh,
)
from cosmology_gnn_simulation_tpu_torch.training.trainer import (
    TrainConfig,
    Trainer,
    default_model_config,
)
from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats, resolve_device
from cosmology_gnn_simulation_tpu_torch.utils import checkpoint as ckpt_lib


def main(argv=None):
    args = get_config(argv)
    device = resolve_device(args.device)
    # On the CPU until the body knows this rank's device.
    stats = NormalizationStats.from_metadata(args.metadata, device="cpu")
    print(f"Using time step (dt): {stats.dt}")
    print(f"Using box size: {stats.box_size}")

    if args.native_loader:
        from cosmology_gnn_simulation_tpu_torch.data import native_loader

        pinned = device.type == "cuda"
        train_dataset = native_loader.open_directory(args.train_dir, args.window_size,
                                                     pin_memory=pinned)
        val_dataset = native_loader.open_directory(args.val_dir, args.window_size,
                                                   pin_memory=pinned)
        print("Using native C++ batch loader" + (" (pinned host buffers)" if pinned else ""))
    else:
        # Only the two fields the model reads: loading Velocities and
        # HydroAcceleration per cached file would triple the IO for nothing.
        model_fields = ("Coordinates", "InternalEnergy")
        train_dataset = SequenceDataset(args.train_dir, args.window_size, args.metadata,
                                        fields=model_fields)
        val_dataset = SequenceDataset(args.val_dir, args.window_size, args.metadata,
                                      fields=model_fields)
    return train(args, stats, train_dataset, val_dataset)


def train(args, stats, train_dataset, val_dataset):
    """The CLI's body: the process group and mesh the flags ask for, the
    Trainer (from ``--pretrained_model``'s weights or ``--resume``'s state)
    and its fit on the datasets (``SequenceDataset.batches``' contract, and
    ``num_particles``). Returns the Trainer."""
    device = resolve_device(args.device)
    spatial = args.spatial_shards or 0
    model_config = default_model_config(
        window_size=args.window_size,
        latent_size=args.latent_size,
        mlp_hidden_size=args.mlp_hidden_size,
        mlp_num_hidden_layers=args.mlp_num_hidden_layers,
        num_message_passing_steps=args.num_message_passing_steps,
        output_size=args.output_size,
        aggregate=args.aggregate,
        remat=args.remat,
        remat_chunk=args.remat_chunk,
        carry_dtype=args.carry_dtype,
    )
    train_config = TrainConfig(
        num_neighbors=args.num_neighbors,
        batch_size=args.batch_size,
        window_size=args.window_size,
        noise_std=args.noise_std,
        num_epochs=args.num_epochs,
        learning_rate=args.learning_rate,
        final_learning_rate=args.final_learning_rate,
        weight_decay=args.weight_decay,
        seed=args.seed,
        save_every=args.save_every,
        augment_prob=args.augment_prob,
        acc_loss_weight=args.acc_loss_weight,
        temp_rate_loss_weight=args.temp_rate_loss_weight,
        momentum_loss_weight=args.momentum_loss_weight,
        output_dir=args.output_dir,
        compute_dtype=args.compute_dtype,
        neighbor_method=args.neighbor_method,
        strict_neighbor_check=not args.no_strict_neighbors,
        aggregation=args.aggregation,
        cellblock_variable=args.cellblock_variable,
        fused_tail=args.fused_tail,
    )
    if train_config.aggregation.startswith("cellblock") and (
            spatial > 1 or args.data_parallel or args.distributed):
        raise SystemExit("--aggregation cellblock is single-device only (the cell block does "
                         "not compose with data or particle sharding); drop the "
                         "--spatial_shards/--data_parallel/--distributed flags")

    if args.distributed:
        if initialize_distributed(device=device, backend=args.dist_backend):
            print(f"Multi-process runtime: rank {dist.get_rank()} of {dist.get_world_size()} "
                  f"({dist.get_backend()})")
        else:
            print("--distributed: no torchrun environment (MASTER_ADDR, RANK, WORLD_SIZE); "
                  "running single-process")
    mesh = halo = None
    if spatial > 1:
        from cosmology_gnn_simulation_tpu_torch.parallel.halo import choose_halo_config

        mesh = spatial_mesh(spatial, device, backend=args.dist_backend)
        # Capacities from the measured occupancies of a real frame
        # (clustered data overflows the uniform plan at partition time).
        first = next(iter(train_dataset.batches(1, shuffle=False)), None)
        positions = None if first is None else np.asarray(first["positions"][0, -1])
        halo = choose_halo_config(train_dataset.num_particles, args.num_neighbors, spatial,
                                  noise=args.noise_std > 0, positions=positions,
                                  box=float(stats.box_size))
        print(f"Halo-sharded training: {spatial} spatial shards x {mesh.shape['data']} data "
              f"shards; grid {halo.grid_size}, halo {halo.halo_layers} layer(s) "
              f"({dist.get_backend()}, rank {mesh.rank} on {mesh.device})")
    elif args.data_parallel:
        world = dist.get_world_size() if dist.is_initialized() else 1
        mesh = make_mesh((world, 1), device=device)
        print(f"Data-parallel training over {world} rank(s) ({mesh.device} here)")
    if mesh is not None:
        device = mesh.device
    elif dist.is_initialized() and device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank())  # each rank its own card
    print(f"Using device: {device}")

    steps_per_epoch = max(len(train_dataset) // args.batch_size, 1)
    init_params = None
    if args.pretrained_model:
        try:
            init_params = ckpt_lib.load_checkpoint(args.pretrained_model, device)["params"]
            print(f"Starting from pretrained model: {args.pretrained_model}")
        except Exception as exc:
            # The reference continues with random weights when the load
            # fails; so does this, loudly.
            print(f"Error loading pretrained model ({exc}); continuing with random init")

    trainer = Trainer(model_config, stats, train_config, steps_per_epoch, init_params,
                      mesh=mesh, halo=halo, device=device)
    start_epoch = 0
    if args.resume:
        start_epoch = trainer.restore(args.resume)
        print(f"Resumed from {args.resume}; continuing at epoch {start_epoch}")
    trainer.fit(train_dataset, val_dataset, start_epoch=start_epoch)
    return trainer


if __name__ == "__main__":
    main()
