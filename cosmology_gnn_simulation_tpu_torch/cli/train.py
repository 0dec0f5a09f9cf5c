"""``python -m cosmology_gnn_simulation_tpu_torch.cli.train`` — the training
entry point (counterpart of ``cli/train.py``): single device, or
data-parallel over the ranks of a process group (``--data_parallel``,
launched by ``torchrun --nproc_per_node=G ... --distributed``); the halo
branch (``--spatial_shards`` > 1) raises in ``config.check_ported``."""

from __future__ import annotations

import torch
import torch.distributed as dist

from cosmology_gnn_simulation_tpu_torch.config import get_config
from cosmology_gnn_simulation_tpu_torch.data.dataset import SequenceDataset
from cosmology_gnn_simulation_tpu_torch.parallel.mesh import (
    initialize_distributed,
    local_rank,
    make_mesh,
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
    if args.distributed:
        # First, so each rank's tensors go to its own card.
        if initialize_distributed(device=device):
            print(f"Multi-process runtime: rank {dist.get_rank()} of {dist.get_world_size()} "
                  f"({dist.get_backend()})")
        else:
            print("--distributed: no torchrun environment (MASTER_ADDR, RANK, WORLD_SIZE); "
                  "running single-process")
        if device.type == "cuda":
            device = torch.device("cuda", local_rank())
    stats = NormalizationStats.from_metadata(args.metadata, device=device)
    print(f"Using time step (dt): {stats.dt}")
    print(f"Using box size: {stats.box_size}")
    print(f"Using device: {device}")

    # Only the two fields the model reads: loading Velocities and
    # HydroAcceleration per cached file would triple the IO for nothing.
    model_fields = ("Coordinates", "InternalEnergy")
    train_dataset = SequenceDataset(args.train_dir, args.window_size, args.metadata,
                                    fields=model_fields)
    val_dataset = SequenceDataset(args.val_dir, args.window_size, args.metadata,
                                  fields=model_fields)

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
    if train_config.aggregation.startswith("cellblock") and (args.data_parallel
                                                             or args.distributed):
        raise SystemExit("--aggregation cellblock is single-device only (the cell block does "
                         "not compose with data or particle sharding); drop the "
                         "--data_parallel/--distributed flags")
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

    mesh = None
    if args.data_parallel:
        world = dist.get_world_size() if dist.is_initialized() else 1
        mesh = make_mesh((world, 1), device=device)
        print(f"Data-parallel training over {world} rank(s) ({mesh.device} here)")

    trainer = Trainer(model_config, stats, train_config, steps_per_epoch, init_params,
                      mesh=mesh, device=device)
    start_epoch = 0
    if args.resume:
        start_epoch = trainer.restore(args.resume)
        print(f"Resumed from {args.resume}; continuing at epoch {start_epoch}")
    trainer.fit(train_dataset, val_dataset, start_epoch=start_epoch)
    return trainer


if __name__ == "__main__":
    main()
