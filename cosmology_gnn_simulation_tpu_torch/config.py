"""Training CLI configuration (counterpart of ``config.py``): the JAX
package's flags and defaults, plus ``--device``.

* ``--device`` (default ``cuda``) picks where the port trains; without a
  CUDA device ``cuda`` raises, nothing falls back to the CPU;
* ``--num_workers`` is accepted for CLI compatibility but unused (graphs
  are built on the device inside the step);
* flags whose paths the port does not have yet (``--aggregation
  cellblock``, ``--cellblock_variable``, ``--carry_dtype bfloat16``,
  ``--data_parallel``, ``--spatial_shards`` > 1, ``--distributed``,
  ``--native_loader``) raise ``NotImplementedError`` naming the ROADMAP
  item that ports them (``check_ported``).
"""

from __future__ import annotations

import argparse
import json
import os


def build_train_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Cosmology GNN Simulation (PyTorch + CUDA)")

    parser.add_argument("--train_dir", type=str, required=True,
                        help="Directory containing training HDF5 files")
    parser.add_argument("--val_dir", type=str, required=True,
                        help="Directory containing validation HDF5 files")
    parser.add_argument("--metadata_path", type=str, required=True,
                        help="Path to metadata file")
    parser.add_argument("--output_dir", type=str, default="model_output",
                        help="Path to output directory")

    parser.add_argument("--num_neighbors", type=int, default=16,
                        help="Number of nearest neighbors (incl. self)")
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--window_size", type=int, default=5)
    parser.add_argument("--latent_size", type=int, default=128)
    parser.add_argument("--mlp_hidden_size", type=int, default=128)
    parser.add_argument("--mlp_num_hidden_layers", type=int, default=2)
    parser.add_argument("--num_message_passing_steps", type=int, default=10)
    parser.add_argument("--output_size", type=int, default=3)
    parser.add_argument("--noise_std", type=float, default=0.0)
    parser.add_argument("--num_epochs", type=int, default=10)
    parser.add_argument("--learning_rate", type=float, default=1e-4)
    parser.add_argument("--final_learning_rate", type=float, default=1e-4)
    parser.add_argument("--weight_decay", type=float, default=0.0)
    parser.add_argument("--num_workers", type=int, default=0,
                        help="Accepted for reference-CLI compatibility; unused")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--save_every", type=int, default=10)
    parser.add_argument("--augment_prob", type=float, default=1.0)
    parser.add_argument("--temp_rate_loss_weight", type=float, default=1.0)
    parser.add_argument("--acc_loss_weight", type=float, default=1.0)
    parser.add_argument("--momentum_loss_weight", type=float, default=0.0)
    parser.add_argument("--plots_dir", type=str, default="plots")
    parser.add_argument("--pretrained_model", type=str, default=None)
    parser.add_argument("--test_data_path", type=str, default=None)

    parser.add_argument("--device", type=str, default="cuda",
                        help="Device to train on: 'cuda' (default; raises "
                             "without one) or 'cpu' (the kernels' plain versions)")
    parser.add_argument("--compute_dtype", type=str, default=None,
                        choices=[None, "bfloat16", "float32"],
                        help="Matmul operand dtype (accumulation stays fp32)")
    parser.add_argument("--aggregate", type=str, default="sender_latents",
                        choices=["sender_latents", "edge_messages"])
    parser.add_argument("--distributed", action="store_true",
                        help="Multi-process training (not ported)")
    parser.add_argument("--data_parallel", action="store_true",
                        help="Shard the batch across all visible devices (not ported)")
    parser.add_argument("--spatial_shards", type=int, default=0,
                        help="Decompose the box into this many x-slabs with "
                             "halo exchange; 0/1 = off (more is not ported)")
    parser.add_argument("--neighbor_method", type=str, default="auto",
                        choices=["auto", "bruteforce", "celllist", "pallas"],
                        help="Periodic k-NN backend")
    parser.add_argument("--aggregation", type=str, default="auto",
                        choices=["auto", "gather", "cellblock",
                                 "cellblock_hybrid"],
                        help="Message-passing aggregation backend: 'gather' "
                             "(gather + sum, sorted-edge backward), "
                             "'cellblock_hybrid' (the window matmul K4 over the "
                             "cell-block plan, particle-space carry) or "
                             "'cellblock' (slot-space carry; not ported); "
                             "'auto' is 'gather'")
    parser.add_argument("--cellblock_variable", action="store_true",
                        help="Variable per-column slot capacities for the "
                             "cellblock layouts (not ported)")
    parser.add_argument("--carry_dtype", type=str, default=None,
                        choices=[None, "bfloat16", "float32"],
                        help="Residual-stream carry dtype (default float32; "
                             "bfloat16 is not ported)")
    parser.add_argument("--remat", action="store_true",
                        help="Recompute each message-passing step in the "
                             "backward pass instead of keeping its "
                             "activations (torch.utils.checkpoint)")
    parser.add_argument("--remat_chunk", type=int, default=None,
                        help="Hierarchical two-level remat: scan the "
                             "processor as M/chunk checkpointed chunks of "
                             "chunk checkpointed steps (must divide "
                             "num_message_passing_steps); the backward "
                             "holds M/c + c carries instead of M")
    parser.add_argument("--fused_tail", dest="fused_tail",
                        action="store_const", const=True, default=None,
                        help="Force the fused step tail (K5 forward, K6 "
                             "backward) ON in the train step (default: auto "
                             "— on for the pruned bf16 default-width model "
                             "on CUDA)")
    parser.add_argument("--no_fused_tail", dest="fused_tail",
                        action="store_const", const=False,
                        help="Force the fused step-tail kernel OFF")
    parser.add_argument("--no_strict_neighbors", action="store_true",
                        help="Downgrade a failed kNN exactness certificate "
                             "from an error to a warning")
    parser.add_argument("--native_loader", action="store_true",
                        help="Use the C++ mmap/prefetch batch loader (not ported)")
    parser.add_argument("--resume", type=str, default=None,
                        help="Checkpoint dir for FULL resume (params + "
                             "optimizer + epoch + RNG), unlike "
                             "--pretrained_model which loads weights only")
    return parser


def check_ported(args) -> None:
    """Raise ``NotImplementedError`` for a flag whose path the port does not
    have yet, naming the ROADMAP queue 1 item that ports it. A flag the
    parser lacks (the eval CLIs have fewer) counts as not given."""
    def flag(name, default=None):
        return getattr(args, name, default)

    unported = [
        (flag("aggregation") == "cellblock", "--aggregation cellblock (the slot-space carry)", 4),
        (flag("cellblock_variable"), "--cellblock_variable", 4),
        (flag("carry_dtype") == "bfloat16", "--carry_dtype bfloat16", 4),
        (flag("data_parallel"), "--data_parallel", 5),
        ((flag("spatial_shards") or 0) > 1, "--spatial_shards > 1", 5),
        (flag("distributed"), "--distributed", 5),
        (flag("native_loader"), "--native_loader", 6),
    ]
    for given, name, item in unported:
        if given:
            raise NotImplementedError(f"{name} is not ported yet (ROADMAP queue 1 item {item})")


def get_config(argv=None):
    args = build_train_parser().parse_args(argv)
    check_ported(args)
    os.makedirs(args.output_dir, exist_ok=True)
    with open(args.metadata_path, "r") as f:
        args.metadata = json.load(f)
    return args
