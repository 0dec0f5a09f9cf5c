"""Import a JAX package checkpoint (Orbax) into the PyTorch port's format.

    python import_jax_checkpoint.py JAX_CHECKPOINT OUTPUT

Run from the repository root on a host that has JAX and Orbax. It reads
JAX_CHECKPOINT with the JAX package's ``utils.checkpoint.load_checkpoint``,
converts its params with the port's ``convert.params_from_jax`` (float32
tensors on the CPU, the same tree) and writes them with the port's
``utils.checkpoint.save_checkpoint`` as the checkpoint directory OUTPUT,
with the epoch and the ``config.json`` (``{"model": ..., "train": ...}``:
the two packages' configurations have the same field names, so it carries
over as it is) where the JAX checkpoint has them.

Not carried: the Adam moments and the threefry PRNG key, which have no
counterpart in the port's optimizer and generator. A JAX run therefore
continues in the port as a fine-tune, ``cli.train --pretrained_model
OUTPUT``; ``cli.one_step_test`` and ``cli.render_rollout`` read OUTPUT as
any checkpoint of the port. This script is the one place that imports both
packages; the port itself never imports JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def import_checkpoint(jax_checkpoint: str, output: str) -> str:
    """Convert the checkpoint at ``jax_checkpoint`` into the port's
    checkpoint directory ``output``; returns its path."""
    from cosmology_gnn_simulation_tpu.utils.checkpoint import load_checkpoint
    from cosmology_gnn_simulation_tpu_torch.convert import params_from_jax
    from cosmology_gnn_simulation_tpu_torch.utils.checkpoint import save_checkpoint

    restored = load_checkpoint(jax_checkpoint)
    epoch = restored.get("epoch")
    output = os.path.abspath(output)
    return save_checkpoint(
        os.path.dirname(output), os.path.basename(output),
        params_from_jax(restored["params"], device="cpu"),
        epoch=None if epoch is None else int(epoch),
        config=restored.get("config"),
    )


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("jax_checkpoint", help="a checkpoint directory of the JAX package")
    parser.add_argument("output", help="the port's checkpoint directory to write")
    args = parser.parse_args(argv)
    path = import_checkpoint(args.jax_checkpoint, args.output)
    print(f"Imported {args.jax_checkpoint} -> {path} (params, epoch and config; Adam state "
          "and PRNG key not carried: continue with cli.train --pretrained_model)")
    return path


if __name__ == "__main__":
    main()
