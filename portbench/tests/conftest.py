"""Tiny versions of the benchmark's cells for the CPU: each cell's own
traffic mix and limits, its configuration at 2,048 particles, k = 8, width
32 and 5 message-passing steps (config 4's recomputation runs in chunks of
5). The kernels run as the port's plain versions there. ``f32`` computes
in float32 throughout (no bf16 operands or carry)."""

import json
import time
from pathlib import Path

import pytest
import torch

from cosmology_gnn_simulation_tpu_torch.ops.cellblock import choose_cellblock_spec
from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
TINY = {"num_particles": 2048, "num_neighbors": 8, "latent_size": 32, "mlp_hidden_size": 32,
        "num_message_passing_steps": 5}


def tiny_cell(name: str, f32: bool = False):
    bench, cell, cfg, mix, limits = harness.load_cell(ROOT, name)
    cfg = dict(cfg, **TINY)
    mix = dict(mix)
    if f32:
        cfg["compute_dtype"] = "float32"
        mix["model_options"] = {k: v for k, v in mix.get("model_options", {}).items()
                                if k != "carry_dtype"}
    if mix["entry"] == "rollout":
        mix["steps_per_request"] = 2
    # The cell's plan frozen at the tiny size, as the chooser gives it there.
    spec = choose_cellblock_spec(cfg["num_particles"], cfg["num_neighbors"],
                                 variable=mix["route"].get("cellblock_variable", False))
    mix["plan"] = {key: getattr(spec, key) for key in mix["plan"]}
    return bench, cell, cfg, mix, limits


def run_tiny(name: str, seed: int = 2**31 + 5, control=None) -> dict:
    bench, cell, cfg, mix, limits = tiny_cell(name)
    return harness.run_cell(bench, cell, cfg, mix, limits, seed, 0.3, 0, torch.device("cpu"),
                            time.perf_counter(), control=control)


@pytest.fixture
def cells():
    return [c["name"] for c in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
