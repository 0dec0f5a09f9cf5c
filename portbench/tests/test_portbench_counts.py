"""The yardstick's counts against numbers worked by hand at small shapes."""

import pytest

from portbench.counts import fused_tail, model_flops, peaks, plan, window_matmul

PLAN = {"num_tiles": 2, "query_block": 32, "window": 16, "latent": 64, "num_padded": 100,
        "rev_lanes": 128, "num_particles": 50, "num_neighbors": 4, "num_slots": 64,
        "carry_bytes": 4, "agg_bytes": 4}


def test_window_matmul():
    # S 2 x 9 x 16 x 32 = 9,216; candidates 100 x 64 x 2 = 12,800; starts
    # 2 x 9 x 4 = 72; out 2 x 32 x 64 x 4 = 16,384.
    assert window_matmul.count(PLAN) == {"bytes": 38472, "ops": 25600,
                                         "op_rate": "bf16_tensor"}
    # S_rev 2 x 9 x 16 x 128 = 36,864 in place of S.
    assert window_matmul.count(PLAN, transpose=True)["bytes"] == 66120


def test_fused_tail():
    # The N = 10 particles' rows, never the plan's 64 slots.
    p = dict(PLAN, latent=4, num_particles=10)
    # Weights (3 x 16 + 5 x 4) x 4 = 272 bytes; rows 10 x 4 wide.
    assert fused_tail.count(p) == {"bytes": 10 * 4 * 12 + 272, "ops": 960,
                                   "op_rate": "bf16_tensor"}
    assert fused_tail.count(p, backward=True) == {"bytes": 10 * 4 * 20 + 544, "ops": 2880,
                                                  "op_rate": "bf16_tensor"}
    # A bf16 carry: x, dx and the carry's gradient at 2 bytes.
    assert fused_tail.count(dict(p, carry_bytes=2))["bytes"] == 10 * 4 * 8 + 272


def test_plan_kernels():
    p = dict(PLAN, num_slots=10, num_neighbors=2, window=4, num_particles=5)
    assert plan.count(p, "s_onehot")["bytes"] == 10 * 2 * 2 + 10 * 36 + 4
    assert plan.count(p, "s_decode") == {"bytes": 5 * 2 * 4 + 10 * 2 * 2 + 4, "ops": 600,
                                         "op_rate": "f32"}
    assert plan.count(p, "reverse_table")["bytes"] == 100 * 3 * 4 + 800 + 2 * 36 * 128 + 4


def test_model_flops():
    cfg = {"num_particles": 2, "num_neighbors": 3, "latent_size": 2, "mlp_hidden_size": 2,
           "mlp_num_hidden_layers": 1, "node_input_size": 1, "num_message_passing_steps": 1,
           "output_size": 1}
    # Encoder [1, 2, 2]: 6 MACs; the step's node MLP [4, 2, 2]: 12; two
    # decoders [2, 2, 1]: 6 each; 2 x 30 = 60 a row, plus the aggregation's
    # (3 - 1) x 2 adds = 64 a row, 2 rows.
    assert model_flops.count(cfg) == 128
    assert model_flops.count(cfg, train=True) == 384


def test_bound():
    assert peaks.bound_s(3.35e12, 1.0, "bf16_tensor") == (1.0, "bytes")
    assert peaks.bound_s(1.0, 989e12, "bf16_tensor") == (1.0, "operations")
    assert peaks.bound_s(0.0, 67e12, "f32") == (1.0, "operations")


def test_the_plan_is_frozen():
    # The counts read the workload's frozen plan; a program whose spec for
    # the cell differs stops the run.
    from portbench import harness, system
    from portbench.tests.conftest import ROOT
    _, _, cfg, mix, _ = harness.load_cell(ROOT, "config4.rollout")
    plan = system.plan_shapes(cfg, mix)
    assert plan["num_slots"] == mix["plan"]["num_slots"] == 645888
    assert plan["num_particles"] == 500000 and plan["carry_bytes"] == 4
    with pytest.raises(SystemExit, match="frozen plan"):
        system.plan_shapes(cfg, dict(mix, plan=dict(mix["plan"], query_block=224)))
