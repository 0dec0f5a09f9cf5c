"""Activation checkpointing in the port's model (``remat``, ``remat_chunk``):
one train step with each gives the loss and gradients of the step without
it, bit for bit (the recomputed forward runs the same operations on the
same inputs), on gather and hybrid, with the fused tail's plain version on
and off, and on the slot-space path with the bf16 carry; and the
recomputation runs each step's forward again exactly as
often as the checkpoint structure implies, which ``chip_smoke.py`` holds
the card's kernel launches to. No JAX.

The file runs on one CPU thread: with several, the unpruned model's edge
gather backward (``y_src[neighbors]``, an accumulating ``index_put_``)
adds in thread order, and two runs without remat already differ in the
last bits.
"""

import collections

import numpy as np
import pytest
import torch

from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import (
    default_model_config,
    init_encode_process_decode,
)
from cosmology_gnn_simulation_tpu_torch.ops import cellblock, fused_step
from cosmology_gnn_simulation_tpu_torch.training.trainer import (
    Optimizer,
    TrainConfig,
    make_train_step,
)
from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats, tree_leaves

METADATA = {
    "temp_mean": 1.0, "temp_std": 0.3, "temp_rate_mean": 0.0,
    "temp_rate_std": 0.02, "vel_mean": 0.0, "vel_std": 0.06,
    "acc_mean": 0.0, "acc_std": 0.2, "box_size": 1.0, "dt": 0.05,
}
STEPS = 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tier-1 run puts six pytest workers on the
    host's cores, and this file's many small CPU ops run tens of times
    slower when each worker's thread pool competes for them. It also makes
    the accumulating index_put deterministic (see above)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(n=600, seed=0):
    rng = np.random.default_rng(seed)
    pos = np.remainder(rng.uniform(0, 1, (1, n, 3))
                       + rng.normal(0, 5e-4, (6, n, 3)).cumsum(0), 1.0).astype(np.float32)
    temp = (1.0 + rng.normal(0, 1e-3, (6, n, 1)).cumsum(0)).astype(np.float32)
    return {"positions": pos[None, :5], "temperatures": temp[None, :5],
            "target_positions": pos[None, 5], "target_temperatures": temp[None, 5]}


def _sgd_step(batch, aggregation, fused, steps=STEPS, model_kw=None, **remat):
    """(loss, gradient leaves) of one train step: SGD with lr 1, so the
    update is the gradient; noise 0, no augmentation."""
    cfg = default_model_config(latent_size=32, mlp_hidden_size=32, mlp_num_hidden_layers=1,
                               num_message_passing_steps=steps, **(model_kw or {}), **remat)
    params = init_encode_process_decode(cfg, torch.Generator().manual_seed(0), device="cpu")
    before = [t.detach().clone() for t in tree_leaves(params)]
    sgd = Optimizer(lambda leaves: torch.optim.SGD(leaves, lr=1.0))
    tc = TrainConfig(aggregation=aggregation, num_neighbors=8, noise_std=0.0, augment_prob=0.0,
                     fused_tail=fused, compute_dtype="bfloat16" if fused else None)
    step = make_train_step(cfg, NormalizationStats.from_metadata(METADATA, device="cpu"), tc, sgd)
    params, _, metrics = step(params, sgd.init(params), batch, torch.Generator())
    return float(metrics["loss"]), [b - a.detach() for b, a in zip(before, tree_leaves(params))]


CASES = [("gather", False, None), ("gather", True, None), ("cellblock_hybrid", False, None),
         ("cellblock_hybrid", True, None), ("gather", False, {"aggregate": "edge_messages"}),
         ("cellblock", True, {"carry_dtype": "bfloat16"})]


@pytest.mark.parametrize("aggregation,fused,model_kw", CASES,
                         ids=["gather", "gather-fused", "hybrid", "hybrid-fused",
                              "gather-unpruned", "slots-fused-bf16-carry"])
def test_remat_gives_the_same_loss_and_gradients(aggregation, fused, model_kw):
    batch = _batch()
    loss, grads = _sgd_step(batch, aggregation, fused, model_kw=model_kw)
    for remat in ({"remat": True}, {"remat_chunk": 2}):
        remat_loss, remat_grads = _sgd_step(batch, aggregation, fused, model_kw=model_kw,
                                            **remat)
        assert remat_loss == loss, remat
        assert all(torch.equal(a, b) for a, b in zip(remat_grads, grads)), remat
    if "carry_dtype" in (model_kw or {}):
        return
    # The float32 carry is the default carry.
    carry_loss, carry_grads = _sgd_step(batch, aggregation, fused,
                                        model_kw={**(model_kw or {}), "carry_dtype": "float32"})
    assert carry_loss == loss
    assert all(torch.equal(a, b) for a, b in zip(carry_grads, grads))


def _count_calls(monkeypatch):
    counts = collections.Counter()
    for module, name in ((fused_step, "_tail_forward"), (fused_step, "_tail_backward"),
                         (cellblock, "window_matmul"), (cellblock, "window_matmul_t")):
        def counted(*args, _fn=getattr(module, name), _name=name, **kwargs):
            counts[_name] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(module, name, counted)
    return counts


@pytest.mark.parametrize("remat,forwards", [
    ({}, 10),
    # Each step's forward again before its backward.
    ({"remat": True}, 10 + 10),
    # And each chunk's forward again, which stops (early-stopping
    # recomputation) once the chunk's last step has its input: c - 1 steps
    # of each of the M / c chunks.
    ({"remat_chunk": 5}, 10 + 10 + 2 * 4),
    ({"remat_chunk": 2}, 10 + 10 + 5 * 1),
])
def test_recomputation_count(monkeypatch, remat, forwards):
    """The hybrid train step with the fused tail at M = 10: the K4 and K5
    wrappers (here their plain versions) run ``forwards`` times, K4^T and
    K6 once a step."""
    counts = _count_calls(monkeypatch)
    _sgd_step(_batch(), "cellblock_hybrid", True, steps=10, **remat)
    assert counts == {"window_matmul": forwards, "_tail_forward": forwards,
                      "window_matmul_t": 10, "_tail_backward": 10}


def test_remat_chunk_must_divide_and_bf16_carry_is_not_ported():
    with pytest.raises(ValueError, match="remat_chunk=3 must divide num_message_passing_steps=4"):
        _sgd_step(_batch(n=64), "gather", False, remat_chunk=3)
    # The bf16 carry is ported: its step trains; an unknown carry is refused.
    loss, grads = _sgd_step(_batch(n=64), "gather", False, model_kw={"carry_dtype": "bfloat16"})
    assert np.isfinite(loss) and all(bool(torch.isfinite(g).all()) for g in grads)
    with pytest.raises(ValueError, match="carry_dtype"):
        _sgd_step(_batch(n=64), "gather", False, model_kw={"carry_dtype": "float16"})
