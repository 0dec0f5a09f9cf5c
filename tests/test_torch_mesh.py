"""The port's process mesh (``parallel/mesh.py``) without spawning ranks:
the multi-node layout on rank records (the cases of
``tests/test_mesh_layout.py``), ``initialize_distributed`` without an
environment and with a stand-in ``init_process_group``, a mesh of one rank
(``tests/test_parallel.py::test_mesh_creation`` at world size 1), the
collectives on it, and the per-sample keying of the sharded train step's
randomness."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cosmology_gnn_simulation_tpu_torch.parallel import collectives as coll
from cosmology_gnn_simulation_tpu_torch.parallel import mesh as mesh_lib
from cosmology_gnn_simulation_tpu_torch.parallel.mesh import (
    RankInfo,
    hybrid_device_order,
    initialize_distributed,
    make_mesh,
)
from cosmology_gnn_simulation_tpu_torch.parallel.sharded import _sample_generators

TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK",
                "LOCAL_WORLD_SIZE")


def _ranks(num_nodes, per_node):
    return [RankInfo(rank=n * per_node + i, node=n)
            for n in range(num_nodes) for i in range(per_node)]


@pytest.fixture
def one_rank(monkeypatch):
    """No torchrun environment; the process group made by ``make_mesh``
    is taken down after the test."""
    for var in TORCHRUN_ENV:
        monkeypatch.delenv(var, raising=False)
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_data_axis_spans_nodes():
    arr = hybrid_device_order(_ranks(2, 4), (2, 4))  # (data, particle)
    assert arr.shape == (2, 4)
    for row in range(2):  # each data row is one node...
        assert {r.node for r in arr[row]} == {row}
    for col in range(4):  # ...and each particle column crosses nodes only along data
        assert [r.node for r in arr[:, col]] == [0, 1]


def test_hybrid_data_axis():
    arr = hybrid_device_order(_ranks(4, 2), (8, 1))
    assert [r.node for r in arr[:, 0]] == [0, 0, 1, 1, 2, 2, 3, 3]
    assert [r.rank for r in arr[:, 0]] == list(range(8))


def test_particle_axis_stays_local():
    arr = hybrid_device_order(_ranks(2, 4), (2, 2, 2), data_axis=0)
    for i in range(2):
        assert {r.node for r in arr[i].reshape(-1)} == {i}


def test_rejects_data_axis_not_divisible_by_nodes():
    with pytest.raises(ValueError, match="data axis"):
        hybrid_device_order(_ranks(2, 4), (1, 8))


def test_rejects_uneven_nodes():
    ranks = _ranks(2, 4)[:-1] + [RankInfo(rank=99, node=0)]
    with pytest.raises(ValueError, match="evenly"):
        hybrid_device_order(ranks, (2, 4))


def test_rejects_wrong_product():
    with pytest.raises(ValueError, match="multiply"):
        hybrid_device_order(_ranks(2, 4), (2, 3))


def test_initialize_distributed_noop_without_environment(one_rank):
    assert initialize_distributed() is False
    assert initialize_distributed(device="cpu") is False
    assert not dist.is_initialized()


@pytest.mark.parametrize("device,backend", [("cpu", "gloo"), ("cuda", "nccl")])
def test_initialize_distributed_calls_init_process_group(one_rank, monkeypatch, device,
                                                         backend):
    """The backend follows the device (no other is tried); the card's rank
    takes cuda:{LOCAL_RANK}; torchrun's environment alone also joins."""
    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: calls.append((a, kw)))
    monkeypatch.setattr(mesh_lib, "resolve_device", torch.device)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: calls.append(("set_device", i)))
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert initialize_distributed("file:///tmp/x", 4, 1, device=device) is True
    if device == "cuda":
        assert calls.pop(0) == ("set_device", 3)
    assert calls == [((backend,), dict(init_method="file:///tmp/x", world_size=4, rank=1))]
    calls.clear()
    for var, value in (("MASTER_ADDR", "localhost"), ("RANK", "0"), ("WORLD_SIZE", "2")):
        monkeypatch.setenv(var, value)
    assert initialize_distributed(device="cpu") is True
    assert calls == [(("gloo",), dict(init_method="env://", world_size=None, rank=None))]


def test_mesh_creation(one_rank):
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "particle": 1}
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    mesh = make_mesh((1, 1), device="cpu")
    assert [mesh.axis(name).size for name in ("data", "particle")] == [1, 1]
    assert [coll.axis_index(mesh.axis(name)) for name in ("data", "particle")] == [0, 0]
    assert mesh.device == torch.device("cpu") and mesh.rank == 0
    with pytest.raises(ValueError, match="multiply"):
        make_mesh((2, 1), device="cpu")


def test_collectives_on_one_rank(one_rank):
    """On one rank every collective is the identity, still made (and
    counted), with the transposes of the sharded step's convention: the
    gather's backward an all-reduce of the gathered gradient, psum's the
    identity, pmean's scaled by 1 / size."""
    axis = make_mesh((1, 1), device="cpu").axis("particle")
    coll.reset_collectives()
    x = torch.arange(6.0).reshape(3, 2).requires_grad_(True)
    gathered = coll.all_gather(x, axis)
    total = coll.psum(x.sum(0), axis)
    mean = coll.pmean(x.sum(), axis)
    assert torch.equal(gathered, x) and torch.equal(total, x.sum(0)) and torch.equal(mean,
                                                                                      x.sum())
    (gathered * 2).sum().add(total.sum()).add(mean).backward()
    assert torch.equal(x.grad, torch.full((3, 2), 4.0))
    flat = coll.all_reduce_flat([torch.ones(2), torch.arange(3, dtype=torch.int64)])
    assert torch.equal(flat[0], torch.ones(2)) and flat[1].dtype == torch.int64
    sent = coll.broadcast_flat([torch.ones(2, 2)])
    assert torch.equal(sent[0], torch.ones(2, 2))
    assert coll.collectives == {"all_gather": 1, "all_reduce": 4, "broadcast": 1,
                                "ppermute": 0}


def test_sample_generators_key_the_noise_by_shard():
    """A sample's augmentation draws are the same on every particle shard,
    its noise draws differ by shard, and both differ by sample and step."""
    def draws(step, sample, shard):
        aug, noise = _sample_generators(42, step, sample, shard, "cpu")
        return torch.rand(4, generator=aug), torch.randn(4, generator=noise)

    a0, n0 = draws(0, 0, 0)
    a1, n1 = draws(0, 0, 1)
    assert torch.equal(a0, a1) and not torch.equal(n0, n1)
    for other in (draws(0, 1, 0), draws(1, 0, 0)):
        assert not torch.equal(a0, other[0]) and not torch.equal(n0, other[1])
    assert torch.equal(draws(0, 0, 0)[1], n0)  # deterministic
    assert np.all(np.isfinite(n0.numpy()))
