"""The transpose certificate ``reverse_mismatch`` of the hybrid plan comes
from two independent edge counts, S's (K3's count of the offsets it
accumulates) and S_rev's (K7's count of the edges it tables). Losing one
edge on either side before the build must show as +1 or -1, so the counts
cannot make the certificate a tautology. No JAX here; the ``cuda`` twin is
``tests/test_torch_cuda.py::test_reverse_mismatch_fires_on_the_card``.
"""

import pytest
import torch

from cosmology_gnn_simulation_tpu_torch.ops import cellblock
from cosmology_gnn_simulation_tpu_torch.ops.cell_list import choose_cell_grid
from cosmology_gnn_simulation_tpu_torch.ops.pallas_knn import (
    codes_packing_cap,
    pallas_cell_list_knn,
)


def drop_one_edge(monkeypatch, side, spec):
    """Patch the plan build's codes route to lose the first edge it holds:
    from the sender packs the reverse table reads (``side="packs"``:
    ``reverse_mismatch`` +1) or from S's offsets (``"offsets"``: -1)."""
    if side == "packs":
        real = cellblock.sender_packs

        def patched(*args):
            packs = real(*args).clone()
            flat = packs.view(-1)
            flat[int(torch.nonzero(flat < spec.num_slots)[0])] = spec.num_slots
            return packs

        monkeypatch.setattr(cellblock, "sender_packs", patched)
    else:
        real = cellblock.s_decode

        def patched(*args):
            offsets, dropped = real(*args)
            offsets = offsets.clone()
            flat = offsets.view(-1)
            flat[int(torch.nonzero(flat < spec.s_width)[0])] = spec.s_width
            return offsets, dropped

        monkeypatch.setattr(cellblock, "s_decode", patched)


@pytest.mark.parametrize("side", ["packs", "offsets"])
def test_reverse_mismatch_fires(side, monkeypatch):
    n, k = 3000, 8
    pos = torch.rand(n, 3, generator=torch.Generator().manual_seed(9))
    grid = choose_cell_grid(n, k)
    spec = cellblock.choose_cellblock_spec(n, k)
    _, codes, spill = pallas_cell_list_knn(pos, k, 1.0, grid, codes_only=True)
    kw = dict(with_reverse=True, neighbor_codes=codes, codes_cap=codes_packing_cap(n, k, grid),
              codes_spill=spill)
    clean = cellblock.build_cellblock(pos, None, 1.0, spec, **kw)
    assert int(clean.reverse_mismatch) == 0 and int(clean.dropped_edges) == 0
    drop_one_edge(monkeypatch, side, spec)
    plan = cellblock.build_cellblock(pos, None, 1.0, spec, **kw)
    assert int(plan.reverse_mismatch) == (1 if side == "packs" else -1)
