"""Times the plan kernels K2 (the codes decode) and K7 (the reverse table)
on the card, each with the torch code around it that the plan build runs,
at N = 65,536, k = 16 (chip_smoke.py's uniform seed frame, the flagship
spec).

    python -m cosmology_gnn_simulation_tpu_torch.plan_timing [--root DIR] [--label L]

With ``--root`` it times the port's package of the repository at ``DIR``
(imported afresh from there), so one call can time two trees in turns
(parent, this tree, this tree, parent). It times what each tree's
``build_cellblock`` runs for the same result, like with like:

* ``decode``: the particle-order codes to S offsets and the dropped-edge
  count. A tree whose K2 takes slot codes runs the torch prologue first
  (``slot_codes``: scatter to slots, 27-roll start table, spill
  resolution; ``_normalized_codes``), then K2 and a sum; a tree whose K2
  takes the particle-order codes runs K2 alone.
* ``certificate``: K3 and K7 with ``reverse_mismatch`` from the sender
  packs. A tree whose K7 takes the padded candidates runs
  ``reverse_candidates``, K3, K7 and the two int64 table sums; a tree
  whose kernels count their edges runs K3 with its count, K7 and one
  subtraction.
* ``k2`` and ``k7``: the kernel alone on the inputs its wrapper takes.

Each is timed by CUDA events around 50 back-to-back calls (``ms``) and
from a CUDA graph of 20 calls (``graph_ms``). Prints one JSON line with
the card's name and power limit. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from cosmology_gnn_simulation_tpu_torch.select_timing import _import_from, timed

N, K = 65536, 16


def _counted_calls(cellblock, layout, codes, spill, sc, spec, cap):
    """(decode, certificate, k2, k7) of a tree whose K2 takes the
    particle-order codes and whose K3 and K7 count their edges."""
    packs = cellblock.sender_packs(sc, layout, cap, spec)

    def decode():
        return cellblock.s_decode(codes, spill, layout, spec, cap)

    def certificate(offsets):
        _, s_total = cellblock.s_onehot(offsets, width=spec.s_width, with_total=True)
        _, rev_total = cellblock.reverse_table(packs, layout, spec)
        return s_total - rev_total

    return decode, certificate, decode, lambda: cellblock.reverse_table(packs, layout, spec)


def _slot_codes_calls(cellblock, layout, codes, spill, sc, spec, cap):
    """The same for a tree whose K2 takes normalized slot codes and a
    27-roll start table and whose K7 takes the padded candidates: its torch
    prologues and the two int64 table sums are part of what it runs."""
    width = spec.s_width
    packs = cellblock.sender_packs(sc, cap, spec)

    def decode():
        s = cellblock.slot_codes(layout, codes, cap, spill, spec)
        off = cellblock.s_decode(cellblock._normalized_codes(s, cap, spec),
                                 s.qz_slot.contiguous(), s.cstart27, layout.tile_const,
                                 spec=spec, codes_cap=cap)
        return off, (off == width + 1).sum()

    def certificate(offsets):
        s_table = cellblock.s_onehot(offsets, width=width)
        s_rev = cellblock.reverse_table(cellblock.reverse_candidates(packs, layout, spec),
                                        layout.window_starts, spec=spec)
        return s_table.sum(dtype=torch.int64) - s_rev.sum(dtype=torch.int64)

    k2_in = (cellblock._normalized_codes(sc, cap, spec), sc.qz_slot.contiguous(), sc.cstart27,
             layout.tile_const)
    packed = cellblock.reverse_candidates(packs, layout, spec)
    return (decode, certificate,
            lambda: cellblock.s_decode(*k2_in, spec=spec, codes_cap=cap),
            lambda: cellblock.reverse_table(packed, layout.window_starts, spec=spec))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--label", default="")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("plan_timing needs a CUDA device")
    kernels, cellblock, pallas_knn, cell_list = _import_from(args.root)
    kernels.build(["s_decode", "s_onehot", "reverse_table"])
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)  # chip_smoke.py's seed frame, its last step
    base = rng.uniform(0, 1, (1, N, 3))
    drift = rng.normal(0, 5e-4, (5, N, 3)).cumsum(axis=0)
    pos = torch.as_tensor(np.remainder(base + drift, 1.0).astype(np.float32)[-1], device=dev)
    grid = cell_list.choose_cell_grid(N, K)
    spec = cellblock.choose_cellblock_spec(N, K)
    cap = pallas_knn.codes_packing_cap(N, K, grid)
    layout = cellblock.cellblock_layout(pos, 1.0, spec)
    _, codes, spill = pallas_knn.pallas_cell_list_knn(pos, K, 1.0, grid, codes_only=True)
    sc = cellblock.slot_codes(layout, codes, cap, spill, spec)
    # A tree whose K2 takes the layout counts in its kernels; an older tree
    # (K2 from slot codes) is timed through _slot_codes_calls, kept so the A/B
    # in PERF.md can be run again against such a tree.
    fused = "layout" in inspect.signature(cellblock.s_decode).parameters
    calls = _counted_calls if fused else _slot_codes_calls
    decode, certificate, k2, k7 = calls(cellblock, layout, codes, spill, sc, spec, cap)
    offsets, _ = decode()
    out = {"label": args.label, "root": args.root, "fused": fused,
           "reverse_mismatch": int(certificate(offsets))}
    out["decode"] = timed(decode)
    out["k2"] = timed(k2)
    out["certificate"] = timed(lambda: certificate(offsets))
    out["k7"] = timed(k7)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
