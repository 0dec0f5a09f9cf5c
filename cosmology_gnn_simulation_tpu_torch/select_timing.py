"""Times the k-NN selection kernels on the card: K1 in its three modes and
K8, at N = 65,536 (chip_smoke.py's uniform seed frame), k = 16 and 48.

    python -m cosmology_gnn_simulation_tpu_torch.select_timing [--root DIR] [--label L]

With ``--root`` it times the port's package of the repository at ``DIR``
instead of this one (imported afresh from there), so one call can time two
trees in turns (for example a parent commit
unpacked beside this one: parent, this tree, this tree, parent). Each
kernel is timed by CUDA events around 50 back-to-back wrapper calls
(``ms``) and from a CUDA graph of 20 calls (``graph_ms``, the device time
without the host's cost of each call). K8 searches the plan's live rows
where the package's wrapper takes them (a ``rows`` argument), else every
row. A kernel that refuses to launch is reported with its error. Prints
one JSON line with the card's name and power limit. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

N, KS = 65536, (16, 48)
PACKAGE = "cosmology_gnn_simulation_tpu_torch"


def _import_from(root: str):
    """The package's kernels, cellblock, pallas_knn and cell_list modules,
    imported from the repository at ``root``."""
    for name in [m for m in sys.modules if m == PACKAGE or m.startswith(PACKAGE + ".")]:
        del sys.modules[name]
    sys.path.insert(0, str(Path(root).resolve()))
    return [importlib.import_module(f"{PACKAGE}.{m}")
            for m in ("kernels", "ops.cellblock", "ops.pallas_knn", "ops.cell_list")]


def time_ms(fn, reps: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed(fn) -> dict:
    """Events and graph times of ``fn``; a kernel that refuses to launch
    gets the error instead, and a wrapper that cannot be captured in a
    graph (one that reads the device back) ``graph_ms`` None."""
    try:
        ms = time_ms(fn, 50)
    except RuntimeError as err:
        return {"error": str(err)}
    try:
        gms = graph_ms(fn, 20)
    except RuntimeError as err:
        print(f"graph capture failed: {err}", file=sys.stderr)
        gms = None
    return {"ms": ms, "graph_ms": gms}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--label", default="")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("select_timing needs a CUDA device")
    kernels, cellblock, pallas_knn, cell_list = _import_from(args.root)
    choose_cell_grid = cell_list.choose_cell_grid

    kernels.build(["knn_select", "dense_select"])
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)  # chip_smoke.py's seed frame, its last step
    base = rng.uniform(0, 1, (1, N, 3))
    drift = rng.normal(0, 5e-4, (5, N, 3)).cumsum(axis=0)
    pos = torch.as_tensor(np.remainder(base + drift, 1.0).astype(np.float32)[-1], device=dev)
    box = torch.full((), 1.0, dtype=torch.float32, device=dev)
    out = {"label": args.label, "root": args.root}
    for k in KS:
        grid = choose_cell_grid(N, k)
        cap, _, spill_cap = pallas_knn.spill_layout(N, k, grid)
        t = pallas_knn.build_table(pos, grid.grid_size, cap, box)
        spill = pallas_knn.build_spill(pos, t.particle_rank, cap, spill_cap)
        planes = (t.x, t.y, t.z, t.ids)
        kw = dict(k=k, n=N, g=grid.grid_size, box=1.0,
                  mi_start=pallas_knn.min_image_start(cap, spill_cap))
        for name in ("knn_select", "knn_codes", "knn_dual"):
            fn = getattr(pallas_knn, name)
            call = lambda fn=fn: fn(planes, spill, **kw)  # noqa: E731
            out[f"{name}_k{k}"] = timed(call)
    spec = cellblock.choose_cellblock_spec(N, 16)
    dspec = cellblock.choose_dense_search_spec(N, spec)
    layout = cellblock.cellblock_layout(pos, 1.0, spec)
    ds = cellblock.dense_search_inputs(layout, pos[layout.order], 1.0, spec, dspec)
    # A wrapper with a ``rows`` argument searches the plan's live rows; an
    # older one searches every row.
    takes_rows = "rows" in inspect.signature(cellblock.dense_select).parameters
    args = (ds.table, ds.queries, ds.windows, 1.0) + ((ds.rows,) if takes_rows else ())
    for k in KS:
        kw = dict(k=k, query_block=dspec.query_block, w_eff=ds.w_eff)
        out[f"dense_select_k{k}"] = timed(lambda kw=kw: cellblock.dense_select(*args, **kw))
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
