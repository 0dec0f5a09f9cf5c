"""One run of one cell: set-up, the measured window, the comparison, the
result line.

Everything that belongs to a cell is data found by name: the cell in
``BENCHMARK.json`` names its configuration (``portbench/configs/``) and its
traffic mix (``portbench/workloads/<traffic>.json``, which names the entry
point in ``portbench/entries/``); its comparison's limits are
``portbench/limits/<cell>.json``; each metric is read by
``portbench/metrics/<metric>.py``, or where that file is not there by the
reader of its name's stem, ``<stem>.py`` for ``<stem>.<suffix>``: a
quantity split into a rollout and a train metric has one reader.

``--trace 0`` measures the cell's end-to-end metrics over ``--seconds``.
``--trace 1`` measures its per-layer metrics: the first half of the window
runs with the profiler off and gives the time a step, then the profiler
traces a few requests, and train cells count their synchronizing calls
over a few more steps.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

from portbench import tracing

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "cosmology_gnn_simulation_tpu"}


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, name: str):
    """``(benchmark, cell, configuration, mix, limits)`` of cell ``name``."""
    bench = _load_json(root / "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = _load_json(root / config["file"])
    mix = _load_json(HERE / "workloads" / f"{cell['traffic']}.json")
    limits = _load_json(HERE / "limits" / f"{name}.json")
    return bench, cell, cfg, mix, limits


def metrics_of(bench: dict, cell: str, kind: str) -> list:
    """The metrics of ``kind`` (``end_to_end`` or ``per_layer``) that the
    cell reports."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def reader_path(name: str) -> Path:
    own = HERE / "metrics" / f"{name}.py"
    return own if own.is_file() else HERE / "metrics" / f"{name.split('.')[0]}.py"


def reader(name: str) -> types.ModuleType:
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", reader_path(name))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def nvidia_smi(query: str) -> str:
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi unavailable: {err}"


def run_window(entry, seconds: float):
    """Requests until ``seconds`` have passed: ``{"seconds", "latencies_s",
    "ok", ...}``. The window ends when its last request has been settled:
    settling reads results on the host, after all the work before them."""
    entry.begin()
    latencies = []
    cpu0 = time.process_time()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i = 0
    while True:
        start = time.perf_counter()
        if start >= deadline and latencies:
            break
        entry.request(i)
        latencies.append(time.perf_counter() - start)
        i += 1
    ok = entry.settle()
    total = time.perf_counter() - t0
    return {"seconds": total, "latencies_s": latencies, "ok": ok,
            "cpu_seconds": time.process_time() - cpu0,
            "work_per_request": entry.work_per_request,
            "steps_per_request": entry.steps_per_request, "next": i}


def describe(window: dict) -> str:
    """The window's requests and their latencies: quartiles, and the mean of
    each third of the window (a drift shows there)."""
    lat = [t * 1e3 for t in window["latencies_s"]]
    thirds = [lat[i * len(lat) // 3:(i + 1) * len(lat) // 3] for i in range(3)]
    quart = statistics.quantiles(lat, n=4) if len(lat) > 1 else lat * 3
    dec = statistics.quantiles(lat, n=10) if len(lat) > 1 else lat
    return (f"{len(lat)} requests in {window['seconds']:.3f} s; latency ms quartiles "
            f"{[round(q, 3) for q in quart]}, deciles {[round(q, 1) for q in dec]}, by thirds "
            f"{[round(statistics.fmean(t), 3) for t in thirds if t]}; this process's CPU "
            f"seconds {window['cpu_seconds']:.3f}")


def count_syncs(fn) -> int:
    """The synchronizing calls ``fn()`` makes, under CUDA's sync debug mode."""
    import warnings

    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchronizing CUDA operation" in str(w.message) for w in caught)


def main(argv, t_start: float, root: Path) -> int:
    parser = argparse.ArgumentParser(description="Run one cell of the port's benchmark.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    bench, cell, cfg, mix, limits = load_cell(root, args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result",
              file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    print(f"card: {nvidia_smi('name,power.limit')}", file=sys.stderr)
    result = run_cell(bench, cell, cfg, mix, limits, args.seed, args.seconds, args.trace,
                      torch.device("cuda", 0), t_start)
    found = forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: {found}: no result",
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


def run_cell(bench, cell, cfg, mix, limits, seed, seconds, trace, device, t_start,
             control=None) -> dict:
    """One run of the cell on ``device``: its result, as the last line
    prints it. With ``control`` (a dtype) the control takes the program's
    place in the comparison: the plain reference computed with operands in
    ``control``; the result then also holds both sides' ``readings``."""
    import torch
    cuda = device.type == "cuda"
    synchronize = torch.cuda.synchronize if cuda else (lambda: None)
    clocks = "clocks.sm,clocks.mem,power.draw,temperature.gpu"
    entry = importlib.import_module(f"portbench.entries.{mix['entry']}").Entry(
        cfg, mix, seed, device)
    entry.warm_up()
    synchronize()
    setup_seconds = time.perf_counter() - t_start
    if cuda:
        print(f"before the window: {nvidia_smi(clocks)}", file=sys.stderr)

    ctx = types.SimpleNamespace(cfg=cfg, mix=mix, plan=entry.plan, setup_seconds=setup_seconds,
                                trace=None, syncs_per_step=None)
    breakdown = None
    if trace:
        ctx.window = run_window(entry, seconds / 2)
        steps, nxt = mix["trace_requests"], ctx.window["next"]

        def traced():
            for j in range(steps):
                entry.request(nxt + j)
            entry.settle()

        ctx.trace = tracing.capture(traced, steps * entry.steps_per_request, synchronize)
        if mix.get("sync_steps") and cuda:
            entry.begin()
            syncs = count_syncs(lambda: [entry.request(j) for j in range(mix["sync_steps"])])
            entry.settle()
            ctx.syncs_per_step = syncs / (mix["sync_steps"] * entry.steps_per_request)
        breakdown = {"device_ops": tracing.top_ops(ctx.trace.device),
                     "idle_gaps": tracing.idle_gaps(ctx.trace)}
        kind = "per_layer"
    else:
        ctx.window = run_window(entry, seconds)
        kind = "end_to_end"
    if cuda:
        print(f"after the window: {nvidia_smi(clocks)}", file=sys.stderr)
    print(f"window: {describe(ctx.window)}", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    metrics = {}
    for m in metrics_of(bench, cell["name"], kind):
        value = reader(m["name"]).read(ctx)
        if value is None:
            # A kernel the program no longer launches leaves its share silent.
            print(f"metric {m['name']}: nothing to read in this run", file=sys.stderr)
        else:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    window = ctx.window
    attempted, failed = len(window["ok"]), window["ok"].count(False)
    entry.release()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    compared = entry.compare(low=control)
    print(f"compared in {time.perf_counter() - t0:.1f} s: {compared['note']}", file=sys.stderr)
    side = "program" if control is None else "control"
    checks = {name: {"value": value, "limit": limits[name]}
              for name, value in compared[side].items()}
    for name, c in checks.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)

    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else device.type,
                   "count": cell["chips"], "memory_peak_bytes": int(peak)}
    if trace:
        device_info["busy_s"] = tracing.busy_s(ctx.trace.device)
        device_info["window_s"] = ctx.trace.wall_s
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if control is not None:
        result["readings"] = {s: compared[s] for s in ("program", "control")}
    result["checks"] = checks
    return result
