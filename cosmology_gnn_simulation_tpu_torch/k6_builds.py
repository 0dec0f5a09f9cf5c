"""K6 (``csrc/fused_tail_bwd.cu``) built with other nvcc flags than its own.

    python -m cosmology_gnn_simulation_tpu_torch.k6_builds [--n N] [--seed S]

Builds the kernel three ways, all at once: "committed" (``NVCC_FLAGS`` and
its ``EXTRA_FLAGS``, the build the port loads), "fma" (the same without
``--fmad=false``: FMA contraction on) and "cicc-O1" (the committed flags
with the front end at ``-O1``). Prints each build's ``-Xptxas -v`` stack
and spill lines, then holds each against the plain version at ``[N, 128]``
with bf16 and f32 agg (chip_smoke.py's K6 tolerance) and times it as
chip_smoke.py does: events around back-to-back calls, and a CUDA graph of
the calls (device time). Prints the card's name and power limit. Needs a
CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from unittest import mock

import torch

from cosmology_gnn_simulation_tpu_torch import kernels
from cosmology_gnn_simulation_tpu_torch.models.mlp import init_mlp
from cosmology_gnn_simulation_tpu_torch.ops import fused_step
from cosmology_gnn_simulation_tpu_torch.types import tree_map

NAME = "fused_tail_bwd"
K6_REL, K6_MEAN = 1e-2, 1e-3  # chip_smoke.py's


def _flag_sets():
    own = kernels.NVCC_FLAGS + kernels.EXTRA_FLAGS.get(NAME, [])
    return {"committed": own, "fma": [f for f in own if f != "--fmad=false"],
            "cicc-O1": own + ["-Xcicc", "-O1"]}


def _build_all():
    """{label: (library path, ptxas stack and spill lines)}."""
    out_dir = kernels.BUILD_DIR / "k6_builds"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = str(kernels.PACKAGE_DIR / "csrc" / f"{NAME}.cu")
    procs = {label: subprocess.Popen(
        [kernels._nvcc(), *flags, "-o", str(out_dir / f"{label}.so"), source],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for label, flags in _flag_sets().items()}
    built = {}
    for label, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {label} build:\n{log}")
        # The kernel's two instantiations (f32 agg first), then the reduce.
        none = "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
        stack = [line.strip() for line in log.splitlines()
                 if "stack frame" in line and line.strip() != none]
        built[label] = (out_dir / f"{label}.so", stack)
    return built


def _close(a, b):
    """chip_smoke.py's ``mostly_close``."""
    a, b = a.detach().float(), b.detach().float()
    err = (a - b).abs()
    off = int((err > K6_REL * float(b.abs().max())).sum())
    return off <= 1e-5 * b.numel() and float(err.mean()) <= K6_MEAN * float(b.abs().mean())


def _events_ms(fn, reps):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(fn, reps):
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


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n", type=int, default=65536)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k6_builds needs a CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    built = _build_all()
    gen = torch.Generator().manual_seed(args.seed)
    node = init_mlp(gen, 256, 128, 2, 128, layer_norm=True)
    node["ln"] = {"scale": torch.rand(128, generator=gen) + 0.5,
                  "bias": torch.randn(128, generator=gen) * 0.1}
    node = tree_map(lambda t: t.to(dev), node)
    x = torch.randn(args.n, 128, generator=gen).to(dev)
    agg = torch.randn(args.n, 128, generator=gen).bfloat16().to(dev)
    agg32 = agg.float() + 1e-3 * torch.randn(args.n, 128, generator=gen).to(dev)
    aggs = {"bf16": agg, "f32": agg32}
    g = torch.randn(args.n, 128, generator=gen).to(dev)
    refs = {k: fused_step.fused_step_tail_bwd_reference(x, a, g, node) for k, a in aggs.items()}
    for label, (path, stack) in built.items():
        lib = fused_step._bind(ctypes.CDLL(str(path)), NAME)
        row = []
        with mock.patch.object(fused_step, "_lib", lambda name: lib):
            for key, a in aggs.items():
                def call():
                    return fused_step.fused_step_tail_bwd(x, a, g, node)
                dx, dagg, grads = call()
                ref = refs[key]
                ok = all(_close(u, v) for u, v in zip([dx, dagg, *grads],
                                                      [ref[0], ref[1], *ref[2]]))
                row.append(f"{key} agg: {'within tolerance' if ok else 'OUT OF TOLERANCE'}, "
                           f"events {_events_ms(call, 100):.5f} ms, graph "
                           f"{_graph_ms(call, 20):.5f} ms")
        print(f"{label}: {'; '.join(stack) or 'no stack'}\n    " + "\n    ".join(row))


if __name__ == "__main__":
    main()
