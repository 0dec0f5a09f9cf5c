"""The comparison's two readings for a cell, on the card, through the
harness's own run of the cell.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]
        [--fault <name>]

For each seed, one run of the cell (``harness.run_cell``) with a window of
3 seconds: the traffic's own load, long enough for its longest requests,
and as many requests or checked steps compared as a run compares. Without
``--fault`` the control takes the program's place: the plain reference
with every matmul operand in float8 (e4m3), the precision below the bf16
operands the configurations state. Its result must come out not correct;
its ``readings`` hold the program's numbers (the lower reading of each
limit) and the control's (the upper). With ``--fault`` one of
``portbench/faults.py``'s faults is planted in the program instead, and
the run's own numbers are the fault's reading. One JSON result line a
seed. The benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402

from portbench import faults, harness  # noqa: E402

WINDOW_S = 3.0


def main(argv):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--fault", choices=sorted(faults.FAULTS))
    args = parser.parse_args(argv)
    bench, cell, cfg, mix, limits = harness.load_cell(ROOT, args.workload)
    import torch
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    control = None if args.fault else torch.float8_e4m3fn
    start = T_START
    for seed in args.seeds:
        with faults.planted(args.fault) if args.fault else contextlib.nullcontext():
            result = harness.run_cell(bench, cell, cfg, mix, limits, seed, WINDOW_S, 0,
                                      torch.device("cuda", 0), start, control=control)
        result.update(workload=args.workload, seed=seed, fault=args.fault or "control",
                      seconds=time.perf_counter() - start)
        print(json.dumps(result), flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
