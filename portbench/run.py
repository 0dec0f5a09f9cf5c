"""Run one cell of the benchmark of the PyTorch and CUDA port.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout holding the port. Exits non-zero with no
result without a CUDA device. The last line of standard output is the
result, as one JSON object; the numbers compared and their limits are the
last lines of standard error.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# The repository root, not this folder, heads the search path: the port and
# this package import from there.
sys.path[0] = str(ROOT)

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START, ROOT))
