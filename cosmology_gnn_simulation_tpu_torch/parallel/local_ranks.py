"""Ranks on one machine: ``LocalRanks(world, fn, args)`` spawns ``world``
processes (``torch.multiprocessing``), joins them into one process group
over a file store (no TCP port to pick) and runs ``fn(*args)`` on each;
``results()`` returns what they returned, in rank order.

The ranks of the CPU tests and the ranks that share one card (``device=
"cuda:0"``, ``backend="gloo"``) start this way. ``fn`` must be a
module-level function (the spawned ranks import it). A rank that raises,
dies or has not answered by the deadline fails ``results()``, and every
rank is stopped before it returns; each collective times out after
``collective_timeout``, so a rank that waits on a dead peer fails too.
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch.distributed as dist
import torch.multiprocessing as mp

from cosmology_gnn_simulation_tpu_torch.parallel.mesh import initialize_distributed


def _rank_main(rank, world, init_file, device, backend, collective_timeout, fn, args, results):
    try:
        initialize_distributed(f"file://{init_file}", world, rank, device=device,
                               backend=backend, timeout=collective_timeout)
        results.put((rank, None, fn(*args)))
    except BaseException:  # reported to the parent, which fails results()
        results.put((rank, traceback.format_exc(), None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class LocalRanks:
    """``world`` spawned ranks running ``fn(*args)``, started at
    construction (the caller can work meanwhile)."""

    def __init__(self, world: int, fn: Callable, args: Sequence = (), *, device="cpu",
                 backend: Optional[str] = None, timeout_s: float = 240.0,
                 collective_timeout=datetime.timedelta(seconds=60),
                 init_file: Optional[str] = None):
        self._tmp = None
        if init_file is None:
            self._tmp = tempfile.TemporaryDirectory(prefix="local_ranks_")
            init_file = os.path.join(self._tmp.name, "rendezvous")
        ctx = mp.get_context("spawn")
        self.queue = ctx.Queue()
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(rank, world, init_file, device, backend,
                                        collective_timeout, fn, tuple(args), self.queue))
                      for rank in range(world)]
        for p in self.procs:
            p.start()
        self.timeout_s = timeout_s
        self.deadline = time.monotonic() + timeout_s

    def results(self) -> list:
        """Every rank's return value, in rank order; raises RuntimeError
        with the ranks' tracebacks and exit codes if any failed."""
        world = len(self.procs)
        out, errors = {}, []
        try:
            while len(out) < world and time.monotonic() < self.deadline:
                try:
                    rank, error, value = self.queue.get(timeout=1.0)
                except queue.Empty:
                    if not any(p.is_alive() for p in self.procs):
                        break  # every rank has exited: no result is coming
                    continue
                if error:
                    errors.append(f"rank {rank}:\n{error}")
                    # The others may wait on it in a collective: stop soon.
                    self.deadline = min(self.deadline, time.monotonic() + 10.0)
                out[rank] = value
            if len(out) < world:
                errors.append(f"results from ranks {sorted(out)} only "
                              f"(deadline {self.timeout_s} s)")
        finally:
            grace = time.monotonic() + 30.0
            for p in self.procs:
                p.join(timeout=max(grace - time.monotonic(), 0.0))
            for p in self.procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
            if self._tmp is not None:
                self._tmp.cleanup()
        codes = [p.exitcode for p in self.procs]
        if errors or any(code != 0 for code in codes):
            raise RuntimeError(f"ranks failed (exit codes {codes}):\n" + "\n".join(errors))
        return [out[rank] for rank in range(world)]
