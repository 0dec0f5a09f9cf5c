"""Requests of ``rollout.rollout``: a simulation campaign with one client.

A request rolls one window of the pool forward ``steps_per_request`` steps
on the mix's route and ends when the host holds the request's per-step
certificate (``neighbor_exactness``) and has checked it. A request whose
certificate is false at any step has failed. The comparison replays a
sample of the window's requests, drawn from the seed, through the plain
reference, one step at a time from the program's own frames.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import system
from portbench.reference import integrate, weights
from portbench.traffic import frames

NUMBERS = ("position_rms", "position_max", "temperature_rms", "temperature_max")


class Entry:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from cosmology_gnn_simulation_tpu_torch.rollout import rollout
        self.cfg, self.mix, self.device = cfg, mix, device
        self.n, self.k = cfg["num_particles"], cfg["num_neighbors"]
        self.steps = mix["steps_per_request"]
        self.work_per_request = self.n * self.steps
        self.steps_per_request = self.steps
        self.weights = weights.make_weights(cfg, seed, device)
        self.windows = [frames.rollout_window(self.n, mix, s)
                        for s in frames.pool_seeds(seed, mix["pool"])]
        self.device_windows = [(torch.from_numpy(p).to(device), torch.from_numpy(t).to(device))
                               for p, t in self.windows]
        self.stats = system.stats(cfg, device)
        model_cfg = system.model_config(cfg, mix)
        kw = dict(num_neighbors=self.k, dtype=getattr(torch, cfg["compute_dtype"]),
                  exactness_guard="flag", device=device, **mix["route"])
        self._call = lambda pos, temp: rollout(self.weights, model_cfg, pos, temp, self.stats,
                                               self.steps, **kw)
        self.plan = system.plan_shapes(cfg, mix)
        self._rng = np.random.default_rng([seed, 1])
        self.kept = []  # (pool index, coordinates, energies) of the sampled requests
        self.ok = []
        self._count = 0

    def warm_up(self):
        self._run(0)
        self.begin()

    def begin(self):
        self.kept, self.ok, self._count = [], [], 0

    def _run(self, i):
        p = i % len(self.device_windows)
        out = self._call(*self.device_windows[p])
        return p, out, bool(out["neighbor_exactness"].all())

    def request(self, i):
        p, out, ok = self._run(i)
        self.ok.append(ok)
        # Reservoir sampling, drawn from the seed, over the finished requests.
        size = self.mix["check_requests"]
        if len(self.kept) < size:
            self.kept.append((p, out["Coordinates"], out["InternalEnergy"]))
        else:
            j = int(self._rng.integers(0, self._count + 1))
            if j < size:
                self.kept[j] = (p, out["Coordinates"], out["InternalEnergy"])
        self._count += 1

    def settle(self):
        return list(self.ok)

    def release(self):
        del self.device_windows
        self._call = None
        torch.cuda.empty_cache()

    @torch.no_grad()
    def compare(self, low=None):
        """The program's numbers against the float32 reference and, with
        ``low``, the same numbers of the reference computed in ``low``.

        Each number is a gap to the float32 reference (root mean square or
        widest over the particles and steps compared), in units of the root
        mean square gap of the reference computed with the configuration's
        own operand precision (bf16): the program's gap as a multiple of an
        honest computation's at that precision. The random weights of a seed
        set how much rounding grows through the network, for every
        precision alike; the unit takes that out. ``raw`` holds the gaps in
        box units and temperature units."""
        stats = dict(self.cfg["metadata"])
        frames_, box = self.cfg["window"], stats["box_size"]
        sides = {"program": None, "stated": getattr(torch, self.cfg["compute_dtype"])}
        if low is not None:
            sides["control"] = low
        sums = {side: [0.0, 0.0, 0.0, 0.0] for side in sides}
        count = ambiguous = 0
        for _, coords, energy in self.kept:
            for s in range(coords.shape[0] - frames_):
                pos, temp = coords[s:s + frames_], energy[s:s + frames_]
                ref_pos, ref_temp, amb = integrate.next_frame(pos, temp, self.weights, stats,
                                                              self.k)
                count += ref_pos.shape[0]
                ambiguous += int(amb.sum())
                for side, precision in sides.items():
                    if precision is None:
                        got_pos, got_temp = coords[s + frames_], energy[s + frames_]
                    else:
                        got_pos, got_temp, _ = integrate.next_frame(
                            pos, temp, self.weights, stats, self.k, precision)
                    dpos = _wrap(got_pos - ref_pos, box).norm(dim=1)
                    dtemp = (got_temp - ref_temp).abs().flatten()
                    acc = sums[side]
                    acc[0] += float((dpos ** 2).sum())
                    acc[1] = max(acc[1], float(dpos[~amb].max()))
                    acc[2] += float((dtemp ** 2).sum())
                    acc[3] = max(acc[3], float(dtemp[~amb].max()))
        raw = {side: dict(zip(NUMBERS, ((p2 / count) ** 0.5, pmax, (t2 / count) ** 0.5, tmax)))
               for side, (p2, pmax, t2, tmax) in sums.items()}
        unit_pos = max(raw["stated"]["position_rms"], 1e-30)
        unit_temp = max(raw["stated"]["temperature_rms"], 1e-30)
        out = {side: {name: value / (unit_pos if name.startswith("position") else unit_temp)
                      for name, value in raw[side].items()}
               for side in sides if side != "stated"}
        out["raw"] = raw
        out["note"] = (f"{len(self.kept)} requests, {count} particle-steps compared, {ambiguous} "
                       f"with a k-th neighbour tie left out of the widest gaps; bf16 reference's "
                       f"gaps {unit_pos:.4g} (position), {unit_temp:.4g} (temperature)")
        return out


def _wrap(d, box):
    return d - box * torch.round(d / box)
