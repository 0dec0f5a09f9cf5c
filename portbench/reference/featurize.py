"""Node features, training noise and training targets, plain PyTorch.

The simulator's input is a window of T frames: ``positions [T, N, 3]`` and
``temperatures [T, N, 1]``. Positions are wrapped into the periodic box;
velocities are minimum-image finite differences over dt; a particle's node
features are its T - 1 velocities, normalized, then its T temperatures,
normalized. Training adds a random walk to the window (zero at the first
frame), shifts the targets by the walk's last frame, and predicts the
normalized acceleration and temperature rate that reach the target frame.
"""

from __future__ import annotations

import math

import torch


def min_image(d: torch.Tensor, box: float) -> torch.Tensor:
    return d - box * torch.round(d / box)


def node_features(pos: torch.Tensor, temp: torch.Tensor, stats: dict):
    """``(wrapped [T, N, 3], velocities [T - 1, N, 3], nodes [N, F])`` of a
    window; the feature order is velocity frame by frame, xyz inside, then
    temperature frame by frame."""
    box, dt = stats["box_size"], stats["dt"]
    wrapped = torch.remainder(pos, box)
    vel = min_image(wrapped[1:] - wrapped[:-1], box) / dt
    n = pos.shape[1]
    v = ((vel - stats["vel_mean"]) / stats["vel_std"]).permute(1, 0, 2).reshape(n, -1)
    t = ((temp - stats["temp_mean"]) / stats["temp_std"]).permute(1, 0, 2).reshape(n, -1)
    return wrapped, vel, torch.cat([v, t], dim=1)


def random_walk(normals: torch.Tensor, scale, dt: float) -> torch.Tensor:
    """``[N, T - 1, D]`` standard normals to a ``[N, T, D]`` walk: scaled by
    ``scale / sqrt(T - 1)``, summed twice over time (velocity, then
    position times dt), a zero frame first."""
    steps = normals.shape[1]
    walk = torch.cumsum(normals * (scale / math.sqrt(steps)), dim=1)
    walk = torch.cumsum(walk, dim=1) * dt
    return torch.cat([torch.zeros_like(walk[:, :1]), walk], dim=1)


def training_example(window: dict, draws: dict, stats: dict, noise_std: float):
    """One noised training example: ``(wrapped last frame [N, 3], nodes,
    target acceleration [N, 3], target temperature rate [N, 1])``, all
    normalized. ``window`` holds ``positions [T, N, 3]``, ``temperatures
    [T, N, 1]``, ``target_positions [N, 3]``, ``target_temperatures [N, 1]``;
    ``draws`` the axis permutation ``perm`` (3 ints) and the normals
    ``position [N, T - 1, 3]`` and ``temperature [N, T - 1, 1]``."""
    box, dt = stats["box_size"], stats["dt"]
    perm = draws["perm"]
    pos = window["positions"][..., perm]
    target = window["target_positions"][..., perm]
    pos_noise = random_walk(draws["position"], noise_std, dt).transpose(0, 1)
    temp_noise = random_walk(draws["temperature"], noise_std * stats["temp_rate_std"],
                             dt).transpose(0, 1)
    wrapped, vel, nodes = node_features(pos + pos_noise, window["temperatures"] + temp_noise,
                                        stats)
    next_vel = min_image(target + pos_noise[-1] - wrapped[-1], box) / dt
    acc = ((next_vel - vel[-1]) / dt - stats["acc_mean"]) / stats["acc_std"]
    temps = window["temperatures"] + temp_noise
    rate = (window["target_temperatures"] + temp_noise[-1] - temps[-1]) / dt
    rate = (rate - stats["temp_rate_mean"]) / stats["temp_rate_std"]
    return wrapped[-1], nodes, acc, rate
