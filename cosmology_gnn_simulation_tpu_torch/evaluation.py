"""Evaluation (counterpart of ``evaluation.py``): the one-step
integrated-space MSE, rollout error metrics and summary, and the rollout ->
HDF5 conversion.

* ``validate_one_step``: the error is measured in integrated position /
  temperature space (after the Euler update), over start indices drawn by
  numpy's ``default_rng(seed).choice`` exactly as the JAX package draws
  them, so both test the same timesteps; each window goes through the
  port's ``one_step_prediction`` (its aggregation and device surface) and
  its MSEs are taken in numpy, as in JAX.
* ``calculate_rollout_errors`` / ``write_rollout_summary``: per-step MSE
  against the ground truth and the ``rollout_summary.txt`` artifact.
* ``convert_rollout_to_hdf5``: rebuild ``Velocities`` by minimum-image
  finite differences (float32, on the CPU, as ``jnp`` computes them) and
  ``HydroAcceleration`` by differencing velocities, into a rollout file
  that is itself a valid dataset.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import (
    EncodeProcessDecodeConfig,
)
from cosmology_gnn_simulation_tpu_torch.ops.cell_list import f32
from cosmology_gnn_simulation_tpu_torch.ops.periodic import min_image_displacement
from cosmology_gnn_simulation_tpu_torch.rollout import one_step_prediction
from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats


def validate_one_step(
    params,
    model_config: EncodeProcessDecodeConfig,
    data: Dict[str, np.ndarray],
    stats: NormalizationStats,
    window_size: int,
    *,
    num_neighbors: int = 16,
    num_timesteps: int = 10,
    seed: Optional[int] = 0,
    dtype: Optional[torch.dtype] = None,
    neighbor_method: str = "auto",
    aggregation: str = "auto",
    cellblock_variable: bool = False,
    device="cuda",
) -> Dict:
    """One-step position/temperature MSE over sampled start indices.

    ``data`` holds ``Coordinates [T, N, 3]`` and ``InternalEnergy`` (``[T,
    N]`` or ``[T, N, 1]``). ``num_timesteps`` start indices are drawn without
    replacement from ``range(T - window_size - 1)`` by
    ``np.random.default_rng(seed)`` (``seed=None``: numpy's global
    generator). ``dtype``, ``neighbor_method``, ``aggregation`` (``"auto"`` /
    ``"gather"`` or ``"cellblock_hybrid"``) and ``device`` are
    ``one_step_prediction``'s. Returns the mean errors, the per-window
    errors and the tested (predicted) timesteps."""
    coords = np.asarray(data["Coordinates"], dtype=np.float32)
    temps = np.asarray(data["InternalEnergy"], dtype=np.float32)
    if temps.ndim == 2:
        temps = temps[..., None]
    total_frames = coords.shape[0]
    # The reference's bound, which skips the final valid start index.
    max_start_idx = total_frames - window_size - 1
    if max_start_idx < num_timesteps:
        num_timesteps = max_start_idx
    if num_timesteps < 1:
        raise ValueError(
            f"No testable timesteps: trajectory has {total_frames} frames, "
            f"window_size={window_size} needs at least {window_size + 2}."
        )
    rng = np.random.default_rng(seed) if seed is not None else np.random
    start_indices = sorted(
        rng.choice(max_start_idx, size=num_timesteps, replace=False).tolist()
    )

    position_errors, temperature_errors, tested = [], [], []
    for start in start_indices:
        new_pos, new_temp = one_step_prediction(
            params, model_config,
            coords[start: start + window_size], temps[start: start + window_size], stats,
            num_neighbors=num_neighbors, dtype=dtype, neighbor_method=neighbor_method,
            aggregation=aggregation, cellblock_variable=cellblock_variable, device=device,
        )
        next_pos = coords[start + window_size]
        next_temp = temps[start + window_size]
        position_errors.append(float(np.mean((new_pos.cpu().numpy() - next_pos) ** 2)))
        temperature_errors.append(float(np.mean((new_temp.cpu().numpy() - next_temp) ** 2)))
        tested.append(start + window_size)

    return {
        "position_error": float(np.mean(position_errors)),
        "temperature_error": float(np.mean(temperature_errors)),
        "position_errors": position_errors,
        "temperature_errors": temperature_errors,
        "tested_timesteps": tested,
    }


def calculate_rollout_errors(
    rollout_data: Dict[str, np.ndarray], ground_truth: Dict[str, np.ndarray]
) -> Dict:
    """Per-timestep MSE of the rollout against the ground truth, over the
    frames both have, and their means."""
    pred_coords = np.asarray(rollout_data["Coordinates"])
    true_coords = np.asarray(ground_truth["Coordinates"])
    t = min(len(pred_coords), len(true_coords))
    pos_errors = [
        float(np.mean((pred_coords[i] - true_coords[i]) ** 2)) for i in range(t)
    ]
    pred_temps = np.squeeze(np.asarray(rollout_data["InternalEnergy"]))
    true_temps = np.squeeze(np.asarray(ground_truth["InternalEnergy"]))
    tt = min(len(pred_temps), len(true_temps))
    temp_errors = [
        float(np.mean((pred_temps[i] - true_temps[i]) ** 2)) for i in range(tt)
    ]
    return {
        "position_errors": pos_errors,
        "temperature_errors": temp_errors,
        "mean_position_error": float(np.mean(pos_errors)) if pos_errors else None,
        "mean_temperature_error": (
            float(np.mean(temp_errors)) if temp_errors else None
        ),
    }


def write_rollout_summary(
    path: str,
    errors: Dict,
    *,
    model_path: str,
    test_data: str,
    num_particles: int,
    window_size: int,
    num_steps: int,
    dt: float,
    box_size: float,
) -> None:
    """Write the ``rollout_summary.txt`` artifact."""
    with open(path, "w") as f:
        f.write("Rollout Summary\n==============\n\n")
        f.write(f"Model: {model_path}\n")
        f.write(f"Test data: {test_data}\n")
        f.write(f"Number of particles: {num_particles}\n")
        f.write(f"Window size: {window_size}\n")
        f.write(f"Time steps simulated: {num_steps}\n")
        f.write(f"Time step (dt): {dt}\n")
        f.write(f"Box size: {box_size}\n\n")
        if errors.get("mean_position_error") is not None:
            f.write(f"Mean position MSE: {errors['mean_position_error']:.6e}\n")
        if errors.get("mean_temperature_error") is not None:
            f.write(
                f"Mean temperature MSE: {errors['mean_temperature_error']:.6e}\n"
            )


def convert_rollout_to_hdf5(
    rollout_dir: str,
    original_data: Dict[str, np.ndarray],
    box_size: float,
    dt: float,
    output_path: str,
    window_size: int = 5,
) -> Dict[str, np.ndarray]:
    """Rebuild the full 6-field schema from a rollout directory's
    ``rollout_coordinates.npy`` and ``rollout_temperatures.npy`` and write
    it to ``output_path``; returns the fields. The first frame's velocity
    is the original data's at ``window_size - 1``."""
    from cosmology_gnn_simulation_tpu_torch.data.hdf5 import write_simulation

    coords = np.load(os.path.join(rollout_dir, "rollout_coordinates.npy"))
    temps = np.load(os.path.join(rollout_dir, "rollout_temperatures.npy"))

    orig_coords = np.asarray(original_data["Coordinates"])
    if coords.shape[1:] != orig_coords.shape[1:]:
        raise ValueError(
            f"Particle dimension mismatch: rollout {coords.shape[1:]} vs "
            f"original {orig_coords.shape[1:]}"
        )

    velocities = np.zeros_like(coords)
    step = torch.from_numpy(np.asarray(coords[1:] - coords[:-1], dtype=np.float32))
    displacement = min_image_displacement(step, f32(box_size, "cpu")).numpy()
    velocities[1:] = displacement / dt
    if window_size > 1:
        velocities[0] = np.asarray(original_data["Velocities"])[window_size - 1]
    else:
        velocities[0] = displacement[0] / dt

    accelerations = np.zeros_like(coords)
    accelerations[1:] = (velocities[1:] - velocities[:-1]) / dt
    accelerations[0] = accelerations[1]

    out = {
        "Coordinates": coords.astype(np.float32),
        "InternalEnergy": temps.astype(np.float32),
        "Velocities": velocities.astype(np.float32),
        "HydroAcceleration": accelerations.astype(np.float32),
        "BoxSize": box_size,
        "TimeStep": dt,
    }
    write_simulation(output_path, out)
    return out
