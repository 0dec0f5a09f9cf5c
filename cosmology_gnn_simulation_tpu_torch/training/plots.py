"""Loss plots (counterpart of ``training/plots.py``): the five-panel
training dashboard (combined train/val loss, the acceleration,
temperature-rate and momentum losses, and the LR schedule, all log-scale)
and the rollout error plot. ``matplotlib`` is imported inside the
functions, so importing this module does not need it."""

from __future__ import annotations

from typing import Dict, List


def plot_losses(
    train_losses: List[float],
    val_losses: List[float],
    output_path: str,
    component_losses: Dict[str, List[float]],
    learning_rates: List[float],
) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(16, 14))
    gs = plt.GridSpec(3, 2, figure=fig, height_ratios=[2, 1, 1])
    ax1 = fig.add_subplot(gs[0, :])
    ax_acc = fig.add_subplot(gs[1, 0])
    ax_temp = fig.add_subplot(gs[1, 1])
    ax_mom = fig.add_subplot(gs[2, 0])
    ax_lr = fig.add_subplot(gs[2, 1])

    epochs = range(1, len(train_losses) + 1)
    ax1.plot(epochs, train_losses, "b-", linewidth=2, label="Training Loss")
    ax1.plot(epochs, val_losses, "r-", linewidth=2, label="Validation Loss")
    ax1.set_title("Training and Validation Loss per Epoch")
    ax1.set_yscale("log")
    ax1.grid(True, linestyle="--", alpha=0.7)
    ax1.legend()

    panels = [
        (ax_acc, "Acceleration Loss", "acc_train", "acc_val"),
        (ax_temp, "Temperature_Rate Loss", "temp_rate_train", "temp_rate_val"),
        (ax_mom, "Momentum Conservation Loss (PINN)", "momentum_train",
         "momentum_val"),
    ]
    for ax, title, train_key, val_key in panels:
        ax.plot(epochs, component_losses[train_key], "b-", label="Train")
        ax.plot(epochs, component_losses[val_key], "r-", label="Validation")
        ax.set_title(title)
        ax.set_xlabel("Epoch")
        ax.set_yscale("log")
        ax.grid(True, linestyle="--", alpha=0.7)
        ax.legend()

    ax_lr.plot(epochs, learning_rates, "g-", linewidth=3, label="Learning Rate")
    ax_lr.set_title("Learning Rate Schedule (Exponential Decay)")
    ax_lr.set_yscale("log")
    ax_lr.grid(True, linestyle="--", alpha=0.7)
    ax_lr.legend()
    # Initial and current LR text boxes.
    if learning_rates:
        ax_lr.text(
            0.02, 0.95, f"Initial LR: {learning_rates[0]:.2e}",
            transform=ax_lr.transAxes, verticalalignment="top",
            bbox=dict(boxstyle="round", facecolor="lightblue", alpha=0.7),
        )
    if len(learning_rates) > 1:
        ax_lr.text(
            0.02, 0.05, f"Current LR: {learning_rates[-1]:.2e}",
            transform=ax_lr.transAxes, verticalalignment="bottom",
            bbox=dict(boxstyle="round", facecolor="lightgreen", alpha=0.7),
        )

    plt.tight_layout()
    plt.savefig(output_path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def plot_rollout_errors(
    errors: Dict[str, List[float]],
    output_path: str,
    window_size: int,
    box_size: float = 1.0,
) -> None:
    """Rollout error plot with the uncorrelated-MSE reference line at
    box^2/6."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 6))
    ax.plot(errors["position_errors"], "b-", linewidth=2, label="Position MSE")
    ax.plot(
        errors["temperature_errors"], "r-", linewidth=2, label="Temperature MSE"
    )
    ax.set_title("Rollout Error")
    ax.set_xlabel("Timestep")
    ax.set_ylabel("Mean Squared Error")
    ax.axvline(
        x=window_size, color="g", linestyle="--", linewidth=2,
        label="Rollout Start",
    )
    ax.axhline(
        y=box_size**2 / 6, color="black", linestyle="--", linewidth=2,
        label="Uncorrelated Position MSE",
    )
    ax.grid(True, linestyle="--", alpha=0.7)
    ax.set_yscale("log")
    ax.legend()
    plt.tight_layout()
    plt.savefig(output_path)
    plt.close(fig)
