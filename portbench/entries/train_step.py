"""Steps of the step function ``training.make_train_step`` returns: a
training job of batch 1.

Each step takes the next host (numpy) batch of the pool, which the step
uploads itself, and draws its augmentation and noise from one generator on
the card. Metrics stay on the device until the end of the window, which
reads them once, as ``Trainer.fit`` reads them once an epoch: a step with a
non-finite loss or a cell-block violation has failed.

Set-up builds the step, its parameters and its optimizer state once and
drives them through the first ``checked_steps`` steps on distinct batches
of the pool, through the same call and feed; the window then continues
with that same object. The comparison follows those first steps with the
plain reference: each step's loss, the first gradient as Adam received it
(from its first moment after one step), and each parameter's change over
the checked steps.
"""

from __future__ import annotations

import statistics

import torch

from portbench import system
from portbench.reference import featurize, train, weights
from portbench.traffic import frames

NUMBERS = ("loss", "first_gradient", "update")
# The xyz permutations in the order the augmentation's draw indexes them.
AXIS_PERMS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))
# Leaves whose reference gradient is below this share of the median leaf's
# move under Adam by rounding alone; they are left out of the leaf numbers.
STILL_LEAF = 1e-3


class Entry:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from cosmology_gnn_simulation_tpu_torch.training import (
            TrainConfig,
            make_optimizer,
            make_train_step,
        )
        self.cfg, self.mix, self.device = cfg, mix, device
        self.n, self.k = cfg["num_particles"], cfg["num_neighbors"]
        self.work_per_request = 1
        self.steps_per_request = 1
        opts = mix["train"]
        self.tc = TrainConfig(num_neighbors=self.k, batch_size=1, window_size=cfg["window"],
                              noise_std=opts["noise_std"], augment_prob=opts["augment_prob"],
                              learning_rate=opts["learning_rate"],
                              final_learning_rate=opts["learning_rate"],
                              compute_dtype=cfg["compute_dtype"],
                              fused_tail=opts["fused_tail"], **mix["route"])
        self.batches = [frames.train_window(self.n, mix, s)
                        for s in frames.pool_seeds(seed, mix["pool"])]
        self.weights = weights.make_weights(cfg, seed, device)
        self.initial = weights.clone(self.weights)
        self.stats = system.stats(cfg, device)
        optimizer = make_optimizer(self.tc, steps_per_epoch=2**30)
        self.opt_state = optimizer.init(self.weights)
        self.step = make_train_step(system.model_config(cfg, mix), self.stats, self.tc,
                                    optimizer)
        self.generator = torch.Generator(device=device).manual_seed(seed % 2**63)
        self.plan = system.plan_shapes(cfg, mix)
        self.metrics = []
        self._next = 0

    def _feed(self):
        batch = self.batches[self._next % len(self.batches)]
        self._next += 1
        return batch

    def warm_up(self):
        """The checked steps: each one's generator state and loss, the first
        moment after the first, the parameters after the last."""
        self.states, self.losses = [], []
        for t in range(self.mix["checked_steps"]):
            self.states.append(self.generator.get_state())
            _, _, m = self.step(self.weights, self.opt_state, self._feed(), self.generator)
            self.losses.append(float(m["loss"]))
            if t == 0:
                adam = self.opt_state.optimizer
                beta1 = adam.param_groups[0]["betas"][0]
                # A leaf Adam never stepped has no moment: its gradient reads 0.
                self.first_grads = [adam.state[p]["exp_avg"].detach() / (1 - beta1)
                                    if "exp_avg" in adam.state[p] else torch.zeros_like(p)
                                    for p in adam.param_groups[0]["params"]]
        self.checked = weights.clone(self.weights)
        self.begin()

    def begin(self):
        self.metrics = []

    def request(self, i):
        _, _, m = self.step(self.weights, self.opt_state, self._feed(), self.generator)
        self.metrics.append(torch.stack([m["loss"], m.get("cellblock_violations",
                                                          torch.zeros_like(m["loss"]))]))

    def settle(self):
        if not self.metrics:
            return []
        values = torch.stack(self.metrics).tolist()
        return [bool(loss == loss and abs(loss) != float("inf")) and viol == 0
                for loss, viol in values]

    def release(self):
        del self.step, self.opt_state
        self.weights = None
        torch.cuda.empty_cache()

    def _reference(self, low):
        """The reference's losses, first gradient and parameters after the
        checked steps, from the initial weights and the same draws."""
        stats = dict(self.cfg["metadata"])
        params = weights.clone(self.initial)
        adam = train.Adam(params, self.tc.learning_rate)
        losses, first = [], None
        frames_ = self.cfg["window"]
        for t, state in enumerate(self.states):
            batch = self.batches[t % len(self.batches)]
            window = {key: torch.from_numpy(value[0]).to(self.device)
                      for key, value in batch.items()}
            gen = torch.Generator(device=self.device)
            gen.set_state(state)
            example = featurize.training_example(
                window, draws(gen, self.n, frames_, self.tc.augment_prob, self.device), stats,
                self.tc.noise_std)
            loss, grads = train.loss_and_grads(params, example, self.k, stats, low)
            losses.append(loss)
            first = grads if first is None else first
            adam.step(grads)
        return losses, first, weights.leaves(params)

    def compare(self, low=None):
        """The program's numbers against the float32 reference and, with
        ``low``, the same numbers of the reference computed in ``low``.

        Each number is a gap to the float32 reference, in units of the same
        gap of the reference computed with the configuration's own operand
        precision (bf16): the largest relative loss gap over the checked
        steps, the worst leaf's gap between first-gradient norms, and the
        worst leaf's gap between the norms of the parameters' change over
        the checked steps, a leaf's gap measured against the larger of the
        reference's norm of that leaf and of the median leaf. A seed's
        random weights set how much rounding grows through the network for
        every precision alike; the unit takes that out. ``raw`` holds the
        gaps themselves."""
        initial = weights.leaves(self.initial)
        ref_losses, ref_grads, ref_params = self._reference(None)
        sides = {"program": (self.losses, self.first_grads, weights.leaves(self.checked)),
                 "stated": self._reference(getattr(torch, self.cfg["compute_dtype"]))}
        if low is not None:
            sides["control"] = self._reference(low)
        grad_norms = [float(g.norm()) for g in ref_grads]
        median = statistics.median(grad_norms)
        moving = [i for i, g in enumerate(grad_norms) if g >= STILL_LEAF * median]
        ref_updates = [float((ref_params[i] - initial[i]).norm()) for i in moving]
        ref_gnorms = [grad_norms[i] for i in moving]
        raw = {}
        for side, (losses, grads, params) in sides.items():
            loss = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
            grad = _worst_leaf([float(grads[i].norm()) for i in moving], ref_gnorms)
            update = _worst_leaf([float((params[i] - initial[i]).norm()) for i in moving],
                                 ref_updates)
            raw[side] = dict(zip(NUMBERS, (loss, grad, update)))
        out = {side: {name: value / max(raw["stated"][name], 1e-30)
                      for name, value in raw[side].items()}
               for side in sides if side != "stated"}
        out["raw"] = raw
        out["note"] = (f"{len(self.states)} checked steps, {len(moving)} of {len(grad_norms)} "
                       f"leaves compared (the rest have a reference gradient under "
                       f"{STILL_LEAF} of the median leaf's); bf16 reference's gaps "
                       + ", ".join(f"{k} {v:.4g}" for k, v in raw["stated"].items()))
        return out


def _worst_leaf(got, ref):
    """The largest gap between two norms of a leaf, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    median = statistics.median(ref)
    return max(abs(a - b) / max(b, median) for a, b in zip(got, ref))


def draws(gen: torch.Generator, n: int, frames_: int, augment_prob: float, device) -> dict:
    """One sample's random inputs, in the order the train step draws them
    from its generator: the permutation's index and a uniform number, then
    the position normals, then the temperature normals."""
    index = torch.randint(0, 6, (1,), generator=gen, device=gen.device)
    u = torch.rand((1,), generator=gen, device=gen.device)
    perm = list(AXIS_PERMS[int(index)]) if float(u) < augment_prob else [0, 1, 2]
    position = torch.randn((n, frames_ - 1, 3), generator=gen, device=gen.device)
    temperature = torch.randn((n, frames_ - 1, 1), generator=gen, device=gen.device)
    return {"perm": perm, "position": position.to(device), "temperature": temperature.to(device)}
