"""The training step, plain PyTorch: loss, gradients and Adam.

Loss: the mean squared error of the normalized acceleration plus that of
the normalized temperature rate (the momentum term's weight is 0 in every
cell). Adam: betas 0.9 / 0.999, eps 1e-8 outside the square root, bias
corrections, no weight decay, a constant learning rate.
"""

from __future__ import annotations

import torch

from portbench.reference import knn, model, weights


def loss_and_grads(params, example, k: int, stats: dict, low=None, checkpoint=True):
    """``(loss, gradients in leaf order)`` of one training example (the
    output of ``featurize.training_example``)."""
    last, nodes, acc, rate = example
    neighbors, _ = knn.knn(last, k, stats["box_size"])
    leaves = [t.requires_grad_(True) for t in weights.leaves(params)]
    pred_acc, pred_rate = model.forward(params, nodes, neighbors, low, checkpoint=checkpoint)
    loss = ((pred_acc - acc) ** 2).mean() + ((pred_rate - rate) ** 2).mean()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for t in leaves:
        t.requires_grad_(False)
    grads = [torch.zeros_like(t) if g is None else g.detach() for t, g in zip(leaves, grads)]
    return float(loss.detach()), grads


class Adam:
    def __init__(self, params, lr: float, b1=0.9, b2=0.999, eps=1e-8):
        self.leaves = weights.leaves(params)
        self.lr, self.b1, self.b2, self.eps, self.t = lr, b1, b2, eps, 0
        self.m = [torch.zeros_like(p) for p in self.leaves]
        self.v = [torch.zeros_like(p) for p in self.leaves]

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.leaves, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))
