"""The pruned sender-latents Encode-Process-Decode model, plain PyTorch.

Encoder: an MLP with LayerNorm from the node features to the latent x.
Each of M message-passing steps (weights not shared): every particle sums
the latents of its k nearest particles (itself included), and the node MLP
with LayerNorm maps ``[x, sum]`` to a residual update of x. Decoders: two
MLPs without LayerNorm, to the normalized acceleration and temperature
rate. The edge stream of the full model never reaches these outputs under
sender-latent aggregation, so it is not computed. An MLP is
``num_hidden_layers`` x (Linear, ReLU), a final Linear, then LayerNorm
(biased variance, eps 1e-5) where it has one.

``low`` rounds every matmul operand to that dtype (float8 saturating at its
largest finite value; the gradient passes the rounding unchanged) and sums
in float32: the lower-precision control of
the benchmark's comparison. Without it everything is float32, with TF32
switched off by the caller.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

LN_EPS = 1e-5


def _round(t: torch.Tensor, low):
    if low is None:
        return t
    if low in (torch.float8_e4m3fn, torch.float8_e5m2):
        big = torch.finfo(low).max
        t = t.clamp(-big, big)
    # Rounded in the forward pass; the gradient passes straight through.
    return t + (t.to(low).float() - t).detach()


def linear(x, layer, low=None):
    return _round(x, low) @ _round(layer["w"], low) + layer["b"]


def layer_norm(x, ln):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * ln["scale"] + ln["bias"]


def mlp(params, x, low=None):
    layers = params["layers"]
    for layer in layers[:-1]:
        x = torch.relu(linear(x, layer, low))
    x = linear(x, layers[-1], low)
    return layer_norm(x, params["ln"]) if "ln" in params else x


def adjacency(neighbors: torch.Tensor) -> torch.Tensor:
    """The ``[N, N]`` sparse sum matrix: row i has a 1 at each of i's k
    neighbours."""
    n, k = neighbors.shape
    rows = torch.arange(n, device=neighbors.device).repeat_interleave(k)
    index = torch.stack([rows, neighbors.reshape(-1)])
    ones = torch.ones(n * k, device=neighbors.device)
    return torch.sparse_coo_tensor(index, ones, (n, n), check_invariants=False).coalesce()


def _step(x, adj, node, low):
    agg = torch.sparse.mm(adj, x)
    return x + mlp(node, torch.cat([x, agg], dim=1), low)


def forward(params, nodes, neighbors, low=None, checkpoint=False):
    """``(acceleration [N, 3], temperature rate [N, 1])``, normalized."""
    adj = adjacency(neighbors)
    x = mlp(params["encoder"]["node"], nodes, low)
    proc = params["processor"]["node"]
    steps = proc["layers"][0]["w"].shape[0]
    for m in range(steps):
        node = {"layers": tuple({"w": l["w"][m], "b": l["b"][m]} for l in proc["layers"]),
                "ln": {"scale": proc["ln"]["scale"][m], "bias": proc["ln"]["bias"][m]}}
        if checkpoint:
            x = torch.utils.checkpoint.checkpoint(_step, x, adj, node, low, use_reentrant=False)
        else:
            x = _step(x, adj, node, low)
    return mlp(params["decoder_acc"], x, low), mlp(params["decoder_temp_rate"], x, low)
