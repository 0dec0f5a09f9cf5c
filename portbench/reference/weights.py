"""The benchmark's own seeded weights, in the port's parameter layout.

A layer is ``{"w": [in, out], "b": [out]}``, an MLP ``{"layers": (layer,
...), "ln": {"scale", "bias"}?}``, and the model ``{"encoder": {"node",
"edge"}, "processor": {"edge", "node"} stacked on a leading [M] axis,
"decoder_acc", "decoder_temp_rate"}``. Every weight and bias is uniform in
``[-1/sqrt(fan_in), 1/sqrt(fan_in))`` (``torch.nn.Linear``'s rule), drawn
in one call from a generator on ``device`` seeded with ``seed``; LayerNorm
scales are 1 and biases 0. The same tensors go to the program and to the
reference, so neither derives weights of its own.
"""

from __future__ import annotations

import math

import torch


def _mlp_shapes(in_dim, hidden, n_hidden, out_dim):
    dims = [in_dim] + [hidden] * n_hidden + [out_dim]
    return [(dims[i], dims[i + 1]) for i in range(len(dims) - 1)]


def _layout(cfg):
    """``[(path, (in, out), stacked, layer_norm)]``: each MLP of the model."""
    lat, hid, nh = cfg["latent_size"], cfg["mlp_hidden_size"], cfg["mlp_num_hidden_layers"]
    return [
        (("encoder", "node"), _mlp_shapes(cfg["node_input_size"], hid, nh, lat), 0, True),
        (("encoder", "edge"), _mlp_shapes(cfg["edge_input_size"], hid, nh, lat), 0, True),
        (("processor", "edge"), _mlp_shapes(3 * lat, hid, nh, lat),
         cfg["num_message_passing_steps"], True),
        (("processor", "node"), _mlp_shapes(2 * lat, hid, nh, lat),
         cfg["num_message_passing_steps"], True),
        (("decoder_acc",), _mlp_shapes(lat, hid, nh, cfg["output_size"]), 0, False),
        (("decoder_temp_rate",), _mlp_shapes(lat, hid, nh, 1), 0, False),
    ]


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The model's float32 parameters for configuration ``cfg`` from
    ``seed``, made on ``device`` in one uniform draw."""
    layout = _layout(cfg)
    sizes = []
    for _, shapes, stack, _ in layout:
        for fan_in, fan_out in shapes:
            sizes.append(max(stack, 1) * (fan_in * fan_out + fan_out))
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    draw = torch.rand(sum(sizes), generator=gen, device=device).mul_(2.0).sub_(1.0)
    params, offset = {}, 0
    for path, shapes, stack, ln in layout:
        lead = (stack,) if stack else ()
        layers = []
        for fan_in, fan_out in shapes:
            bound = 1.0 / math.sqrt(fan_in)
            n_w, n_b = fan_in * fan_out, fan_out
            block = draw[offset:offset + max(stack, 1) * (n_w + n_b)].view(max(stack, 1), -1)
            offset += block.numel()
            w = (block[:, :n_w] * bound).reshape(*lead, fan_in, fan_out).contiguous()
            b = (block[:, n_w:] * bound).reshape(*lead, fan_out).contiguous()
            layers.append({"w": w, "b": b})
        mlp = {"layers": tuple(layers)}
        if ln:
            out = shapes[-1][1]
            mlp["ln"] = {"scale": torch.ones(*lead, out, device=device),
                         "bias": torch.zeros(*lead, out, device=device)}
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = mlp
    return params


def leaves(tree) -> list:
    """The tree's tensors in key order (dicts by insertion, tuples by index)."""
    if isinstance(tree, dict):
        return [leaf for key in tree for leaf in leaves(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in leaves(item)]
    return [tree]


def clone(tree):
    """A deep copy of the tree's tensors (detached)."""
    if isinstance(tree, dict):
        return {key: clone(value) for key, value in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(clone(item) for item in tree)
    return tree.detach().clone()
