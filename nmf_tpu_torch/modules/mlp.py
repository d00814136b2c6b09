"""Plain ReLU MLP (``nmf_tpu/modules/mlp.py``).

Layers are ``nn.Linear``s (weight (out, in)); nmf_tpu keeps ``{"w": (in,
out), "b"}`` dicts, and ``weights.from_jax_state_dict`` transposes between
the two. Initial values come from an explicit ``torch.Generator``, from the
distributions of nmf_tpu's initializers: the default draws weights and
biases from U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (``nn.Linear``'s default);
``kaiming`` (bound sqrt(6 / fan_in)), ``xavier`` (sqrt(2) sqrt(6 / (fan_in +
fan_out))) and ``xavier_sigmoid`` (sqrt(6 / (fan_in + fan_out))) draw
uniform weights and zero biases. ``bias=False`` drops the final layer's
bias (nmf_tpu's ``create_mlp(bias=False)``; its state dict then has no
``['b']`` key for that layer).
"""
import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def _weight_bound(initializer, fan_in, fan_out):
    if initializer == "kaiming":
        return math.sqrt(6.0 / fan_in)
    if initializer == "xavier":
        return math.sqrt(2.0) * math.sqrt(6.0 / (fan_in + fan_out))
    if initializer == "xavier_sigmoid":
        return math.sqrt(6.0 / (fan_in + fan_out))
    return None


class MLP(nn.Module):
    def __init__(self, input_w, output_w, num_layers, hidden_w=128,
                 generator=None, initializer=None, bias=True):
        super().__init__()
        if num_layers < 1:
            raise ValueError("MLP needs at least one layer")
        widths = ([input_w] + [hidden_w] * (num_layers - 1) + [output_w])
        last = len(widths) - 2
        self.layers = nn.ModuleList(
            nn.Linear(widths[i], widths[i + 1], bias=bias or i < last)
            for i in range(len(widths) - 1))
        for layer in self.layers:
            bound = _weight_bound(initializer, layer.in_features,
                                  layer.out_features)
            default = bound is None
            if default:
                bound = 1.0 / math.sqrt(layer.in_features)
            nn.init.uniform_(layer.weight, -bound, bound, generator=generator)
            if layer.bias is None:
                continue
            if default:
                nn.init.uniform_(layer.bias, -bound, bound,
                                 generator=generator)
            else:
                nn.init.zeros_(layer.bias)

    def forward(self, x):
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < n - 1:
                x = F.relu(x)
        return x


@torch.no_grad()
def scale_final_layer(mlp: MLP, uniform_range: float, generator=None):
    """Redraw the final layer's weight from U(-uniform_range,
    uniform_range) (nmf_tpu's ``scale_final_layer(uniform_range=...)``, the
    near-zero start of the normal network)."""
    nn.init.uniform_(mlp.layers[-1].weight, -uniform_range, uniform_range,
                     generator=generator)
    return mlp
