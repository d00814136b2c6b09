"""Plain ReLU MLP (``nmf_tpu/modules/mlp.py``).

Layers are ``nn.Linear``s (weight (out, in)); nmf_tpu keeps ``{"w": (in,
out), "b"}`` dicts, and ``weights.from_jax_state_dict`` transposes between
the two. Weights and biases are drawn from U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the
distribution of ``nn.Linear``'s default init and of nmf_tpu's default
initializer, from an explicit ``torch.Generator``.
"""
import math

import torch.nn as nn
import torch.nn.functional as F


class MLP(nn.Module):
    def __init__(self, input_w, output_w, num_layers, hidden_w=128,
                 generator=None):
        super().__init__()
        if num_layers < 1:
            raise ValueError("MLP needs at least one layer")
        widths = ([input_w] + [hidden_w] * (num_layers - 1) + [output_w])
        self.layers = nn.ModuleList(
            nn.Linear(widths[i], widths[i + 1])
            for i in range(len(widths) - 1))
        for layer in self.layers:
            bound = 1.0 / math.sqrt(layer.in_features)
            nn.init.uniform_(layer.weight, -bound, bound, generator=generator)
            nn.init.uniform_(layer.bias, -bound, bound, generator=generator)

    def forward(self, x):
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < n - 1:
                x = F.relu(x)
        return x
