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
``['b']`` key for that layer). ``skip`` builds nmf_tpu's skip-connection
variant: ``layers`` (``skip`` layers, input to hidden, ReLU after the last)
and ``skip_layers`` (the rest, from the input concatenated with that).

``compute_dtype="bf16"`` (``model.arch.mlp_dtype``) rounds each product's
operands, the layer input and the weight, to bfloat16 and multiplies them
in f32: nmf_tpu's bf16 dot with an f32 result. Bias and ReLU stay f32 and
the parameters f32. Autograd through the two casts rounds the input's and
the weight's gradients to bfloat16, as the transpose of nmf_tpu's cast
does. The product of two bf16 values is exact in f32, so the upcast form
is what a bf16 GEMM with f32 accumulation and an f32 result computes.
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


def _make_layers(input_w, output_w, num_layers, hidden_w, generator,
                 initializer, bias):
    widths = ([input_w] + [hidden_w] * (num_layers - 1) + [output_w])
    last = len(widths) - 2
    layers = nn.ModuleList(
        nn.Linear(widths[i], widths[i + 1], bias=bias or i < last)
        for i in range(len(widths) - 1))
    for layer in layers:
        bound = _weight_bound(initializer, layer.in_features,
                              layer.out_features)
        default = bound is None
        if default:
            bound = 1.0 / math.sqrt(layer.in_features)
        nn.init.uniform_(layer.weight, -bound, bound, generator=generator)
        if layer.bias is None:
            continue
        if default:
            nn.init.uniform_(layer.bias, -bound, bound, generator=generator)
        else:
            nn.init.zeros_(layer.bias)
    return layers


def bf16_round(t):
    """``t`` rounded to bfloat16 and back to f32, with autograd."""
    return t.to(torch.bfloat16).to(torch.float32)


class MLP(nn.Module):
    def __init__(self, input_w, output_w, num_layers, hidden_w=128,
                 generator=None, initializer=None, bias=True, skip=None):
        super().__init__()
        if num_layers < 1 or (skip is not None
                              and not 0 < skip < num_layers):
            raise ValueError("MLP needs at least one layer on each side of "
                             "its skip connection")
        self.compute_dtype = "f32"
        self.skip_layers = None
        if skip is None:
            self.layers = _make_layers(input_w, output_w, num_layers,
                                       hidden_w, generator, initializer, bias)
            return
        self.layers = _make_layers(input_w, hidden_w, skip, hidden_w,
                                   generator, initializer, True)
        self.skip_layers = _make_layers(input_w + hidden_w, output_w,
                                        num_layers - skip, hidden_w,
                                        generator, initializer, bias)

    def _run(self, layers, x):
        bf16 = self.compute_dtype == "bf16"
        n = len(layers)
        for i, layer in enumerate(layers):
            if bf16:
                x = F.linear(bf16_round(x), bf16_round(layer.weight),
                             layer.bias)
            else:
                x = layer(x)
            if i < n - 1:
                x = F.relu(x)
        return x

    def forward(self, x):
        h = self._run(self.layers, x)
        if self.skip_layers is None:
            return h
        return self._run(self.skip_layers,
                           torch.cat([x, F.relu(h)], dim=-1))


def set_mlp_dtype(module, dtype: str):
    """Set the compute dtype ("f32" or "bf16") of every MLP in
    ``module``."""
    if dtype not in ("f32", "bf16"):
        raise ValueError(f"mlp_dtype must be f32 or bf16, got {dtype!r}")
    for m in module.modules():
        if isinstance(m, MLP):
            m.compute_dtype = dtype
    return module


@torch.no_grad()
def scale_final_layer(mlp: MLP, uniform_range: float, generator=None):
    """Redraw the final layer's weight from U(-uniform_range,
    uniform_range) (nmf_tpu's ``scale_final_layer(uniform_range=...)``, the
    near-zero start of the normal network)."""
    last = (mlp.layers if mlp.skip_layers is None else mlp.skip_layers)[-1]
    nn.init.uniform_(last.weight, -uniform_range, uniform_range,
                     generator=generator)
    return mlp
