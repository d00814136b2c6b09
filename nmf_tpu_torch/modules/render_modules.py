"""Appearance heads (``nmf_tpu/modules/render_modules.py``): the subset of
the tensorf slice, ``PE`` and ``MLPRenderFea``."""
import torch
import torch.nn as nn

from ..ops.safemath import positional_encoding
from .mlp import MLP


class PE(nn.Module):
    """Positional encoding of the last axis (no parameters)."""

    def __init__(self, max_degree=8, in_dim=3):
        super().__init__()
        self.max_degree = max_degree
        self.in_dim = in_dim

    def dim(self):
        return 2 * self.in_dim * self.max_degree

    def forward(self, x, roughness=None):
        return positional_encoding(x, self.max_degree)


class MLPRenderFea(nn.Module):
    """View-dependent colour head (MLPRender_Fea): sigmoid of a 3-layer MLP
    of [features, viewdirs, PE(features), PE(viewdirs)]; the last bias
    starts at zero."""

    def __init__(self, in_channels, viewpe=6, feape=6, featureC=128,
                 lr=1e-3, generator=None):
        super().__init__()
        self.viewpe = viewpe
        self.feape = feape
        self.lr = float(lr)
        in_mlpC = 2 * viewpe * 3 + 2 * feape * in_channels + 3 + in_channels
        self.mlp = MLP(in_mlpC, 3, num_layers=3, hidden_w=featureC,
                       generator=generator)
        nn.init.zeros_(self.mlp.layers[-1].bias)

    def forward(self, pts, viewdirs, features):
        indata = [features, viewdirs]
        if self.feape > 0:
            indata.append(positional_encoding(features, self.feape))
        if self.viewpe > 0:
            indata.append(positional_encoding(viewdirs, self.viewpe))
        return torch.sigmoid(self.mlp(torch.cat(indata, dim=-1)))
