"""Appearance, material and normal heads
(``nmf_tpu/modules/render_modules.py``): ``PE``, ``MLPRenderFea`` and
``MLPRenderPE`` (tensorf), ``RandHydraMLPDiffuse`` (microfacet), and the predicted-normal
heads ``MLPNormal`` and ``AppDimNormal``."""
import math

import torch
import torch.nn as nn

from ..ops.safemath import (integrated_pos_enc, inv_sigmoid, normalize,
                            positional_encoding)
from .mlp import MLP, scale_final_layer


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


class MLPRenderPE(nn.Module):
    """View-dependent colour head of the sample position (MLPRender_PE):
    sigmoid of a 3-layer MLP of [features, viewdirs, position,
    PE(position), PE(viewdirs)]; the last bias starts at zero. nmf_tpu
    feeds the raw position that the reference sizes its MLP for but
    forgets to concatenate; so does the port."""

    def __init__(self, in_channels, viewpe=6, pospe=6, featureC=128,
                 lr=1e-3, generator=None):
        super().__init__()
        self.viewpe = viewpe
        self.pospe = pospe
        self.lr = float(lr)
        in_mlpC = (3 + 2 * viewpe * 3) + (3 + 2 * pospe * 3) + in_channels
        self.mlp = MLP(in_mlpC, 3, num_layers=3, hidden_w=featureC,
                       generator=generator)
        nn.init.zeros_(self.mlp.layers[-1].bias)

    def forward(self, pts, viewdirs, features):
        indata = [features, viewdirs, pts[..., :3]]
        if self.pospe > 0:
            indata.append(positional_encoding(pts[..., :3], self.pospe))
        if self.viewpe > 0:
            indata.append(positional_encoding(viewdirs, self.viewpe))
        return torch.sigmoid(self.mlp(torch.cat(indata, dim=-1)))


class RandHydraMLPDiffuse(nn.Module):
    """The microfacet material head: albedo, tint, f0 and roughness from
    one-layer MLPs of the appearance features, with calibrated diffuse and
    roughness biases (frozen) and train-time noise of scale ``std``."""

    def __init__(self, in_channels, feape=0, hidden_w=64, num_layers=1,
                 initializer="xavier_sigmoid", lr=1e-3, start_roughness=0.35,
                 tint_bias=0.0, diffuse_bias=-0.619, diffuse_mul=1.5,
                 roughness_bias=-1.0, f0_bias=0.0, roughness_cfg=None,
                 generator=None):
        super().__init__()
        self.feape = int(feape)
        in_mlpC = 2 * max(self.feape, 0) * in_channels + in_channels
        rc = roughness_cfg or {"hidden_w": hidden_w,
                               "num_layers": num_layers}

        def mlp(out, hw, nl):
            return MLP(in_mlpC, out, num_layers=nl, hidden_w=hw,
                       generator=generator, initializer=initializer)

        self.diffuse_mlp = mlp(3, hidden_w, num_layers)
        self.tint_mlp = mlp(3, hidden_w, num_layers)
        self.f0_mlp = mlp(3, hidden_w, num_layers)
        self.roughness_mlp = mlp(2, rc["hidden_w"], rc["num_layers"])
        self.diffuse_bias = nn.Parameter(torch.tensor(float(diffuse_bias)))
        self.roughness_bias = nn.Parameter(
            torch.tensor(float(roughness_bias)))
        self.tint_bias = float(tint_bias)
        self.f0_bias = float(f0_bias)
        self.diffuse_mul = float(diffuse_mul)
        self.start_roughness = float(start_roughness)
        self.lr = float(lr)

    def forward(self, pts, viewdirs, features, std=0.0, draws=None):
        """-> (albedo (M, 3), tint (M, 3), matprop). With ``draws``, the
        normal draws ``diffuse_noise`` (M, 3) and ``roughness_noise`` (M, 2)
        times ``std`` perturb albedo and roughness."""
        indata = [features]
        if self.feape > 0:
            indata.append(positional_encoding(features, self.feape))
        mlp_in = torch.cat(indata, dim=-1)
        diffuse = torch.sigmoid(self.diffuse_mul * self.diffuse_mlp(mlp_in)
                                + self.diffuse_bias)
        r = torch.sigmoid(self.roughness_mlp(mlp_in)
                          + self.roughness_bias) / 2
        if draws is not None:
            dev = features.device
            diffuse = torch.clamp(
                diffuse + draws.normal("diffuse_noise", diffuse.shape, dev)
                * std, 0, 1)
            r = r + draws.normal("roughness_noise", r.shape, dev) * std / 2
        r = torch.clamp(r, 1e-2, 1.0)
        tint = torch.sigmoid(self.tint_mlp(mlp_in) + self.tint_bias)
        f0 = torch.sigmoid(self.f0_mlp(mlp_in) + self.f0_bias)
        matprop = {"diffuse": diffuse, "r1": r[..., 0:1], "r2": r[..., 1:2],
                   "f0": f0, "tint": tint}
        return diffuse, tint, matprop

    @torch.no_grad()
    def calibrate(self, mean_brightness, conserve_energy, pts, viewdirs,
                  features):
        """Shift the diffuse and roughness biases so the initial albedo
        and roughness hit their targets."""
        diffuse, _, extra = self(pts, viewdirs, features)
        diffuse_v = float(inv_sigmoid(diffuse).mean())
        v = (0.5 if conserve_energy else 0.25) / float(mean_brightness)
        v = min(max(v, 1e-4), 1 - 1e-4)
        self.diffuse_bias.add_(math.log(v / (1 - v)) - diffuse_v)
        roughness = (extra["r1"] + extra["r2"]) / 2 / 2
        roughness_v = float(inv_sigmoid(roughness).mean())
        sr = self.start_roughness
        self.roughness_bias.add_(math.log(sr / (1 - sr)) - roughness_v)


class MLPNormal(nn.Module):
    """Predicted normals: normalize(MLP([xyz] + [features] + IPE(xyz, size)
    + PE(features))), each part present by ``pospe`` / ``feape`` (>= 0 adds
    the raw input, > 0 its encoding of that many degrees); the IPE's
    variance is ``size_multi`` x the sample's footprint (xyz's 4th
    channel)."""

    def __init__(self, mlp, pospe=12, feape=-1, size_multi=2.5e-3, lr=1e-3):
        super().__init__()
        self.mlp = mlp
        self.pospe = int(pospe)
        self.feape = int(feape)
        self.size_multi = float(size_multi)
        self.lr = float(lr)

    def forward(self, pts, features, geo_norms=None):
        p3 = pts[..., :3]
        indata = []
        if self.pospe >= 0:
            indata.append(p3)
        if self.feape >= 0:
            indata.append(features)
        if self.pospe > 0:
            size = pts[..., 3:4].expand(p3.shape)
            indata.append(integrated_pos_enc((p3, self.size_multi * size), 0,
                                             self.pospe))
        if self.feape > 0:
            indata.append(positional_encoding(features, self.feape))
        return normalize(self.mlp(torch.cat(indata, dim=-1)))


def init_mlp_normal(in_channels, generator=None, pospe=12, feape=-1,
                    hidden_w=128, num_layers=4, initializer="kaiming",
                    size_multi=2.5e-3, lr=1e-3, **_):
    """nmf_tpu's ``init_mlp_normal``: a ``num_layers`` x ``hidden_w`` MLP
    whose final layer has no bias and starts at U(-1e-5, 1e-5)."""
    in_mlpC = 0
    if pospe >= 0:
        in_mlpC += 2 * pospe * 3 + 3
    if feape >= 0:
        in_mlpC += 2 * max(feape, 0) * in_channels + in_channels
    mlp = MLP(in_mlpC, 3, num_layers=num_layers, hidden_w=hidden_w,
              generator=generator, initializer=initializer, bias=False)
    scale_final_layer(mlp, 1e-5, generator=generator)
    return MLPNormal(mlp, pospe=pospe, feape=feape, size_multi=size_multi,
                     lr=lr)


class AppDimNormal(nn.Module):
    """Normals read from the first three appearance-feature channels."""

    lr = 1.0

    def forward(self, pts, features, geo_norms=None):
        raw = features[..., 0:3]
        return raw / (torch.linalg.norm(raw, dim=-1, keepdim=True) + 1e-8)
