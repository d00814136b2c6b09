"""Appearance, material and normal heads
(``nmf_tpu/modules/render_modules.py``): the ``PE`` and ``IPE`` encoders,
``MLPRenderFea`` and ``MLPRenderPE`` (tensorf), the material heads
``RandHydraMLPDiffuse``, ``HydraMLPDiffuse``, ``MLPDiffuse`` and
``PassthroughDiffuse`` (microfacet, Ref-NeRF), the predicted-normal
heads ``MLPNormal`` and ``AppDimNormal``, and the
``LearnableSphericalEncoding``, which no builder target reaches.

A material head maps (pts (M, 4): position and footprint, viewdirs,
features) to (albedo (M, 3), tint (M, 3), matprop), where matprop holds
``diffuse``, ``tint``, the roughnesses ``r1`` / ``r2`` (M, 1) and ``f0``
((M, 3); ``MLPDiffuse``'s is (M, 1), as nmf_tpu's). Its ``calibrate``
shifts its frozen ``diffuse_bias`` / ``roughness_bias`` (state-dict
leaves) so the initial albedo and roughness hit their targets.
"""
import math

import numpy as np
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


class IPE(PE):
    """Integrated positional encoding of directions whose variance is the
    roughness (N,), broadcast over the last axis."""

    def forward(self, viewdirs, roughness):
        size = roughness.reshape(-1, 1).expand(viewdirs.shape)
        return integrated_pos_enc((viewdirs, size), 0, self.max_degree)


def _point_inputs(pts, features, pospe, feape):
    """[xyz] + [IPE(xyz, footprint)] + [features] + [PE(features)], each
    present by ``pospe`` / ``feape`` (>= 0 adds the raw input, > 0 its
    encoding of that many degrees)."""
    p3 = pts[..., :3]
    indata = []
    if pospe >= 0:
        indata.append(p3)
    if pospe > 0:
        size = pts[..., 3:4].expand(p3.shape)
        indata.append(integrated_pos_enc((p3, size), 0, pospe))
    if feape >= 0:
        indata.append(features)
    if feape > 0:
        indata.append(positional_encoding(features, feape))
    return indata


def _point_width(in_channels, pospe, feape):
    """The width of ``_point_inputs``."""
    width = 2 * pospe * 3 + 3 if pospe >= 0 else 0
    if feape >= 0:
        width += 2 * max(feape, 0) * in_channels + in_channels
    return width


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
    MLPs of the point inputs (``_point_inputs``) and, with a
    ``view_encoder``, its encoding of the view direction and the direction;
    the roughness MLP also reads the ``roughness_view_encoder``'s (both
    encoders at roughness 1e-3). Calibrated diffuse and roughness biases
    (frozen) and train-time noise of scale ``std``."""

    def __init__(self, in_channels, pospe=-1, feape=0, hidden_w=64,
                 num_layers=1, initializer="xavier_sigmoid", lr=1e-3,
                 start_roughness=0.35, tint_bias=0.0, diffuse_bias=-0.619,
                 diffuse_mul=1.5, roughness_bias=-1.0, f0_bias=0.0,
                 roughness_cfg=None, view_encoder=None,
                 roughness_view_encoder=None, generator=None):
        super().__init__()
        self.pospe = int(pospe)
        self.feape = int(feape)
        self.view_encoder = view_encoder
        self.roughness_view_encoder = roughness_view_encoder
        in_mlpC = _point_width(in_channels, self.pospe, self.feape)
        if view_encoder is not None:
            in_mlpC += view_encoder.dim() + 3
        rough_in = in_mlpC
        if roughness_view_encoder is not None:
            rough_in += roughness_view_encoder.dim() + 3
        rc = roughness_cfg or {"hidden_w": hidden_w,
                               "num_layers": num_layers}

        def mlp(width, out, hw, nl):
            return MLP(width, out, num_layers=nl, hidden_w=hw,
                       generator=generator, initializer=initializer)

        self.diffuse_mlp = mlp(in_mlpC, 3, hidden_w, num_layers)
        self.tint_mlp = mlp(in_mlpC, 3, hidden_w, num_layers)
        self.f0_mlp = mlp(in_mlpC, 3, hidden_w, num_layers)
        self.roughness_mlp = mlp(rough_in, 2, rc["hidden_w"],
                                 rc["num_layers"])
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
        indata = _point_inputs(pts, features, self.pospe, self.feape)
        B = pts.shape[0]
        rough = None
        if self.view_encoder is not None or \
                self.roughness_view_encoder is not None:
            rough = torch.full((B,), 1e-3, device=pts.device)
        if self.view_encoder is not None:
            indata += [self.view_encoder(viewdirs, rough).reshape(B, -1),
                       viewdirs]
        mlp_in = torch.cat(indata, dim=-1)
        if self.roughness_view_encoder is not None:
            indata += [self.roughness_view_encoder(viewdirs, rough).reshape(
                B, -1), viewdirs]
        rough_in = torch.cat(indata, dim=-1)
        diffuse = torch.sigmoid(self.diffuse_mul * self.diffuse_mlp(mlp_in)
                                + self.diffuse_bias)
        r = torch.sigmoid(self.roughness_mlp(rough_in)
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


class _BiasedHead(nn.Module):
    """The calibration of ``MLPDiffuse`` and ``HydraMLPDiffuse``, in
    float32 as nmf_tpu's: diffuse_bias += logit(v) - mean(logit(albedo)),
    v = (0.5 if conserve_energy else 0.25) / mean_brightness clipped to
    [1e-4, 1 - 1e-4]; roughness_bias += logit(start_roughness) -
    mean(logit((r1 + r2) / 4)); albedo and roughness clipped to [1e-6,
    1 - 1e-6]."""

    def __init__(self, pospe, feape, lr):
        super().__init__()
        self.diffuse_bias = nn.Parameter(torch.tensor(-2.0))
        self.roughness_bias = nn.Parameter(torch.tensor(1.0))
        self.tint_bias = -1.0
        self.diffuse_mul = 1.0
        self.pospe = int(pospe)
        self.feape = int(feape)
        self.lr = float(lr)

    def inputs(self, pts, features):
        return torch.cat(_point_inputs(pts, features, self.pospe,
                                       self.feape), dim=-1)

    @torch.no_grad()
    def calibrate(self, mean_brightness, conserve_energy, pts, viewdirs,
                  features, start_roughness=0.35):
        diffuse, _, extra = self(pts, viewdirs, features)

        def logit(x, lo=1e-4):
            x = torch.as_tensor(x, dtype=torch.float32, device=pts.device)
            return inv_sigmoid(torch.clamp(x, lo, 1 - lo))

        v = (0.5 if conserve_energy else 0.25) / float(mean_brightness)
        self.diffuse_bias.add_(float(logit(v) - logit(diffuse, 1e-6).mean()))
        rough = (extra["r1"] + extra["r2"]) / 4
        self.roughness_bias.add_(float(
            inv_sigmoid(torch.tensor(start_roughness))
            - logit(rough, 1e-6).mean()))


class MLPDiffuse(_BiasedHead):
    """One MLP of the point inputs with 10 outputs: albedo (3), tint (3),
    ambient, r1, r2 and f0, the last an (M, 1) column. The yaml's bias
    keys are not read (nmf_tpu's ``init_mlp_diffuse``): the biases start
    at -2 and 1."""

    def __init__(self, in_channels, pospe=12, feape=6, featureC=128,
                 num_layers=4, lr=1e-4, generator=None, **_):
        super().__init__(pospe, feape, lr)
        self.mlp = MLP(_point_width(in_channels, self.pospe, self.feape),
                       10, num_layers=num_layers, hidden_w=featureC,
                       generator=generator)

    def forward(self, pts, viewdirs, features, std=0.0, draws=None):
        out = self.mlp(self.inputs(pts, features))
        ambient = torch.sigmoid(out[..., 6:7] - 2)
        r1 = torch.sigmoid(out[..., 7:8] + self.roughness_bias) \
            * (1 - 1e-3) + 1e-3
        r2 = torch.sigmoid(out[..., 8:9] + self.roughness_bias) \
            * (1 - 1e-3) + 1e-3
        tint = torch.sigmoid(out[..., 3:6] + self.tint_bias)
        f0 = torch.sigmoid(out[..., 9:10] + 3) * (1 - 0.001) + 0.001
        diffuse = torch.sigmoid(self.diffuse_mul * out[..., 0:3]
                                + self.diffuse_bias)
        return diffuse, tint, {"ambient": ambient, "r1": r1, "r2": r2,
                               "f0": f0, "tint": tint, "diffuse": diffuse}


class HydraMLPDiffuse(_BiasedHead):
    """Albedo, tint and roughness from three MLPs of the point inputs, no
    train-time noise; f0 the dielectric 0.04. Biases as ``MLPDiffuse``."""

    def __init__(self, in_channels, pospe=12, feape=6, featureC=128,
                 num_layers=4, lr=1e-4, generator=None, **_):
        super().__init__(pospe, feape, lr)
        width = _point_width(in_channels, self.pospe, self.feape)

        def mlp(out):
            return MLP(width, out, num_layers=num_layers, hidden_w=featureC,
                       generator=generator)

        self.diffuse_mlp = mlp(3)
        self.tint_mlp = mlp(3)
        self.roughness_mlp = mlp(2)

    def forward(self, pts, viewdirs, features, std=0.0, draws=None):
        x = self.inputs(pts, features)
        diffuse = torch.sigmoid(self.diffuse_mul * self.diffuse_mlp(x)
                                + self.diffuse_bias)
        r = torch.sigmoid(self.roughness_mlp(x) + self.roughness_bias) / 2
        tint = torch.sigmoid(self.tint_mlp(x) + self.tint_bias)
        return diffuse, tint, {"diffuse": diffuse, "r1": r[..., 0:1],
                               "r2": r[..., 1:2], "tint": tint,
                               "f0": torch.full_like(diffuse, 0.04)}


class PassthroughDiffuse(nn.Module):
    """Material properties read from the first 8 appearance-feature
    channels (app_dim >= 8); no parameters, nothing to calibrate."""

    lr = 0.0

    def forward(self, pts, viewdirs, features, std=0.0, draws=None):
        diffuse = torch.sigmoid(features[..., 0:3] - 3)
        roughness = torch.clamp(torch.sigmoid(features[..., 3:4] + 2),
                                min=1e-2) / 2
        ambient = torch.sigmoid(features[..., 4:5] - 2)
        tint = torch.sigmoid(features[..., 5:8])
        return diffuse, tint, {
            "ambient": ambient, "diffuse": diffuse, "roughness": roughness,
            "r1": roughness, "r2": roughness,
            "f0": torch.full_like(diffuse, 0.04)}

    def calibrate(self, *args, **kwargs):
        pass


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


def fibonacci_sphere(n: int, eps: float):
    """(3, n) evenly distributed points on the unit sphere (an offset
    Fibonacci lattice), computed in float64 and stored in float32."""
    indices = np.arange(n, dtype=np.float64)
    golden = (1 + 5 ** 0.5) / 2
    phi = np.arccos(1 - 2 * (indices + eps) / (n - 1 + 2 * eps))
    theta = 2 * np.pi * indices / golden
    xyz = np.stack([np.cos(theta) * np.sin(phi),
                    np.sin(theta) * np.sin(phi),
                    np.cos(phi)], axis=0)
    return torch.tensor(xyz, dtype=torch.float32)


class LearnableSphericalEncoding(nn.Module):
    """Learned features ``weights`` (1, M, C) on a Fibonacci sphere lattice
    ``sphere_pos`` (3, M; a buffer), read by a Gaussian kernel over the
    angular distance of a direction to each lattice point, normalized over
    the lattice. No builder target reaches it, in nmf_tpu either."""

    def __init__(self, weights, sphere_pos, lr=1e-3):
        super().__init__()
        self.weights = nn.Parameter(weights)
        self.register_buffer("sphere_pos", sphere_pos)
        self.lr = float(lr)

    def dim(self):
        return self.weights.shape[-1]

    def forward(self, vec, sigma):
        """vec (N, 3); sigma: a scalar or (N, 1) angular stddev."""
        cos_dist = torch.clamp(vec @ self.sphere_pos, -1 + 1e-5, 1 - 1e-5)
        ang = torch.arccos(cos_dist)
        prob = torch.exp(-((ang / sigma) ** 2) / 2)
        prob = prob / (prob.sum(dim=1, keepdim=True) + 1e-8)
        return prob @ self.weights[0]


def init_learnable_spherical_encoding(out_channels, out_res, generator=None,
                                      lr=1e-3):
    """nmf_tpu's ``init_learnable_spherical_encoding``: weights U(0, 1),
    the lattice's offset by ``out_res``."""
    eps = 0.33 if out_res < 24 else (1.33 if out_res < 177 else 3.33)
    weights = torch.rand((1, out_res, out_channels), generator=generator)
    return LearnableSphericalEncoding(weights, fibonacci_sphere(out_res, eps),
                                      lr=lr)
