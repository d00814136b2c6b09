"""BRDF heads (``nmf_tpu/modules/brdf.py``).

``MLPBRDF``, the learned residual BRDF: an MLP of [dot products of L, V,
N and H (``dotpe`` >= 0) and their IPE (``dotpe`` > 0), features,
encoder(half vector), half vector, encoder(diffuse vector), diffuse
vector, PE(features)] with a calibrated output bias and the activation
sigmoid, exp, softplus or sigexp (sigmoid colour times exp brightness,
which reads no bias).

``Specular``: Fresnel-Schlick with a learned C0 times anisotropic Smith
masking. With ``num_layers=0`` its C0 "MLP" is the identity, so C0 has
the features' width, as nmf_tpu's; nmf_tpu's Microfacet cannot build it
(ROADMAP C.12), so it is reached only directly.
"""
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.safemath import (EPS, integrated_pos_enc, inv_activation,
                            normalize, positional_encoding, signed_clip)
from .mlp import MLP

ACTIVATIONS = ("sigmoid", "exp", "softplus", "sigexp")


class MLPBRDF(nn.Module):
    def __init__(self, mlp, bias=0.0, h_encoder=None, d_encoder=None,
                 feape=0, dotpe=-1, activation="sigmoid", mul_LdotN=False,
                 lr=1e-3, init_val=0.5):
        super().__init__()
        self.mlp = mlp
        # calibrated, never trained (optimizer group "frozen")
        self.bias = nn.Parameter(torch.tensor(float(bias)))
        self.h_encoder = h_encoder
        self.d_encoder = d_encoder
        self.feape = int(feape)
        self.dotpe = int(dotpe)
        if activation not in ACTIVATIONS:
            raise ValueError(f"brdf.activation={activation!r}: nmf_tpu has "
                             f"{', '.join(ACTIVATIONS)}")
        self.activation = activation
        self.mul_LdotN = bool(mul_LdotN)
        self.lr = float(lr)
        self.init_val = float(init_val)

    def forward(self, V, L, N, H, local_v, half_vec, diff_vec, efeatures,
                eax, eay):
        """Directions (R, 3); efeatures (R, D); eax, eay (R,). -> (R, 3)."""
        R = V.shape[0]
        indata = []
        if self.dotpe >= 0:
            # sin_ln twice, as nmf_tpu's
            LdotN = (L * N).sum(-1, keepdim=True)
            LdotH = (L * H).sum(-1, keepdim=True)
            VdotN = (V * N).sum(-1, keepdim=True)
            NdotH = half_vec[..., 2:3]
            sin_ln = torch.sqrt(torch.clamp(1 - LdotN ** 2, 1e-8, 1))
            sin_nh = torch.sqrt(torch.clamp(1 - NdotH ** 2, 1e-8, 1))
            indata += [LdotH, sin_ln, VdotN, sin_ln, NdotH, sin_nh]
            if self.dotpe > 0:
                dotvals = torch.cat(indata, dim=-1)
                indata.append(integrated_pos_enc(
                    (dotvals * math.pi, 0.20 * torch.ones_like(dotvals)),
                    0, self.dotpe))
        indata.append(efeatures)
        if self.h_encoder is not None:
            indata += [self.h_encoder(half_vec, eax).reshape(R, -1), half_vec]
        if self.d_encoder is not None:
            indata += [self.d_encoder(diff_vec, eax).reshape(R, -1), diff_vec]
        if self.feape > 0:
            indata.append(positional_encoding(efeatures, self.feape))
        weight = self._activation(self.mlp(torch.cat(indata, dim=-1)))
        if self.mul_LdotN:
            LdotN = (L * N).sum(-1, keepdim=True)
            return weight * torch.clamp(LdotN, min=0).detach()
        return weight

    def _activation(self, x):
        if self.activation == "sigexp":
            return (torch.sigmoid(x[..., :3])
                    * torch.exp(torch.clamp(x[..., 3:4], -10, 10) - 1))
        x = x[..., :3] + self.bias
        if self.activation == "sigmoid":
            return torch.sigmoid(x)
        if self.activation == "exp":
            return torch.exp(x)
        return F.softplus(x)

    @torch.no_grad()
    def calibrate(self, draws, efeatures, bg_brightness):
        """Shift ``bias`` so the mean initial weight hits init_val /
        bg_brightness, over random directions: ``vec0`` .. ``vec6`` (N, 3)
        and ``eax``, ``eay`` (N,) uniform draws. sigexp is inverted as the
        sigmoid (the bias it shifts is not read); softplus has no inverse
        and raises ValueError, as in nmf_tpu."""
        N = efeatures.shape[0]
        dev = efeatures.device

        def rand_vecs(i):
            return normalize(2 * draws.uniform(f"vec{i}", (N, 3), dev) - 1)

        L = rand_vecs(0)
        norms = rand_vecs(1)
        norms = (L * norms).sum(-1, keepdim=True) * norms
        weight = self(rand_vecs(2), L, norms, rand_vecs(3), rand_vecs(4),
                      rand_vecs(5), rand_vecs(6), efeatures,
                      draws.uniform("eax", (N,), dev),
                      draws.uniform("eay", (N,), dev))
        act = "sigmoid" if self.activation == "sigexp" else self.activation
        target = min(max(self.init_val / float(bg_brightness), 1e-4),
                     1 - 1e-4)
        now = float(inv_activation(torch.clamp(weight, 1e-4, 1 - 1e-4),
                                   act).mean())
        self.bias.add_(inv_activation(target, act) - now)


def init_mlp_brdf(in_channels, h_encoder=None, d_encoder=None, feape=0,
                  dotpe=-1, activation="sigmoid", mul_LdotN=False, bias=0.0,
                  lr=1e-3, hidden_w=64, num_layers=3, initializer="kaiming",
                  generator=None, **_):
    in_mlpC = 2 * feape * in_channels + in_channels
    if dotpe >= 0:
        in_mlpC += 6 + 2 * dotpe * 6
    if h_encoder is not None:
        in_mlpC += h_encoder.dim() + 3
    if d_encoder is not None:
        in_mlpC += d_encoder.dim() + 3
    mlp = MLP(in_mlpC, 4, num_layers=num_layers, hidden_w=hidden_w,
              generator=generator, initializer=initializer)
    return MLPBRDF(mlp, bias=bias, h_encoder=h_encoder, d_encoder=d_encoder,
                   feape=feape, dotpe=dotpe, activation=activation,
                   mul_LdotN=mul_LdotN, lr=lr)


def aniso_smith_masking_gtr2(v_local, ax, ay, eps=EPS):
    """Smith's masking of the anisotropic GTR2 lobe; v_local (R, 3) in the
    shading frame, ax, ay (R,) -> (R,)."""
    v2 = v_local * v_local
    Lambda = (-1 + torch.sqrt(torch.clamp(
        1 + (v2[..., 0] * ax * ax + v2[..., 1] * ay * ay)
        / signed_clip(v2[..., 2]), min=eps))) / 2
    return 1 / (1 + Lambda)


class Specular(nn.Module):
    """Fm * Gm / 4: Fm = C0 + (1 - C0) (local_v . half_vec)^5 with C0 =
    sigmoid(c0_mlp(features) + bias), Gm the Smith masking of the diffuse
    vector times that of the view vector. ``bias`` is a constant (not a
    state-dict leaf), nothing is calibrated."""

    def __init__(self, c0_mlp, bias=0.0, lr=1e-3):
        super().__init__()
        self.c0_mlp = c0_mlp
        self.bias = float(bias)
        self.lr = float(lr)

    def forward(self, V, L, N, H, local_v, half_vec, diff_vec, efeatures,
                ax, ay):
        VdotH = (local_v * half_vec).sum(-1, keepdim=True)
        C0 = torch.sigmoid(self.c0_mlp(efeatures) + self.bias)
        Fm = C0 + (1 - C0) * VdotH ** 5
        Gm = (aniso_smith_masking_gtr2(diff_vec, ax, ay)
              * aniso_smith_masking_gtr2(local_v, ax, ay))
        return Fm * Gm.reshape(-1, 1) / 4

    def calibrate(self, draws, efeatures, bg_brightness):
        pass


def init_specular(in_channels, lr=1e-3, bias=0.0, hidden_w=64,
                  num_layers=0, generator=None, **_):
    """C0's MLP (features -> 3, nn.Linear's default init), or the identity
    (no state-dict key) at ``num_layers=0``, nmf_tpu's default."""
    c0 = (MLP(in_channels, 3, num_layers=num_layers, hidden_w=hidden_w,
              generator=generator) if num_layers > 0 else nn.Identity())
    return Specular(c0, bias=bias, lr=lr)
