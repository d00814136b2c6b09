"""Learned residual BRDF ``MLPBRDF`` (``nmf_tpu/modules/brdf.py``): an MLP of
[features, ISH(half vector), half vector, ISH(diffuse vector), diffuse
vector] with a calibrated output bias."""
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.safemath import inv_activation, normalize, positional_encoding
from .mlp import MLP

LATER = " it comes with a later slice of nmf_tpu_torch (ROADMAP A.1)"
ACTIVATIONS = {"sigmoid": torch.sigmoid, "exp": torch.exp,
               "softplus": F.softplus}


class MLPBRDF(nn.Module):
    def __init__(self, mlp, bias=0.0, h_encoder=None, d_encoder=None,
                 feape=0, activation="sigmoid", mul_LdotN=False, lr=1e-3,
                 init_val=0.5):
        super().__init__()
        self.mlp = mlp
        # calibrated, never trained (optimizer group "frozen")
        self.bias = nn.Parameter(torch.tensor(float(bias)))
        self.h_encoder = h_encoder
        self.d_encoder = d_encoder
        self.feape = int(feape)
        if activation not in ACTIVATIONS:
            raise NotImplementedError(
                f"brdf.activation={activation!r} is not ported yet:{LATER}")
        self.activation = activation
        self.mul_LdotN = bool(mul_LdotN)
        self.lr = float(lr)
        self.init_val = float(init_val)

    def forward(self, V, L, N, H, local_v, half_vec, diff_vec, efeatures,
                eax, eay):
        """Directions (R, 3); efeatures (R, D); eax, eay (R,). -> (R, 3)."""
        R = V.shape[0]
        indata = [efeatures]
        if self.h_encoder is not None:
            indata += [self.h_encoder(half_vec, eax).reshape(R, -1), half_vec]
        if self.d_encoder is not None:
            indata += [self.d_encoder(diff_vec, eax).reshape(R, -1), diff_vec]
        if self.feape > 0:
            indata.append(positional_encoding(efeatures, self.feape))
        raw = self.mlp(torch.cat(indata, dim=-1))
        weight = ACTIVATIONS[self.activation](raw[..., :3] + self.bias)
        if self.mul_LdotN:
            LdotN = (L * N).sum(-1, keepdim=True)
            return weight * torch.clamp(LdotN, min=0).detach()
        return weight

    @torch.no_grad()
    def calibrate(self, draws, efeatures, bg_brightness):
        """Shift ``bias`` so the mean initial weight hits init_val /
        bg_brightness, over random directions: ``vec0`` .. ``vec6`` (N, 3)
        and ``eax``, ``eay`` (N,) uniform draws."""
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
        act = self.activation
        target = min(max(self.init_val / float(bg_brightness), 1e-4),
                     1 - 1e-4)
        now = float(inv_activation(torch.clamp(weight, 1e-4, 1 - 1e-4),
                                   act).mean())
        self.bias.add_(inv_activation(target, act) - now)


def init_mlp_brdf(in_channels, h_encoder=None, d_encoder=None, feape=0,
                  dotpe=-1, activation="sigmoid", mul_LdotN=False, bias=0.0,
                  lr=1e-3, hidden_w=64, num_layers=3, initializer="kaiming",
                  generator=None, **_):
    if dotpe >= 0:
        raise NotImplementedError(f"brdf.dotpe >= 0 is not ported yet:{LATER}")
    in_mlpC = 2 * feape * in_channels + in_channels
    if h_encoder is not None:
        in_mlpC += h_encoder.dim() + 3
    if d_encoder is not None:
        in_mlpC += d_encoder.dim() + 3
    mlp = MLP(in_mlpC, 4, num_layers=num_layers, hidden_w=hidden_w,
              generator=generator, initializer=initializer)
    return MLPBRDF(mlp, bias=bias, h_encoder=h_encoder, d_encoder=d_encoder,
                   feape=feape, activation=activation, mul_LdotN=mul_LdotN,
                   lr=lr)
