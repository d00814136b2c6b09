"""The Microfacet model's optional light-transport helpers
(``nmf_tpu/modules/visibility.py``).

``VisibilityMLP`` is the learned visibility cache: from a bounce ray's
direction and its parent's appearance features it predicts the chance
``sigvis`` that the ray is blocked (and an expected termination ``eterm``).
The model damps the retrace priority of rays it predicts blocked and fits
it to the background visibility the retrace pass observes.

``ERBrightSampler`` draws bounce directions toward bright envmap texels by
inverse-CDF sampling of the texel brightness weighted by its solid angle
(``torch.cumsum`` and a left ``torch.searchsorted``, as
``jnp.searchsorted``), from the uniform draws ``u``, ``jy`` and ``jx``
(n,).

``CubeBrightSampler`` builds, but nmf_tpu's model cannot use it (ROADMAP
C.10): ``Microfacet.shade`` calls ``sample(key, bg_module, n, cache=...)``
where its ``sample`` takes ``(key, V, N)``, and nothing refreshes its
spots. Sampling with it raises ``NotImplementedError``.
"""
import math

import torch
import torch.nn as nn

from ..ops.safemath import positional_encoding
from .mlp import MLP


class VisibilityMLP(nn.Module):
    def __init__(self, in_channels, feape=2, featureC=128, num_layers=4,
                 lr=1e-3, generator=None):
        super().__init__()
        in_w = 3
        if feape > -1:
            in_w += 2 * feape * in_channels + in_channels
        self.mlp = MLP(in_w, 2, num_layers=num_layers, hidden_w=featureC,
                       generator=generator, initializer="xavier")
        self.feape = int(feape)
        self.lr = float(lr)

    def forward(self, pts, viewdirs, features):
        """-> (eterm, sigvis), each (N,). ``pts`` is unused, as in
        nmf_tpu."""
        indata = [viewdirs]
        if self.feape > -1:
            indata.append(features)
        if self.feape > 0:
            indata.append(positional_encoding(features, self.feape))
        out = self.mlp(torch.cat(indata, dim=-1))
        sigvis = torch.sigmoid(out[..., 0])
        eterm = torch.exp(torch.clamp(out[..., 1], -10, 10))
        return eterm, sigvis


def init_visibility_mlp(in_channels, generator=None, feape=2, featureC=128,
                        num_layers=4, lr=1e-3, **_):
    return VisibilityMLP(in_channels, feape=feape, featureC=featureC,
                         num_layers=num_layers, lr=lr, generator=generator)


class ERBrightSampler:
    """Envmap brightness importance sampler."""

    def sample(self, draws, bg_module, n_rays: int, cache=None):
        """``n_rays`` directions drawn in proportion to the envmap's
        brightness times the texel's solid angle. Returns (dirs (n, 3),
        pdf (n,) over the sphere); the pdf keeps its gradient to the
        envmap, the directions have none."""
        brightness = bg_module.activation_fn(bg_module.bg_mat).mean(dim=0)
        h, w = brightness.shape
        dev = brightness.device
        theta = (torch.arange(h, device=dev) + 0.5) / h * math.pi
        flat = (brightness * torch.sin(theta)[:, None]).reshape(-1)
        cdf = torch.cumsum(flat, dim=0)
        cdf = cdf / cdf[-1]
        u = draws.uniform("u", (n_rays,), dev)
        idx = torch.searchsorted(cdf, u)
        iy = torch.div(idx, w, rounding_mode="floor")
        ix = idx % w
        jy = (iy + draws.uniform("jy", (n_rays,), dev)) / h
        jx = (ix + draws.uniform("jx", (n_rays,), dev)) / w
        th = jy * math.pi
        ph = 2 * math.pi * jx
        dirs = torch.stack([torch.sin(th) * torch.cos(ph),
                            torch.sin(th) * torch.sin(ph),
                            torch.cos(th)], dim=-1)
        pdf_texel = flat[idx] / flat.sum()
        sa_texel = ((2 * math.pi / w) * (math.pi / h)
                    * torch.clamp(torch.sin(th), min=1e-6))
        return dirs, pdf_texel / sa_texel


class CubeBrightSampler(nn.Module):
    """nmf_tpu's bright-spot sampler as its checkpoints hold it: the
    ``spots`` (S, 3), zeros, and its settings. nmf_tpu's Microfacet model
    cannot call it (ROADMAP C.10)."""

    def __init__(self, n_spots=16, scale=1, update_freq=1000):
        super().__init__()
        self.register_buffer("spots", torch.zeros((int(n_spots), 3)))
        self.scale = int(scale)
        self.update_freq = int(update_freq)

    def sample(self, *args, **kwargs):
        raise NotImplementedError(
            "bright_sampler=CubeBrightSampler: nmf_tpu's Microfacet.shade "
            "calls sample(key, bg_module, n, cache=...) but the cube "
            "sampler takes (key, V, N), so nmf_tpu raises TypeError at the "
            "first step, and nothing updates its spots (ROADMAP C.10); "
            "use ERBrightSampler")
