"""Learnable equirectangular environment map with summed-area-table (SAT)
filtering (``nmf_tpu/modules/bg.py``, ``IntegralEquirect``).

``prepare`` builds the per-step cache once: the activated map, padded with
pole-mirror rows (across a pole the map continues flipped and rotated by
180 degrees of azimuth) and periodic columns, so every lookup box is one
rectangle of the extended table; its SAT; the pole rows' means; and the SH
irradiance coefficients (no gradient, unless ``sh_grad``: then the diffuse
shading term trains the map through them, nmf_tpu's opt-in extension). A
lookup reads the box integral from the SAT's four corners, each one
quad-table row gathered by ``TakeRows``, whose backward is the
``binsum_rows`` kernel.

The map is ``activation(brightness + mul * bg_mat)``: exp (clipped at
20), softplus(6 x) / 6, clip at 1e-3 from below, or the identity.
``mipnoise`` adds U(0, mipnoise) draws to a lookup's mip levels when the
caller gives draws; as in nmf_tpu, no caller does.
"""
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import sh
from ..ops.grid_sample import quad_gather_2d
from ..ops.safemath import EPS, safe_atan2

SAT_SCALE = 1000.0
SAT_PAD = 72    # periodic columns on each side
SAT_VPAD = 40   # pole-mirror rows above and below


def _integrate_box(bl, br, tl, tr, size, cum_mat, W, H):
    """Box integral over the extended SAT cum_mat (C, H + 2V, W + 2E) from
    its four corners, given in coordinates normalized to the original (H,
    W) grid. -> (N, C)."""
    He, We = cum_mat.shape[-2], cum_mat.shape[-1]
    E = (We - W) // 2
    V = (He - H) // 2
    emax = 2 * E / max(W - 1, 1)
    vmax = 2 * V / max(H - 1, 1)

    def to_ext(c):
        col = ((torch.clamp(c[..., 0], -1 - emax, 1 + emax) + 1) * 0.5
               * (W - 1) + E)
        row = ((torch.clamp(c[..., 1], -1 - vmax, 1 + vmax) + 1) * 0.5
               * (H - 1) + V)
        return torch.stack([2 * col / (We - 1) - 1, 2 * row / (He - 1) - 1],
                           dim=-1)

    corners = torch.stack([to_ext(bl), to_ext(br), to_ext(tl), to_ext(tr)])
    vals = quad_gather_2d(cum_mat, corners)  # (4, N, C)
    return (vals[3] + vals[0] - vals[2] - vals[1]) / size[..., None]


class IntegralEquirect(nn.Module):
    def __init__(self, bg_resolution=512, init_val=-0.6, activation="exp",
                 mipbias=1.0, mipnoise=0.0, lr=0.02, mipbias_lr=1e-4,
                 brightness_lr=0.0, mul_lr=0.0, sh_grad=False):
        super().__init__()
        self.bg_mat = nn.Parameter(torch.full(
            (3, bg_resolution, 2 * bg_resolution), float(init_val)))
        self.mipbias = nn.Parameter(torch.tensor(float(mipbias)))
        self.brightness = nn.Parameter(torch.tensor(0.0))
        self.mul = nn.Parameter(torch.tensor(1.0))
        self.activation = activation
        self.mipnoise = float(mipnoise)
        self.sh_grad = bool(sh_grad)
        self.lr = float(lr)
        self.mipbias_lr = float(mipbias_lr)
        self.brightness_lr = float(brightness_lr)
        self.mul_lr = float(mul_lr)

    def hw(self):
        return self.bg_mat.shape[-2], self.bg_mat.shape[-1]

    def activation_fn(self, x):
        x = self.brightness + self.mul * x
        if self.activation == "softplus":
            return F.softplus(6.0 * x) / 6.0
        if self.activation == "clip":
            return torch.clamp(x, min=1e-3)
        if self.activation == "identity":
            return x
        return torch.exp(torch.clamp(x, max=20))

    def mean_color(self):
        return self.activation_fn(self.bg_mat).reshape(3, -1).mean(dim=-1)

    def tv_loss(self):
        """Mean absolute difference of the raw map to its lower and right
        neighbours (``TV_weight_bg``). A difference of 0 (everywhere on
        the initial map) takes the slope +1, as ``jnp.abs``'s gradient
        gives it; torch's ``abs`` gives 0 there."""
        def abs_(d):
            return torch.where(d >= 0, d, -d)

        img = self.bg_mat
        tv_h = abs_(img[:, 1:, :-1] - img[:, :-1, :-1])
        tv_w = abs_(img[:, :-1, 1:] - img[:, :-1, :-1])
        return (tv_h + tv_w + 1e-8).mean()

    def prepare(self, with_sh: bool = True):
        """The per-step cache: extended SAT ``cum_mat``, the pole rows'
        means ``top_row`` / ``bot_row`` and, with ``with_sh``, the
        Lambertian-convolved SH coefficients ``sh_conv_coeffs`` (9, 3),
        differentiable with ``sh_grad``."""
        activated = self.activation_fn(self.bg_mat)
        H, W = activated.shape[-2], activated.shape[-1]
        V = min(SAT_VPAD, H - 1)
        shifted = torch.roll(activated, W // 2, dims=-1)
        top = shifted[:, 1:V + 1].flip(1)
        bot = shifted[:, H - 1 - V:H - 1].flip(1)
        vert = torch.cat([top, activated, bot], dim=1)
        E = min(SAT_PAD, W)
        ext = torch.cat([vert[..., -E:], vert, vert[..., :E]], dim=-1)
        cache = {
            "cum_mat": torch.cumsum(torch.cumsum(ext / SAT_SCALE, dim=1),
                                    dim=2),
            "top_row": activated[:, 0, :].mean(dim=-1),
            "bot_row": activated[:, -1, :].mean(dim=-1),
        }
        if with_sh:
            with torch.set_grad_enabled(self.sh_grad
                                        and torch.is_grad_enabled()):
                cache["sh_conv_coeffs"] = self.get_spherical_harmonics(
                    100, cache=cache)[1]
        return cache

    def sa2mip(self, u, sa_sample):
        """Log solid angle -> (mip_w, mip_h) footprint levels in [0, 7]."""
        h, w = self.hw()
        sa = sa_sample.reshape(-1)
        cos = torch.sqrt(torch.clamp(1 - u[:, 2] ** 2, min=EPS))
        d = h * w / torch.clamp(2 * math.pi ** 2 * cos, min=EPS)
        area = torch.exp(torch.log(d / 2) + sa)
        fh = torch.clamp(torch.sqrt(torch.clamp(area, min=EPS)) * cos,
                         min=EPS)
        fw = area / fh
        mip_w = torch.log(fw) / math.log(2) + self.mipbias
        mip_h = torch.log(fh) / math.log(2) + self.mipbias
        return torch.clamp(mip_w, 0, 7), torch.clamp(mip_h, 0, 7)

    def forward(self, viewdirs, sa_sample, cache=None, draws=None):
        """viewdirs (N, 3); sa_sample (N,) log solid angle -> (N, 3). With
        ``mipnoise`` and ``draws``, the uniform draws ``mip_w`` and ``mip_h``
        (N,) jitter the mip levels."""
        if cache is None:
            cache = self.prepare()
        h, w = self.hw()
        mip_w, mip_h = self.sa2mip(viewdirs, sa_sample.reshape(-1))
        if self.mipnoise > 0 and draws is not None:
            dev = viewdirs.device
            mip_w = torch.clamp(mip_w + self.mipnoise * draws.uniform(
                "mip_w", mip_w.shape, dev), 0, 7)
            mip_h = torch.clamp(mip_h + self.mipnoise * draws.uniform(
                "mip_h", mip_h.shape, dev), 0, 7)
        sw = 2.0 ** mip_w / h / 2
        shh = 2.0 ** mip_h / h
        offset = torch.stack([sw, shh], dim=-1)
        size = (offset / 2 * offset.new_tensor([w, h])).prod(dim=-1)

        a, b, c = viewdirs[:, 0], viewdirs[:, 1], viewdirs[:, 2]
        norm2d = torch.sqrt(a ** 2 + b ** 2)
        phi = safe_atan2(b, a)
        theta = safe_atan2(c, norm2d)
        coords = torch.stack([
            (torch.remainder(phi, 2 * math.pi) - math.pi) / math.pi,
            -theta / math.pi * 2], dim=-1)

        half = offset / 2
        bl = coords - half
        tr = coords + half
        br = coords + torch.stack([sw, -shh], -1) / 2
        tl = coords + torch.stack([-sw, shh], -1) / 2
        bg_vals = _integrate_box(bl, br, tl, tr, size, cache["cum_mat"], w,
                                 h) * SAT_SCALE
        # within 3 texels of a pole: the pole row's mean
        cutoff = 1 - 2 / h * 3
        bg_vals = torch.where(coords[:, 1:2] > cutoff,
                              cache["bot_row"][None], bg_vals)
        return torch.where(coords[:, 1:2] < -cutoff, cache["top_row"][None],
                           bg_vals)

    def get_spherical_harmonics(self, G: int = 100, mipval: float = -5.0,
                                cache=None):
        """Project the map onto 9 SH bases over a (G/2, G) grid of
        directions -> (coeffs (9, 3), Lambertian-convolved coeffs / pi)."""
        dev = self.bg_mat.device
        theta = torch.linspace(0, math.pi, G // 2, device=dev)
        phi = torch.linspace(0, 2 * math.pi, G, device=dev)
        th, ph = torch.meshgrid(theta, phi, indexing="ij")
        dirs = torch.stack([torch.sin(th) * torch.cos(ph),
                            torch.sin(th) * torch.sin(ph),
                            torch.cos(th)], dim=-1).reshape(-1, 3)
        SB = dirs.shape[0]
        bg = self(dirs, torch.full((SB,), mipval, device=dev), cache=cache)
        evaled = sh.eval_sh_bases(9, dirs)
        coeffs = 2 * math.pi ** 2 * (
            bg.reshape(SB, 1, 3) * evaled.reshape(SB, -1, 1)
            * torch.sin(th).reshape(SB, 1, 1)).mean(dim=0)
        sh_A = sh.lambertian_coeffs(16, device=dev)[:coeffs.shape[0]]
        conv = sh_A.reshape(-1, 1) * coeffs
        return coeffs, conv / math.pi


def init_integral_equirect(bg_resolution=512, init_val=-0.6,
                           activation="exp", mipbias=1.0, mipnoise=0.0,
                           lr=0.02, mipbias_lr=1e-4, brightness_lr=0.0,
                           mul_lr=0.0, sh_grad=False, **_):
    return IntegralEquirect(bg_resolution, init_val, activation, mipbias,
                            mipnoise, lr, mipbias_lr, brightness_lr, mul_lr,
                            sh_grad)
