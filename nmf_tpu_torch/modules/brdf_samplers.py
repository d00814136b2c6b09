"""Importance sampling of bounce rays (``nmf_tpu/modules/brdf_samplers.py``):
Hammersley draws with a random toroidal offset; Heitz 2018 GGX VNDF
sampling, the SGGX microflake, Beckmann and cosine-lobe samplers and their
GGX / cosine mix, each with its pdf (``compute_prob``, in the local frame,
0 below the horizon)."""
import math

import torch

from ..ops.safemath import EPS, normalize, safe_cos, safe_sin

_M32 = 0xFFFFFFFF


def radical_inverse_base2(i):
    """Bit-reversed fraction of the uint32 value of index i -> [0, 1), on
    int64 with 32-bit masks."""
    i = i.to(torch.int64) & _M32
    i = ((i & 0x55555555) << 1) | ((i & 0xAAAAAAAA) >> 1)
    i = ((i & 0x33333333) << 2) | ((i & 0xCCCCCCCC) >> 2)
    i = ((i & 0x0F0F0F0F) << 4) | ((i & 0xF0F0F0F0) >> 4)
    i = ((i & 0x00FF00FF) << 8) | ((i & 0xFF00FF00) >> 8)
    i = ((i << 16) | (i >> 16)) & _M32
    return i.to(torch.float32) * (1.0 / 4294967296.0)


def hammersley_draw(draws, within_idx, counts_per_slot):
    """Stratified (u1, u2) per flat bounce-ray slot: u1 = (i + 0.5) / n, u2
    = the radical inverse of i, both shifted by a quarter of the uniform
    draws ``offset1`` / ``offset2`` (R,) modulo 1."""
    R = counts_per_slot.shape[0]
    dev = counts_per_slot.device
    u1 = ((within_idx.to(torch.float32) + 0.5)
          / torch.clamp(counts_per_slot.to(torch.float32), min=1))
    u2 = radical_inverse_base2(within_idx)
    off1 = draws.uniform("offset1", (R,), dev)
    off2 = draws.uniform("offset2", (R,), dev)
    return (torch.remainder(u1 + off1 * 0.25, 1.0),
            torch.remainder(u2 + off2 * 0.25, 1.0))


def _rows_apply(basis, v):
    """basis (R, 3, 3) rows times v (R, 3): world -> local."""
    return torch.einsum("rij,rj->ri", basis, v)


def _frame(N):
    """Row world basis (R, 3, 3) around N: tangent, bitangent, N."""
    R = N.shape[0]
    z_up = N.new_tensor([0.0, 0.0, 1.0]).expand(R, 3)
    x_up = N.new_tensor([-1.0, 0.0, 0.0]).expand(R, 3)
    up = torch.where(N[:, 2:3].abs() < 0.999, z_up, x_up)
    tangent = normalize(torch.cross(up, N, dim=-1))
    bitangent = normalize(torch.cross(N, tangent, dim=-1))
    return torch.stack([tangent, bitangent, N], dim=1)


def _reflect(V, H_l, basis, N):
    """World half vector of local H_l, and V reflected about it, flipped
    into N's hemisphere -> (H, L)."""
    H = torch.einsum("rji,rj->ri", basis, H_l)
    L = normalize(2.0 * (V * H).sum(-1, keepdim=True) * H - V)
    sign = torch.where((L * N).sum(-1, keepdim=True) > 0, 1.0, -1.0)
    return H, L * sign


def _log_pdf(sampler, L, V, H_l, basis, r1, r2):
    """log of ``sampler``'s pdf of L, no gradient."""
    return torch.log(torch.clamp(sampler.compute_prob(
        _rows_apply(basis, L), _rows_apply(basis, V), H_l, r1, r2),
        min=EPS)).detach()


def _below_horizon_zero(dir_in, pdf):
    return torch.where(dir_in[:, 2] > 0, pdf, torch.zeros_like(pdf))


class GGXSampler:
    """Isotropic GGX VNDF sampler (the roughness of both axes is r1)."""

    def sample(self, u1, u2, V, N, r1, r2=None):
        """u1, u2: (R,) uniforms; V: (R, 3) outgoing (towards the eye); N:
        (R, 3) normals aligned to V; r1: (R,) roughness. Returns (L (R, 3),
        row world basis (R, 3, 3), logD (R,), no gradient)."""
        r2 = r1
        R = N.shape[0]
        z_up = N.new_tensor([0.0, 0.0, 1.0]).expand(R, 3)
        x_up = N.new_tensor([-1.0, 0.0, 0.0]).expand(R, 3)
        basis = _frame(N)

        V_l = _rows_apply(basis, V)
        V_stretch = normalize(torch.stack(
            [r1 * V_l[:, 0], r2 * V_l[:, 1], V_l[:, 2]], dim=-1))
        T1 = torch.where(V_stretch[:, 2:3] < 0.999,
                         normalize(torch.cross(V_stretch, z_up, dim=-1)),
                         x_up)
        T2 = normalize(torch.cross(T1, V_stretch, dim=-1))

        z = V_stretch[:, 2]
        a = torch.clamp(1.0 / torch.clamp(1.0 + z.detach(), min=1e-8),
                        max=1e4)
        r = torch.sqrt(u1)
        lower = u2 < a
        phi = torch.where(lower, u2 / a * math.pi,
                          (u2 - a) / (1 - a) * math.pi + math.pi)
        P1 = (r * safe_cos(phi))[:, None]
        P2 = (r * safe_sin(phi) * torch.where(lower, torch.ones_like(z),
                                              z))[:, None]
        N_stretch = (P1 * T1 + P2 * T2
                     + torch.sqrt(torch.clamp(1 - P1 * P1 - P2 * P2,
                                              min=EPS)) * V_stretch)
        H_l = normalize(torch.stack([N_stretch[:, 0] * r1,
                                     N_stretch[:, 1] * r2,
                                     N_stretch[:, 2]], dim=-1))
        _, L = _reflect(V, H_l, basis, N)
        return L, basis, _log_pdf(self, L, V, H_l, basis, r1, r2)

    def compute_prob(self, dir_in, dir_out, halfvec, r1, r2):
        """VNDF pdf D G1(out) / (4 n.out) in the local frame, 0 below the
        horizon. Returns (R,)."""
        r1 = r1.reshape(-1)
        r2c = torch.clamp(r1, min=EPS)
        r1c = torch.clamp((r1 + r2c) / 2, min=EPS)
        Lambda = (-1 + torch.sqrt(torch.clamp(
            1 + ((dir_out[:, 0] * r1c) ** 2 + (dir_out[:, 1] * r2c) ** 2)
            / torch.clamp(dir_out[:, 2] ** 2, min=1e-6), min=EPS))) / 2
        invG = 1 + Lambda
        invD = (math.pi * r1c * r2c
                * (halfvec[:, 0] ** 2 / r1c ** 2
                   + halfvec[:, 1] ** 2 / r2c ** 2
                   + halfvec[:, 2] ** 2) ** 2)
        logD = (-torch.log(torch.clamp(invG * invD, min=EPS))
                - torch.log(torch.clamp(4 * dir_out[..., 2], min=EPS)))
        prob = torch.exp(logD)
        return torch.where(dir_in[:, 2] > 0, prob, torch.zeros_like(prob))


class SGGXSampler:
    """SGGX microflake sampler (Heitz et al. 2015) with the surface-like
    diagonal S = diag(r^2, r^2, 1) in the shading frame: visible normals
    from the projected ellipse around the view direction."""

    def sample(self, u1, u2, V, N, r1, r2=None):
        basis = _frame(N)
        V_l = _rows_apply(basis, V)
        sxx = torch.clamp(r1, min=1e-3) ** 2
        szz = torch.ones_like(sxx)
        wk_raw = torch.cross(V_l, V_l.new_tensor([0.0, 0.0, 1.0]).expand(
            V_l.shape), dim=-1)
        wk = normalize(torch.where(
            V_l[:, 2:3].abs() < 0.999, wk_raw,
            V_l.new_tensor([1.0, 0.0, 0.0]).expand(V_l.shape)))
        wj = normalize(torch.cross(wk, V_l, dim=-1))
        wi = V_l

        def s_dot(a, b):
            return (sxx * (a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1])
                    + szz * a[:, 2] * b[:, 2])

        Skk = torch.clamp(s_dot(wk, wk), min=EPS)
        Skj = s_dot(wk, wj)
        Ski = s_dot(wk, wi)
        Sjj = torch.clamp(s_dot(wj, wj), min=EPS)
        Sji = s_dot(wj, wi)
        Sii = torch.clamp(s_dot(wi, wi), min=EPS)
        tmp = torch.sqrt(torch.clamp(Sjj * Sii - Sji ** 2, min=EPS))
        inv_sqrt_Sii = 1.0 / torch.sqrt(Sii)
        det = torch.clamp(Skk * Sjj * Sii - Skk * Sji ** 2 - Skj ** 2 * Sii
                          + 2 * Skj * Sji * Ski - Ski ** 2 * Sjj, min=EPS)
        zero = torch.zeros_like(Skk)
        Mk = torch.stack([torch.sqrt(det / (Sjj * Sii - Sji ** 2 + EPS)),
                          zero, zero], -1)
        Mj = torch.stack([-inv_sqrt_Sii * (Skj * Sii - Ski * Sji) / tmp,
                          inv_sqrt_Sii * tmp, zero], -1)
        Mi = torch.stack([inv_sqrt_Sii * Ski, inv_sqrt_Sii * Sji,
                          inv_sqrt_Sii * Sii], -1)
        r = torch.sqrt(u1)
        phi = 2 * math.pi * u2
        uu = r * torch.cos(phi)
        vv = r * torch.sin(phi)
        ww = torch.sqrt(torch.clamp(1 - uu ** 2 - vv ** 2, min=0))
        H_vis = uu[:, None] * Mk + vv[:, None] * Mj + ww[:, None] * Mi
        H_l = normalize(H_vis[:, 0:1] * wk + H_vis[:, 1:2] * wj
                        + H_vis[:, 2:3] * wi)
        _, L = _reflect(V, H_l, basis, N)
        return L, basis, _log_pdf(self, L, V, H_l, basis, r1, r2)

    def compute_prob(self, dir_in, dir_out, halfvec, r1, r2):
        """The SGGX NDF's pdf of the reflected direction. Returns (R,)."""
        sxx = torch.clamp(r1.reshape(-1), min=1e-3) ** 2
        quad = torch.clamp((halfvec[:, 0] ** 2 + halfvec[:, 1] ** 2) / sxx
                           + halfvec[:, 2] ** 2, min=EPS)
        D = 1.0 / (math.pi * torch.sqrt(sxx * sxx) * quad ** 2)
        o = dir_out
        sigma_o = torch.sqrt(torch.clamp(
            sxx * (o[:, 0] ** 2 + o[:, 1] ** 2) + o[:, 2] ** 2, min=EPS))
        VdotH = torch.clamp((dir_out * halfvec).sum(-1), min=EPS)
        return _below_horizon_zero(dir_in, D * VdotH / sigma_o / (4 * VdotH))


class BeckmannSampler:
    """Beckmann NDF importance sampler: theta_h = atan(sqrt(-a^2 ln(1 -
    u1)))."""

    def sample(self, u1, u2, V, N, r1, r2=None):
        basis = _frame(N)
        a2 = torch.clamp(r1, min=1e-3) ** 2
        tan2 = -a2 * torch.log(torch.clamp(1 - u1, min=1e-8))
        cos_t = 1.0 / torch.sqrt(1 + tan2)
        sin_t = torch.sqrt(torch.clamp(1 - cos_t ** 2, min=0))
        phi = 2 * math.pi * u2
        H_l = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                           cos_t], dim=-1)
        _, L = _reflect(V, H_l, basis, N)
        return L, basis, _log_pdf(self, L, V, H_l, basis, r1, r2)

    def compute_prob(self, dir_in, dir_out, halfvec, r1, r2):
        a2 = torch.clamp(r1.reshape(-1), min=1e-3) ** 2
        cos_h = torch.clamp(halfvec[:, 2], EPS, 1)
        tan2 = (1 - cos_h ** 2) / torch.clamp(cos_h ** 2, min=EPS)
        D = torch.exp(-tan2 / a2) / (math.pi * a2 * cos_h ** 4)
        VdotH = torch.clamp((dir_out * halfvec).sum(-1), min=EPS)
        return _below_horizon_zero(dir_in, D * cos_h / (4 * VdotH))


class CosineLobeSampler:
    """Cosine-weighted hemisphere sampler."""

    def sample(self, u1, u2, V, N, r1, r2=None):
        basis = _frame(N)
        r = torch.sqrt(u1)
        phi = 2 * math.pi * u2
        local = torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                             torch.sqrt(torch.clamp(1 - u1, min=EPS))],
                            dim=-1)
        L = torch.einsum("rji,rj->ri", basis, local)
        logD = torch.log(torch.clamp(local[:, 2] / math.pi, min=EPS))
        return L, basis, logD

    def compute_prob(self, dir_in, dir_out, halfvec, r1, r2):
        return _below_horizon_zero(dir_in, dir_in[:, 2] / math.pi)


class MultiSampler:
    """Two lobes: even slots from ``sampler_a`` (GGX), odd ones from
    ``sampler_b`` (the cosine lobe); the pdf is the mean of the two."""

    def __init__(self, sampler_a=None, sampler_b=None):
        self.sampler_a = GGXSampler() if sampler_a is None else sampler_a
        self.sampler_b = CosineLobeSampler() if sampler_b is None \
            else sampler_b

    def sample(self, u1, u2, V, N, r1, r2=None):
        La, basis, _ = self.sampler_a.sample(u1, u2, V, N, r1, r2)
        Lb, _, _ = self.sampler_b.sample(u1, u2, V, N, r1, r2)
        pick_a = (torch.arange(La.shape[0], device=La.device) % 2) == 0
        L = torch.where(pick_a[:, None], La, Lb)
        H_l = _rows_apply(basis, normalize(V + L))
        return L, basis, _log_pdf(self, L, V, H_l, basis, r1, r2)

    def compute_prob(self, dir_in, dir_out, halfvec, r1, r2):
        pa = self.sampler_a.compute_prob(dir_in, dir_out, halfvec, r1, r2)
        pb = self.sampler_b.compute_prob(dir_in, dir_out, halfvec, r1, r2)
        return (pa.reshape(-1) + pb.reshape(-1)) / 2
