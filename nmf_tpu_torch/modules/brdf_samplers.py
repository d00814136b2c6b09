"""GGX importance sampling of bounce rays
(``nmf_tpu/modules/brdf_samplers.py``): Hammersley draws with a random
toroidal offset, and Heitz 2018 VNDF sampling with its pdf."""
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
        up = torch.where(N[:, 2:3].abs() < 0.999, z_up, x_up)
        tangent = normalize(torch.cross(up, N, dim=-1))
        bitangent = normalize(torch.cross(N, tangent, dim=-1))
        basis = torch.stack([tangent, bitangent, N], dim=1)

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
        H = torch.einsum("rji,rj->ri", basis, H_l)

        L = normalize(2.0 * (V * H).sum(-1, keepdim=True) * H - V)
        sign = torch.where((L * N).sum(-1, keepdim=True) > 0, 1.0, -1.0)
        L = L * sign

        L_l = _rows_apply(basis, L)
        logD = torch.log(torch.clamp(
            self.compute_prob(L_l, V_l, H_l, r1, r2), min=EPS)).detach()
        return L, basis, logD

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
