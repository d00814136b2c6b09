"""Visualize learned BRDF lobes as equirect images (the port's
``nmf_tpu/scripts/graph_brdfs.py``).

For a set of surface points and view directions, evaluate brdf_weight x
pdf over an equirect grid of incoming directions in the surface's frame
(normal +z), and tile the results into one image, marking the view
direction in green.
"""
import math

import torch

from ..ops.safemath import normalize


@torch.no_grad()
def graph_brdfs(model, xyzs, viewdirs, app_features, res=64):
    """model: Microfacet; xyzs (F, 4); viewdirs (V, 3); app_features (F, D),
    on one device. Returns an image (F*res, 2*V*res, 3): row block f, column
    block v is the lobe of point f seen from view v, over elevation (rows,
    -pi/2 to pi/2) and azimuth (columns, 0 to 2 pi)."""
    dev = xyzs.device
    ele = torch.linspace(-math.pi / 2, math.pi / 2, res, device=dev)
    azi = torch.linspace(0, 2 * math.pi, 2 * res, device=dev)
    eg, ag = torch.meshgrid(ele, azi, indexing="ij")
    ang_vecs = torch.stack([
        -torch.sin(eg),
        torch.cos(eg) * torch.sin(ag),
        torch.cos(eg) * torch.cos(ag)], dim=-1).reshape(-1, 3)

    F = xyzs.shape[0]
    V = viewdirs.shape[0]
    A = ang_vecs.shape[0]

    _, _, matprop = model.diffuse_module(xyzs, viewdirs, app_features,
                                         std=0.0)
    r1 = matprop["r1"][:, 0]

    # expand to (F*V*A,)
    L = ang_vecs[None, None].expand(F, V, A, 3).reshape(-1, 3)
    eV = viewdirs[None, :, None].expand(F, V, A, 3).reshape(-1, 3)
    eN = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(F * V * A, 3)
    H = normalize((L + eV) / 2)
    feats = app_features[:, None, None].expand(
        F, V, A, app_features.shape[-1]).reshape(F * V * A, -1)
    er1 = r1[:, None, None].expand(F, V, A).reshape(-1)

    brdf_weight = model.brdf(eV, L, eN, H, eV, H, L, feats, er1, er1)
    pdf = model.brdf_sampler.compute_prob(L, eV, H, er1, er1).reshape(-1, 1)
    colors = (pdf * brdf_weight).reshape(F * V, A, 3)

    # mark the view direction in green
    vd_ind = torch.argmax((L * eV).sum(-1).reshape(F * V, A), dim=1)
    colors[torch.arange(F * V, device=dev), vd_ind] = torch.tensor(
        [0.0, 1.0, 0.0], device=dev, dtype=colors.dtype)

    im = colors.reshape(F, V, res, 2 * res, 3)
    return im.permute(0, 2, 1, 3, 4).reshape(F * res, 2 * V * res, 3)
