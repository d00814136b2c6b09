"""Streaming evaluation render (``nmf_tpu/render_streaming.py``): every
ray marched in blocks of ``block`` samples until its transmittance is
spent, for memory-bounded evaluation of local-shading models.

nmf_tpu carries (T, rgb, depth, acc) through a ``lax.while_loop``; here the
loop runs on the host, one block at a time, and stops once every ray's
transmittance is at most ``t_thresh``, which it checks once a block (one
host sync a block). A block's weights, rgb, acc and depth come from the
composite kernel K1 in full mode (``composite_rays``), scaled by the
transmittance T carried into the block: K1's recurrence ``w = alpha * T``,
``T *= 1 - alpha + 1e-10`` is the block recurrence of nmf_tpu's loop, so
the blocks chain to the weights of one march. The carried T is the product
of ``1 - alpha + 1e-10`` over the block.

Only local-shading models stream (tensorf, refnerf: radiance is a
function of the sample alone); they read no weights, so the shading runs
before K1 composites the block. The microfacet model and the DualModel
raise ``ValueError``, as in nmf_tpu.
"""
import math

import torch

from .ops.draws import Draws
from .ops.kernels.composite import composite_rays
from .ops.tonemap import get_tonemap


@torch.no_grad()
def render_streaming(nmf, rays, block: int = 64, t_thresh: float = 1e-4):
    """Render rays (B, 6) block by block, tonemapped and composited on
    white as nmf_tpu's defaults -> (images {rgb_map, acc_map, depth}
    (B, ...), stats {blocks: the blocks marched})."""
    if hasattr(nmf.model, "brdf") or hasattr(nmf.model, "model1"):
        raise ValueError(
            "render_streaming supports local-shading models only "
            "(tensorf/refnerf); the microfacet model needs the full "
            "transmittance field to budget bounce rays")
    rf, sampler = nmf.rf, nmf.sampler
    near, far = sampler.near_far
    stepsize = float(sampler.live_stepsize)
    n_blocks = max(-(-int(math.ceil((far - near) / stepsize)) // block), 1)

    B = rays.shape[0]
    dev = rays.device
    o, d = rays[:, 0:3], rays[:, 3:6]
    vec = torch.where(d == 0, torch.full_like(d, 1e-6), d)
    ra = (rf.aabb[1] - o) / vec
    rb = (rf.aabb[0] - o) / vec
    t_min = torch.clamp(torch.minimum(ra, rb).amax(-1), near, far)

    needs_normals = nmf.model.needs_normals(0)
    mask_grid = (sampler.alpha_mask
                 if getattr(sampler, "enable_alpha_mask", False) else None)
    viewdirs = d[:, None].expand(B, block, 3).reshape(-1, 3)
    dists = torch.full((B, block), stepsize * rf.distance_scale, device=dev)
    T = torch.ones((B,), device=dev)
    rgb_acc = torch.zeros((B, 3), device=dev)
    depth_acc = torch.zeros((B,), device=dev)
    acc = torch.zeros((B,), device=dev)
    i = 0
    while i < n_blocks and bool((T > t_thresh).any()):
        offs = i * block + torch.arange(block, dtype=torch.float32,
                                        device=dev)
        z = t_min[:, None] + stepsize * offs[None, :]
        pts = o[:, None] + d[:, None] * z[..., None]
        mask = ((pts >= rf.aabb[0]) & (pts <= rf.aabb[1])).all(-1)
        mask &= (T > t_thresh)[:, None]
        if mask_grid is not None:
            mask &= mask_grid.sample_alpha(pts) > 0
        # footprint z / focal, focal 1 as every render of nmf_tpu passes
        xyz = torch.cat([pts, z[..., None]], -1).reshape(-1, 4)
        sigma = rf.compute_densityfeature(xyz).reshape(B, block)
        sigma = torch.where(mask, sigma, torch.zeros_like(sigma))
        app = rf.compute_appfeature(xyz)
        normals = (rf.compute_normals(xyz) if needs_normals
                   else torch.zeros((B * block, 3), device=dev))
        rgb_s, _ = nmf.model.shade(
            xyz, rf.normalize_coord(xyz), app, viewdirs, normals, None,
            mask.reshape(-1), B, render_reflection=None,
            bg_module=nmf.bg_module, bg_cache=None, is_train=False, recur=0,
            draws=Draws())
        _, rgb_b, acc_b, depth_b = composite_rays(
            sigma, dists, rgb_s.reshape(B, block, 3), z)
        rgb_acc += T[:, None] * rgb_b
        depth_acc += T * depth_b
        acc += T * acc_b
        alpha = 1.0 - torch.exp(-sigma * dists)
        T = T * torch.prod(1.0 - alpha + 1e-10, dim=1)
        i += 1

    tm_fn = get_tonemap(nmf.tonemap)
    rgb_map = tm_fn(rgb_acc, noclip=nmf.hdr) + (1 - acc[..., None])
    return ({"rgb_map": rgb_map, "acc_map": acc, "depth": depth_acc},
            {"blocks": i})
