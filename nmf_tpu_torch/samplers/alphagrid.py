"""Uniform-stepping ray sampler with dense alpha-mask culling
(``nmf_tpu/samplers/alphagrid.py``).

Output is a padded, static-shape (B, K) set of samples with a validity
mask: the first K valid samples of the N march steps of each ray, chosen by
a stable sort (``ops.masked.compact_topk``). When K divides by the
superstep S = 4 and K < N the two-level march runs: one lookup of an
extra-dilated coarse mask per superstep of S steps, compaction to K // S
supersteps, expansion, then the fine mask test. Training marches draw
cumulative jittered steps (nmf_tpu's ``cumrand``, which every config
uses).

The sampler is an ``nn.Module`` whose alpha volumes and boxes are buffers;
schedule events update it in place.
"""
import numpy as np
import torch
import torch.nn as nn

from ..ops.grid_sample import grid_sample_3d, max_pool_3d
from ..ops.masked import compact_topk, gather_rows

SUPERSTEP = 4
DENSE_CHUNK_POINTS = 1 << 21  # points per slab group of the mask rebuild


class AlphaGridMask(nn.Module):
    """Dense binarized alpha volume (D, H, W), indexed [z, y, x], and the
    same volume dilated by a superstep's extent (``coarse_volume``)."""

    def __init__(self, aabb, alpha_volume, coarse_volume):
        super().__init__()
        self.register_buffer("aabb", aabb.clone())
        self.register_buffer("alpha_volume", alpha_volume)
        self.register_buffer("coarse_volume", coarse_volume)

    def _unit(self, xyz):
        return (xyz[..., :3] - self.aabb[0]) / (self.aabb[1] - self.aabb[0])

    def sample_alpha(self, xyz, nearest=True):
        """World xyz (..., 3/4) -> alpha (...). ``nearest`` looks up the
        nearest cell (the volume is binary and dilated, so this matches the
        trilinear > 0 test to within one texel)."""
        if nearest:
            D, H, W = self.alpha_volume.shape
            unit = self._unit(xyz)
            iz = torch.round(unit[..., 2] * (D - 1)).long().clamp(0, D - 1)
            iy = torch.round(unit[..., 1] * (H - 1)).long().clamp(0, H - 1)
            ix = torch.round(unit[..., 0] * (W - 1)).long().clamp(0, W - 1)
            return self.alpha_volume[iz, iy, ix]
        coords = self._unit(xyz) * 2 - 1
        return grid_sample_3d(self.alpha_volume[None], coords)[..., 0]

    def sample_coarse(self, xyz):
        vol = self.coarse_volume
        D, H, W = vol.shape
        unit = torch.clamp(self._unit(xyz), 0.0, 1.0)
        iz = torch.round(unit[..., 2] * (D - 1)).long()
        iy = torch.round(unit[..., 1] * (H - 1)).long()
        ix = torch.round(unit[..., 0] * (W - 1)).long()
        return vol[iz, iy, ix]


class AlphaGridSampler(nn.Module):
    def __init__(self, aabb, near_far=(2.0, 6.0), enable_alpha_mask=True,
                 update_list=(), alpha_mask_thres=0.001, multiplier=1):
        super().__init__()
        self.register_buffer("aabb", torch.as_tensor(aabb,
                                                     dtype=torch.float32))
        self.alpha_mask = None
        self.near_far = tuple(float(x) for x in near_far)
        self.enable_alpha_mask = bool(enable_alpha_mask)
        self.update_list = tuple(update_list)
        self.alpha_mask_thres = float(alpha_mask_thres)
        self.multiplier = int(multiplier)
        self.stepsize = 0.01
        self.n_samples = 440

    # ------------------------------------------------------------------
    def update(self, rf, init: bool = False):
        """Adopt the field's geometry; unless ``init``, also rebuild the
        alpha mask. At init a missing mask becomes an all-occupied 32^3."""
        self.aabb = rf.aabb.detach().clone()
        self.n_samples = rf.n_samples * self.multiplier
        self.stepsize = rf.stepsize / self.multiplier
        if not init:
            self.update_alpha_mask(rf)
        elif self.alpha_mask is None:
            ones = torch.ones((32, 32, 32), device=self.aabb.device)
            self.alpha_mask = AlphaGridMask(self.aabb, ones, ones.clone())
        return self

    def check_schedule(self, iteration: int, rf) -> bool:
        if iteration in self.update_list:
            self.update(rf)
            return True
        return False

    def _coarse_dilate_radius(self, gs) -> int:
        """Cells of extra dilation so one lookup at a superstep midpoint
        covers the superstep's ray extent (cumrand steps reach 1.5 x the
        stepsize), plus half a cell of rounding."""
        aabb = self.aabb.detach().cpu().numpy().astype(np.float64)
        unit_min = float(((aabb[1] - aabb[0])
                          / (np.asarray(gs, np.float64) - 1)).min())
        return int(np.ceil(0.75 * SUPERSTEP * self.stepsize / unit_min
                           + 0.5))

    # ------------------------------------------------------------------
    @torch.no_grad()
    def compute_dense_alpha(self, rf, grid_size):
        """Alpha of every cell of a dense (X, Y, Z) grid, swept in groups of
        x-slabs of at most DENSE_CHUNK_POINTS points."""
        dev = self.aabb.device
        lin = [torch.linspace(0.0, 1.0, g, device=dev) for g in grid_size]
        samples = torch.stack(torch.meshgrid(*lin, indexing="ij"), dim=-1)
        xyz = self.aabb[0] * (1 - samples) + self.aabb[1] * samples
        X = grid_size[0]
        per_slab = int(grid_size[1]) * int(grid_size[2])
        step = max(1, DENSE_CHUNK_POINTS // per_slab)
        sigma = torch.cat([
            rf.compute_densityfeature(xyz[i:i + step].reshape(-1, 3))
            for i in range(0, X, step)]).reshape(tuple(grid_size))
        alpha = 1 - torch.exp(-sigma * self.stepsize)
        return alpha, xyz

    @torch.no_grad()
    def update_alpha_mask(self, rf):
        """Dense alpha + max-pool dilation + binarization -> new mask.
        Returns the box of the occupied cells (the caller may ignore it)."""
        gs = tuple(rf.grid_size)
        alpha, dense_xyz = self.compute_dense_alpha(rf, gs)
        alpha_t = torch.clamp(alpha, 0, 1).permute(2, 1, 0).contiguous()
        alpha_t = max_pool_3d(alpha_t, 3)
        alpha_bin = (alpha_t >= self.alpha_mask_thres).float()
        coarse = max_pool_3d(alpha_bin, 2 * self._coarse_dilate_radius(gs) + 1)
        self.alpha_mask = AlphaGridMask(self.aabb, alpha_bin, coarse)
        occupied = alpha_bin.permute(2, 1, 0) > 0.5
        if bool(occupied.any()):
            valid_xyz = dense_xyz[occupied]
            return torch.stack([valid_xyz.min(0)[0], valid_xyz.max(0)[0]])
        return self.aabb.clone()

    # ------------------------------------------------------------------
    def sample(self, rays, is_train=False, jitter=None, generator=None,
               max_samples_per_ray: int = -1):
        """rays: (B, 6) -> dict of xyz (B, K, 4) (world position + footprint
        z / focal, with focal 1 as every render of nmf_tpu passes), z_vals
        (B, K), dists (B, K), valid (B, K) bool.

        In training the march is jittered by U[0, 1) draws of shape (B, N):
        ``jitter`` if given, else drawn from ``generator``.
        """
        N = self.n_samples
        near, far = self.near_far
        rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
        B = rays.shape[0]
        dev = rays.device

        vec = torch.where(rays_d == 0, torch.full_like(rays_d, 1e-6), rays_d)
        rate_a = (self.aabb[1] - rays_o) / vec
        rate_b = (self.aabb[0] - rays_o) / vec
        t_min = torch.clamp(torch.minimum(rate_a, rate_b).amax(-1), near, far)

        stepsize = self.stepsize
        if is_train:
            if jitter is None:
                jitter = torch.rand((B, N), generator=generator, device=dev)
            step = torch.cumsum(jitter * stepsize + stepsize / 2, dim=1)
        else:
            step = stepsize * torch.arange(N, dtype=torch.float32,
                                           device=dev)[None].expand(B, N)
        z_vals = t_min[:, None] + step

        K = max_samples_per_ray
        if (0 < K < N and K % SUPERSTEP == 0 and self.enable_alpha_mask
                and self.alpha_mask is not None):
            return self._sample_two_level(rays_o, rays_d, z_vals, K)

        pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
        valid = self._in_box(pts)
        if self.alpha_mask is not None and self.enable_alpha_mask:
            valid = valid & (self.alpha_mask.sample_alpha(pts) > 0)
        size = z_vals[..., None]
        dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1],
                           z_vals.new_zeros((B, 1))], dim=-1)
        if 0 < K < N:
            packed = torch.cat([pts, size, z_vals[..., None],
                                dists[..., None], valid[..., None].float()],
                               dim=-1)
            idx, keep = compact_topk(valid, K)
            packed = gather_rows(packed, idx)
            xyz = packed[..., 0:4]
            z_vals = packed[..., 4]
            dists = packed[..., 5]
            valid = (packed[..., 6] > 0.5) & keep
        else:
            xyz = torch.cat([pts, size], dim=-1)
        return {"xyz": xyz, "z_vals": z_vals, "dists": dists, "valid": valid}

    def _in_box(self, p):
        return ((p >= self.aabb[0]) & (p <= self.aabb[1])).all(dim=-1)

    def _sample_two_level(self, rays_o, rays_d, z_vals, K: int):
        """One coarse-mask lookup per superstep of S steps, compaction of
        the passing supersteps to K // S, expansion to K samples. A kept
        sample keeps its distance to the next candidate step."""
        B, N = z_vals.shape
        S = SUPERSTEP
        NS = N // S
        Ks = K // S
        z = z_vals[:, :NS * S]
        dists_full = torch.cat([z[:, 1:] - z[:, :-1], z.new_zeros((B, 1))],
                               dim=-1)
        zs = z.reshape(B, NS, S)
        ds = dists_full.reshape(B, NS, S)

        def at(zv):
            return rays_o[:, None, :] + rays_d[:, None, :] * zv[..., None]

        z_mid = 0.5 * (zs[:, :, 0] + zs[:, :, -1])
        sup_valid = (self._in_box(at(zs[:, :, 0]))
                     | self._in_box(at(zs[:, :, -1])))
        sup_valid = sup_valid & (self.alpha_mask.sample_coarse(at(z_mid)) > 0)

        idx_s, keep_s = compact_topk(sup_valid, Ks)
        sel = gather_rows(torch.cat([zs, ds], dim=-1), idx_s)  # (B, Ks, 2S)
        z_f = sel[..., :S].reshape(B, K)
        d_f = sel[..., S:].reshape(B, K)
        pts = at(z_f)
        valid = (self._in_box(pts) & torch.repeat_interleave(keep_s, S, dim=1)
                 & (self.alpha_mask.sample_alpha(pts) > 0))
        xyz = torch.cat([pts, z_f[..., None]], dim=-1)
        return {"xyz": xyz, "z_vals": z_f, "dists": d_f, "valid": valid}
