"""Occupancy-grid sampler with EMA density updates
(``nmf_tpu/samplers/occgrid.py``, the sampler that nmf_tpu maps the
upstream NerfAcc / Raymarcher / ContinuousAlphagrid samplers onto).

The grid is a dense (G, G, G) buffer of the module, indexed [x, y, z],
holding an exponential moving maximum of the field's density at the cell
centres; a cell is occupied while its value exceeds
``min(mean, density_thresh)``. The march is uniform from the box entry,
jittered per step in training, culled by a nearest-cell occupancy lookup,
with the conical-frustum footprint in the 4th channel, and compacted to
the first K valid samples a ray as the alpha-grid sampler's single-level
march is (``alphagrid.compact_samples``). ``sample_ndc`` marches linear
steps in [near, far] for NDC rays.

Schedule events update the module in place: every ``update_freq``
iterations the density sweep, and ``get_bounds`` gives the box of the
occupied cells for the field's ``shrink`` at ``shrink_iters``.
"""
import math

import numpy as np
import torch
import torch.nn as nn

from .alphagrid import DENSE_CHUNK_POINTS, compact_samples, march_ndc


def conical_frustum_radius(z0, z1, base_radius):
    """Mean-projected Gaussian radius of a conical frustum segment
    [z0, z1] (mip-NeRF eq. 7), scaled by ``base_radius``."""
    mu = (z0 + z1) / 2
    hw = (z1 - z0) / 2
    denom = torch.clamp(3 * mu ** 2 + hw ** 2, min=1e-10)
    r_var = base_radius ** 2 * (
        (mu ** 2) / 4 + (5 / 12) * hw ** 2 - (4 / 15) * hw ** 4 / denom)
    return torch.sqrt(torch.clamp(r_var, min=1e-12))


class OccGridSampler(nn.Module):
    def __init__(self, aabb, grid_reso=128, near_far=(2.0, 6.0),
                 update_freq=16, ema_decay=0.95, density_thresh=0.01,
                 multiplier=1, shrink_iters=(), test_multiplier=1.0):
        super().__init__()
        self.register_buffer("aabb", torch.as_tensor(aabb,
                                                     dtype=torch.float32))
        self.register_buffer("density_grid",
                             torch.zeros((int(grid_reso),) * 3))
        self.grid_reso = int(grid_reso)
        self.near_far = tuple(float(x) for x in near_far)
        self.update_freq = int(update_freq)
        self.ema_decay = float(ema_decay)
        self.density_thresh = float(density_thresh)
        self.multiplier = int(multiplier)
        self.shrink_iters = tuple(int(i) for i in shrink_iters)
        self.test_multiplier = float(test_multiplier)
        self.stepsize = 0.01
        self.n_samples = 440

    @property
    def live_stepsize(self):
        """The march step (the render layer's name, shared with the
        alpha-grid sampler; this sampler has no fixed-shape mode)."""
        return self.stepsize

    # ------------------------------------------------------------------
    def update(self, rf, init: bool = False):
        """Adopt the field's box and step (``multiplier`` x its steps at
        1 / ``multiplier`` its step size), then run the density sweep. At
        init a grid of another resolution restarts from zeros."""
        self.aabb = rf.aabb.detach().clone()
        self.n_samples = rf.n_samples * self.multiplier
        self.stepsize = rf.stepsize / self.multiplier
        if init and self.density_grid.shape[0] != self.grid_reso:
            self.density_grid = torch.zeros((self.grid_reso,) * 3,
                                            device=self.aabb.device)
        self.update_density(rf)
        return self

    def check_schedule(self, iteration: int, rf) -> bool:
        """The density sweep every ``update_freq`` iterations; never asks
        for an optimizer rebuild."""
        if iteration % self.update_freq == 0 and iteration > 0:
            self.update_density(rf)
        return False

    @torch.no_grad()
    def update_density(self, rf):
        """grid <- max(grid * ema_decay, density at the cell centres), the
        centres swept in groups of x-slabs of at most DENSE_CHUNK_POINTS."""
        G = self.density_grid.shape[0]
        lin = (torch.arange(G, device=self.aabb.device) + 0.5) / G
        unit = torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"),
                           dim=-1)
        xyz = self.aabb[0] * (1 - unit) + self.aabb[1] * unit
        step = max(1, DENSE_CHUNK_POINTS // (G * G))
        sigma = torch.cat([
            rf.compute_densityfeature(xyz[i:i + step].reshape(-1, 3))
            for i in range(0, G, step)]).reshape((G,) * 3)
        self.density_grid = torch.maximum(self.density_grid * self.ema_decay,
                                          sigma)

    def occupancy(self):
        thresh = torch.clamp(self.density_grid.mean(),
                             max=self.density_thresh)
        return self.density_grid > thresh

    def get_bounds(self):
        """Box (2, 3) of the occupied cells, one cell of margin on each
        side, within the sampler's box; the box itself when no cell is
        occupied. Host side (numpy): it runs at ``shrink_iters`` only."""
        G = self.density_grid.shape[0]
        occ = self.occupancy().cpu().numpy()
        aabb = self.aabb.detach().cpu().numpy()
        if not occ.any():
            return aabb
        idx = np.stack(np.nonzero(occ), -1)
        cell = (aabb[1] - aabb[0]) / G
        lo = aabb[0] + idx.min(0) * cell - 0.5 * cell
        hi = aabb[0] + (idx.max(0) + 1) * cell + 0.5 * cell
        return np.stack([np.maximum(lo, aabb[0]), np.minimum(hi, aabb[1])])

    def occupied_at(self, xyz):
        """Nearest-cell occupancy of world points (..., 3): the cell
        ``trunc(unit * G)``, clamped to the grid."""
        G = self.density_grid.shape[0]
        occ = self.occupancy()
        unit = (xyz - self.aabb[0]) / (self.aabb[1] - self.aabb[0])
        idx = (unit * G).long().clamp(0, G - 1)
        return occ[idx[..., 0], idx[..., 1], idx[..., 2]]

    @torch.no_grad()
    def mark_untrained_grid(self, poses, intrinsic, img_wh):
        """Set to -1 the cells whose centre no training camera sees
        (``poses``: (P, 3/4, 4) camera-to-world, OpenCV axes, +z forward;
        ``intrinsic``: fx at [0][0], fy at [1][1]; ``img_wh``: (W, H))."""
        G = self.density_grid.shape[0]
        lin = (np.arange(G) + 0.5) / G
        unit = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"),
                        -1).reshape(-1, 3)
        aabb = self.aabb.detach().cpu().numpy()
        xyz = aabb[0] * (1 - unit) + aabb[1] * unit
        fx, fy = intrinsic[0][0], intrinsic[1][1]
        W, H = img_wh
        seen = np.zeros(xyz.shape[0], bool)
        for pose in np.asarray(poses):
            R, t = pose[:3, :3], pose[:3, 3]
            cam = (xyz - t) @ R
            z = cam[:, 2]
            with np.errstate(divide="ignore", invalid="ignore"):
                u = cam[:, 0] / z * fx + W / 2
                v = cam[:, 1] / z * fy + H / 2
            seen |= (z > 0) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        mask = torch.from_numpy(seen.reshape((G,) * 3)).to(
            self.density_grid.device)
        self.density_grid = torch.where(
            mask, self.density_grid, torch.full_like(self.density_grid, -1))

    # ------------------------------------------------------------------
    def n_steps(self, stepmul: float = 1.0) -> int:
        """March steps N of a training pass with step multiplier
        ``stepmul`` (an NDC pass marches ``n_samples``)."""
        return int(self.n_samples * stepmul)

    def _in_box(self, p):
        return ((p >= self.aabb[0]) & (p <= self.aabb[1])).all(dim=-1)

    def sample_ndc(self, rays, is_train=False, jitter=None,
                   max_samples_per_ray: int = -1):
        """NDC rays (B, 6): ``n_samples`` linear steps in [near, far],
        jittered by ``jitter`` (B, n_samples) U[0, 1) draws of a step in
        training; valid inside the box and an occupied cell; dists scaled
        by |rays_d|; footprint z (focal 1)."""
        pts, z_vals, dists = march_ndc(rays, self.near_far, self.n_samples,
                                       is_train, jitter)
        valid = self._in_box(pts) & self.occupied_at(pts)
        return compact_samples(pts, z_vals[..., None], z_vals, dists, valid,
                               max_samples_per_ray)

    def sample(self, rays, is_train=False, jitter=None,
               max_samples_per_ray: int = -1, override_near=None,
               stepmul: float = 1.0):
        """rays: (B, 6) -> dict of xyz (B, K, 4) (world position + the
        conical-frustum radius, focal 1), z_vals, dists, valid (B, K).

        N = n_samples x stepmul steps of stepsize / stepmul from the box
        entry (clamped to [near, far]; a retrace pass starts at
        ``override_near``), at ``stepsize * (i + jitter)`` in training,
        ``jitter`` (B, N) U[0, 1) draws; at evaluation the step count and
        step size are further scaled by ``test_multiplier``.
        """
        if not is_train:
            stepmul *= self.test_multiplier
        N = int(self.n_samples * stepmul)
        near, far = self.near_far
        if override_near is not None:
            near = override_near
        rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
        dev = rays.device

        vec = torch.where(rays_d == 0, torch.full_like(rays_d, 1e-6), rays_d)
        rate_a = (self.aabb[1] - rays_o) / vec
        rate_b = (self.aabb[0] - rays_o) / vec
        t_min = torch.minimum(torch.maximum(
            torch.minimum(rate_a, rate_b).amax(-1),
            torch.as_tensor(near, dtype=torch.float32, device=dev)),
            torch.as_tensor(far, dtype=torch.float32, device=dev))

        stepsize = self.stepsize / stepmul
        steps = torch.arange(N, dtype=torch.float32, device=dev)[None]
        if is_train:
            steps = steps + jitter
        z_vals = t_min[:, None] + stepsize * steps
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
        valid = self._in_box(pts) & self.occupied_at(pts)
        size = conical_frustum_radius(z_vals, z_vals + stepsize,
                                      1.0 / math.sqrt(3.0))[..., None]
        dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1],
                           z_vals.new_zeros((rays.shape[0], 1))], dim=-1)
        return compact_samples(pts, size, z_vals, dists, valid,
                               max_samples_per_ray)


def init_occgrid(rf, grid_reso=128, **kwargs):
    """An occupancy-grid sampler over the field's box, swept once."""
    return OccGridSampler(rf.aabb.detach().cpu(), grid_reso=grid_reso,
                          **kwargs).to(rf.aabb.device).update(rf, init=True)
