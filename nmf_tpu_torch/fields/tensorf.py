"""TensoRF vector-matrix factorized radiance field (``nmf_tpu/fields/tensorf.py``).

``TensorVMSplit`` is an ``nn.Module``: its factor planes and lines and the
basis matrices are parameters, the scene box ``aabb`` is a buffer. The query
path gathers one quad-table row per (sample, plane) and one pair-table row
per (sample, line); the plane and line cotangents are accumulated by the
``binsum_rows`` kernel (``ops/grid_sample.TakeRows``).

Not in this slice: smoothed normals (``compute_normals``,
``compute_all(with_normals=True)``), ``fixed_shape`` padding, ``shrink``,
``dbasis``, and the TV / orthogonality regularizers.
"""
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.grid_sample import (line_interp, quad_gather_2d,
                               resize_align_corners_1d,
                               resize_align_corners_2d)
from ..utils import n_to_reso

# plane i holds axes MAT_MODE[i]; line i holds axis VEC_MODE[i]
MAT_MODE = ((0, 1), (0, 2), (1, 2))
VEC_MODE = (2, 1, 0)

GATHER_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


class FactorGrid(nn.Module):
    """One plane + line factor set: planes (C, H, W), lines (C, L)."""

    def __init__(self, planes, lines):
        super().__init__()
        self.planes = nn.ParameterList([nn.Parameter(p) for p in planes])
        self.lines = nn.ParameterList([nn.Parameter(l) for l in lines])

    @property
    def n_comp(self) -> int:
        return self.planes[0].shape[0]

    def query(self, coords):
        """coords: (..., 3) normalized to [-1, 1] -> list of 3 (..., C)
        factor products, gathered in the parameters' dtype."""
        feats = []
        for i in range(3):
            m0, m1 = MAT_MODE[i]
            plane, line = self.planes[i], self.lines[i]
            pc = quad_gather_2d(plane, torch.stack(
                [coords[..., m0], coords[..., m1]], dim=-1))
            lc = line_interp(line, coords[..., VEC_MODE[i]])
            feats.append(pc * lc)
        return feats


def init_factor_grid(generator, grid_size: int, n_comp: int, init_mode: str,
                     init_val: float):
    """Initial planes N(0, init_val^2) (C, G, G) and lines (C, G): the
    'rand' mode of nmf_tpu's ``init_factor_grid``, the one every shipped
    config uses."""
    if init_mode != "rand":
        raise NotImplementedError(f"field.init_mode={init_mode!r} is not "
                                  "ported yet (only 'rand')")
    planes = [init_val * torch.randn((n_comp, grid_size, grid_size),
                                     generator=generator) for _ in range(3)]
    lines = [init_val * torch.randn((n_comp, grid_size), generator=generator)
             for _ in range(3)]
    return FactorGrid(planes, lines)


class TensorVMSplit(nn.Module):
    """Split density/appearance VM field."""

    def __init__(self, density_rf, app_rf, basis_mat, dbasis_mat, aabb,
                 grid_size, app_dim=24, activation="softplus",
                 density_shift=-4.0, distance_scale=25.0, step_ratio=0.5,
                 gather_dtype="bf16", n_voxel_list=(), upsamp_list=(),
                 lr=0.02, lr_net=1e-3):
        super().__init__()
        self.density_rf = density_rf
        self.app_rf = app_rf
        self.basis_mat = nn.Parameter(basis_mat)
        self.dbasis_mat = nn.Parameter(dbasis_mat)  # unused: dbasis=False
        self.register_buffer("aabb", torch.as_tensor(aabb, dtype=torch.float32))
        self.grid_size = tuple(int(g) for g in grid_size)
        self.app_dim = app_dim
        if activation != "softplus":
            raise NotImplementedError(f"field.activation={activation!r} is "
                                      "not ported yet (only softplus)")
        self.density_shift = float(density_shift)
        self.distance_scale = float(distance_scale)
        self.step_ratio = float(step_ratio)
        if gather_dtype not in GATHER_DTYPES:
            raise ValueError(f"gather_dtype must be one of "
                             f"{sorted(GATHER_DTYPES)}, got {gather_dtype!r}")
        self.gather_dtype = gather_dtype
        self.n_voxel_list = tuple(n_voxel_list)
        self.upsamp_list = tuple(upsamp_list)
        self.lr = float(lr)
        self.lr_net = float(lr_net)

    # ---- geometry (host-side python floats) ----
    def _aabb_np(self):
        return self.aabb.detach().cpu().numpy().astype(np.float64)

    @property
    def stepsize(self) -> float:
        aabb = self._aabb_np()
        units = (aabb[1] - aabb[0]) / (np.asarray(self.grid_size,
                                                  np.float64) - 1)
        return float(units.min() * self.step_ratio)

    @property
    def aabb_diag(self) -> float:
        aabb = self._aabb_np()
        return float(np.linalg.norm(aabb[1] - aabb[0]))

    @property
    def n_samples(self) -> int:
        return int(self.aabb_diag / self.stepsize) + 1

    # ---- queries ----
    def normalize_coord(self, xyz):
        """World xyz (..., 3 or 4; a trailing 4th channel passes through)
        -> normalized [-1, 1]."""
        aabb_size = self.aabb[1] - self.aabb[0]
        coords = (xyz[..., :3] - self.aabb[0]) * (2.0 / aabb_size) - 1
        return torch.cat([coords, xyz[..., 3:]], dim=-1)

    def feature2density(self, feat):
        return F.softplus(torch.clamp(feat, -15, 1e3) + self.density_shift)

    @staticmethod
    def _contract_density(feats):
        return sum(f.sum(dim=-1) for f in feats)

    def compute_densityfeature(self, xyz):
        """World xyz (..., 3/4) -> density (...), gathered in f32."""
        coords = self.normalize_coord(xyz)[..., :3]
        return self.feature2density(
            self._contract_density(self.density_rf.query(coords)))

    def compute_appfeature(self, xyz):
        coords = self.normalize_coord(xyz)[..., :3]
        return torch.cat(self.app_rf.query(coords), dim=-1) @ self.basis_mat

    def compute_all(self, xyz, with_normals=False):
        """(density, app_features, None) from ONE gathered row per factor:
        the density and appearance tables are concatenated channel-wise."""
        if with_normals:
            raise NotImplementedError(
                "smoothed field normals are not ported yet (microfacet slice)")
        coords = self.normalize_coord(xyz)[..., :3]
        d_rf, a_rf = self.density_rf, self.app_rf
        Cd = d_rf.n_comp
        gd = GATHER_DTYPES[self.gather_dtype]
        d_feats, a_feats = [], []
        for i in range(3):
            m0, m1 = MAT_MODE[i]
            plane = torch.cat([d_rf.planes[i], a_rf.planes[i]]).to(gd)
            line = torch.cat([d_rf.lines[i], a_rf.lines[i]]).to(gd)
            pc = quad_gather_2d(plane, torch.stack(
                [coords[..., m0], coords[..., m1]], dim=-1))
            lc = line_interp(line, coords[..., VEC_MODE[i]])
            d_feats.append(pc[..., :Cd] * lc[..., :Cd])
            a_feats.append(pc[..., Cd:] * lc[..., Cd:])
        sigma = self.feature2density(self._contract_density(d_feats))
        app = torch.cat(a_feats, dim=-1) @ self.basis_mat
        return sigma, app, None

    # ---- regularizers ----
    def density_L1(self):
        total = 0.0
        for i in range(3):
            total = (total + self.density_rf.planes[i].abs().mean()
                     + self.density_rf.lines[i].abs().mean())
        return total

    # ---- schedule events (host side, in place) ----
    def check_schedule(self, iteration: int) -> bool:
        if iteration in self.upsamp_list:
            n_voxels = self.n_voxel_list[self.upsamp_list.index(iteration)]
            self.upsample(n_to_reso(n_voxels, self._aabb_np()))
            return True
        return False

    @torch.no_grad()
    def upsample(self, res_target):
        """Resample every plane and line to ``res_target`` (align_corners
        bilinear); the parameters are replaced, so the optimizer must be
        rebuilt."""
        for fg in (self.density_rf, self.app_rf):
            for i in range(3):
                m0, m1 = MAT_MODE[i]
                fg.planes[i] = nn.Parameter(resize_align_corners_2d(
                    fg.planes[i], (int(res_target[m1]), int(res_target[m0]))))
                fg.lines[i] = nn.Parameter(resize_align_corners_1d(
                    fg.lines[i], int(res_target[VEC_MODE[i]])))
        self.grid_size = tuple(int(r) for r in res_target)


def init_tensorvm_split(generator, aabb, density_n_comp=16,
                        appearance_n_comp=24, app_dim=24, grid_size=None,
                        N_voxel_init=128 ** 3, N_voxel_final=300 ** 3,
                        upsamp_list=(500, 1000, 2000, 3000, 4000, 5500, 7000),
                        init_mode="rand", d_init_val=0.1, app_init_val=0.1,
                        **kwargs):
    """Build a TensorVMSplit (nmf_tpu's ``init_tensorvm_split``): square
    planes of the first axis' resolution, torch-Linear-style uniform basis
    matrices, the voxel schedule's resolutions."""
    aabb = np.asarray(aabb, np.float32)
    if grid_size is None:
        grid_size = n_to_reso(N_voxel_init, aabb)
    gsize = int(grid_size[0])
    density_rf = init_factor_grid(generator, gsize, density_n_comp, init_mode,
                                  d_init_val)
    app_rf = init_factor_grid(generator, gsize, appearance_n_comp, init_mode,
                              app_init_val)
    bound_b = 1.0 / math.sqrt(3 * appearance_n_comp)
    basis_mat = (torch.rand((3 * appearance_n_comp, app_dim),
                            generator=generator) * 2 - 1) * bound_b
    bound_d = 1.0 / math.sqrt(3 * density_n_comp)
    dbasis_mat = (torch.rand((3 * density_n_comp, 1), generator=generator)
                  * 2 - 1) * bound_d
    n_voxel_list = tuple(
        int(round(v)) for v in (np.round(np.linspace(
            N_voxel_init ** (1 / 3), N_voxel_final ** (1 / 3),
            len(upsamp_list) + 1) ** 3)).tolist()[1:])
    return TensorVMSplit(density_rf, app_rf, basis_mat, dbasis_mat, aabb,
                         grid_size, app_dim=app_dim,
                         n_voxel_list=n_voxel_list,
                         upsamp_list=tuple(upsamp_list), **kwargs)
