"""TensoRF vector-matrix factorized radiance field (``nmf_tpu/fields/tensorf.py``).

``TensorVMSplit`` is an ``nn.Module``: its factor planes and lines and the
basis matrices are parameters, the scene box ``aabb`` is a buffer. The query
path gathers one quad-table row per (sample, plane) and one pair-table row
per (sample, line); the plane and line cotangents are accumulated by the
``binsum_rows`` kernel (``ops/grid_sample.TakeRows``). With normals, the
tables also carry the density planes filtered by the smoothed derivative
kernels and the differenced density lines, so one gathered row gives
density, appearance and the density gradient.

Not ported yet: ``compute_normals`` on its own, autodiff normals
(``numer_grad=False``), ``fixed_shape`` padding, ``shrink``, ``dbasis``,
and the TV / orthogonality regularizers.
"""
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.grid_sample import (conv1d_same, conv2d_same, line_interp,
                               quad_gather_2d, resize_align_corners_1d,
                               resize_align_corners_2d,
                               smoothed_derivative_kernels_2d)
from ..ops.safemath import normalize
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

    def query(self, coords, dtype=None):
        """coords: (..., 3) normalized to [-1, 1] -> list of 3 (..., C)
        factor products, gathered in ``dtype`` (default: the parameters')
        and accumulated in f32."""
        feats = []
        for i in range(3):
            m0, m1 = MAT_MODE[i]
            plane, line = self.planes[i], self.lines[i]
            if dtype is not None:
                plane, line = plane.to(dtype), line.to(dtype)
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
                 lr=0.02, lr_net=1e-3, smoothing=1.0, numer_grad=True):
        super().__init__()
        if not numer_grad:
            raise NotImplementedError("field.numer_grad=false (autodiff "
                                      "normals) is not ported yet")
        self.smoothing = float(smoothing)
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

    def compute_densityfeature(self, xyz, use_gather_dtype=False):
        """World xyz (..., 3/4) -> density (...), gathered in f32, or in
        the gather dtype with ``use_gather_dtype`` (the proposal pass: the
        same values compute_all gives)."""
        coords = self.normalize_coord(xyz)[..., :3]
        gd = GATHER_DTYPES[self.gather_dtype] if use_gather_dtype else None
        return self.feature2density(
            self._contract_density(self.density_rf.query(coords, gd)))

    def compute_appfeature(self, xyz):
        coords = self.normalize_coord(xyz)[..., :3]
        return torch.cat(self.app_rf.query(coords), dim=-1) @ self.basis_mat

    def _dkernels(self):
        """(kx, ky, k1): the smoothed plane derivative kernels and the line
        central difference [-1/2, 0, 1/2] (d/d index)."""
        kx, ky = smoothed_derivative_kernels_2d(self.smoothing)
        return kx, ky, np.array([-0.5, 0.0, 0.5])

    def compute_all(self, xyz, with_normals=False):
        """(density, app_features, normals or None) from ONE gathered row
        per factor: the density and appearance tables (and, with normals,
        the density planes filtered by the derivative kernels and the
        differenced lines) are concatenated channel-wise. The normals are
        normalize(-grad), the smoothed gradient of the density feature."""
        coords = self.normalize_coord(xyz)[..., :3]
        d_rf, a_rf = self.density_rf, self.app_rf
        Cd, Ca = d_rf.n_comp, a_rf.n_comp
        gd = GATHER_DTYPES[self.gather_dtype]
        if with_normals:
            kx, ky, k1 = self._dkernels()
        d_feats, a_feats = [], []
        dgrads = [[], [], []]
        for i in range(3):
            m0, m1 = MAT_MODE[i]
            v = VEC_MODE[i]
            dp, dl = d_rf.planes[i], d_rf.lines[i]
            parts_p, parts_l = [dp, a_rf.planes[i]], [dl, a_rf.lines[i]]
            if with_normals:
                parts_p += [conv2d_same(dp, kx), conv2d_same(dp, ky)]
                parts_l.append(conv1d_same(dl, k1))
            pc = quad_gather_2d(torch.cat(parts_p).to(gd), torch.stack(
                [coords[..., m0], coords[..., m1]], dim=-1))
            lc = line_interp(torch.cat(parts_l).to(gd), coords[..., v])
            p_d, l_d = pc[..., :Cd], lc[..., :Cd]
            d_feats.append(p_d * l_d)
            a_feats.append(pc[..., Cd:Cd + Ca] * lc[..., Cd:Cd + Ca])
            if with_normals:
                dgrads[m0].append(pc[..., Cd + Ca:2 * Cd + Ca] * l_d)
                dgrads[m1].append(pc[..., 2 * Cd + Ca:3 * Cd + Ca] * l_d)
                dgrads[v].append(p_d * lc[..., Cd + Ca:2 * Cd + Ca])
        sigma = self.feature2density(self._contract_density(d_feats))
        app = torch.cat(a_feats, dim=-1) @ self.basis_mat
        if not with_normals:
            return sigma, app, None
        g = torch.stack([self._contract_density(dgrads[j])
                         for j in range(3)], dim=-1)
        return sigma, app, normalize(-g)

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
