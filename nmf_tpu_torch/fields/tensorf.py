"""TensoRF vector-matrix factorized radiance field (``nmf_tpu/fields/tensorf.py``).

``TensorVMSplit`` is an ``nn.Module``: its factor planes and lines and the
basis matrices are parameters, the scene box ``aabb`` is a buffer. The query
path gathers one quad-table row per (sample, plane) and one pair-table row
per (sample, line); the plane and line cotangents are accumulated by the
``binsum_rows`` kernel (``ops/grid_sample.TakeRows``). With normals, the
tables also carry the density planes filtered by the smoothed derivative
kernels and the differenced density lines, so one gathered row gives
density, appearance and the density gradient.

``fixed_shape=True`` allocates the factor grids at the final resolution
of the voxel schedule, zero-padded, with the logical resolution in the
``live_reso`` buffer (f32 (3,)): queries map onto the live region, an
upsample resamples it in place, the regularizers read it only, and no
tensor ever changes shape. The zero padding is an invariant: the planes are
masked before every filter (whose transpose would reach into the padding)
and before ``abs`` (whose gradient at 0 is not 0), so the padding's
gradient is exactly zero.

``shrink`` crops the planes and lines to a box aligned to the voxel lattice
(the occupancy-grid sampler's ``shrink_iters``); the quad and pair tables
that the queries gather (``ops/grid_sample.py``) are derived from the
parameters at every query, so they follow the new sizes.

The options of nmf_tpu's field: the init modes ``rand``, ``trig``,
``unif``, ``unifplane``, ``randplane``; the activations softplus, relu,
exp (``trunc_exp``) and identity; ``dbasis`` (the density features
contracted by the (3 * n_comp, 1) ``dbasis_mat`` instead of summed);
``contract_space`` and ``numer_grad=False``. Without the smoothed normals
(``numer_grad=False``, or ``dbasis``) ``compute_all`` with normals
answers as nmf_tpu's renderer queries such a field: the density in the
gather dtype, the appearance and the normals each on their own in f32;
the normals are then autograd normals through the quad gather (the
gradient with respect to the points, kept as a graph in training), and
``dbasis`` with the smoothed normals raises, as in nmf_tpu.
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
from ..ops.safemath import normalize, trunc_exp
from ..samplers.alphagrid import linspace_f32
from ..utils import n_to_reso

# plane i holds axes MAT_MODE[i]; line i holds axis VEC_MODE[i]
MAT_MODE = ((0, 1), (0, 2), (1, 2))
VEC_MODE = (2, 1, 0)

GATHER_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _live_mask(n, live):
    return torch.arange(n, dtype=torch.float32, device=live.device) < live


def mask_live_2d(plane, live_hw):
    """Zero a padded (C, H, W) plane beyond its live (H, W)."""
    if live_hw is None:
        return plane
    H, W = plane.shape[-2:]
    return plane * (_live_mask(H, live_hw[0])[:, None]
                    & _live_mask(W, live_hw[1])[None, :])


def mask_live_1d(line, live_l):
    if live_l is None:
        return line
    return line * _live_mask(line.shape[-1], live_l)


def plane_lives(live, i):
    """(live (H, W) of plane i, live L of line i), or (None, None)."""
    if live is None:
        return None, None
    m0, m1 = MAT_MODE[i]
    return (live[m1], live[m0]), live[VEC_MODE[i]]


class FactorGrid(nn.Module):
    """One plane + line factor set: planes (C, H, W), lines (C, L)."""

    def __init__(self, planes, lines):
        super().__init__()
        self.planes = nn.ParameterList([nn.Parameter(p) for p in planes])
        self.lines = nn.ParameterList([nn.Parameter(l) for l in lines])

    @property
    def n_comp(self) -> int:
        return self.planes[0].shape[0]

    def query(self, coords, dtype=None, live=None):
        """coords: (..., 3) normalized to [-1, 1] -> list of 3 (..., C)
        factor products, gathered in ``dtype`` (default: the parameters')
        and accumulated in f32; ``live``: the field's live resolution per
        world axis, for padded grids."""
        feats = []
        for i in range(3):
            m0, m1 = MAT_MODE[i]
            lhw, ll = plane_lives(live, i)
            plane, line = self.planes[i], self.lines[i]
            if dtype is not None:
                plane, line = plane.to(dtype), line.to(dtype)
            pc = quad_gather_2d(plane, torch.stack(
                [coords[..., m0], coords[..., m1]], dim=-1), lhw)
            lc = line_interp(line, coords[..., VEC_MODE[i]], ll)
            feats.append(pc * lc)
        return feats


def _trig_factors(grid_size: int, n_comp: int, init_val: float):
    """The 'trig' mode's plane (2 (n_comp // 2), G, G) and line, as
    nmf_tpu computes them in f32: sines and cosines of frequencies 0, 1,
    2, 4, ... of x + y (planes) and x, scaled by init_val * exp(-freq)."""
    pos = linspace_f32(-1.0, 1.0, grid_size, "cpu")
    xy = pos[:, None] + pos[None, :]
    freqs = torch.cat([torch.zeros(1), 2.0 ** torch.arange(
        n_comp // 2 - 1, dtype=torch.float32)])
    scales = init_val * torch.exp(-freqs)
    ang_p = freqs[:, None, None] * xy[None] * math.pi
    ang_l = freqs[:, None] * pos[None] * math.pi
    plane = torch.cat([scales[:, None, None] * torch.sin(ang_p),
                       scales[:, None, None] * torch.cos(ang_p)])
    line = torch.cat([scales[:, None] * torch.sin(ang_l),
                      scales[:, None] * torch.cos(ang_l)])
    return plane, line


def init_factor_grid(generator, grid_size: int, n_comp: int, init_mode: str,
                     init_val: float):
    """Initial planes (C, G, G) and lines (C, G) of nmf_tpu's
    ``init_factor_grid`` modes: 'rand' N(0, init_val^2) (every shipped
    config), 'unif' U(-1, 1) sqrt(init_val), 'unifplane' / 'randplane'
    uniform / normal planes with constant lines sqrt(init_val), 'trig'
    deterministic. The three planes are drawn before the three lines."""
    G = (n_comp, grid_size, grid_size)
    L = (n_comp, grid_size)
    root = init_val ** 0.5

    def unif(shape):
        return root * (2 * torch.rand(shape, generator=generator) - 1)

    if init_mode == "trig":
        plane, line = _trig_factors(grid_size, n_comp, init_val)
        return FactorGrid([plane.clone() for _ in range(3)],
                          [line.clone() for _ in range(3)])
    if init_mode == "unif":
        planes = [unif(G) for _ in range(3)]
        lines = [unif(L) for _ in range(3)]
    elif init_mode in ("unifplane", "randplane"):
        planes = [unif(G) if init_mode == "unifplane" else
                  root * torch.randn(G, generator=generator)
                  for _ in range(3)]
        lines = [root * torch.ones(L) for _ in range(3)]
    else:
        planes = [init_val * torch.randn(G, generator=generator)
                  for _ in range(3)]
        lines = [init_val * torch.randn(L, generator=generator)
                 for _ in range(3)]
    return FactorGrid(planes, lines)


def pad_factor_grid(fg: FactorGrid, pad_gs):
    """Zero-pad an exact-shape FactorGrid to the (X, Y, Z) resolution
    ``pad_gs`` (in place)."""
    with torch.no_grad():
        for i in range(3):
            m0, m1 = MAT_MODE[i]
            p, ln = fg.planes[i], fg.lines[i]
            buf = p.new_zeros((p.shape[0], int(pad_gs[m1]), int(pad_gs[m0])))
            buf[:, :p.shape[1], :p.shape[2]] = p
            lbuf = ln.new_zeros((ln.shape[0], int(pad_gs[VEC_MODE[i]])))
            lbuf[:, :ln.shape[1]] = ln
            fg.planes[i] = nn.Parameter(buf)
            fg.lines[i] = nn.Parameter(lbuf)
    return fg


@torch.no_grad()
def shrink_factor_grid(fg: FactorGrid, t_l, b_r):
    """Crop fg's planes and lines (in place) to the voxel ids [t_l, b_r)
    of each world axis."""
    for i in range(3):
        m0, m1 = MAT_MODE[i]
        v = VEC_MODE[i]
        fg.lines[i] = nn.Parameter(
            fg.lines[i][:, int(t_l[v]):int(b_r[v])].clone())
        fg.planes[i] = nn.Parameter(
            fg.planes[i][:, int(t_l[m1]):int(b_r[m1]),
                         int(t_l[m0]):int(b_r[m0])].clone())
    return fg


class TensorVMSplit(nn.Module):
    """Split density/appearance VM field."""

    def __init__(self, density_rf, app_rf, basis_mat, dbasis_mat, aabb,
                 grid_size, app_dim=24, activation="softplus",
                 density_shift=-4.0, distance_scale=25.0, step_ratio=0.5,
                 gather_dtype="bf16", n_voxel_list=(), upsamp_list=(),
                 lr=0.02, lr_net=1e-3, smoothing=1.0, numer_grad=True,
                 dbasis=False, contract_space=False, num_pretrain=0,
                 calibrate=False, live_reso=None):
        super().__init__()
        self.smoothing = float(smoothing)
        self.numer_grad = bool(numer_grad)
        self.dbasis = bool(dbasis)
        self.contract_space = bool(contract_space)
        # read by train.pretrain_density
        self.num_pretrain = int(num_pretrain or 0)
        self.calibrate = bool(calibrate)
        self.density_rf = density_rf
        self.app_rf = app_rf
        self.basis_mat = nn.Parameter(basis_mat)
        self.dbasis_mat = nn.Parameter(dbasis_mat)
        self.register_buffer("aabb", torch.as_tensor(aabb, dtype=torch.float32))
        self.grid_size = tuple(int(g) for g in grid_size)
        self.app_dim = app_dim
        if activation not in ("softplus", "relu", "exp", "identity"):
            raise ValueError(f"Unknown activation {activation}")
        self.activation = activation
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
        self.fixed_shape = live_reso is not None
        self.register_buffer(
            "live_reso", None if live_reso is None else torch.as_tensor(
                live_reso, dtype=torch.float32))

    # ---- geometry (host-side python floats, from the f32 box and its f32
    # extent, as nmf_tpu computes them) ----
    def _aabb_np(self):
        return self.aabb.detach().cpu().numpy()

    def _extent_np(self):
        aabb = self._aabb_np()
        return aabb[1] - aabb[0]

    @property
    def stepsize(self) -> float:
        units = self._extent_np().astype(np.float64) / (
            np.asarray(self.grid_size, np.float64) - 1)
        return float(units.min() * self.step_ratio)

    @property
    def aabb_diag(self) -> float:
        return float(np.linalg.norm(self._extent_np()))

    @property
    def n_samples(self) -> int:
        return int(self.aabb_diag / self.stepsize) + 1

    def _live3(self):
        """None, or the live resolution of each world axis (0-d f32)."""
        return tuple(self.live_reso) if self.fixed_shape else None

    @property
    def live_grid_size(self):
        """The logical resolution (host side)."""
        if not self.fixed_shape:
            return tuple(self.grid_size)
        return tuple(int(v) for v in self.live_reso.tolist())

    @property
    def fused_normals_ok(self) -> bool:
        """compute_all fuses only the smoothed normals without dbasis."""
        return self.numer_grad and not self.dbasis

    def live_step_scale(self) -> float:
        """stepsize at the live resolution over stepsize at grid_size."""
        if not self.fixed_shape:
            return 1.0
        extent = self._extent_np().astype(np.float64)
        live = np.asarray(self.live_reso.tolist(), np.float64)
        return float((extent / (live - 1)).min() * self.step_ratio
                     ) / self.stepsize

    # ---- queries ----
    def normalize_coord(self, xyz):
        """World xyz (..., 3 or 4; a trailing 4th channel passes through)
        -> normalized [-1, 1]. With ``contract_space``, nmf_tpu contracts
        the WORLD position (norm d: d / 2 inside the unit ball, (1 + (d -
        1) / 4) / 2 outside) and ignores the box; the port does the same."""
        if self.contract_space:
            dist = torch.linalg.norm(xyz[..., :3], dim=-1, keepdim=True) + 1e-8
            contracted = torch.where(dist > 1, (dist - 1) / 4 + 1, dist) / 2
            return torch.cat([contracted * (xyz[..., :3] / dist),
                              xyz[..., 3:]], dim=-1)
        aabb_size = self.aabb[1] - self.aabb[0]
        coords = (xyz[..., :3] - self.aabb[0]) * (2.0 / aabb_size) - 1
        return torch.cat([coords, xyz[..., 3:]], dim=-1)

    def feature2density(self, feat):
        if self.activation == "softplus":
            return F.softplus(torch.clamp(feat, -15, 1e3) + self.density_shift)
        if self.activation == "relu":
            return F.relu(feat + self.density_shift)
        if self.activation == "exp":
            return trunc_exp(feat + self.density_shift)
        return feat

    def _contract_density(self, feats):
        """The density feature: the factor products summed, or with
        ``dbasis`` contracted by ``dbasis_mat``."""
        if self.dbasis:
            return (torch.cat(feats, dim=-1) @ self.dbasis_mat)[..., 0]
        return sum(f.sum(dim=-1) for f in feats)

    def compute_densityfeature(self, xyz, use_gather_dtype=False,
                               activate=True):
        """World xyz (..., 3/4) -> density (...), gathered in f32, or in
        the gather dtype with ``use_gather_dtype`` (the proposal pass: the
        same values compute_all gives)."""
        coords = self.normalize_coord(xyz)[..., :3]
        gd = GATHER_DTYPES[self.gather_dtype] if use_gather_dtype else None
        sig = self._contract_density(self.density_rf.query(
            coords, gd, self._live3()))
        return self.feature2density(sig) if activate else sig

    def compute_appfeature(self, xyz):
        coords = self.normalize_coord(xyz)[..., :3]
        return torch.cat(self.app_rf.query(coords, live=self._live3()),
                         dim=-1) @ self.basis_mat

    def _dkernels(self):
        """(kx, ky, k1): the smoothed plane derivative kernels and the line
        central difference [-1/2, 0, 1/2] (d/d index)."""
        kx, ky = smoothed_derivative_kernels_2d(self.smoothing)
        return kx, ky, np.array([-0.5, 0.0, 0.5])

    def compute_all(self, xyz, with_normals=False):
        """(density, app_features, normals or None). Fused, from ONE
        gathered row per factor in the gather dtype: the density and
        appearance tables (and, with normals, the density planes filtered
        by the derivative kernels and the differenced lines) concatenated
        channel-wise; the normals are normalize(-grad), the smoothed
        gradient of the density feature. Normals without the smoothed
        path (``fused_normals_ok`` False) take one query each."""
        if with_normals and not self.fused_normals_ok:
            return (self.compute_densityfeature(xyz, use_gather_dtype=True),
                    self.compute_appfeature(xyz), self.compute_normals(xyz))
        return self._fused(xyz, GATHER_DTYPES[self.gather_dtype],
                           with_normals)

    def compute_normals(self, xyz):
        """World-space normals normalize(-grad density feature): the
        smoothed gradient in f32, or (``numer_grad=False``) autograd
        through the quad gather in f32, with a graph when gradients are
        on."""
        if not self.numer_grad:
            pts = xyz[..., :3]
            graph = torch.is_grad_enabled()
            if not pts.requires_grad:
                pts = pts.detach().requires_grad_(True)
            with torch.enable_grad():
                raw = self.compute_densityfeature(pts, activate=False)
                (g,) = torch.autograd.grad(raw.sum(), pts, create_graph=graph)
            return normalize(-g)
        if self.dbasis:
            raise NotImplementedError(
                "dbasis=True with smoothed normals is not used by shipped "
                "configs (nmf_tpu raises too)")
        return self._fused(xyz, torch.float32, True)[2]

    def _fused(self, xyz, gd, with_normals):
        coords = self.normalize_coord(xyz)[..., :3]
        d_rf, a_rf = self.density_rf, self.app_rf
        Cd, Ca = d_rf.n_comp, a_rf.n_comp
        if with_normals:
            kx, ky, k1 = self._dkernels()
        live = self._live3()
        d_feats, a_feats = [], []
        dgrads = [[], [], []]
        for i in range(3):
            m0, m1 = MAT_MODE[i]
            v = VEC_MODE[i]
            lhw, ll = plane_lives(live, i)
            dp, dl = d_rf.planes[i], d_rf.lines[i]
            parts_p, parts_l = [dp, a_rf.planes[i]], [dl, a_rf.lines[i]]
            if with_normals:
                mdp = mask_live_2d(dp, lhw)
                parts_p += [conv2d_same(mdp, kx), conv2d_same(mdp, ky)]
                parts_l.append(conv1d_same(mask_live_1d(dl, ll), k1))
            pc = quad_gather_2d(torch.cat(parts_p).to(gd), torch.stack(
                [coords[..., m0], coords[..., m1]], dim=-1), lhw)
            lc = line_interp(torch.cat(parts_l).to(gd), coords[..., v], ll)
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
        g = torch.stack([sum(f.sum(dim=-1) for f in dgrads[j])
                         for j in range(3)], dim=-1)
        return sigma, app, normalize(-g)

    # ---- regularizers: over the live region only, normalized by live
    # counts, so a padded grid gives the exact-shape values ----
    def density_L1(self):
        live = self._live3()
        total = 0.0
        for i in range(3):
            pl, ln = self.density_rf.planes[i], self.density_rf.lines[i]
            if live is None:
                total = total + pl.abs().mean() + ln.abs().mean()
                continue
            lhw, ll = plane_lives(live, i)
            total = (total
                     + mask_live_2d(pl, lhw).abs().sum()
                     / (pl.shape[0] * lhw[0] * lhw[1])
                     + mask_live_1d(ln, ll).abs().sum() / (ln.shape[0] * ll))
        return total

    @staticmethod
    def _tv(x2d, live_hw=None):
        h_tv = x2d[..., 1:, :-1] - x2d[..., :-1, :-1]
        w_tv = x2d[..., :-1, 1:] - x2d[..., :-1, :-1]
        val = torch.sqrt(w_tv ** 2 + h_tv ** 2 + 1e-5)
        if live_hw is None:
            return val.mean()
        lh, lw = live_hw
        C, H1, W1 = val.shape
        m = (_live_mask(H1, lh - 1)[:, None] & _live_mask(W1, lw - 1)[None])
        return (val * m).sum() / (C * (lh - 1) * (lw - 1))

    @staticmethod
    def _tv_line(line, live_l=None):
        val = (line[..., 1:] - line[..., :-1]).abs()
        if live_l is None:
            return val.mean()
        C, L1 = val.shape
        return (val * _live_mask(L1, live_l - 1)).sum() / (C * (live_l - 1))

    def _tv_loss(self, fg):
        total = 0.0
        for i in range(3):
            lhw, ll = plane_lives(self._live3(), i)
            total = (total + self._tv(fg.planes[i], lhw) * 1e-2
                     + self._tv_line(fg.lines[i], ll) * 1e-3)
        return total

    def tv_loss_density(self):
        return self._tv_loss(self.density_rf)

    def tv_loss_app(self):
        return self._tv_loss(self.app_rf)

    def vector_comp_diffs(self):
        """Orthogonality of the line components: the mean |off-diagonal|
        of each line set's Gram matrix."""
        total = 0.0
        for fg in (self.density_rf, self.app_rf):
            for i in range(3):
                vec = fg.lines[i]
                dotp = vec @ vec.t()
                n = vec.shape[0]
                off = dotp - torch.diag(torch.diag(dotp))
                total = total + off.abs().sum() / max(n * (n - 1), 1)
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
        rebuilt. A padded grid resamples its live region in place, capped
        at its padded size."""
        if self.fixed_shape:
            old = self.live_grid_size
            new = tuple(min(int(n), g) for n, g in zip(res_target,
                                                       self.grid_size))
            for fg in (self.density_rf, self.app_rf):
                for i in range(3):
                    m0, m1 = MAT_MODE[i]
                    v = VEC_MODE[i]
                    p, ln = fg.planes[i], fg.lines[i]
                    resized = resize_align_corners_2d(
                        p[:, :old[m1], :old[m0]], (new[m1], new[m0]))
                    p.zero_()[:, :new[m1], :new[m0]] = resized
                    rline = resize_align_corners_1d(ln[:, :old[v]], new[v])
                    ln.zero_()[:, :new[v]] = rline
            self.live_reso.copy_(torch.tensor(new, dtype=torch.float32))
            return
        for fg in (self.density_rf, self.app_rf):
            for i in range(3):
                m0, m1 = MAT_MODE[i]
                fg.planes[i] = nn.Parameter(resize_align_corners_2d(
                    fg.planes[i], (int(res_target[m1]), int(res_target[m0]))))
                fg.lines[i] = nn.Parameter(resize_align_corners_1d(
                    fg.lines[i], int(res_target[VEC_MODE[i]])))
        self.grid_size = tuple(int(r) for r in res_target)

    def shrink(self, new_aabb):
        """Crop the grids to ``new_aabb`` (2, 3), widened to the voxel
        lattice, in place (the parameters are replaced, so the optimizer
        must be rebuilt). Returns whether anything changed: not when the
        aligned box is the current one."""
        if self.fixed_shape:
            raise NotImplementedError(
                "field.fixed_shape does not support rf.shrink (occgrid "
                "shrink_iters); use the default exact-shape mode for "
                "shrinking configs")
        aabb = self._aabb_np()
        gs = np.asarray(self.grid_size)
        units = (aabb[1] - aabb[0]) / (gs - 1)
        t_l = np.round((np.asarray(new_aabb[0]) - aabb[0]) / units
                       ).astype(int)
        b_r = np.round((np.asarray(new_aabb[1]) - aabb[0]) / units
                       ).astype(int) + 1
        b_r = np.minimum(b_r, gs)
        t_l = np.clip(t_l, 0, None)
        t_l_r = t_l / (gs - 1)
        b_r_r = (b_r - 1) / (gs - 1)
        correct_aabb = np.stack([(1 - t_l_r) * aabb[0] + t_l_r * aabb[1],
                                 (1 - b_r_r) * aabb[0] + b_r_r * aabb[1]])
        if np.array_equal(correct_aabb, aabb):
            return False
        shrink_factor_grid(self.density_rf, t_l, b_r)
        shrink_factor_grid(self.app_rf, t_l, b_r)
        self.aabb = torch.as_tensor(correct_aabb, dtype=torch.float32,
                                    device=self.aabb.device)
        self.grid_size = tuple(int(s) for s in b_r - t_l)
        return True


def init_tensorvm_split(generator, aabb, density_n_comp=16,
                        appearance_n_comp=24, app_dim=24, grid_size=None,
                        N_voxel_init=128 ** 3, N_voxel_final=300 ** 3,
                        upsamp_list=(500, 1000, 2000, 3000, 4000, 5500, 7000),
                        init_mode="rand", d_init_val=0.1, app_init_val=0.1,
                        fixed_shape=False, **kwargs):
    """Build a TensorVMSplit (nmf_tpu's ``init_tensorvm_split``): square
    planes of the first axis' resolution, torch-Linear-style uniform basis
    matrices, the voxel schedule's resolutions. ``fixed_shape`` draws the
    grids at the initial resolution and zero-pads them to the final one."""
    aabb = np.asarray(aabb, np.float32)
    if grid_size is None:
        grid_size = n_to_reso(N_voxel_init, aabb)
    gsize = int(grid_size[0])
    density_rf = init_factor_grid(generator, gsize, density_n_comp, init_mode,
                                  d_init_val)
    app_rf = init_factor_grid(generator, gsize, appearance_n_comp, init_mode,
                              app_init_val)
    live_reso = None
    if fixed_shape:
        pad_gs = tuple(max(int(p), int(g)) for p, g in
                       zip(n_to_reso(N_voxel_final, aabb), grid_size))
        live_reso = [float(g) for g in grid_size]
        pad_factor_grid(density_rf, pad_gs)
        pad_factor_grid(app_rf, pad_gs)
        grid_size = pad_gs
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
                         upsamp_list=tuple(upsamp_list), live_reso=live_reso,
                         **kwargs)
