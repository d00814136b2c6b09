"""Multiresolution hash-grid radiance field (``nmf_tpu/fields/hashgrid.py``):
the instant-ngp encoding, a density head and an appearance head.

The encoding gathers the 8 corners of every level with ONE ``TakeRows``
over the tables viewed as (L * T, F), whose backward is the row
scatter-add kernel ``binsum_rows``. The spatial hash is nmf_tpu's uint32
arithmetic with wraparound, computed in int64: each product is masked to
its low 32 bits before the XOR (corner coordinates stay below ~2^11 and
the primes below 2^32, so no product overflows int64).

Normals are autograd normals, ``normalize(-d density_mlp(feat) / d xyz)``:
with gradients on, ``torch.autograd.grad(create_graph=True)``, so a loss
on the normals reaches the tables through the gathered rows (first order
through ``TakeRows``); under ``no_grad`` (evaluation) the same gradient
without a graph.
"""
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..modules.mlp import MLP
from ..ops.grid_sample import TakeRows
from ..ops.safemath import normalize, trunc_exp

PRIMES = (1, 2654435761, 805459861)
_LOW32 = 0xFFFFFFFF


def hash_ids(c0, c1, c2, log2_size: int):
    """nmf_tpu's spatial hash of integer corner coordinates (broadcast
    together; non-negative int64) -> int64 ids in [0, 2^log2_size)."""
    h = (c0 * PRIMES[0]) & _LOW32
    h = h ^ ((c1 * PRIMES[1]) & _LOW32)
    h = h ^ ((c2 * PRIMES[2]) & _LOW32)
    return h & (2 ** log2_size - 1)


def _clip01(x):
    """clip(x, 0, 1) with jnp.clip's gradient (half at either bound)."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


class HashEncoding(nn.Module):
    def __init__(self, tables, base_resolution=16, finest_resolution=512,
                 log2_hashmap_size=19):
        super().__init__()
        self.tables = nn.Parameter(tables)  # (L, T, F)
        self.base_resolution = int(base_resolution)
        self.finest_resolution = int(finest_resolution)
        self.log2_hashmap_size = int(log2_hashmap_size)

    def dim(self) -> int:
        return self.tables.shape[0] * self.tables.shape[2]

    def resolutions(self):
        """Each level's grid resolution, in nmf_tpu's float arithmetic."""
        L = self.tables.shape[0]
        b = math.exp((math.log(self.finest_resolution)
                      - math.log(self.base_resolution)) / max(L - 1, 1))
        return [int(math.floor(self.base_resolution * b ** level))
                for level in range(L)]

    def corner_ids(self, x_unit):
        """(ids (N, L, 8) int64 into the (L * T) rows, weights (N, L, 8))
        of points (N, 3) in [0, 1]; corners in nmf_tpu's (dx, dy, dz)
        order."""
        L, T, _ = self.tables.shape
        reso = torch.tensor(self.resolutions(), dtype=x_unit.dtype,
                            device=x_unit.device)
        xs = x_unit[:, None, :] * reso[:, None]
        x0 = torch.floor(xs)
        f = xs - x0
        c = x0.to(torch.int64)[..., None] + torch.arange(2,
                                                          device=xs.device)
        ids = hash_ids(c[:, :, 0, :, None, None], c[:, :, 1, None, :, None],
                       c[:, :, 2, None, None, :], self.log2_hashmap_size)
        ids = ids.reshape(-1, L, 8) + (torch.arange(L, device=xs.device)
                                       * T)[:, None]
        w1 = torch.stack([1 - f, f], dim=-1)  # (N, L, 3, 2)
        w = (w1[:, :, 0, :, None, None] * w1[:, :, 1, None, :, None]
             * w1[:, :, 2, None, None, :])
        return ids, w.reshape(-1, L, 8)

    def forward(self, x_unit):
        """x_unit (N, 3) in [0, 1] -> (N, L * F)."""
        L, T, Fd = self.tables.shape
        ids, w = self.corner_ids(x_unit)
        rows = TakeRows.apply(self.tables.reshape(L * T, Fd),
                              ids.reshape(-1).to(torch.int32))
        feat = (rows.reshape(-1, L, 8, Fd) * w[..., None]).sum(dim=2)
        return feat.reshape(-1, L * Fd)


class HashGridRF(nn.Module):
    """Hash-encoded field with separate density and appearance heads. No
    schedule (no upsample, no shrink): ``grid_size`` only sets the march
    step."""

    def __init__(self, encoding, density_mlp, app_mlp, aabb, app_dim=24,
                 activation="exp", density_shift=-1.0, distance_scale=25.0,
                 step_ratio=0.5, grid_size=(512, 512, 512), lr=1e-2,
                 lr_net=1e-3):
        super().__init__()
        self.encoding = encoding
        self.density_mlp = density_mlp
        self.app_mlp = app_mlp
        # a copy: the fit moves the box in place (scripts/fit_field.py)
        self.register_buffer("aabb", torch.tensor(np.asarray(aabb, np.float32)))
        self.app_dim = int(app_dim)
        self.activation = activation
        self.density_shift = float(density_shift)
        self.distance_scale = float(distance_scale)
        self.step_ratio = float(step_ratio)
        self.grid_size = tuple(int(g) for g in grid_size)
        self.lr = float(lr)
        self.lr_net = float(lr_net)
        self.upsamp_list = ()
        self.fixed_shape = False

    # ---- geometry (host side, from the f32 box, as nmf_tpu) ----
    def _extent_np(self):
        aabb = self.aabb.detach().cpu().numpy()
        return aabb[1] - aabb[0]

    @property
    def stepsize(self) -> float:
        units = self._extent_np().astype(np.float64) / (
            np.asarray(self.grid_size, np.float64) - 1)
        return float(units.min() * self.step_ratio)

    @property
    def n_samples(self) -> int:
        diag = float(np.linalg.norm(self._extent_np()))
        return int(diag / self.stepsize) + 1

    @property
    def live_grid_size(self):
        return self.grid_size

    def normalize_coord(self, xyz):
        aabb_size = self.aabb[1] - self.aabb[0]
        coords = (xyz[..., :3] - self.aabb[0]) * (2.0 / aabb_size) - 1
        return torch.cat([coords, xyz[..., 3:]], dim=-1)

    def _unit(self, pts3):
        return _clip01((pts3 - self.aabb[0]) / (self.aabb[1] - self.aabb[0]))

    def feature2density(self, feat):
        if self.activation == "exp":
            return trunc_exp(feat + self.density_shift)
        if self.activation == "softplus":
            return F.softplus(torch.clamp(feat, -15, 1e3) + self.density_shift)
        return F.relu(feat + self.density_shift)

    # ---- queries ----
    def compute_densityfeature(self, xyz, use_gather_dtype=False,
                               activate=True):
        """World xyz (N, 3/4) -> density (N,). The tables are f32:
        ``use_gather_dtype`` changes nothing."""
        feat = self.encoding(self._unit(xyz[..., :3]))
        sig = self.density_mlp(feat)[..., 0]
        return self.feature2density(sig) if activate else sig

    def compute_appfeature(self, xyz):
        return self.app_mlp(self.encoding(self._unit(xyz[..., :3])))

    def raw_features(self, xyz):
        """(the raw density feature (N,), the appearance features) from one
        encoding of the points: ``compute_densityfeature(xyz,
        activate=False)`` and ``compute_appfeature(xyz)`` with one K3
        launch in their backward."""
        feat = self.encoding(self._unit(xyz[..., :3]))
        return self.density_mlp(feat)[..., 0], self.app_mlp(feat)

    def compute_normals(self, xyz):
        return self.compute_all(xyz, with_normals=True)[2]

    def compute_all(self, xyz, with_normals=False):
        """(density, app_features, normals or None) from one encoding of
        the points (N, 3/4)."""
        pts = xyz[..., :3]
        if not with_normals:
            feat = self.encoding(self._unit(pts))
            return (self.feature2density(self.density_mlp(feat)[..., 0]),
                    self.app_mlp(feat), None)
        graph = torch.is_grad_enabled()
        if not pts.requires_grad:
            pts = pts.detach().requires_grad_(True)
        with torch.enable_grad():
            feat = self.encoding(self._unit(pts))
            raw = self.density_mlp(feat)[..., 0]
            (g,) = torch.autograd.grad(raw.sum(), pts, create_graph=graph)
        if not graph:
            feat, raw = feat.detach(), raw.detach()
        return (self.feature2density(raw), self.app_mlp(feat),
                normalize(-g))

    # ---- regularizers and schedule ----
    def density_L1(self):
        return self.encoding.tables.abs().mean()

    def tv_loss_density(self):
        return self.aabb.new_zeros(())

    def tv_loss_app(self):
        return self.aabb.new_zeros(())

    def vector_comp_diffs(self):
        return self.aabb.new_zeros(())

    def check_schedule(self, iteration: int) -> bool:
        return False


def init_hashgrid_rf(generator, aabb, n_levels=16, n_features=2,
                     log2_hashmap_size=19, base_resolution=16,
                     finest_resolution=512, app_dim=24, hidden_w=64,
                     **kwargs):
    """nmf_tpu's ``init_hashgrid_rf``: tables from U(-1e-4, 1e-4), two
    2-layer heads of width ``hidden_w``."""
    tables = 1e-4 * (2 * torch.rand(
        (n_levels, 2 ** log2_hashmap_size, n_features),
        generator=generator) - 1)
    enc = HashEncoding(tables, base_resolution=base_resolution,
                       finest_resolution=finest_resolution,
                       log2_hashmap_size=log2_hashmap_size)
    density_mlp = MLP(enc.dim(), 1, num_layers=2, hidden_w=hidden_w,
                      generator=generator)
    app_mlp = MLP(enc.dim(), app_dim, num_layers=2, hidden_w=hidden_w,
                  generator=generator)
    return HashGridRF(enc, density_mlp, app_mlp, np.asarray(aabb, np.float32),
                      app_dim=app_dim, **kwargs)
