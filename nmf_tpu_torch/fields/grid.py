"""Dense 3D voxel radiance field (``nmf_tpu/fields/grid.py``).

nmf_tpu holds a density volume (1, D, H, W) and an appearance volume
(app_dim, D, H, W), read by trilinear align-corners interpolation with
zeros outside the box. The port stores both as ONE row table
``grid_rows`` (D * H * W, C): row ``(z * H + y) * W + x`` holds the
voxel's density, its app_dim appearance channels and zeros up to a
multiple of 4 f32 columns (C = 28 at app_dim 24), so that the row
scatter-add kernel takes its vector path. A query gathers the 8 corners
of every point with one ``TakeRows``, whose backward is ``binsum_rows``:
the step copies the volume in neither direction. ``density_grid`` and
``app_grid`` are views of the table in nmf_tpu's layout; the weight
transfer (``weights.py``) reads and writes them through ``jax_leaves`` /
``load_jax_leaves``.

The normals are the closed-form gradient of the trilinear density, from
the same 8 gathered rows (nmf_tpu differentiates the query with
``jax.grad``): the weights' derivatives are those of autodiff through
``x - floor(x)``, and a loss on the normals reaches the table through the
gathered rows, first order through ``TakeRows``.
"""
import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.grid_sample import TakeRows, grid_sample_3d
from ..ops.safemath import normalize, trunc_exp

# corner order of nmf_tpu's grid_sample_3d: dx outer, dz inner
CORNERS = tuple((dx, dy, dz) for dx in (0, 1) for dy in (0, 1)
                for dz in (0, 1))


def row_width(app_dim: int) -> int:
    """Columns of a table row: density + app_dim, padded to 4 f32."""
    return -(-(1 + app_dim) // 4) * 4


def pack_rows(density, app):
    """(1, D, H, W) density and (A, D, H, W) appearance -> the
    (D * H * W, row_width(A)) table."""
    A = app.shape[0]
    R = density[0].numel()
    rows = density.new_zeros((R, row_width(A)))
    rows[:, 0] = density.reshape(R)
    rows[:, 1:1 + A] = app.reshape(A, R).t()
    return rows


class GridRF(nn.Module):
    """Dense voxel field. ``grid_size`` is (X, Y, Z) as nmf_tpu's; the
    volumes are (Z, Y, X) = (D, H, W)."""

    def __init__(self, density_grid, app_grid, aabb, grid_size, app_dim=24,
                 activation="softplus", density_shift=-4.0,
                 distance_scale=25.0, step_ratio=0.5, lr=0.02, lr_net=1e-3):
        super().__init__()
        self.app_dim = int(app_dim)
        self.dhw = tuple(int(s) for s in density_grid.shape[1:])
        self.grid_rows = nn.Parameter(pack_rows(density_grid, app_grid))
        self.register_buffer("aabb", torch.tensor(np.asarray(aabb, np.float32)))
        self.grid_size = tuple(int(g) for g in grid_size)
        self.activation = activation
        self.density_shift = float(density_shift)
        self.distance_scale = float(distance_scale)
        self.step_ratio = float(step_ratio)
        self.lr = float(lr)
        self.lr_net = float(lr_net)
        self.upsamp_list = ()
        self.fixed_shape = False

    # ---- nmf_tpu's leaves, as views of the table ----
    def jax_leaves(self, rows=None):
        """{leaf: view} in nmf_tpu's layout of ``rows`` (default: the
        table; the table's gradient gives nmf_tpu's gradients)."""
        rows = self.grid_rows if rows is None else rows
        D, H, W = self.dhw
        return {"density_grid": rows[:, 0].reshape(1, D, H, W),
                "app_grid": rows[:, 1:1 + self.app_dim].t().reshape(
                    self.app_dim, D, H, W)}

    @torch.no_grad()
    def load_jax_leaves(self, leaves):
        """Rebuild the table from nmf_tpu's ``density_grid`` and
        ``app_grid`` (either may be missing: the table keeps its values);
        a volume of another shape replaces the parameter."""
        cur = self.jax_leaves()
        dev = self.grid_rows.device
        dens, app = (cur[k] if k not in leaves else leaves[k].to(dev)
                     if torch.is_tensor(leaves[k]) else torch.from_numpy(
                         np.array(leaves[k], np.float32)).to(dev)
                     for k in ("density_grid", "app_grid"))
        self.app_dim = app.shape[0]
        self.dhw = tuple(int(s) for s in dens.shape[1:])
        self.grid_rows = nn.Parameter(pack_rows(dens, app))

    @property
    def density_grid(self):
        return self.jax_leaves()["density_grid"]

    @property
    def app_grid(self):
        return self.jax_leaves()["app_grid"]

    # ---- geometry (host side; the step in f64 from the f32 extent, as
    # nmf_tpu's grid field: TensorVMSplit takes it in f32, ROADMAP C.5) ----
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

    def live_step_scale(self) -> float:
        return 1.0

    fused_normals_ok = True

    def normalize_coord(self, xyz):
        aabb_size = self.aabb[1] - self.aabb[0]
        coords = (xyz[..., :3] - self.aabb[0]) * (2.0 / aabb_size) - 1
        return torch.cat([coords, xyz[..., 3:]], dim=-1)

    def feature2density(self, feat):
        if self.activation == "softplus":
            return F.softplus(torch.clamp(feat, -15, 1e3) + self.density_shift)
        if self.activation == "exp":
            return trunc_exp(feat + self.density_shift)
        return F.relu(feat + self.density_shift)

    # ---- queries ----
    def _gather(self, xyz, with_derivs=False):
        """Points (..., 3/4) -> (features (N, C) with the weights of the 8
        corners, and with ``with_derivs`` the density's gradient (N, 3) in
        world units). A corner outside the volume has weight 0 (its row
        id clamped into the table)."""
        D, H, W = self.dhw
        c = self.normalize_coord(xyz[..., :3].reshape(-1, 3))
        pos, sizes, frac = [], [], []
        for j, size in enumerate((W, H, D)):
            x = (c[:, j] + 1.0) * 0.5 * (size - 1)
            x0 = torch.floor(x)
            pos.append(x0.long())
            sizes.append(size)
            frac.append(x - x0)
        weights, derivs, ids = [], [[], [], []], []
        for corner in CORNERS:
            idx, valid, terms = [], True, []
            for j, d in enumerate(corner):
                i = pos[j] + d
                valid = valid & (i >= 0) & (i <= sizes[j] - 1)
                idx.append(i.clamp(0, sizes[j] - 1))
                terms.append(frac[j] if d else 1 - frac[j])
            ids.append((idx[2] * H + idx[1]) * W + idx[0])
            zero = torch.zeros_like(terms[0])
            weights.append(torch.where(
                valid, terms[0] * terms[1] * terms[2], zero))
            if with_derivs:
                for j in range(3):
                    others = [terms[k] for k in range(3) if k != j]
                    sign = 1.0 if corner[j] else -1.0
                    derivs[j].append(torch.where(
                        valid, sign * others[0] * others[1], zero))
        rows = TakeRows.apply(self.grid_rows, torch.stack(ids, 1).reshape(
            -1).to(torch.int32)).reshape(-1, 8, self.grid_rows.shape[1])
        feats = (rows * torch.stack(weights, 1)[..., None]).sum(dim=1)
        if not with_derivs:
            return feats, None
        # d index / d world of axis j: (size - 1) / 2 * 2 / extent
        extent = self.aabb[1] - self.aabb[0]
        dens = rows[..., 0]
        g = torch.stack([(dens * torch.stack(derivs[j], 1)).sum(dim=1)
                         * (0.5 * (sizes[j] - 1)) * (2.0 / extent[j])
                         for j in range(3)], dim=-1)
        return feats, g

    def compute_densityfeature(self, xyz, use_gather_dtype=False,
                               activate=True):
        """World xyz (..., 3/4) -> density (N,). The table is f32:
        ``use_gather_dtype`` changes nothing."""
        sig = self._gather(xyz)[0][:, 0]
        return self.feature2density(sig) if activate else sig

    def compute_appfeature(self, xyz):
        return self._gather(xyz)[0][:, 1:1 + self.app_dim]

    def raw_features(self, xyz):
        """(the raw density feature (N,), the appearance features) from one
        gather of the 8 corner rows: ``compute_densityfeature(xyz,
        activate=False)`` and ``compute_appfeature(xyz)`` with one K3
        launch in their backward."""
        feats = self._gather(xyz)[0]
        return feats[:, 0], feats[:, 1:1 + self.app_dim]

    def compute_all(self, xyz, with_normals=False):
        """(density, app_features, normals or None) from one gather of the
        8 corner rows."""
        feats, g = self._gather(xyz, with_normals)
        return (self.feature2density(feats[:, 0]),
                feats[:, 1:1 + self.app_dim],
                None if g is None else normalize(-g))

    def compute_normals(self, xyz):
        return self.compute_all(xyz, with_normals=True)[2]

    # ---- regularizers and schedule ----
    def density_L1(self):
        return self.density_grid.abs().mean()

    @staticmethod
    def _tv3(vol):
        return ((vol[:, 1:] - vol[:, :-1]).abs().mean()
                + (vol[:, :, 1:] - vol[:, :, :-1]).abs().mean()
                + (vol[..., 1:] - vol[..., :-1]).abs().mean())

    def tv_loss_density(self):
        return self._tv3(self.density_grid)

    def tv_loss_app(self):
        return self._tv3(self.app_grid)

    def vector_comp_diffs(self):
        return self.aabb.new_zeros(())

    def check_schedule(self, iteration: int) -> bool:
        """nmf_tpu's grid field never upsamples on a schedule."""
        return False

    @torch.no_grad()
    def upsample(self, res_target):
        """Trilinear align-corners resize of both volumes to
        ``res_target``, read as nmf_tpu reads it: the volumes become
        (C, t0, t1, t2) and ``grid_size`` ``res_target`` (the same order
        only for a cubic target, as in nmf_tpu)."""
        dev = self.grid_rows.device
        lin = [torch.linspace(-1.0, 1.0, int(t), device=dev)
               for t in res_target]
        gz, gy, gx = torch.meshgrid(*lin, indexing="ij")
        coords = torch.stack([gx, gy, gz], dim=-1)
        leaves = {k: torch.movedim(grid_sample_3d(v, coords), -1, 0)
                  for k, v in self.jax_leaves().items()}
        self.load_jax_leaves(leaves)
        self.grid_size = tuple(int(t) for t in res_target)


def init_grid_rf(generator, aabb, grid_size=(128, 128, 128), app_dim=24,
                 init_scale=0.1, **kwargs):
    """nmf_tpu's ``init_grid_rf``: both volumes U(0, init_scale)."""
    gs = tuple(int(g) for g in grid_size)
    shape = (gs[2], gs[1], gs[0])
    density = init_scale * torch.rand((1, *shape), generator=generator)
    app = init_scale * torch.rand((app_dim, *shape), generator=generator)
    return GridRF(density, app, np.asarray(aabb, np.float32), gs,
                  app_dim=app_dim, **kwargs)
