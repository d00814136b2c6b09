"""Bilinear grid sampling (``nmf_tpu/ops/grid_sample.py``).

Convention of torch ``F.grid_sample(align_corners=True)`` with zeros
padding: the last axis of ``coords`` is (x, y[, z]) in [-1, 1], x indexing
the last array dimension.

The field's queries use ``quad_gather_2d`` and ``line_interp``: one table
row per sample carries every corner it interpolates (the 2x2 neighbourhood
of a plane, the 2 neighbours on a line), gathered by ``TakeRows``, whose
backward is the row scatter-add kernel ``binsum_rows``.
"""
import torch
import torch.nn.functional as F

from .kernels.binsum import binsum_rows


def _unnormalize(coord, size):
    """[-1, 1] -> [0, size - 1] (align_corners=True)."""
    return (coord + 1.0) * 0.5 * (size - 1)


class TakeRows(torch.autograd.Function):
    """``table[idx]`` along axis 0 whose backward accumulates the row
    cotangents with ``binsum_rows`` (in f32, cast back to the table's dtype),
    as ``_qg_bwd`` and ``take_rows_binsum`` do in nmf_tpu. ``idx``: (N,)
    int32, every id in range."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.num_rows = table.shape[0]
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        d = binsum_rows(idx, g.float().contiguous(), ctx.num_rows)
        return d.to(g.dtype), None


def grid_sample_1d(line, coords):
    """line: (C, L); coords: (...) in [-1, 1] -> (..., C). Zeros padding."""
    C, L = line.shape
    x = _unnormalize(coords, L)
    x0 = torch.floor(x)
    w1 = x - x0
    i0 = x0.long()
    i1 = i0 + 1
    v0 = ((i0 >= 0) & (i0 <= L - 1)).to(line.dtype)
    v1 = ((i1 >= 0) & (i1 <= L - 1)).to(line.dtype)
    g0 = line[:, i0.clamp(0, L - 1)]
    g1 = line[:, i1.clamp(0, L - 1)]
    out = g0 * (v0 * (1 - w1)) + g1 * (v1 * w1)
    return torch.movedim(out, 0, -1)


def grid_sample_2d(plane, coords):
    """plane: (C, H, W); coords: (..., 2) as (x, y) -> (..., C)."""
    C, H, W = plane.shape
    x = _unnormalize(coords[..., 0], W)
    y = _unnormalize(coords[..., 1], H)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    ix0 = x0.long()
    iy0 = y0.long()
    flat = plane.reshape(C, H * W)
    out = 0.0
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        ix = ix0 + dx
        iy = iy0 + dy
        w = (wx if dx else (1 - wx)) * (wy if dy else (1 - wy))
        valid = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
        idx = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
        g = flat[:, idx]
        out = out + g * torch.where(valid, w, torch.zeros_like(w))
    return torch.movedim(out, 0, -1)


def grid_sample_3d(vol, coords):
    """vol: (C, D, H, W); coords: (..., 3) as (x, y, z) -> (..., C);
    x indexes W, y indexes H, z indexes D."""
    C, D, H, W = vol.shape
    x = _unnormalize(coords[..., 0], W)
    y = _unnormalize(coords[..., 1], H)
    z = _unnormalize(coords[..., 2], D)
    x0, y0, z0 = torch.floor(x), torch.floor(y), torch.floor(z)
    wx, wy, wz = x - x0, y - y0, z - z0
    ix0, iy0, iz0 = x0.long(), y0.long(), z0.long()
    flat = vol.reshape(C, D * H * W)
    out = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                ix, iy, iz = ix0 + dx, iy0 + dy, iz0 + dz
                w = ((wx if dx else (1 - wx))
                     * (wy if dy else (1 - wy))
                     * (wz if dz else (1 - wz)))
                valid = ((ix >= 0) & (ix <= W - 1)
                         & (iy >= 0) & (iy <= H - 1)
                         & (iz >= 0) & (iz <= D - 1))
                idx = ((iz.clamp(0, D - 1) * H + iy.clamp(0, H - 1)) * W
                       + ix.clamp(0, W - 1))
                g = flat[:, idx]
                out = out + g * torch.where(valid, w, torch.zeros_like(w))
    return torch.movedim(out, 0, -1)


def _quad_prep(plane_shape, coords):
    """Flat corner index and bilinear weights of quad_gather_2d."""
    C, H, W = plane_shape
    cx = torch.clamp(coords[..., 0], -1, 1)
    cy = torch.clamp(coords[..., 1], -1, 1)
    x = _unnormalize(cx, W)
    y = _unnormalize(cy, H)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    wx = x - x0f
    wy = y - y0f
    ix0 = torch.clamp(x0f, 0, W - 1).to(torch.int32)
    iy0 = torch.clamp(y0f, 0, H - 1).to(torch.int32)
    return ix0, iy0, wx, wy


def _quad_table(plane):
    """(C, H, W) -> row-gatherable (H*W, 4C) table: row iy*W + ix holds the
    corners (0,0), (1,0), (0,1), (1,1) in (dx, dy). The wrapped rows of the
    last column and row only ever appear with weight exactly 0."""
    C, H, W = plane.shape
    quad = torch.cat([
        plane,
        torch.roll(plane, -1, dims=2),
        torch.roll(plane, -1, dims=1),
        torch.roll(plane, (-1, -1), dims=(1, 2)),
    ], dim=0)
    return quad.reshape(4 * C, H * W).t().contiguous()


def _quad_combine(rows, wx, wy, C):
    r = rows.float()
    w00 = (1 - wx) * (1 - wy)
    w10 = wx * (1 - wy)
    w01 = (1 - wx) * wy
    w11 = wx * wy
    return (r[..., 0 * C:1 * C] * w00[..., None]
            + r[..., 1 * C:2 * C] * w10[..., None]
            + r[..., 2 * C:3 * C] * w01[..., None]
            + r[..., 3 * C:4 * C] * w11[..., None])


def quad_gather_2d(plane, coords):
    """Bilinear 2D sample with ONE table row gathered per sample.

    plane: (C, H, W) in the gather dtype; coords: (..., 2) as (x, y)
    -> (..., C) float32. Equals grid_sample_2d for coords in [-1, 1].
    """
    C, H, W = plane.shape
    ix0, iy0, wx, wy = _quad_prep(plane.shape, coords)
    idx = (iy0 * W + ix0).reshape(-1)
    rows = TakeRows.apply(_quad_table(plane), idx)
    rows = rows.reshape(coords.shape[:-1] + (4 * C,))
    return _quad_combine(rows, wx, wy, C)


def line_interp(line, coords):
    """Linear 1D sample, the semantics of nmf_tpu's ``line_interp_matmul``.

    line: (C, L) in the gather dtype; coords: (...) in [-1, 1] (clamped)
    -> (..., C) float32. The interpolation weights are rounded to the
    line's dtype, as the 2-hot matrix of the matmul form is; products
    accumulate in f32. One row of the (L, 2C) table [line_i | line_{i+1}]
    is gathered per sample.
    """
    C, L = line.shape
    x = _unnormalize(torch.clamp(coords, -1, 1), L)
    x0f = torch.floor(x)
    w1 = x - x0f
    i0 = torch.clamp(x0f, 0, L - 1).to(torch.int32)
    lt = line.t()
    table = torch.cat([lt, torch.roll(lt, -1, dims=0)], dim=1).contiguous()
    rows = TakeRows.apply(table, i0.reshape(-1)).float()
    rows = rows.reshape(coords.shape + (2 * C,))
    w0 = (1 - w1).to(line.dtype).float()[..., None]
    w1 = w1.to(line.dtype).float()[..., None]
    return rows[..., :C] * w0 + rows[..., C:] * w1


def resize_align_corners_2d(plane, new_hw):
    """Bilinear resize (C, H, W) -> (C, H', W'), align_corners=True."""
    Hn, Wn = new_hw
    ys = torch.linspace(-1.0, 1.0, Hn, device=plane.device)
    xs = torch.linspace(-1.0, 1.0, Wn, device=plane.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    out = grid_sample_2d(plane, torch.stack([gx, gy], dim=-1))
    return torch.movedim(out, -1, 0)


def resize_align_corners_1d(line, new_l):
    xs = torch.linspace(-1.0, 1.0, new_l, device=line.device)
    return torch.movedim(grid_sample_1d(line, xs), -1, 0)


def max_pool_3d(vol, ks: int = 3):
    """3D max pool of (D, H, W), stride 1, 'same' padding."""
    return F.max_pool3d(vol[None, None], ks, stride=1, padding=ks // 2)[0, 0]
