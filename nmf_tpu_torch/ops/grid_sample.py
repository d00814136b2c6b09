"""Bilinear grid sampling (``nmf_tpu/ops/grid_sample.py``).

Convention of torch ``F.grid_sample(align_corners=True)`` with zeros
padding: the last axis of ``coords`` is (x, y[, z]) in [-1, 1], x indexing
the last array dimension.

The field's queries use ``quad_gather_2d`` and ``line_interp``: one table
row per sample carries every corner it interpolates (the 2x2 neighbourhood
of a plane, the 2 neighbours on a line), gathered by ``TakeRows``, whose
backward is the row scatter-add kernel ``binsum_rows``. The field's normals
come from planes and lines filtered by ``smoothed_derivative_kernels_2d``
with ``conv2d_same`` / ``conv1d_same`` (zero-padded correlations, in f32
on the card: cuDNN's TF32 is off for them).

``live_hw`` / ``live_l`` serve the field's fixed-shape mode: the table is
allocated at its final size and zero-padded, and coordinates map onto its
first ``live`` rows and columns (0-d f32 tensors, so an upsample changes a
value, not a shape). The padded tail only ever appears as the zero-weight
far corner of the last live texel.
"""
import numpy as np
import torch
import torch.nn.functional as F

from .kernels.binsum import binsum_rows


def _unnormalize(coord, size):
    """[-1, 1] -> [0, size - 1] (align_corners=True)."""
    return (coord + 1.0) * 0.5 * (size - 1)


class TakeRows(torch.autograd.Function):
    """``table[idx]`` along axis 0 whose backward accumulates the row
    cotangents with ``binsum_rows`` (read in the table's dtype, summed in
    f32, cast back to the table's dtype), as ``_qg_bwd`` and
    ``take_rows_binsum`` do in nmf_tpu. ``idx``: (N,) int32, every id in
    range."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.num_rows = table.shape[0]
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        d = binsum_rows(idx, g.contiguous(), ctx.num_rows)
        return d.to(g.dtype), None


def grid_sample_1d(line, coords, live_l=None):
    """line: (C, L); coords: (...) in [-1, 1] -> (..., C). Zeros padding
    beyond the first ``live_l`` entries (default: all)."""
    C, L = line.shape
    Ll = L if live_l is None else live_l
    x = _unnormalize(coords, Ll)
    x0 = torch.floor(x)
    w1 = x - x0
    i0 = x0.long()
    i1 = i0 + 1
    v0 = ((i0 >= 0) & (i0 <= Ll - 1)).to(line.dtype)
    v1 = ((i1 >= 0) & (i1 <= Ll - 1)).to(line.dtype)
    g0 = line[:, i0.clamp(0, L - 1)]
    g1 = line[:, i1.clamp(0, L - 1)]
    out = g0 * (v0 * (1 - w1)) + g1 * (v1 * w1)
    return torch.movedim(out, 0, -1)


def grid_sample_2d(plane, coords, live_hw=None):
    """plane: (C, H, W); coords: (..., 2) as (x, y) -> (..., C), over the
    live (H, W) of a padded plane (default: all of it)."""
    C, H, W = plane.shape
    Hl, Wl = (H, W) if live_hw is None else live_hw
    x = _unnormalize(coords[..., 0], Wl)
    y = _unnormalize(coords[..., 1], Hl)
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
        valid = (ix >= 0) & (ix <= Wl - 1) & (iy >= 0) & (iy <= Hl - 1)
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


def _clip_index(xf, live, size):
    """floor(x) clipped to [0, live - 1] in f32, then to [0, size - 1]."""
    if live is not None:
        xf = torch.minimum(torch.clamp(xf, min=0), live - 1)
    return torch.clamp(xf, 0, size - 1).to(torch.int32)


def _quad_prep(plane_shape, coords, live_hw=None):
    """Flat corner index and bilinear weights of quad_gather_2d. The gather
    stride stays the padded W; coordinates unnormalize against the live
    extents."""
    C, H, W = plane_shape
    Hl, Wl = (None, None) if live_hw is None else live_hw
    cx = torch.clamp(coords[..., 0], -1, 1)
    cy = torch.clamp(coords[..., 1], -1, 1)
    x = _unnormalize(cx, W if Wl is None else Wl)
    y = _unnormalize(cy, H if Hl is None else Hl)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    wx = x - x0f
    wy = y - y0f
    return _clip_index(x0f, Wl, W), _clip_index(y0f, Hl, H), wx, wy


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


def quad_gather_2d(plane, coords, live_hw=None):
    """Bilinear 2D sample with ONE table row gathered per sample.

    plane: (C, H, W) in the gather dtype; coords: (..., 2) as (x, y)
    -> (..., C) float32. Equals grid_sample_2d for coords in [-1, 1].
    """
    C, H, W = plane.shape
    ix0, iy0, wx, wy = _quad_prep(plane.shape, coords, live_hw)
    idx = (iy0 * W + ix0).reshape(-1)
    rows = TakeRows.apply(_quad_table(plane), idx)
    rows = rows.reshape(coords.shape[:-1] + (4 * C,))
    return _quad_combine(rows, wx, wy, C)


def line_interp(line, coords, live_l=None):
    """Linear 1D sample, the semantics of nmf_tpu's ``line_interp_matmul``.

    line: (C, L) in the gather dtype; coords: (...) in [-1, 1] (clamped)
    -> (..., C) float32. The interpolation weights are rounded to the
    line's dtype, as the 2-hot matrix of the matmul form is; products
    accumulate in f32. One row of the (L, 2C) table [line_i | line_{i+1}]
    is gathered per sample.
    """
    C, L = line.shape
    x = _unnormalize(torch.clamp(coords, -1, 1),
                     L if live_l is None else live_l)
    x0f = torch.floor(x)
    w1 = x - x0f
    i0 = _clip_index(x0f, live_l, L)
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


def _convolve2d_full(a, b):
    """Full 2D convolution of two small numpy arrays."""
    out = np.zeros((a.shape[0] + b.shape[0] - 1, a.shape[1] + b.shape[1] - 1))
    for i in range(b.shape[0]):
        for j in range(b.shape[1]):
            out[i:i + a.shape[0], j:j + a.shape[1]] += b[i, j] * a
    return out


def smoothed_derivative_kernels_2d(smoothing: float = 1.0):
    """(kx, ky) 5x5 numpy correlation kernels, [row, col]: a normalized 3x3
    gaussian (std ``smoothing``) convolved with the central difference
    -[1, 0, -1] / 2 along the columns (kx) or the rows (ky)."""
    f_blur = np.array([0.0, 1.0, 0.0])
    f_edge = -np.array([1.0, 0.0, -1.0]) / 2.0
    n = np.arange(3) - 1.0
    g1 = np.exp(-(n ** 2) / (2 * (smoothing + 1e-8) ** 2))
    g2 = np.outer(g1, g1)
    g2 = g2 / g2.sum()
    return (_convolve2d_full(g2, np.outer(f_blur, f_edge)),
            _convolve2d_full(g2, np.outer(f_edge, f_blur)))


def _correlate(x, w):
    """Depthwise 'same' correlation of (C, *S) with w (1, 1, *k), k odd,
    zero padding, with cuDNN's TF32 off: in f32 on the card, as nmf_tpu
    filters (cuDNN rounds f32 convolutions to TF32 by default)."""
    conv = F.conv2d if w.dim() == 4 else F.conv1d
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return conv(x[:, None], w, padding=w.shape[-1] // 2)[:, 0]
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class SameCorrelation(torch.autograd.Function):
    """``_correlate`` whose backward is the correlation with the flipped
    kernel (its adjoint for odd k), so the backward is f32 too. The kernel
    takes no gradient."""

    @staticmethod
    def forward(ctx, x, w):
        if w.shape[-1] % 2 == 0:
            raise ValueError(f"'same' correlation needs an odd kernel, got "
                             f"{tuple(w.shape[2:])}")
        ctx.save_for_backward(w)
        return _correlate(x, w)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        return _correlate(g.contiguous(),
                          w.flip(tuple(range(2, w.dim())))), None


def conv2d_same(plane, kern):
    """Depthwise 'same' correlation of (C, H, W) with a (k, k) kernel, zero
    padding."""
    k = kern.shape[0]
    w = torch.as_tensor(kern, dtype=plane.dtype,
                        device=plane.device).reshape(1, 1, k, k)
    return SameCorrelation.apply(plane, w)


def conv1d_same(line, kern):
    """Depthwise 'same' correlation of (C, L) with a (k,) kernel."""
    k = kern.shape[0]
    w = torch.as_tensor(kern, dtype=line.dtype,
                        device=line.device).reshape(1, 1, k)
    return SameCorrelation.apply(line, w)


def max_pool_3d(vol, ks: int = 3):
    """3D max pool of (D, H, W), stride 1, 'same' padding."""
    return F.max_pool3d(vol[None, None], ks, stride=1, padding=ks // 2)[0, 0]
