"""Static-shape masked ops (``nmf_tpu/ops/masked.py``): transmittance,
masked reductions, fixed-K compaction, segment sums and row gathers.

``raw2alpha`` is the plain version of the composite kernel
(``ops/kernels/composite.py``); the renderer goes through the kernel. The
segment sums and the backward of the row gathers go through the row
scatter-add kernel ``binsum_rows``.
"""
import torch

from .kernels.binsum import binsum_rows


def raw2alpha(sigma, dist):
    """sigma, dist: (B, N) -> (weights (B, N), transmittance_tail (B,)).

    weights[i, j] = alpha_ij * prod_{k<j} (1 - alpha_ik + 1e-10).
    """
    alpha = 1.0 - torch.exp(-sigma * dist)
    one_m = torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10],
                      dim=-1)
    T = torch.cumprod(one_m, dim=-1)
    return alpha * T[:, :-1], T[:, -1]


def row_mask_sum(values, mask):
    """values: (B, N, D), mask: (B, N) -> (B, D). Masked sum over samples."""
    return (values * mask[..., None].to(values.dtype)).sum(dim=1)


def compact_topk(valid, k: int):
    """Positions of the first (along axis 1) up-to-k valid entries per row.

    valid: (B, N) bool. Returns (idx (B, k) int64, keep (B, k) bool): a
    stable sort on ~valid sinks invalid entries to the end while valid
    entries keep their order.
    """
    order = torch.sort((~valid).to(torch.uint8), dim=1, stable=True)[1]
    idx = order[:, :k]
    counts = valid.sum(dim=1, keepdim=True)
    keep = torch.arange(k, device=valid.device)[None, :] < counts
    return idx, keep


def gather_rows(x, idx):
    """x: (B, N, ...) gathered at idx: (B, k) -> (B, k, ...)."""
    idx_e = idx.reshape(idx.shape + (1,) * (x.ndim - 2))
    return torch.gather(x, 1, idx_e.expand(idx.shape + x.shape[2:]))


class _SegmentSum(torch.autograd.Function):
    """Row scatter-add through ``binsum_rows`` (ids out of range dropped);
    the backward is the row gather of the cotangent."""

    @staticmethod
    def forward(ctx, vals, ids, num_segments):
        ctx.save_for_backward(ids)
        ctx.num_segments = num_segments
        return binsum_rows(ids, vals, num_segments)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        n = ctx.num_segments
        keep = ((ids >= 0) & (ids < n))[:, None]
        dv = g.index_select(0, ids.clamp(0, n - 1).long())
        return torch.where(keep, dv, torch.zeros_like(dv)), None, None


def segment_sum_to(values, seg_ids, valid, num_segments: int):
    """Sum the valid rows of values (R, D) f32 into (num_segments, D) by
    segment id (R,). Invalid rows are parked at an out-of-range id, which
    the kernel drops."""
    vals = torch.where(valid[:, None], values, torch.zeros_like(values))
    ids = torch.where(valid, seg_ids, torch.full_like(seg_ids, num_segments))
    return _SegmentSum.apply(vals.contiguous(), ids.to(torch.int32),
                             num_segments)


def take_rows_binsum(x, idx):
    """``x[idx]`` along axis 0 whose backward scatter-add is ``binsum_rows``
    (``ops/grid_sample.TakeRows``)."""
    from .grid_sample import TakeRows

    return TakeRows.apply(x, idx.to(torch.int32))
