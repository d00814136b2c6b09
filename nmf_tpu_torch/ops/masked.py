"""Static-shape masked ops (``nmf_tpu/ops/masked.py``): transmittance,
masked reductions, fixed-K compaction.

``raw2alpha`` is the plain version of the composite kernel
(``ops/kernels/composite.py``); the renderer goes through the kernel.
"""
import torch


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
