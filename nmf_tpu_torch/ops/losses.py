"""Volume-rendering losses (``nmf_tpu/ops/losses.py``)."""
import torch


def distortion_loss(midpoint, weight, dt):
    """mip-NeRF-360 distortion, O(N) prefix-sum form.

    midpoint, weight, dt: (B, N) with midpoints ascending along N. Returns
    the scalar sum over rays of
    sum_ij w_i w_j |m_i - m_j| + 1/3 sum_i w_i^2 dt_i.
    """
    W = torch.cumsum(weight, dim=-1)
    S = torch.cumsum(weight * midpoint, dim=-1)
    bidir = 2 * (weight * (midpoint * (W - weight) - (S - weight * midpoint))
                 ).sum(dim=-1)
    self_term = (weight ** 2 * dt).sum(dim=-1) / 3
    return (bidir + self_term).sum()
