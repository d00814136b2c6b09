"""Weight-proportional ray resampling, proposal -> fine quadrature
(``nmf_tpu/ops/resample.py``).

Works in arc length over the occupied (valid) segments: n_fine + 1 sorted
boundaries by inverse CDF of (weight + pad per length), interval midpoints
as the fine positions and interval lengths as their dists, so the fine
intervals partition the occupied span.
"""
import torch


def _lookup(keys, queries, payload, strict=False):
    """For each query q: i = #{k: keys_k <= q} (``< q`` when strict),
    clipped to K - 1, and the payload rows (B, K, C) at i."""
    K = keys.shape[-1]
    idx = torch.searchsorted(keys.contiguous(), queries.contiguous(),
                             right=not strict).clamp(max=K - 1)
    return torch.gather(payload, 1, idx[..., None].expand(
        idx.shape + payload.shape[-1:]))


def resample_pdf(draws, z_vals, dists, weights, valid, n_fine: int,
                 is_train: bool, pad: float = 0.01):
    """Resample n_fine midpoint samples a ray from segment weights.

    z_vals, dists, weights: (B, K); valid: (B, K) bool; proposal sample i
    owns [z_i, z_i + dists_i]. Training draws the stratified boundary
    offsets ``resample`` (B, n_fine + 1) from ``draws``. Returns (z_f (B,
    n_fine) sorted, dists_f, valid_f).
    """
    B, K = z_vals.shape
    eps = 1e-12
    zero = torch.zeros_like(dists)
    dl = torch.where(valid, torch.clamp(dists, min=0.0), zero)
    L = dl.sum(dim=-1, keepdim=True)
    w = (torch.where(valid, weights, zero)
         + pad * dl / torch.clamp(L, min=eps))
    cdf = torch.cumsum(w, dim=-1)
    cdf = cdf / torch.clamp(cdf[:, -1:], min=eps)
    cdf_prev = torch.cat([cdf.new_zeros((B, 1)), cdf[:, :-1]], dim=-1)
    S = torch.cumsum(dl, dim=-1)
    S_prev = S - dl

    nb = n_fine + 1
    dev = z_vals.device
    if is_train:
        u = ((torch.arange(nb, device=dev)
              + draws.uniform("resample", (B, nb), dev)) / nb)
        u = torch.cat([u.new_zeros((B, 1)), u[:, 1:-1],
                       u.new_ones((B, 1))], dim=-1)
    else:
        u = torch.linspace(0.0, 1.0, nb, device=dev)[None].expand(B, nb)
    u = torch.clamp(u, 0.0, 1.0 - 1e-7)

    vb = _lookup(cdf, u, torch.stack([cdf_prev, cdf, dl, S_prev], dim=-1))
    cdf_p, cdf_i, dl_i, S_prev_i = vb.unbind(-1)
    frac = (u - cdf_p) / torch.clamp(cdf_i - cdf_p, min=eps)
    s_b = S_prev_i + frac * dl_i

    dists_f = s_b[:, 1:] - s_b[:, :-1]
    s_mid = 0.5 * (s_b[:, 1:] + s_b[:, :-1])
    # segment i covers (S_prev_i, S_i]: the strict count #{S_k < s}
    vm = _lookup(S, s_mid, torch.stack([z_vals, S_prev], dim=-1),
                 strict=True)
    z_f = vm[..., 0] + (s_mid - vm[..., 1])
    valid_f = (L > eps).expand(B, n_fine)
    return z_f, dists_f, valid_f
