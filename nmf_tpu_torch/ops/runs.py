"""Cell-run merging of ray samples, run-collapsed shading
(``nmf_tpu/ops/runs.py``).

``merge_sample_runs`` collapses each maximal run of consecutive samples in
the same grid cell into one representative sample: the run's summed
transmittance weight, its weight-averaged depth and its summed segment
width. The top ``n_slots`` runs by weight are kept a ray, in along-ray
order. Density is not coarsened: the weights come from the full
per-sample pass.

nmf_tpu looks the per-run sums up with one-hot matmuls, a trick for the
TPU's per-row gather cost; here ``torch.gather`` picks the same values (a
one-hot row selects one value exactly). Ties in the run ranking go to the
lower run index, as ``jax.lax.top_k`` breaks them.
"""
import torch

from .grid_sample import _unnormalize
from .masked import gather_rows


def cell_indices(rf, xyz):
    """Per-axis grid cell of each sample: (..., 4) world xyz -> (..., 3)
    int32. Two samples share all three plane rows and line indices iff
    their rows are equal. A fixed-shape field's cells are those of its
    live resolutions."""
    coords = rf.normalize_coord(xyz)[..., :3]
    live = rf._live3() if hasattr(rf, "_live3") else None
    out = []
    for a in range(3):
        R = int(rf.grid_size[a])
        Rl = R if live is None else live[a]
        x = _unnormalize(torch.clamp(coords[..., a], -1, 1), Rl)
        ix = torch.clamp(torch.floor(x), min=0)
        ix = torch.minimum(ix, torch.as_tensor(Rl - 1, dtype=ix.dtype,
                                               device=ix.device))
        out.append(torch.clamp(ix.to(torch.int32), 0, R - 1))
    return torch.stack(out, dim=-1)


def top_k_indices(x, k: int):
    """Indices of the k largest entries of each row of x (B, N), in
    descending order, ties to the lower index (``jax.lax.top_k``'s
    order)."""
    return torch.sort(x, dim=1, descending=True, stable=True)[1][:, :k]


def merge_sample_runs(cells, z_vals, dists, weight, valid, n_slots: int):
    """Collapse consecutive same-cell samples into per-run slots.

    cells: (B, K, 3) int32; z_vals, dists, weight: (B, K) f32; valid:
    (B, K) bool. Returns (z_m, dists_m, w_m, valid_m), each (B, n_slots)
    in along-ray order: the run's summed weight, its weight-averaged depth
    (the plain mean over its valid samples for a zero-weight run), its
    summed width, and whether it exists and holds a valid sample. Runs
    never span an invalid sample; missing slots are invalid with zero
    weight.
    """
    B, K = weight.shape
    dev = weight.device
    same = ((cells[:, 1:] == cells[:, :-1]).all(-1)
            & valid[:, 1:] & valid[:, :-1])
    starts = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev),
                        ~same], dim=1)
    zero = torch.zeros_like(weight)
    w = torch.where(valid, weight, zero)
    vf = valid.to(torch.float32)
    # the j-th run's start per ray, ascending; K: no such run
    kk = torch.arange(K, device=dev)[None].expand(B, K)
    startpos = torch.sort(torch.where(starts, kk, K), dim=1)[0]
    has = startpos < K
    nextpos = torch.cat([startpos[:, 1:],
                         torch.full((B, 1), K, device=dev,
                                    dtype=startpos.dtype)], dim=1)

    # per-run sums as differences of padded cumulative sums
    stack = torch.stack([w, w * z_vals, torch.where(valid, dists, zero), vf,
                         vf * z_vals], dim=-1)
    cp = torch.cat([stack.new_zeros((B, 1, 5)), torch.cumsum(stack, dim=1)],
                   dim=1)
    seg = gather_rows(cp, nextpos) - gather_rows(cp, startpos)
    W = seg[..., 0]

    # the top n_slots runs by weight, back in along-ray order
    jsel = torch.sort(top_k_indices(
        torch.where(has, W, torch.full_like(W, -1.0)), n_slots), dim=1)[0]
    sel = torch.cat([seg, has.to(torch.float32)[..., None]], dim=-1)
    W_m, WZ_m, D_m, V_m, VZ_m, has_m = gather_rows(sel, jsel).unbind(-1)

    valid_m = (has_m > 0.5) & (V_m > 0.5)
    eps = 1e-12
    z_w = WZ_m / torch.clamp(W_m, min=eps)
    z_u = VZ_m / torch.clamp(V_m, min=1.0)
    z_m = torch.where(W_m > eps, z_w, z_u)
    return z_m, D_m, W_m, valid_m
