#!/usr/bin/env python
"""Microbenchmark of the gather layout of the VM factor-plane queries, on
the card.

    python -m nmf_tpu_torch.scripts.bench_gather

Port of ``nmf_tpu/scripts/bench_gather.py``: three stacked planes of
C = 72 x 300 x 300 (bf16 tables cast from f32), M = 4096 x 128 bilinear
queries each. ``gs_cols`` gathers the four corners as columns of the
(C, HW) table (C strided reads a sample); ``gs_rows`` takes rows of the
transposed (HW, C) table through ``ops/grid_sample.TakeRows``, whose
backward is the row scatter-add kernel K3 (N = 524,288, C = 72, R =
90,000 in bf16, 4 corners x 3 planes = 12 launches a forward+backward).
Prints each layout's forward time (with the gathered bytes over it, GB/s)
and forward+backward time (``profile_step.timeit``, CUDA events). Needs
a CUDA device.
"""
import sys

import torch

from ..ops.grid_sample import TakeRows
from .profile_step import timeit

C, H, W = 72, 300, 300
M = 4096 * 128
N_PLANES = 3
CORNERS = ((0, 0), (1, 0), (0, 1), (1, 1))


def _unnorm(c, size):
    return (c + 1.0) * 0.5 * (size - 1)


def corners(coords, H, W):
    """(M, 2) coords in [-1, 1] as (x, y) -> the lower corner's integer
    (ix0, iy0) and the fractional weights (wx, wy)."""
    x = _unnorm(coords[..., 0], W)
    y = _unnorm(coords[..., 1], H)
    x0, y0 = torch.floor(x), torch.floor(y)
    return x0.long(), y0.long(), x - x0, y - y0


def _corner_terms(coords, H, W):
    """For each of the four corners: its (M,) flat table row (clipped in
    range) and its (M,) bilinear weight (0 off the plane)."""
    ix0, iy0, wx, wy = corners(coords, H, W)
    for dx, dy in CORNERS:
        ix, iy = ix0 + dx, iy0 + dy
        w = (wx if dx else (1 - wx)) * (wy if dy else (1 - wy))
        valid = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
        idx = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
        yield idx, torch.where(valid, w, torch.zeros_like(w))


def gs_cols(plane, coords, dtype=torch.bfloat16):
    """Bilinear lookup of a (C, H, W) plane at (M, 2) coords -> (M, C):
    columns of the (C, HW) table in ``dtype``, summed in f32."""
    Cp, Hp, Wp = plane.shape
    flat = plane.reshape(Cp, Hp * Wp).to(dtype)
    out = 0.0
    for idx, w in _corner_terms(coords, Hp, Wp):
        out = out + flat.index_select(1, idx).float() * w
    return out.movedim(0, -1)


def gs_rows(plane, coords, dtype=torch.bfloat16):
    """``gs_cols`` from rows of the transposed (HW, C) table, taken by
    ``TakeRows`` (its backward: K3 on the card)."""
    Cp, Hp, Wp = plane.shape
    flat = plane.reshape(Cp, Hp * Wp).t().contiguous().to(dtype)
    out = 0.0
    for idx, w in _corner_terms(coords, Hp, Wp):
        out = out + TakeRows.apply(flat, idx.to(torch.int32)).float() \
            * w[:, None]
    return out


def stacked(gs, planes, coords):
    """``gs`` over stacked planes (P, C, H, W) and coords (P, M, 2) ->
    (P, M, C)."""
    return torch.stack([gs(p, c) for p, c in zip(planes, coords)])


def stacked_grad(gs, planes, coords):
    """d/d planes of sum(stacked(gs, planes, coords) ** 2)."""
    planes = planes.detach().requires_grad_(True)
    (g,) = torch.autograd.grad((stacked(gs, planes, coords) ** 2).sum(),
                               planes)
    return g


def bench(gen, timer=timeit):
    """Both layouts' lines on the generator's device; returns [{layout,
    fwd_ms, fwd_bwd_ms, gb_per_s}]."""
    dev = gen.device
    planes = torch.randn((N_PLANES, C, H, W), generator=gen, device=dev)
    coords = torch.rand((N_PLANES, M, 2), generator=gen, device=dev) * 2 - 1
    rows = []
    for name, gs in (("cols(C,HW)", gs_cols), ("rows(HW,C)", gs_rows)):
        t_f = timer(lambda: stacked(gs, planes, coords))
        t_b = timer(lambda: stacked_grad(gs, planes, coords))
        gbytes = N_PLANES * M * len(CORNERS) * C * 2 / 1e9
        print(f"{name}: fwd {t_f:.4f} ms ({gbytes / t_f * 1e3:.0f} GB/s) "
              f"fwd+bwd {t_b:.4f} ms")
        rows.append({"layout": name, "fwd_ms": t_f, "fwd_bwd_ms": t_b,
                     "gb_per_s": gbytes / t_f * 1e3})
    return rows


def main(argv=None):
    if not torch.cuda.is_available():
        sys.exit("bench_gather: needs a CUDA device")
    return bench(torch.Generator(device="cuda").manual_seed(0))


if __name__ == "__main__":
    main()
