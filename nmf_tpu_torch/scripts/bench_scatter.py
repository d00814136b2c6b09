#!/usr/bin/env python
"""Microbenchmarks of the gather and scatter walls of the train step, on
the card.

    python -m nmf_tpu_torch.scripts.bench_scatter \
        [alpha | scatter | binsum | all]

Port of ``nmf_tpu/scripts/bench_scatter.py``, at its sizes:

1. ``alpha``: the alpha-mask lookup, M = 4096 x 440 single-scalar gathers
   from a G^3 volume (G = 32, 128, 200): f32 and int8 scalar gathers, the
   (row, lane) two-step, and at G = 32 a one-hot product in bf16.
2. ``scatter``: the plane gradient's scatter-add on bf16 payloads, plain
   ``index_add_``, ``argsort`` + ``index_add_`` on the sorted ids, and the
   sort + chunk-combine (``chunk_combine_scatter``), with each variant's
   relative error against plain ``index_add_``.
3. ``binsum``: the row scatter-add kernel K3 (``ops/kernels/binsum.
   binsum_rows``) against ``zeros + index_add_`` at the train step's shapes,
   on uniform ids and on hot ids (90% of the updates on 64 rows).

Times are ``profile_step.timeit``'s (CUDA events); each function also
returns its lines' numbers. Needs a CUDA device.
"""
import math
import sys

import torch

from ..ops.kernels.binsum import binsum_rows
from .profile_step import timeit

ALPHA_M = 4096 * 440
ALPHA_GRIDS = (32, 128, 200)
# (updates M, table rows T, columns D, id distribution)
SCATTER_CASES = ((524288, 16384, 288, "uniform"),
                 (131072, 691456, 12, "hot"),
                 (524288, 16384, 288, "hot"))
BINSUM_CASES = ((262144, 90000, 288, "uniform"),
                (262144, 90000, 288, "hot"),
                (262144, 691456, 12, "hot"),
                (262144, 691456, 12, "uniform"))
HOT_ROWS, HOT_SHARE = 64, 0.9
CHUNK = 128


def make_ids(gen, M, T, dist):
    """(M,) int32 row ids in [0, T) on the generator's device: uniform, or
    "hot": a HOT_SHARE of them drawn from the first HOT_ROWS rows (the
    envmap SAT's collisions), the rest uniform."""
    dev = gen.device
    ids = torch.randint(0, T, (M,), generator=gen, device=dev,
                        dtype=torch.int32)
    if dist == "uniform":
        return ids
    hot = torch.randint(0, HOT_ROWS, (M,), generator=gen, device=dev,
                        dtype=torch.int32)
    return torch.where(torch.rand(M, generator=gen, device=dev) < HOT_SHARE,
                       hot, ids)


def rel_err(ref, got):
    """max |ref - got| / max |ref|, in f32."""
    ref, got = ref.float(), got.float()
    return float((ref - got).abs().max() / (ref.abs().max() + 1e-8))


# ----------------------------------------------------------------- alpha
def alpha_variants(vol, iz, iy, ix):
    """{name: fn()} of the alpha-mask lookups of a binary (G, G, G) volume
    ``vol`` at M cells (iz, iy, ix); each fn returns (M,) values."""
    G = vol.shape[0]
    volf, voli8 = vol.float(), vol.to(torch.int8)
    rows = (iz * G + iy).long()

    def row_lane(v):
        # gather the (z, y) row (G lanes of x), pick lane x
        return torch.gather(v.reshape(G * G, G)[rows], 1, ix[:, None].long())

    variants = {"scalar f32 gather": lambda: volf[iz, iy, ix],
                "scalar int8 gather": lambda: voli8[iz, iy, ix],
                "row+lane f32": lambda: row_lane(volf)[:, 0],
                "row+lane int8": lambda: row_lane(voli8)[:, 0]}
    if G == 32:
        vb = volf.reshape(G * G, G).to(torch.bfloat16)

        def one_hot_mm():
            # one-hot product: (M, G*G) @ (G*G, G) picked by lane
            oh = torch.zeros((rows.shape[0], G * G), dtype=torch.bfloat16,
                             device=vb.device).scatter_(1, rows[:, None],
                                                        1.0)
            return torch.gather(oh @ vb, 1, ix[:, None].long())[:, 0].float()

        variants["one-hot matmul bf16"] = one_hot_mm
    return variants


def bench_alpha(gen, M=ALPHA_M, grids=ALPHA_GRIDS, timer=timeit):
    """Each lookup variant at each grid size; fails unless every variant
    reads the scalar gather's values. Returns [{G, variant, ms}]."""
    dev = gen.device
    out = []
    for G in grids:
        vol = torch.rand((G, G, G), generator=gen, device=dev) > 0.5
        iz, iy, ix = torch.randint(0, G, (3, M), generator=gen, device=dev)
        variants = alpha_variants(vol, iz, iy, ix)
        ref = variants["scalar f32 gather"]()
        for name, fn in variants.items():
            if not torch.equal(fn().float(), ref):
                raise AssertionError(f"alpha G={G} {name}: values differ "
                                     "from the scalar gather's")
            t = timer(fn)
            out.append({"G": G, "variant": name, "ms": t})
            print(f"G={G} {name + ':':30s} {t:8.4f} ms  "
                  f"({t * 1e6 / M:.2f} ns/row)")
    return out


# ----------------------------------------------------------------- scatter
def chunk_combine_scatter(idx, g, T, C=CHUNK, pairs_cap=None):
    """Sort updates by target row, partial-sum runs inside fixed chunks via
    a batched one-hot product, compact the per-chunk uniques, scatter them
    (nmf_tpu's ``_chunk_combine_scatter``).

    idx: (M,) int targets in [0, T); g: (M, D) updates, M a multiple of C.
    Exact: each (chunk, unique-target) pair contributes one scattered row;
    #pairs <= #chunks + #targets, a static bound.
    """
    M, D = g.shape
    n_chunks = M // C
    if pairs_cap is None:
        pairs_cap = 1 << int(math.ceil(math.log2(n_chunks + T + 1)))
    order = torch.argsort(idx, stable=True)
    si = idx[order]                              # (M,) sorted targets
    sg = g[order]                                # (M, D) reordered payload
    ci = si.reshape(n_chunks, C)
    cg = sg.reshape(n_chunks, C, D)
    eq = ci[:, :, None] == ci[:, None, :]        # (n_chunks, C, C)
    part = torch.bmm(eq.to(cg.dtype), cg)
    first = torch.cat([torch.ones((n_chunks, 1), dtype=torch.bool,
                                  device=g.device),
                       ci[:, 1:] != ci[:, :-1]], dim=1)
    # compact first-occurrence rows into the static pairs buffer
    flat_first = first.reshape(-1)
    ord2 = torch.argsort((~flat_first).to(torch.uint8),
                         stable=True)[:pairs_cap]
    tgt = torch.where(flat_first[ord2], si[ord2],
                      torch.full_like(si[ord2], T))   # dump row T
    out = torch.zeros((T + 1, D), dtype=g.dtype, device=g.device)
    return out.index_add_(0, tgt, part.reshape(M, D)[ord2])[:T]


def scatter_variants(idx, g, T):
    """{name: fn()} of the scatter-adds of rows ``g`` (M, D) at ``idx``
    into a fresh (T, D) table in g's dtype."""
    def plain():
        return torch.zeros((T, g.shape[1]), dtype=g.dtype,
                           device=g.device).index_add_(0, idx, g)

    def sorted_add():
        order = torch.argsort(idx)
        return torch.zeros((T, g.shape[1]), dtype=g.dtype,
                           device=g.device).index_add_(0, idx[order],
                                                       g[order])

    return {"plain index_add_": plain, "sort + index_add_": sorted_add,
            "chunk-combine scatter": lambda: chunk_combine_scatter(idx, g, T)}


def bench_scatter(gen, cases=SCATTER_CASES, timer=timeit):
    """Each variant on bf16 payloads, its relative error against plain
    ``index_add_`` and, against the f32 sum of the same payload, its own
    (``f32_err``). Returns [{M, T, D, dist, variant, ms, rel_err,
    f32_err}]."""
    dev = gen.device
    out = []
    for M, T, D, dist in cases:
        idx = make_ids(gen, M, T, dist)
        g = torch.randn((M, D), generator=gen,
                        device=dev).to(torch.bfloat16)
        exact = torch.zeros((T, D), device=dev).index_add_(0, idx, g.float())
        variants = scatter_variants(idx, g, T)
        ref = variants["plain index_add_"]()
        head = f"M={M} T={T} D={D} {dist:8s}"
        for name, fn in variants.items():
            t = timer(fn)
            got = fn()
            row = {"M": M, "T": T, "D": D, "dist": dist, "variant": name,
                   "ms": t, "rel_err": rel_err(ref, got),
                   "f32_err": rel_err(exact, got)}
            out.append(row)
            print(f"{head:28s} {name + ':':24s} {t:8.4f} ms  rel err "
                  f"{row['rel_err']:.2e} (vs f32 sum {row['f32_err']:.2e})")
            head = ""
    return out


def bench_binsum(gen, cases=BINSUM_CASES, timer=timeit):
    """K3 against ``zeros + index_add_`` on f32 rows at the train step's
    shapes: the fine pass's quad-plane gradient (uniform-ish) and the
    envmap SAT's backward (collision-heavy). Returns [{M, T, D, dist,
    index_add_ms, binsum_ms, rel_err, touched}] (touched: the rows the ids
    hit)."""
    dev = gen.device
    out = []
    for M, T, D, dist in cases:
        idx = make_ids(gen, M, T, dist)
        g = torch.randn((M, D), generator=gen, device=dev)

        def base():
            return torch.zeros((T, D), device=dev).index_add_(0, idx, g)

        def kernel():
            return binsum_rows(idx, g, T)

        t0, t1 = timer(base), timer(kernel)
        err = rel_err(base(), kernel())
        out.append({"M": M, "T": T, "D": D, "dist": dist,
                    "index_add_ms": t0, "binsum_ms": t1, "rel_err": err,
                    "touched": int(torch.unique(idx).numel())})
        print(f"M={M} T={T} D={D} {dist:8s} zeros + index_add_: "
              f"{t0:8.4f} ms")
        print(f"{'':28s} K3 binsum_rows:     {t1:8.4f} ms  "
              f"({t0 / max(t1, 1e-9):.2f}x)")
        print(f"{'':28s} binsum rel err:     {err:.2e}")
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    which = argv[0] if argv else "all"
    if which not in ("alpha", "scatter", "binsum", "all"):
        sys.exit(f"bench_scatter: unknown benchmark {which!r}")
    if not torch.cuda.is_available():
        sys.exit("bench_scatter: needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if which in ("alpha", "all"):
        bench_alpha(gen)
    if which in ("scatter", "all"):
        bench_scatter(gen)
    if which in ("binsum", "all"):
        bench_binsum(gen)


if __name__ == "__main__":
    main()
