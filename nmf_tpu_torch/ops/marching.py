"""Marching tetrahedra isosurface extraction (numpy, host-side): the
port's copy of ``nmf_tpu/ops/marching.py``.

nmf_tpu's module replaces the reference's skimage marching-cubes dependency
(utils.py:159-219 convert_sdf_samples_to_ply) with a self-contained
implementation: each grid cube is split into 6 tetrahedra; each tet
contributes 0-2 triangles with vertices linearly interpolated onto the
isolevel. Produces watertight surfaces (more triangles than marching cubes,
same geometry class).
"""
import numpy as np

# canonical 6-tet decomposition of a cube around the main diagonal 0-7;
# corner k sits at offset (k & 1, (k >> 1) & 1, (k >> 2) & 1)
TETS = np.array([
    [0, 1, 3, 7],
    [0, 3, 2, 7],
    [0, 2, 6, 7],
    [0, 6, 4, 7],
    [0, 4, 5, 7],
    [0, 5, 1, 7],
], dtype=np.int32)

CORNER_OFFSETS = np.array(
    [[(k >> 0) & 1, (k >> 1) & 1, (k >> 2) & 1] for k in range(8)],
    dtype=np.int32)


def _interp(p0, p1, v0, v1, level):
    t = (level - v0) / np.where(np.abs(v1 - v0) < 1e-12, 1e-12, v1 - v0)
    t = np.clip(t, 0.0, 1.0)[..., None]
    return p0 + t * (p1 - p0)


def marching_tets(volume, level=0.0):
    """volume: (X, Y, Z) scalar field. Returns (verts (V,3) in index coords,
    faces (F,3) int32). Surface where volume crosses `level`."""
    X, Y, Z = volume.shape
    # cube base indices
    bx, by, bz = np.meshgrid(np.arange(X - 1), np.arange(Y - 1),
                             np.arange(Z - 1), indexing="ij")
    base = np.stack([bx, by, bz], -1).reshape(-1, 3)  # (C, 3)
    # corner positions and values per cube: (C, 8, 3), (C, 8)
    corners = base[:, None, :] + CORNER_OFFSETS[None]
    vals = volume[corners[..., 0], corners[..., 1], corners[..., 2]]

    # only keep cubes that straddle the level
    straddle = (vals.min(1) <= level) & (vals.max(1) >= level)
    corners = corners[straddle].astype(np.float64)
    vals = vals[straddle]
    if corners.shape[0] == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int32)

    tris = []
    for tet in TETS:
        p = corners[:, tet]      # (C, 4, 3)
        v = vals[:, tet]         # (C, 4)
        inside = v > level       # (C, 4)
        code = (inside[:, 0].astype(int) | (inside[:, 1].astype(int) << 1)
                | (inside[:, 2].astype(int) << 2)
                | (inside[:, 3].astype(int) << 3))
        # single-vertex cases (1 triangle)
        for vid in range(4):
            others = [o for o in range(4) if o != vid]
            for c, flip in ((1 << vid, False),
                            (0b1111 ^ (1 << vid), True)):
                m = code == c
                if not m.any():
                    continue
                pv, vv = p[m], v[m]
                e = [_interp(pv[:, vid], pv[:, o], vv[:, vid], vv[:, o],
                             level) for o in others]
                tri = np.stack([e[0], e[2], e[1]] if flip else e, axis=1)
                tris.append(tri)
        # two-vertex cases (2 triangles forming a quad)
        pairs = [((0, 1), (2, 3)), ((0, 2), (1, 3)), ((0, 3), (1, 2))]
        for (a, b), (c_, d) in pairs:
            for code_in, flip in (((1 << a) | (1 << b), False),
                                  ((1 << c_) | (1 << d), True)):
                m = code == code_in
                if not m.any():
                    continue
                pv, vv = p[m], v[m]
                if flip:
                    a_, b_, c2, d2 = c_, d, a, b
                else:
                    a_, b_, c2, d2 = a, b, c_, d
                e_ac = _interp(pv[:, a_], pv[:, c2], vv[:, a_], vv[:, c2], level)
                e_ad = _interp(pv[:, a_], pv[:, d2], vv[:, a_], vv[:, d2], level)
                e_bc = _interp(pv[:, b_], pv[:, c2], vv[:, b_], vv[:, c2], level)
                e_bd = _interp(pv[:, b_], pv[:, d2], vv[:, b_], vv[:, d2], level)
                tris.append(np.stack([e_ac, e_ad, e_bd], axis=1))
                tris.append(np.stack([e_ac, e_bd, e_bc], axis=1))

    if not tris:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int32)
    all_tris = np.concatenate(tris, axis=0)  # (T, 3, 3)
    # weld duplicate vertices
    flat = all_tris.reshape(-1, 3)
    keys = np.round(flat * 1e5).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    verts = np.zeros((uniq.shape[0], 3))
    verts[inv] = flat
    faces = inv.reshape(-1, 3).astype(np.int32)
    # drop degenerate faces
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    return verts, faces[ok]
