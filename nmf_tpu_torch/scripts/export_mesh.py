"""Extract a triangle mesh from a trained field (the port's
``nmf_tpu/scripts/export_mesh.py``).

The field's density is queried on a reso^3 lattice over its box, in chunks
of 2^18 points on the checkpoint's device, and marched on the host by
``ops/marching.marching_tets`` at ``min(level, max / 2)``. The mesh is
written as a binary little-endian PLY (float xyz vertices, uchar-counted
int faces), record for record as nmf_tpu writes it.

Usage:
    python -m nmf_tpu_torch.scripts.export_mesh ckpt.th out.ply [--reso 256]
        [--level 5] [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

CHUNK = 1 << 18


@torch.no_grad()
def density_volume(nmf, reso=256):
    """(the density on the reso^3 lattice over the field's box, (X, Y, Z)
    indexed as x, y, z; the box (2, 3) as numpy)."""
    aabb = nmf.rf.aabb.detach().cpu().numpy()
    lin = [np.linspace(aabb[0][i], aabb[1][i], reso) for i in range(3)]
    gx, gy, gz = np.meshgrid(*lin, indexing="ij")
    xyz = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float32)
    dev = nmf.rf.aabb.device
    sigmas = []
    for i in range(0, xyz.shape[0], CHUNK):
        s = nmf.rf.compute_densityfeature(
            torch.from_numpy(xyz[i:i + CHUNK]).to(dev))
        sigmas.append(s.float().cpu().numpy())
    return np.concatenate(sigmas).reshape(reso, reso, reso), aabb


def export_mesh(nmf, path, reso=256, level=5.0, times=None):
    """March the field's density volume at ``min(level, max / 2)`` and
    write the mesh to ``path``; returns (verts (V, 3) in world units,
    faces (F, 3)). ``times``, if given, takes the seconds of the density
    query (``density``) and of the marching (``marching``)."""
    from ..ops.marching import marching_tets

    t0 = time.time()
    vol, aabb = density_volume(nmf, reso)
    t1 = time.time()
    level = min(level, float(vol.max()) * 0.5)
    verts, faces = marching_tets(vol, level=level)
    scale = (aabb[1] - aabb[0]) / (reso - 1)
    verts = verts * scale + aabb[0]
    if times is not None:
        times.update(density=t1 - t0, marching=time.time() - t1)
    _write_ply(path, verts, faces)
    return verts, faces


def _write_ply(path, verts, faces):
    with open(path, "wb") as f:
        header = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(verts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n")
        f.write(header.encode())
        f.write(verts.astype("<f4").tobytes())
        face_rec = np.empty(len(faces),
                            dtype=[("n", "u1"), ("idx", "<i4", 3)])
        face_rec["n"] = 3
        face_rec["idx"] = faces
        f.write(face_rec.tobytes())


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("ckpt")
    p.add_argument("output")
    p.add_argument("--reso", type=int, default=256)
    p.add_argument("--level", type=float, default=5.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from .. import ckpt as ckpt_lib

    nmf, _, _ = ckpt_lib.load(args.ckpt, device=args.device)
    times = {}
    verts, faces = export_mesh(nmf, args.output, reso=args.reso,
                               level=args.level, times=times)
    print(f"wrote {args.output}: {len(verts)} verts, {len(faces)} faces "
          f"(density {times['density']:.2f} s, marching "
          f"{times['marching']:.2f} s)")
    return {"verts": verts, "faces": faces, **times}


if __name__ == "__main__":
    main()
