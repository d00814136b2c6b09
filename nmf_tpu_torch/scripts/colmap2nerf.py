"""Convert a COLMAP text reconstruction to transforms.json (host-side
numpy; the port's copy of ``nmf_tpu/scripts/colmap2nerf.py``).

Reads cameras.txt/images.txt from a COLMAP sparse model, recenters the
scene, and writes a blender-style transforms file.

Usage:
    python -m nmf_tpu_torch.scripts.colmap2nerf --text sparse/0 \
        --images images --out transforms.json
"""
import argparse
import json
import math
import os
from pathlib import Path

import numpy as np


def qvec2rotmat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w,
         2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z,
         2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w,
         1 - 2 * x * x - 2 * y * y],
    ])


def read_cameras_text(path):
    cams = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            el = line.split()
            cam_id, model = int(el[0]), el[1]
            w, h = float(el[2]), float(el[3])
            params = [float(x) for x in el[4:]]
            if model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL"):
                fl_x = fl_y = params[0]
                cx, cy = params[1], params[2]
            elif model in ("PINHOLE", "OPENCV"):
                fl_x, fl_y, cx, cy = params[0], params[1], params[2], params[3]
            else:
                raise ValueError(f"unsupported camera model {model}")
            cams[cam_id] = dict(w=w, h=h, fl_x=fl_x, fl_y=fl_y, cx=cx, cy=cy)
    return cams


def read_images_text(path):
    ims = []
    with open(path) as f:
        lines = [l for l in f if not l.startswith("#") and l.strip()]
    for line in lines[::2]:  # every other line is 2D points
        el = line.split()
        q = np.array([float(x) for x in el[1:5]])
        t = np.array([float(x) for x in el[5:8]])
        cam_id = int(el[8])
        name = el[9]
        ims.append((name, q, t, cam_id))
    return ims


def convert(text_dir, images_dir="images", out_path="transforms.json",
            aabb_scale=4):
    text_dir = Path(text_dir)
    cams = read_cameras_text(text_dir / "cameras.txt")
    ims = read_images_text(text_dir / "images.txt")
    cam = next(iter(cams.values()))

    frames = []
    for name, q, t, cam_id in sorted(ims):
        R = qvec2rotmat(q)
        # COLMAP gives world->cam; invert to c2w
        c2w = np.eye(4)
        c2w[:3, :3] = R.T
        c2w[:3, 3] = -R.T @ t
        # opencv -> blender camera convention (flip y, z)
        c2w[:3, 1:3] *= -1
        frames.append({
            "file_path": os.path.join(images_dir, name),
            "transform_matrix": c2w.tolist(),
        })

    # recenter: subtract mean camera position, scale to unit-ish box
    centers = np.array([f["transform_matrix"] for f in frames])[:, :3, 3]
    center = centers.mean(0)
    scale = 2.0 / max(np.abs(centers - center).max(), 1e-6)
    for f in frames:
        m = np.array(f["transform_matrix"])
        m[:3, 3] = (m[:3, 3] - center) * scale
        f["transform_matrix"] = m.tolist()

    meta = {
        "camera_angle_x": float(2 * math.atan(cam["w"] / (2 * cam["fl_x"]))),
        "fl_x": cam["fl_x"], "fl_y": cam["fl_y"],
        "w": int(cam["w"]), "h": int(cam["h"]),
        "aabb_scale": aabb_scale,
        "frames": frames,
    }
    with open(out_path, "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--text", required=True, help="COLMAP sparse text dir")
    p.add_argument("--images", default="images")
    p.add_argument("--out", default="transforms.json")
    p.add_argument("--aabb_scale", type=int, default=4)
    a = p.parse_args(argv)
    meta = convert(a.text, a.images, a.out, a.aabb_scale)
    print(f"wrote {a.out} with {len(meta['frames'])} frames")


if __name__ == "__main__":
    main()
