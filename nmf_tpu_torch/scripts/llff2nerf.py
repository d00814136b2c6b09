"""Convert an LLFF capture (poses_bounds.npy) to transforms.json
(host-side numpy; the port's copy of ``nmf_tpu/scripts/llff2nerf.py``).

Produces a blender-style transforms file so LLFF captures can be trained
through the blender/own_data loader path.

Usage: python -m nmf_tpu_torch.scripts.llff2nerf <scene_dir>
           [--out transforms.json]
"""
import argparse
import glob
import json
import os
from pathlib import Path

import numpy as np


def convert(scene_dir, out_name="transforms.json", aabb_scale=4):
    scene_dir = Path(scene_dir)
    pb = np.load(scene_dir / "poses_bounds.npy")
    poses = pb[:, :15].reshape(-1, 3, 5)
    H, W, focal = poses[0, :, 4]
    # (down right back) -> (right up back)
    poses = np.concatenate(
        [poses[..., 1:2], -poses[..., 0:1], poses[..., 2:4]], -1)
    images = sorted(sum([glob.glob(str(scene_dir / "images" / e))
                         for e in ("*.png", "*.jpg", "*.JPG")], []))
    frames = []
    for i, img in enumerate(images):
        mat = np.eye(4)
        mat[:3, :4] = poses[i]
        frames.append({
            "file_path": os.path.relpath(img, scene_dir),
            "transform_matrix": mat.tolist(),
        })
    meta = {
        "camera_angle_x": float(2 * np.arctan(W / (2 * focal))),
        "w": int(W),
        "h": int(H),
        "aabb_scale": aabb_scale,
        "frames": frames,
    }
    with open(scene_dir / out_name, "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("scene_dir")
    p.add_argument("--out", default="transforms.json")
    p.add_argument("--aabb_scale", type=int, default=4)
    a = p.parse_args(argv)
    meta = convert(a.scene_dir, a.out, a.aabb_scale)
    print(f"wrote {a.out} with {len(meta['frames'])} frames")


if __name__ == "__main__":
    main()
