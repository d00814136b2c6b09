"""NSVF-format and Tanks&Temples dataset loaders (host-side numpy; the
port's copy of ``nmf_tpu/data/nsvf.py``).

bbox.txt scene bounds, intrinsics.txt, pose txt files, rgb/pose folder
pairing with split prefixes (0_train / 1_val / 2_test). Images are read by
``exr.imread_any`` (PIL, or the EXR reader) and resized by
``blender._resize`` (OpenCV's ``INTER_AREA`` in numpy), as the port's
Blender loader reads them.
"""
from pathlib import Path

import numpy as np

from .blender import _resize
from .exr import imread_any as _imread
from .ray_utils import get_ray_directions, get_rays


def _load_intrinsics(path):
    with open(path) as f:
        first = f.readline().split()
    focal = float(first[0])
    cx, cy = (float(first[1]), float(first[2])) if len(first) > 2 else (None,
                                                                        None)
    return focal, cx, cy


def load_nsvf(datadir, split="train", downsample=1.0, white_bg=True):
    datadir = Path(datadir)
    bbox = np.loadtxt(datadir / "bbox.txt").reshape(-1)[:6]
    scene_bbox = bbox.reshape(2, 3).astype(np.float32)
    focal, cx, cy = _load_intrinsics(datadir / "intrinsics.txt")

    prefix = {"train": "0_", "val": "1_", "test": "2_"}[split]
    pose_files = sorted((datadir / "pose").glob(f"{prefix}*"))
    img_files = sorted((datadir / "rgb").glob(f"{prefix}*"))
    if not pose_files:  # some scenes only ship train poses
        pose_files = sorted((datadir / "pose").glob("*"))
        img_files = sorted((datadir / "rgb").glob("*"))

    sample = _imread(img_files[0])
    h, w = int(sample.shape[0] / downsample), int(sample.shape[1] / downsample)
    focal = focal / downsample

    directions = get_ray_directions(h, w, [focal, focal])
    directions = directions / np.linalg.norm(directions, axis=-1,
                                             keepdims=True)
    # NSVF poses are OpenCV-convention c2w
    all_rays, all_rgbs, poses = [], [], []
    for pf, imf in zip(pose_files, img_files):
        c2w = np.loadtxt(pf).astype(np.float32)
        poses.append(c2w)
        img = _imread(imf)
        img = _resize(img, (w, h))
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        img = img.reshape(-1, img.shape[-1])
        if img.shape[-1] == 4:
            # blend alpha onto white (reference nsvf.py:107)
            img = img[:, :3] * img[:, -1:] + (1 - img[:, -1:])
        all_rgbs.append(img)
        rays_o, rays_d = get_rays(directions, c2w)
        all_rays.append(np.concatenate([rays_o, rays_d], -1))

    center = scene_bbox.mean(0)
    radius = np.linalg.norm(scene_bbox[1] - scene_bbox[0]) / 2
    return {
        "all_rays": np.concatenate(all_rays, 0).astype(np.float32),
        "all_rgbs": np.concatenate(all_rgbs, 0).astype(np.float32),
        "poses": np.stack(poses),
        "img_wh": (w, h),
        "focal": focal,
        "near_far": (0.5, 6.0),
        "scene_bbox": scene_bbox,
        "white_bg": white_bg,
    }


def load_tankstemple(datadir, split="train", downsample=1.0, white_bg=True,
                     wh=(1920, 1080)):
    """Tanks&Temples (NSVF release) loader (reference
    dataLoader/tankstemple.py:86-170): matrix intrinsics.txt scaled to the
    working resolution, bbox.txt * 1.2, test split falling back to the val
    prefix, principal-point-centered normalized directions."""
    datadir = Path(datadir)
    scene_bbox = (np.loadtxt(datadir / "bbox.txt").reshape(-1)[:6]
                  .reshape(2, 3).astype(np.float32) * 1.2)
    w, h = int(wh[0] / downsample), int(wh[1] / downsample)
    K = np.loadtxt(datadir / "intrinsics.txt").astype(np.float32)
    K = K.reshape(-1, K.shape[-1]) if K.ndim > 1 else K.reshape(1, -1)
    K = K[:3, :3] if K.shape[0] >= 3 else K
    scale = np.array([w, h], np.float32) / np.array(wh, np.float32)
    K = K.copy()
    K[:2] *= scale.reshape(2, 1)
    fx, fy = float(K[0, 0]), float(K[1, 1])
    cx, cy = float(K[0, 2]), float(K[1, 2])

    prefix = {"train": "0_", "val": "1_", "test": "2_"}[split]
    pose_files = sorted((datadir / "pose").glob(f"{prefix}*"))
    img_files = sorted((datadir / "rgb").glob(f"{prefix}*"))
    if split == "test" and not pose_files:
        # scenes without a held-out split reuse val (tankstemple.py:130-134)
        pose_files = sorted((datadir / "pose").glob("1_*"))
        img_files = sorted((datadir / "rgb").glob("1_*"))

    directions = get_ray_directions(h, w, [fx, fy], center=[cx, cy])
    directions = directions / np.linalg.norm(directions, axis=-1,
                                             keepdims=True)
    all_rays, all_rgbs, poses = [], [], []
    for pf, imf in zip(pose_files, img_files):
        c2w = np.loadtxt(pf).astype(np.float32)
        poses.append(c2w)
        img = _imread(imf)
        img = _resize(img, (w, h))
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        img = img.reshape(-1, img.shape[-1])
        if img.shape[-1] == 4:
            img = img[:, :3] * img[:, -1:] + (1 - img[:, -1:])
        all_rgbs.append(img)
        rays_o, rays_d = get_rays(directions, c2w)
        all_rays.append(np.concatenate([rays_o, rays_d], -1))

    return {
        "all_rays": np.concatenate(all_rays, 0).astype(np.float32),
        "all_rgbs": np.concatenate(all_rgbs, 0).astype(np.float32),
        "poses": np.stack(poses),
        "img_wh": (w, h),
        "focal": fx,
        "near_far": (0.01, 6.0),
        "scene_bbox": scene_bbox,
        "white_bg": True,
    }
