"""LLFF forward-facing scenes (host-side numpy; the port's copy of
``nmf_tpu/data/llff.py``).

``load_llff`` reads ``poses_bounds.npy`` (one row of 17 a view: a 3 x 5
matrix of the camera-to-world rotation and position in down-right-back
axes with a column of (H, W, focal), then the near and far bounds) and the
images under ``images/``, converts the axes to right-up-back, recentres the
poses on their average, scales the scene so that 0.75 x the nearest bound
becomes 1, holds out every ``hold_every``-th view for the test split,
resizes with ``resize.resize_area`` (OpenCV's ``INTER_AREA``) and, with
``ndc_ray``, converts the rays to NDC (near plane 1) with the fixed NDC
scene box. ``save_llff_scene`` writes a scene in the same layout.
"""
from pathlib import Path

import numpy as np

from .blender import _resize
from .exr import imread_any, write_png
from .ray_utils import get_rays, ndc_rays_blender

# the scene box of NDC rays
NDC_BBOX = np.array([[-1.5, -1.67, -1.0], [1.5, 1.67, 1.0]], np.float32)


def _normalize(v):
    return v / (np.linalg.norm(v) + 1e-10)


def average_poses(poses):
    """The central camera-to-world (3, 4) of poses (N, 3, 4): the mean
    centre, the mean z axis and the mean y axis made orthonormal."""
    center = poses[..., 3].mean(0)
    z = _normalize(poses[..., 2].mean(0))
    y_ = poses[..., 1].mean(0)
    x = _normalize(np.cross(y_, z))
    y = np.cross(z, x)
    return np.stack([x, y, z, center], 1)


def center_poses(poses):
    """Poses (N, 3, 4) in the frame of their average pose -> (centred
    poses, the average pose as a 4 x 4)."""
    avg_h = np.eye(4)
    avg_h[:3] = average_poses(poses)
    last = np.broadcast_to(np.array([0, 0, 0, 1.0]), (len(poses), 1, 4))
    poses_h = np.concatenate([poses, last], 1)
    centered = np.linalg.inv(avg_h) @ poses_h
    return centered[:, :3], avg_h


def create_spiral_poses(radii, focus_depth, n_poses=120, n_circles=2):
    """Camera-to-world poses (n_poses, 3, 4) on a spiral of ``radii``
    (3,) looking at the point ``focus_depth`` in front."""
    poses = []
    for t in np.linspace(0, n_circles * 2 * np.pi, n_poses + 1)[:-1]:
        center = np.array([np.cos(t), -np.sin(t), -np.sin(0.5 * t)]) * radii
        z = _normalize(center - np.array([0, 0, -focus_depth]))
        x = _normalize(np.cross(np.array([0, 1.0, 0]), z))
        y = np.cross(z, x)
        poses.append(np.stack([x, y, z, center], 1))
    return np.stack(poses)


def image_paths(datadir):
    """The scene's images, ``images/*.{png,jpg,JPG,jpeg}`` sorted by
    path."""
    folder = Path(datadir) / "images"
    return sorted(str(p) for ext in ("*.png", "*.jpg", "*.JPG", "*.jpeg")
                  for p in folder.glob(ext))


def load_llff(datadir, split="train", downsample=4.0, hold_every=8,
              ndc_ray=True):
    """Returns the standard dataset dict (all_rays (N, 6), all_rgbs
    (N, 3), poses, img_wh, focal, near_far, scene_bbox, white_bg,
    ndc_ray): near_far (0, 1) with NDC rays, else the scaled bounds'
    extremes."""
    datadir = Path(datadir)
    poses_bounds = np.load(datadir / "poses_bounds.npy")  # (N, 17)
    paths = image_paths(datadir)
    if len(poses_bounds) != len(paths):
        raise ValueError(f"{datadir}: {len(poses_bounds)} poses vs "
                         f"{len(paths)} images")

    poses = poses_bounds[:, :15].reshape(-1, 3, 5)
    bounds = poses_bounds[:, -2:]
    H, W, focal = poses[0, :, -1]
    focal = focal / downsample
    w, h = int(W / downsample), int(H / downsample)

    # (down right back) -> (right up back)
    poses = np.concatenate(
        [poses[..., 1:2], -poses[..., :1], poses[..., 2:4]], -1)
    poses, _ = center_poses(poses)
    scale = bounds.min() * 0.75
    bounds /= scale
    poses[..., 3] /= scale

    directions = np.stack([
        (np.arange(w)[None, :].repeat(h, 0) - w / 2 + 0.5) / focal,
        -(np.arange(h)[:, None].repeat(w, 1) - h / 2 + 0.5) / focal,
        -np.ones((h, w))], -1).astype(np.float32)

    i_test = np.arange(0, len(poses), hold_every)
    idxs = (np.array([i for i in range(len(poses)) if i not in i_test])
            if split == "train" else i_test)

    all_rays, all_rgbs = [], []
    for i in idxs:
        img = _resize(imread_any(paths[i])[..., :3], (w, h))
        all_rgbs.append(img.reshape(-1, 3))
        rays_o, rays_d = get_rays(directions, poses[i])
        if ndc_ray:
            rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
            rays_o, rays_d = ndc_rays_blender(h, w, focal, 1.0, rays_o,
                                              rays_d)
        all_rays.append(np.concatenate([rays_o, rays_d], -1))

    return {
        "all_rays": np.concatenate(all_rays, 0).astype(np.float32),
        "all_rgbs": np.concatenate(all_rgbs, 0).astype(np.float32),
        "poses": poses[idxs],
        "img_wh": (w, h),
        "focal": focal,
        "near_far": (0.0, 1.0) if ndc_ray else (float(bounds.min()),
                                                float(bounds.max())),
        "scene_bbox": NDC_BBOX.copy(),
        "white_bg": False,
        "ndc_ray": ndc_ray,
    }


def save_llff_scene(scenedir, poses, images, focal, bounds):
    """Write a scene in the LLFF layout that ``load_llff`` reads:
    ``images/{i:03d}.png`` (8-bit RGB, rounded to nearest) and
    ``poses_bounds.npy``, a row of 17 a view: the camera-to-world
    ``poses[i]`` (3, 4; right-up-back axes) as down-right-back columns
    with (H, W, focal), then ``bounds[i]`` (near, far). ``images``: an
    iterable of (H, W, 3) float arrays, so a generator may make the views
    one at a time."""
    scenedir = Path(scenedir)
    (scenedir / "images").mkdir(parents=True, exist_ok=True)
    rows = []
    for i, (pose, img) in enumerate(zip(poses, images)):
        write_png(scenedir / "images" / f"{i:03d}.png",
                  np.round(np.clip(img, 0, 1) * 255).astype(np.uint8))
        pose = np.asarray(pose, np.float64)
        H, W = img.shape[:2]
        mat = np.stack([-pose[:, 1], pose[:, 0], pose[:, 2], pose[:, 3],
                        np.array([H, W, focal], np.float64)], -1)
        rows.append(np.concatenate([mat.reshape(15), bounds[i]]))
    np.save(scenedir / "poses_bounds.npy", np.stack(rows))
