"""Procedural sphere scene with analytic ground truth (the port's own copy of
``make_sphere_dataset`` from ``nmf_tpu/data/synthetic.py``), so end-to-end
training runs without external data."""
import numpy as np

from .ray_utils import get_ray_directions_blender, get_rays, pose_spherical


def _sphere_hit(rays_o, rays_d, center, radius):
    """Ray-sphere intersection. Returns (hit mask, t, normal)."""
    oc = rays_o - center
    b = np.sum(oc * rays_d, axis=-1)
    c = np.sum(oc * oc, axis=-1) - radius ** 2
    disc = b * b - c
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0))
    hit = hit & (t > 0)
    p = rays_o + t[..., None] * rays_d
    n = (p - center) / radius
    return hit, t, n


def render_sphere_scene(rays_o, rays_d, bg_col=(1.0, 1.0, 1.0)):
    """Analytic GT: a red diffuse sphere at origin with simple head-light
    shading. rays_d must be normalized."""
    hit, t, n = _sphere_hit(rays_o, rays_d, np.zeros(3), 0.8)
    lam = np.clip(np.sum(-rays_d * n, axis=-1), 0, 1)
    base = np.array([0.85, 0.15, 0.1])
    rgb = 0.2 * base + 0.8 * base * lam[..., None]
    out = np.broadcast_to(np.asarray(bg_col, dtype=np.float32),
                          rgb.shape).copy()
    out[hit] = rgb[hit]
    alpha = hit.astype(np.float32)
    return out.astype(np.float32), alpha, t


def make_sphere_dataset(n_views=8, H=64, W=64, radius=4.0, seed=0,
                        phi_deg=-30.0):
    """Returns dict with all_rays (N,6), all_rgbs (N,3), plus per-image
    stacks and camera info (mirrors BlenderDataset's precomputed fields,
    dataLoader/blender.py:118-258)."""
    focal = 0.5 * W / np.tan(0.5 * np.deg2rad(60.0))
    directions = get_ray_directions_blender(H, W, [focal, focal])
    directions = directions / np.linalg.norm(directions, axis=-1,
                                             keepdims=True)
    all_rays, all_rgbs = [], []
    poses = []
    for i in range(n_views):
        theta = 360.0 * i / n_views
        c2w = pose_spherical(theta, phi_deg, radius)
        poses.append(c2w)
        rays_o, rays_d = get_rays(directions, c2w)
        rgb, alpha, _ = render_sphere_scene(rays_o, rays_d)
        all_rays.append(np.concatenate([rays_o, rays_d], axis=-1))
        all_rgbs.append(rgb)
    return {
        "all_rays": np.concatenate(all_rays, 0),
        "all_rgbs": np.concatenate(all_rgbs, 0),
        "poses": np.stack(poses),
        "img_wh": (W, H),
        "focal": focal,
        "near_far": (radius - 1.5, radius + 1.5),
        "scene_bbox": np.array([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]],
                               dtype=np.float32),
        "white_bg": True,
    }

