"""Camera ray generation (host-side numpy; the port's own copy of
``nmf_tpu/data/ray_utils.py``: get_ray_directions_blender, get_rays,
pose_spherical)."""
import numpy as np


def get_ray_directions_blender(H, W, focal, center=None):
    """Blender convention: -z forward, +y up. Returns (H, W, 3)."""
    j, i = np.mgrid[0:H, 0:W].astype(np.float32)
    i = i + 0.5
    j = j + 0.5
    cent = center if center is not None else [W / 2, H / 2]
    directions = np.stack(
        [(i - cent[0]) / focal[0], -(j - cent[1]) / focal[1],
         -np.ones_like(i)], axis=-1)
    return directions


def get_rays(directions, c2w):
    """directions: (H, W, 3) camera-frame; c2w: (3/4, 4).
    Returns (rays_o (HW, 3), rays_d (HW, 3))."""
    rays_d = directions @ np.asarray(c2w[:3, :3]).T
    rays_o = np.broadcast_to(np.asarray(c2w[:3, 3]), rays_d.shape)
    return rays_o.reshape(-1, 3).astype(np.float32), \
        rays_d.reshape(-1, 3).astype(np.float32)


def pose_spherical(theta_deg, phi_deg, radius):
    """Camera-to-world for a camera on a sphere looking at the origin
    (blender convention, -z forward)."""
    th = np.deg2rad(theta_deg)
    phi = np.deg2rad(phi_deg)

    trans = np.eye(4)
    trans[2, 3] = radius
    rot_phi = np.eye(4)
    rot_phi[1, 1] = np.cos(phi)
    rot_phi[1, 2] = -np.sin(phi)
    rot_phi[2, 1] = np.sin(phi)
    rot_phi[2, 2] = np.cos(phi)
    rot_th = np.eye(4)
    rot_th[0, 0] = np.cos(th)
    rot_th[0, 2] = -np.sin(th)
    rot_th[2, 0] = np.sin(th)
    rot_th[2, 2] = np.cos(th)
    c2w = rot_th @ rot_phi @ trans
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
                    dtype=np.float64)
    return (flip @ c2w).astype(np.float32)
