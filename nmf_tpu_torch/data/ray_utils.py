"""Camera ray generation (host-side numpy; the port's own copy of
``nmf_tpu/data/ray_utils.py``: get_ray_directions,
get_ray_directions_blender, get_rays, ndc_rays_blender, pose_spherical),
and PFM image read / write."""
import re

import numpy as np


def get_ray_directions(H, W, focal, center=None):
    """OpenCV-convention camera ray directions, normalized later by caller.

    focal: (fx, fy). Returns (H, W, 3) with +z forward.
    """
    j, i = np.mgrid[0:H, 0:W].astype(np.float32)
    i = i + 0.5
    j = j + 0.5
    cent = center if center is not None else [W / 2, H / 2]
    directions = np.stack(
        [(i - cent[0]) / focal[0], (j - cent[1]) / focal[1], np.ones_like(i)],
        axis=-1)
    return directions


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


def ndc_rays_blender(H, W, focal, near, rays_o, rays_d):
    """World rays -> NDC rays: shift each origin to the plane z = -near,
    then project (the LLFF convention: camera looking down -z)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d
    o0 = -1.0 / (W / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]
    d0 = -1.0 / (W / (2.0 * focal)) * (
        rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2])
    d1 = -1.0 / (H / (2.0 * focal)) * (
        rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2])
    d2 = -2.0 * near / rays_o[..., 2]
    return (np.stack([o0, o1, o2], -1).astype(np.float32),
            np.stack([d0, d1, d2], -1).astype(np.float32))


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


def read_pfm(filename):
    """A PFM image -> (data (H, W, 3) or (H, W) float32, scale)."""
    with open(filename, "rb") as f:
        header = f.readline().decode("utf-8").rstrip()
        if header not in ("PF", "Pf"):
            raise ValueError("Not a PFM file.")
        dim_match = re.match(r"^(\d+)\s(\d+)\s$", f.readline().decode("utf-8"))
        if not dim_match:
            raise ValueError("Malformed PFM header.")
        width, height = map(int, dim_match.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if header == "PF" else (height, width)
    # PFM stores rows bottom to top
    return np.flipud(data.reshape(shape)), abs(scale)


def write_pfm(filename, image, scale=1.0):
    """Write an (H, W, 3) or (H, W) image as PFM, in the machine's byte
    order (a negative scale says little-endian)."""
    image = np.asarray(image, np.float32)
    color = image.ndim == 3 and image.shape[2] == 3
    with open(filename, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and np.little_endian):
            scale = -scale
        f.write(f"{scale}\n".encode())
        np.flipud(image).tofile(f)
