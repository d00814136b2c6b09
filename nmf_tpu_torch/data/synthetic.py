"""Procedural scenes with analytic ground truth (the port's own copy of
``nmf_tpu/data/synthetic.py``), so end-to-end training runs without
external data: the red ``synthetic_sphere`` (also as a forward-facing
capture, ``forward_facing_sphere``, for the LLFF layout), and the protocol
scenes
``synthetic_shiny`` / ``_cluster`` / ``_studio`` (spheres of tabulated
materials under an analytic HDR environment, split-sum direct shading plus
a one-bounce Monte Carlo interreflection correction, two elevation rings or
a stratified hemisphere of cameras; they also give the ground-truth
normals, tints and environment panorama).

The protocol scenes are memoized as ``.npz`` files under
``runs/.dataset_cache`` (``NMF_DATASET_CACHE`` moves it; empty disables
it), keyed on the arguments and on a hash of this module's own sources,
under a ``torch_`` prefix: the cache never serves nmf_tpu's files, nor
nmf_tpu the port's.
"""
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

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


# rows of a forward-facing view rendered in one task of the thread pool
BAND_ROWS = 256


def threaded_map(fn, items):
    """Yields ``fn`` of each of ``items`` in order, computed on up to 8
    threads (numpy releases the interpreter lock in its array
    operations)."""
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        yield from pool.map(fn, items)


def forward_facing_sphere(n_views=20, H=3024, W=4032, focal=3260.0):
    """The red sphere seen from a forward-facing capture: cameras on a grid
    five wide in the plane z = 4, 0.2 apart and centred, all looking down
    -z (Blender axes: right, up, back). Returns (poses (n_views, 3, 4),
    views, bounds (n_views, 2)): ``views`` yields each (H, W, 3) image on
    white in turn, rendered in bands of ``BAND_ROWS`` rows by
    ``threaded_map`` (a view of fern's 4032 x 3024 is 12.2M rays);
    ``bounds`` are the near and far depths of the sphere (radius 0.8)
    along each camera's axis, 0.1 wider on each side."""
    cols = np.arange(n_views) % 5
    rows = np.arange(n_views) // 5
    centers = np.stack([0.2 * (cols - 2.0), 0.2 * (rows - (rows.max() / 2)),
                        np.full(n_views, 4.0)], -1)
    poses = np.concatenate([np.broadcast_to(np.eye(3), (n_views, 3, 3)),
                            centers[..., None]], -1)
    bounds = np.stack([centers[:, 2] - 0.9, centers[:, 2] + 0.9], -1)
    dirs = get_ray_directions_blender(H, W, [focal, focal])
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)

    def view(c2w):
        img = np.empty((H, W, 3), np.float32)

        def render_band(r0):
            band = dirs[r0:r0 + BAND_ROWS]
            rgb, _, _ = render_sphere_scene(*get_rays(band, c2w))
            img[r0:r0 + BAND_ROWS] = rgb.reshape(band.shape)

        list(threaded_map(render_band, range(0, H, BAND_ROWS)))
        return img

    return poses, (view(c2w) for c2w in poses), bounds


_SHINY_SPHERES = [
    # center, radius, albedo, f0 color (tint), roughness
    (np.array([-0.72, -0.5, -0.1]), 0.48, np.array([0.2, 0.05, 0.05]),
     np.array([1.0, 0.71, 0.29]), 0.08),   # gold, near-mirror
    (np.array([0.72, -0.5, -0.1]), 0.48, np.array([0.05, 0.08, 0.35]),
     np.array([0.04, 0.04, 0.04]), 0.5),   # blue dielectric, rough
    (np.array([0.0, 0.62, 0.15]), 0.52, np.array([0.06, 0.06, 0.06]),
     np.array([0.95, 0.93, 0.88]), 0.22),  # silver, medium
]

# Second protocol scene: a tight cluster around a large near-mirror ball.
# Mutual solid angles are big, so one-bounce interreflections (which the
# MC GT term renders and the microfacet model's retrace pass can actually
# fit) dominate the specular content -- the scene that separates NMF from
# env-only shading models.
_CLUSTER_SPHERES = [
    (np.array([0.0, 0.0, 0.05]), 0.62, np.array([0.04, 0.04, 0.04]),
     np.array([0.95, 0.93, 0.88]), 0.03),   # big silver mirror
    (np.array([-0.85, -0.35, -0.35]), 0.35, np.array([0.18, 0.06, 0.02]),
     np.array([1.0, 0.71, 0.29]), 0.25),    # gold, glossy
    (np.array([0.75, -0.5, -0.3]), 0.32, np.array([0.1, 0.12, 0.45]),
     np.array([0.04, 0.04, 0.04]), 0.12),   # blue dielectric, sharp
    (np.array([0.15, 0.85, -0.4]), 0.3, np.array([0.2, 0.1, 0.05]),
     np.array([0.95, 0.64, 0.54]), 0.5),    # copper, rough
]


# Third protocol scene: a WELL-POSED inverse-rendering arrangement. The
# shiny/cluster scenes are intentionally brutal (dark near-pure-specular
# spheres: geometry is unanchored by diffuse multiview consistency and the
# envmap is under-determined -- the identifiability oracle's null space,
# BASELINE.md). Studio adds what real capture scenes have: bright diffuse
# anchors (rough 0.9+, albedo 0.7) that pin geometry and the envmap's
# coarse scales, a mid-roughness glossy pair filling the footprint
# spectrum, and ONE near-mirror ball exercising the retrace/envmap path.
# On this scene the NMF decomposition is identifiable, so it carries the
# framework's quality-parity headline.
_STUDIO_SPHERES = [
    (np.array([0.0, -0.15, 0.3]), 0.48, np.array([0.03, 0.03, 0.03]),
     np.array([0.95, 0.93, 0.88]), 0.04),   # silver near-mirror (the test)
    (np.array([-0.85, -0.45, -0.25]), 0.38, np.array([0.5, 0.09, 0.06]),
     np.array([0.03, 0.03, 0.03]), 0.9),    # bright red diffuse anchor
    (np.array([0.85, -0.45, -0.25]), 0.38, np.array([0.45, 0.44, 0.4]),
     np.array([0.03, 0.03, 0.03]), 0.95),   # bright neutral diffuse anchor
    (np.array([-0.15, 0.85, -0.3]), 0.34, np.array([0.15, 0.08, 0.02]),
     np.array([1.0, 0.71, 0.29]), 0.2),     # gold glossy (mid roughness)
    (np.array([0.55, 0.55, -0.42]), 0.3, np.array([0.08, 0.25, 0.5]),
     np.array([0.04, 0.04, 0.04]), 0.45),   # blue semi-rough
]


def shiny_env_fn(dirs):
    """Analytic HDR environment (returns linear radiance, (N, 3))."""
    d = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    c = d[..., 2]
    up = np.clip(c, 0, 1)[..., None]
    sky = (np.array([0.35, 0.5, 0.85]) * up
           + np.array([0.9, 0.85, 0.8]) * (1 - up))
    ground = np.array([0.25, 0.2, 0.16])
    base = np.where(c[..., None] >= 0, sky, ground[None])
    sun_dir = np.array([0.55, 0.35, 0.76])
    sun_dir /= np.linalg.norm(sun_dir)
    sun = np.clip((d * sun_dir).sum(-1), 0, 1)[..., None] ** 600
    lobe1_dir = np.array([-0.7, 0.5, 0.3])
    lobe1_dir /= np.linalg.norm(lobe1_dir)
    lobe1 = np.clip((d * lobe1_dir).sum(-1), 0, 1)[..., None] ** 40
    lobe2_dir = np.array([0.2, -0.9, 0.1])
    lobe2_dir /= np.linalg.norm(lobe2_dir)
    lobe2 = np.clip((d * lobe2_dir).sum(-1), 0, 1)[..., None] ** 40
    return (base + 40.0 * sun * np.array([1.0, 0.95, 0.85])
            + 2.5 * lobe1 * np.array([0.9, 0.3, 0.2])
            + 1.8 * lobe2 * np.array([0.2, 0.7, 0.9])).astype(np.float32)


def equirect_dirs(H, W):
    """Directions for each texel in the IntegralEquirect orientation
    (modules/bg.py __call__: row 0 = +z pole, col = phi/2pi * W - 0.5)."""
    r = (np.arange(H) + 0.5) / H
    cl = (np.arange(W) + 0.5) / W
    theta = -(2 * r - 1) * np.pi / 2          # +pi/2 (up) .. -pi/2
    phi = 2 * np.pi * cl
    ct, st = np.cos(theta), np.sin(theta)
    cp, sp = np.cos(phi), np.sin(phi)
    return np.stack([ct[:, None] * cp[None], ct[:, None] * sp[None],
                     np.broadcast_to(st[:, None], (H, W))], -1)


class _ShinyEnv:
    """Precomputed equirect + blur pyramid + irradiance lookup."""

    def __init__(self, H=128, seed=0):
        W = 2 * H
        self.H, self.W = H, W
        dirs = equirect_dirs(H, W)
        self.map = shiny_env_fn(dirs.reshape(-1, 3)).reshape(H, W, 3)
        # blur pyramid: progressive wrap-padded box blurs approximate the
        # roughness prefilter
        levels = [self.map]
        cur = self.map
        for _ in range(5):
            cur = self._blur(cur)
            levels.append(cur)
        self.levels = np.stack(levels)  # (L, H, W, 3)
        # irradiance from a coarse env: I(n) = sum E max(n.d, 0) sa / pi
        gH, gW = 32, 64
        gd = equirect_dirs(gH, gW).reshape(-1, 3)
        genv = shiny_env_fn(gd)
        sa = (2 * np.pi / gW) * (np.pi / gH) * np.cos(
            -(2 * ((np.arange(gH) + 0.5) / gH) - 1) * np.pi / 2)
        sa = np.repeat(sa, gW)
        iH, iW = 32, 64
        idirs = equirect_dirs(iH, iW).reshape(-1, 3)
        cosm = np.clip(idirs @ gd.T, 0, None)  # (iHW, gHW)
        self.irr = ((cosm * sa[None]) @ genv / np.pi
                    ).reshape(iH, iW, 3).astype(np.float32)

    def turn(self, yaw_deg):
        """Turn the environment about +z by ``yaw_deg`` (a whole number of
        the coarsest map's columns): every map rolls along azimuth."""
        for name in ("map", "levels", "irr"):
            im = getattr(self, name)
            cols = yaw_deg / 360.0 * im.shape[-2]
            if cols != int(cols):
                raise ValueError(f"yaw {yaw_deg} is not a whole number of "
                                 f"the {im.shape[-2]} columns of {name}")
            setattr(self, name, np.roll(im, int(cols), axis=-2))

    @staticmethod
    def _blur(im, k=9):
        """Box blur: azimuth wraps, elevation clamps at the poles."""
        H, W, _ = im.shape
        off = np.arange(-(k // 2), k // 2 + 1)
        ci = np.mod(np.arange(W)[None] + off[:, None], W)      # (k, W)
        x = im[:, ci].mean(axis=1)                             # (H, W, 3)
        ri = np.clip(np.arange(H)[None] + off[:, None], 0, H - 1)
        return x[ri].mean(axis=0).astype(np.float32)

    def _uv(self, dirs, H, W):
        d = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
        theta = np.arctan2(d[:, 2], np.sqrt(d[:, 0] ** 2 + d[:, 1] ** 2))
        phi = np.mod(np.arctan2(d[:, 1], d[:, 0]), 2 * np.pi)
        r = np.clip(((-theta / np.pi * 2) + 1) / 2 * H - 0.5, 0, H - 1)
        c = np.mod(phi / (2 * np.pi) * W - 0.5, W)
        return r, c

    @staticmethod
    def _bilinear(img, r, c):
        H, W, _ = img.shape
        r0 = np.floor(r).astype(int)
        c0 = np.floor(c).astype(int)
        r1 = np.clip(r0 + 1, 0, H - 1)
        c1 = (c0 + 1) % W
        fr = (r - r0)[..., None]
        fc = (c - c0)[..., None]
        r0 = np.clip(r0, 0, H - 1)
        c0 = np.mod(c0, W)
        return ((img[r0, c0] * (1 - fr) + img[r1, c0] * fr) * (1 - fc)
                + (img[r0, c1] * (1 - fr) + img[r1, c1] * fr) * fc)

    def radiance(self, dirs, rough=None):
        r, c = self._uv(dirs, self.H, self.W)
        if rough is None:
            return self._bilinear(self.map, r, c)
        lvl = np.clip(np.sqrt(rough) * 4.5, 0, len(self.levels) - 1)
        lo = np.floor(lvl).astype(int)
        hi = np.clip(lo + 1, 0, len(self.levels) - 1)
        f = (lvl - lo)[..., None]
        a = self._bilinear_lvl(lo, r, c)
        b = self._bilinear_lvl(hi, r, c)
        return a * (1 - f) + b * f

    def _bilinear_lvl(self, lvl, r, c):
        out = np.empty((r.shape[0], 3), np.float32)
        for l in np.unique(lvl):
            m = lvl == l
            out[m] = self._bilinear(self.levels[l], r[m], c[m])
        return out

    def irradiance(self, n):
        r, c = self._uv(n, 32, 64)
        return self._bilinear(self.irr, r, c)


def _shiny_first_hit(rays_o, rays_d, exclude=None, spheres=None):
    spheres = _SHINY_SPHERES if spheres is None else spheres
    N = rays_o.shape[0]
    best_t = np.full(N, np.inf)
    idx = np.full(N, -1)
    for i, (c, rad, *_rest) in enumerate(spheres):
        hit, t, _ = _sphere_hit(rays_o, rays_d, c, rad)
        if exclude is not None:
            hit = hit & (exclude != i)
        closer = hit & (t < best_t)
        best_t[closer] = t[closer]
        idx[closer] = i
    return idx, best_t


def _shiny_mats(idx, spheres=None):
    """Per-point material arrays for sphere indices idx (N,)."""
    spheres = _SHINY_SPHERES if spheres is None else spheres
    albedo = np.stack([s[2] for s in spheres])[idx]
    f0 = np.stack([s[3] for s in spheres])[idx]
    rough = np.asarray([s[4] for s in spheres])[idx]
    return albedo, f0, rough


def _shiny_direct_shade(idx, n, v, env, spheres=None):
    """Direct (environment-only) split-sum shade of sphere surface points:
    Fresnel x roughness-prefiltered env along the mirror direction plus
    (1-F) x albedo x irradiance. idx: (N,) sphere index; v points TOWARD
    the eye. Returns (rgb linear (N,3), F (N,3))."""
    albedo, f0, rough = _shiny_mats(idx, spheres)
    cos = np.clip((n * v).sum(-1), 0, 1)[:, None]
    F = f0 + (1 - f0) * (1 - cos) ** 5
    refl = -v + 2 * cos * n
    spec = F * env.radiance(refl, rough)
    diff = albedo * env.irradiance(n)
    return spec + (1 - F) * diff, F


def _frame(z):
    """Orthonormal tangent frame for (N,3) unit vectors z."""
    h = np.where(np.abs(z[:, 2:3]) < 0.9,
                 np.array([0.0, 0.0, 1.0]), np.array([1.0, 0.0, 0.0]))
    x = np.cross(h, z)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    return x, np.cross(z, x)


def _interreflection_delta(idx, p, n, v, env, rng, n_spec=64, n_diff=64,
                           spheres=None):
    """MC occlusion/interreflection correction to the split-sum shade.

    The base GT treats the environment as unoccluded, but a physically
    based renderer (the microfacet model retraces bounce rays against the
    learned field; recur=1 shades the hit with env-only light, exactly
    one bounce) sees the neighboring spheres in reflections and loses
    their blocked env light. Measured on the shipped scene, ~6% of
    foreground pixels have mirror rays hitting a neighbor -- GT without
    this term caps the achievable test PSNR and actively mis-supervises
    the retrace path.

    Ratio-estimator form keeps the clean analytic base everywhere: only
    samples that HIT a neighbor contribute (L_neighbor - L_env), so MC
    noise scales with the correction, not the full radiance:
      delta = F * E_lobe[(L_hit - env) 1{hit}]
            + (1-F) * albedo * E_cos[(L_hit - env) 1{hit}]
    Specular samples draw from a power-cosine lobe about the mirror
    direction with exponent 2/rough^2 - 2 (Phong-equivalent width of the
    prefilter); L_hit is the neighbor's direct shade (matches the model's
    one-bounce depth). Below-horizon lobe samples are skipped (a convex
    sphere self-occludes there; the prefiltered base makes the same
    approximation)."""
    spheres = _SHINY_SPHERES if spheres is None else spheres
    N = p.shape[0]
    albedo, f0, rough = _shiny_mats(idx, spheres)
    cos = np.clip((n * v).sum(-1), 0, 1)[:, None]
    F = f0 + (1 - f0) * (1 - cos) ** 5
    refl = -v + 2 * cos * n
    m_exp = np.clip(2.0 / (rough ** 2 + 1e-8) - 2.0, 1.0, 1e7)
    centers = np.stack([s[0] for s in spheres])
    radii = np.asarray([s[1] for s in spheres])

    def run(axis, n_samp, cosine):
        xs, ys = _frame(axis)
        acc = np.zeros((N, 3), np.float32)
        s1 = int(np.sqrt(n_samp))
        s2 = max(n_samp // s1, 1)
        for k in range(s1 * s2):
            # 2D-stratify (polar, azimuth): the variance is binary neighbor
            # visibility times the env's 40x sun; jittered strata localize
            # the hit/miss boundary within each cell
            u1 = (k // s2 + rng.random(N)) / s1
            u2 = (k % s2 + rng.random(N)) / s2
            ct = np.sqrt(u1) if cosine else u1 ** (1.0 / (m_exp + 1.0))
            st = np.sqrt(np.maximum(1 - ct * ct, 0))
            ph = 2 * np.pi * u2
            w = (xs * (st * np.cos(ph))[:, None]
                 + ys * (st * np.sin(ph))[:, None] + axis * ct[:, None])
            up = (w * n).sum(-1) > 1e-4
            hi, t = _shiny_first_hit(p + 1e-4 * w, w, exclude=idx,
                                     spheres=spheres)
            hm = up & (hi >= 0)
            if hm.any():
                q = p[hm] + t[hm][:, None] * w[hm]
                nq = (q - centers[hi[hm]]) / radii[hi[hm]][:, None]
                lq, _ = _shiny_direct_shade(hi[hm], nq, -w[hm], env,
                                            spheres)
                acc[hm] += lq - env.radiance(w[hm])
        return acc / (s1 * s2)

    delta = F * run(refl, n_spec, cosine=False)
    delta += (1 - F) * albedo * run(n, n_diff, cosine=True)
    return delta.astype(np.float32)


def render_shiny_scene(rays_o, rays_d, env: "_ShinyEnv", interreflect=False,
                       rng=None, n_gi_samples=64, spheres=None):
    """Analytic GT shade. Returns (rgb linear fg, alpha, normals, tints).
    interreflect=True adds the one-bounce neighbor-reflection/occlusion
    correction (see _interreflection_delta)."""
    spheres = _SHINY_SPHERES if spheres is None else spheres
    N = rays_o.shape[0]
    idx, t = _shiny_first_hit(rays_o, rays_d, spheres=spheres)
    hit = idx >= 0
    rgb = env.radiance(rays_d)  # background radiance
    normals = np.zeros((N, 3), np.float32)
    tints = np.zeros((N, 3), np.float32)
    if hit.any():
        p = rays_o[hit] + t[hit][:, None] * rays_d[hit]
        centers = np.stack([s[0] for s in spheres])
        radii = np.asarray([s[1] for s in spheres])
        n = (p - centers[idx[hit]]) / radii[idx[hit]][:, None]
        v = -rays_d[hit]
        shade, _ = _shiny_direct_shade(idx[hit], n, v, env, spheres)
        if interreflect:
            rng = rng or np.random.default_rng(0)
            shade = shade + _interreflection_delta(
                idx[hit], p, n, v, env, rng,
                n_spec=n_gi_samples, n_diff=n_gi_samples, spheres=spheres)
        _, f0, _ = _shiny_mats(idx[hit], spheres)
        rgb[hit] = shade
        normals[hit] = n
        tints[hit] = f0
    return rgb.astype(np.float32), hit.astype(np.float32), normals, tints


def _np_srgb(x):
    limit = 0.0031308
    return np.where(x > limit,
                    1.055 * np.clip(x, limit, None) ** (1 / 2.4) - 0.055,
                    12.92 * x)


# Bump when any GT math above changes (spheres, env, shading, MC
# correction, view layout): invalidates every cached dataset.
_GT_VERSION = 3  # protocol v3 (interreflection MC correction)


def _gt_content_hash():
    """Auto-invalidation for the dataset cache: a hash of the sphere
    tables, the analytic env, and every GT-math function's source, so a
    GT edit without a manual _GT_VERSION bump can never serve stale
    ground truth to protocol runs (cache correctness no longer rests on
    remembering the bump)."""
    import hashlib
    import inspect

    h = hashlib.sha256()
    for tbl in (_SHINY_SPHERES, _CLUSTER_SPHERES, _STUDIO_SPHERES):
        for row in tbl:
            for v in row:
                h.update(np.asarray(v, np.float64).tobytes())
    # make_shiny_dataset itself carries the camera-pose and ray-generation
    # math (look-at, hemisphere stratification, ray normalization) — a GT
    # edit there must invalidate too, so its source joins the hash (the
    # hash is static text; no recursion with being called from inside it)
    for fn in (shiny_env_fn, equirect_dirs, _ShinyEnv, _sphere_hit,
               _shiny_first_hit, _shiny_mats, _shiny_direct_shade, _frame,
               _interreflection_delta, render_shiny_scene, _np_srgb,
               make_shiny_dataset):
        try:
            h.update(inspect.getsource(fn).encode())
        except (OSError, TypeError):  # source unavailable (frozen/REPL)
            h.update(fn.__name__.encode())
    return h.hexdigest()[:12]


def _cache_dir():
    d = os.environ.get("NMF_DATASET_CACHE")
    if d == "":  # explicit opt-out
        return None
    return Path(d) if d else (Path(__file__).resolve().parents[2]
                              / "runs" / ".dataset_cache")


# the protocol's camera rig: orbit radius, seed of the camera jitter and
# of the Monte Carlo draws, and the upper ring's elevation
_SHINY_RADIUS = 3.2
_SHINY_SEED = 0
_SHINY_PHI_DEG = -25.0


def make_shiny_dataset(n_views=24, H=128, W=128, split="train",
                       env_bg=False, hemisphere=False, interreflect=True,
                       n_gi_samples=64, scene="shiny", env_yaw_deg=0.0,
                       linear=False):
    """Protocol scene (see module header). all_rgbs is RGBA (tonemapped
    foreground + alpha) so training can blend random backgrounds like the
    blender loader; test views sit between train azimuths.

    env_bg=True bakes the true environment into background pixels with
    alpha 1 (a "real capture" protocol: the bg module receives direct
    supervision in every camera-visible direction, so envmap recovery is
    measurable and specular geometry cannot hide against a blended-white
    background). hemisphere=True replaces the two fixed elevation rings
    with stratified azimuth x golden-ratio elevations over [-10, -60] deg
    (the blender protocol's upper-hemisphere coverage; two rings leave
    vertical parallax unconstrained and a 30k specular fit collapses into
    view-dependent floaters). interreflect=True (protocol v3 default) adds
    the one-bounce neighbor-reflection/occlusion MC correction so the GT
    is consistent with a physically based renderer (the blender scenes the
    reference trains on are path traced); costs ~1-2 min host time per
    split at 400px. env_yaw_deg turns the environment about +z (the scene
    under another light; not in nmf_tpu's generator). linear=True keeps
    the foreground's linear radiance (clipped at 0, not tonemapped: HDR
    frames, values past 1 kept) in place of the sRGB colours (not in
    nmf_tpu's generator).

    Results are memoized to runs/.dataset_cache (override location with
    NMF_DATASET_CACHE; set it empty to disable): the dataset is a pure
    function of the arguments, and the MC GT at 400px costs tens of
    single-core minutes that protocol-run retries would otherwise repay
    on every resume."""
    radius, seed, phi_deg = _SHINY_RADIUS, _SHINY_SEED, _SHINY_PHI_DEG
    cache = None
    cdir = _cache_dir()
    if cdir is not None:
        key = (f"v{_GT_VERSION}.{_gt_content_hash()}"
               f"_{scene}_{split}_n{n_views}_{H}x{W}"
               f"_r{radius}_s{seed}_p{phi_deg}_bg{int(env_bg)}"
               f"_h{int(hemisphere)}_gi{int(interreflect)}"
               f"x{n_gi_samples}"
               + (f"_y{env_yaw_deg:g}" if env_yaw_deg else "")
               + ("_linear" if linear else ""))
        cache = cdir / f"torch_shiny_{key}.npz"
        if cache.exists():
            with np.load(cache) as z:
                ds = {k: z[k] for k in z.files}
            ds["img_wh"] = tuple(int(v) for v in ds["img_wh"])
            ds["focal"] = float(ds["focal"])
            ds["near_far"] = tuple(float(v) for v in ds["near_far"])
            ds["white_bg"] = bool(ds["white_bg"])
            return ds
    env = _ShinyEnv()
    if env_yaw_deg:
        env.turn(env_yaw_deg)
    spheres = {"shiny": _SHINY_SPHERES,
               "cluster": _CLUSTER_SPHERES,
               "studio": _STUDIO_SPHERES}[scene]
    gi_rng = np.random.default_rng(
        seed + (7 if split == "train" else 117) + 1000)
    focal = 0.5 * W / np.tan(0.5 * np.deg2rad(55.0))
    directions = get_ray_directions_blender(H, W, [focal, focal])
    directions = directions / np.linalg.norm(directions, axis=-1,
                                             keepdims=True)
    if hemisphere:
        rng = np.random.default_rng(seed + (0 if split == "train" else 101))
        thetas = (360.0 * (np.arange(n_views)
                           + rng.uniform(0, 1, n_views)) / n_views)
        fracs = (np.arange(n_views) * 0.6180339887 + rng.uniform()) % 1.0
        view_phis = -10.0 - 50.0 * fracs
    else:
        offset = 0.0 if split == "train" else 180.0 / n_views
        phis = [phi_deg, phi_deg - 12.0]
        thetas = 360.0 * np.arange(n_views) / n_views + offset
        view_phis = np.array([phis[i % len(phis)] for i in range(n_views)])
    all_rays, all_rgbs, all_norms, all_tints = [], [], [], []
    poses = []
    for i in range(n_views):
        c2w = pose_spherical(thetas[i], view_phis[i], radius)
        poses.append(c2w)
        rays_o, rays_d = get_rays(directions, c2w)
        rgb, alpha, norms, tints = render_shiny_scene(
            rays_o, rays_d, env, interreflect=interreflect, rng=gi_rng,
            n_gi_samples=n_gi_samples, spheres=spheres)
        ldr = (np.clip(rgb, 0, None) if linear
               else np.clip(_np_srgb(np.clip(rgb, 0, None)), 0, 1))
        if env_bg:
            rgba = np.concatenate([ldr, np.ones_like(alpha)[:, None]], -1)
        else:
            # background pixels carry the env color but alpha 0: the
            # trainer blends them over bg_col exactly like blender RGBA
            rgba = np.concatenate([ldr, alpha[:, None]], -1)
        all_rays.append(np.concatenate([rays_o, rays_d], axis=-1))
        all_rgbs.append(rgba)
        all_norms.append(norms)
        all_tints.append(tints)
    ds = {
        "all_rays": np.concatenate(all_rays, 0).astype(np.float32),
        "all_rgbs": np.concatenate(all_rgbs, 0).astype(np.float32),
        "all_norms": np.concatenate(all_norms, 0).astype(np.float32),
        "all_tints": np.concatenate(all_tints, 0).astype(np.float32),
        "poses": np.stack(poses),
        "img_wh": (W, H),
        "focal": focal,
        "near_far": (radius - 1.8, radius + 1.8),
        "scene_bbox": np.array([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]],
                               dtype=np.float32),
        "white_bg": False,
        # eval's calc_envmap_psnr flips columns then rolls by W/2; emit the
        # GT pano pre-inverse-transformed so it lands in bg_mat orientation
        "gt_bg_im": np.roll(env.map, env.W // 2, axis=1)[:, ::-1].copy(),
    }
    if cache is not None:
        cache.parent.mkdir(parents=True, exist_ok=True)
        # atomic publish: concurrent retries may generate simultaneously.
        # (open file object: savez would append .npz to a bare path)
        tmp = cache.with_suffix(f".tmp{os.getpid()}")
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **ds)
        os.replace(tmp, cache)
    return ds
