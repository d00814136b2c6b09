"""Blender (nerf_synthetic) scenes and the dataset dispatch (host-side
numpy; the port's copy of ``nmf_tpu/data/blender.py``).

``load_blender`` reads ``transforms_{split}.json`` and its images and
precomputes every pixel's ray in world space, RGBA images and, with
``load_normals``, the ``normal_*`` / ``tint_*`` maps; ``load_own_data``
reads self-captured transforms; ``load_dataset`` dispatches on
``dataset_name``. Images are read by ``exr.imread_any`` and resized by
``resize.resize_area`` (OpenCV's ``INTER_AREA``, as nmf_tpu resizes them
where OpenCV is installed). ``save_blender_split`` writes a scene in the
same layout.

nmf_tpu's quirks are kept: ``downsample_train`` resizes both splits, the
scene box is +-1.5 times the json's ``aabb_scale`` (the trainer scales it
again by the yaml's), and the yaml's ``near_far`` overrides the json's.
"""
import itertools
import json
import os
from pathlib import Path

import numpy as np

from .exr import imread_any, write_exr, write_png
from .ray_utils import get_ray_directions, get_rays
from .resize import resize_area


def _resize(img, wh):
    w, h = wh
    if img.shape[1] == w and img.shape[0] == h:
        return img
    return resize_area(img, (w, h))


BLENDER2OPENCV = np.array(
    [[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]],
    dtype=np.float32)


def load_blender(datadir, split="train", downsample=1.0, white_bg=True,
                 load_normals=False, n_vis=-1):
    """Returns the standard dataset dict (all_rays (N, 6), all_rgbs (N, C),
    all_norms, all_tints, poses, img_wh, focal, near_far, scene_bbox,
    white_bg)."""
    datadir = Path(datadir)
    with open(datadir / f"transforms_{split}.json") as f:
        meta = json.load(f)

    ext = meta.get("ext", ".png")
    near_far = meta.get("near_far", [2.0, 6.0])
    white_bg = meta.get("white_bg", white_bg)
    w = int(meta.get("w", 800) / downsample)
    h = int(meta.get("h", 800) / downsample)

    scene_bbox = np.array([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]],
                          dtype=np.float32)
    aabb_scale = meta.get("aabb_scale", 1.0)
    scene_bbox *= aabb_scale

    if "camera_angle_x" in meta:
        fx = 0.5 * w / np.tan(0.5 * meta["camera_angle_x"])
        fy = fx
    else:
        fx, fy = meta["fl_x"] / downsample, meta["fl_y"] / downsample

    directions = get_ray_directions(h, w, [fx, fy])  # OpenCV convention
    directions = directions / np.linalg.norm(directions, axis=-1,
                                             keepdims=True)

    frames = meta["frames"]
    interval = 1 if n_vis < 0 else max(len(frames) // n_vis, 1)
    all_rays, all_rgbs, all_norms, all_tints, poses = [], [], [], [], []
    for frame in frames[::interval]:
        pose = np.array(frame["transform_matrix"],
                        dtype=np.float32) @ BLENDER2OPENCV
        poses.append(pose)
        fp = frame["file_path"]
        img_path = datadir / (fp + ext if not fp.endswith(ext) else fp)
        if not img_path.exists() and fp.startswith("./"):
            img_path = datadir / (fp[2:] + ext)
        img = imread_any(img_path)
        img = _resize(img, (w, h))
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        all_rgbs.append(img.reshape(-1, img.shape[-1]))

        rays_o, rays_d = get_rays(directions, pose)
        all_rays.append(np.concatenate([rays_o, rays_d], -1))

        if load_normals:
            npath = datadir / (fp.replace("r_", "normal_") + ext)
            if npath.exists():
                nim = imread_any(npath)[..., :3] * 2 - 1
                nim = _resize(nim, (w, h))
                all_norms.append(nim.reshape(-1, 3))
            tpath = datadir / (fp.replace("r_", "tint_") + ext)
            if tpath.exists():
                tim = _resize(imread_any(tpath)[..., :3], (w, h))
                all_tints.append(tim.reshape(-1, 3))

    return {
        "all_rays": np.concatenate(all_rays, 0).astype(np.float32),
        "all_rgbs": np.concatenate(all_rgbs, 0).astype(np.float32),
        "all_norms": (np.concatenate(all_norms, 0).astype(np.float32)
                      if all_norms else None),
        "all_tints": (np.concatenate(all_tints, 0).astype(np.float32)
                      if all_tints else None),
        "poses": np.stack(poses),
        "img_wh": (w, h),
        "focal": fx,
        "near_far": tuple(near_far),
        "scene_bbox": scene_bbox,
        "white_bg": white_bg,
    }


def load_own_data(datadir, split="train", downsample=1.0, white_bg=True):
    """Self-captured transforms (the reference's
    dataLoader/your_own_data.py): explicit w/h/camera_angle_x/
    camera_angle_y/cx/cy metadata, principal-point-centered normalized
    directions, near_far [0.1, 100]; RGBA is composited on white."""
    datadir = Path(datadir)
    with open(datadir / f"transforms_{split}.json") as f:
        meta = json.load(f)
    ext = meta.get("ext", ".png")
    w = int(meta["w"] / downsample)
    h = int(meta["h"] / downsample)
    fx = 0.5 * w / np.tan(0.5 * meta["camera_angle_x"])
    fy = (0.5 * h / np.tan(0.5 * meta["camera_angle_y"])
          if "camera_angle_y" in meta else fx)
    cx = meta.get("cx", w / 2) / downsample
    cy = meta.get("cy", h / 2) / downsample

    directions = get_ray_directions(h, w, [fx, fy], center=[cx, cy])
    directions = directions / np.linalg.norm(directions, axis=-1,
                                             keepdims=True)
    all_rays, all_rgbs, poses = [], [], []
    for frame in meta["frames"]:
        pose = np.array(frame["transform_matrix"],
                        dtype=np.float32) @ BLENDER2OPENCV
        poses.append(pose)
        fp = frame["file_path"]
        img_path = datadir / (fp + ext if not fp.endswith(ext) else fp)
        img = imread_any(img_path)
        img = _resize(img, (w, h))
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        img = img.reshape(-1, img.shape[-1])
        if img.shape[-1] == 4:
            img = img[:, :3] * img[:, -1:] + (1 - img[:, -1:])
        all_rgbs.append(img)
        rays_o, rays_d = get_rays(directions, pose)
        all_rays.append(np.concatenate([rays_o, rays_d], -1))

    return {
        "all_rays": np.concatenate(all_rays, 0).astype(np.float32),
        "all_rgbs": np.concatenate(all_rgbs, 0).astype(np.float32),
        "poses": np.stack(poses),
        "img_wh": (w, h),
        "focal": fx,
        "near_far": (0.1, 100.0),
        "scene_bbox": np.array([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]],
                               np.float32),
        "white_bg": True,
    }


def load_dataset(cfg_dataset, datadir=None, split="train", n_vis=-1):
    """Dispatch on ``dataset_name``: the file scenes ``blender``,
    ``own_data``, ``llff`` (``data/llff.py``), ``nsvf`` and
    ``tankstemple`` (``data/nsvf.py``) under ``datadir/scenedir``, and
    the procedural scenes ``synthetic_sphere`` /
    ``synthetic_shiny`` / ``synthetic_cluster`` / ``synthetic_studio``,
    which carry all_norms, all_tints and gt_bg_im.
    The yaml's ``near_far`` overrides the scene's."""
    name = cfg_dataset["dataset_name"]
    if name == "blender":
        ds = load_blender(
            os.path.join(datadir, cfg_dataset["scenedir"]), split=split,
            downsample=cfg_dataset.get("downsample_train", 1.0),
            white_bg=cfg_dataset.get("white_bg", True), n_vis=n_vis,
            load_normals=cfg_dataset.get("stack_norms", False))
    elif name == "llff":
        from .llff import load_llff

        ds = load_llff(os.path.join(datadir, cfg_dataset["scenedir"]),
                       split=split,
                       downsample=cfg_dataset.get("downsample_train", 4.0),
                       ndc_ray=cfg_dataset.get("ndc_ray", True))
    elif name == "nsvf":
        from .nsvf import load_nsvf

        ds = load_nsvf(os.path.join(datadir, cfg_dataset["scenedir"]),
                       split=split,
                       downsample=cfg_dataset.get("downsample_train", 1.0),
                       white_bg=cfg_dataset.get("white_bg", True))
    elif name == "tankstemple":
        from .nsvf import load_tankstemple

        ds = load_tankstemple(
            os.path.join(datadir, cfg_dataset["scenedir"]), split=split,
            downsample=cfg_dataset.get("downsample_train", 1.0),
            white_bg=cfg_dataset.get("white_bg", True))
    elif name == "own_data":
        ds = load_own_data(os.path.join(datadir, cfg_dataset["scenedir"]),
                           split=split,
                           downsample=cfg_dataset.get("downsample_train",
                                                      1.0),
                           white_bg=cfg_dataset.get("white_bg", True))
    elif name == "synthetic_sphere":
        from .synthetic import make_sphere_dataset

        n_views = cfg_dataset.get("n_views", 12)
        size = cfg_dataset.get("image_size", 64)
        phi = -30.0 if split == "train" else -25.0
        ds = make_sphere_dataset(n_views=n_views, H=size, W=size,
                                 seed=0 if split == "train" else 1,
                                 phi_deg=phi)
    elif name in ("synthetic_shiny", "synthetic_cluster",
                  "synthetic_studio"):
        from .synthetic import make_shiny_dataset

        size = cfg_dataset.get("image_size", 128)
        ds = make_shiny_dataset(
            n_views=cfg_dataset.get("n_views", 24), H=size, W=size,
            split=split, env_bg=cfg_dataset.get("env_bg", False),
            hemisphere=cfg_dataset.get("hemisphere", False),
            interreflect=cfg_dataset.get("interreflect", True),
            n_gi_samples=cfg_dataset.get("n_gi_samples", 64),
            scene=name.split("_", 1)[1])
    else:
        raise ValueError(f"unknown dataset {name}")
    if cfg_dataset.get("near_far"):
        ds["near_far"] = tuple(cfg_dataset["near_far"])
    return ds


def save_blender_split(scenedir, split, poses, images, camera_angle_x,
                       normals=None, tints=None, exr=False):
    """Write one split of a scene in nerf_synthetic layout, as
    ``load_blender`` reads it: ``transforms_{split}.json`` (camera_angle_x,
    w, h, and a frame a view: ``file_path`` ``./{split}/r_{i}`` with no
    extension, ``transform_matrix`` the Blender-convention camera-to-world
    of ``poses[i]``) and ``{split}/r_{i}.png``, 8-bit RGB or RGBA rounded
    to nearest; with ``normals``, ``normal_{i}.png`` holding (n + 1) / 2,
    and with ``tints``, ``tint_{i}.png``. ``images`` / ``normals`` /
    ``tints``: iterables of (H, W, C) float arrays, so a generator may
    make the views one at a time. ``exr``: the images as
    ``{split}/r_{i}.exr`` (32-bit float, ZIPS; values past 1 kept) and
    ``"ext": ".exr"`` in the json, an HDR scene's layout."""
    scenedir = Path(scenedir)
    (scenedir / split).mkdir(parents=True, exist_ok=True)

    def u8(x):
        return np.round(np.clip(x, 0, 1) * 255).astype(np.uint8)

    none = itertools.repeat(None)
    frames = []
    for i, (pose, img, nrm, tint) in enumerate(zip(
            poses, images, none if normals is None else normals,
            none if tints is None else tints)):
        if exr:
            write_exr(scenedir / split / f"r_{i}.exr", img)
        else:
            write_png(scenedir / split / f"r_{i}.png", u8(img))
        if nrm is not None:
            write_png(scenedir / split / f"normal_{i}.png", u8((nrm + 1) / 2))
        if tint is not None:
            write_png(scenedir / split / f"tint_{i}.png", u8(tint))
        frames.append({"file_path": f"./{split}/r_{i}",
                       "transform_matrix": np.asarray(pose, np.float64)
                       .tolist()})
    meta = {"camera_angle_x": float(camera_angle_x), "w": img.shape[1],
            "h": img.shape[0], "frames": frames}
    if exr:
        meta["ext"] = ".exr"
    (scenedir / f"transforms_{split}.json").write_text(json.dumps(meta))
