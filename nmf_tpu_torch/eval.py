"""Image rendering and metric evaluation (``nmf_tpu/eval.py``): chunked
rendering of a ray set; per-image PSNR / SSIM and, where the dataset has
them, the masked angular error of the normals against ``all_norms``
(``norm_err``, degrees) and the regression-aligned PSNR of the tint against
``all_tints``; the envmap's regression-aligned metrics against a
ground-truth panorama; the eval budget tiers; PNG artifacts (the test
image, its squared error, rgb|depth and one folder per map), ``mean.txt``,
the per-image ``stats.yaml`` and the envmap as ``pano.png`` and
``pano.exr``; the test sweep's videos; the orbit path (``render_path``)
and the ray logger's ``rays.pkl``. PNGs are written with zlib alone, EXRs
by ``data/exr.py``, videos as animated GIFs by PIL (nmf_tpu writes mp4
through cv2, or a GIF where it cannot). ``streaming=True`` renders through
``render_streaming`` (rgb, acc and depth maps only; local-shading models).

An ``hdr`` model's views are also written as ``{prefix}{i:03d}.exr``: the
rendered ``rgb_map`` unclipped (its curve is applied with ``noclip``).
Not in this slice: LPIPS (its weights cannot be fetched here).
"""
import contextlib
import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from . import utils
from .data.exr import write_exr, write_png
from .data.ray_utils import (get_ray_directions_blender, get_rays,
                              pose_spherical)
from .data.resize import resize_linear
from .ops.draws import Draws
from .render import NMF, render
from .modules.logger import collect_ray_debug
from .render_streaming import render_streaming


# test-time Monte Carlo budget tiers: the multiplier of the shading
# model's bounce rays a sample, bounce buffers and retrace buffers
EVAL_TIERS = {"train": 1, "high": 2, "ultra": 4}


def validate_eval_tier(tier):
    """A tier name or a positive integer -> its multiplier; raises on
    anything else (at startup, not after the training run)."""
    if isinstance(tier, str):
        if tier not in EVAL_TIERS:
            raise ValueError(f"eval_tier must be one of "
                             f"{sorted(EVAL_TIERS)} or an int, got {tier!r}")
        return EVAL_TIERS[tier]
    mult = int(tier)
    if mult != tier or mult < 1:
        raise ValueError(f"eval_tier must be a positive integer multiplier "
                         f"or one of {sorted(EVAL_TIERS)}, got {tier!r}")
    return mult


@contextlib.contextmanager
def apply_eval_tier(nmf: NMF, tier):
    """Within the block, the shading model's test-time budgets
    (test_rays_per_ray, brdf_ray_budget, max_retrace_rays) are scaled by
    the tier's multiplier; models without them are left alone."""
    mult = validate_eval_tier(tier)
    model = nmf.model
    keys = ("test_rays_per_ray", "brdf_ray_budget", "max_retrace_rays")
    if mult <= 1 or not hasattr(model, "brdf_ray_budget"):
        yield nmf
        return
    saved = {k: getattr(model, k) for k in keys}
    model.test_rays_per_ray = saved["test_rays_per_ray"] * mult
    model.brdf_ray_budget = tuple(b * mult for b in saved["brdf_ray_budget"])
    model.max_retrace_rays = tuple(r * mult
                                   for r in saved["max_retrace_rays"])
    try:
        yield nmf
    finally:
        for k, v in saved.items():
            setattr(model, k, v)


def _device(nmf: NMF):
    return nmf.rf.aabb.device


@torch.no_grad()
def render_rays_chunked(nmf: NMF, rays, chunk=4096, draws=None,
                        ndc_ray=False, streaming=False):
    """Render (N, 6) numpy rays (NDC rays with ``ndc_ray``) on a white
    background in fixed-size chunks (the tail chunk padded with copies of
    ray 0) -> {map: (N, ...) numpy}. ``streaming``: through
    ``render_streaming``.

    Ray i goes into chunk i % n_chunks, as nmf_tpu interleaves them so that
    every chunk gets the image-average ray mix; outputs come back in the
    original order. The envmap cache is built once; chunk i takes its
    random draws from ``draws`` in scope ``chunk{i}``.
    """
    rays = np.asarray(rays, np.float32)
    N = rays.shape[0]
    n_chunks = (N + chunk - 1) // chunk
    inv = None
    if n_chunks > 1:
        order = np.argsort(np.arange(N) % n_chunks, kind="stable")
        inv = np.empty(N, np.int64)
        inv[order] = np.arange(N)
        rays = rays[order]
    pad = n_chunks * chunk - N
    if pad:
        rays = np.concatenate([rays, rays[:1].repeat(pad, 0)], 0)
    dev = _device(nmf)
    if draws is None:
        draws = Draws(torch.Generator(device=dev).manual_seed(0))
    bg_cache = nmf.bg_module.prepare() if nmf.bg_module is not None else None
    outs = {}
    for i in range(n_chunks):
        r = torch.from_numpy(rays[i * chunk:(i + 1) * chunk]).to(dev)
        if streaming:
            ims, _ = render_streaming(nmf, r)
        else:
            ims, _ = render(nmf, r, is_train=False, draw_debug=True,
                            draws=draws.scoped(f"chunk{i}"),
                            bg_cache=bg_cache, ndc_ray=ndc_ray)
        for k, v in ims.items():
            outs.setdefault(k, []).append(v)
    out = {k: torch.cat(v)[:N].cpu().numpy() for k, v in outs.items()}
    if inv is not None:
        out = {k: v[inv] for k, v in out.items()}
    return out


def render_image(nmf: NMF, rays, hw, chunk=4096, draws=None, ndc_ray=False,
                 streaming=False):
    H, W = hw
    maps = render_rays_chunked(nmf, rays, chunk=chunk, draws=draws,
                               ndc_ray=ndc_ray, streaming=streaming)
    return {k: v.reshape(H, W, *v.shape[1:]) for k, v in maps.items()}


def visualize_depth(depth, near_far=None):
    d = np.asarray(depth)
    lo, hi = (near_far if near_far is not None
              else (np.percentile(d, 1), np.percentile(d, 99)))
    x = np.clip((d - lo) / max(hi - lo, 1e-8), 0, 1)
    return np.stack([x, x, x], axis=-1)


def regression_aligned_psnr(pred, gt):
    """PSNR after a per-channel linear fit of pred to gt."""
    X = np.asarray(pred).reshape(-1, 3)
    Y = np.asarray(gt).reshape(-1, 3)
    A = np.concatenate([X, np.ones((X.shape[0], 1))], axis=1)
    coef, *_ = np.linalg.lstsq(A, Y, rcond=None)
    err = np.clip(A @ coef - Y, -1, 1)
    return float(-10 * np.log10(np.mean(err ** 2) + 1e-12))


def envmap_image(bg_module):
    """The activated envmap as an (H, W, 3) numpy image."""
    with torch.no_grad():
        act = bg_module.activation_fn(bg_module.bg_mat)
    return np.transpose(act.float().cpu().numpy(), (1, 2, 0))


def calc_envmap_metrics(bg_module, gt_im, fH=500):
    """The recovered envmap against a ground-truth panorama, both resized
    to (fH, 2 fH) and the prediction regression-aligned per channel:
    PSNR over the whole map and PSNR, SMAPE and SSIM over its top half
    (the hemisphere the reflections see)."""
    pred = envmap_image(bg_module)
    gt = np.asarray(gt_im, dtype=np.float32)
    gW = gt.shape[1]
    gt = gt[:, ::-1]
    gt = np.concatenate([gt[:, gW // 2:], gt[:, :gW // 2]], axis=1)
    pred = resize_linear(pred, (2 * fH, fH))
    gt = resize_linear(gt[..., :3], (2 * fH, fH))
    X = pred.reshape(-1, 3)
    Y = gt.reshape(-1, 3)
    A = np.concatenate([X, np.ones((X.shape[0], 1))], axis=1)
    coef, *_ = np.linalg.lstsq(A, Y, rcond=None)
    aligned = (A @ coef).reshape(gt.shape).astype(np.float32)

    def _metrics(p, g):
        err = np.clip(p - g, -1, 1)
        psnr = float(-10 * np.log10(np.mean(err ** 2) + 1e-12))
        smape = float(np.mean(2.0 * np.abs(p - g)
                              / (np.abs(p) + np.abs(g) + 1e-6)))
        ssim = float(utils.rgb_ssim(np.clip(p, 0, 1), np.clip(g, 0, 1), 1.0))
        return psnr, smape, ssim

    top = slice(0, gt.shape[0] // 2)
    psnr_top, smape_top, ssim_top = _metrics(aligned[top], gt[top])
    psnr_full, _, _ = _metrics(aligned, gt)
    return {"envmap_psnr_top": psnr_top, "envmap_smape_top": smape_top,
            "envmap_ssim_top": ssim_top, "envmap_psnr": psnr_full}


def normal_error_deg(pred_normals, gt_normals):
    """(mean angular error in degrees over the pixels whose ground-truth
    normal is set, per-pixel error map) or (None, None) when none is."""
    mask = np.linalg.norm(gt_normals, axis=-1) > 0.9
    if not mask.any():
        return None, None
    cos = np.clip((pred_normals * gt_normals).sum(-1), -1, 1)
    err = np.rad2deg(np.arccos(cos))
    return float(err[mask].mean()), np.where(
        mask, np.clip(err / 90.0, 0, 1), 0.0)


# (map, subfolder) dumped per test image; normals are shown as (n + 1) / 2
_MAP_DIRS = (("world_normal", "world_normal"), ("normal", "normal"),
             ("tint", "tint"), ("spec", "spec"), ("diffuse", "diffuse"),
             ("albedo", "albedo"), ("cross_section", "cross_section"))


def _save_maps(save_dir, name, maps, pred, gt, near_far):
    d = Path(save_dir)
    err = ((pred - gt) ** 2).mean(-1)
    write_png(d / "err" / name, np.clip(err * 20, 0, 1))
    depth = visualize_depth(maps["depth"], near_far)
    write_png(d / "rgbd" / name, np.concatenate([pred, depth], axis=1))
    for k, sub in _MAP_DIRS:
        if k in maps:
            im = maps[k]
            write_png(d / sub / name, (im + 1) / 2 if "normal" in k else im)
    if "roughness" in maps:
        write_png(d / "roughness" / name, maps["roughness"][..., 0])
    write_png(d / "acc_map" / name, maps["acc_map"])
    if "surf_width" in maps:
        write_png(d / "surf_width" / name,
                  np.clip(maps["surf_width"] / 64.0, 0, 1))


def evaluate(nmf: NMF, dataset, save_dir: Optional[str] = None,
             n_vis: int = -1, seed: int = 0, prefix: str = "",
             compute_extra_metrics: bool = True, gt_bg=None,
             streaming: bool = False, ray_logger=None):
    """Render views of ``dataset`` in chunks of ``nmf.eval_batch_size``
    rays and return the means of psnr, ssim (``compute_extra_metrics``)
    and, where the dataset has them, norm_err and tint_psnr, plus the
    envmap metrics against ``gt_bg``. With ``save_dir``: the images as
    {prefix}{i:03d}.png (and, for an ``hdr`` model, the unclipped
    ``rgb_map`` as {prefix}{i:03d}.exr), one folder of PNGs per map,
    stats{prefix}.yaml, mean.txt, the envmap as {prefix}pano.png and
    {prefix}pano.exr (FLOAT, ZIPS) and, for more than one view, the
    sweep's videos {prefix}video.gif, depthvideo.gif and, where the
    model gives normals, normalvideo.gif. An enabled ``ray_logger``
    (``modules.logger.RayLogger``) with no entry yet logs the central
    ``max_rays`` rays of the first view and writes ``rays.pkl`` (and
    ``rays.html`` where plotly is installed).
    ``streaming``: every view through ``render_streaming`` (no normal
    maps). Random draws come from a generator seeded with ``seed``. As
    nmf_tpu's
    eval does, it renders every ray through the world-ray march, also an
    LLFF scene's NDC rays, which training marches in NDC (ROADMAP C.5)."""
    chunk = nmf.eval_batch_size
    draws = Draws(torch.Generator(device=_device(nmf)).manual_seed(seed))
    W, H = dataset["img_wh"]
    n_px = H * W
    n_images = dataset["all_rays"].shape[0] // n_px
    idxs = (range(n_images) if n_vis <= 0
            else range(0, n_images, max(n_images // n_vis, 1)))
    stats = {"psnr": [], "ssim": [], "norm_err": [], "tint_psnr": []}
    vid = {"video": [], "depthvideo": [], "normalvideo": []}
    if save_dir is not None:
        os.makedirs(save_dir, exist_ok=True)
    for img_i in idxs:
        px = slice(img_i * n_px, (img_i + 1) * n_px)
        gt = dataset["all_rgbs"][px].reshape(H, W, -1)
        if gt.shape[-1] == 4:
            gt = gt[..., :3] * gt[..., 3:] + (1 - gt[..., 3:])
        maps = render_image(nmf, dataset["all_rays"][px], (H, W), chunk=chunk,
                            draws=draws.scoped(f"image{img_i}"),
                            streaming=streaming)
        if (ray_logger is not None and ray_logger.enable
                and not ray_logger.entries):
            lo = max((H // 2) * W + W // 2 - ray_logger.max_rays // 2, 0)
            rays = torch.from_numpy(np.asarray(
                dataset["all_rays"][px][lo:lo + ray_logger.max_rays],
                np.float32)).to(_device(nmf))
            ray_logger.log(**collect_ray_debug(nmf, rays))
        pred = np.clip(maps["rgb_map"], 0, 1)
        name = f"{prefix}{img_i:03d}.png"
        stats["psnr"].append(utils.rgb_psnr(pred, gt))
        if compute_extra_metrics:
            stats["ssim"].append(utils.rgb_ssim(pred, gt, 1.0))
        if (dataset.get("all_norms") is not None
                and "world_normal" in maps):
            gt_n = dataset["all_norms"][px].reshape(H, W, 3)
            err, err_map = normal_error_deg(maps["world_normal"], gt_n)
            if err is not None:
                stats["norm_err"].append(err)
                if save_dir is not None:
                    write_png(Path(save_dir) / "normal_err" / name, err_map)
        if dataset.get("all_tints") is not None and "tint" in maps:
            stats["tint_psnr"].append(regression_aligned_psnr(
                maps["tint"].reshape(-1, 3), dataset["all_tints"][px]))
        if save_dir is not None:
            write_png(Path(save_dir) / name, pred)
            if nmf.hdr:
                write_exr(Path(save_dir) / f"{prefix}{img_i:03d}.exr",
                          maps["rgb_map"])
            _save_maps(save_dir, name, maps, pred, gt, dataset.get("near_far"))
            vid["video"].append(pred)
            vid["depthvideo"].append(visualize_depth(
                maps["depth"], dataset.get("near_far")))
            if "world_normal" in maps:
                vid["normalvideo"].append((maps["world_normal"] + 1) / 2)
    summary = {k: float(np.mean(v)) for k, v in stats.items() if len(v)}
    if gt_bg is not None and nmf.bg_module is not None:
        summary.update(calc_envmap_metrics(nmf.bg_module, gt_bg))
    if save_dir is not None:
        import yaml

        with open(Path(save_dir) / f"stats{prefix}.yaml", "w") as f:
            yaml.safe_dump({k: [float(x) for x in v]
                            for k, v in stats.items() if len(v)}, f)
        with open(Path(save_dir) / "mean.txt", "w") as f:
            f.write(str(summary))
        if nmf.bg_module is not None:
            envmap = envmap_image(nmf.bg_module)
            write_png(Path(save_dir) / f"{prefix}pano.png", envmap)
            write_exr(Path(save_dir) / f"{prefix}pano.exr", envmap)
        if len(vid["video"]) > 1:
            for name, frames in vid.items():
                if frames:
                    write_video(Path(save_dir) / f"{prefix}{name}.gif",
                                frames)
        if ray_logger is not None and ray_logger.entries:
            ray_logger.save(str(Path(save_dir) / "rays.pkl"))
            ray_logger.save_html(str(Path(save_dir) / "rays.html"))
    return summary


def write_video(path, frames, fps=30):
    """Write float [0, 1] or uint8 frames (grey ones stacked to RGB) as an
    animated GIF at ``path`` with the suffix .gif, looping; floats are
    truncated to 8 bits, as nmf_tpu's video frames. A GIF frame lasts a
    whole number of centiseconds: round(100 / fps) of them. PIL merges a
    frame equal to the one before it into that one, their times summed
    (``gif_frame_count`` counts them apart). Returns the path, or None
    without frames."""
    from PIL import Image

    u8 = [(np.clip(f, 0, 1) * 255).astype(np.uint8)
          if np.asarray(f).dtype != np.uint8 else np.asarray(f)
          for f in frames]
    if not u8:
        return None
    u8 = [np.stack([f] * 3, -1) if f.ndim == 2 else f[..., :3] for f in u8]
    path = Path(path).with_suffix(".gif")
    path.parent.mkdir(parents=True, exist_ok=True)
    ims = [Image.fromarray(f) for f in u8]
    ims[0].save(path, save_all=True, append_images=ims[1:],
                duration=_frame_ms(fps), loop=0)
    return path


def _frame_ms(fps):
    return 10 * max(round(100 / fps), 1)


def gif_frame_count(path, fps=30):
    """The number of video frames in a GIF that ``write_video`` wrote at
    ``fps``: its time over one frame's."""
    from PIL import Image, ImageSequence

    with Image.open(path) as gif:
        total = sum(f.info["duration"] for f in ImageSequence.Iterator(gif))
    return round(total / _frame_ms(fps))


def render_path(nmf: NMF, hw, focal, n_frames=60, radius=4.0, phi_deg=-30.0,
                save_dir=None, chunk=4096, draws=None):
    """Render an orbit: frame i from the camera ``pose_spherical(360 i /
    n_frames, phi_deg, radius)`` looking at the origin (Blender
    convention, focal ``focal`` px, ``hw`` pixels), on white, through
    ``render_rays_chunked`` with the draws of scope ``frame{i}``. With
    ``save_dir``: each frame as ``path/{i:03d}.png`` and, for more than one
    frame, all of them as ``path.gif``. Returns the (H, W, 3) frames."""
    H, W = hw
    directions = get_ray_directions_blender(H, W, [focal, focal])
    directions = directions / np.linalg.norm(directions, axis=-1,
                                             keepdims=True)
    if draws is None:
        draws = Draws(torch.Generator(device=_device(nmf)).manual_seed(0))
    frames = []
    for i in range(n_frames):
        rays_o, rays_d = get_rays(
            directions, pose_spherical(360.0 * i / n_frames, phi_deg, radius))
        maps = render_image(nmf, np.concatenate([rays_o, rays_d], -1),
                            (H, W), chunk=chunk,
                            draws=draws.scoped(f"frame{i}"))
        frames.append(np.clip(maps["rgb_map"], 0, 1))
        if save_dir is not None:
            write_png(Path(save_dir) / "path" / f"{i:03d}.png", frames[-1])
    if save_dir is not None and len(frames) > 1:
        write_video(Path(save_dir) / "path.gif", frames)
    return frames
