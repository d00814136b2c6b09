"""Image rendering and metric evaluation (``nmf_tpu/eval.py``): chunked
rendering of a ray set, per-image PSNR/SSIM, and PNG artifacts (the test
image, its squared error and rgb|depth). PNGs are written with zlib alone.

Not in this slice: LPIPS, normal/tint/envmap metrics, videos, HDR dumps,
eval tiers and render_path.
"""
import os
import struct
import zlib
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from . import utils
from .render import NMF, render


def _device(nmf: NMF):
    return nmf.rf.aabb.device


@torch.no_grad()
def render_rays_chunked(nmf: NMF, rays, chunk=4096):
    """Render (N, 6) numpy rays on a white background in fixed-size chunks
    (the tail chunk padded with copies of ray 0) -> {map: (N, ...) numpy}.

    Ray i goes into chunk i % n_chunks, as nmf_tpu interleaves them so that
    every chunk gets the image-average ray mix; outputs come back in the
    original order.
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
    outs = {}
    for i in range(n_chunks):
        r = torch.from_numpy(rays[i * chunk:(i + 1) * chunk]).to(dev)
        ims, _ = render(nmf, r, is_train=False, draw_debug=True)
        for k, v in ims.items():
            outs.setdefault(k, []).append(v)
    out = {k: torch.cat(v)[:N].cpu().numpy() for k, v in outs.items()}
    if inv is not None:
        out = {k: v[inv] for k, v in out.items()}
    return out


def render_image(nmf: NMF, rays, hw, chunk=4096):
    H, W = hw
    maps = render_rays_chunked(nmf, rays, chunk=chunk)
    return {k: v.reshape(H, W, *v.shape[1:]) for k, v in maps.items()}


def visualize_depth(depth, near_far=None):
    d = np.asarray(depth)
    lo, hi = (near_far if near_far is not None
              else (np.percentile(d, 1), np.percentile(d, 99)))
    x = np.clip((d - lo) / max(hi - lo, 1e-8), 0, 1)
    return np.stack([x, x, x], axis=-1)


def write_png(path, img):
    """Write an (H, W) or (H, W, 3) image in [0, 1] as an 8-bit RGB PNG."""
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, -1)
    u8 = (np.clip(arr[..., :3], 0, 1) * 255).astype(np.uint8)
    H, W = u8.shape[:2]
    raw = b"".join(b"\x00" + u8[y].tobytes() for y in range(H))

    def chunk(tag, data):
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(png)


def evaluate(nmf: NMF, dataset, save_dir: Optional[str] = None,
             n_vis: int = -1):
    """Render test views in chunks of ``nmf.eval_batch_size`` rays, return
    {"psnr", "ssim"} means; with ``save_dir`` write {i:03d}.png, err/ and
    rgbd/ PNGs and mean.txt."""
    chunk = nmf.eval_batch_size
    W, H = dataset["img_wh"]
    n_px = H * W
    n_images = dataset["all_rays"].shape[0] // n_px
    idxs = (range(n_images) if n_vis <= 0
            else range(0, n_images, max(n_images // n_vis, 1)))
    stats = {"psnr": [], "ssim": []}
    if save_dir is not None:
        os.makedirs(save_dir, exist_ok=True)
    for img_i in idxs:
        rays = dataset["all_rays"][img_i * n_px:(img_i + 1) * n_px]
        gt = dataset["all_rgbs"][img_i * n_px:(img_i + 1) * n_px]
        gt = gt.reshape(H, W, -1)
        if gt.shape[-1] == 4:
            gt = gt[..., :3] * gt[..., 3:] + (1 - gt[..., 3:])
        maps = render_image(nmf, rays, (H, W), chunk=chunk)
        pred = np.clip(maps["rgb_map"], 0, 1)
        stats["psnr"].append(utils.rgb_psnr(pred, gt))
        stats["ssim"].append(utils.rgb_ssim(pred, gt, 1.0))
        if save_dir is not None:
            name = f"{img_i:03d}.png"
            write_png(Path(save_dir) / name, pred)
            err = ((pred - gt) ** 2).mean(-1)
            write_png(Path(save_dir) / "err" / name, np.clip(err * 20, 0, 1))
            depth = visualize_depth(maps["depth"], dataset.get("near_far"))
            write_png(Path(save_dir) / "rgbd" / name,
                      np.concatenate([pred, depth], axis=1))
    summary = {k: float(np.mean(v)) for k, v in stats.items()}
    if save_dir is not None:
        with open(Path(save_dir) / "mean.txt", "w") as f:
            f.write(str(summary))
    return summary
