"""Recompute eval metrics from dumped images (host only, no model; the
port's copy of ``nmf_tpu/scripts/reeval.py``).

Walks run folders, reloads each run's test split through the port's
``load_dataset``, recomputes PSNR, SSIM and the alpha-weighted normal error
from the ``imgs_test_all`` PNGs, and writes ``stats{suffix}.yaml``. PNGs are
read with PIL (``data.exr``), not imageio. LPIPS stays out, as in the
port's eval: nmf_tpu computes it only where the ``lpips`` package and its
weights are installed.

Usage:
    python -m nmf_tpu_torch.scripts.reeval RUNDIR [RUNDIR ...]
        [--datadir /data] [--suffix _reeval]

Each RUNDIR must contain ``config.yaml`` and ``imgs_test_all/``; the
updated stats land in ``imgs_test_all/stats{suffix}.yaml``, starting from
the keys of the stats files already there (``tint_psnr``, ``envmap_*``).
"""
import argparse
import sys
from pathlib import Path

import numpy as np


def _imread(path):
    from ..data.exr import _read_pil

    return _read_pil(path)


def _decode_normal(png_u8):
    """Invert the eval's encoding of (n+1)/2 in 8 bits: v/255*2-1,
    renormalized."""
    n = png_u8[..., :3].astype(np.float32) / 255.0 * 2.0 - 1.0
    return n / (np.linalg.norm(n, axis=-1, keepdims=True) + 1e-6)


def reeval_run(run_dir: Path, datadir: str, suffix: str = "_reeval",
               log=print):
    import yaml

    from .. import utils
    from ..data.blender import load_dataset

    run_dir = Path(run_dir)
    img_dir = run_dir / "imgs_test_all"
    if not (run_dir / "config.yaml").exists() or not img_dir.exists():
        log(f"skip {run_dir}: no config.yaml or imgs_test_all")
        return None
    with open(run_dir / "config.yaml") as f:
        cfg = yaml.safe_load(f)
    ds = load_dataset(cfg["dataset"], cfg.get("datadir", datadir),
                      split="test")
    W, H = ds["img_wh"]
    n_px = H * W
    rgbs = ds["all_rgbs"]
    n_images = rgbs.shape[0] // n_px

    stats = {"psnr": [], "ssim": [], "norm_err": []}
    for idx in range(n_images):
        p = img_dir / f"{idx:03d}.png"
        if not p.exists():
            continue  # eval may have dumped a strided subset (n_vis)
        pred = _imread(p)[..., :3].astype(np.float32) / 255.0
        gt = np.asarray(rgbs[idx * n_px:(idx + 1) * n_px]).reshape(H, W, -1)
        if gt.shape[-1] == 4:
            gt = gt[..., :3] * gt[..., 3:] + (1 - gt[..., 3:])
        stats["psnr"].append(utils.rgb_psnr(pred, gt))
        stats["ssim"].append(float(utils.rgb_ssim(pred, gt, 1.0)))

        np_path = img_dir / "world_normal" / f"{idx:03d}.png"
        if np_path.exists() and ds.get("all_norms") is not None:
            pn = _decode_normal(_imread(np_path))
            gtn = np.asarray(
                ds["all_norms"][idx * n_px:(idx + 1) * n_px]).reshape(H, W, 3)
            mask = np.linalg.norm(gtn, axis=-1) > 0.9
            if mask.any():
                gtn = gtn / (np.linalg.norm(gtn, axis=-1, keepdims=True)
                             + 1e-6)
                cos = np.clip((pn * gtn).sum(-1), -1, 1)
                err = np.rad2deg(np.arccos(cos))
                stats["norm_err"].append(float(err[mask].mean()))

    # start from the existing stats files so keys not recomputed here
    # (tint_psnr, envmap_*) survive
    out = {}
    for prev in sorted(img_dir.glob("stats*.yaml")):
        with open(prev) as f:
            prev_data = yaml.safe_load(f) or {}
        for k, v in prev_data.items():
            out[k] = (float(np.mean(v)) if isinstance(v, list) and v else v)
    for k, v in stats.items():
        if v:
            out[k] = float(np.mean(v))
    out_path = img_dir / f"stats{suffix}.yaml"
    with open(out_path, "w") as f:
        yaml.safe_dump(out, f)
    log(f"{run_dir.name}: " + " ".join(
        f"{k}={out[k]:.3f}" for k in ("psnr", "ssim", "norm_err")
        if k in out))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("runs", nargs="+", help="run folders (contain "
                    "config.yaml + imgs_test_all), or parents of them")
    ap.add_argument("--datadir", default="/data")
    ap.add_argument("--suffix", default="_reeval")
    args = ap.parse_args(argv)
    results = {}
    for r in args.runs:
        r = Path(r)
        dirs = [r] if (r / "config.yaml").exists() else sorted(
            p for p in r.glob("*") if (p / "config.yaml").exists())
        for d in dirs:
            res = reeval_run(d, args.datadir, args.suffix)
            if res is not None:
                results[str(d)] = res
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
