"""Training entry point (``nmf_tpu/train.py:reconstruction``) for the tensorf
slice.

    python -m nmf_tpu_torch.train model=tensorf dataset=synthetic_sphere \
        model.params.n_iters=3000 expname=run1 [device=cpu]

Host loop: batching, the train step, progress lines (psnr, loss, rays/s),
schedule events (voxel upsample, alpha-mask rebuild) followed by an
optimizer rebuild and the switch to ``L1_weight_rest``, and the final test
evaluation. Runs on ``cuda`` unless the config says ``device=cpu``.

Not in this slice: checkpoints and resume, mid-run visual evals, the
device mesh, the adaptive batch and budget controllers, TV/ortho/pred/ori
decays, render_only and multirun.
"""
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import config as config_lib
from . import eval as eval_lib
from . import trainer
from .builders import build_nmf
from .data import load_dataset


def make_optimizer(nmf, params, n_iters):
    if params.get("weight_decay"):
        raise NotImplementedError("params.weight_decay is not ported yet")
    return trainer.Optimizer(nmf, trainer.OptimConfig(
        betas=tuple(params.get("betas", (0.9, 0.99))),
        eps=float(params.get("eps", 1e-8)),
        lr_init=float(params.get("lr_init", 1.0)),
        lr_final=float(params.get("lr_final", 1e-3)),
        lr_delay_steps=int(params.get("lr_delay_steps", 100)),
        lr_delay_mult=float(params.get("lr_delay_mult", 0.1)),
        n_iters=n_iters,
        clip_grad=params.get("clip_grad")))


def make_loss_weights(params, l1_rest=False):
    l1 = params.get("L1_weight_initial", 0.0)
    if l1_rest and params.get("L1_weight_rest") is not None:
        l1 = params["L1_weight_rest"]
    return trainer.LossWeights(
        distortion_lambda=params.get("distortion_lambda", 0.0),
        l1_weight=l1,
        ortho_weight=params.get("ortho_weight", 0.0),
        tv_weight_density=params.get("TV_weight_density", 0.0),
        tv_weight_app=params.get("TV_weight_app", 0.0))


def reconstruction(cfg, log=print):
    """Train, then evaluate the test split. Returns (nmf, results): the
    final test metrics plus the last logged train loss and rays/s."""
    params = cfg["model"]["params"]
    device = torch.device(cfg.get("device", "cuda"))
    expname = f"{cfg['dataset']['scenedir'].split('/')[-1]}_{cfg['expname']}"
    logfolder = Path(cfg.get("basedir", "./log")) / expname
    logfolder.mkdir(parents=True, exist_ok=True)
    config_lib.save_config(cfg, logfolder / "config.yaml")

    train_ds = load_dataset(cfg["dataset"], cfg.get("datadir"), split="train")
    test_ds = load_dataset(cfg["dataset"], cfg.get("datadir"), split="test")
    seed = int(cfg.get("seed", 20211200))
    near_far = tuple(cfg["dataset"].get("near_far", train_ds["near_far"]))
    aabb = (np.asarray(train_ds["scene_bbox"], np.float32)
            * float(cfg["dataset"].get("aabb_scale", 1)))
    nmf = build_nmf(cfg["model"]["arch"], aabb, near_far, seed=seed,
                    device=device)

    n_iters = int(params["n_iters"])
    batch_size = int(params.get("batch_size", 4096))
    opt = make_optimizer(nmf, params, n_iters)
    store_rays = torch.from_numpy(train_ds["all_rays"]).to(device)
    store_rgb = torch.from_numpy(train_ds["all_rgbs"]).to(device)
    sampler = trainer.SimpleSampler(store_rays.shape[0], batch_size,
                                    seed=cfg.get("seed", 0))
    rng = np.random.default_rng(cfg.get("seed", 0))
    jitter_gen = torch.Generator(device=device).manual_seed(seed)
    bg_mode = params.get("bg_col", "white")
    refresh = max(int(cfg.get("progress_refresh_rate", 50) or 50), 1)

    l1_rest = False
    rays_done = 0
    results = {}
    t_start = time.time()
    for it in range(n_iters):
        bg_col = trainer.bg_col_for(bg_mode, rng)
        ids = torch.from_numpy(sampler.nextids()).to(device)
        rays, rgba = store_rays[ids], store_rgb[ids]
        bg_t = torch.from_numpy(bg_col).to(device)
        rgb_gt = (rgba[:, :3] * rgba[:, 3:] + (1 - rgba[:, 3:]) * bg_t
                  if rgba.shape[-1] == 4 else rgba)
        metrics = trainer.train_step(
            nmf, opt, rays, rgb_gt, tuple(float(c) for c in bg_col),
            make_loss_weights(params, l1_rest), generator=jitter_gen)
        rays_done += batch_size
        if it % refresh == 0 or it == n_iters - 1:
            mse = float(metrics["photo_mse"])
            psnr = -10 * math.log10(max(mse, 1e-10))
            loss = float(metrics["loss"])
            rays_per_sec = rays_done / max(time.time() - t_start, 1e-9)
            results.update(loss=loss, train_psnr=psnr,
                           rays_per_sec=rays_per_sec)
            log(f"iter {it:06d} psnr={psnr:.2f} loss={loss:.5f} "
                f"rays/s={rays_per_sec:.0f}")
        if nmf.check_schedule(it + 1):
            opt = make_optimizer(nmf, params, n_iters)
            l1_rest = True
            log(f"iter {it}: schedule event -> optimizer reinit; "
                f"grid={nmf.rf.grid_size}")

    if cfg.get("render_test", True):
        final_n = cfg.get("final_N_vis")
        if final_n is None:
            final_n = cfg.get("N_vis", -1)
        res = eval_lib.evaluate(nmf, test_ds,
                                save_dir=str(logfolder / "imgs_test_all"),
                                n_vis=final_n)
        log(f"final test: {res}")
        results.update(res)
    return nmf, results


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    cfg = config_lib.compose(argv)
    if cfg.get("render_only"):
        raise NotImplementedError(
            "render_only needs checkpoints, which come with a later slice")
    if isinstance(cfg.get("dataset"), list):
        raise NotImplementedError("dual-scene training is not ported yet")
    return reconstruction(cfg)


if __name__ == "__main__":
    main()
