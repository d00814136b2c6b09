"""Training entry point (``nmf_tpu/train.py:reconstruction``).

    python -m nmf_tpu_torch.train model=microfacet_tensorf2 \
        dataset=synthetic_sphere model.params.n_iters=3000 expname=run1 \
        [device=cpu]

Host loop: the microfacet model's bias calibration against the envmap
brightness, batching (with the adaptive batch controller when the config
sets ``target_num_samples``), the train step, progress lines (psnr, loss,
rays/s, the bounce-ray thinning factors), schedule events (voxel upsample,
alpha-mask rebuild) followed by an optimizer rebuild, the switch to
``L1_weight_rest`` and a batch reset, and the final test evaluation. Runs
on ``cuda`` unless the config says ``device=cpu``. Every random draw comes
from one ``torch.Generator`` on the device, seeded by ``seed``.

Not ported yet: checkpoints and resume, mid-run visual evals, the device
mesh, the bounce-budget controller (``adapt_brdf_budget``), TV/ortho/pred/
ori decays, render_only and multirun.
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
from .ops.draws import Draws


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
    for key in ("final_ori_lambda", "final_pred_lambda", "adapt_brdf_budget",
                "charbonier_loss", "TV_weight_bg", "normal_err_lambda"):
        if params.get(key):
            raise NotImplementedError(f"params.{key} is not ported yet "
                                      "(ROADMAP A.2)")
    l1 = params.get("L1_weight_initial", 0.0)
    if l1_rest and params.get("L1_weight_rest") is not None:
        l1 = params["L1_weight_rest"]
    return trainer.LossWeights(
        distortion_lambda=params.get("distortion_lambda", 0.0),
        l1_weight=l1,
        ortho_weight=params.get("ortho_weight", 0.0),
        tv_weight_density=params.get("TV_weight_density", 0.0),
        tv_weight_app=params.get("TV_weight_app", 0.0),
        ori_lambda=params.get("ori_lambda", 0.0),
        envmap_lambda=params.get("envmap_lambda", 0.0),
        diffuse_lambda=params.get("diffuse_lambda", 0.0),
        brdf_lambda=params.get("brdf_lambda", 0.0))


@torch.no_grad()
def calibrate_model(nmf, draws):
    """The shading model's bias calibration against the envmap's mean
    brightness, at the appearance features of ``xyz`` (10000, 4) uniform
    draws in the normalized box (footprint 0); the model's draws are in
    scope ``model``."""
    if not hasattr(nmf.model, "calibrate") or nmf.bg_module is None:
        return
    dev = nmf.rf.aabb.device
    xyz = draws.uniform("xyz", (10000, 4), dev) * 2 - 1
    xyz[:, 3] = 0.0
    feat = nmf.rf.compute_appfeature(xyz)
    bg_brightness = float(nmf.bg_module.mean_color().mean())
    nmf.model.calibrate(draws.scoped("model"), xyz, feat, bg_brightness)


class BatchController:
    """The adaptive ray count: every 16 steps, the pow2 batch that brings
    ``target_num_samples`` valid samples a step at the last step's samples
    a ray, within [min_batch_size, max_batch_size]; back to the starting
    batch after every schedule event. Without a target, the batch stays."""

    def __init__(self, params):
        self.start = int(params.get("starting_batch_size",
                                    params.get("batch_size", 4096)))
        self.target = params.get("target_num_samples")
        self.lo = int(params.get("min_batch_size", self.start))
        self.hi = int(params.get("max_batch_size", self.start))
        self.adapt = bool(self.target) and self.hi > self.lo
        self.size = self.start

    def after_step(self, it, n_valid_samples):
        if self.adapt and (it + 1) % 16 == 0:
            spr = max(float(n_valid_samples) / self.size, 1e-3)
            bucket = 2 ** int(math.floor(math.log2(
                max(float(self.target) / spr, 1.0))))
            self.size = int(np.clip(bucket, self.lo, self.hi))

    def reset(self):
        self.size = self.start


def reconstruction(cfg, log=print):
    """Train, then evaluate the test split. Returns (nmf, results): the
    final test metrics plus the last logged train loss, rays/s, batch and
    thinning factors, and the training loop's seconds."""
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
    draws = Draws(torch.Generator(device=device).manual_seed(seed))
    calibrate_model(nmf, draws.scoped("calibrate"))

    n_iters = int(params["n_iters"])
    batch = BatchController(params)
    opt = make_optimizer(nmf, params, n_iters)
    store_rays = torch.from_numpy(train_ds["all_rays"]).to(device)
    store_rgb = torch.from_numpy(train_ds["all_rgbs"]).to(device)
    sampler = trainer.SimpleSampler(store_rays.shape[0], batch.size,
                                    seed=cfg.get("seed", 0))
    rng = np.random.default_rng(cfg.get("seed", 0))
    bg_mode = params.get("bg_col", "white")
    refresh = max(int(cfg.get("progress_refresh_rate", 50) or 50), 1)

    l1_rest = False
    rays_done = 0
    results = {}
    t_start = time.time()
    for it in range(n_iters):
        bg_col = trainer.bg_col_for(bg_mode, rng)
        ids = torch.from_numpy(sampler.nextids(batch.size)).to(device)
        rays, rgba = store_rays[ids], store_rgb[ids]
        bg_t = torch.from_numpy(bg_col).to(device)
        rgb_gt = (rgba[:, :3] * rgba[:, 3:] + (1 - rgba[:, 3:]) * bg_t
                  if rgba.shape[-1] == 4 else rgba)
        metrics = trainer.train_step(
            nmf, opt, rays, rgb_gt, tuple(float(c) for c in bg_col),
            make_loss_weights(params, l1_rest), draws=draws)
        rays_done += rays.shape[0]
        batch.after_step(it, metrics["n_valid_samples"])
        if it % refresh == 0 or it == n_iters - 1:
            mse = float(metrics["photo_mse"])
            psnr = -10 * math.log10(max(mse, 1e-10))
            loss = float(metrics["loss"])
            rays_per_sec = rays_done / max(time.time() - t_start, 1e-9)
            thin = {k: float(metrics[k]) for k in
                    ("thin_scale", "thin_scale_retrace") if k in metrics}
            results.update(loss=loss, train_psnr=psnr,
                           rays_per_sec=rays_per_sec, batch=rays.shape[0],
                           **thin)
            log(f"iter {it:06d} psnr={psnr:.2f} loss={loss:.5f} "
                f"rays/s={rays_per_sec:.0f} batch={rays.shape[0]}"
                + "".join(f" {k}={v:.3f}" for k, v in thin.items()))
        if nmf.check_schedule(it + 1):
            opt = make_optimizer(nmf, params, n_iters)
            l1_rest = True
            batch.reset()
            log(f"iter {it}: schedule event -> optimizer reinit; "
                f"grid={nmf.rf.grid_size}")

    results["train_seconds"] = time.time() - t_start
    if cfg.get("render_test", True):
        final_n = cfg.get("final_N_vis")
        if final_n is None:
            final_n = cfg.get("N_vis", -1)
        res = eval_lib.evaluate(nmf, test_ds,
                                save_dir=str(logfolder / "imgs_test_all"),
                                n_vis=final_n, seed=seed)
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
