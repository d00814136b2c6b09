"""Dual-scene training (``nmf_tpu/train_dualbg.py``): one field and shading
model, one envmap a scene (``modules.dual_bg.MultiBG``).

    python -m nmf_tpu_torch.train_dualbg model=microfacet_tensorf2 \
        dataset=lego dataset2=materials datadir=/data [device=cpu]

The two scenes come from a list-valued ``dataset`` (``dual_lego``,
``dual_mats``; a one-entry list trains one scene twice) or from
``dataset`` and ``dataset2``. The model is built on the first scene's box
and near / far, its envmap joined by a second one of the same config, and
calibrated as ``train.reconstruction`` calibrates it. Iteration ``it``
trains scene ``it % 2`` on a fixed batch from its own ``SimpleSampler``
and store on the device, with its envmap selected (there is no adaptive
batch, pause or mid-run eval, as in nmf_tpu); the loss weights keep
``L1_weight_initial`` and decay the TV weights by
``lr_decay_target_ratio ** (it / n_iters)``. A schedule event rebuilds
the optimizer (its lr schedule restarts). The run writes
``<basedir>/dual_<expname>/dual_<expname>.th``, then evaluates each test
split with its own envmap into ``imgs_test_<i>``. Runs on ``cuda`` unless
the config says ``device=cpu``.
"""
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import ckpt as ckpt_lib
from . import config as config_lib
from . import eval as eval_lib
from . import trainer
from .builders import build_bg, build_nmf
from .data import load_dataset
from .modules.dual_bg import MultiBG
from .ops.draws import Draws
from .train import calibrate_model, make_loss_weights, make_optimizer


def dataset_configs(cfg):
    """The two scenes' dataset configs."""
    if isinstance(cfg["dataset"], list):
        ds_cfgs = list(cfg["dataset"])[:2]
        return ds_cfgs * 2 if len(ds_cfgs) == 1 else ds_cfgs
    return [cfg["dataset"], cfg.get("dataset2", cfg["dataset"])]


def reconstruction_dual(cfg, log=print):
    """Train on two scenes, then evaluate each. Returns (nmf, the list of
    each test split's metrics)."""
    params = cfg["model"]["params"]
    device = torch.device(cfg.get("device", "cuda"))
    datadir = cfg.get("datadir", "/data")
    ds_cfgs = dataset_configs(cfg)
    datasets = [load_dataset(c, datadir, split="train") for c in ds_cfgs]
    test_sets = [load_dataset(c, datadir, split="test") for c in ds_cfgs]

    expname = f"dual_{cfg['expname']}"
    logfolder = Path(cfg.get("basedir", "./log")) / expname
    logfolder.mkdir(parents=True, exist_ok=True)

    seed = int(cfg.get("seed", 20211200))
    nmf = build_nmf(cfg["model"]["arch"], datasets[0]["scene_bbox"],
                    datasets[0]["near_far"], seed=seed, device=device)
    if nmf.bg_module is not None:
        bg2 = build_bg(cfg["model"]["arch"].get("bg_module")).to(device)
        nmf.bg_module = MultiBG([nmf.bg_module, bg2])
    draws = Draws(torch.Generator(device=device).manual_seed(seed))
    calibrate_model(nmf, draws.scoped("calibrate"))

    n_iters = int(params["n_iters"])
    batch_size = int(params.get("batch_size", 4096))
    opt = make_optimizer(nmf, params, n_iters)
    samplers = [trainer.SimpleSampler(d["all_rays"].shape[0], batch_size)
                for d in datasets]
    stores = [(torch.from_numpy(d["all_rays"]).to(device),
               torch.from_numpy(d["all_rgbs"]).to(device)) for d in datasets]
    rng = np.random.default_rng(0)
    refresh = max(int(cfg.get("progress_refresh_rate", 50) or 50), 1)
    t_start = time.time()
    for it in range(n_iters):
        di = it % len(datasets)
        if isinstance(nmf.bg_module, MultiBG):
            nmf.bg_module.select(di)
        ids = torch.from_numpy(samplers[di].nextids()).to(device)
        rays, rgba = stores[di][0][ids], stores[di][1][ids]
        bg_col = trainer.bg_col_for(params.get("bg_col", "white"), rng)
        bg_t = torch.from_numpy(bg_col).to(device)
        rgb_gt = (rgba[:, :3] * rgba[:, 3:] + (1 - rgba[:, 3:]) * bg_t
                  if rgba.shape[-1] == 4 else rgba)
        tv_mult = float(cfg.get("lr_decay_target_ratio", 0.1)) ** (
            it / n_iters)
        metrics = trainer.train_step(
            nmf, opt, rays, rgb_gt, tuple(float(c) for c in bg_col),
            make_loss_weights(params, tv_mult=tv_mult), draws=draws)
        if it % refresh == 0 or it == n_iters - 1:
            mse = float(metrics["photo_mse"])
            log(f"iter {it:06d} ds{di} "
                f"psnr={-10 * math.log10(max(mse, 1e-10)):.2f} "
                f"loss={float(metrics['loss']):.5f}")
        if nmf.check_schedule(it + 1):
            opt = make_optimizer(nmf, params, n_iters)
            log(f"iter {it}: schedule event -> optimizer reinit")
    log(f"trained {n_iters} iterations in {time.time() - t_start:.1f} s")

    ckpt_lib.save(logfolder / f"{expname}.th", nmf, cfg)
    results = []
    for di, tds in enumerate(test_sets):
        if isinstance(nmf.bg_module, MultiBG):
            nmf.bg_module.select(di)
        results.append(eval_lib.evaluate(
            nmf, tds, save_dir=str(logfolder / f"imgs_test_{di}"),
            n_vis=cfg.get("N_vis", 5), seed=seed))
        log(f"dataset {di} test: {results[-1]}")
    return nmf, results


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    return reconstruction_dual(config_lib.compose(argv))


if __name__ == "__main__":
    main()
