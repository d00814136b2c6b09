"""Training entry point (``nmf_tpu/train.py``: ``reconstruction``,
``render_test`` and their dispatch).

    python -m nmf_tpu_torch.train model=microfacet_tensorf2 \
        dataset=synthetic_sphere model.params.n_iters=3000 expname=run1 \
        [device=cpu]

Host loop: the field's density pretraining or calibration
(``field.num_pretrain``, ``field.calibrate``), the microfacet model's bias
calibration against the envmap brightness, batching (with the adaptive batch controller when the config
sets ``target_num_samples``), the train step, progress lines (psnr, loss,
rays/s, the bounce-ray thinning factors) also written to the run folder's
``metrics.jsonl``, schedule events (voxel upsample, alpha-mask rebuild,
occupancy-grid shrink; the occupancy grid's density sweep every
``update_freq`` iterations keeps the optimizer) followed by a fresh
optimizer, the switch to ``L1_weight_rest`` and a
batch reset, ``vis_every`` evals, checkpoints (``save_every`` writes
``{expname}_latest.th``, the end of the run ``{expname}.th``), and the
final test evaluation at the ``eval_tier`` budgets. ``stop_iter`` pauses
the run with a ``_latest.th``; ``resume=True`` continues from it, and
``ckpt=`` starts from a checkpoint. ``render_only=True ckpt=...``
evaluates a checkpoint instead of training, through the streaming
renderer with ``stream=true`` (which, as in nmf_tpu, the final eval of a
training run does not read), and with ``fixed_bg=<envmap file>`` relit:
the checkpoint's envmap swapped for the file's (``ckpt.load_envmap``:
nmf_tpu's or the port's ``scripts/pano2env.py`` fit, or a checkpoint's).
``render_path=true`` renders the orbit video after the final eval
(``eval.render_path`` into ``imgs_path/``); ``log_rays=true`` has the
eval write the ray logger's ``rays.pkl``. A list-valued ``dataset``
(``dual_lego``, ``dual_mats``) trains two scenes with one envmap each
(``train_dualbg.py``). An LLFF scene whose yaml sets ``ndc_ray`` trains
and evaluates on NDC rays. Runs on ``cuda`` unless the config says
``device=cpu``.

Random streams: the march jitter and the shading model's draws come from
one ``torch.Generator`` on the device, the ray batches and the background
colours from numpy generators. A fresh run seeds them with ``seed``; a run
resumed at ``start_iter`` seeds them with ``stream_seed(seed,
start_iter)``, so two resumes from one checkpoint train identically (the
streams are not those of an unpaused run: nmf_tpu folds its key with the
iteration instead).

The envmap metrics compare against the ``gt_bg`` panorama: a top-level
``gt_bg=`` path, or the dataset yaml's ``gt_bg`` file where it exists under
``<datadir>/backgrounds/``, read with ``data.exr.imread_any``; else the
procedural scene's own.

Loss extras: ``final_ori_lambda`` / ``final_pred_lambda`` decay the ori
and pred weights geometrically to those values over ``n_iters`` (a resumed
run starts at ``decay ** start_iter``); ``charbonier_loss``,
``TV_weight_bg``, ``normal_err_lambda`` (against the train split's
``all_norms``, a store on the device batched with the rays) and
``weight_decay`` go to the trainer, and an ``hdr`` model trains on the
Huber loss. ``adapt_brdf_budget`` grows the
bounce budgets (``BudgetController``); the pause checkpoint carries the
grown budgets and ``budget_mult``, the final one the configured budgets.

    python -m nmf_tpu_torch.train -m dataset=synthetic_sphere,synthetic_studio \
        model.params.n_iters=100,200 ...

runs the cartesian sweep of the comma-list overrides one job after the
other (``expand_multirun``). The port runs on one card (no device mesh).
"""
import contextlib
import copy
import datetime
import itertools
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
from .builders import build_nmf
from .data import load_dataset
from .data.exr import imread_any
from .logging_utils import RunLogger
from .modules.logger import RayLogger
from .ops.draws import Draws


def make_optimizer(nmf, params, n_iters):
    return trainer.Optimizer(nmf, trainer.OptimConfig(
        betas=tuple(params.get("betas", (0.9, 0.99))),
        eps=float(params.get("eps", 1e-8)),
        lr_init=float(params.get("lr_init", 1.0)),
        lr_final=float(params.get("lr_final", 1e-3)),
        lr_delay_steps=int(params.get("lr_delay_steps", 100)),
        lr_delay_mult=float(params.get("lr_delay_mult", 0.1)),
        n_iters=n_iters,
        clip_grad=params.get("clip_grad"),
        weight_decay=float(params.get("weight_decay", 0) or 0)))


def make_loss_weights(params, l1_rest=False, tv_mult=1.0, ori_mult=1.0,
                      pred_mult=1.0):
    """The step's loss weights: the TV weights times ``tv_mult``, ori and
    pred times their decays' ``ori_mult`` / ``pred_mult``, L1 at
    ``L1_weight_rest`` once ``l1_rest``."""
    l1 = params.get("L1_weight_initial", 0.0)
    if l1_rest and params.get("L1_weight_rest") is not None:
        l1 = params["L1_weight_rest"]
    return trainer.LossWeights(
        distortion_lambda=params.get("distortion_lambda", 0.0),
        l1_weight=l1,
        ortho_weight=params.get("ortho_weight", 0.0),
        tv_weight_density=params.get("TV_weight_density", 0.0) * tv_mult,
        tv_weight_app=params.get("TV_weight_app", 0.0) * tv_mult,
        ori_lambda=params.get("ori_lambda", 0.0) * ori_mult,
        pred_lambda=params.get("pred_lambda", 0.0) * pred_mult,
        envmap_lambda=params.get("envmap_lambda", 0.0),
        diffuse_lambda=params.get("diffuse_lambda", 0.0),
        brdf_lambda=params.get("brdf_lambda", 0.0),
        normal_err_lambda=params.get("normal_err_lambda", 0.0),
        tv_weight_bg=params.get("TV_weight_bg", 0.0),
        charbonier=bool(params.get("charbonier_loss", False)),
        charbonier_eps=float(params.get("charbonier_eps", 1e-3)))


def lambda_decay(params, name, n_iters):
    """The per-iteration factor that takes ``<name>_lambda`` to
    ``final_<name>_lambda`` over ``n_iters``; 1 without a final value."""
    start, final = params.get(f"{name}_lambda", 0), params.get(
        f"final_{name}_lambda")
    if not (start > 0 and final):
        return 1.0
    return math.exp(math.log(final / start) / n_iters)


def _box_points(rf, draws, n=20000):
    """n points uniform in [-1, 1]^3 scaled by the box's upper corner
    (nmf_tpu's draw, which assumes a symmetric box), footprint 0."""
    dev = rf.aabb.device
    xyz3 = (draws.uniform("xyz", (n, 3), dev) * 2 - 1) * rf.aabb[1]
    return torch.cat([xyz3, xyz3.new_zeros((n, 1))], -1)


def pretrain_density(nmf, draws, start_density: float, log=print):
    """The field's startup density (nmf_tpu's ``pretrain_density``):
    ``field.num_pretrain`` iterations of Adam (lr 5e-3, betas 0.9 / 0.99)
    on the density factors (``density_rf``, ``dbasis_mat``) fitting the
    alpha at the sampler's step of 20,000 box points to ``start_density``
    with 10% normal noise (draws ``{i}/xyz``, ``{i}/noise``); or, with
    ``field.calibrate`` and no pretraining, the ``density_shift`` that
    brings the mean density of 20,000 box points (``calibrate/xyz``) to
    the one whose alpha is ``start_density``. Fields without these knobs
    are left alone."""
    rf = nmf.rf
    stepsize = float(nmf.sampler.live_stepsize)
    n = int(getattr(rf, "num_pretrain", 0) or 0)
    ds = rf.distance_scale
    if n <= 0 or not hasattr(rf, "density_rf"):
        if getattr(rf, "calibrate", False):
            with torch.no_grad():
                sigma = rf.compute_densityfeature(
                    _box_points(rf, draws.scoped("calibrate")))
            target = -math.log(1 - start_density) / (stepsize * ds)
            rf.density_shift = float(rf.density_shift) + (
                math.log(target) - math.log(max(float(sigma.mean()), 1e-12)))
            log(f"density_shift calibrated -> {rf.density_shift:.3f}")
        return
    params = [*rf.density_rf.parameters(), rf.dbasis_mat]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    alpha_mean = 0.0
    for i in range(n):
        d = draws.scoped(f"{i}")
        with torch.enable_grad():
            sigma = rf.compute_densityfeature(_box_points(rf, d))
            alpha = 1 - torch.exp(-sigma * stepsize * ds)
            target = start_density * (
                1 + 0.1 * d.normal("noise", alpha.shape, alpha.device))
            loss = (alpha - target).abs().mean()
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        alpha_mean = alpha.detach().mean()
        for p, g, mi, vi in zip(params, grads, m, v):
            # optax.adam(5e-3, 0.9, 0.99)
            trainer.adam_step(p, torch.zeros_like(p) if g is None else g,
                              mi, vi, i + 1, 5e-3, -1.0, 0.9, 0.99, 1e-8)
    log(f"pretrain density: mean alpha {float(alpha_mean):.6f} "
        f"after {n} iters (target {start_density})")


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


class BudgetController:
    """The bounce-budget controller (``adapt_brdf_budget``): every 16 steps,
    when the least of the last step's thinning factors is under 0.5 (the
    batch asked for more than twice the rays it got), the model's bounce
    budgets and retrace rays double, up to ``adapt_brdf_budget_max`` times
    the base ones; they never shrink. A budget is no tensor's shape, so a
    change needs no optimizer rebuild. ``mult``: the multiplier the model
    already carries (a resumed run's ``budget_mult``), which the base is
    divided out of."""

    def __init__(self, params, model, mult=1, log=print):
        self.model = model
        self.on = (bool(params.get("adapt_brdf_budget", False))
                   and hasattr(model, "brdf_ray_budget"))
        self.max_mult = int(params.get("adapt_brdf_budget_max", 4))
        self.mult = int(mult) if self.on else 1
        self.log = log
        if self.on:
            self.base = (tuple(b // self.mult for b in model.brdf_ray_budget),
                         tuple(r // self.mult
                               for r in model.max_retrace_rays))

    def apply(self, mult):
        """Set the model's budgets to ``mult`` times the base."""
        if self.on:
            self.model.brdf_ray_budget = tuple(b * mult
                                               for b in self.base[0])
            self.model.max_retrace_rays = tuple(r * mult
                                                for r in self.base[1])

    @contextlib.contextmanager
    def at_base(self):
        """The model at the base budgets within the block."""
        self.apply(1)
        try:
            yield
        finally:
            self.apply(self.mult)

    def after_step(self, it, metrics):
        if not self.on or (it + 1) % 16:
            return
        thin = min(float(metrics.get("thin_scale", 1.0)),
                   float(metrics.get("thin_scale_retrace", 1.0)))
        if thin < 0.5 and self.mult * 2 <= self.max_mult:
            self.mult *= 2
            self.apply(self.mult)
            self.log(f"iter {it}: brdf budget mult -> x{self.mult} "
                     f"(thin={thin:.2f})")

    def config(self, cfg):
        """``cfg`` with the model's live budgets, for a resume checkpoint:
        the resume divides ``budget_mult`` back out of them."""
        if self.mult == 1:
            return cfg
        cfg = copy.deepcopy(cfg)
        model_cfg = cfg["model"]["arch"]["model"]
        model_cfg["brdf_ray_budget"] = list(self.model.brdf_ray_budget)
        model_cfg["max_retrace_rays"] = list(self.model.max_retrace_rays)
        return cfg


def stream_seed(seed: int, start_iter: int) -> int:
    """Seed of a run's random streams: ``seed`` for a fresh run; for a run
    resumed at ``start_iter``, a number drawn from numpy's SeedSequence of
    (seed, start_iter)."""
    if start_iter == 0:
        return int(seed)
    return int(np.random.SeedSequence([int(seed), int(start_iter)])
               .generate_state(1, np.uint32)[0])


def schedule_events(nmf):
    """The iterations at which the field or the sampler changes and the
    optimizer is rebuilt: the upsamples, the alpha-mask rebuilds and the
    occupancy-grid shrinks. The occupancy grid's density sweep every
    ``update_freq`` iterations (in ``NMF.check_schedule``) is no event:
    it keeps the optimizer."""
    s = nmf.sampler
    return (set(nmf.rf.upsamp_list) | set(getattr(s, "update_list", ()))
            | set(getattr(s, "shrink_iters", ())))


def _final_n_vis(cfg):
    """View count of the final eval and of render_only: final_N_vis, else
    N_vis."""
    final_n = cfg.get("final_N_vis")
    return cfg.get("N_vis", -1) if final_n is None else final_n


def ray_logger(cfg):
    """The eval's ray logger when the config sets ``log_rays``, else None."""
    return RayLogger(enable=True) if cfg.get("log_rays") else None


def _resolve_gt_bg(cfg, datadir, test_ds):
    """The ground-truth panorama of the envmap metrics, as nmf_tpu resolves
    it for the final eval and render_only alike: the top-level ``gt_bg``
    path, replaced by the dataset yaml's ``gt_bg`` where that file exists
    under ``<datadir>/backgrounds``, read with ``imread_any``; without
    either, the procedural scene's own ``gt_bg_im`` (or None)."""
    gt_bg_path = cfg.get("gt_bg")
    if cfg["dataset"].get("gt_bg"):
        ds_bg = Path(datadir) / "backgrounds" / cfg["dataset"]["gt_bg"]
        if ds_bg.exists():
            gt_bg_path = str(ds_bg)
    if gt_bg_path:
        return imread_any(gt_bg_path)
    return test_ds.get("gt_bg_im")


def _expname(cfg):
    expname = f"{cfg['dataset']['scenedir'].split('/')[-1]}_{cfg['expname']}"
    if cfg.get("add_timestamp"):
        expname += datetime.datetime.now().strftime("-%Y%m%d-%H%M%S")
    return expname


def reconstruction(cfg, log=print):
    """Train, then evaluate the test split. Returns (nmf, results): the
    final test metrics plus the last logged train loss, rays/s, batch and
    thinning factors, and the training loop's seconds. A ``stop_iter``
    pause returns the train metrics and ``paused_at``."""
    params = cfg["model"]["params"]
    tier = cfg.get("eval_tier", "train")
    eval_lib.validate_eval_tier(tier)
    device = torch.device(cfg.get("device", "cuda"))
    expname = _expname(cfg)
    logfolder = Path(cfg.get("basedir", "./log")) / expname
    logfolder.mkdir(parents=True, exist_ok=True)
    config_lib.save_config(cfg, logfolder / "config.yaml")
    run_log = RunLogger(logfolder, echo=log)
    log = run_log.info

    datadir = cfg.get("datadir", "/data")
    train_ds = load_dataset(cfg["dataset"], datadir, split="train")
    test_ds = load_dataset(cfg["dataset"], datadir, split="test")
    seed = int(cfg.get("seed", 20211200))
    near_far = tuple(cfg["dataset"].get("near_far", train_ds["near_far"]))
    aabb = (np.asarray(train_ds["scene_bbox"], np.float32)
            * float(cfg["dataset"].get("aabb_scale", 1)))
    nmf = build_nmf(cfg["model"]["arch"], aabb, near_far, seed=seed,
                    device=device)
    ndc_ray = bool(cfg["dataset"].get("ndc_ray", False))

    start_iter, extra = 0, {}
    latest_path = logfolder / f"{expname}_latest.th"
    if cfg.get("resume") and latest_path.exists():
        nmf, _, extra = ckpt_lib.load(latest_path, device)
        start_iter = int(extra.get("iteration", 0))
        log(f"resume: {latest_path} at iter {start_iter}")
    elif cfg.get("ckpt"):
        nmf, _, _ = ckpt_lib.load(cfg["ckpt"], device)
    run_seed = stream_seed(seed, start_iter)
    draws = Draws(torch.Generator(device=device).manual_seed(run_seed))
    if start_iter == 0 and not cfg.get("ckpt"):
        pretrain_density(nmf, draws.scoped("pretrain"),
                         float(params.get("start_density", 5e-3)), log=log)
    nmf.sampler.update(nmf.rf, init=True)
    if start_iter == 0:
        calibrate_model(nmf, draws.scoped("calibrate"))

    n_iters = int(params["n_iters"])
    batch = BatchController(params)
    opt = make_optimizer(nmf, params, n_iters)
    # lr_upsample_reset=true restarts the schedule at every event; false
    # continues the global schedule across events
    lr_reset = bool(params.get("lr_upsample_reset", True))
    events = schedule_events(nmf)
    if start_iter:
        last_event = max((e for e in events if e <= start_iter), default=0)
        opt.fast_forward(start_iter - last_event if lr_reset else start_iter)
        batch.size = int(extra.get("cur_bs", batch.size))
    lr_decay_iters = int(cfg.get("lr_decay_iters", -1) or -1)
    if lr_decay_iters <= 0:
        lr_decay_iters = n_iters
    tv_decay = float(cfg.get("lr_decay_target_ratio",
                             params.get("lr_decay_target_ratio", 0.1))
                     ) ** (1.0 / lr_decay_iters)
    tv_mult = tv_decay ** start_iter
    ori_decay = lambda_decay(params, "ori", n_iters)
    pred_decay = lambda_decay(params, "pred", n_iters)
    ori_mult, pred_mult = ori_decay ** start_iter, pred_decay ** start_iter
    budgets = BudgetController(params, nmf.model,
                               mult=extra.get("budget_mult", 1), log=log)
    store_rays = torch.from_numpy(train_ds["all_rays"]).to(device)
    store_rgb = torch.from_numpy(train_ds["all_rgbs"]).to(device)
    # per-ray ground-truth normals, batched with the rays (normal_err)
    store_norms = (None if train_ds.get("all_norms") is None else
                   torch.from_numpy(train_ds["all_norms"]).to(device))
    sampler = trainer.SimpleSampler(
        store_rays.shape[0], batch.size,
        seed=stream_seed(cfg.get("seed", 0), start_iter))
    rng = np.random.default_rng(stream_seed(cfg.get("seed", 0), start_iter))
    bg_mode = params.get("bg_col", "white")
    refresh = max(int(cfg.get("progress_refresh_rate", 50) or 50), 1)
    vis_every = int(cfg.get("vis_every", 0) or 0)
    save_every = int(cfg.get("save_every", 0) or 0)
    stop_iter = int(cfg.get("stop_iter", 0) or 0)
    iter_limit = min(n_iters, stop_iter) if stop_iter > 0 else n_iters

    def save_resume(iteration):
        ckpt_lib.save(latest_path, nmf, budgets.config(cfg), extra={
            "iteration": iteration, "cur_bs": int(batch.size),
            "budget_mult": budgets.mult})

    l1_rest = any(e <= start_iter for e in events) if start_iter else False
    rays_done = 0
    results = {}
    t_start = time.time()
    for it in range(start_iter, iter_limit):
        bg_col = trainer.bg_col_for(bg_mode, rng)
        ids = torch.from_numpy(sampler.nextids(batch.size)).to(device)
        rays, rgba = store_rays[ids], store_rgb[ids]
        bg_t = torch.from_numpy(bg_col).to(device)
        rgb_gt = (rgba[:, :3] * rgba[:, 3:] + (1 - rgba[:, 3:]) * bg_t
                  if rgba.shape[-1] == 4 else rgba)
        metrics = trainer.train_step(
            nmf, opt, rays, rgb_gt, tuple(float(c) for c in bg_col),
            make_loss_weights(params, l1_rest, tv_mult, ori_mult,
                              pred_mult), draws=draws, ndc_ray=ndc_ray,
            gt_normals=None if store_norms is None else store_norms[ids],
            hdr=nmf.hdr)
        tv_mult *= tv_decay
        ori_mult *= ori_decay
        pred_mult *= pred_decay
        rays_done += rays.shape[0]
        batch.after_step(it, metrics["n_valid_samples"])
        budgets.after_step(it, metrics)
        if it % refresh == 0 or it == iter_limit - 1:
            mse = float(metrics["photo_mse"])
            psnr = -10 * math.log10(max(mse, 1e-10))
            loss = float(metrics["loss"])
            rays_per_sec = rays_done / max(time.time() - t_start, 1e-9)
            shading = {k: float(metrics[k]) for k in
                       ("thin_scale", "thin_scale_retrace", "visibility_loss",
                        "bright_share") if k in metrics}
            results.update(loss=loss, train_psnr=psnr,
                           rays_per_sec=rays_per_sec, batch=rays.shape[0],
                           budget_mult=budgets.mult, **shading)
            run_log.scalars(it, psnr=psnr, loss=loss,
                            rays_per_sec=round(rays_per_sec, 1),
                            n_valid_samples=int(metrics["n_valid_samples"]),
                            **{k: round(v, 4) for k, v in shading.items()})
            log(f"iter {it:06d} psnr={psnr:.2f} loss={loss:.5f} "
                f"rays/s={rays_per_sec:.0f} batch={rays.shape[0]}"
                + "".join(f" {k}={v:.3f}" for k, v in shading.items()))
        if nmf.check_schedule(it + 1):
            opt = make_optimizer(nmf, params, n_iters)
            if not lr_reset:
                opt.fast_forward(it + 1)
            l1_rest = True
            batch.reset()
            log(f"iter {it}: schedule event -> optimizer reinit; "
                f"grid={nmf.rf.live_grid_size}, "
                f"aabb={nmf.rf.aabb.detach().cpu().numpy().round(4).tolist()}")
        if (vis_every > 0 and cfg.get("N_vis", 0) != 0
                and (it + 1) % vis_every == 0):
            res = eval_lib.evaluate(
                nmf, test_ds, save_dir=str(logfolder / "imgs_vis"),
                n_vis=cfg.get("N_vis", 5), seed=seed, prefix=f"{it:06d}_",
                compute_extra_metrics=False)
            log(f"iter {it} test: {res}")
            if cfg.get("save_often"):
                ckpt_lib.save(logfolder / f"{expname}_{it}.th", nmf, cfg)
        if save_every and (it + 1) % save_every == 0 and it + 1 < n_iters:
            save_resume(it + 1)

    results["train_seconds"] = time.time() - t_start
    if iter_limit < n_iters:
        save_resume(iter_limit)
        log(f"stop_iter pause at {iter_limit}/{n_iters}; resume=True "
            "continues")
        run_log.close()
        results["paused_at"] = iter_limit
        return nmf, results

    # the final checkpoint holds the configured budgets; the evals run at
    # the ones the field was trained with (render_path, as nmf_tpu's, at
    # the configured ones)
    with budgets.at_base():
        ckpt_lib.save(logfolder / f"{expname}.th", nmf, cfg)
    if budgets.mult != 1:
        log(f"final eval at trained budgets (x{budgets.mult}); checkpoint "
            "saved at configured budgets")
    if cfg.get("render_test", True):
        with eval_lib.apply_eval_tier(nmf, tier):
            res = eval_lib.evaluate(
                nmf, test_ds, save_dir=str(logfolder / "imgs_test_all"),
                n_vis=_final_n_vis(cfg), seed=seed,
                gt_bg=_resolve_gt_bg(cfg, datadir, test_ds),
                ray_logger=ray_logger(cfg))
        log(f"final test: {res}")
        results.update(res)
    if cfg.get("render_train", False):
        res_tr = eval_lib.evaluate(
            nmf, train_ds, save_dir=str(logfolder / "imgs_train_all"),
            n_vis=cfg.get("N_vis", -1), seed=seed)
        log(f"train-split eval: {res_tr}")
        results["train_split"] = res_tr
    if cfg.get("render_path", False):
        W, H = test_ds["img_wh"]
        with budgets.at_base():
            eval_lib.render_path(nmf, (H, W), train_ds["focal"],
                                 save_dir=str(logfolder / "imgs_path"),
                                 draws=Draws(torch.Generator(device=device)
                                             .manual_seed(seed)))
        log("render_path done")
    run_log.close()
    return nmf, results


def render_test(cfg, log=print):
    """Evaluate the checkpoint ``ckpt`` on the test split (the final eval's
    view count, seed and ``eval_tier``) and, with ``render_train``, on the
    train split; through the streaming renderer with ``stream``; with
    ``fixed_bg``, under that file's envmap. Returns (nmf, test metrics)."""
    if not cfg.get("ckpt"):
        raise SystemExit(
            "render_only=True requires ckpt=<path to a .th checkpoint>")
    tier = cfg.get("eval_tier", "train")
    eval_lib.validate_eval_tier(tier)
    device = torch.device(cfg.get("device", "cuda"))
    nmf, _, _ = ckpt_lib.load(cfg["ckpt"], device)
    if cfg.get("fixed_bg"):
        nmf.bg_module = ckpt_lib.load_envmap(cfg["fixed_bg"], device)
    datadir = cfg.get("datadir", "/data")
    test_ds = load_dataset(cfg["dataset"], datadir, split="test")
    logfolder = Path(cfg.get("basedir", "./log")) / _expname(cfg)
    seed = int(cfg.get("seed", 20211200))
    streaming = bool(cfg.get("stream", False))
    with eval_lib.apply_eval_tier(nmf, tier):
        res = eval_lib.evaluate(nmf, test_ds,
                                save_dir=str(logfolder / "imgs_render"),
                                n_vis=_final_n_vis(cfg), seed=seed,
                                gt_bg=_resolve_gt_bg(cfg, datadir, test_ds),
                                streaming=streaming,
                                ray_logger=ray_logger(cfg))
        log(f"render_test: {res}")
        if cfg.get("render_train", False):
            train_ds = load_dataset(cfg["dataset"], datadir, split="train")
            res_tr = eval_lib.evaluate(
                nmf, train_ds, save_dir=str(logfolder / "imgs_train_all"),
                n_vis=cfg.get("N_vis", -1), seed=seed, streaming=streaming)
            log(f"train-split eval: {res_tr}")
    return nmf, res


def dispatch(cfg, log=print):
    if cfg.get("render_only"):
        return render_test(cfg, log=log)
    if isinstance(cfg.get("dataset"), list):
        from .train_dualbg import reconstruction_dual

        return reconstruction_dual(cfg, log=log)
    return reconstruction(cfg, log=log)


def expand_multirun(argv):
    """The jobs of a ``-m`` sweep: every override whose value is a bare
    comma list (a value in brackets is a list, not a sweep) is swept, the
    jobs are the cartesian product, in order. Returns [(job overrides,
    {swept key: value})]."""
    keys, choices, fixed = [], [], []
    for ov in argv:
        if "=" in ov:
            k, v = ov.split("=", 1)
            if "," in v and not v.strip().startswith("["):
                keys.append(k)
                choices.append(v.split(","))
                continue
        fixed.append(ov)
    jobs = []
    for combo in itertools.product(*choices):
        swept = dict(zip(keys, combo))
        jobs.append((fixed + [f"{k}={v}" for k, v in swept.items()], swept))
    return jobs


def multirun(argv, log=print):
    """Run the sweep's jobs one after the other. Each job's run folder is
    its own: the scene names it, and each swept key other than ``dataset``
    adds ``-<last key part><value>`` to ``expname``. The first job that
    raises stops the sweep. Returns the jobs' results."""
    jobs = expand_multirun(argv)
    results = []
    for i, (job_argv, swept) in enumerate(jobs):
        cfg = config_lib.compose(job_argv)
        suffix = "".join(f"-{k.rsplit('.', 1)[-1]}{v}"
                         for k, v in swept.items() if k != "dataset")
        if suffix:
            cfg["expname"] = f"{cfg.get('expname', 'run')}{suffix}"
        log(f"[multirun {i + 1}/{len(jobs)}] "
            + " ".join(f"{k}={v}" for k, v in swept.items()))
        results.append(dispatch(cfg, log=log))
    return results


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if "-m" in argv or "--multirun" in argv:
        return multirun([a for a in argv if a not in ("-m", "--multirun")])
    return dispatch(config_lib.compose(argv))


if __name__ == "__main__":
    main()
