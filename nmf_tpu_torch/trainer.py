"""Training library (``nmf_tpu/trainer.py``): optimizer groups, the
optimizer, the loss and the train step.

The optimizer computes what nmf_tpu's ``make_optimizer(fused=True)`` does
with the shipped configs (no weight decay): optax's global-norm clip, one
Adam over every tensor, a per-group learning rate and the mip-NeRF
schedule. nmf_tpu
differentiates every float leaf of its model, including the scene box
``rf.aabb`` (frozen, learning rate 0); its gradient enters the global norm
of the clip, so the train step gives the box a gradient too.
"""
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .render import NMF, render


def label_for_path(s: str) -> str:
    """Optimizer group of a parameter path ("rf/density_rf/planes/0")."""
    if s.startswith(("rf/density_rf", "rf/app_rf", "rf/encoding",
                     "rf/density_grid", "rf/app_grid")):
        return "rf_grid"
    if s.startswith(("rf/basis_mat", "rf/dbasis_mat", "rf/density_mlp",
                     "rf/app_mlp")):
        return "rf_net"
    if s.startswith("rf/fields"):
        return "frozen"
    if s.startswith("model/diffuse_module"):
        if s.endswith("diffuse_bias") or s.endswith("roughness_bias"):
            return "frozen"
        return "diffuse"
    if s.startswith("model/brdf/bias"):
        return "frozen"
    if s.startswith("model/brdf"):
        return "brdf"
    if s.startswith("model/visibility_module"):
        return "visibility"
    if s.startswith("model/"):
        return "frozen"
    if s.startswith("normal_module"):
        return "normal"
    if s.startswith("bg_module/bg_mat"):
        return "bg"
    if s.startswith("bg_module/mipbias"):
        return "bg_mipbias"
    if s.startswith("bg_module/brightness"):
        return "bg_brightness"
    if s.startswith("bg_module/mul"):
        return "bg_mul"
    return "frozen"


def lr_decay_schedule(lr_init, lr_final, max_steps, lr_delay_steps=100,
                      lr_delay_mult=0.1):
    """mip-NeRF decay: count -> multiplier from lr_init to lr_final, in
    float32 arithmetic like nmf_tpu's traced schedule."""
    f32 = np.float32

    def sched(count):
        step = f32(count)
        if lr_delay_steps > 0:
            delay = f32(lr_delay_mult) + f32(1 - lr_delay_mult) * np.sin(
                f32(0.5 * np.pi) * np.clip(step / f32(lr_delay_steps),
                                           f32(0), f32(1)))
        else:
            delay = f32(1.0)
        t = np.clip(step / f32(max_steps), f32(0), f32(1))
        return float(delay * np.exp((f32(1) - t) * f32(math.log(lr_init))
                                    + t * f32(math.log(lr_final))))
    return sched


class OptimConfig(NamedTuple):
    betas: tuple = (0.9, 0.99)
    eps: float = 1e-8
    lr_init: float = 1.0
    lr_final: float = 1e-3
    lr_delay_steps: int = 100
    lr_delay_mult: float = 0.1
    n_iters: int = 30000
    clip_grad: Optional[float] = None


def group_lrs(nmf: NMF):
    """Learning rate of each group, from the module definitions."""
    s = nmf.lr_scale
    return {"rf_grid": nmf.rf.lr * s, "rf_net": nmf.rf.lr_net * s,
            "diffuse": nmf.model.diffuse_module.lr * s, "frozen": 0.0}


def differentiated_tensors(nmf: NMF):
    """(path, tensor, label) of every tensor the train step differentiates:
    the parameters and the field's box (frozen)."""
    out = [(name.replace(".", "/"), p, label_for_path(name.replace(".", "/")))
           for name, p in nmf.named_parameters()]
    out.append(("rf/aabb", nmf.rf.aabb, "frozen"))
    return out


class Optimizer:
    """Clip by global norm, Adam, per-group lr, schedule.

    The update of step ``count`` (0-based) is
    ``-sched(count) * lr * m_hat / (sqrt(v_hat) + eps)`` with optax's
    moment and bias-correction arithmetic. Frozen tensors (lr 0) count in
    the clip's norm and never move.
    """

    def __init__(self, nmf: NMF, cfg: OptimConfig):
        self.cfg = cfg
        lrs = group_lrs(nmf)
        self.entries = [(t, lrs.get(label, 0.0))
                        for _, t, label in differentiated_tensors(nmf)]
        for t, _ in self.entries:
            t.requires_grad_(True)
        self.sched = lr_decay_schedule(cfg.lr_init, cfg.lr_final,
                                       cfg.n_iters, cfg.lr_delay_steps,
                                       cfg.lr_delay_mult)
        self.count = 0
        self.m = [torch.zeros_like(t) for t, _ in self.entries]
        self.v = [torch.zeros_like(t) for t, _ in self.entries]

    def zero_grad(self):
        for t, _ in self.entries:
            t.grad = None

    @torch.no_grad()
    def step(self):
        cfg = self.cfg
        b1, b2 = cfg.betas
        grads = [t.grad if t.grad is not None else torch.zeros_like(t)
                 for t, _ in self.entries]
        if cfg.clip_grad:
            # optax clip_by_global_norm: unchanged below the limit, else
            # g / |g| * limit
            g_norm = torch.sqrt(sum((g * g).sum() for g in grads))
            keep = g_norm < cfg.clip_grad
            grads = [torch.where(keep, g, (g / g_norm) * cfg.clip_grad)
                     for g in grads]
        count = self.count + 1
        bc1 = 1 - np.float32(b1) ** np.float32(count)
        bc2 = 1 - np.float32(b2) ** np.float32(count)
        step_size = -self.sched(self.count)
        for (t, lr), g, m, v in zip(self.entries, grads, self.m, self.v):
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * (g * g))
            if lr == 0.0:
                continue
            upd = (m / float(bc1)) / (torch.sqrt(v / float(bc2)) + cfg.eps)
            t.add_((upd * lr) * step_size)
        self.count = count


class LossWeights(NamedTuple):
    """Per-iteration loss weights (nmf_tpu's LossWeights). Terms that the
    tensorf slice computes as exact zeros (normal, envmap, BRDF and
    visibility terms) are not computed."""
    distortion_lambda: float = 0.0
    l1_weight: float = 8e-5
    ortho_weight: float = 0.0
    tv_weight_density: float = 0.0
    tv_weight_app: float = 0.0


def compute_loss(nmf: NMF, rays, rgb_gt, weights: LossWeights, bg_col,
                 jitter=None, generator=None):
    """Photometric + regularizer loss. Returns (loss, metrics)."""
    for name in ("ortho_weight", "tv_weight_density", "tv_weight_app"):
        if getattr(weights, name):
            raise NotImplementedError(
                f"{name} is not ported yet (tensorf slice)")
    ims, stats = render(nmf, rays, is_train=True, bg_col=bg_col,
                        jitter=jitter, generator=generator)
    rgb_map = ims["rgb_map"]
    B = rays.shape[0]
    sq = (torch.clamp(rgb_map, 0, 1) - torch.clamp(rgb_gt, 0, 1)) ** 2
    total = sq.sum()
    if weights.distortion_lambda:
        total = total + weights.distortion_lambda * stats["distortion_loss"]
    if weights.l1_weight:
        total = total + weights.l1_weight * nmf.rf.density_L1() * B
    total = total / B
    metrics = {"loss": total.detach(), "photo_mse": sq.detach().mean(),
               "n_valid_samples": stats["n_valid_samples"]}
    return total, metrics


def train_step(nmf: NMF, opt: Optimizer, rays, rgb_gt, bg_col,
               weights: LossWeights, jitter=None, generator=None):
    """One step: loss, backward, optimizer update. A non-finite loss skips
    the update (parameters and optimizer state stay as they were)."""
    opt.zero_grad()
    loss, metrics = compute_loss(nmf, rays, rgb_gt, weights, bg_col,
                                 jitter=jitter, generator=generator)
    loss.backward()
    if bool(torch.isfinite(loss.detach())):
        opt.step()
    return metrics


class SimpleSampler:
    """Random permutation ray-batch cursor."""

    def __init__(self, total, batch, seed=0):
        self.total = total
        self.batch = batch
        self.curr = total
        self.ids = None
        self.rng = np.random.default_rng(seed)

    def nextids(self, batch=None):
        batch = self.batch if batch is None else batch
        self.curr += batch
        if self.ids is None or self.curr + batch > self.total:
            self.ids = self.rng.permutation(self.total)
            self.curr = 0
        return self.ids[self.curr:self.curr + batch]


def bg_col_for(mode: str, rng) -> np.ndarray:
    if mode == "rand":
        return rng.uniform(size=(3,)).astype(np.float32)
    if mode == "white":
        return np.ones(3, dtype=np.float32)
    if mode == "black":
        return np.zeros(3, dtype=np.float32)
    raise ValueError(f"Unknown bg col mode {mode}")
