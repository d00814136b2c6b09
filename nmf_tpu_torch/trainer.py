"""Training library (``nmf_tpu/trainer.py``): optimizer groups, the
optimizer, the loss and the train step.

The optimizer computes what nmf_tpu's ``make_optimizer(fused=True)`` does:
optax's global-norm clip, the weight decay added to the clipped gradient,
one Adam over every tensor, a per-group learning rate and the mip-NeRF
schedule. nmf_tpu
differentiates every float leaf of its model, including the scene box
``rf.aabb`` (frozen, learning rate 0); its gradient enters the global norm
of the clip, so the train step gives the box a gradient too.
"""
import math
import re
from typing import NamedTuple, Optional

import numpy as np
import torch

from .render import NMF, render


def label_for_path(s: str) -> str:
    """Optimizer group of a parameter path ("rf/density_rf/planes/0").
    Each envmap of a ``MultiBG`` ("bg_module/bgs/1/bg_mat") takes the
    envmap's groups; nmf_tpu's labels freeze them (ROADMAP C.9)."""
    s = re.sub(r"^bg_module/bgs/\d+/", "bg_module/", s)
    if s.startswith(("rf/density_rf", "rf/app_rf", "rf/encoding",
                     "rf/density_grid", "rf/app_grid", "rf/grid_rows")):
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
    # L2 as torch's Adam: weight_decay * param added to the gradient after
    # the clip, before the moments (optax.add_decayed_weights)
    weight_decay: float = 0.0


def group_lrs(nmf: NMF):
    """Learning rate of each group, from the module definitions. Every
    group shares the optimizer's betas (nmf_tpu's fused optimizer); the one
    group with other betas, bg_mul, has learning rate 0 in the shipped
    configs."""
    s = nmf.lr_scale
    # a model without a top-level material head (DualModel) gives the
    # group nmf_tpu's fallback 1e-3; it has no tensor in it
    dm = getattr(nmf.model, "diffuse_module", None)
    lrs = {"rf_grid": nmf.rf.lr * s, "rf_net": nmf.rf.lr_net * s,
           "diffuse": (dm.lr if dm is not None else 1e-3) * s,
           "frozen": 0.0}
    brdf = getattr(nmf.model, "brdf", None)
    if brdf is not None:
        lrs["brdf"] = brdf.lr * s
    if nmf.normal_module is not None:
        lrs["normal"] = nmf.normal_module.lr * s
    vis = getattr(nmf.model, "visibility_module", None)
    if vis is not None:
        lrs["visibility"] = vis.lr * s
    bg = nmf.bg_module
    if bg is not None:
        lrs.update(bg=bg.lr * s, bg_mipbias=bg.mipbias_lr * s,
                   bg_brightness=bg.brightness_lr * s, bg_mul=bg.mul_lr * s)
    return lrs


def differentiated_tensors(nmf: NMF):
    """(path, tensor, label) of every tensor the train step differentiates:
    the parameters, the field's and the sampler's boxes, the normal blend
    and the annealed proposal pad (frozen; the sampler's box takes a
    gradient through the retrace pass, the blend through a normal module,
    the pad through a retrace pass's proposal)."""
    out = [(name.replace(".", "/"), p, label_for_path(name.replace(".", "/")))
           for name, p in nmf.named_parameters()]
    out.append(("rf/aabb", nmf.rf.aabb, "frozen"))
    out.append(("sampler/aabb", nmf.sampler.aabb, "frozen"))
    out.append(("predicted_normal_lambda", nmf.predicted_normal_lambda,
                "frozen"))
    if nmf.proposal_pad_cur is not None:
        out.append(("proposal_pad_cur", nmf.proposal_pad_cur, "frozen"))
    return out


@torch.no_grad()
def adam_step(t, g, m, v, count, lr, step_size, b1, b2, eps):
    """One optax.adam update of ``t`` in place: the moments ``m``, ``v``
    take the gradient ``g``, then ``t += (update * lr) * step_size``,
    skipped at lr 0 (a frozen tensor's moments still move). ``count`` is
    1-based; the bias corrections are taken in f32, as optax's."""
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * (g * g))
    if lr == 0.0:
        return
    bc1 = 1 - np.float32(b1) ** np.float32(count)
    bc2 = 1 - np.float32(b2) ** np.float32(count)
    upd = (m / float(bc1)) / (torch.sqrt(v / float(bc2)) + eps)
    t.add_((upd * lr) * step_size)


class Optimizer:
    """Clip by global norm, Adam, per-group lr, schedule.

    The update of step ``count`` (0-based) is
    ``-sched(count) * lr * m_hat / (sqrt(v_hat) + eps)`` with optax's
    moment and bias-correction arithmetic. Frozen tensors (lr 0) count in
    the clip's norm and never move: as in nmf_tpu, every tensor of the
    shading model outside ``diffuse_module``, ``brdf`` and
    ``visibility_module`` is frozen, Ref-NeRF's reflection MLP and both
    of DualModel's models among them.
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

    def fast_forward(self, step: int):
        """Set the step count, which drives both the lr schedule and Adam's
        bias correction (nmf_tpu's ``fast_forward_opt_state``): a fresh
        optimizer continues the global schedule from ``step`` instead of
        restarting it."""
        self.count = int(step)

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
        if cfg.weight_decay:
            # every tensor, the frozen ones too (their lr keeps them still)
            grads = [g + cfg.weight_decay * t
                     for (t, _), g in zip(self.entries, grads)]
        count = self.count + 1
        step_size = -self.sched(self.count)
        for (t, lr), g, m, v in zip(self.entries, grads, self.m, self.v):
            adam_step(t, g, m, v, count, lr, step_size, b1, b2, cfg.eps)
        self.count = count


class LossWeights(NamedTuple):
    """Per-iteration loss weights (nmf_tpu's LossWeights). The visibility
    term's weight is fixed at 1 (its inputs are detached: it trains the
    visibility MLP alone); ``charbonier`` swaps the clipped squared error
    for sqrt(d^2 + charbonier_eps^2) on the unclipped colours."""
    distortion_lambda: float = 0.0
    l1_weight: float = 8e-5
    ortho_weight: float = 0.0
    tv_weight_density: float = 0.0
    tv_weight_app: float = 0.0
    ori_lambda: float = 0.0
    pred_lambda: float = 0.0
    envmap_lambda: float = 0.0
    diffuse_lambda: float = 0.0
    brdf_lambda: float = 0.0
    normal_err_lambda: float = 0.0
    tv_weight_bg: float = 0.0
    visibility_lambda: float = 1.0
    charbonier: bool = False
    charbonier_eps: float = 1e-3


def huber_loss(pred, target, delta=1.0):
    """optax's elementwise Huber loss: 0.5 d^2 for |d| <= delta, else
    delta (|d| - 0.5 delta)."""
    err = torch.abs(pred - target)
    quad = torch.clamp(err, max=delta)
    return 0.5 * quad ** 2 + delta * (err - quad)


# loss weight -> render stat it scales
_STAT_TERMS = (("distortion_lambda", "distortion_loss"),
               ("ori_lambda", "ori_loss"),
               ("pred_lambda", "prediction_loss"),
               ("envmap_lambda", "envmap_reg"),
               ("diffuse_lambda", "diffuse_reg"), ("brdf_lambda", "brdf_reg"),
               ("normal_err_lambda", "normal_err"))


def compute_loss(nmf: NMF, rays, rgb_gt, weights: LossWeights, bg_col,
                 draws, ndc_ray=False, gt_normals=None, hdr=False):
    """Photometric + regularizer loss. Returns (loss, metrics). The envmap
    cache is built once here for the whole step; ``ndc_ray``: the rays are
    NDC rays; ``gt_normals`` (B, 3): the rays' ground-truth normals (the
    normal-error term needs them); ``hdr``: the photometric term is the
    summed Huber loss (delta 1) on the unclipped colours, ahead of
    Charbonier. ``photo_mse`` is the clipped squared error whatever the
    term."""
    bg_cache = nmf.bg_module.prepare() if nmf.bg_module is not None else None
    ims, stats = render(nmf, rays, is_train=True, bg_col=bg_col,
                        draws=draws, bg_cache=bg_cache, ndc_ray=ndc_ray,
                        gt_normals=gt_normals)
    rgb_map = ims["rgb_map"]
    B = rays.shape[0]
    sq = (torch.clamp(rgb_map, 0, 1) - torch.clamp(rgb_gt, 0, 1)) ** 2
    if hdr:
        total = huber_loss(rgb_map, rgb_gt).sum()
    elif weights.charbonier:
        total = torch.sqrt((rgb_map - rgb_gt) ** 2
                           + weights.charbonier_eps ** 2).sum()
    else:
        total = sq.sum()
    for weight_name, stat in _STAT_TERMS:
        w = getattr(weights, weight_name)
        if w:
            total = total + w * stats[stat]
    if "visibility_loss" in stats:
        total = total + weights.visibility_lambda * B * stats[
            "visibility_loss"]
    for w, reg in ((weights.l1_weight, nmf.rf.density_L1),
                   (weights.ortho_weight, nmf.rf.vector_comp_diffs),
                   (weights.tv_weight_density, nmf.rf.tv_loss_density),
                   (weights.tv_weight_app, nmf.rf.tv_loss_app),
                   (weights.tv_weight_bg, getattr(nmf.bg_module, "tv_loss",
                                                  None))):
        if w and reg is not None:
            total = total + w * reg() * B
    total = total / B
    metrics = {"loss": total.detach(), "photo_mse": sq.detach().mean(),
               "n_valid_samples": stats["n_valid_samples"]}
    for k in ("thin_scale", "thin_scale_retrace", "visibility_loss",
              "bright_share"):
        if k in stats:
            metrics[k] = stats[k].detach()
    return total, metrics


def train_step(nmf: NMF, opt: Optimizer, rays, rgb_gt, bg_col,
               weights: LossWeights, draws, ndc_ray=False, gt_normals=None,
               hdr=False):
    """One step: loss, backward, optimizer update. A non-finite loss skips
    the update (parameters and optimizer state stay as they were)."""
    opt.zero_grad()
    loss, metrics = compute_loss(nmf, rays, rgb_gt, weights, bg_col,
                                 draws=draws, ndc_ray=ndc_ray,
                                 gt_normals=gt_normals, hdr=hdr)
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
