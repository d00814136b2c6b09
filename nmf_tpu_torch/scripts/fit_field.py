#!/usr/bin/env python
"""Distill one radiance field into another representation (the port's
``nmf_tpu/scripts/fit_field.py``).

Sample points uniformly in the source field's box, regress the target
field's raw density feature (and its appearance features) onto the
source's with Adam. Converts a trained TensorVMSplit checkpoint into a
HashGridRF or a dense GridRF. On the card the target's backward is K3: the
grid's 8 corner rows of 28 columns a point, or the hash tables' 8 corners
of each level, scattered by ``TakeRows``.

As in nmf_tpu, every float leaf of the target is fitted, its box
(``aabb``) among them: nmf_tpu's ``jax.value_and_grad`` over the field's
pytree differentiates the box, and its Adam moves it (ROADMAP C.16).

Usage:
  python -m nmf_tpu_torch.scripts.fit_field --ckpt log/run/run.th \\
      --target hashgrid --steps 2000 --out /tmp/distilled.th [--device cpu]

The saved checkpoint's config names the target field (``field/hashgrid``
or ``field/grid`` with ``grid_size``), so ``ckpt.load`` of either package
rebuilds the distilled field. nmf_tpu's CLI saves the source's config
instead, and its file loads back as the source's field type with the
distilled arrays dropped (ROADMAP C.15): the port departs there.
"""
import argparse
import copy
import time

import torch

from ..ops.draws import Draws
from ..trainer import adam_step

# optax.adam's defaults
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def fit_tensors(rf):
    """The target's tensors that the fit moves: its parameters and its
    box, in a fixed order."""
    return [*rf.parameters(), rf.aabb]


def sample_points(draws, it, aabb, batch):
    """``batch`` points uniform in the box ``aabb`` (2, 3), as
    ``jax.random.uniform(key, (batch, 3), minval, maxval)``: the draw
    ``points{it}`` of U[0, 1) scaled into the box and kept above its
    lower corner."""
    u = draws.uniform(f"points{it}", (batch, 3), aabb.device)
    return torch.maximum(aabb[0], u * (aabb[1] - aabb[0]) + aabb[0])


def fit_loss(src_rf, rf, xyz, fit_app=True):
    """Mean squared error of the target's raw density feature (and, with
    ``fit_app``, of its appearance features) against the source's, which
    take no gradient. A target with ``raw_features`` (the grid and hash
    fields) gives both from one query, so its backward launches K3 once;
    nmf_tpu queries twice, which changes only the order of the gradient's
    sums."""
    with torch.no_grad():
        s_sig = src_rf.compute_densityfeature(xyz, activate=False)
        s_app = src_rf.compute_appfeature(xyz) if fit_app else None
    if fit_app and hasattr(rf, "raw_features"):
        t_sig, t_app = rf.raw_features(xyz)
    else:
        t_sig = rf.compute_densityfeature(xyz, activate=False)
        t_app = rf.compute_appfeature(xyz) if fit_app else None
    loss = ((t_sig - s_sig) ** 2).mean()
    if fit_app:
        loss = loss + ((t_app - s_app) ** 2).mean()
    return loss


class FitAdam:
    """optax.adam(lr) over ``tensors``: the moments ``m``, ``v`` and the
    1-based ``count`` of ``trainer.adam_step``."""

    def __init__(self, tensors, lr):
        self.tensors, self.lr, self.count = list(tensors), float(lr), 0
        self.m = [torch.zeros_like(t) for t in self.tensors]
        self.v = [torch.zeros_like(t) for t in self.tensors]

    def step(self):
        self.count += 1
        for t, m, v in zip(self.tensors, self.m, self.v):
            g = t.grad if t.grad is not None else torch.zeros_like(t)
            adam_step(t, g, m, v, self.count, self.lr, -1.0, ADAM_B1,
                      ADAM_B2, ADAM_EPS)
            t.grad = None


def fit_field(src_rf, target_rf, steps=2000, batch=65536, lr=1e-2,
              fit_app=True, log_every=200, draws=None, generator=None,
              log=print):
    """Fit ``target_rf`` in place; returns (target_rf, losses), the loss
    of every ``log_every``-th step and of the last. The points come from
    ``draws`` (named ``points{it}``) or a ``generator``."""
    draws = draws if draws is not None else Draws(generator)
    aabb = src_rf.aabb.detach().clone()
    tensors = fit_tensors(target_rf)
    for t in tensors:
        t.requires_grad_(True)
    opt = FitAdam(tensors, lr)
    losses = []
    try:
        for it in range(steps):
            loss = fit_loss(src_rf, target_rf,
                            sample_points(draws, it, aabb, batch), fit_app)
            loss.backward()
            opt.step()
            if it % log_every == 0 or it == steps - 1:
                losses.append(float(loss.detach()))
                log(f"fit_field step {it}: loss={losses[-1]:.5f}")
    finally:
        target_rf.aabb.requires_grad_(False)
    return target_rf, losses


def distilled_config(cfg, target, grid_size):
    """The source checkpoint's config with the target field's: the keys of
    the port's ``field/{target}.yaml`` (a grid's ``grid_size`` set), as
    ``field`` and as ``model.arch.rf``, where ``ckpt.load`` reads it."""
    from ..config import load_group

    field = load_group("field", target)
    if target == "grid":
        field["grid_size"] = [int(grid_size)] * 3
    field["app_dim"] = int(cfg["model"]["arch"]["rf"].get(
        "app_dim", field.get("app_dim", 24)))
    out = copy.deepcopy(cfg)
    out["field"] = field
    out["model"]["arch"]["rf"] = copy.deepcopy(field)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--target", choices=("hashgrid", "grid"),
                    default="hashgrid")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--grid-size", type=int, default=128)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .. import ckpt as ckpt_lib
    from ..builders import build_field

    device = torch.device(args.device)
    nmf, cfg, _ = ckpt_lib.load(args.ckpt, device=device)
    out_cfg = distilled_config(cfg, args.target, args.grid_size)
    # the target at nmf_tpu's defaults (the yaml's keys), drawn on the CPU
    # from seed 0 as build_nmf draws; the points from a generator on the
    # device
    tgt = build_field(torch.Generator().manual_seed(0),
                      out_cfg["model"]["arch"]["rf"],
                      nmf.rf.aabb.detach().cpu().numpy()).to(device)
    draws = Draws(torch.Generator(device=device).manual_seed(0))
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.time()
    fitted, losses = fit_field(nmf.rf, tgt, steps=args.steps,
                               batch=args.batch, lr=args.lr, draws=draws)
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.time() - t0
    nmf.rf = fitted
    ckpt_lib.save(args.out, nmf, out_cfg,
                  extra={"distilled_from": str(args.ckpt),
                         "fit_losses": losses})
    print(f"fit_field: {args.steps} steps of {args.batch} points in "
          f"{seconds:.1f} s ({1e3 * seconds / max(args.steps, 1):.2f} ms a "
          f"step); saved distilled {args.target} field to {args.out}")
    return {"losses": losses, "seconds": seconds, "out": args.out}


if __name__ == "__main__":
    main()
