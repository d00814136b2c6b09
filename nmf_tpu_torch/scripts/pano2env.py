"""Fit an IntegralEquirect envmap to a panorama image and write it as an
envmap file (``nmf_tpu/scripts/pano2env.py``), which ``render_only
fixed_bg=<file>`` and ``compose_scenes --bg`` read.

    python -m nmf_tpu_torch.scripts.pano2env input.exr output.th \\
        [--resolution 1024] [--iters 1000] [--device cuda]

The fit: an exp-activated envmap of ``resolution`` x 2 ``resolution``
texels starting at log(max(mean, 1e-3)), mip bias 0, looked up at log
solid angle -6 in the direction of every panorama pixel (equirect: row
theta from +z, column phi); each iteration takes ``batch`` pixels drawn by
``np.random.default_rng(0)`` and one Adam step (lr 0.15, betas 0.9 /
0.99, optax's arithmetic) on all four of its tensors against the mean
absolute error. Inputs: ``.pfm`` through ``data.ray_utils.read_pfm``,
anything else through ``data.exr.imread_any`` (HDR EXR values stay
linear).
"""
import argparse
import math

import numpy as np
import torch


def pano_directions(H, W):
    """(H W, 3) unit directions of an equirect panorama's pixel centres."""
    js, is_ = np.meshgrid(np.arange(W), np.arange(H))
    theta = (is_ + 0.5) / H * math.pi
    phi = (js + 0.5) / W * 2 * math.pi - math.pi
    return np.stack([np.sin(theta) * np.cos(phi),
                     np.sin(theta) * np.sin(phi),
                     np.cos(theta)], -1).reshape(-1, 3).astype(np.float32)


def fit_pano(pano, bg_resolution=1024, iters=1000, batch=65536, lr=0.15,
             device="cuda", log=print, on_step=None):
    """The fitted ``IntegralEquirect`` on ``device`` for an (H, W, 3)
    panorama. ``on_step(it, loss, tensors, grads, m, v)``, if given, sees
    every step after its update."""
    from .. import trainer
    from ..modules.bg import init_integral_equirect

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device=cuda but torch sees no CUDA device; "
                           "pass --device cpu to run on the CPU")
    bg = init_integral_equirect(
        bg_resolution=bg_resolution,
        init_val=float(np.log(max(pano.mean(), 1e-3))), activation="exp",
        mipbias=0.0).to(device)
    dirs = pano_directions(*pano.shape[:2])
    cols = pano.reshape(-1, 3).astype(np.float32)
    tensors = [bg.bg_mat, bg.mipbias, bg.brightness, bg.mul]
    m = [torch.zeros_like(t) for t in tensors]
    v = [torch.zeros_like(t) for t in tensors]
    sa = torch.full((batch,), -6.0, device=device)
    rng = np.random.default_rng(0)
    for it in range(iters):
        ids = rng.integers(0, dirs.shape[0], size=(batch,))
        d = torch.from_numpy(dirs[ids]).to(device)
        c = torch.from_numpy(cols[ids]).to(device)
        loss = (bg(d, sa, cache=bg.prepare(with_sh=False)) - c).abs().mean()
        grads = torch.autograd.grad(loss, tensors)
        for t, g, mi, vi in zip(tensors, grads, m, v):
            # optax.adam(lr, b1=0.9, b2=0.99) over all four tensors
            trainer.adam_step(t, g, mi, vi, it + 1, lr, -1.0, 0.9, 0.99,
                              1e-8)
        if on_step is not None:
            on_step(it, loss.detach(), tensors, grads, m, v)
        if it % 100 == 0:
            log(f"pano fit iter {it}: loss {float(loss.detach()):.5f}")
    return bg


def read_pano(path):
    """The (H, W, 3) float32 panorama at ``path``."""
    if str(path).endswith(".pfm"):
        from ..data.ray_utils import read_pfm

        pano = read_pfm(path)[0]
    else:
        from ..data.exr import imread_any

        pano = imread_any(path)
    return np.asarray(pano, dtype=np.float32)[..., :3]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--resolution", type=int, default=1024)
    p.add_argument("--iters", type=int, default=1000)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from .. import ckpt

    bg = fit_pano(read_pano(args.input), bg_resolution=args.resolution,
                  iters=args.iters, device=args.device)
    ckpt.save_envmap(args.output, bg, {"source": args.input})
    print(f"saved {args.output}")
    return bg


if __name__ == "__main__":
    main()
