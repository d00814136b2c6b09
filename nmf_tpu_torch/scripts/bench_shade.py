#!/usr/bin/env python
"""Microprofile of the shading block's pieces of the flagship step, on the
card.

    python -m nmf_tpu_torch.scripts.bench_shade

Port of ``nmf_tpu/scripts/bench_shade.py``, on the flagship at grid 128,
an envmap of 512 x 1024, 128 / 64 samples a ray, bounce budgets (32768,
8192) and 1024 retrace rays (``bench_nmf``, the counterpart of
``__graft_entry__._build_nmf``). Lines (``profile_step.timeit``, CUDA
events): the transmittance at B = 4096 x K = 128, forward and
forward+backward, through the kernel entry ``ops/kernels/composite.
transmittance_weights`` (K1; K2 in the backward) and the plain
``ops/masked.raw2alpha``; ``compact_topk`` and compact + gather at N =
440; the alpha-mask lookup; ``Microfacet.shade`` on M = 4096 x 128
samples with the reflections stubbed (forward, and forward+backward into
the model and the features: its segment sums and parent gathers are K3);
the secondary render of 1024 rays at recursion 1; the normal module, where
the model has one. Needs a CUDA device.

The model is freshly initialised, as nmf_tpu's bench's: no sample earns a
bounce ray (its share, thinned to the budget, rounds to 0), so every slot
of the budget is computed and the segment sums drop every row.
"""
import sys

import numpy as np
import torch

from .. import config
from ..builders import build_nmf
from ..ops.draws import Draws
from ..ops.kernels.composite import transmittance_weights
from ..ops.masked import compact_topk, gather_rows, raw2alpha
from ..render import render
from ..samplers.alphagrid import AlphaGridMask
from ..ops.safemath import normalize
from .profile_step import timeit

# bench_shade.py's flagship (nmf_tpu/scripts/bench_shade.py:22-23)
BENCH_SIZES = {"grid": 128, "bg_res": 512, "k_spr": 128, "recur_k": 64,
               "brdf_budget": (32768, 8192), "retrace": 1024}
AABB = np.array([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]], dtype=np.float32)
NEAR_FAR = (2.0, 6.0)
ALPHA_GRID = 128  # the alpha-mask lookup's volume, 20% occupied


def bench_nmf(grid=64, bg_res=128, k_spr=96, recur_k=48,
              brdf_budget=(8192, 2048), retrace=256, proposal=-1,
              grid_final=None, upsamp=(), device="cuda", seed=0):
    """The flagship of ``__graft_entry__._build_nmf`` (the same overrides
    of ``model=microfacet_tensorf2 dataset=synthetic_sphere``, box +-1.5,
    near / far 2 / 6), built by the port on ``device``. Returns (nmf,
    cfg)."""
    cfg = config.compose([
        "model=microfacet_tensorf2", "dataset=synthetic_sphere",
        f"field.N_voxel_init={grid ** 3}",
        f"field.N_voxel_final={(grid_final or grid) ** 3}",
        f"field.upsamp_list={list(upsamp)}",
        f"model.arch.max_samples_per_ray={k_spr}",
        f"model.arch.recur_samples_per_ray={recur_k}",
        f"model.arch.proposal_samples_per_ray={proposal}",
        f"model.arch.model.brdf_ray_budget=[{brdf_budget[0]},"
        f"{brdf_budget[1]}]",
        f"model.arch.model.max_retrace_rays=[{retrace}]",
        f"model.arch.bg_module.bg_resolution={bg_res}",
    ])
    nmf = build_nmf(cfg["model"]["arch"], AABB, NEAR_FAR, seed=seed,
                    device=device)
    return nmf, cfg


def fresh_draws(device, seed=0):
    return Draws(torch.Generator(device=device).manual_seed(seed))


def stub_reflection(bounce_rays, mipval, retrace, draws):
    """Every bounce ray lit by 1: isolates the MLPs and the bookkeeping."""
    return torch.ones((bounce_rays.shape[0], 3),
                      device=bounce_rays.device), None


def shade_inputs(nmf, M, gen):
    """Flattened shading inputs of M samples: xyz (M, 4) in [-1, 1],
    features (M, app_dim), unit view directions, normals facing them,
    weights in [0, 0.05) and a validity mask (half valid)."""
    dev = gen.device
    vdirs = normalize(torch.randn((M, 3), generator=gen, device=dev))
    return {"xyz": torch.rand((M, 4), generator=gen, device=dev) * 2 - 1,
            "feats": torch.randn((M, nmf.rf.app_dim), generator=gen,
                                 device=dev),
            "vdirs": vdirs, "norms": -vdirs,
            "w": torch.rand(M, generator=gen, device=dev) * 0.05,
            "valid": torch.rand(M, generator=gen, device=dev) < 0.5}


def shade_stub(nmf, ins, B, draws, bg_cache, feats=None):
    """``Microfacet.shade`` in train mode at recursion 0 with the
    reflections stubbed -> rgb (M, 3)."""
    rgb, _ = nmf.model.shade(
        ins["xyz"], ins["xyz"], ins["feats"] if feats is None else feats,
        ins["vdirs"], ins["norms"], ins["w"], ins["valid"], B,
        render_reflection=stub_reflection, bg_module=nmf.bg_module,
        bg_cache=bg_cache, is_train=True, recur=0, draws=draws)
    return rgb


def secondary_rays(T, gen):
    """T retrace rays (T, 6): origins in the inner box, unit directions."""
    dev = gen.device
    ro = torch.rand((T, 3), generator=gen, device=dev) - 0.5
    rd = normalize(torch.randn((T, 3), generator=gen, device=dev))
    return torch.cat([ro, rd], dim=-1)


def secondary(nmf, rays, draws, bg_cache):
    """The retrace pass's render of ``rays`` (recursion 1, no tonemap,
    mip level -5) -> rgb (T, 3)."""
    ims, _ = render(nmf, rays, is_train=True, bg_col=None, draws=draws,
                    recur=1, override_near=0.05, stepmul=1.0, tonemap=False,
                    start_mipval=torch.full((rays.shape[0],), -5.0,
                                            device=rays.device),
                    bg_cache=bg_cache)
    return ims["rgb_map"]


def grads(out, tensors):
    return torch.autograd.grad(out.sum(), tensors, allow_unused=True)


def line(rows, name, ms):
    rows[name] = ms
    print(f"{name + ':':34s} {ms:9.4f} ms")


def bench(nmf, gen, B=4096, K=128, N=440, T=1024, timer=timeit):
    """Every line of the script on ``nmf``; returns {line: ms}."""
    dev = gen.device
    rows = {}
    # the envmap cache is a constant here, as in nmf_tpu's bench (built
    # outside its jitted functions)
    with torch.no_grad():
        bg_cache = nmf.bg_module.prepare()

    # --- transmittance: the kernel entry and the plain version ---
    sig = torch.rand((B, K), generator=gen, device=dev) * 5
    dst = torch.full((B, K), 0.01, device=dev)
    sig_g = sig.clone().requires_grad_(True)
    for name, fn in (("K1 transmittance_weights", transmittance_weights),
                     ("plain raw2alpha",
                      lambda s, d: raw2alpha(s, d)[0])):
        line(rows, f"{name} fwd", timer(fn, sig, dst))
        line(rows, f"{name} fwd+bwd",
             timer(lambda f=fn: grads(f(sig_g, dst), [sig_g])))

    # --- sampler internals ---
    valid = torch.rand((B, N), generator=gen, device=dev) < 0.25
    line(rows, "compact_topk", timer(compact_topk, valid, K))
    xyz = torch.rand((B, N, 4), generator=gen, device=dev)
    line(rows, "compact+gather",
         timer(lambda: gather_rows(xyz, compact_topk(valid, K)[0])))
    vol = (torch.rand((ALPHA_GRID,) * 3, generator=gen, device=dev)
           < 0.2).float()
    pts = torch.rand((B, N, 3), generator=gen, device=dev) * 2.8 - 1.4
    mask = AlphaGridMask(nmf.sampler.aabb, vol)
    line(rows, "alpha lookup", timer(mask.sample_alpha, pts))

    # --- the shading model with stubbed reflections ---
    M = B * K
    ins = shade_inputs(nmf, M, gen)
    params = [p for p in nmf.model.parameters() if p.requires_grad]
    feats = ins["feats"].clone().requires_grad_(True)
    line(rows, "shade-stub fwd", timer(lambda: shade_stub(
        nmf, ins, B, fresh_draws(dev), bg_cache)))
    line(rows, "shade-stub fwd+bwd", timer(lambda: grads(shade_stub(
        nmf, ins, B, fresh_draws(dev), bg_cache, feats), params + [feats])))

    # --- the secondary (retrace) render ---
    rays = secondary_rays(T, gen)
    all_params = [p for p in nmf.parameters() if p.requires_grad]
    line(rows, "secondary fwd", timer(lambda: secondary(
        nmf, rays, fresh_draws(dev), bg_cache)))
    line(rows, "secondary fwd+bwd", timer(lambda: grads(secondary(
        nmf, rays, fresh_draws(dev), bg_cache), all_params)))

    if nmf.normal_module is not None:
        line(rows, "normal_module fwd", timer(
            nmf.normal_module, ins["xyz"], ins["feats"], ins["norms"]))
    return rows


def main(argv=None):
    if not torch.cuda.is_available():
        sys.exit("bench_shade: needs a CUDA device")
    nmf, _ = bench_nmf(device="cuda", **BENCH_SIZES)
    return bench(nmf, torch.Generator(device="cuda").manual_seed(0))


if __name__ == "__main__":
    main()
