#!/usr/bin/env python
"""Bisect the per-bounce-ray cost inside ``Microfacet.shade``, on the card,
by patching the method with staged copies (measurement only).

    python -m nmf_tpu_torch.scripts.bisect_shade [0,1,...,7,-1,-2]

Port of ``nmf_tpu/scripts/bisect_shade.py``. Each stage drops one more
piece of the bounce block: 0 the whole of ``shade`` (equal to it), 1 the
envmap lookup (every ray lit by 1), 2 the BRDF MLP (a constant weight),
3 the GGX sample (the mirror direction), 4 the Hammersley points, 5 the
parent row gather (slot r reads sample r), 6 the ``searchsorted`` of the
slots' parents, 7 the whole bounce block (the diffuse term alone). -1
detaches the envmap's result (its backward killed), -2 its inputs (the
bounce rays' coordinate gradient killed, the envmap's kept). Each stage
times the gradient of ``trainer.compute_loss`` on 4096 rays of the
flagship of ``bench_shade.BENCH_SIZES`` without retrace
(``max_retrace_rays=()``), as nmf_tpu's bisect does; ``profile_step.
timeit``, CUDA events. Needs a CUDA device. On that freshly initialised
model no sample earns a bounce ray (see ``bench_shade``): each stage
times the budget's slots, whose segment sums drop every row.

The staged copy follows the port's current ``shade`` with its named draws,
for the options of the flagship's default run; any other option raises,
naming it (``unstaged_options``).
"""
import contextlib
import sys

import numpy as np
import torch

from ..models.microfacet import Microfacet
from ..modules.brdf_samplers import hammersley_draw
from ..ops import sh
from ..ops.masked import segment_sum_to, take_rows_binsum
from ..ops.safemath import normalize
from ..trainer import LossWeights, compute_loss
from .bench_shade import BENCH_SIZES, bench_nmf, fresh_draws
from .profile_step import timeit

STAGE_NAMES = {0: "full", 1: "-envmap", 2: "-brdfmlp", 3: "-ggx",
               4: "-hammersley", 5: "-parentgather", 6: "-searchsorted",
               7: "-bounceblock", -1: "sg(envmap out)", -2: "sg(envmap in)"}
B_RAYS = 4096


def unstaged_options(model, recur):
    """The options of ``model`` at recursion ``recur`` that the staged
    copy does not stage (the flagship's default run turns none of them
    on, and the bisect turns retrace off)."""
    out = []
    if model.bright_sampler is not None and model.percent_bright > 0:
        out.append("percent_bright")
    if model.visibility_module is not None:
        out.append("visibility_module")
    if model.russian_roulette:
        out.append("russian_roulette")
    if model.diffuse_mixing_mode != "fresnel":
        out.append(f"diffuse_mixing_mode={model.diffuse_mixing_mode}")
    if recur < len(model.max_retrace_rays):
        out.append("max_retrace_rays")
    return out


def _first_rows(x, n):
    """The first n rows of x, cycled where x has fewer (no gather)."""
    reps = -(-n // x.shape[0])
    return (x if reps == 1 else x.repeat(reps, 1))[:n]


def make_staged_shade(stage):
    """A ``Microfacet.shade`` without the pieces of ``stage``
    (STAGE_NAMES)."""
    if stage not in STAGE_NAMES:
        raise ValueError(f"stage {stage} is none of {sorted(STAGE_NAMES)}")

    def shade(self, xyz, xyz_normed, app_features, viewdirs, normals,
              weights, valid, B, render_reflection, bg_module, bg_cache,
              is_train, recur, draws):
        unstaged = unstaged_options(self, recur)
        if unstaged:
            raise NotImplementedError(
                f"bisect_shade stages no {', '.join(unstaged)}")
        M = xyz.shape[0]
        dev = xyz.device
        noise_app = app_features + draws.normal(
            "app_noise", app_features.shape, dev) * self.anoise
        std = self.std if is_train else 0.0
        albedo, tint, matprop = self.diffuse_module(
            xyz_normed, viewdirs, app_features, std=std, draws=draws)
        if self.no_emitters and bg_module is not None:
            conv = bg_cache["sh_conv_coeffs"] if (
                bg_cache is not None and "sh_conv_coeffs" in bg_cache) else \
                bg_module.get_spherical_harmonics(100, cache=bg_cache)[1]
            evaled = sh.eval_sh_bases(conv.shape[0], normals.detach())
            if not getattr(bg_module, "sh_grad", False):
                conv = conv.detach()
            E = (conv[None] * evaled[..., None]).sum(dim=1)
            diffuse = albedo * E
        else:
            diffuse = albedo
        if stage >= 7:  # no bounce block at all
            return diffuse, {"roughness": matprop["r1"], "tint": tint,
                             "diffuse": diffuse, "spec": diffuse,
                             "albedo": albedo}

        rays_per_ray = self.rays_per_ray if is_train else \
            self.test_rays_per_ray
        budget = self.brdf_ray_budget[min(recur,
                                          len(self.brdf_ray_budget) - 1)]
        w = torch.where(valid, weights, torch.zeros_like(weights))
        demand = (w * rays_per_ray).sum()
        alloc_scale = torch.clamp(
            0.98 * budget / torch.clamp(demand, min=1.0), max=1.0).detach()
        pt_limit = (w * rays_per_ray * alloc_scale
                    + draws.uniform("alloc", (M,), dev) - 0.5)
        counts = torch.clamp(torch.floor(pt_limit), 0, 400).to(torch.int64)
        counts = torch.where(valid, counts, torch.zeros_like(counts))
        starts = torch.cumsum(counts, dim=0) - counts
        r_idx = torch.arange(budget, device=dev)
        if stage >= 6:  # no searchsorted: slot r's parent is sample r mod M
            src = r_idx % M
        else:
            src = torch.clamp(torch.searchsorted(starts, r_idx, right=True)
                              - 1, 0, M - 1)
        total = torch.clamp(counts.sum(), max=budget)
        slot_valid = r_idx < total
        kept = torch.minimum(torch.clamp(
            torch.clamp(starts + counts, max=budget)
            - torch.clamp(starts, max=budget), min=0), counts)
        ray_count = torch.clamp(kept.to(torch.float32), min=1e-8)

        Cf = noise_app.shape[-1]
        parent = torch.cat([
            viewdirs, normals, matprop["r1"][:, :1], noise_app, xyz[:, :3],
            matprop["f0"].expand(M, 3), diffuse,
            counts[:, None].to(torch.float32),
            w[:, None], ray_count[:, None], starts[:, None].to(torch.float32),
        ], dim=-1)
        o = 7 + Cf
        if stage >= 5:
            # no parent row gather: slot r reads sample r's direction,
            # normal, roughness, features and position; the rest is read
            # by index, as nmf_tpu's staged copy does
            P = _first_rows(parent, budget)
            bR0 = matprop["f0"].expand(M, 3)[src]
            ediffuse = diffuse[src]
            bcounts = counts[src].to(torch.float32)
            brc = ray_count[src]
            bstarts = starts[src].to(torch.float32)
        else:
            P = take_rows_binsum(parent, src)
            bR0 = P[:, o + 3:o + 6]
            ediffuse = P[:, o + 6:o + 9]
            bcounts = P[:, o + 9]
            brc = P[:, o + 11]
            bstarts = P[:, o + 12]
        bV = -P[:, 0:3]
        bN = P[:, 3:6]
        if self.detach_N:
            bN = bN.detach()
        bN = bN * torch.sign((bV * bN).sum(-1, keepdim=True))
        r1 = P[:, 6]
        if is_train:
            r1 = torch.clamp(r1, min=self.min_rough)
        efeatures = P[:, 7:o]
        exyz = P[:, o:o + 3]
        within = (r_idx.to(torch.float32) - bstarts).to(torch.int32)

        if stage >= 4:
            u1 = u2 = torch.full((budget,), 0.5, device=dev)
        else:
            u1, u2 = hammersley_draw(draws, within, bcounts.to(torch.int32))
        if stage >= 3:  # the mirror direction in place of a GGX sample
            L = normalize(2 * (bV * bN).sum(-1, keepdim=True) * bN - bV)
            basis = torch.eye(3, device=dev).expand(budget, 3, 3)
            logD = torch.zeros(budget, device=dev)
        else:
            L, basis, logD = self.brdf_sampler.sample(u1, u2, bV, bN, r1, r1)
        H = normalize((bV + L) / 2)
        local_v = torch.einsum("rij,rj->ri", basis, bV)
        halfvec = torch.einsum("rij,rj->ri", basis, H)
        diffvec = torch.einsum("rij,rj->ri", basis, L)
        mipval = -torch.log(torch.clamp(bcounts, min=1)) - logD
        bounce_rays = torch.cat([exyz + L * 5e-3, L], dim=-1)

        sg = torch.Tensor.detach
        if stage >= 2:
            brdf_weight = (torch.ones((budget, 3), device=dev)
                           * torch.sigmoid(self.brdf.bias))
        else:
            brdf_weight = self.brdf(bV, sg(L), sg(bN), sg(H), sg(local_v),
                                    sg(halfvec), sg(diffvec), efeatures,
                                    sg(r1), sg(r1))
        rdraws = draws.scoped("retrace")
        if stage >= 1:
            incoming_light = torch.ones((budget, 3), device=dev)
        elif stage == -1:  # the envmap's result detached: its backward off
            incoming_light = render_reflection(bounce_rays, mipval, False,
                                               rdraws)[0].detach()
        elif stage == -2:  # its inputs detached: the envmap's grad kept
            incoming_light = render_reflection(sg(bounce_rays), sg(mipval),
                                               False, rdraws)[0]
        else:
            incoming_light, _ = render_reflection(bounce_rays, mipval, False,
                                                  rdraws)
        debug = {"__counts": counts, "__src": src}
        erc = brc[:, None]

        def packed_segment_sum(parts):
            out = segment_sum_to(torch.cat(parts, dim=-1) / erc, src,
                                 slot_valid, M)
            return torch.split(out, [p.shape[-1] for p in parts], dim=-1)

        costheta = (-bV * H).sum(-1, keepdim=True).abs()
        spec_reflectance = bR0 + (1 - bR0) * torch.clamp(
            1 - costheta, 0, 1) ** 5
        lit = incoming_light * brdf_weight
        comb = spec_reflectance * lit + (1 - spec_reflectance) * ediffuse
        spec, brdf_rgb, rgb = packed_segment_sum(
            [incoming_light, brdf_weight, comb])
        R0s = matprop["f0"]
        cth = (-viewdirs * normals).sum(-1, keepdim=True).abs()
        sr = R0s + (1 - R0s) * torch.clamp(1 - cth, 0, 1) ** 5
        # a contributing sample left with no ray keeps its diffuse lobe
        starved = ((w > 0) & (kept == 0))[:, None]
        rgb = torch.where(starved, (1 - sr) * diffuse, rgb)
        debug.update({"diffuse": (1 - sr) * diffuse, "tint": sr * brdf_rgb,
                      "roughness": matprop["r1"], "spec": spec,
                      "albedo": albedo, "__thin_scale": alloc_scale})
        return rgb, debug

    return shade


@contextlib.contextmanager
def staged(stage):
    """``Microfacet.shade`` patched with stage ``stage`` inside the block,
    restored after it (also when the block raises)."""
    orig = Microfacet.shade
    Microfacet.shade = make_staged_shade(stage)
    try:
        yield
    finally:
        Microfacet.shade = orig


def bisect_rays(B, device):
    """B rays from (0, 0, -4) looking up +z, and random target colours
    (nmf_tpu's bisect's, from a numpy seed)."""
    rng = np.random.default_rng(0)
    origins = np.tile(np.array([[0.0, 0.0, -4.0]], np.float32), (B, 1))
    dirs = rng.normal(size=(B, 3)).astype(np.float32)
    dirs[:, 2] = np.abs(dirs[:, 2]) + 1.0
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rays = torch.from_numpy(np.concatenate([origins, dirs], -1))
    rgbs = torch.from_numpy(rng.uniform(size=(B, 3)).astype(np.float32))
    return rays.to(device), rgbs.to(device)


def loss_grads(nmf, rays, rgbs, seed=0):
    """(loss, gradients of every parameter) of one train step's loss, on
    the draws of a generator seeded with ``seed``."""
    params = [p for p in nmf.parameters() if p.requires_grad]
    loss, _ = compute_loss(nmf, rays, rgbs, LossWeights(), (1.0, 1.0, 1.0),
                           draws=fresh_draws(rays.device, seed))
    return loss.detach(), torch.autograd.grad(loss, params,
                                              allow_unused=True)


def bisect(nmf, rays, rgbs, stages=tuple(range(8)), timer=timeit, n=6):
    """Each stage's loss-gradient time; returns {stage: ms}."""
    out = {}
    for stage in stages:
        with staged(stage):
            out[stage] = timer(loss_grads, nmf, rays, rgbs, n=n)
        print(f"stage {stage} ({STAGE_NAMES[stage]:15s}): "
              f"{out[stage]:8.2f} ms")
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    stages = ([int(s) for s in argv[0].split(",")] if argv
              else tuple(range(8)))
    if not torch.cuda.is_available():
        sys.exit("bisect_shade: needs a CUDA device")
    nmf, _ = bench_nmf(device="cuda", **BENCH_SIZES)
    nmf.model.max_retrace_rays = ()
    return bisect(nmf, *bisect_rays(B_RAYS, "cuda"), stages)


if __name__ == "__main__":
    main()
