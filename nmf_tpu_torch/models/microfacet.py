"""Neural Microfacet shading (``nmf_tpu/models/microfacet.py``).

Per sample: the material head, SH-convolved diffuse irradiance, and a flat
buffer of bounce rays under one budget a recursion level. Allocation is
proportional: when the batch asks for more rays than the budget, every
sample's share is thinned by one factor. Each bounce ray reads its parent
sample through one packed row gather, draws a GGX direction from a
Hammersley point, weighs it with the learned BRDF and takes its light from
the envmap; the top-T contributors are retraced through the field by the
renderer. One packed segment sum brings the bounce rays back onto their
samples (fresnel mixing). The row gather's backward and the segment sum go
through the ``binsum_rows`` kernel.

Options (each off in the shipped configs):
- ``brdf_sampler``: GGX, or SGGX, Beckmann, the cosine lobe or their mix
  (``modules/brdf_samplers.py``);
- ``detach_N_iters`` > 0: the bounce rays' normals carry no gradient until
  that iteration, where the schedule lets them (an optimizer rebuild);
- ``bright_sampler`` with ``percent_bright`` > 0: the last share of each
  sample's rays of the primary pass point at bright envmap texels, weighed
  by the GGX-to-bright pdf ratio, their footprint read from the bright pdf;
- ``visibility_module``: damps the retrace priority of rays it predicts
  blocked, and is fit to the retraced rays' background visibility (the
  ``__visibility_loss`` it reports);
- ``russian_roulette``: a sample that owns retraced rays is represented by
  them alone (the retrace count per sample is a ``binsum_rows`` segment
  sum of one column);
- ``diffuse_mixing_mode``: ``fresnel`` (the default), ``fresnel_ind`` (the
  fresnel mix without the BRDF weight), ``no_diffuse`` or ``lambda`` (the
  tint's mean blends the specular and diffuse terms);
- the envmap's ``sh_grad``: the diffuse irradiance's gradient reaches the
  envmap through its SH projection (the normals stay detached).

A material head whose f0 is one column (``MLPDiffuse``) has it broadcast
to three before the packed row gather. nmf_tpu packs the one column and
reads the row two columns off, so its per-ray count reads the sample's
first slot, 0 for the first sample with rays; its division by that count
gives an infinite tint map and non-finite gradients, and a train step's
loss turns NaN through its zero-weighted ``brdf_reg`` (ROADMAP C.12).
"""
import torch
import torch.nn as nn

from ..modules.brdf_samplers import hammersley_draw
from ..ops import sh
from ..ops.masked import segment_sum_to, take_rows_binsum
from ..ops.safemath import EPS, normalize


MIXING_MODES = ("fresnel", "fresnel_ind", "no_diffuse", "lambda")


def stable_top_k(x, k: int):
    """Indices of the k largest entries of x (R,), ties to the lowest
    index, as ``lax.top_k`` breaks them."""
    return torch.sort(x, descending=True, stable=True)[1][:k]


class Microfacet(nn.Module):
    def __init__(self, diffuse_module, brdf, brdf_sampler,
                 min_rough_start=0.0, start_std=0.0, anoise=0.25,
                 rays_per_ray=128, test_rays_per_ray=128,
                 brdf_ray_budget=(65536, 16384), max_retrace_rays=(1024,),
                 conserve_energy=True, no_emitters=True,
                 diffuse_mixing_mode="fresnel", min_rough_decay=0.999,
                 std_decay=1.0, std_decay_interval=10, detach_N_iters=0,
                 percent_bright=0.0, russian_roulette=False,
                 visibility_module=None, bright_sampler=None):
        super().__init__()
        self.diffuse_module = diffuse_module
        self.brdf = brdf
        self.brdf_sampler = brdf_sampler
        self.visibility_module = visibility_module
        self.bright_sampler = bright_sampler
        # schedule scalars (optimizer group "frozen")
        self.min_rough = nn.Parameter(torch.tensor(float(min_rough_start)))
        self.std = nn.Parameter(torch.tensor(float(start_std)))
        self.anoise = float(anoise)
        self.rays_per_ray = int(rays_per_ray)
        self.test_rays_per_ray = int(test_rays_per_ray)
        self.brdf_ray_budget = tuple(int(b) for b in brdf_ray_budget)
        self.max_retrace_rays = tuple(int(t) for t in max_retrace_rays)
        self.conserve_energy = bool(conserve_energy)
        self.no_emitters = bool(no_emitters)
        if diffuse_mixing_mode not in MIXING_MODES:
            raise ValueError(f"diffuse_mixing_mode={diffuse_mixing_mode!r} "
                             f"is none of {MIXING_MODES}")
        self.diffuse_mixing_mode = diffuse_mixing_mode
        self.detach_N_iters = int(detach_N_iters)
        # the normals start detached only if the schedule will free them
        self.detach_N = self.detach_N_iters > 0
        self.percent_bright = float(percent_bright)
        self.russian_roulette = bool(russian_roulette)
        self.min_rough_decay = float(min_rough_decay)
        self.std_decay = float(std_decay)
        self.std_decay_interval = int(std_decay_interval)

    def needs_normals(self, recur: int) -> bool:
        return True

    @torch.no_grad()
    def check_schedule(self, iteration: int) -> bool:
        if iteration % 10 == 0:
            self.min_rough.mul_(self.min_rough_decay)
        if iteration % self.std_decay_interval == 0:
            self.std.mul_(self.std_decay)
        if self.detach_N and iteration > self.detach_N_iters:
            self.detach_N = False
            return True
        return False

    @torch.no_grad()
    def calibrate(self, draws, xyz, feat, bg_brightness):
        """Bias calibration against the background brightness: the
        material head over ``viewdirs`` (N, 3) uniform draws, the BRDF over
        the draws of scope ``brdf``."""
        viewdirs = normalize(draws.uniform("viewdirs", (xyz.shape[0], 3),
                                           xyz.device))
        self.diffuse_module.calibrate(bg_brightness, self.conserve_energy,
                                      xyz, viewdirs, feat)
        self.brdf.init_val = 0.5 if self.conserve_energy else 0.25
        self.brdf.calibrate(draws.scoped("brdf"), feat, bg_brightness)

    def shade(self, xyz, xyz_normed, app_features, viewdirs, normals,
              weights, valid, B, render_reflection, bg_module, bg_cache,
              is_train, recur, draws):
        """Flattened samples, M = B * K. Returns (rgb (M, 3), debug).

        Draws: ``app_noise`` (M, app_dim) normal, the material head's
        ``diffuse_noise`` / ``roughness_noise``, ``alloc`` (M,) uniform
        rounding offsets, the Hammersley ``offset1`` / ``offset2`` (R,),
        ``tiebreak`` (R,), the retrace pass's draws in scope ``retrace``
        and, with the bright sampler, its ``bright/u``, ``bright/jy`` and
        ``bright/jx`` (R,). ``debug`` carries the per-sample maps, the
        thinning factor ``__thin_scale``, the discrete decisions
        ``__counts`` (M,), ``__src`` (R,) and, with a retrace,
        ``__top_idx`` (T,), with a visibility module its
        ``__visibility_loss`` and with bright rays their share of the valid
        slots ``__bright_share``.
        """
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
            # with sh_grad the envmap's SH projection takes the diffuse
            # term's gradient; the normals stay detached either way
            E = (conv[None] * evaled[..., None]).sum(dim=1)
            diffuse = albedo * E
        else:
            diffuse = albedo

        rays_per_ray = self.rays_per_ray if is_train else \
            self.test_rays_per_ray
        budget = self.brdf_ray_budget[min(recur,
                                          len(self.brdf_ray_budget) - 1)]

        # proportional allocation under the budget, stochastic rounding
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
        src = torch.clamp(torch.searchsorted(starts, r_idx, right=True) - 1,
                          0, M - 1)
        total = torch.clamp(counts.sum(), max=budget)
        slot_valid = r_idx < total
        kept = torch.minimum(torch.clamp(
            torch.clamp(starts + counts, max=budget)
            - torch.clamp(starts, max=budget), min=0), counts)
        ray_count = torch.clamp(kept.to(torch.float32), min=1e-8)

        # every attribute a bounce ray reads of its parent: one row gather
        Cf = noise_app.shape[-1]
        parent = torch.cat([
            viewdirs, normals, matprop["r1"][:, :1], noise_app, xyz[:, :3],
            matprop["f0"].expand(M, 3), diffuse,
            counts[:, None].to(torch.float32),
            w[:, None], ray_count[:, None], starts[:, None].to(torch.float32),
        ], dim=-1)
        P = take_rows_binsum(parent, src)
        o = 7 + Cf
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
        bR0 = P[:, o + 3:o + 6]
        ediffuse = P[:, o + 6:o + 9]
        bcounts = P[:, o + 9]
        bw = P[:, o + 10]
        brc = P[:, o + 11]
        within = (r_idx.to(torch.float32) - P[:, o + 12]).to(torch.int32)

        u1, u2 = hammersley_draw(draws, within, bcounts.to(torch.int32))
        L, basis, logD = self.brdf_sampler.sample(u1, u2, bV, bN, r1, r1)
        # the last percent_bright of each sample's rays toward bright texels
        use_bright = (self.bright_sampler is not None
                      and self.percent_bright > 0 and bg_module is not None
                      and recur == 0)
        if use_bright:
            bdirs, bpdf = self.bright_sampler.sample(
                draws.scoped("bright"), bg_module, L.shape[0],
                cache=bg_cache)
            main = torch.ceil(bcounts * (1.0 - self.percent_bright))
            bright_mask = ((within >= main.to(torch.int32))
                           & ((bdirs * bN).sum(-1) > 0) & slot_valid)
            L = torch.where(bright_mask[:, None], bdirs, L)
        H = normalize((bV + L) / 2)
        local_v = torch.einsum("rij,rj->ri", basis, bV)
        halfvec = torch.einsum("rij,rj->ri", basis, H)
        diffvec = torch.einsum("rij,rj->ri", basis, L)
        bright_w = None
        if use_bright:
            # a bright ray's estimate takes pdf_lobe / pdf_bright, and its
            # footprint the bright pdf
            lobe_p = self.brdf_sampler.compute_prob(diffvec, local_v,
                                                    halfvec, r1, r1)
            ratio = torch.clamp(lobe_p / torch.clamp(bpdf, min=EPS), 0.0,
                                1e3)
            bright_w = torch.where(bright_mask, ratio,
                                   torch.ones_like(ratio))[:, None].detach()
            # telemetry: the share of the valid slots drawn toward the envmap
            bright_share = (bright_mask.sum()
                            / torch.clamp(slot_valid.sum(), min=1)).detach()
            logD = torch.where(bright_mask,
                               torch.log(torch.clamp(bpdf, min=EPS)), logD)
        samp_prob = torch.exp(logD)
        mipval = -torch.log(torch.clamp(bcounts, min=1)) - logD
        bounce_rays = torch.cat([exyz + L * 5e-3, L], dim=-1)

        sg = torch.Tensor.detach
        brdf_weight = self.brdf(bV, sg(L), sg(bN), sg(H), sg(local_v),
                                sg(halfvec), sg(diffvec), efeatures, sg(r1),
                                sg(r1))
        if bright_w is not None:
            brdf_weight = brdf_weight * bright_w

        # incoming light: the envmap for every ray, the field for the top T
        incoming_light, _ = render_reflection(bounce_rays, mipval, False,
                                              draws.scoped("retrace"))
        debug = {"__counts": counts, "__src": src}
        if use_bright:
            debug["__bright_share"] = bright_share
        erc = brc[:, None]
        vis = self.visibility_module
        if recur < len(self.max_retrace_rays) and bg_module is not None:
            T = self.max_retrace_rays[recur]
            per_sample_factor = bw / brc
            per_ray_factor = (brdf_weight.amax(dim=-1)
                              * ((bV * bN).sum(-1) > 0) * samp_prob)
            contribution = (per_ray_factor * per_sample_factor).detach()
            if vis is not None:
                # damp the priority of rays predicted blocked
                contribution = contribution * (
                    1.0 - vis(sg(exyz), sg(L), sg(efeatures))[1]).detach()
            contribution = torch.where(slot_valid, contribution,
                                       torch.full_like(contribution, -1.0))
            contribution = (contribution
                            / torch.clamp(contribution.sum(), min=EPS) * T)
            contribution = contribution + draws.uniform(
                "tiebreak", contribution.shape, dev)
            contribution = torch.where(slot_valid, contribution,
                                       torch.full_like(contribution, -1e9))
            top_idx = stable_top_k(contribution, T)
            retraced, bg_vis = render_reflection(
                take_rows_binsum(bounce_rays, top_idx), mipval[top_idx],
                True, draws.scoped("retrace"))
            incoming_light = incoming_light.index_copy(0, top_idx, retraced)
            debug["__top_idx"] = top_idx
            tvalid = slot_valid[top_idx]
            if vis is not None:
                # fit sigvis to 1 - the observed background visibility;
                # only the visibility MLP takes this gradient
                sv = vis(exyz[top_idx].detach(), L[top_idx].detach(),
                         efeatures[top_idx].detach())[1]
                err = (sv - (1.0 - bg_vis.detach())) ** 2
                debug["__visibility_loss"] = (
                    torch.where(tvalid, err, torch.zeros_like(err)).sum()
                    / torch.clamp(tvalid.sum(), min=1))
            if self.russian_roulette:
                # a sample that owns retraced rays keeps only them: its
                # envmap-only rays drop out, its ray count becomes theirs
                num_retrace = segment_sum_to(
                    tvalid[:, None].to(torch.float32), src[top_idx], tvalid,
                    M)[:, 0]
                rtmask = num_retrace > 0
                ray_count = torch.where(rtmask, num_retrace, ray_count)
                retraced_slot = torch.zeros(budget, dtype=torch.bool,
                                            device=dev)
                retraced_slot[top_idx] = tvalid
                slot_valid = slot_valid & (retraced_slot | ~rtmask[src])
                erc = ray_count[src][:, None]

        def packed_segment_sum(parts):
            out = segment_sum_to(torch.cat(parts, dim=-1) / erc, src,
                                 slot_valid, M)
            return torch.split(out, [p.shape[-1] for p in parts], dim=-1)

        mode = self.diffuse_mixing_mode
        if mode in ("fresnel", "fresnel_ind"):
            costheta = (-bV * H).sum(-1, keepdim=True).abs()
            spec_reflectance = bR0 + (1 - bR0) * torch.clamp(
                1 - costheta, 0, 1) ** 5
            lit = incoming_light * brdf_weight if mode == "fresnel" \
                else incoming_light
            comb = spec_reflectance * lit + (1 - spec_reflectance) * ediffuse
            spec, brdf_rgb, rgb = packed_segment_sum(
                [incoming_light, brdf_weight, comb])
            R0s = matprop["f0"]
            cth = (-viewdirs * normals).sum(-1, keepdim=True).abs()
            sr = R0s + (1 - R0s) * torch.clamp(1 - cth, 0, 1) ** 5
            # a contributing sample left with no ray keeps its diffuse lobe
            starved = ((w > 0) & (kept == 0))[:, None]
            rgb = torch.where(starved, (1 - sr) * diffuse, rgb)
            debug["diffuse"] = (1 - sr) * diffuse
            debug["tint"] = sr * brdf_rgb if mode == "fresnel" else sr
        else:
            spec, brdf_rgb, tinted = packed_segment_sum(
                [incoming_light, brdf_weight, incoming_light * brdf_weight])
            if mode == "no_diffuse":
                rgb = tinted
                debug["diffuse"] = diffuse
                debug["tint"] = brdf_rgb
            else:  # lambda: the tint's mean blends the two terms
                lam = tint.mean(dim=-1, keepdim=True)
                rgb = lam * tinted + (1 - lam) * diffuse
                rgb = torch.where(counts[:, None] > 0, rgb,
                                  torch.zeros_like(rgb))
                debug["diffuse"] = diffuse * (1 - lam)
                debug["tint"] = brdf_rgb * lam
        debug.update({"roughness": matprop["r1"], "spec": spec,
                      "albedo": albedo, "__thin_scale": alloc_scale})
        return rgb, debug


def init_microfacet(app_dim, diffuse_module, brdf, brdf_sampler,
                    min_rough_start=0.0, start_std=0.0, **kwargs):
    conserve = kwargs.get("conserve_energy", True)
    brdf.init_val = 0.5 if conserve else 0.25
    keys = ("anoise", "rays_per_ray", "test_rays_per_ray", "brdf_ray_budget",
            "max_retrace_rays", "conserve_energy", "no_emitters",
            "diffuse_mixing_mode", "min_rough_decay", "std_decay",
            "std_decay_interval", "detach_N_iters", "percent_bright",
            "russian_roulette", "visibility_module", "bright_sampler")
    return Microfacet(diffuse_module, brdf, brdf_sampler,
                      min_rough_start=min_rough_start, start_std=start_std,
                      **{k: v for k, v in kwargs.items() if k in keys})
