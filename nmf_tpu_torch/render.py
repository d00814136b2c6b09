"""Volume renderer: the composition root ``NMF`` and ``render``
(``nmf_tpu/render.py``).

Samples stay in a padded (B, K) layout with a validity mask. The
transmittance weights go through the composite CUDA kernel
(``ops/kernels/composite.transmittance_weights``) on the card: for the
proposal pass (forward only), the primary pass and every retrace pass.

A pass optionally runs a no-gradient proposal density over the full march
and resamples a smaller weight-proportional fine set; the field query gives
normals when the shading model needs them; the shading model may call back
into ``render`` one recursion level deeper for its retraced bounce rays,
whose sample positions keep their gradient to the bounce directions. The
background is a constant colour or, for a retrace pass, the envmap.

With a normal module, the shading sees ``normalize(lam * predicted + (1 -
lam) * geometric)`` normals (``lam``: ``predicted_normal_lambda``, 1 from
the build with ``use_predicted_normals``; with ``geonorm_iters`` > 0 each
tick sets it to ``clip((it - geonorm_iters) / geonorm_interp_iters, 0,
1)``) and, with ``align_pred_norms``, the primary pass reports the
predicted normals' misalignment as ``prediction_loss``; under the geonorm
schedule ``ori_loss`` also counts the predicted normals facing away. With
``ndc_ray`` the primary pass marches NDC rays (``sampler.sample_ndc``);
retrace passes march world rays. With ``detach_inter`` a retrace pass's
weights carry no gradient. Given per-ray ground-truth normals, the primary
pass reports ``normal_err``: the weighted misalignment of the geometric
and the predicted normals (zeros without a normal module) with them, over
the rays whose normal's components sum past 0.9.

Not ported yet: ``merge_runs`` and two-stage shading
(``app_samples_per_ray``); a configuration asking for them raises
``NotImplementedError`` when built.
"""
import torch
import torch.nn as nn

from .ops.draws import Draws
from .ops.kernels.composite import transmittance_weights
from .ops.losses import distortion_loss
from .ops.masked import row_mask_sum
from .ops.resample import resample_pdf
from .ops.safemath import normalize
from .ops.tonemap import srgb_tonemap


class NMF(nn.Module):
    """Field + sampler + shading model (+ envmap)."""

    def __init__(self, rf, sampler, model, bg_module=None,
                 normal_module=None, max_samples_per_ray=-1,
                 recur_samples_per_ray=-1, proposal_samples_per_ray=-1,
                 proposal_pad=0.01, recur_stepmul=1.0, eval_batch_size=4096,
                 lr_scale=1.0, use_predicted_normals=False,
                 align_pred_norms=True, geonorm_iters=-1,
                 geonorm_interp_iters=1000, detach_inter=False):
        super().__init__()
        self.rf = rf
        self.sampler = sampler
        self.model = model
        self.bg_module = bg_module
        self.normal_module = normal_module
        # the predicted/geometric normal blend
        use_pred = bool(use_predicted_normals) and normal_module is not None
        self.register_buffer("predicted_normal_lambda",
                             torch.tensor(1.0 if use_pred else 0.0))
        self.align_pred_norms = bool(align_pred_norms)
        self.geonorm_iters = int(geonorm_iters or -1)
        self.geonorm_interp_iters = int(geonorm_interp_iters)
        self.max_samples_per_ray = int(max_samples_per_ray)
        self.recur_samples_per_ray = int(recur_samples_per_ray)
        self.proposal_samples_per_ray = int(proposal_samples_per_ray)
        self.proposal_pad = float(proposal_pad)
        self.recur_stepmul = float(recur_stepmul)
        self.eval_batch_size = int(eval_batch_size)
        self.lr_scale = float(lr_scale)
        self.detach_inter = bool(detach_inter)

    def check_schedule(self, iteration: int) -> bool:
        """Host-side schedule tick, in place. Returns whether the optimizer
        must be rebuilt. The sampler's mask rebuild or density sweep sees
        the field before this tick's upsample, as in nmf_tpu; at one of
        the sampler's ``shrink_iters`` the field is then cropped to the
        sampler's occupied box (a rebuild even when the box stays). The
        geonorm schedule sets the normal blend."""
        m_changed = self.model.check_schedule(iteration)
        s_changed = self.sampler.check_schedule(iteration, self.rf)
        r_changed = self.rf.check_schedule(iteration)
        if (iteration in getattr(self.sampler, "shrink_iters", ())
                and hasattr(self.rf, "shrink")):
            self.rf.shrink(self.sampler.get_bounds())
            r_changed = True
        changed = m_changed or s_changed or r_changed
        if changed:
            self.sampler.update(self.rf, init=True)
        if self.geonorm_iters > 0:
            lam = min(max((iteration - self.geonorm_iters)
                          / self.geonorm_interp_iters, 0.0), 1.0)
            with torch.no_grad():
                self.predicted_normal_lambda.fill_(lam)
        return changed


def render_just_bg(nmf: NMF, viewdirs, mipval, bg_cache=None):
    return nmf.bg_module(viewdirs, mipval, cache=bg_cache).reshape(-1, 3)


def reflection_fn(nmf: NMF, is_train, recur, bg_cache, thin_out):
    """The shading model's light source for its bounce rays (T, 6) with
    their mip levels (T,): with ``retrace``, a ``render`` one level deeper
    (envmap background, no tonemap) -> (rgb, 1 - acc); else the envmap ->
    (rgb, None). A retrace pass's thinning factor goes to ``thin_out``."""

    def render_reflection(bounce_rays, mipval, retrace, draws):
        if not retrace:
            return render_just_bg(nmf, bounce_rays[:, 3:6], mipval,
                                  bg_cache), None
        ims, stats = render(
            nmf, bounce_rays, is_train=is_train, bg_col=None, draws=draws,
            recur=recur + 1, override_near=3 * nmf.sampler.live_stepsize,
            stepmul=nmf.recur_stepmul, tonemap=False, start_mipval=mipval,
            bg_cache=bg_cache)
        if "thin_scale" in stats:
            thin_out.append(stats["thin_scale"])
        return ims["rgb_map"], 1 - ims["acc_map"]

    return render_reflection


def debug_maps(weight, valid, acc_map, z_vals, xyz_normed, world_normal,
               pred_normal, rgb, debug, bg):
    """The eval maps of nmf_tpu's ``render(draw_debug=True)``: depth, the
    composited world normal (``world_normal``) and predicted normal
    (``normal``; each zeros where the pass has none), both over a
    background of ones, the valid sample count, the z < 0 cross-section
    and the shading model's per-sample maps (tint, spec, diffuse,
    roughness, albedo) composited over ``bg``."""
    B, K = weight.shape
    eweight = weight[..., None]
    pw = torch.where(valid, weight, torch.zeros_like(weight))[..., None]
    bg1 = (1 - acc_map[..., None])

    def composite(normals):
        if normals is None:
            return torch.zeros_like(acc_map)[:, None].expand(B, 3)
        return row_mask_sum(normals.reshape(B, K, 3) * pw, valid)

    wn, pn = composite(world_normal), composite(pred_normal)
    cs_mask = (xyz_normed.reshape(B, K, -1)[..., 2] < 0) & valid
    maps = {
        "depth": (weight * z_vals).sum(dim=1),
        "world_normal": acc_map[..., None] * wn + bg1,
        "normal": acc_map[..., None] * pn + bg1,
        "surf_width": valid.sum(dim=1),
        "cross_section": row_mask_sum(
            cs_mask[..., None] * eweight
            * torch.clamp(rgb.reshape(B, K, 3), 0, 1), valid)}
    for k, v in debug.items():
        if not k.startswith("__"):
            im = row_mask_sum(v.reshape(B, K, -1) * eweight, valid)
            maps[k] = im + bg1 * bg
    return maps


def render(nmf: NMF, rays, is_train=False, bg_col=(1.0, 1.0, 1.0),
           draws=None, recur=0, override_near=None, stepmul=1.0,
           tonemap=True, start_mipval=None, draw_debug=False, bg_cache=None,
           ndc_ray=False, gt_normals=None):
    """Render a ray batch (B, 6) -> (images, stats).

    images: rgb_map (B, 3), acc_map (B,) and, with ``draw_debug``, the
    maps of ``debug_maps``. stats (recursion level 0): ori_loss,
    prediction_loss, distortion_loss, envmap_reg, brdf_reg, diffuse_reg,
    normal_err (given ``gt_normals`` (B, 3)), n_valid_samples, for
    microfacet shading thin_scale (and thin_scale_retrace), with a
    visibility module visibility_loss and with bright rays bright_share. ``bg_col`` None takes the
    background from the envmap. ``ndc_ray``: the rays are NDC rays (this pass only; the
    shading model's retrace passes march world rays).

    Random draws (the march jitter, the resampling offsets, the shading
    model's) come from ``draws`` (``ops/draws.py``); a pass without any
    needs none.
    """
    draws = Draws() if draws is None else draws
    B = rays.shape[0]
    dev = rays.device
    K = nmf.max_samples_per_ray if recur == 0 else nmf.recur_samples_per_ray
    march = None
    if is_train:
        march = draws.uniform("jitter", (B, nmf.sampler.n_steps(stepmul)),
                              dev)
    if ndc_ray:
        samp = nmf.sampler.sample_ndc(rays, is_train=is_train, jitter=march,
                                      max_samples_per_ray=K)
    else:
        samp = nmf.sampler.sample(rays, is_train=is_train, jitter=march,
                                  max_samples_per_ray=K,
                                  override_near=override_near,
                                  stepmul=stepmul)
    xyz, z_vals, dists = samp["xyz"], samp["z_vals"], samp["dists"]
    valid = samp["valid"]
    if recur == 0:
        # primary sample positions depend on the rays only
        xyz, z_vals, dists = xyz.detach(), z_vals.detach(), dists.detach()
    K = xyz.shape[1]
    rf = nmf.rf

    kf = nmf.proposal_samples_per_ray if recur == 0 else -1
    if 0 < kf < K:
        # proposal: density without gradient over the whole march, then a
        # weight-proportional fine set of kf samples
        with torch.no_grad():
            sigma_p = rf.compute_densityfeature(
                xyz.reshape(-1, 4), use_gather_dtype=True).reshape(B, K)
            sigma_p = torch.where(valid, sigma_p, torch.zeros_like(sigma_p))
            w_p = transmittance_weights(sigma_p, dists * rf.distance_scale)
            z_vals, dists, valid = resample_pdf(
                draws, z_vals, dists, w_p, valid, kf, is_train,
                nmf.proposal_pad)
            pts = rays[:, None, 0:3] + rays[:, None, 3:6] * z_vals[..., None]
            xyz = torch.cat([pts, z_vals[..., None]], dim=-1)
        K = kf

    sigma, app_features, world_normal = rf.compute_all(
        xyz.reshape(-1, 4), with_normals=nmf.model.needs_normals(recur))
    sigma = torch.where(valid, sigma.reshape(B, K), sigma.new_zeros(()))
    weight = transmittance_weights(sigma, dists * rf.distance_scale)
    if recur > 0 and nmf.detach_inter:
        weight = weight.detach()
    acc_map = weight.sum(dim=1)

    xyz_flat = xyz.reshape(-1, 4)
    valid_flat = valid.reshape(-1)
    xyz_normed = rf.normalize_coord(xyz_flat)
    viewdirs = rays[:, None, 3:6].expand(B, K, 3).reshape(-1, 3)
    pred_normal, shade_normal = None, world_normal
    if world_normal is not None and nmf.normal_module is not None:
        pred_normal = nmf.normal_module(xyz_normed, app_features,
                                        world_normal)
        lam = nmf.predicted_normal_lambda
        shade_normal = normalize(lam * pred_normal
                                 + (1 - lam) * world_normal)

    retrace_thin = []
    rgb, debug = nmf.model.shade(
        xyz_flat, xyz_normed, app_features, viewdirs, shade_normal,
        weight.reshape(-1), valid_flat, B,
        render_reflection=reflection_fn(nmf, is_train, recur, bg_cache,
                                        retrace_thin),
        bg_module=nmf.bg_module, bg_cache=bg_cache, is_train=is_train,
        recur=recur, draws=draws.scoped("shade"))
    rgb_map = row_mask_sum(weight[..., None] * rgb.reshape(B, K, 3), valid)

    stats = {}
    for k in ("visibility_loss", "bright_share"):
        if f"__{k}" in debug:
            stats[k] = debug[f"__{k}"]
    if "__thin_scale" in debug:
        stats["thin_scale"] = debug["__thin_scale"]
        if retrace_thin:
            stats["thin_scale_retrace"] = retrace_thin[0]

    if nmf.bg_module is not None and bg_col is None:
        bg_mip = (torch.full((B,), -100.0, device=dev) if start_mipval is None
                  else start_mipval.reshape(-1))
        bg = render_just_bg(nmf, rays[:, 3:6], bg_mip, bg_cache)
        if tonemap:
            bg = srgb_tonemap(bg, noclip=True)
    else:
        bg = torch.as_tensor((0.0, 0.0, 0.0) if bg_col is None else bg_col,
                             dtype=torch.float32, device=dev).reshape(1, 3)

    if recur == 0:
        flat_w = weight.reshape(-1)
        aweight = torch.where(valid_flat, flat_w, torch.zeros_like(flat_w))
        zero = weight.new_zeros(())
        ori = zero
        if world_normal is not None:
            vdet = viewdirs.detach()
            facing = torch.clamp((-vdet * world_normal).sum(-1), max=0) ** 2
            if nmf.geonorm_iters > 0 and pred_normal is not None:
                facing = torch.clamp((-vdet * pred_normal).sum(-1),
                                     max=0) ** 2 + facing
            ori = (aweight * facing).sum()
        normal_err = zero
        if gt_normals is not None:
            gt = gt_normals[:, None, :].expand(B, K, 3).reshape(-1, 3)
            mask = (gt.sum(-1) > 0.9) & valid_flat

            def misalign(n):  # a pass's missing normals are zeros
                return 2 if n is None else 2 * (1 - (n * gt).sum(-1))

            err = misalign(pred_normal) + misalign(world_normal)
            normal_err = (torch.where(mask, aweight,
                                      torch.zeros_like(aweight)) * err).sum()
        pred = zero
        if pred_normal is not None and nmf.align_pred_norms:
            pred = (aweight * 2 * (1 - (pred_normal * world_normal).sum(-1))
                    ).sum()
        stats.update({
            "ori_loss": ori,
            "prediction_loss": pred,
            "envmap_reg": (torch.clamp(
                nmf.bg_module.mean_color().mean() - 0.05, min=0)
                if nmf.bg_module is not None else zero),
            "brdf_reg": (torch.clamp(debug["tint"].mean(), min=0)
                         if "tint" in debug else zero),
            "diffuse_reg": ((aweight.detach()[:, None]
                             * debug["diffuse"]).sum() / 3
                            if "diffuse" in debug else zero),
            "distortion_loss": distortion_loss(z_vals, weight, dists),
            "normal_err": normal_err,
            "n_valid_samples": valid.sum(),
        })
    images = {}
    if draw_debug:
        images.update(debug_maps(weight, valid, acc_map, z_vals, xyz_normed,
                                 world_normal, pred_normal, rgb, debug, bg))
    if tonemap:
        rgb_map = srgb_tonemap(rgb_map)
    images["rgb_map"] = rgb_map + (1 - acc_map[..., None]) * bg
    images["acc_map"] = acc_map
    return images, stats
