"""Volume renderer: the composition root ``NMF`` and ``render``
(``nmf_tpu/render.py``).

Samples stay in a padded (B, K) layout with a validity mask. The
transmittance weights go through the composite CUDA kernel
(``ops/kernels/composite.transmittance_weights``) on the card: for the
proposal passes, the primary pass and every retrace pass.

A pass optionally runs a proposal density over the full march and
resamples a smaller weight-proportional fine set (on the primary pass
without gradient); the field query gives
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

The shading set can be smaller than the march: with
``app_samples_per_ray`` (two-stage) the top samples of each ray by weight,
with ``merge_runs`` the top runs of consecutive same-cell samples
(``ops/runs.py``; it wins when both are set). Either applies to the
primary pass of a field with a grid; its stage 1 queries the density over
the full march (the same values the fused query gives, so ``acc_map``,
the distortion loss and the sample count see the full budget), and stage
2 the appearance (and normals) of the shading set only. With
``recur_proposal_samples_per_ray`` a retrace pass runs the proposal too,
with the field's tensors held still and the positions differentiable in
the bounce rays. ``proposal_pad_init`` / ``proposal_pad_iters`` anneal the
proposal's pad geometrically from the one to ``proposal_pad`` over those
iterations (``proposal_pad_cur``, a 0-d buffer). The output is
tonemapped with the NMF's curve (``tonemap``), unclipped with ``hdr``.
"""
import contextlib
import warnings

import torch
import torch.nn as nn

from .ops.draws import Draws
from .ops.kernels.composite import transmittance_weights
from .ops.losses import distortion_loss
from .ops.masked import gather_rows, row_mask_sum
from .ops.resample import resample_pdf
from .ops.runs import cell_indices, merge_sample_runs, top_k_indices
from .ops.safemath import normalize
from .ops.tonemap import get_tonemap


class NMF(nn.Module):
    """Field + sampler + shading model (+ envmap)."""

    def __init__(self, rf, sampler, model, bg_module=None,
                 normal_module=None, max_samples_per_ray=-1,
                 recur_samples_per_ray=-1, proposal_samples_per_ray=-1,
                 proposal_pad=0.01, recur_stepmul=1.0, eval_batch_size=4096,
                 lr_scale=1.0, use_predicted_normals=False,
                 align_pred_norms=True, geonorm_iters=-1,
                 geonorm_interp_iters=1000, detach_inter=False,
                 tonemap="srgb", hdr=False, app_samples_per_ray=-1,
                 merge_runs=0, recur_proposal_samples_per_ray=-1,
                 proposal_pad_init=-1.0, proposal_pad_iters=0):
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
        get_tonemap(tonemap)
        self.tonemap = tonemap
        self.hdr = bool(hdr)
        self.app_samples_per_ray = int(app_samples_per_ray)
        self.merge_runs = int(merge_runs or 0)
        self.recur_proposal_samples_per_ray = int(
            recur_proposal_samples_per_ray)
        self.proposal_pad_init = float(proposal_pad_init)
        self.proposal_pad_iters = int(proposal_pad_iters or 0)
        # the annealed pad's live value, from the build on
        anneal = self.proposal_pad_iters > 0 and self.proposal_pad_init > 0
        self.register_buffer("proposal_pad_cur", torch.tensor(
            self.proposal_pad_init) if anneal else None)

    @property
    def pad(self):
        """The proposal's pad: the annealed value, else ``proposal_pad``."""
        return (self.proposal_pad if self.proposal_pad_cur is None
                else self.proposal_pad_cur)

    def check_schedule(self, iteration: int) -> bool:
        """Host-side schedule tick, in place. Returns whether the optimizer
        must be rebuilt. The sampler's mask rebuild or density sweep sees
        the field before this tick's upsample, as in nmf_tpu; at one of
        the sampler's ``shrink_iters`` the field is then cropped to the
        sampler's occupied box (a rebuild even when the box stays). The
        geonorm schedule sets the normal blend, the pad's anneal the
        pad."""
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
        if self.proposal_pad_cur is not None:
            t = min(max(iteration / self.proposal_pad_iters, 0.0), 1.0)
            with torch.no_grad():
                self.proposal_pad_cur.fill_(self.proposal_pad_init ** (1 - t)
                                            * self.proposal_pad ** t)
        return changed


@contextlib.contextmanager
def held_still(module):
    """Gradients flow to the inputs of ``module``'s queries but not to its
    tensors within the block (nmf_tpu's stop-gradient copy of the field)."""
    moving = [t for t in (*module.parameters(), *module.buffers())
              if t.requires_grad]
    for t in moving:
        t.requires_grad_(False)
    try:
        yield
    finally:
        for t in moving:
            t.requires_grad_(True)


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

    kf = (nmf.proposal_samples_per_ray if recur == 0
          else nmf.recur_proposal_samples_per_ray)
    if 0 < kf < K:
        # proposal: density over the whole march, then a weight-proportional
        # fine set of kf samples; on a retrace pass the positions keep their
        # gradient to the bounce rays (the field's tensors are held still)
        with torch.no_grad() if recur == 0 else held_still(rf):
            sigma_p = rf.compute_densityfeature(
                xyz.reshape(-1, 4), use_gather_dtype=True).reshape(B, K)
            sigma_p = torch.where(valid, sigma_p, torch.zeros_like(sigma_p))
            w_p = transmittance_weights(sigma_p, dists * rf.distance_scale)
            z_vals, dists, valid = resample_pdf(
                draws, z_vals, dists, w_p, valid, kf, is_train, nmf.pad)
            pts = rays[:, None, 0:3] + rays[:, None, 3:6] * z_vals[..., None]
            xyz = torch.cat([pts, z_vals[..., None]], dim=-1)
        K = kf

    needs_normals = nmf.model.needs_normals(recur)
    app_k = nmf.app_samples_per_ray if recur == 0 else -1
    merge_k = nmf.merge_runs if recur == 0 else 0
    merge = 0 < merge_k < K and hasattr(rf, "grid_size")
    if merge and 0 < app_k < K:
        warnings.warn(
            "merge_runs takes precedence over app_samples_per_ray: the "
            "two-stage top-K shading stage is disabled while run-collapsed "
            "shading is active (both coarsen the same shading set)",
            stacklevel=2)
    two_stage = 0 < app_k < K and not merge
    if two_stage or merge:
        # stage 1: density over the full march, the values compute_all
        # gives, so acc_map is the full render's
        sigma = rf.compute_densityfeature(xyz.reshape(-1, 4),
                                          use_gather_dtype=True)
        app_features = world_normal = None
    else:
        sigma, app_features, world_normal = rf.compute_all(
            xyz.reshape(-1, 4), with_normals=needs_normals)
    sigma = torch.where(valid, sigma.reshape(B, K), sigma.new_zeros(()))
    weight = transmittance_weights(sigma, dists * rf.distance_scale)
    if recur > 0 and nmf.detach_inter:
        weight = weight.detach()
    acc_map = weight.sum(dim=1)
    # the full march's quadrature, for the distortion loss and the count
    z_full, d_full, w_full, valid_full = z_vals, dists, weight, valid

    if two_stage:
        # stage 2 shades the top app_k samples of each ray by weight
        idx = top_k_indices(weight, app_k)
        xyz = gather_rows(xyz, idx)
        z_vals, dists = gather_rows(z_vals, idx), gather_rows(dists, idx)
        weight = gather_rows(weight, idx)
        valid = gather_rows(valid, idx) & (weight > 0)
        K = app_k
    if merge:
        # stage 2 shades one sample a run of same-cell samples; the merged
        # positions are a quadrature choice and carry no gradient, the run
        # weights keep theirs
        z_m, d_m, weight, valid = merge_sample_runs(
            cell_indices(rf, xyz), z_vals, dists, weight, valid, merge_k)
        z_vals, dists = z_m.detach(), d_m.detach()
        pts = rays[:, None, 0:3] + rays[:, None, 3:6] * z_vals[..., None]
        xyz = torch.cat([pts, z_vals[..., None]], dim=-1)
        K = merge_k
    if app_features is None:
        xyz_s = xyz.reshape(-1, 4)
        if not needs_normals or getattr(rf, "fused_normals_ok", False):
            _, app_features, world_normal = rf.compute_all(
                xyz_s, with_normals=needs_normals)
        else:
            app_features = rf.compute_appfeature(xyz_s)
            world_normal = rf.compute_normals(xyz_s)

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

    tm_fn = get_tonemap(nmf.tonemap)
    if nmf.bg_module is not None and bg_col is None:
        bg_mip = (torch.full((B,), -100.0, device=dev) if start_mipval is None
                  else start_mipval.reshape(-1))
        bg = render_just_bg(nmf, rays[:, 3:6], bg_mip, bg_cache)
        if tonemap:
            bg = tm_fn(bg, noclip=True)
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
            "distortion_loss": distortion_loss(z_full, w_full, d_full),
            "normal_err": normal_err,
            "n_valid_samples": valid_full.sum(),
        })
    images = {}
    if draw_debug:
        images.update(debug_maps(weight, valid, acc_map, z_vals, xyz_normed,
                                 world_normal, pred_normal, rgb, debug, bg))
    if tonemap:
        rgb_map = tm_fn(rgb_map, noclip=nmf.hdr)
    images["rgb_map"] = rgb_map + (1 - acc_map[..., None]) * bg
    images["acc_map"] = acc_map
    return images, stats
