"""Volume renderer: the composition root ``NMF`` and ``render``
(``nmf_tpu/render.py``) at recursion depth 0.

Samples stay in a padded (B, K) layout with a validity mask. The
transmittance weights go through the composite CUDA kernel
(``ops/kernels/composite.transmittance_weights``) on the card.

Not in this slice: proposal resampling, ``merge_runs``, two-stage shading
(``app_samples_per_ray``), ray recursion, background modules and normal
modules; a configuration asking for them raises ``NotImplementedError``.
"""
import torch
import torch.nn as nn

from .ops.kernels.composite import transmittance_weights
from .ops.losses import distortion_loss
from .ops.masked import row_mask_sum
from .ops.tonemap import srgb_tonemap


class NMF(nn.Module):
    """Field + sampler + shading model."""

    def __init__(self, rf, sampler, model, max_samples_per_ray=-1,
                 eval_batch_size=4096, lr_scale=1.0):
        super().__init__()
        self.rf = rf
        self.sampler = sampler
        self.model = model
        # nmf_tpu's predicted/geometric normal blend; 0 without a normal
        # module (kept so its state dict maps one to one)
        self.register_buffer("predicted_normal_lambda", torch.zeros(()))
        self.max_samples_per_ray = int(max_samples_per_ray)
        self.eval_batch_size = int(eval_batch_size)
        self.lr_scale = float(lr_scale)

    def check_schedule(self, iteration: int) -> bool:
        """Host-side schedule tick, in place. Returns whether the optimizer
        must be rebuilt. The sampler's mask rebuild sees the field before
        this tick's upsample, as in nmf_tpu."""
        m_changed = self.model.check_schedule(iteration)
        s_changed = self.sampler.check_schedule(iteration, self.rf)
        r_changed = self.rf.check_schedule(iteration)
        changed = m_changed or s_changed or r_changed
        if changed:
            self.sampler.update(self.rf, init=True)
        return changed


def render(nmf: NMF, rays, is_train=False, bg_col=(1.0, 1.0, 1.0),
           jitter=None, generator=None, draw_debug=False):
    """Render a ray batch (B, 6) -> (images, stats).

    images: rgb_map (B, 3), acc_map (B,) and, with ``draw_debug``, depth
    (B,). stats: distortion_loss and n_valid_samples. Training marches are
    jittered by ``jitter`` (B, N) U[0, 1) draws or by draws from
    ``generator``.
    """
    B = rays.shape[0]
    samp = nmf.sampler.sample(rays, is_train=is_train, jitter=jitter,
                              generator=generator,
                              max_samples_per_ray=nmf.max_samples_per_ray)
    # primary sample positions depend on the rays only
    xyz = samp["xyz"].detach()
    z_vals = samp["z_vals"].detach()
    dists = samp["dists"].detach()
    valid = samp["valid"]
    K = xyz.shape[1]

    sigma, app_features, _ = nmf.rf.compute_all(xyz.reshape(-1, 4),
                                                with_normals=False)
    sigma = torch.where(valid, sigma.reshape(B, K), sigma.new_zeros(()))
    weight = transmittance_weights(sigma, dists * nmf.rf.distance_scale)
    acc_map = weight.sum(dim=1)

    xyz_flat = xyz.reshape(-1, 4)
    xyz_normed = nmf.rf.normalize_coord(xyz_flat)
    viewdirs = rays[:, None, 3:6].expand(B, K, 3).reshape(-1, 3)
    rgb, _ = nmf.model.shade(xyz_flat, xyz_normed, app_features, viewdirs,
                             None, weight.reshape(-1), valid.reshape(-1), B)
    rgb_map = row_mask_sum(weight[..., None] * rgb.reshape(B, K, 3), valid)

    bg = torch.as_tensor(bg_col, dtype=torch.float32,
                         device=rays.device).reshape(1, 3)
    stats = {
        "distortion_loss": distortion_loss(z_vals, weight, dists),
        "n_valid_samples": valid.sum(),
    }
    images = {}
    if draw_debug:
        images["depth"] = (weight * z_vals).sum(dim=1)
    rgb_map = srgb_tonemap(rgb_map)
    images["rgb_map"] = rgb_map + (1 - acc_map[..., None]) * bg
    images["acc_map"] = acc_map
    return images, stats
