"""Ray and sample-cloud debug logger (``nmf_tpu/modules/logger.py``):
the sample positions, transmittance weights and normals of a ray bundle,
pickled as ``rays.pkl`` (lists of numpy arrays), and a plotly figure or
``rays.html`` where plotly is installed (None without it).

There is no global logger: the trainer makes one when the config sets
``log_rays`` and hands it to ``eval.evaluate``, which logs the central
bundle of its first view. ``collect_ray_debug`` runs the sampler and the
field over the bundle, its weights through the composite kernel
(``ops/kernels/composite.transmittance_weights``) on the card.
"""
import pickle

import numpy as np
import torch

from ..ops.kernels.composite import transmittance_weights


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class RayLogger:
    """Collects per-render debug geometry. Disabled by default (zero cost)."""

    def __init__(self, enable: bool = False, max_rays: int = 512):
        self.enable = enable
        self.max_rays = max_rays
        self.reset()

    def reset(self):
        self.entries = []

    def log(self, rays, xyz, weights, valid, normals=None, rgb=None):
        """rays (B, 6); xyz (B, K, 3/4); weights/valid (B, K);
        normals/rgb optional (B, K, 3). Stores at most max_rays rays."""
        if not self.enable:
            return
        n = min(self.max_rays, _np(rays).shape[0])
        ent = {
            "rays": _np(rays)[:n],
            "xyz": _np(xyz)[:n, :, :3],
            "weights": _np(weights)[:n],
            "valid": _np(valid)[:n],
        }
        if normals is not None:
            ent["normals"] = _np(normals)[:n]
        if rgb is not None:
            ent["rgb"] = _np(rgb)[:n]
        self.entries.append(ent)

    def save(self, path: str):
        """Pickle the collected geometry (rays.pkl)."""
        if not self.entries:
            return None
        with open(path, "wb") as f:
            pickle.dump(self.entries, f)
        return path

    def to_plotly(self, entry_idx: int = 0, weight_thresh: float = 1e-3):
        """Build a plotly Figure: ray lines + weighted sample cloud
        (+ normal quivers). Returns None when plotly is unavailable."""
        try:
            import plotly.graph_objects as go
        except ImportError:
            return None
        if not self.entries:
            return None
        e = self.entries[entry_idx]
        rays, xyz = e["rays"], e["xyz"]
        w = np.where(e["valid"], e["weights"], 0.0)
        traces = []
        # ray segments: origin -> farthest valid sample
        xs, ys, zs = [], [], []
        for i in range(rays.shape[0]):
            o = rays[i, :3]
            vm = e["valid"][i]
            end = xyz[i, vm.argmax() if vm.any() else 0] if vm.any() else (
                o + rays[i, 3:6])
            xs += [o[0], end[0], None]
            ys += [o[1], end[1], None]
            zs += [o[2], end[2], None]
        traces.append(go.Scatter3d(x=xs, y=ys, z=zs, mode="lines",
                                   line=dict(width=1), name="rays"))
        m = w > weight_thresh
        pts = xyz[m]
        traces.append(go.Scatter3d(
            x=pts[:, 0], y=pts[:, 1], z=pts[:, 2], mode="markers",
            marker=dict(size=2, color=w[m], colorscale="Viridis"),
            name="samples"))
        if "normals" in e:
            nm = e["normals"][m]
            qx, qy, qz = [], [], []
            for p, v in zip(pts, nm):
                q = p + 0.05 * v
                qx += [p[0], q[0], None]
                qy += [p[1], q[1], None]
                qz += [p[2], q[2], None]
            traces.append(go.Scatter3d(x=qx, y=qy, z=qz, mode="lines",
                                       line=dict(width=1, color="red"),
                                       name="normals"))
        return go.Figure(data=traces)

    def save_html(self, path: str, entry_idx: int = 0):
        fig = self.to_plotly(entry_idx)
        if fig is None:
            return None
        fig.write_html(path)
        return path


@torch.no_grad()
def collect_ray_debug(nmf, rays, max_samples_per_ray: int = -1):
    """The debug geometry of a (B, 6) ray tensor: the eval march's sample
    positions ``xyz`` (B, K, 4), ``valid``, the transmittance ``weights``
    of their densities and the field's ``normals`` (B, K, 3), with the
    rays; ``max_samples_per_ray`` -1 marches the whole box."""
    samp = nmf.sampler.sample(rays, is_train=False,
                              max_samples_per_ray=max_samples_per_ray)
    xyz, valid = samp["xyz"], samp["valid"]
    B, K = valid.shape
    sigma = nmf.rf.compute_densityfeature(xyz.reshape(-1, 4)).reshape(B, K)
    sigma = torch.where(valid, sigma, torch.zeros_like(sigma))
    weight = transmittance_weights(
        sigma.contiguous(), (samp["dists"] * nmf.rf.distance_scale)
        .contiguous())
    normals = nmf.rf.compute_normals(xyz.reshape(-1, 4)).reshape(B, K, 3)
    return {"rays": rays, "xyz": xyz, "weights": weight, "valid": valid,
            "normals": normals}
