"""Ref-NeRF shading and the two-model warmup (``nmf_tpu/models/refnerf.py``).

``RefNeRF``: the material head gives diffuse, tint and roughness (no
noise); a reflection MLP (``RefMLP``) of the view reflected about the
shading normal, its cosine and an integrated SH encoding of the reflected
direction at that roughness gives the specular colour; ``rgb = diffuse +
tint * spec``. No bounce rays, no retrace.

``DualModel``: ``model1`` shades every retrace pass and every pass until
``switch_iter``; from then on ``model2`` shades the primary pass. The
switch is a schedule event (the optimizer is rebuilt). ``use_model2`` is
not part of the state dict: a resumed run sets it again at its first tick.
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..modules.ish import ListISH
from ..modules.mlp import MLP
from ..ops.safemath import positional_encoding


class RefMLP(nn.Module):
    """Specular colour from [refdirs, VdotN, (features, PE(features)),
    ISH(refdirs, roughness)] through an MLP, ``offset`` and an
    activation."""

    def __init__(self, mlp, ref_encoder=None, feape=-1,
                 activation="softplus", offset=0.0, lr=1e-3):
        super().__init__()
        self.mlp = mlp
        self.ref_encoder = ref_encoder
        self.feape = int(feape)
        self.activation = activation
        self.offset = float(offset)
        self.lr = float(lr)

    def forward(self, pts, viewdirs, features, refdirs, roughness,
                viewdotnorm):
        indata = [refdirs, viewdotnorm]
        if self.feape > -1:
            indata.append(features)
        if self.feape > 0:
            indata.append(positional_encoding(features, self.feape))
        if self.ref_encoder is not None:
            indata.append(self.ref_encoder(refdirs, roughness).reshape(
                pts.shape[0], -1))
        out = self.mlp(torch.cat(indata, dim=-1)) + self.offset
        if self.activation == "softplus":
            return F.softplus(out)
        if self.activation == "sigmoid":
            return torch.sigmoid(out)
        if self.activation == "exp":
            return torch.exp(torch.clamp(out, max=10))
        return out


class RefNeRF(nn.Module):
    def __init__(self, diffuse_module, ref_module):
        super().__init__()
        self.diffuse_module = diffuse_module
        self.ref_module = ref_module

    def needs_normals(self, recur: int) -> bool:
        return True

    def check_schedule(self, iteration: int) -> bool:
        return False

    def shade(self, xyz, xyz_normed, app_features, viewdirs, normals,
              weights, valid, B, **kwargs):
        diffuse, tint, matprop = self.diffuse_module(
            xyz_normed, viewdirs, app_features, std=0.0)
        VdotN = (-viewdirs * normals).sum(-1, keepdim=True)
        refdirs = 2 * VdotN * normals + viewdirs
        spec = self.ref_module(xyz_normed, viewdirs, app_features, refdirs,
                               matprop["r1"][..., 0], VdotN)
        rgb = diffuse + tint * spec
        return rgb, {"diffuse": diffuse, "tint": tint,
                     "roughness": matprop["r1"], "spec": spec}


_LIST_ISH = ListISH()


def init_refnerf(app_dim, diffuse_module, feape=-1, ref_encoder=_LIST_ISH,
                 num_layers=3, hidden_w=128, initializer="kaiming",
                 activation="softplus", offset=0.0, lr=1e-3,
                 generator=None, **_):
    """nmf_tpu's ``init_refnerf``: the reflection encoder defaults to
    ListISH(0, 1, 2, 4) (None: no encoder). Other keys of the config
    (``featureC``) are read by nothing, as in nmf_tpu."""
    in_w = 3 + 1 + (0 if ref_encoder is None else ref_encoder.dim())
    if feape > -1:
        in_w += 2 * max(feape, 0) * app_dim + app_dim
    mlp = MLP(in_w, 3, num_layers=num_layers, hidden_w=hidden_w,
              generator=generator, initializer=initializer)
    return RefNeRF(diffuse_module, RefMLP(
        mlp, ref_encoder=ref_encoder, feape=feape, activation=activation,
        offset=offset, lr=lr))


class DualModel(nn.Module):
    def __init__(self, model1, model2, switch_iter=0):
        super().__init__()
        self.model1 = model1
        self.model2 = model2
        self.switch_iter = int(switch_iter)
        self.use_model2 = False

    def needs_normals(self, recur: int) -> bool:
        return (self.model1.needs_normals(recur)
                or self.model2.needs_normals(recur))

    def check_schedule(self, iteration: int) -> bool:
        """Both models' ticks; at ``switch_iter`` (or the first tick after
        it) the switch to ``model2``, which asks for an optimizer
        rebuild."""
        c1 = self.model1.check_schedule(iteration)
        c2 = self.model2.check_schedule(iteration)
        if not self.use_model2 and iteration >= self.switch_iter:
            self.use_model2 = True
            return True
        return c1 or c2

    def calibrate(self, draws, xyz, feat, bg_brightness):
        for name in ("model1", "model2"):
            model = getattr(self, name)
            if hasattr(model, "calibrate"):
                model.calibrate(draws.scoped(name), xyz, feat, bg_brightness)

    def shade(self, *args, recur=0, **kwargs):
        active = (self.model1 if recur > 0 or not self.use_model2
                  else self.model2)
        return active.shade(*args, recur=recur, **kwargs)
