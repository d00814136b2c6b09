"""Scene composition: the union of several trained fields
(``nmf_tpu/fields/listrf.py``).

Each field sits at an offset, rotated (``rotations``: world -> field).
The density is the max over the fields; the appearance and the normals
come from the field with the largest density at the point (the first on
ties, as ``jnp.argmax``), the normals rotated back to the world. The box
is the union of the shifted boxes. The fields are frozen in training
(``trainer.label_for_path``: ``rf/fields/...``).
"""
import numpy as np
import torch
import torch.nn as nn

from ..ops.safemath import normalize


class ListRF(nn.Module):
    def __init__(self, fields, offsets, rotations, aabb_union):
        super().__init__()
        self.fields = nn.ModuleList(fields)
        self.register_buffer("offsets",
                             torch.as_tensor(offsets, dtype=torch.float32))
        self.register_buffer("rotations",
                             torch.as_tensor(rotations, dtype=torch.float32))
        self.register_buffer("aabb_union",
                             torch.as_tensor(aabb_union, dtype=torch.float32))
        self.upsamp_list = ()
        self.fixed_shape = False

    # ---- what nmf_tpu proxies from field 0, or takes over the fields ----
    @property
    def aabb(self):
        return self.aabb_union

    @property
    def app_dim(self):
        return self.fields[0].app_dim

    @property
    def distance_scale(self):
        return self.fields[0].distance_scale

    @property
    def grid_size(self):
        return self.fields[0].grid_size

    @property
    def live_grid_size(self):
        return self.grid_size

    def live_step_scale(self) -> float:
        return 1.0

    @property
    def lr(self):
        return self.fields[0].lr

    @property
    def lr_net(self):
        return self.fields[0].lr_net

    @property
    def stepsize(self) -> float:
        return min(f.stepsize for f in self.fields)

    @property
    def n_samples(self) -> int:
        return max(f.n_samples for f in self.fields)

    def normalize_coord(self, xyz):
        return self.fields[0].normalize_coord(xyz)

    def feature2density(self, feat):
        return self.fields[0].feature2density(feat)

    # ---- queries ----
    def _local(self, i, xyz):
        p = (xyz[..., :3] - self.offsets[i]) @ self.rotations[i].t()
        return torch.cat([p, xyz[..., 3:]], dim=-1)

    def _densities(self, xyz, activate=True):
        return torch.stack([f.compute_densityfeature(self._local(i, xyz),
                                                     activate=activate)
                            for i, f in enumerate(self.fields)])

    def compute_densityfeature(self, xyz, use_gather_dtype=False,
                               activate=True):
        """The max over the fields; each field gathers in f32, as nmf_tpu
        queries a ListRF (``use_gather_dtype`` changes nothing)."""
        return self._densities(xyz, activate).max(dim=0)[0]

    def _pick(self, xyz, per_field):
        """The rows (F, N, C) of the field with the largest density."""
        which = self._densities(xyz).argmax(dim=0)
        return torch.gather(per_field, 0, which[None, :, None].expand(
            1, -1, per_field.shape[-1]))[0]

    def compute_appfeature(self, xyz):
        return self._pick(xyz, torch.stack([
            f.compute_appfeature(self._local(i, xyz))
            for i, f in enumerate(self.fields)]))

    def compute_normals(self, xyz):
        return normalize(self._pick(xyz, torch.stack([
            f.compute_normals(self._local(i, xyz)) @ self.rotations[i]
            for i, f in enumerate(self.fields)])))

    def compute_all(self, xyz, with_normals=False):
        """What nmf_tpu's render queries of a field without compute_all:
        density, appearance and (with ``with_normals``) normals, each
        query on its own."""
        return (self.compute_densityfeature(xyz),
                self.compute_appfeature(xyz),
                self.compute_normals(xyz) if with_normals else None)

    # ---- regularizers and schedule ----
    def density_L1(self):
        return sum(f.density_L1() for f in self.fields)

    def tv_loss_density(self):
        return sum(f.tv_loss_density() for f in self.fields)

    def tv_loss_app(self):
        return sum(f.tv_loss_app() for f in self.fields)

    def vector_comp_diffs(self):
        return sum(f.vector_comp_diffs() for f in self.fields)

    def check_schedule(self, iteration: int) -> bool:
        return False


def make_listrf(fields, offsets=None, rotations=None):
    """nmf_tpu's ``make_listrf``: zero offsets and identity rotations by
    default; the box the union of each field's box shifted by its
    offset."""
    F = len(fields)
    offsets = np.zeros((F, 3), np.float32) if offsets is None else \
        np.asarray(offsets, np.float32)
    rotations = np.broadcast_to(np.eye(3, dtype=np.float32), (F, 3, 3)) \
        if rotations is None else np.asarray(rotations, np.float32)
    boxes = np.stack([f.aabb.detach().cpu().numpy() for f in fields])
    lo = (boxes[:, 0] + offsets).min(axis=0)
    hi = (boxes[:, 1] + offsets).max(axis=0)
    return ListRF(fields, offsets, rotations.copy(), np.stack([lo, hi])).to(
        fields[0].aabb.device)
