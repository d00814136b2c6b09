"""Carry nmf_tpu weights into the port.

``from_jax_state_dict(nmf, sd)`` takes the flat ``{path: ndarray}`` of
``nmf_tpu.ckpt.state_dict`` (keys like ``.rf.density_rf.planes[0]`` or
``.model.diffuse_module.mlp.layers[0]['w']``) and copies every entry into
the port's modules through an explicit path map. MLP weights are stored
(in, out) by nmf_tpu and (out, in) by ``nn.Linear``: they are transposed.
A key the map does not know raises, and so does a port tensor that no key
filled.
"""
import re

import numpy as np
import torch

_MLP = re.compile(r"^\.model\.diffuse_module\.mlp\.layers\[(\d+)\]\['([wb])'\]$")
_FACTOR = re.compile(r"^\.rf\.(density_rf|app_rf)\.(planes|lines)\[(\d)\]$")


def port_tensor(nmf, key):
    """(tensor, transpose) of the port behind a nmf_tpu state-dict key;
    ``transpose`` says the port stores it transposed."""
    m = _FACTOR.match(key)
    if m:
        fg, kind, i = m.groups()
        return getattr(getattr(nmf.rf, fg), kind)[int(i)], False
    m = _MLP.match(key)
    if m:
        layer = nmf.model.diffuse_module.mlp.layers[int(m.group(1))]
        if m.group(2) == "w":
            return layer.weight, True
        return layer.bias, False
    mask = nmf.sampler.alpha_mask
    fixed = {
        ".rf.basis_mat": nmf.rf.basis_mat,
        ".rf.dbasis_mat": nmf.rf.dbasis_mat,
        ".rf.aabb": nmf.rf.aabb,
        ".sampler.aabb": nmf.sampler.aabb,
        ".sampler.alpha_mask.aabb": mask.aabb,
        ".sampler.alpha_mask.alpha_volume": mask.alpha_volume,
        ".sampler.alpha_mask.coarse_volume": mask.coarse_volume,
        ".predicted_normal_lambda": nmf.predicted_normal_lambda,
    }
    if key not in fixed:
        raise KeyError(f"nmf_tpu state-dict key {key!r} has no counterpart "
                       "in nmf_tpu_torch")
    if fixed[key] is None:
        raise KeyError(f"{key}: the port has no tensor there")
    return fixed[key], False


def _port_tensors(nmf):
    """Every tensor the map must fill: parameters and buffers by identity."""
    return {id(t): name for name, t in
            list(nmf.named_parameters()) + list(nmf.named_buffers())}


@torch.no_grad()
def from_jax_state_dict(nmf, sd):
    """Load ``sd`` into ``nmf`` in place and return it. Shapes follow the
    state dict; the field's grid size and the sampler's geometry are
    re-derived when the planes change shape."""
    unfilled = _port_tensors(nmf)
    for key, value in sd.items():
        old, transpose = port_tensor(nmf, key)
        arr = np.asarray(value)
        new = torch.tensor(arr.T if transpose else arr, dtype=old.dtype,
                           device=old.device)
        unfilled.pop(id(old), None)
        if old.shape == new.shape:
            old.copy_(new)
        else:
            old.data = new
    if unfilled:
        raise KeyError("port tensors not filled by the state dict: "
                       f"{sorted(unfilled.values())}")
    rf = nmf.rf
    p0, p1 = rf.density_rf.planes[0], rf.density_rf.planes[1]
    grid = (p0.shape[2], p0.shape[1], p1.shape[1])
    if grid != tuple(rf.grid_size):
        rf.grid_size = grid
        nmf.sampler.update(rf, init=True)
    return nmf
