"""Carry weights between nmf_tpu and the port.

``from_jax_state_dict(nmf, sd)`` takes the flat ``{path: ndarray}`` of
``nmf_tpu.ckpt.state_dict`` (keys like ``.rf.density_rf.planes[0]``,
``.model.brdf.mlp.layers[0]['w']``, ``.rf.encoding.tables``,
``.model.ref_module.mlp.layers[0]['w']``, ``.model.model1...``,
``.bg_module.bg_mat`` or a ``MultiBG``'s ``.bg_module.bgs[1].bg_mat``) and
copies
every entry into the port's module of the same path: an attribute per
``.name``, a list entry per ``[i]``. MLP layers are ``{"w": (in, out),
"b"}`` dicts in nmf_tpu and ``nn.Linear``s here: ``['w']`` is the
transposed ``weight``, ``['b']`` the ``bias`` (a layer without a bias,
as the normal network's last, has no ``['b']`` key). A module that keeps
its parameters in another layout than nmf_tpu's leaves (the grid field's
row table) maps them itself: ``jax_leaves()`` gives its leaves in
nmf_tpu's layout, ``load_jax_leaves({leaf: array})`` takes them. A key
whose path the port lacks raises, and so does a port tensor that no key
filled.

``to_jax_state_dict(nmf)`` is the inverse: the same keys, shapes and
dtypes as ``nmf_tpu.ckpt.state_dict`` of the same model, as numpy arrays.
"""
import re

import numpy as np
import torch

_TOKEN = re.compile(r"\.(\w+)|\[(\d+)\]|\['(\w+)'\]")


def _resolve(nmf, key):
    """(object, transpose, whether the whole key was read) behind a
    nmf_tpu state-dict key."""
    obj, pos, transpose = nmf, 0, False
    for m in _TOKEN.finditer(key):
        if m.start() != pos:
            break
        pos = m.end()
        name, index, field = m.groups()
        try:
            if name is not None:
                obj = getattr(obj, name)
            elif index is not None:
                obj = obj[int(index)]
            else:
                obj = {"w": obj.weight, "b": obj.bias}[field]
                transpose = field == "w"
        except (AttributeError, IndexError, KeyError, TypeError):
            obj = None
        if obj is None:
            break
    return obj, transpose, pos == len(key)


def port_tensor(nmf, key):
    """(tensor, transpose) of the port behind a nmf_tpu state-dict key;
    ``transpose`` says the port stores it transposed. A leaf that a module
    maps itself is a view in nmf_tpu's layout."""
    obj, transpose, whole = _resolve(nmf, key)
    if not whole or not isinstance(obj, torch.Tensor):
        raise KeyError(f"nmf_tpu state-dict key {key!r} has no counterpart "
                       "in nmf_tpu_torch")
    return obj, transpose


def _leaf_owner(nmf, key):
    """(module, leaf) when ``key`` names a leaf of a module that maps its
    own leaves (``load_jax_leaves``), else None."""
    head, _, leaf = key.rpartition(".")
    if not leaf.isidentifier():
        return None
    obj, _, whole = _resolve(nmf, head)
    owns = (whole and hasattr(obj, "load_jax_leaves")
            and leaf in obj.jax_leaves())
    return (obj, leaf) if owns else None


def port_grad(nmf, key):
    """The port's gradient of the tensor behind a nmf_tpu key, in
    nmf_tpu's layout, or None."""
    owner = _leaf_owner(nmf, key)
    if owner is not None:
        module, leaf = owner
        g = next(p for p in module.parameters(recurse=False)).grad
        return None if g is None else module.jax_leaves(g)[leaf]
    t, transpose = port_tensor(nmf, key)
    return None if t.grad is None else (t.grad.t() if transpose else t.grad)


def _jax_path(module_path, leaf, module):
    """nmf_tpu's key of the port tensor ``leaf`` of ``module`` (found at
    the dotted ``module_path``), and whether the port stores it
    transposed."""
    def path(tokens):
        return "".join(f"[{t}]" if t.isdigit() else f".{t}"
                       for t in tokens if t)

    if isinstance(module, torch.nn.Linear):
        return path(module_path.split(".")) + {
            "weight": "['w']", "bias": "['b']"}[leaf], leaf == "weight"
    return path([*module_path.split("."), leaf]), False


@torch.no_grad()
def to_jax_state_dict(nmf):
    """Flat ``{nmf_tpu path: float32 ndarray}`` of every parameter and
    buffer of ``nmf``, on the host."""
    sd = {}
    for mpath, module in nmf.named_modules():
        tensors = list(module.named_buffers(recurse=False))
        if hasattr(module, "jax_leaves"):
            for leaf, t in module.jax_leaves().items():
                sd[_jax_path(mpath, leaf, module)[0]] = (
                    t.detach().float().cpu().numpy().copy())
        else:
            tensors += list(module.named_parameters(recurse=False))
        for leaf, t in tensors:
            key, transpose = _jax_path(mpath, leaf, module)
            arr = t.detach().float().cpu().numpy()
            sd[key] = (arr.T if transpose else arr).copy()
    return sd


def _port_tensors(nmf):
    """Every tensor the map must fill: parameters and buffers by identity."""
    return {id(t): name for name, t in
            list(nmf.named_parameters()) + list(nmf.named_buffers())}


def _copy_entries(nmf, sd, keys, filled):
    """Copy the entries ``keys`` of ``sd``; the names of the port tensors
    filled go into ``filled``."""
    owned = {}
    for key in keys:
        owner = _leaf_owner(nmf, key)
        if owner is not None:
            owned.setdefault(owner[0], {})[owner[1]] = np.asarray(sd[key])
    for module, leaves in owned.items():
        module.load_jax_leaves(leaves)
    names = _port_tensors(nmf)
    for module in owned:
        filled.update(names[id(p)]
                      for p in module.parameters(recurse=False))
    for key in keys:
        if _leaf_owner(nmf, key) is not None:
            continue
        old, transpose = port_tensor(nmf, key)
        arr = np.asarray(sd[key])
        new = torch.tensor(arr.T if transpose else arr, dtype=old.dtype,
                           device=old.device)
        filled.add(names.get(id(old)))
        if old.shape == new.shape:
            old.copy_(new)
        else:
            old.data = new


@torch.no_grad()
def from_jax_state_dict(nmf, sd):
    """Load ``sd`` into ``nmf`` in place and return it. Shapes follow the
    state dict. The field's entries come first: when its planes change
    shape (an upsampled or shrunk field's), the grid size is read from
    them and the sampler's geometry re-derived before the other entries,
    the sampler's own arrays (alpha mask, occupancy grid, box) among them,
    are copied. ``nmf`` may also be a lone module (no ``rf``), whose keys
    are then its own paths."""
    filled = set()

    def plane_shapes():
        # the factor fields' planes (a ListRF's fields', each); the other
        # fields never change shape here, or take it from their leaves. A
        # module without a field (a lone shading module) has none.
        rf = getattr(nmf, "rf", None)
        return {id(m): [tuple(p.shape) for p in m.density_rf.planes]
                for m in (rf.modules() if rf is not None else ())
                if hasattr(m, "density_rf")}

    # a freshly built field's planes are square at its first axis'
    # resolution, whatever its grid size; planes of another shape are an
    # upsampled or shrunk field's, whose sizes they give
    before = plane_shapes()
    _copy_entries(nmf, sd, [k for k in sd if k.startswith(".rf.")], filled)
    if plane_shapes() != before:
        for m in nmf.rf.modules():
            if hasattr(m, "density_rf"):
                p0, p1 = m.density_rf.planes[0], m.density_rf.planes[1]
                m.grid_size = (p0.shape[2], p0.shape[1], p1.shape[1])
        nmf.sampler.update(nmf.rf, init=True)
    _copy_entries(nmf, sd, [k for k in sd if not k.startswith(".rf.")],
                  filled)
    unfilled = set(_port_tensors(nmf).values()) - filled
    if unfilled:
        raise KeyError("port tensors not filled by the state dict: "
                       f"{sorted(unfilled)}")
    return nmf
