"""Checkpoints (``nmf_tpu/ckpt.py``, format 2), readable by both packages,
and envmap files.

A checkpoint is a pickle of ``{format: 2, config, state_dict, aabb,
near_far, grid_size, extra}``: the resolved config, the flat state dict of
``weights.to_jax_state_dict`` (numpy arrays keyed by nmf_tpu's pytree
paths), and the geometry nmf_tpu's builders take. It holds only numpy
arrays and Python builtins, so nmf_tpu reads the port's files without
torch, and the port reads nmf_tpu's without JAX.

``load`` rebuilds the model from the saved config through ``build_nmf``, at
the saved box and grid size (a shrunk or upsampled field's), and copies
the arrays in by path (``weights.from_jax_state_dict``). A composed scene
(``fields/listrf.py``; its keys ``.rf.fields[i]...``) gets one field of
the config's kind per saved field, each then taking its arrays and box
from the state dict. A dual-scene checkpoint (``train_dualbg.py``; its
keys ``.bg_module.bgs[i]...``) raises: nmf_tpu's ``load`` builds one fresh
envmap for it and drops the saved ones with a warning.

Every file is read through a restricted unpickler: it imports numpy's
array and scalar reconstruction and ``numpy.dtype``, nothing else (a
config's dicts, lists, strings and numbers are pickle opcodes, no
classes). nmf_tpu's fitted-envmap file (format 1: ``{"model":
IntegralEquirect, config, extra}``, every leaf a numpy array) names the
class ``nmf_tpu.modules.bg.IntegralEquirect``, which is read as a plain
record, so no module of ``nmf_tpu``, ``jax`` or ``flax`` is loaded; any
other format-1 payload raises ``Format1Checkpoint``. ``load_envmap``
builds the port's ``IntegralEquirect`` from such a file, from the file
``save_envmap`` writes (``scripts/pano2env.py``: ``{format: "envmap",
envmap, config}``, numpy arrays and builtins) or from a format-2
checkpoint's envmap.
"""
import pickle
from pathlib import Path

import numpy as np
import torch

from . import weights
from .builders import build_field, build_nmf
from .fields.listrf import make_listrf
from .modules.bg import init_integral_equirect


class Format1Checkpoint(ValueError):
    pass


def save(path, nmf, config, extra=None):
    """Write ``nmf`` with its resolved ``config`` (must hold
    ``model.arch``) and ``extra`` (resume state) to ``path``."""
    if not (isinstance(config, dict) and isinstance(config.get("model"), dict)
            and config["model"].get("arch") is not None):
        raise ValueError("a format-2 checkpoint needs the config's "
                         "model.arch to rebuild the model from")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {
        "format": 2,
        "config": config,
        "state_dict": weights.to_jax_state_dict(nmf),
        "aabb": nmf.rf.aabb.detach().cpu().numpy().astype(np.float32),
        "near_far": tuple(float(x) for x in nmf.sampler.near_far),
        "grid_size": tuple(int(g) for g in nmf.rf.grid_size),
        "extra": dict(extra or {}),
    }
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    tmp.replace(path)


# the packages a format-1 pickle names (its flax pytree's classes)
_FORMAT_1_MODULES = {"jax", "jaxlib", "flax", "optax", "nmf_tpu"}
# where numpy 1.x and 2.x put the functions that rebuild an array or a
# scalar: a file written under either reads under either
_NUMPY_MODULES = {"numpy.core.multiarray", "numpy._core.multiarray"}


class EnvmapRecord:
    """nmf_tpu's pickled ``IntegralEquirect``: its fields as attributes."""


# this numpy's functions behind those names
_NUMPY_CALLABLES = {"_reconstruct": np.zeros(1).__reduce__()[0],
                    "scalar": np.float32(0).__reduce__()[0]}


class _Unpickler(pickle.Unpickler):
    def __init__(self, f, path):
        super().__init__(f)
        self.path = path

    def find_class(self, module, name):
        if module in _NUMPY_MODULES and name in _NUMPY_CALLABLES:
            return _NUMPY_CALLABLES[name]
        if module == "numpy" and name in ("ndarray", "dtype"):
            return getattr(np, name)
        if (module, name) == ("nmf_tpu.modules.bg", "IntegralEquirect"):
            return EnvmapRecord
        if module.split(".")[0] in _FORMAT_1_MODULES:
            raise Format1Checkpoint(
                f"{self.path}: a format-1 checkpoint (it pickles "
                f"{module}.{name}); nmf_tpu_torch reads format-2 "
                "checkpoints and envmap files only")
        raise pickle.UnpicklingError(
            f"{self.path}: the file names {module}.{name}, which the "
            "checkpoint reader does not admit (numpy arrays only)")


def _unpickle(path):
    with open(path, "rb") as f:
        return _Unpickler(f, path).load()


def _read(path):
    payload = _unpickle(path)
    if not isinstance(payload, dict) or payload.get("format") != 2:
        raise Format1Checkpoint(
            f"{path}: a format-1 checkpoint (a pickled flax pytree); "
            "nmf_tpu_torch reads format-2 checkpoints only")
    return payload


def _count(sd, prefix):
    """The number of list entries ``prefix<i>]...`` among the keys."""
    return len({k.split("]")[0] for k in sd if k.startswith(prefix)})


def load(path, device="cuda"):
    """(nmf on ``device``, config, extra) from a format-2 checkpoint
    written by either package."""
    payload = _read(path)
    cfg = payload["config"]
    sd = payload["state_dict"]
    n_bgs = _count(sd, ".bg_module.bgs[")
    if n_bgs:
        raise NotImplementedError(
            f"{path}: a dual-scene checkpoint ({n_bgs} envmaps under "
            ".bg_module.bgs[i]); nmf_tpu_torch does not reload one "
            "(nmf_tpu's load builds one fresh envmap and drops the saved "
            "ones)")
    grid_size = tuple(payload["grid_size"]) or None
    nmf = build_nmf(cfg["model"]["arch"], payload["aabb"],
                    tuple(payload["near_far"]), device=device,
                    grid_size=grid_size)
    n_fields = _count(sd, ".rf.fields[")
    if n_fields:
        gen = torch.Generator().manual_seed(0)
        nmf.rf = make_listrf([build_field(
            gen, cfg["model"]["arch"].get("rf", {}),
            np.array(payload["aabb"], np.float32), grid_size).to(device)
            for _ in range(n_fields)])
    weights.from_jax_state_dict(nmf, sd)
    if n_fields:
        nmf.sampler.update(nmf.rf, init=True)
    return nmf, cfg, payload.get("extra", {})


# an envmap's arrays, and the settings init_integral_equirect takes
_ENVMAP_LEAVES = ("bg_mat", "mipbias", "brightness", "mul")
_ENVMAP_SETTINGS = ("activation", "mipnoise", "sh_grad", "lr", "mipbias_lr",
                    "brightness_lr", "mul_lr")


def save_envmap(path, bg_module, config=None):
    """Write ``bg_module`` (an ``IntegralEquirect``) as an envmap file:
    its four arrays and its settings, numpy arrays and builtins only."""
    envmap = {k: getattr(bg_module, k).detach().float().cpu().numpy()
              for k in _ENVMAP_LEAVES}
    envmap.update(activation=bg_module.activation,
                  sh_grad=bool(bg_module.sh_grad),
                  **{k: float(getattr(bg_module, k))
                     for k in _ENVMAP_SETTINGS if k not in (
                         "activation", "sh_grad")})
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"format": "envmap", "envmap": envmap,
                     "config": config}, f)


def load_envmap(path, device="cuda"):
    """The port's ``IntegralEquirect`` on ``device`` from an envmap file:
    nmf_tpu's fitted envmap (format 1, as its pano2env writes it), the
    port's (``save_envmap``) or a format-2 checkpoint's envmap (its
    settings from the saved config)."""
    payload = _unpickle(path)
    model = payload.get("model") if isinstance(payload, dict) else None
    if isinstance(model, EnvmapRecord):
        fields = vars(model)
    elif isinstance(payload, dict) and payload.get("format") == "envmap":
        fields = payload["envmap"]
    elif isinstance(payload, dict) and payload.get("format") == 2:
        sd = payload["state_dict"]
        if ".bg_module.bg_mat" not in sd:
            raise ValueError(f"{path}: the checkpoint holds no envmap")
        fields = {**(payload["config"]["model"]["arch"].get("bg_module")
                     or {}),
                  **{k: sd[f".bg_module.{k}"] for k in _ENVMAP_LEAVES}}
    else:
        raise Format1Checkpoint(
            f"{path}: a format-1 file that is no fitted envmap; "
            "nmf_tpu_torch reads format-2 checkpoints and envmap files only")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device=cuda but torch sees no CUDA device; "
                           "pass device=cpu to run on the CPU")
    bg_mat = np.asarray(fields["bg_mat"], np.float32)
    bg = init_integral_equirect(
        bg_resolution=bg_mat.shape[1],
        **{k: fields[k] for k in _ENVMAP_SETTINGS if k in fields})
    with torch.no_grad():
        for k in _ENVMAP_LEAVES:
            getattr(bg, k).data = torch.tensor(
                np.asarray(fields[k], np.float32))
    return bg.to(device)
