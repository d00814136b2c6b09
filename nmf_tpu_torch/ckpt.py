"""Checkpoints (``nmf_tpu/ckpt.py``, format 2), readable by both packages.

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
from the state dict. A format-1
file (nmf_tpu's whole pickled flax pytree, no ``format`` key) needs JAX to
unpickle, so the port refuses it.
"""
import pickle
from pathlib import Path

import numpy as np
import torch

from . import weights
from .builders import build_field, build_nmf
from .fields.listrf import make_listrf


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


def _read(path):
    # a format-1 file pickles flax/jax objects: without JAX, unpickling it
    # fails here on the missing module, before the format can be read
    try:
        with open(path, "rb") as f:
            payload = pickle.load(f)
    except ModuleNotFoundError as e:
        if (e.name or "").split(".")[0] not in _FORMAT_1_MODULES:
            raise
        raise Format1Checkpoint(
            f"{path}: a format-1 checkpoint needs JAX to unpickle ({e}); "
            "nmf_tpu_torch reads format-2 checkpoints only") from e
    if not isinstance(payload, dict) or payload.get("format") != 2:
        raise Format1Checkpoint(
            f"{path}: a format-1 checkpoint (a pickled flax pytree); "
            "nmf_tpu_torch reads format-2 checkpoints only")
    return payload


def load(path, device="cuda"):
    """(nmf on ``device``, config, extra) from a format-2 checkpoint
    written by either package."""
    payload = _read(path)
    cfg = payload["config"]
    sd = payload["state_dict"]
    grid_size = tuple(payload["grid_size"]) or None
    nmf = build_nmf(cfg["model"]["arch"], payload["aabb"],
                    tuple(payload["near_far"]), device=device,
                    grid_size=grid_size)
    n_fields = len({k.split("]")[0] for k in sd
                    if k.startswith(".rf.fields[")})
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
