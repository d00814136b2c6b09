"""Shared helpers of the nmf_tpu_torch parity tests: a tiny model=tensorf
built by nmf_tpu and the port's copy of it."""
import jax
import numpy as np

from nmf_tpu import ckpt as jckpt
from nmf_tpu import config as jconfig
from nmf_tpu.builders import build_nmf as jbuild
from nmf_tpu_torch import weights
from nmf_tpu_torch.builders import build_nmf as tbuild

AABB = np.array([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]], np.float32)
NEAR_FAR = (2.5, 5.5)


def build_pair(gather="f32", extra=()):
    """A tiny model=tensorf built by nmf_tpu, and the port's copy of it."""
    ov = ["model=tensorf", "dataset=synthetic_sphere",
          "field.N_voxel_init=4096", "field.N_voxel_final=8000",
          f"field.gather_dtype={gather}",
          "model.arch.model.diffuse_module.featureC=16", *extra]
    cfg = jconfig.compose(ov)
    jn = jbuild(jax.random.PRNGKey(0), cfg["model"]["arch"], AABB, NEAR_FAR)
    tn = tbuild(cfg["model"]["arch"], AABB, NEAR_FAR, device="cpu")
    weights.from_jax_state_dict(tn, jckpt.state_dict(jn))
    return jn, tn, cfg
