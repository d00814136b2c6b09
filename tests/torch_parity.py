"""Shared helpers of the nmf_tpu_torch parity tests: tiny models built by
nmf_tpu and the port's copies of them, and the replay of nmf_tpu's key
splits as the port's named draws."""
import jax
import numpy as np

from nmf_tpu import ckpt as jckpt
from nmf_tpu import config as jconfig
from nmf_tpu.builders import build_nmf as jbuild
from nmf_tpu_torch import weights
from nmf_tpu_torch.builders import build_nmf as tbuild
from torch_inputs import FLAGSHIP

AABB = np.array([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]], np.float32)
NEAR_FAR = (2.5, 5.5)

def build_pair(gather="f32", extra=(), base=None, aabb=AABB,
               near_far=NEAR_FAR):
    """A tiny model built by nmf_tpu, and the port's copy of it (by
    default model=tensorf)."""
    ov = base if base is not None else [
        "model=tensorf", "dataset=synthetic_sphere",
        "field.N_voxel_init=4096", "field.N_voxel_final=8000",
        f"field.gather_dtype={gather}",
        "model.arch.model.diffuse_module.featureC=16"]
    cfg = jconfig.compose([*ov, *extra])
    jn = jbuild(jax.random.PRNGKey(0), cfg["model"]["arch"], aabb, near_far)
    tn = tbuild(cfg["model"]["arch"], aabb, near_far, device="cpu")
    weights.from_jax_state_dict(tn, jckpt.state_dict(jn))
    return jn, tn, cfg


def build_flagship_pair(extra=(), **kw):
    return build_pair(extra=extra, base=FLAGSHIP, **kw)


def port_copy(jn, cfg, aabb=AABB, near_far=NEAR_FAR):
    """A fresh port of the nmf_tpu model ``jn`` (built from ``cfg``)."""
    tn = tbuild(cfg["model"]["arch"], aabb, near_far, device="cpu")
    return weights.from_jax_state_dict(tn, jckpt.state_dict(jn))


def close(a, b, rtol, what="", scale=None):
    """|a - b| <= rtol * (|b| + max|b|)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    s = np.abs(b).max() if scale is None else scale
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * s + 1e-12,
                               err_msg=what)


def grads_match(tn, jgrads, rtol, loose=()):
    """Every nmf_tpu gradient against the port's (a tensor the port does
    not differentiate must have an exactly zero one there); ``loose``:
    (key part, rtol) of tensors held to their own tolerance."""
    for key, g in jckpt.state_dict(jgrads).items():
        tg = weights.port_grad(tn, key)
        if tg is None:
            assert not np.any(g), key
            continue
        tol = next((tl for k, tl in loose if k in key), rtol)
        close(tg.numpy(), g, tol, key)


def _u(key, shape):
    return np.asarray(jax.random.uniform(key, shape))


def _n(key, shape):
    return np.asarray(jax.random.normal(key, shape))


def render_draws(key, jn, B, is_train, recur=0, prefix=""):
    """The draws of nmf_tpu's ``render(key)`` of B rays at recursion
    ``recur``, by the port's names: render.py splits the key four ways
    (march jitter, shade, -, proposal resampling); a shading model without
    bounce rays draws nothing."""
    keys = jax.random.split(key, 4)
    d = {}
    K = jn.max_samples_per_ray if recur == 0 else jn.recur_samples_per_ray
    stepmul = 1.0 if recur == 0 else jn.recur_stepmul
    if is_train:
        d[prefix + "jitter"] = _u(keys[0],
                                  (B, int(jn.sampler.n_samples * stepmul)))
    kf = jn.proposal_samples_per_ray if recur == 0 else -1
    if 0 < kf < K:
        if is_train:
            d[prefix + "resample"] = _u(keys[2], (B, kf + 1))
        K = kf
    if hasattr(jn.model, "brdf_ray_budget"):
        d.update(shade_draws(keys[1], jn, B * K, is_train, recur,
                             prefix + "shade/"))
    return d


def shade_draws(key, jn, M, is_train, recur=0, prefix=""):
    """The draws of nmf_tpu's ``Microfacet.shade(key)`` on M samples: the
    key splits six ways (app-feature noise, material noise, rounding,
    Hammersley offsets, retrace tie-break and the retrace pass's key)."""
    m = jn.model
    ks = jax.random.split(key, 6)
    kd, kr = jax.random.split(ks[1])
    R = m.brdf_ray_budget[min(recur, len(m.brdf_ray_budget) - 1)]
    k1, k2 = jax.random.split(ks[3])
    d = {prefix + "app_noise": _n(ks[0], (M, jn.rf.app_dim)),
         prefix + "diffuse_noise": _n(kd, (M, 3)),
         prefix + "roughness_noise": _n(kr, (M, 2)),
         prefix + "alloc": _u(ks[2], (M,)),
         prefix + "offset1": _u(k1, (R,)),
         prefix + "offset2": _u(k2, (R,))}
    if recur < len(m.max_retrace_rays):
        d[prefix + "tiebreak"] = _u(ks[4], (R,))
        d.update(render_draws(ks[4], jn, m.max_retrace_rays[recur],
                              is_train, recur + 1, prefix + "retrace/"))
    return d


def calibration_draws(key, n_points=10000):
    """The draws of nmf_tpu's ``train.calibrate_model(key)``: the points,
    the material head's view directions and the BRDF's random vectors."""
    k1, k2 = jax.random.split(key)
    kv, kb = jax.random.split(k2)
    ks = jax.random.split(kb, 7)
    d = {"xyz": _u(k1, (n_points, 4)),
         "model/viewdirs": _u(kv, (n_points, 3)),
         "model/brdf/eax": _u(ks[0], (n_points,)),
         "model/brdf/eay": _u(ks[1], (n_points,))}
    for i in range(7):
        d[f"model/brdf/vec{i}"] = _u(ks[i], (n_points, 3))
    return d
