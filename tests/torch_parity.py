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


def grads_match(tn, jgrads, rtol, loose=(), scales=None):
    """Every nmf_tpu gradient against the port's (a tensor the port does
    not differentiate must have an exactly zero one there); ``loose``:
    (key part, rtol) of tensors held to their own tolerance; ``scales``:
    {key: the scale its tolerance is relative to} (default max |g|)."""
    scales = scales or {}
    for key, g in jckpt.state_dict(jgrads).items():
        tg = weights.port_grad(tn, key)
        if tg is None:
            assert not np.any(g), key
            continue
        tol = next((tl for k, tl in loose if k in key), rtol)
        close(tg.numpy(), g, tol, key, scale=scales.get(key))


def envmap_scalar_scales(jn, jgrads):
    """The scales of the envmap's brightness and mul gradients: each sums
    a term of every texel (exp(brightness + mul x) is the map), so they
    are held relative to the sum of those terms' magnitudes, not to their
    own value, which cancellation can make small."""
    g = np.abs(np.asarray(jgrads.bg_module.bg_mat, np.float64))
    x = np.abs(np.asarray(jn.bg_module.bg_mat, np.float64))
    return {".bg_module.brightness": g.sum(), ".bg_module.mul": (g * x).sum()}


def _u(key, shape):
    return np.asarray(jax.random.uniform(key, shape))


def _n(key, shape):
    return np.asarray(jax.random.normal(key, shape))


def render_draws(key, jn, B, is_train, recur=0, prefix=""):
    """The draws of nmf_tpu's ``render(key)`` of B rays at recursion
    ``recur``, by the port's names: render.py splits the key four ways
    (march jitter, shade, -, proposal resampling); a shading model without
    bounce rays draws nothing. The shading set is the proposal's fine set,
    or the merged runs or the two-stage set of the primary pass."""
    keys = jax.random.split(key, 4)
    d = {}
    K = jn.max_samples_per_ray if recur == 0 else jn.recur_samples_per_ray
    stepmul = 1.0 if recur == 0 else jn.recur_stepmul
    if is_train:
        d[prefix + "jitter"] = _u(keys[0],
                                  (B, int(jn.sampler.n_samples * stepmul)))
    kf = (jn.proposal_samples_per_ray if recur == 0
          else jn.recur_proposal_samples_per_ray)
    if 0 < kf < K:
        if is_train:
            d[prefix + "resample"] = _u(keys[2], (B, kf + 1))
        K = kf
    if recur == 0 and 0 < jn.merge_runs < K:
        K = jn.merge_runs
    elif recur == 0 and 0 < jn.app_samples_per_ray < K:
        K = jn.app_samples_per_ray
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
    if (getattr(m, "bright_sampler", None) is not None
            and m.percent_bright > 0 and recur == 0):
        # ERBrightSampler.sample splits its key three ways
        kb = jax.random.split(ks[5], 3)
        for name, k in zip(("u", "jy", "jx"), kb):
            d[f"{prefix}bright/{name}"] = _u(k, (R,))
    return d


def jax_reflection(jn, cache, is_train=True):
    """nmf_tpu's render_reflection closure (render.py:313-327)."""
    from nmf_tpu.render import render as jrender

    def reflect(bounce_rays, mipval, retrace, rkey):
        if retrace:
            ims, _ = jrender(jn, bounce_rays, rkey, is_train=is_train,
                             bg_col=None, recur=1,
                             override_near=3 * jn.sampler.live_stepsize,
                             stepmul=jn.recur_stepmul, tonemap=False,
                             start_mipval=mipval, bg_cache=cache)
            return ims["rgb_map"], 1 - ims["acc_map"]
        return jn.bg_module(bounce_rays[:, 3:6], mipval,
                            cache=cache).reshape(-1, 3), None
    return reflect


def shade_inputs(M, seed, few_valid=False):
    """Flattened shading inputs of M samples: xyz (M, 4), appearance
    features (M, 24), unit view directions and normals, weights, and a
    validity mask (80% valid); ``few_valid``: so few weights that fewer
    than 32 bounce slots are valid."""
    rng = np.random.default_rng(seed)
    xyz = np.concatenate([rng.uniform(-0.9, 0.9, (M, 3)),
                          rng.uniform(2.5, 4.0, (M, 1))], -1)
    app = rng.normal(0, 0.3, (M, 24))
    vd = rng.normal(size=(M, 3))
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    nrm = rng.normal(size=(M, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    w = rng.uniform(0, 0.3, M) ** 2
    valid = rng.uniform(size=M) < 0.8
    if few_valid:
        w = np.where(rng.uniform(size=M) < 0.02, 0.01, 0.0)
    return [a.astype(np.float32) for a in (xyz, app, vd, nrm, w)] + [valid]


def params_match(tn, jn, jgrads, move):
    """Every tensor of the port after an optimizer step against nmf_tpu's:
    within 1e-5 (+ 1e-5 relative) where nmf_tpu's gradient is at least
    1e-3 of its tensor's largest; elsewhere within 1e-5 + ``move`` (Adam's
    first steps are ~lr * sign(g), so an entry whose gradient lies within
    rounding of 0 may move the other way)."""
    jgd = jckpt.state_dict(jgrads)
    for k, v in jckpt.state_dict(jn).items():
        t, transpose = weights.port_tensor(tn, k)
        tv = t.detach().numpy()
        err = np.abs((tv.T if transpose else tv) - v)
        gk = np.abs(jgd[k])
        tight = gk >= 1e-3 * gk.max()
        assert (err[tight] <= 1e-5 + 1e-5 * np.abs(v[tight])).all(), k
        assert (err <= 1e-5 + move).all(), k


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
