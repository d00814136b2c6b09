"""The Microfacet model's optional parts in nmf_tpu_torch against nmf_tpu,
on the tiny flagship of ``torch_inputs.FLAGSHIP``: the visibility MLP
(its init and forward, its weights carried by ``weights.py``), each BRDF
sampler's ``sample`` and ``compute_prob``, the envmap bright-ray sampler,
``Microfacet.shade`` with each option alone, one train step with every
option of the slice on, and the cube bright sampler that nmf_tpu's model
cannot call (ROADMAP C.10).

Tolerances: forward 1e-5 and gradients 1e-4 of each output's largest
(``torch_parity.close``); the envmap's brightness and mul gradients, sums
of a term a texel, 1e-4 of those terms' summed magnitudes
(``torch_parity.envmap_scalar_scales``); the Beckmann and SGGX pdfs 1e-4
(their exponent divides the directions' rounding by the squared
roughness, down to 0.05^2); the all-options train step holds the updated
parameters to 1e-5 (``torch_parity.params_match``) and its gradients to
5e-4, as ``test_torch_flagship.py``'s train steps (the normals of a random
field turn ulp differences of the sample positions into 1e-4-relative
differences of the bounce directions). The envmap's mip bias is 12, so
every lookup box spans the map (``test_torch_flagship.py``).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import nmf_tpu.modules.brdf_samplers as jbs  # noqa: E402
from nmf_tpu import ckpt as jckpt  # noqa: E402
from nmf_tpu import trainer as jtrainer  # noqa: E402
from nmf_tpu.data.blender import load_dataset as jload  # noqa: E402
from nmf_tpu.modules.visibility import ERBrightSampler as JBright  # noqa: E402
from nmf_tpu_torch import train as ttrain  # noqa: E402
from nmf_tpu_torch import trainer as ttrainer  # noqa: E402
from nmf_tpu_torch import weights  # noqa: E402
from nmf_tpu_torch.builders import build_nmf as tbuild  # noqa: E402
from nmf_tpu_torch.modules import brdf_samplers as tbs  # noqa: E402
from nmf_tpu_torch.modules.visibility import ERBrightSampler  # noqa: E402
from nmf_tpu_torch.ops.draws import Draws  # noqa: E402
from nmf_tpu_torch.render import reflection_fn  # noqa: E402
from torch_parity import (AABB, NEAR_FAR, build_flagship_pair,  # noqa: E402
                          close, envmap_scalar_scales, grads_match,
                          jax_reflection, params_match, render_draws,
                          shade_draws, shade_inputs)

FWD, GRAD = 1e-5, 1e-4
MIPBIAS = 12.0
VISIBILITY = ("model.arch.model.visibility_module._target_="
              "modules.render_modules.VisibilityMLP")
BRIGHT = ["model.arch.model.bright_sampler._target_="
          "brdf_samplers.equirect_bright_sampler.ERBrightSampler",
          "model.arch.model.percent_bright=0.25"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(extra=()):
    """The tiny flagship with ``extra`` in both packages, mip bias 12."""
    jn, tn, cfg = build_flagship_pair(extra=extra)
    with torch.no_grad():
        tn.bg_module.mipbias.fill_(MIPBIAS)
    return jn.replace(bg_module=jn.bg_module.replace(
        mipbias=jnp.asarray(MIPBIAS, jnp.float32))), tn, cfg


def test_visibility_mlp_init_and_forward():
    """The port's own init has nmf_tpu's keys, shapes and xavier bounds
    (zero biases); with nmf_tpu's weights carried over by weights.py the
    forward (eterm, sigvis) matches, and so do the gradients."""
    jn, tn, cfg = _pair([VISIBILITY])
    fresh = weights.to_jax_state_dict(tbuild(cfg["model"]["arch"], AABB,
                                             NEAR_FAR, device="cpu"))
    jsd = jckpt.state_dict(jn)
    vis_keys = sorted(k for k in jsd if ".visibility_module." in k)
    assert vis_keys == sorted(k for k in fresh if ".visibility_module." in k)
    assert len(vis_keys) == 8  # 4 layers, w and b
    for k in vis_keys:
        assert fresh[k].shape == jsd[k].shape, k
        if k.endswith("['b']"):
            assert not fresh[k].any(), k
        else:
            fan_in, fan_out = fresh[k].shape
            bound = math.sqrt(2) * math.sqrt(6 / (fan_in + fan_out))
            assert np.abs(fresh[k]).max() <= bound, k
            assert np.abs(fresh[k]).max() > 0.5 * bound, k
    first = ".model.visibility_module.mlp.layers[0]['w']"
    assert jsd[first].shape == (3 + 24 + 2 * 2 * 24, 128)
    # the port's state dict carries the same arrays back
    back = weights.to_jax_state_dict(tn)
    for k in vis_keys:
        np.testing.assert_array_equal(back[k], jsd[k])

    rng = np.random.default_rng(0)
    pts = rng.normal(size=(200, 3)).astype(np.float32)
    dirs = rng.normal(size=(200, 3)).astype(np.float32)
    feats = rng.normal(0, 0.5, (200, 24)).astype(np.float32)
    cot = rng.normal(size=(2, 200)).astype(np.float32)

    def jfun(vm, f):
        e, s = vm(jnp.asarray(pts), jnp.asarray(dirs), f)
        return (e * cot[0] + s * cot[1]).sum(), (e, s)

    (_, (je, js)), (jg, jgf) = jax.value_and_grad(
        jfun, argnums=(0, 1), has_aux=True)(jn.model.visibility_module,
                                            jnp.asarray(feats))
    f = torch.tensor(feats, requires_grad=True)
    te, ts = tn.model.visibility_module(torch.from_numpy(pts),
                                        torch.from_numpy(dirs), f)
    (te * torch.from_numpy(cot[0]) + ts * torch.from_numpy(cot[1])).sum(
        ).backward()
    close(te.detach().numpy(), je, FWD, "eterm")
    close(ts.detach().numpy(), js, FWD, "sigvis")
    close(f.grad.numpy(), jgf, GRAD, "d features")
    for key, g in jckpt.state_dict(jg).items():
        t, transpose = weights.port_tensor(tn.model.visibility_module, key)
        close((t.grad.t() if transpose else t.grad).numpy(), g, GRAD, key)


SAMPLERS = {
    "sggx": (jbs.SGGXSampler(), tbs.SGGXSampler()),
    "beckmann": (jbs.BeckmannSampler(), tbs.BeckmannSampler()),
    "cosine": (jbs.CosineLobeSampler(), tbs.CosineLobeSampler()),
    "multi": (jbs.MultiSampler(sampler_a=jbs.GGXSampler(),
                               sampler_b=jbs.CosineLobeSampler()),
              tbs.MultiSampler()),
}


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_brdf_sampler_matches(name):
    """sample: the directions, the basis and logD, and the gradients of the
    directions to V, N and the roughness; compute_prob on the samples'
    local frames, with its gradients."""
    js, ts = SAMPLERS[name]
    rng = np.random.default_rng(len(name))
    R = 512
    u1, u2 = rng.uniform(0.01, 0.99, (2, R)).astype(np.float32)
    N = rng.normal(size=(R, 3))
    N /= np.linalg.norm(N, axis=-1, keepdims=True)
    V = rng.normal(size=(R, 3))
    V /= np.linalg.norm(V, axis=-1, keepdims=True)
    V = V * np.sign((V * N).sum(-1, keepdims=True))
    r = rng.uniform(0.05, 0.9, R)
    N, V, r = (a.astype(np.float32) for a in (N, V, r))
    cot = rng.normal(size=(R, 3)).astype(np.float32)

    def jfun(V_, N_, r_):
        L, basis, logD = js.sample(jnp.asarray(u1), jnp.asarray(u2), V_,
                                   N_, r_, r_)
        H = L + V_
        H = H / jnp.linalg.norm(H, axis=-1, keepdims=True)
        rows = lambda v: jnp.einsum("rij,rj->ri", basis, v)  # noqa: E731
        p = js.compute_prob(rows(L), rows(V_), rows(H), r_, r_)
        return (L * cot).sum() + p.sum(), (L, basis, logD, p)

    (_, (jL, jbasis, jlogD, jp)), jg = jax.value_and_grad(
        jfun, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(V), jnp.asarray(N), jnp.asarray(r))
    tV, tN, tr = (torch.tensor(a, requires_grad=True) for a in (V, N, r))
    L, basis, logD = ts.sample(torch.from_numpy(u1), torch.from_numpy(u2),
                               tV, tN, tr, tr)
    H = L + tV
    H = H / torch.linalg.norm(H, dim=-1, keepdim=True)
    rows = lambda v: torch.einsum("rij,rj->ri", basis, v)  # noqa: E731
    p = ts.compute_prob(rows(L), rows(tV), rows(H), tr, tr)
    ((L * torch.from_numpy(cot)).sum() + p.sum()).backward()
    close(L.detach().numpy(), jL, FWD, "L")
    close(basis.detach().numpy(), jbasis, FWD, "basis")
    close(logD.numpy(), jlogD, FWD, "logD")
    close(p.detach().numpy(), jp, GRAD, "pdf")
    for t, g, what in zip((tV, tN, tr), jg, ("V", "N", "roughness")):
        if t.grad is None:  # the cosine lobe ignores V and the roughness
            assert not np.any(g), what
            continue
        close(t.grad.numpy(), g, GRAD, f"d {what}")


def test_bright_sampler_draws_and_pdf():
    """ERBrightSampler on a 32 x 64 envmap: the texel each draw picks (no
    index differs: the two cumsums agree to rounding far from every u), the
    directions, the pdf and its gradient to the envmap."""
    jn, tn, _ = _pair()
    n = 4096
    key = jax.random.PRNGKey(3)
    kb = jax.random.split(key, 3)
    draws = Draws(None, {name: np.asarray(jax.random.uniform(k, (n,)))
                         for name, k in zip(("u", "jy", "jx"), kb)})
    rng = np.random.default_rng(4)
    bg_mat = rng.normal(-0.6, 1.0, (3, 32, 64)).astype(np.float32)
    cot = rng.normal(size=n).astype(np.float32)

    def jfun(m):
        bg = jn.bg_module.replace(bg_mat=m)
        d, pdf = JBright().sample(key, bg, n)
        return (pdf * cot).sum(), (d, pdf)

    (_, (jd, jpdf)), jg = jax.value_and_grad(jfun, has_aux=True)(
        jnp.asarray(bg_mat))
    with torch.no_grad():
        tn.bg_module.bg_mat.copy_(torch.from_numpy(bg_mat))
    tn.bg_module.bg_mat.requires_grad_(True)
    td, tpdf = ERBrightSampler().sample(draws, tn.bg_module, n)
    (tpdf * torch.from_numpy(cot)).sum().backward()
    # a texel picked differently would move a direction by a texel
    close(td.detach().numpy(), jd, FWD, "dirs")
    close(tpdf.detach().numpy(), jpdf, FWD, "pdf")
    close(tn.bg_module.bg_mat.grad.numpy(), jg, GRAD, "d bg_mat")


# (overrides, retrace, detach_N schedule tick) of each option alone. The
# freed normals and the mixing modes shade at recursion 1 (no retrace: the
# retrace pass is the default's). Both packages' envmap lookups of the
# bounce rays take no gradient to the directions here: with whole-map
# boxes (mip bias 12) it is a difference of SAT slopes at the box corners,
# at the rounding floor (the envmap's own tests hold that gradient).
SHADE_CASES = {
    "russian_roulette": (["model.arch.model.russian_roulette=true"], True,
                         None),
    "bright": (BRIGHT, True, None),
    "visibility": ([VISIBILITY], True, None),
    "detach_N": (["model.arch.model.detach_N_iters=5"], True, None),
    "detach_N freed": (["model.arch.model.detach_N_iters=5"], False, 6),
    "detach_inter": (["model.arch.detach_inter=true"], True, None),
    **{f"mixing {m}": ([f"model.arch.model.diffuse_mixing_mode={m}"], False,
                       None)
       for m in ("fresnel", "fresnel_ind", "no_diffuse", "lambda")},
}


@pytest.mark.parametrize("case", list(SHADE_CASES))
def test_shade_option_matches(case):
    """Microfacet.shade on 512 samples with one option on: rgb, the debug
    maps, the visibility loss, the gradients of the inputs and of every
    parameter (the objective adds the visibility loss, so its gradient
    reaches the visibility MLP)."""
    extra, retrace, tick = SHADE_CASES[case]
    jn, tn, _ = _pair(extra)
    if tick is not None:
        jn = jn.replace(model=jn.model.check_schedule(tick)[0])
        assert tn.model.check_schedule(tick)
        assert not tn.model.detach_N and not jn.model.detach_N
    assert tn.model.detach_N == jn.model.detach_N
    recur = 0 if retrace else 1
    M = 512
    key = jax.random.PRNGKey(sum(map(ord, case)))
    xyz, app, vd, nrm, w, valid = shade_inputs(M, seed=len(case))
    cot = np.random.default_rng(1).normal(size=(M, 3)).astype(np.float32)

    def jfun(n, app_, nrm_, w_):
        cache = n.bg_module.prepare()
        reflect = jax_reflection(n, cache)

        def jreflect(rays, mipval, retrace, rkey):
            if not retrace:
                rays = jax.lax.stop_gradient(rays)
            return reflect(rays, mipval, retrace, rkey)

        rgb, dbg = n.model.shade(
            jnp.asarray(xyz), n.rf.normalize_coord(jnp.asarray(xyz)), app_,
            jnp.asarray(vd), nrm_, w_, jnp.asarray(valid), M // 8,
            render_reflection=jreflect,
            bg_module=n.bg_module, bg_cache=cache, is_train=True,
            recur=recur, key=key)
        vis = dbg.get("__visibility_loss", jnp.zeros(()))
        maps = {k: v for k, v in dbg.items() if not k.startswith("__")}
        return (rgb * cot).sum() + vis, (rgb, maps, vis)

    (_, (jrgb, jmaps, jvis)), jg = jax.jit(jax.value_and_grad(
        jfun, argnums=(0, 1, 2, 3), has_aux=True))(
            jn, jnp.asarray(app), jnp.asarray(nrm), jnp.asarray(w))

    draws = Draws(None, shade_draws(key, jn, M, True, recur))
    ttrainer.Optimizer(tn, ttrainer.OptimConfig())  # gradients on all
    ins = [torch.tensor(a, requires_grad=True) for a in (app, nrm, w)]
    cache = tn.bg_module.prepare()
    reflect = reflection_fn(tn, True, recur, cache, [])

    def treflect(rays, mipval, retrace, d):
        return reflect(rays if retrace else rays.detach(), mipval, retrace,
                       d)

    trgb, tdbg = tn.model.shade(
        torch.from_numpy(xyz), tn.rf.normalize_coord(torch.from_numpy(xyz)),
        ins[0], torch.from_numpy(vd), ins[1], ins[2],
        torch.from_numpy(valid), M // 8,
        render_reflection=treflect,
        bg_module=tn.bg_module, bg_cache=cache, is_train=True, recur=recur,
        draws=draws)
    tvis = tdbg.get("__visibility_loss", torch.zeros(()))
    ((trgb * torch.from_numpy(cot)).sum() + tvis).backward()

    assert ("__visibility_loss" in tdbg) == (case == "visibility")
    if case == "visibility":
        assert float(jvis) > 0
    close(float(tvis.detach()), float(jvis), FWD, "visibility loss")
    close(trgb.detach().numpy(), jrgb, FWD, "rgb")
    assert sorted(jmaps) == sorted(k for k in tdbg if not k.startswith("__"))
    for k, v in jmaps.items():
        close(tdbg[k].detach().numpy(), v, FWD, k)
    for t, g, name in zip(ins, jg[1:], ("app", "normals", "weights")):
        close(t.grad.numpy(), g, GRAD, name)
    grads_match(tn, jg[0], GRAD, scales=envmap_scalar_scales(jn, jg[0]))


B = 64
ALL_OPTIONS = [VISIBILITY, *BRIGHT, "model.arch.model.russian_roulette=true",
               "model.arch.model.detach_N_iters=100",
               "model.arch.detach_inter=true",
               "model.params.charbonier_loss=true",
               "model.params.TV_weight_bg=0.01",
               "model.params.normal_err_lambda=1e-4",
               "model.params.weight_decay=1e-6",
               "model.params.final_ori_lambda=0.01",
               "model.params.final_pred_lambda=3e-5"]


def test_train_step_with_every_option():
    """One train step of the tiny flagship with every option of the slice
    on (visibility, bright rays, Russian roulette, detached normals,
    detach_inter, the Charbonier loss, the envmap TV, the normal error
    against the dataset's normals, weight decay, the decayed ori / pred
    weights at iteration 50): the loss, the metrics, every gradient and
    every updated tensor."""
    jn, tn, cfg = _pair(ALL_OPTIONS)
    params = cfg["model"]["params"]
    ds = jload({"dataset_name": "synthetic_sphere", "n_views": 4,
                "image_size": 16}, None, "train")
    rng = np.random.default_rng(0)
    ids = rng.choice(ds["all_rays"].shape[0], B, replace=False)
    rays, rgb = ds["all_rays"][ids], ds["all_rgbs"][ids]
    # the sphere's split has no normals: unit ones, a quarter of the rays
    # without (zeros, which normal_err masks out)
    norms = rng.normal(size=(B, 3))
    norms /= np.linalg.norm(norms, axis=-1, keepdims=True)
    norms = np.where(rng.uniform(size=(B, 1)) < 0.25, 0, norms).astype(
        np.float32)
    n_iters, it = 100, 50
    ori = ttrain.lambda_decay(params, "ori", n_iters) ** it
    pred = ttrain.lambda_decay(params, "pred", n_iters) ** it
    tw = ttrain.make_loss_weights(params, ori_mult=ori, pred_mult=pred)
    jw = jtrainer.LossWeights(
        ori_lambda=tw.ori_lambda, pred_lambda=tw.pred_lambda,
        l1_weight=tw.l1_weight, tv_weight_bg=tw.tv_weight_bg,
        normal_err_lambda=tw.normal_err_lambda)
    tx = jtrainer.make_optimizer(jn, jtrainer.OptimConfig(
        betas=tuple(params["betas"]), eps=params["eps"], n_iters=n_iters,
        weight_decay=float(params["weight_decay"])))
    key = jax.random.PRNGKey(7)

    def jstep(n, st):
        (loss, m), g = jax.value_and_grad(
            lambda n_: jtrainer.compute_loss(
                n_, jnp.asarray(rays), jnp.asarray(rgb), key, jw,
                jnp.ones(3), gt_normals=jnp.asarray(norms),
                charbonier=True), has_aux=True)(n)
        upd, st = tx.update(g, st, n)
        return loss, m, g, optax.apply_updates(n, upd)

    jl, jm, jg, jnew = jax.jit(jstep)(jn, tx.init(jn))
    opt = ttrain.make_optimizer(tn, params, n_iters)
    opt.zero_grad()
    tl, tm = ttrainer.compute_loss(
        tn, torch.from_numpy(rays), torch.from_numpy(rgb), tw,
        (1.0, 1.0, 1.0), draws=Draws(None, render_draws(key, jn, B, True)),
        gt_normals=torch.from_numpy(norms))
    tl.backward()
    close(float(tl), float(jl), FWD, "loss")
    for k in ("photo_mse", "thin_scale", "thin_scale_retrace",
              "n_valid_samples"):
        close(float(tm[k]), float(jm[k]), FWD, k)
    assert float(tm["visibility_loss"]) > 0
    grads_match(tn, jg, 5e-4, scales=envmap_scalar_scales(jn, jg))
    opt.step()
    params_match(tn, jnew, jg, 2 * max(ttrainer.group_lrs(tn).values())
                 * opt.sched(0))


def test_cube_bright_sampler_is_c10():
    """nmf_tpu builds the cube sampler, and its Microfacet model fails at
    the first shade (its sample takes (key, V, N)); the port builds it
    and raises NotImplementedError naming C.10."""
    extra = ["model.arch.model.bright_sampler._target_="
             "brdf_samplers.cube_bright_sampler.CubeBrightSampler",
             "model.arch.model.percent_bright=0.1"]
    jn, tn, _ = _pair(extra)
    M = 64
    xyz, app, vd, nrm, w, valid = shade_inputs(M, seed=2)
    # the call Microfacet.shade makes (nmf_tpu/models/microfacet.py:264)
    with pytest.raises(TypeError):
        jn.model.bright_sampler.sample(jax.random.PRNGKey(5), jn.bg_module,
                                       512, cache=jn.bg_module.prepare())
    tcache = tn.bg_module.prepare()
    with pytest.raises(NotImplementedError, match="C.10"):
        tn.model.shade(
            torch.from_numpy(xyz), torch.from_numpy(xyz),
            torch.from_numpy(app), torch.from_numpy(vd),
            torch.from_numpy(nrm), torch.from_numpy(w),
            torch.from_numpy(valid), 8, reflection_fn(tn, True, 0, tcache,
                                                      []),
            tn.bg_module, tcache, True, 0,
            Draws(torch.Generator().manual_seed(0)))


def test_sggx_target_builds_ggx_as_in_nmf_tpu():
    """nmf_tpu's suffix test maps an SGGXSampler target onto GGX (C.10);
    the port builds the same, and the Beckmann target builds Beckmann."""
    for target, cls in (("sggx.SGGXSampler", tbs.GGXSampler),
                        ("beckmann.BeckmannSampler", tbs.BeckmannSampler),
                        ("cosine.CosineLobeSampler", tbs.CosineLobeSampler),
                        ("multi.MultiSampler", tbs.MultiSampler)):
        jn, tn, _ = build_flagship_pair(extra=[
            f"model.arch.model.brdf_sampler._target_=brdf_samplers.{target}"])
        assert type(tn.model.brdf_sampler) is cls
        assert type(jn.model.brdf_sampler).__name__ == cls.__name__


def test_visibility_checkpoint_read_by_each_package(tmp_path):
    """A flagship with a visibility module: the port's checkpoint read by
    nmf_tpu, and nmf_tpu's read by the port, carry every array, the
    visibility MLP's among them."""
    from nmf_tpu_torch import ckpt as tckpt

    jn, tn, cfg = _pair([VISIBILITY])
    with torch.no_grad():
        tn.model.visibility_module.mlp.layers[0].bias.fill_(0.25)
    tckpt.save(tmp_path / "t.th", tn, cfg)
    back, _, _ = jckpt.load(tmp_path / "t.th")
    want = weights.to_jax_state_dict(tn)
    got = jckpt.state_dict(back)
    assert ".model.visibility_module.mlp.layers[0]['b']" in got
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    jckpt.save(tmp_path / "j.th", jn, cfg)
    tback, _, _ = tckpt.load(tmp_path / "j.th", "cpu")
    got = weights.to_jax_state_dict(tback)
    for k, v in jckpt.state_dict(jn).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
