"""The microfacet slice of nmf_tpu_torch as a whole, against nmf_tpu, on the
tiny flagship of ``torch_parity.FLAGSHIP`` with nmf_tpu's random draws
replayed by name (``torch_parity.render_draws``): shade with its discrete
decisions, render at recursion 0 and one retrace level, three train steps
(loss, every gradient, every updated tensor) and a CPU reconstruction run.

The envmap's mip bias is raised to 12 here, so every lookup's mip level
clips at 7 and its box spans the whole map: a box value is then a
difference of SAT entries far apart and agrees to 1e-6, while boxes of a
few texels carry the SAT's summation-order difference times 1000 / area,
and so does the mip bias's gradient (``test_torch_flagship_modules.py::
test_envmap_matches`` holds those at their own tolerance). The march's box
test flips only within an ulp of a face: the rays are the dataset's camera
rays, whose first sample lies half a step inside the box, and the alpha
mask is the initial all-occupied one, which has no cell edges.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import nmf_tpu.models.microfacet as jmf  # noqa: E402
from nmf_tpu import ckpt as jckpt  # noqa: E402
from nmf_tpu import trainer as jtrainer  # noqa: E402
from nmf_tpu.data.blender import load_dataset as jload  # noqa: E402
from nmf_tpu.render import render as jrender  # noqa: E402
from nmf_tpu_torch import train as ttrain  # noqa: E402
from nmf_tpu_torch import trainer as ttrainer  # noqa: E402
from nmf_tpu_torch import weights  # noqa: E402
from nmf_tpu_torch.ops.draws import Draws  # noqa: E402
from nmf_tpu_torch.render import reflection_fn  # noqa: E402
from nmf_tpu_torch.render import render as trender  # noqa: E402
from torch_parity import (build_flagship_pair, jax_reflection,  # noqa: E402
                          params_match, port_copy, render_draws,
                          shade_draws, shade_inputs)

B = 64
DATASET = {"dataset_name": "synthetic_sphere", "n_views": 4,
           "image_size": 16}
MIPBIAS = 12.0
FWD, GRAD = 1e-5, 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny shapes run fastest on one thread, and the test workers
    share the CPU cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flagship():
    """The tiny flagship in nmf_tpu (built once) and its config."""
    jn, _, cfg = build_flagship_pair()
    return jn.replace(bg_module=jn.bg_module.replace(
        mipbias=jnp.asarray(MIPBIAS, jnp.float32))), cfg


def _pair(flagship):
    jn, cfg = flagship
    return jn, port_copy(jn, cfg), cfg


@pytest.fixture(scope="module")
def rays():
    ds = jload(DATASET, None, "train")
    ids = np.random.default_rng(0).choice(ds["all_rays"].shape[0], 3 * B,
                                          replace=False)
    return ds["all_rays"][ids], ds["all_rgbs"][ids]


def _close(a, b, rtol, what="", scale=None):
    """|a - b| <= rtol * (|b| + max|b|)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    s = np.abs(b).max() if scale is None else scale
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * s + 1e-12,
                               err_msg=what)


def _grads_match(tn, jgrads, rtol=GRAD, loose=()):
    """Every nmf_tpu gradient against the port's (a tensor the port does
    not differentiate must have an exactly zero one there)."""
    for key, g in jckpt.state_dict(jgrads).items():
        t, transpose = weights.port_tensor(tn, key)
        if t.grad is None:
            assert not np.any(g), key
            continue
        tg = t.grad.numpy()
        tol = next((tl for k, tl in loose if k in key), rtol)
        _close(tg.T if transpose else tg, g, tol, key)


def test_reconstruction_on_cpu(tmp_path):
    # first in the file: before the JAX compiles, whose thread pools slow
    # the port's CPU ops that follow
    lines = []
    _, res = ttrain.reconstruction(ttrain.config_lib.compose([
        "model=microfacet_tensorf2", "dataset=synthetic_sphere",
        "device=cpu", "model.params.n_iters=18",
        "model.params.batch_size=64", "model.params.min_batch_size=64",
        "model.params.max_batch_size=256",
        "model.params.target_num_samples=4000",
        "field.N_voxel_init=4096", "field.N_voxel_final=8000",
        "field.upsamp_list=[8]", "model.arch.sampler.update_list=[4,12]",
        "model.arch.max_samples_per_ray=16",
        "model.arch.recur_samples_per_ray=8",
        "model.arch.proposal_samples_per_ray=8",
        "model.arch.model.brdf_ray_budget=[512,128]",
        "model.arch.model.max_retrace_rays=[32]",
        "model.arch.bg_module.bg_resolution=32",
        "dataset.image_size=12", "dataset.n_views=3",
        f"basedir={tmp_path}", "expname=f", "progress_refresh_rate=4"]),
        log=lines.append)
    out = tmp_path / "synthetic_sphere_f" / "imgs_test_all"
    # the test images and, as nmf_tpu writes it beside them, the envmap
    assert sorted(p.name for p in out.glob("*.png")) == [
        "000.png", "001.png", "002.png", "pano.png"]
    assert sum("schedule event" in ln for ln in lines) == 3
    # the adaptive batch moved off 64 at its 16th step
    assert any("batch=64" in ln for ln in lines)
    assert res["batch"] != 64
    assert math.isfinite(res["loss"]) and res["psnr"] > 5
    assert 0 < res["thin_scale"] <= 1 and 0 < res["thin_scale_retrace"] <= 1


@pytest.mark.parametrize("case", ["thinned", "few_valid"])
def test_shade_matches_with_its_discrete_decisions(case, flagship,
                                                   monkeypatch):
    """Microfacet.shade on M = 512 samples with injected draws: rgb, the
    debug maps, every gradient, and the discrete decisions equal: the
    per-sample ray counts, the slot -> sample map and the retraced slots."""
    jn, tn, _ = _pair(flagship)
    M = 512
    key = jax.random.PRNGKey({"thinned": 5, "few_valid": 6}[case])
    xyz, app, vd, nrm, w, valid = shade_inputs(
        M, seed=len(case), few_valid=case == "few_valid")
    cot = np.random.default_rng(1).normal(size=(M, 3)).astype(np.float32)
    Cf = app.shape[-1]

    # record nmf_tpu's decisions: route its parent gather through the
    # take_rows_binsum call site (the same x[src] and autodiff), and
    # wrap top_k
    rec = {}
    seg = jmf.segment_sum_to
    monkeypatch.setattr(jmf, "take_rows_binsum",
                        lambda x, idx: rec.setdefault("gathers", []).append(
                            (x, idx)) or x[idx])
    monkeypatch.setattr(jmf, "segment_sum_to",
                        lambda v, s, ok, m, binsum=False: seg(v, s, ok, m))
    top_k = jax.lax.top_k

    def recording_top_k(x, k):
        out = top_k(x, k)
        rec["top"] = (x, out[1])
        return out

    monkeypatch.setattr(jax.lax, "top_k", recording_top_k)

    def jfun(n, app_, nrm_, w_):
        rec.clear()
        cache = n.bg_module.prepare()
        model = n.model.replace(scatter_kernel=True)
        rgb, dbg = model.shade(
            jnp.asarray(xyz), n.rf.normalize_coord(jnp.asarray(xyz)), app_,
            jnp.asarray(vd), nrm_, w_, jnp.asarray(valid), M // 8,
            render_reflection=jax_reflection(n, cache),
            bg_module=n.bg_module,
            bg_cache=cache, is_train=True, recur=0, key=key)
        parent, src = rec["gathers"][0]
        aux = (rgb, {k: v for k, v in dbg.items() if not k.startswith("__")},
               parent[:, 7 + Cf + 9], src, rec["top"][1], rec["top"][0])
        return (rgb * cot).sum(), aux

    (_, (jrgb, jdbg, jcounts, jsrc, jtop, jcontrib)), jg = jax.jit(
        jax.value_and_grad(jfun, argnums=(0, 1, 2, 3), has_aux=True))(
            jn, jnp.asarray(app), jnp.asarray(nrm), jnp.asarray(w))
    monkeypatch.undo()

    draws = Draws(None, shade_draws(key, jn, M, True))
    ttrainer.Optimizer(tn, ttrainer.OptimConfig())  # gradients on all
    ins = [torch.tensor(a, requires_grad=True) for a in (app, nrm, w)]
    cache = tn.bg_module.prepare()
    trgb, tdbg = tn.model.shade(
        torch.from_numpy(xyz), tn.rf.normalize_coord(torch.from_numpy(xyz)),
        ins[0], torch.from_numpy(vd), ins[1], ins[2],
        torch.from_numpy(valid), M // 8,
        render_reflection=reflection_fn(tn, True, 0, cache, []),
        bg_module=tn.bg_module, bg_cache=cache, is_train=True, recur=0,
        draws=draws)
    (trgb * torch.from_numpy(cot)).sum().backward()

    # the draws keep every decision clear of its boundary: no rounding
    # input within 1e-5 of an integer, no two retrace contributions within
    # 1e-5 of each other among the valid ones
    wv = np.where(valid, w, 0).astype(np.float64)
    scale = min(1.0, 0.98 * 512 / max((wv * 128).sum(), 1.0))
    u = draws.given["alloc"]
    lim = wv * 128 * scale + u - 0.5
    assert np.abs(lim - np.round(lim))[valid].min() > 1e-5
    c = np.sort(np.asarray(jcontrib))[::-1]
    c = c[c > -1e8]
    assert c.size < 2 or np.abs(np.diff(c[:33])).min() > 1e-5
    n_valid_slots = int((np.asarray(jcontrib) > -1e8).sum())
    assert (n_valid_slots < 32) == (case == "few_valid")

    for name, j in (("__counts", jcounts), ("__src", jsrc),
                    ("__top_idx", jtop)):
        np.testing.assert_array_equal(tdbg[name].numpy(), np.asarray(j))
    _close(trgb.detach().numpy(), jrgb, FWD, "rgb")
    for k, v in jdbg.items():
        _close(tdbg[k].detach().numpy(), v, FWD, k)
    for t, g, name in zip(ins, jg[1:], ("app", "normals", "weights")):
        _close(t.grad.numpy(), g, GRAD, name)
    _grads_match(tn, jg[0])


def test_eval_render_matches(flagship, rays):
    """The primary pass at evaluation (no jitter, stratified resampling,
    the test-time bounce budget) through the proposal, the field with
    normals, shade and its retrace, at B = 64: the images and the
    recursion-0 statistics. The train-mode pass and its gradients are held
    by the train-step test."""
    jn, tn, _ = _pair(flagship)
    key = jax.random.PRNGKey(9)
    jims, jst = jax.jit(lambda n, r: jrender(
        n, r, key, is_train=False, draw_debug=True,
        bg_cache=n.bg_module.prepare()))(jn, jnp.asarray(rays[0][:B]))
    with torch.no_grad():
        tims, tst = trender(
            tn, torch.from_numpy(rays[0][:B]), is_train=False,
            draws=Draws(None, render_draws(key, jn, B, False)),
            draw_debug=True, bg_cache=tn.bg_module.prepare())
    for k in ("rgb_map", "acc_map", "depth"):
        _close(tims[k].numpy(), jims[k], FWD, k)
    for k in ("ori_loss", "thin_scale", "thin_scale_retrace",
              "distortion_loss", "envmap_reg", "brdf_reg", "diffuse_reg",
              "n_valid_samples"):
        _close(float(tst[k]), float(jst[k]), FWD, k)


def test_retrace_pass_keeps_position_gradients(flagship):
    """render at recursion 1 on 32 bounce rays starting inside the box: the
    envmap background at their mip levels, no tonemap, and gradients that
    reach the rays through the sample positions."""
    jn, tn, _ = _pair(flagship)
    rng = np.random.default_rng(3)
    T = 32
    origin = rng.uniform(-0.6, 0.6, (T, 3))
    dirs = rng.normal(size=(T, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    br = np.concatenate([origin, dirs], -1).astype(np.float32)
    mip = rng.uniform(-6, -2, T).astype(np.float32)
    cot = rng.normal(size=(T, 3)).astype(np.float32)
    key = jax.random.PRNGKey(12)

    def jfun(n, r):
        ims, _ = jrender(n, r, key, is_train=True, draw_debug=True,
                         bg_col=None, recur=1,
                         override_near=3 * n.sampler.live_stepsize,
                         stepmul=n.recur_stepmul, tonemap=False,
                         start_mipval=jnp.asarray(mip),
                         bg_cache=n.bg_module.prepare())
        return (ims["rgb_map"] * cot).sum(), ims

    (_, jims), jg = jax.jit(jax.value_and_grad(
        jfun, argnums=(0, 1), has_aux=True))(jn, jnp.asarray(br))

    ttrainer.Optimizer(tn, ttrainer.OptimConfig())  # gradients on all
    tr = torch.tensor(br, requires_grad=True)
    tims, _ = trender(tn, tr, is_train=True,
                      draws=Draws(None, render_draws(key, jn, T, True, 1)),
                      draw_debug=True, bg_col=None, recur=1,
                      override_near=3 * tn.sampler.stepsize,
                      stepmul=tn.recur_stepmul, tonemap=False,
                      start_mipval=torch.from_numpy(mip),
                      bg_cache=tn.bg_module.prepare())
    (tims["rgb_map"] * torch.from_numpy(cot)).sum().backward()
    for k in ("rgb_map", "acc_map", "depth"):
        _close(tims[k].detach().numpy(), jims[k], FWD, k)
    assert np.abs(np.asarray(jg[1])).max() > 0
    _close(tr.grad.numpy(), jg[1], GRAD, "d rays")
    _grads_match(tn, jg[0])


def test_three_train_steps_match(flagship, rays):
    """Three steps of the flagship train step: the loss, every gradient and
    every updated tensor. Each step starts the port from nmf_tpu's
    parameters (copied over; the Adam moments carry on in each framework),
    so one step's work is compared from one state.

    The normals of a random-initialized field (|grad sigma| ~ 1e-3) turn
    ulp differences of the sample positions (the proposal's CDF, a cumsum
    summed in another order) into 1e-4-relative differences of the bounce
    directions: gradients reached through them agree to 5e-4 of each
    tensor's largest (3.3e-4 seen). Adam's first steps are ~lr * sign(g):
    an entry whose gradient lies inside that band (below 1e-3 of its
    tensor's largest) may move differently, by at most 2 lr sched; every
    other entry is held to 1e-5.
    """
    jn, tn, cfg = _pair(flagship)
    params = cfg["model"]["params"]
    opt_cfg = jtrainer.OptimConfig(
        betas=tuple(params["betas"]), eps=params["eps"],
        lr_init=params["lr_init"], lr_final=params["lr_final"],
        lr_delay_steps=params["lr_delay_steps"],
        lr_delay_mult=params["lr_delay_mult"], n_iters=100)
    tx = jtrainer.make_optimizer(jn, opt_cfg)
    state = tx.init(jn)
    jw = jtrainer.LossWeights(ori_lambda=params["ori_lambda"],
                              pred_lambda=params["pred_lambda"],
                              l1_weight=params["L1_weight_initial"])
    jgrad = jax.jit(jax.value_and_grad(
        lambda n, r, g, k: jtrainer.compute_loss(n, r, g, k, jw,
                                                 jnp.ones(3)),
        has_aux=True))
    jupdate = jax.jit(lambda g, st, n: (lambda u: (
        optax.apply_updates(n, u[0]), u[1]))(tx.update(g, st, n)))
    topt = ttrain.make_optimizer(tn, params, 100)
    tw = ttrain.make_loss_weights(params)
    max_lr = max(ttrainer.group_lrs(tn).values())
    for i in range(3):
        weights.from_jax_state_dict(tn, jckpt.state_dict(jn))
        r, g = rays[0][i * B:(i + 1) * B], rays[1][i * B:(i + 1) * B]
        key = jax.random.PRNGKey(20 + i)
        (jl, jm), jg = jgrad(jn, jnp.asarray(r), jnp.asarray(g), key)
        topt.zero_grad()
        tl, tm = ttrainer.compute_loss(
            tn, torch.from_numpy(r), torch.from_numpy(g), tw,
            (1.0, 1.0, 1.0), draws=Draws(None, render_draws(key, jn, B,
                                                            True)))
        tl.backward()
        _close(float(tl), float(jl), FWD, "loss")
        for k in ("photo_mse", "thin_scale", "thin_scale_retrace",
                  "n_valid_samples"):
            _close(float(tm[k]), float(jm[k]), FWD, k)
        _grads_match(tn, jg, rtol=5e-4)
        jn, state = jupdate(jg, state, jn)
        topt.step()
        params_match(tn, jn, jg, 2 * max_lr * topt.sched(i))
