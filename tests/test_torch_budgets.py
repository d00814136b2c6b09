"""The renderer's sample budgets in nmf_tpu_torch, against nmf_tpu: the
march's superstep and fine_alpha_test, the cell runs (``ops/runs.py``),
two-stage and run-collapsed shading on the tensorf and the flagship, the
retrace proposal with its gradient to the bounce rays, the annealed
proposal pad across a pause and resume, and the state-dict keys of every
knob."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nmf_tpu import ckpt as jckpt  # noqa: E402
from nmf_tpu import trainer as jtrainer  # noqa: E402
from nmf_tpu.data.blender import load_dataset as jload  # noqa: E402
from nmf_tpu.ops import runs as jruns  # noqa: E402
from nmf_tpu.render import render as jrender  # noqa: E402
from nmf_tpu_torch import ckpt as tckpt  # noqa: E402
from nmf_tpu_torch import train as ttrain  # noqa: E402
from nmf_tpu_torch import trainer as ttrainer  # noqa: E402
from nmf_tpu_torch import weights  # noqa: E402
from nmf_tpu_torch.ops import runs as truns  # noqa: E402
from nmf_tpu_torch.ops.draws import Draws  # noqa: E402
from nmf_tpu_torch.render import render as trender  # noqa: E402
from torch_parity import (build_flagship_pair, build_pair,  # noqa: E402
                          close, grads_match, port_copy, render_draws)

B = 64
DATASET = {"dataset_name": "synthetic_sphere", "n_views": 4,
           "image_size": 16}
PAD = ["model.arch.proposal_pad_init=0.5",
       "model.arch.proposal_pad_iters=10"]
MIPBIAS = 12.0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rays():
    ds = jload(DATASET, None, "train")
    ids = np.random.default_rng(0).choice(ds["all_rays"].shape[0], B,
                                          replace=False)
    return ds["all_rays"][ids], ds["all_rgbs"][ids]


def _flagship(extra):
    """The tiny flagship pair with the envmap's mip bias at 12, as the
    flagship's train-step test builds it."""
    jn, _, cfg = build_flagship_pair(extra)
    jn = jn.replace(bg_module=jn.bg_module.replace(
        mipbias=jnp.asarray(MIPBIAS, jnp.float32)))
    return jn, port_copy(jn, cfg), cfg


# ---- the march -----------------------------------------------------------

@pytest.mark.parametrize("knobs", [
    ["model.arch.sampler.superstep=0"], ["model.arch.sampler.superstep=2"],
    ["model.arch.sampler.superstep=8"],
    ["model.arch.sampler.fine_alpha_test=false"]],
    ids=["superstep0", "superstep2", "superstep8", "no_fine_test"])
def test_march_matches_on_a_mask_with_holes(knobs):
    """The eval march and the jittered train march (nmf_tpu's jitter
    injected) at K = 32 of N = 52 steps, on an alpha mask rebuilt by
    nmf_tpu and carried over: validity exactly, positions to 1e-6 (the
    train march is a cumsum). Superstep 0 has no coarse volume."""
    jn, tn, _ = build_pair("f32", [
        "model.arch.sampler.alphaMask_thres=0.0021", *knobs])
    jn = jn.replace(sampler=jn.sampler.update(jn.rf))
    weights.from_jax_state_dict(tn, jckpt.state_dict(jn))
    vol = np.asarray(jn.sampler.alpha_mask.alpha_volume)
    assert 0.05 < vol.mean() < 0.95
    assert ((tn.sampler.alpha_mask.coarse_volume is None)
            == (jn.sampler.alpha_mask.coarse_volume is None)
            == ("superstep=0" in knobs[0]))
    ds = jload(DATASET, None, "train")
    r = ds["all_rays"][np.random.default_rng(1).choice(
        ds["all_rays"].shape[0], 96, replace=False)]
    keys = jax.random.split(jax.random.PRNGKey(7), 4)
    jitter = np.asarray(jax.random.uniform(keys[0],
                                           (96, jn.sampler.n_samples)))
    for train in (False, True):
        sj = jn.sampler.sample(jnp.asarray(r), key=keys[0], is_train=train,
                               max_samples_per_ray=32)
        st = tn.sampler.sample(torch.from_numpy(r), is_train=train,
                               jitter=torch.from_numpy(jitter),
                               max_samples_per_ray=32)
        np.testing.assert_array_equal(st["valid"].numpy(),
                                      np.asarray(sj["valid"]))
        for k in ("z_vals", "dists", "xyz"):
            np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]),
                                       rtol=1e-6, atol=1e-5, err_msg=k)


# ---- cell runs -----------------------------------------------------------

def test_top_k_breaks_ties_as_jax():
    """top_k_indices picks what jax.lax.top_k picks, in its order, on rows
    full of ties (most entries 0 or -1)."""
    rng = np.random.default_rng(0)
    x = rng.choice([-1.0, 0.0, 0.0, 0.25, 0.5], size=(64, 24)).astype(
        np.float32)
    for k in (1, 5, 24):
        want = np.asarray(jax.lax.top_k(jnp.asarray(x), k)[1])
        got = truns.top_k_indices(torch.from_numpy(x), k).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", ["exact", "fixed"])
def test_cell_indices_match(shape):
    """cell_indices on points in and out of the box, at the field's grid
    or, fixed-shape, at its live resolution inside the padded grid."""
    extra = (["field.fixed_shape=true", "field.upsamp_list=[2]"]
             if shape == "fixed" else [])
    jn, tn, _ = build_pair("f32", extra)
    if shape == "fixed":
        assert tn.rf.live_grid_size != tuple(tn.rf.grid_size)
    xyz = np.random.default_rng(2).uniform(-1.8, 1.8, (500, 4)).astype(
        np.float32)
    np.testing.assert_array_equal(
        truns.cell_indices(tn.rf, torch.from_numpy(xyz)).numpy(),
        np.asarray(jruns.cell_indices(jn.rf, jnp.asarray(xyz))))


def _runs_case(case, Bn=32, K=24):
    """Per-sample cells with runs of 1-6 samples, sorted depths, weights
    and validity: ``ties`` makes the weights multiples of 1/32, so run
    sums are exact in f32 (whatever the order of the cumulative sum) and
    many runs tie; ``zero`` zeroes whole runs; ``invalid`` drops samples
    inside runs (a run never spans one)."""
    rng = np.random.default_rng({"ties": 3, "zero": 4, "invalid": 5}[case])
    run_id = np.cumsum(rng.random((Bn, K)) < 0.35, axis=1)
    cells = np.stack([run_id, run_id // 2, np.zeros_like(run_id)],
                     -1).astype(np.int32)
    z = np.sort(rng.uniform(2, 6, (Bn, K)), 1).astype(np.float32)
    d = rng.uniform(0.01, 0.05, (Bn, K)).astype(np.float32)
    w = rng.uniform(0, 0.2, (Bn, K)).astype(np.float32)
    valid = rng.random((Bn, K)) < 0.9
    if case == "ties":
        w = (np.round(w * 32) / 32).astype(np.float32)
    elif case == "zero":
        w[(run_id % 3) == 0] = 0.0
    else:
        valid = rng.random((Bn, K)) < 0.6
    return cells, z, d, w, valid


def _run_weights(cells, w, valid):
    """The summed weights of one ray's runs (a run ends at a change of
    cell or at an invalid sample), padded with -1 to 7 runs."""
    sums = []
    for i in range(len(w)):
        same = (i > 0 and valid[i] and valid[i - 1]
                and (cells[i] == cells[i - 1]).all())
        if same:
            sums[-1] += w[i] if valid[i] else 0.0
        else:
            sums.append(w[i] if valid[i] else 0.0)
    return np.array(sums + [-1.0] * 7)


@pytest.mark.parametrize("case", ["ties", "zero", "invalid"])
def test_merge_sample_runs_matches(case):
    """merge_sample_runs at 6 slots: the runs kept and their validity
    exactly; the width and weight to 1e-6 and the depth to 1e-4 (each is a
    difference of cumulative sums, of w z up to ~30 for the depth, divided
    by the run's weight; nmf_tpu sums in another order); the gradient of
    the run weights to the sample weights to 1e-6 (a difference of
    reverse cumulative sums of the cotangent)."""
    cells, z, d, w, valid = _runs_case(case)
    if case == "ties":
        # some ray keeps one of two runs of equal weight in its last slot
        assert any(np.ptp(np.sort(_run_weights(c, wr, v))[::-1][5:7]) == 0
                   for c, wr, v in zip(cells, w, valid))
    cot = np.random.default_rng(9).normal(size=(32, 6)).astype(np.float32)

    def jfun(wt):
        out = jruns.merge_sample_runs(jnp.asarray(cells), jnp.asarray(z),
                                      jnp.asarray(d), wt, jnp.asarray(valid),
                                      6)
        return (out[2] * cot).sum(), out
    (_, jout), jg = jax.value_and_grad(jfun, has_aux=True)(jnp.asarray(w))
    tw = torch.tensor(w, requires_grad=True)
    tout = truns.merge_sample_runs(
        torch.from_numpy(cells), torch.from_numpy(z), torch.from_numpy(d),
        tw, torch.from_numpy(valid), 6)
    (tout[2] * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))
    for a, b, what, tol in zip(tout[:3], jout[:3], ("z", "dists", "weight"),
                               (1e-4, 1e-6, 1e-6)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=0, atol=tol, err_msg=what)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-6)


# ---- two-stage and merged shading ----------------------------------------

@pytest.mark.parametrize("base", ["tensorf", "flagship"])
def test_two_stage_acc_map_equals_full_render(base, rays):
    """Two-stage shading's stage-1 density is the fused query's bit for
    bit: its acc_map equals the full render's (gather in bf16, the
    shipped dtype). Setting merge_runs too warns and merges."""
    extra = ["model.arch.app_samples_per_ray=4"]
    if base == "tensorf":
        _, tn, cfg = build_pair("bf16", ["model.arch.max_samples_per_ray=32",
                                         *extra])
    else:
        _, tn, cfg = build_flagship_pair(["field.gather_dtype=bf16",
                                          *extra])
    r = torch.from_numpy(rays[0])
    with torch.no_grad():
        two, _ = trender(tn, r, draws=Draws(torch.Generator()))
        tn.app_samples_per_ray = -1
        full, _ = trender(tn, r, draws=Draws(torch.Generator()))
        assert torch.equal(two["acc_map"], full["acc_map"])
        tn.app_samples_per_ray, tn.merge_runs = 4, 3
        with pytest.warns(UserWarning, match="merge_runs takes precedence"):
            trender(tn, r, draws=Draws(torch.Generator()))


@pytest.mark.parametrize("knob", ["model.arch.merge_runs=6",
                                  "model.arch.app_samples_per_ray=6"],
                         ids=["merge", "two_stage"])
def test_tensorf_budget_train_step_matches(knob, rays):
    """A tensorf train step (K = 32, shading set 6) with merged or
    two-stage shading: the loss, the sample count and every gradient to
    5e-4 of each tensor's largest."""
    jn, tn, cfg = build_pair("f32", ["model.arch.max_samples_per_ray=32",
                                     knob])
    params = cfg["model"]["params"]
    jw = jtrainer.LossWeights(ori_lambda=0.0, pred_lambda=0.0,
                              l1_weight=params["L1_weight_initial"])
    key = jax.random.PRNGKey(3)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda n, r, g: jtrainer.compute_loss(n, r, g, key, jw, jnp.ones(3)),
        has_aux=True))(jn, jnp.asarray(rays[0]), jnp.asarray(rays[1]))
    ttrain.make_optimizer(tn, params, 100)
    tl, tm = ttrainer.compute_loss(
        tn, torch.from_numpy(rays[0]), torch.from_numpy(rays[1]),
        ttrain.make_loss_weights(params), (1.0, 1.0, 1.0),
        draws=Draws(None, render_draws(key, jn, B, True)))
    tl.backward()
    close(float(tl), float(jl), 1e-5, "loss")
    assert int(tm["n_valid_samples"]) == int(jm["n_valid_samples"])
    grads_match(tn, jg, 5e-4)


def test_flagship_merge_and_retrace_proposal_train_step_matches(rays):
    """A flagship train step with merged shading (4 runs of the 16
    samples), the retrace proposal (4 of the retrace pass's 8) and the
    annealed pad, the primary proposal off: the loss and every gradient,
    the BRDF's and the material heads' through the bounce rays among
    them, to 2e-3 of each tensor's largest; the pad's, a sum of
    cancelling terms, to 2e-2 of its own. The proposal's inverse-CDF
    lookups turn ulp differences of the CDF into 1e-3-relative ones of
    the retrace positions."""
    jn, tn, cfg = _flagship(["model.arch.proposal_samples_per_ray=-1",
                             "model.arch.merge_runs=4",
                             "model.arch.recur_proposal_samples_per_ray=4",
                             *PAD])
    params = cfg["model"]["params"]
    jw = jtrainer.LossWeights(ori_lambda=params["ori_lambda"],
                              pred_lambda=params["pred_lambda"],
                              l1_weight=params["L1_weight_initial"])
    key = jax.random.PRNGKey(21)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda n, r, g: jtrainer.compute_loss(n, r, g, key, jw, jnp.ones(3)),
        has_aux=True))(jn, jnp.asarray(rays[0]), jnp.asarray(rays[1]))
    ttrain.make_optimizer(tn, params, 100)
    tl, _ = ttrainer.compute_loss(
        tn, torch.from_numpy(rays[0]), torch.from_numpy(rays[1]),
        ttrain.make_loss_weights(params), (1.0, 1.0, 1.0),
        draws=Draws(None, render_draws(key, jn, B, True)))
    tl.backward()
    close(float(tl), float(jl), 1e-5, "loss")
    assert np.abs(np.asarray(jg.proposal_pad_cur)) > 0
    grads_match(tn, jg, 2e-3, loose=((".proposal_pad_cur", 2e-2),))


def test_retrace_proposal_keeps_gradients_to_the_bounce_rays():
    """render at recursion 1 on 32 bounce rays with the retrace proposal
    and the annealed pad: the images, and the gradients to the bounce
    rays, to the pad and to every tensor against nmf_tpu's (the proposal
    density holds the field still; its weights and the resampled
    positions carry the rays' gradient), to 2e-3 of each one's largest
    and the pad's to 2e-2."""
    jn, tn, _ = _flagship(["model.arch.recur_proposal_samples_per_ray=4",
                           *PAD])
    rng = np.random.default_rng(3)
    T = 32
    dirs = rng.normal(size=(T, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    br = np.concatenate([rng.uniform(-0.6, 0.6, (T, 3)), dirs],
                        -1).astype(np.float32)
    mip = rng.uniform(-6, -2, T).astype(np.float32)
    cot = rng.normal(size=(T, 3)).astype(np.float32)
    key = jax.random.PRNGKey(12)

    def jfun(n, r):
        ims, _ = jrender(n, r, key, is_train=True, bg_col=None, recur=1,
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
                      bg_col=None, recur=1,
                      override_near=3 * tn.sampler.stepsize,
                      stepmul=tn.recur_stepmul, tonemap=False,
                      start_mipval=torch.from_numpy(mip),
                      bg_cache=tn.bg_module.prepare())
    (tims["rgb_map"] * torch.from_numpy(cot)).sum().backward()
    for k in ("rgb_map", "acc_map"):
        close(tims[k].detach().numpy(), jims[k], 1e-5, k)
    assert np.abs(np.asarray(jg[1])).max() > 0
    close(tr.grad.numpy(), jg[1], 2e-3, "d rays")
    grads_match(tn, jg[0], 2e-3, loose=((".proposal_pad_cur", 2e-2),))


def test_primary_proposal_stays_gradient_free(rays):
    """With the annealed pad, the primary pass's proposal takes no
    gradient in the port: the pad's gradient is 0 and every other one is
    nmf_tpu's (to 5e-4). nmf_tpu's resampled positions carry one to the
    pad there (ROADMAP C.11), which only its clip's norm sees."""
    jn, tn, cfg = build_pair("f32", [
        "model.arch.max_samples_per_ray=32",
        "model.arch.proposal_samples_per_ray=16", *PAD])
    params = cfg["model"]["params"]
    jw = jtrainer.LossWeights(ori_lambda=0.0, pred_lambda=0.0,
                              l1_weight=params["L1_weight_initial"])
    key = jax.random.PRNGKey(4)
    _, jg = jax.jit(jax.value_and_grad(
        lambda n, r, g: jtrainer.compute_loss(n, r, g, key, jw, jnp.ones(3)),
        has_aux=True))(jn, jnp.asarray(rays[0]), jnp.asarray(rays[1]))
    ttrain.make_optimizer(tn, params, 100)
    tl, _ = ttrainer.compute_loss(
        tn, torch.from_numpy(rays[0]), torch.from_numpy(rays[1]),
        ttrain.make_loss_weights(params), (1.0, 1.0, 1.0),
        draws=Draws(None, render_draws(key, jn, B, True)))
    tl.backward()
    assert float(np.abs(np.asarray(jg.proposal_pad_cur))) > 0
    pad_grad = tn.proposal_pad_cur.grad
    assert pad_grad is None or float(pad_grad) == 0.0
    jg = jg.replace(proposal_pad_cur=jnp.zeros(()))
    grads_match(tn, jg, 5e-4)


# ---- the annealed pad and the state dict ---------------------------------

def test_pad_anneal_matches_across_pause_and_resume(tmp_path):
    """The pad after each schedule tick 1..14 (10 iterations of anneal
    from 0.5 to 0.01), as nmf_tpu's check_schedule gives it; a checkpoint
    written at 6 and loaded carries the pad on and continues the same
    values."""
    jn, tn, cfg = build_pair("f32", ["model.arch.proposal_samples_per_ray=16",
                                     *PAD])
    assert float(tn.proposal_pad_cur) == 0.5 == float(jn.proposal_pad_cur)
    want = []
    for it in range(1, 15):
        jn, _ = jn.check_schedule(it)
        want.append(np.float32(jn.proposal_pad_cur))
    got = []
    for it in range(1, 7):
        tn.check_schedule(it)
        got.append(np.float32(tn.proposal_pad_cur))
    tckpt.save(tmp_path / "p.th", tn, cfg, extra={"iteration": 6})
    tn, _, _ = tckpt.load(tmp_path / "p.th", device="cpu")
    assert np.float32(tn.proposal_pad_cur) == got[-1]
    for it in range(7, 15):
        tn.check_schedule(it)
        got.append(np.float32(tn.proposal_pad_cur))
    np.testing.assert_array_equal(got, want)
    assert got[-1] == np.float32(0.01)


@pytest.mark.parametrize("knobs", [
    ["model.arch.hdr=true",
     "model.arch.tonemap._target_=modules.tonemap.LinearTonemap",
     "model.arch.mlp_dtype=bf16"],
    ["model.arch.sampler.superstep=0"], ["model.arch.sampler.superstep=1"],
    ["model.arch.sampler.superstep=8",
     "model.arch.sampler.fine_alpha_test=false"],
    ["model.arch.app_samples_per_ray=4", "model.arch.merge_runs=4",
     "model.arch.recur_proposal_samples_per_ray=4", *PAD]],
    ids=["hdr_bf16", "superstep0", "superstep1", "superstep8",
         "budgets"])
def test_knob_state_dict_matches(knobs):
    """Each knob builds in the port with nmf_tpu's state-dict keys and
    shapes, also after a mask rebuild (superstep 0 or 1 keep no coarse
    volume; the annealed pad is ``.proposal_pad_cur``), and a checkpoint
    of it loads back with the knob set."""
    jn, tn, cfg = build_flagship_pair(
        ["model.arch.sampler.update_list=[2]", *knobs])
    for stage in range(2):
        jsd, tsd = jckpt.state_dict(jn), weights.to_jax_state_dict(tn)
        assert sorted(tsd) == sorted(jsd)
        for k, v in jsd.items():
            assert tsd[k].shape == v.shape, k
        jn, _ = jn.check_schedule(2)
        assert tn.check_schedule(2)
    has_coarse = ".sampler.alpha_mask.coarse_volume" in tsd
    assert has_coarse == (tn.sampler.superstep > 1)
    assert (".proposal_pad_cur" in tsd) == (tn.proposal_pad_iters > 0)
    for attr in ("hdr", "tonemap", "app_samples_per_ray", "merge_runs",
                 "recur_proposal_samples_per_ray"):
        assert getattr(tn, attr) == getattr(jn, attr), attr
