"""The train-loop extras of nmf_tpu_torch against nmf_tpu: the loss terms
(Charbonier, the normal error against ground-truth normals, the envmap TV,
the visibility loss), the ori / pred decays, weight decay after the
clip, the bounce-budget controller and its checkpoints, multirun, and the
train split's normals reaching the normal error.

Tolerances: forward 1e-5 and gradients 1e-4 of each output's largest
(``torch_parity.close``); the optimizer's moments and parameters 1e-6
relative; the decayed weights 1e-12 relative (a running product against
nmf_tpu's power).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import nmf_tpu.train as jtrain  # noqa: E402
from nmf_tpu import ckpt as jckpt  # noqa: E402
from nmf_tpu import trainer as jtrainer  # noqa: E402
from nmf_tpu.data.blender import load_dataset as jload  # noqa: E402
from nmf_tpu.render import render as jrender  # noqa: E402
from nmf_tpu_torch import ckpt as tckpt  # noqa: E402
from nmf_tpu_torch import train as ttrain  # noqa: E402
from nmf_tpu_torch import trainer as ttrainer  # noqa: E402
from nmf_tpu_torch import weights  # noqa: E402
from nmf_tpu_torch.ops.draws import Draws  # noqa: E402
from nmf_tpu_torch.render import render as trender  # noqa: E402
from torch_parity import (build_flagship_pair, build_pair,  # noqa: E402
                          close, grads_match, render_draws)

FWD, GRAD = 1e-5, 1e-4
B = 64
VISIBILITY = ("model.arch.model.visibility_module._target_="
              "modules.render_modules.VisibilityMLP")
# the tiny flagship run of the loop tests: bounce budgets small enough
# that the batch asks for > 2x the rays it gets (thin ~0.05)
TINY_RUN = ["model=microfacet_tensorf2", "dataset=synthetic_sphere",
            "device=cpu", "field.N_voxel_init=4096",
            "field.N_voxel_final=8000", "field.upsamp_list=[]",
            "model.arch.sampler.update_list=[]",
            "model.arch.max_samples_per_ray=16",
            "model.arch.recur_samples_per_ray=8",
            "model.arch.proposal_samples_per_ray=8",
            "model.arch.model.brdf_ray_budget=[128,64]",
            "model.arch.model.max_retrace_rays=[32]",
            "model.arch.bg_module.bg_resolution=32",
            "model.params.batch_size=64", "model.params.max_batch_size=64",
            "dataset.image_size=12", "dataset.n_views=3",
            "render_test=false", "progress_refresh_rate=1000"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rays():
    ds = jload({"dataset_name": "synthetic_sphere", "n_views": 4,
                "image_size": 16}, None, "train")
    rng = np.random.default_rng(0)
    ids = rng.choice(ds["all_rays"].shape[0], B, replace=False)
    # the sphere's split has no normals: unit ones, a quarter of the rays
    # without (zeros, which the normal error masks out)
    norms = rng.normal(size=(B, 3))
    norms /= np.linalg.norm(norms, axis=-1, keepdims=True)
    norms = np.where(rng.uniform(size=(B, 1)) < 0.25, 0, norms)
    return ds["all_rays"][ids], ds["all_rgbs"][ids], norms.astype(np.float32)


def test_charbonier_loss_matches(rays):
    """compute_loss with the Charbonier photometric term (tiny tensorf):
    the loss and every gradient."""
    jn, tn, cfg = build_pair()
    r, g, _ = rays
    key = jax.random.PRNGKey(2)
    jw = jtrainer.LossWeights(ori_lambda=0.0, pred_lambda=0.0,
                              l1_weight=8e-5)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda n: jtrainer.compute_loss(
            n, jnp.asarray(r), jnp.asarray(g), key, jw, jnp.ones(3),
            charbonier=True), has_aux=True))(jn)
    ttrainer.Optimizer(tn, ttrainer.OptimConfig())  # gradients on all
    tw = ttrain.make_loss_weights(
        {**cfg["model"]["params"], "charbonier_loss": True})
    assert tw.charbonier and tw.charbonier_eps == 1e-3
    tl, _ = ttrainer.compute_loss(
        tn, torch.from_numpy(r), torch.from_numpy(g), tw, (1.0, 1.0, 1.0),
        draws=Draws(None, render_draws(key, jn, B, True)))
    tl.backward()
    close(float(tl), float(jl), FWD, "loss")
    grads_match(tn, jg, GRAD)


def test_normal_err_and_visibility_loss_match(rays):
    """The primary pass's normal_err against per-ray normals and the
    visibility loss of the tiny flagship with a visibility module, each
    with its own gradient: the visibility loss reaches the visibility MLP
    alone."""
    jn, tn, _ = build_flagship_pair(extra=[VISIBILITY])
    r, _, norms = rays
    key = jax.random.PRNGKey(4)

    def jterms(n):
        _, st = jrender(n, jnp.asarray(r), key, is_train=True,
                        bg_col=jnp.ones(3), gt_normals=jnp.asarray(norms),
                        bg_cache=n.bg_module.prepare())
        return jnp.stack([st["normal_err"], st["visibility_loss"]])

    jv, jjac = jax.jit(lambda n: (jterms(n), jax.jacrev(jterms)(n)))(jn)
    ttrainer.Optimizer(tn, ttrainer.OptimConfig())
    _, st = trender(tn, torch.from_numpy(r), is_train=True,
                    bg_col=(1.0, 1.0, 1.0),
                    draws=Draws(None, render_draws(key, jn, B, True)),
                    bg_cache=tn.bg_module.prepare(),
                    gt_normals=torch.from_numpy(norms))
    for i, name in enumerate(("normal_err", "visibility_loss")):
        assert float(jv[i]) > 0, name
        close(float(st[name].detach()), float(jv[i]), FWD, name)
        for t in tn.parameters():
            t.grad = None
        for _, t, _ in ttrainer.differentiated_tensors(tn):
            t.grad = None
        st[name].backward(retain_graph=True)
        jg = jax.tree_util.tree_map(lambda a, i=i: a[i], jjac)
        grads_match(tn, jg, GRAD)
        vis = [k for k, g in jckpt.state_dict(jg).items() if np.any(g)]
        if name == "visibility_loss":
            assert vis and all(".visibility_module." in k for k in vis)


@pytest.mark.parametrize("init", ["constant", "random"])
def test_envmap_tv_matches(init):
    """IntegralEquirect.tv_loss and its gradient, on the initial map (every
    difference 0, where jnp.abs's slope is +1) and on a random one."""
    jn, tn, _ = build_flagship_pair()
    if init == "random":
        m = np.random.default_rng(5).normal(size=(3, 32, 64)).astype(
            np.float32)
        jbg = jn.bg_module.replace(bg_mat=jnp.asarray(m))
        with torch.no_grad():
            tn.bg_module.bg_mat.copy_(torch.from_numpy(m))
    else:
        jbg = jn.bg_module
    jv, jg = jax.value_and_grad(lambda b: b.tv_loss())(jbg)
    tv = tn.bg_module.tv_loss()
    tv.backward()
    close(float(tv), float(jv), FWD, "tv")
    close(tn.bg_module.bg_mat.grad.numpy(), jg.bg_mat, FWD, "d bg_mat")
    assert np.abs(np.asarray(jg.bg_mat)).max() > 0


def test_weight_decay_follows_the_clip():
    """One optimizer step with weight_decay and clip_grad on the tiny
    tensorf, from the same random gradients: optax's chain clips, then adds
    weight_decay * param, then runs Adam. The first moments (which show the
    order) and the updated tensors."""
    jn, tn, cfg = build_pair()
    params = {**cfg["model"]["params"], "clip_grad": 0.5,
              "weight_decay": 0.3}
    opt = ttrain.make_optimizer(tn, params, 100)
    assert opt.cfg.weight_decay == 0.3 and opt.cfg.clip_grad == 0.5
    entries = {id(t) for t, _ in opt.entries}
    rng = np.random.default_rng(6)
    jgrads = {}
    for k, v in jckpt.state_dict(jn).items():
        t, transpose = weights.port_tensor(tn, k)
        g = (rng.normal(size=v.shape).astype(np.float32)
             if id(t) in entries and v.dtype == np.float32
             else np.zeros(v.shape, v.dtype))
        jgrads[k] = g
        if id(t) in entries:
            t.grad = torch.from_numpy(g.T.copy() if transpose else g)
    jg = jckpt.load_state_dict(jn, jgrads)
    tx = jtrainer.make_optimizer(jn, jtrainer.OptimConfig(
        n_iters=100, clip_grad=0.5, weight_decay=0.3))
    upd, state = tx.update(jg, tx.init(jn), jn)
    jnew = optax.apply_updates(jn, upd)
    opt.step()
    mu = next(s for s in state if isinstance(s, optax.ScaleByAdamState)).mu
    jmu = jckpt.state_dict(mu)
    for (t, _), m in zip(opt.entries, opt.m):
        k = next(k for k in jmu if weights.port_tensor(tn, k)[0] is t)
        _, transpose = weights.port_tensor(tn, k)
        np.testing.assert_allclose((m.T if transpose else m).numpy(),
                                   jmu[k], rtol=1e-6, atol=1e-9, err_msg=k)
    for k, v in jckpt.state_dict(jnew).items():
        t, transpose = weights.port_tensor(tn, k)
        tv = t.detach().numpy()
        np.testing.assert_allclose(tv.T if transpose else tv, v, rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def _record_steps(monkeypatch):
    """Wrap the trainer's train_step: each call's loss weights, the
    model's bounce budgets and the ground-truth normals it was given."""
    calls = []
    step = ttrainer.train_step

    def recorded(nmf, opt, rays, rgb_gt, bg_col, weights_, **kw):
        calls.append({"weights": weights_, "rays": rays,
                      "gt_normals": kw.get("gt_normals"),
                      "budgets": (nmf.model.brdf_ray_budget,
                                  nmf.model.max_retrace_rays)})
        return step(nmf, opt, rays, rgb_gt, bg_col, weights_, **kw)

    monkeypatch.setattr(ttrainer, "train_step", recorded)
    return calls


def test_decays_over_iterations_and_on_resume(tmp_path, monkeypatch):
    """final_ori_lambda / final_pred_lambda: the weights of iteration it are
    nmf_tpu's make_loss_weights(params, it, decay ** it, ...) with its
    decay exp(log(final / start) / n_iters) (nmf_tpu/train.py:284-291), in
    a run and in a run paused at 4 and resumed."""
    n = 8
    ov = [*TINY_RUN, f"model.params.n_iters={n}",
          "model.params.final_ori_lambda=0.01",
          "model.params.final_pred_lambda=3e-5", f"basedir={tmp_path}"]
    calls = _record_steps(monkeypatch)
    ttrain.reconstruction(ttrain.config_lib.compose([*ov, "expname=a"]),
                          log=lambda s: None)
    ttrain.reconstruction(ttrain.config_lib.compose(
        [*ov, "expname=b", "stop_iter=4"]), log=lambda s: None)
    ttrain.reconstruction(ttrain.config_lib.compose(
        [*ov, "expname=b", "resume=true"]), log=lambda s: None)
    params = ttrain.config_lib.compose(ov)["model"]["params"]
    decay = {k: math.exp(math.log(params[f"final_{k}_lambda"]
                                  / params[f"{k}_lambda"]) / n)
             for k in ("ori", "pred")}
    assert len(calls) == 2 * n
    for i, call in enumerate(calls):
        it = i % n
        jw = jtrain.make_loss_weights(params, it, decay["ori"] ** it,
                                      decay["pred"] ** it)
        for name in ("ori_lambda", "pred_lambda"):
            np.testing.assert_allclose(getattr(call["weights"], name),
                                       getattr(jw, name), rtol=1e-12,
                                       err_msg=f"{name} at {it}")
    assert calls[-1]["weights"].ori_lambda == pytest.approx(
        0.1 * (0.01 / 0.1) ** ((n - 1) / n))


def test_budget_controller_decisions():
    """Every 16 steps: x2 while the least thinning factor is < 0.5, up to
    adapt_brdf_budget_max; never down (nmf_tpu/train.py:456-485)."""

    class Model:
        brdf_ray_budget, max_retrace_rays = (100, 40), (8,)

    model = Model()
    ctl = ttrain.BudgetController({"adapt_brdf_budget": True,
                                   "adapt_brdf_budget_max": 4}, model,
                                  log=lambda s: None)
    thin = {15: (0.9, 0.4), 31: (0.6, 0.7), 47: (0.3, 0.9), 63: (0.1, 0.1),
            79: (0.99, 0.99)}
    seen = []
    for it in range(80):
        ts, tr = thin.get(it, (0.0, 0.0))
        ctl.after_step(it, {"thin_scale": ts, "thin_scale_retrace": tr})
        seen.append(ctl.mult)
    assert seen[15] == 2 and seen[31] == 2 and seen[47] == 4
    assert seen[63] == 4 and seen[79] == 4 and seen[14] == 1
    assert model.brdf_ray_budget == (400, 160)
    assert model.max_retrace_rays == (32,)
    with ctl.at_base():
        assert model.brdf_ray_budget == (100, 40)
    assert model.max_retrace_rays == (32,)
    off = ttrain.BudgetController({}, Model(), log=lambda s: None)
    off.after_step(15, {"thin_scale": 0.0})
    assert off.mult == 1 and not off.on


def test_budget_mult_checkpoints(tmp_path, monkeypatch):
    """A run that grows its budgets at 15, paused at 20 and resumed: the
    pause checkpoint holds the grown budgets and budget_mult 2, the resumed
    steps run at them, the growth at 31 reaches x4 and the final
    checkpoint holds the configured budgets. nmf_tpu reads the pause
    checkpoint and its resume rule (budgets // budget_mult) gives the
    configured ones; the port reads a pause checkpoint written by nmf_tpu
    and divides as nmf_tpu's resume does."""
    ov = [*TINY_RUN, "model.params.n_iters=40",
          "model.params.adapt_brdf_budget=true", f"basedir={tmp_path}",
          "expname=g"]
    calls = _record_steps(monkeypatch)
    ttrain.reconstruction(ttrain.config_lib.compose([*ov, "stop_iter=20"]),
                          log=lambda s: None)
    folder = tmp_path / "synthetic_sphere_g"
    latest = folder / "synthetic_sphere_g_latest.th"
    _, cfg, extra = tckpt.load(latest, "cpu")
    assert extra["budget_mult"] == 2
    assert cfg["model"]["arch"]["model"]["brdf_ray_budget"] == [256, 128]
    jn, _, jextra = jckpt.load(latest)
    assert jn.model.brdf_ray_budget == (256, 128)
    assert tuple(b // jextra["budget_mult"]
                 for b in jn.model.brdf_ray_budget) == (128, 64)
    _, res = ttrain.reconstruction(ttrain.config_lib.compose(
        [*ov, "resume=true"]), log=lambda s: None)
    # the growth after step 15 takes effect from step 16
    assert [c["budgets"] for c in calls[14:17]] == [
        ((128, 64), (32,)), ((128, 64), (32,)), ((256, 128), (64,))]
    assert calls[20]["budgets"] == ((256, 128), (64,))
    assert calls[32]["budgets"] == ((512, 256), (128,))
    assert res["budget_mult"] == 4
    nmf, _, _ = tckpt.load(folder / "synthetic_sphere_g.th", "cpu")
    assert nmf.model.brdf_ray_budget == (128, 64)

    # a pause checkpoint as nmf_tpu's loop writes it: the configured
    # budgets in the config, the grown ones on its model, budget_mult 2
    jn2 = jn.replace(model=jn.model.replace(brdf_ray_budget=(256, 128)))
    jpath = tmp_path / "j_latest.th"
    jckpt.save(jpath, jn2, ttrain.config_lib.compose(ov),
               extra={"iteration": 20, "budget_mult": 2})
    tn, _, textra = tckpt.load(jpath, "cpu")
    jn3, _, _ = jckpt.load(jpath)
    ctl = ttrain.BudgetController({"adapt_brdf_budget": True}, tn.model,
                                  mult=textra["budget_mult"],
                                  log=lambda s: None)
    assert ctl.base[0] == tuple(b // 2 for b in jn3.model.brdf_ray_budget)


def test_multirun_jobs_match_nmf_tpu(tmp_path, monkeypatch):
    """expand_multirun gives nmf_tpu's jobs (comma lists swept, bracketed
    lists kept, the cartesian product in order), multirun gives its
    expnames, two tiny jobs write two run folders, and a failing job stops
    the sweep."""
    argv = ["dataset=synthetic_sphere,synthetic_studio",
            "model.params.n_iters=1,2", "field.upsamp_list=[2,3]",
            "expname=s"]
    assert ttrain.expand_multirun(argv) == jtrain._expand_multirun(argv)
    names = {}
    for mod, fn in ((jtrain, "_dispatch"), (ttrain, "dispatch")):
        seen = names.setdefault(mod.__name__, [])
        monkeypatch.setattr(mod, fn, lambda cfg, seen=seen, **kw: seen.append(
            (cfg["dataset"]["scenedir"], cfg["expname"])))
    monkeypatch.setattr("builtins.print", lambda *a, **k: None)
    jtrain.multirun(argv)
    ttrain.multirun(argv, log=lambda s: None)
    assert names["nmf_tpu_torch.train"] == names["nmf_tpu.train"]
    assert len(names["nmf_tpu.train"]) == 4
    monkeypatch.undo()

    tiny = ["model=tensorf", "dataset=synthetic_sphere", "device=cpu",
            "model.params.n_iters=1,2", "model.params.batch_size=64",
            "field.N_voxel_init=4096", "field.N_voxel_final=8000",
            "field.upsamp_list=[]", "model.arch.sampler.update_list=[]",
            "model.arch.max_samples_per_ray=32", "dataset.image_size=16",
            "dataset.n_views=2", "N_vis=1", f"basedir={tmp_path}",
            "expname=m"]
    results = ttrain.main(["-m", *tiny])
    assert len(results) == 2
    for n in (1, 2):
        folder = tmp_path / f"synthetic_sphere_m-n_iters{n}"
        assert (folder / "config.yaml").exists()
        assert (folder / f"synthetic_sphere_m-n_iters{n}.th").exists()

    calls = []

    def failing(cfg, **kw):
        calls.append(cfg["expname"])
        raise RuntimeError("job failed")

    monkeypatch.setattr(ttrain, "dispatch", failing)
    with pytest.raises(RuntimeError):
        ttrain.multirun(tiny, log=lambda s: None)
    assert calls == ["m-n_iters1"]


def test_train_normals_reach_normal_err(tmp_path, monkeypatch):
    """A train split with all_norms: each step gets the normals of its rays
    from the store, and the primary pass's normal_err is taken against
    them."""
    ds = {}
    load = ttrain.load_dataset

    def with_norms(cfg, datadir, split="train"):
        out = load(cfg, datadir, split=split)
        if split == "train":
            n = np.random.default_rng(7).normal(
                size=(out["all_rays"].shape[0], 3))
            out["all_norms"] = (n / np.linalg.norm(n, axis=-1, keepdims=True)
                                ).astype(np.float32)
            ds.update(out)
        return out

    errs = []
    render = ttrainer.render

    def recorded_render(*args, **kwargs):
        ims, stats = render(*args, **kwargs)
        errs.append(float(stats["normal_err"].detach()))
        return ims, stats

    monkeypatch.setattr(ttrain, "load_dataset", with_norms)
    monkeypatch.setattr(ttrainer, "render", recorded_render)
    calls = _record_steps(monkeypatch)
    ttrain.reconstruction(ttrain.config_lib.compose([
        *TINY_RUN, "model.params.n_iters=3",
        "model.params.normal_err_lambda=1e-4", f"basedir={tmp_path}",
        "expname=n"]), log=lambda s: None)
    assert len(calls) == 3 and all(e > 0 for e in errs)
    rays = ds["all_rays"]
    for call in calls:
        got = call["rays"].numpy()
        ids = [int(np.flatnonzero((rays == row).all(-1))[0]) for row in got]
        np.testing.assert_array_equal(call["gt_normals"].numpy(),
                                      ds["all_norms"][ids])
