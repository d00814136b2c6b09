"""Ref-NeRF shading, the DualModel warmup and the predicted-normal blend of
nmf_tpu_torch against nmf_tpu (``models/refnerf.py``, ``render.py``): the
shading with its gradients, a render before and after the dual switch,
the geonorm blend, one train step of ``model=refnerf`` and of
``model=microfacet_dualref`` after its switch (tiny widths,
``torch_inputs``), a clipped optimizer step, checkpoints both ways, the
builds of every shipped model / field pair and tiny CLI runs.

The dual model's microfacet renders follow ``test_torch_flagship.py``:
the envmap's mip bias is 12, so every envmap lookup spans the whole map.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from nmf_tpu import ckpt as jckpt  # noqa: E402
from nmf_tpu import config as jconfig  # noqa: E402
from nmf_tpu import trainer as jtrainer  # noqa: E402
from nmf_tpu.builders import build_nmf as jbuild  # noqa: E402
from nmf_tpu.data.blender import load_dataset as jload  # noqa: E402
from nmf_tpu.render import render as jrender  # noqa: E402
from nmf_tpu_torch import ckpt as tckpt  # noqa: E402
from nmf_tpu_torch import train as ttrain  # noqa: E402
from nmf_tpu_torch import trainer as ttrainer  # noqa: E402
from nmf_tpu_torch import weights  # noqa: E402
from nmf_tpu_torch.builders import build_nmf as tbuild  # noqa: E402
from nmf_tpu_torch.ops.draws import Draws  # noqa: E402
from nmf_tpu_torch.render import render as trender  # noqa: E402
from torch_inputs import DUALREF, REFNERF, REFNERF_TCNN  # noqa: E402
from torch_parity import (AABB, build_pair, close,  # noqa: E402
                          grads_match, port_copy, render_draws)

B = 64
FWD, GRAD = 1e-5, 1e-4
MIPBIAS = 12.0
DATASET = {"dataset_name": "synthetic_sphere", "n_views": 4,
           "image_size": 16}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def refnerf():
    jn, _, cfg = build_pair(base=REFNERF)
    return jn, cfg


@pytest.fixture(scope="module")
def dualref():
    jn, _, cfg = build_pair(base=DUALREF)
    return jn.replace(bg_module=jn.bg_module.replace(
        mipbias=jnp.asarray(MIPBIAS, jnp.float32))), cfg


@pytest.fixture(scope="module")
def rays():
    ds = jload(DATASET, None, "train")
    ids = np.random.default_rng(0).choice(ds["all_rays"].shape[0], B,
                                          replace=False)
    return ds["all_rays"][ids], ds["all_rgbs"][ids]


def _switched(jn, tn, on):
    """Both dual models with ``use_model2`` set to ``on``."""
    tn.model.use_model2 = on
    return jn.replace(model=jn.model.replace(use_model2=on))


def _draws(key, jn, n, is_train):
    """nmf_tpu's draws of a render by the port's names; a dual model past
    its switch draws as its microfacet model (model1 draws nothing)."""
    m = jn.model
    if getattr(m, "use_model2", False):
        jn = jn.replace(model=m.model2)
    return render_draws(key, jn, n, is_train)


def test_shade_matches_with_gradients(refnerf):
    """RefNeRF.shade on random samples: rgb and the debug maps, and the
    gradients of the features, the normals and every weight of the
    material head and the reflection MLP."""
    jn, cfg = refnerf
    tn = port_copy(jn, cfg)
    rng = np.random.default_rng(1)
    M = 300
    xyz = rng.uniform(-1, 1, (M, 4)).astype(np.float32)
    feat = rng.normal(0, 0.5, (M, 24)).astype(np.float32)
    v = rng.normal(size=(M, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    nrm = rng.normal(size=(M, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    v, nrm = v.astype(np.float32), nrm.astype(np.float32)
    cot = rng.normal(size=(M, 3)).astype(np.float32)
    kw = dict(weights=None, valid=None, B=M, render_reflection=None,
              bg_module=None, bg_cache=None, is_train=True, recur=0)

    def jfun(model, f, n):
        rgb, debug = model.shade(xyz, xyz, f, v, n, key=None, **kw)
        return (rgb * cot).sum(), (rgb, debug)

    (_, (jrgb, jdebug)), jg = jax.jit(jax.value_and_grad(
        jfun, argnums=(0, 1, 2), has_aux=True))(
            jn.model, jnp.asarray(feat), jnp.asarray(nrm))
    tf = torch.tensor(feat, requires_grad=True)
    tnrm = torch.tensor(nrm, requires_grad=True)
    rgb, debug = tn.model.shade(torch.from_numpy(xyz), torch.from_numpy(xyz),
                                tf, torch.from_numpy(v), tnrm, draws=None,
                                **kw)
    (rgb * torch.from_numpy(cot)).sum().backward()
    close(rgb.detach().numpy(), jrgb, FWD, "rgb")
    assert sorted(debug) == sorted(jdebug)
    for k, val in debug.items():
        close(val.detach().numpy(), jdebug[k], FWD, k)
    close(tf.grad.numpy(), jg[1], GRAD, "d features")
    close(tnrm.grad.numpy(), jg[2], GRAD, "d normals")
    for key, g in jckpt.state_dict(jg[0]).items():
        t, transpose = weights.port_tensor(tn.model, key)
        if t.grad is None:
            assert not np.any(g), key
            continue
        close(t.grad.numpy().T if transpose else t.grad.numpy(), g, GRAD, key)
    assert tn.model.ref_module.mlp.layers[0].weight.grad.abs().max() > 0


@pytest.mark.parametrize("switched", [False, True], ids=["warmup", "switched"])
def test_dual_render_matches(dualref, rays, switched):
    """A render at evaluation of the tiny dual model: before the switch
    Ref-NeRF shades the primary pass; after it the microfacet model does,
    and Ref-NeRF shades its retrace pass. The images and statistics, and
    the schedule tick that switches (an optimizer rebuild) in both."""
    jn, cfg = dualref
    tn = port_copy(jn, cfg)
    assert not tn.model.use_model2
    if switched:
        jn2, jchanged = jn.check_schedule(3)
        assert jchanged and jn2.model.use_model2
        assert tn.check_schedule(3) and tn.model.use_model2
        assert not tn.check_schedule(4)
        jn = _switched(jn, tn, True)
    else:
        assert not tn.check_schedule(2) and not tn.model.use_model2
    key = jax.random.PRNGKey(9)
    r = rays[0]
    jims, jst = jax.jit(lambda n, r: jrender(
        n, r, key, is_train=False, draw_debug=True,
        bg_cache=n.bg_module.prepare()))(jn, jnp.asarray(r))
    with torch.no_grad():
        tims, tst = trender(tn, torch.from_numpy(r), is_train=False,
                            draws=Draws(None, _draws(key, jn, B, False)),
                            draw_debug=True, bg_cache=tn.bg_module.prepare())
    for k in ("rgb_map", "acc_map", "depth", "tint", "spec", "diffuse"):
        close(tims[k].numpy(), jims[k], FWD, k)
    # the retrace pass's Ref-NeRF has no bounce rays to thin
    assert ("thin_scale" in tst) == switched
    assert "thin_scale_retrace" not in tst and "thin_scale_retrace" not in jst
    for k in ("ori_loss", "brdf_reg", "n_valid_samples",
              *(("thin_scale",) if switched else ())):
        close(float(tst[k]), float(jst[k]), FWD, k)


@pytest.fixture(scope="module")
def tcnn_pair():
    return build_pair(base=REFNERF_TCNN)


@pytest.mark.parametrize("tick", [0, 99, 100, 600, 1100, 2000])
def test_geonorm_blend_matches(tcnn_pair, tick):
    """refnerf_tcnn's blend of predicted and geometric normals (1 from the
    build with use_predicted_normals; geonorm_iters 100,
    geonorm_interp_iters 1000) after a schedule tick."""
    jn, tn, _ = tcnn_pair
    assert float(tn.predicted_normal_lambda) == float(
        jn.predicted_normal_lambda) == 1.0
    jn2, _ = jn.check_schedule(tick)
    tn.check_schedule(tick)
    lam = float(tn.predicted_normal_lambda)
    assert lam == float(jn2.predicted_normal_lambda)
    assert lam == min(max((tick - 100) / 1000, 0.0), 1.0)
    tn.predicted_normal_lambda.fill_(1.0)


def _train_pair(case, refnerf, dualref):
    if case == "refnerf":
        jn, cfg = refnerf
        return jn, port_copy(jn, cfg), cfg
    jn, cfg = dualref
    tn = port_copy(jn, cfg)
    return _switched(jn, tn, True), tn, cfg


def _grads(jn, tn, cfg, rays, key):
    """One train step's loss and gradients in both packages (ori 0.1,
    pred 3e-4, L1 8e-5; a black background, over which no ray clips)."""
    params = dict(cfg["model"]["params"], ori_lambda=0.1, pred_lambda=3e-4,
                  L1_weight_initial=8e-5)
    jw = jtrainer.LossWeights(ori_lambda=0.1, pred_lambda=3e-4,
                              l1_weight=8e-5)
    r, g = rays
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda n, r, g: jtrainer.compute_loss(n, r, g, key, jw,
                                              jnp.zeros(3)),
        has_aux=True))(jn, jnp.asarray(r), jnp.asarray(g))
    opt = ttrain.make_optimizer(tn, params, 100)
    tl, tm = ttrainer.compute_loss(
        tn, torch.from_numpy(r), torch.from_numpy(g),
        ttrain.make_loss_weights(params), (0.0, 0.0, 0.0),
        draws=Draws(None, _draws(key, jn, B, True)))
    tl.backward()
    close(float(tl.detach()), float(jl), FWD, "loss")
    close(float(tm["n_valid_samples"]), float(jm["n_valid_samples"]), FWD)
    return jg, opt, params


@pytest.fixture(scope="module")
def refnerf_step(refnerf, rays):
    """The refnerf train step's models, nmf_tpu's gradients and params,
    the port's gradients in place (computed once for two tests)."""
    jn, tn, cfg = _train_pair("refnerf", refnerf, None)
    jg, _, params = _grads(jn, tn, cfg, rays, jax.random.PRNGKey(21))
    return jn, tn, jg, params


@pytest.mark.parametrize("case", ["refnerf", "dualref_switched"])
def test_train_step_matches(case, refnerf_step, dualref, rays):
    """One train step: the loss and every gradient, the frozen reflection
    MLP's (Ref-NeRF) and sub-models' (DualModel) among them. The march's
    sample positions differ from nmf_tpu's jitted march's by ulps (7e-7
    seen; ROADMAP C.3), and Ref-NeRF's normal MLP reads them through a
    degree-12 integrated positional encoding (scales up to 2^10): its
    gradients and the box's are held to 2e-3 of each tensor's largest
    (1.2e-3 seen). Past the dual switch, gradients reached through the
    bounce directions carry the proposal CDF's ulp differences
    (test_torch_flagship.py::test_three_train_steps_match) and are held to
    5e-4."""
    if case == "refnerf":
        jn, tn, jg, _ = refnerf_step
    else:
        jn, tn, cfg = _train_pair(case, None, dualref)
        jg, _, _ = _grads(jn, tn, cfg, rays, jax.random.PRNGKey(21))
    jgd = jckpt.state_dict(jg)
    ref = (".model.ref_module.mlp.layers[0]['w']" if case == "refnerf"
           else ".model.model1.ref_module.mlp.layers[0]['w']")
    if case == "refnerf":
        assert np.abs(jgd[ref]).max() > 0
        assert np.abs(jgd[".normal_module.mlp.layers[0]['w']"]).max() > 0
    else:
        # Ref-NeRF shades the retrace pass
        assert np.abs(jgd[ref]).max() > 0
        assert np.abs(jgd[".model.model2.brdf.mlp.layers[0]['w']"]).max() > 0
    if case == "refnerf":
        grads_match(tn, jg, GRAD, loose=((".normal_module.", 2e-3),
                                         (".rf.aabb", 2e-3)))
    else:
        grads_match(tn, jg, 5e-4)
    labels = {p: lab for p, _, lab in ttrainer.differentiated_tensors(tn)}
    frozen = [p for p in labels if p.startswith(
        ("model/ref_module", "model/model1", "model/model2"))]
    assert frozen and all(labels[p] == "frozen" for p in frozen)


def test_clipped_step_keeps_the_reflection_mlp(refnerf_step):
    """One optimizer step with clip_grad 10 on the refnerf step's gradients
    rescaled so that the frozen reflection MLP's have norm 20 and the rest
    norm 5: the clip engages only because the frozen tensors count in the
    global norm. Adam's first moments are (1 - b1) x the clipped gradient;
    every tensor after the step equals nmf_tpu's (optax) and the
    reflection MLP does not move."""
    jn, tn, jg, params = refnerf_step
    sd = jckpt.state_dict(jg)
    is_ref = {k: ".model.ref_module." in k for k in sd}
    n_ref = np.sqrt(sum((sd[k] ** 2).sum() for k in sd if is_ref[k]))
    n_rest = np.sqrt(sum((sd[k] ** 2).sum() for k in sd if not is_ref[k]))
    scaled = {k: (v * (20 / n_ref if is_ref[k] else 5 / n_rest)
                  ).astype(np.float32) for k, v in sd.items()}
    jg = jckpt.load_state_dict(jg, scaled, strict=True)
    tx = jtrainer.make_optimizer(jn, jtrainer.OptimConfig(n_iters=100,
                                                          clip_grad=10.0))
    jn1 = jax.jit(lambda g, n: optax.apply_updates(
        n, tx.update(g, tx.init(n), n)[0]))(jg, jn)
    opt = ttrain.make_optimizer(tn, dict(params, clip_grad=10.0), 100)
    index = {id(t): i for i, (t, _) in enumerate(opt.entries)}
    before = {}
    for k, v in scaled.items():
        t, transpose = weights.port_tensor(tn, k)
        t.grad = torch.tensor(v.T if transpose else v)
        before[k] = t.detach().clone()
    opt.step()
    clip = 10.0 / np.sqrt(20.0 ** 2 + 5.0 ** 2)
    for k, v in jckpt.state_dict(jn1).items():
        t, transpose = weights.port_tensor(tn, k)
        tv = t.detach().numpy()
        close(tv.T if transpose else tv, v, FWD, k)
        if id(t) in index:
            m = opt.m[index[id(t)]].numpy()
            close(m.T if transpose else m, 0.1 * clip * scaled[k], FWD, k)
        if is_ref[k]:
            assert torch.equal(t.detach(), before[k]), k


@pytest.mark.parametrize("family", ["refnerf", "refnerf_tcnn", "dualref"])
def test_checkpoint_round_trips(tmp_path, family):
    """A port checkpoint of each family loads into the port and into
    nmf_tpu with every array equal; the dual model's switch is not part of
    it."""
    base = {"refnerf": REFNERF, "refnerf_tcnn": REFNERF_TCNN,
            "dualref": DUALREF}[family]
    _, tn, cfg = build_pair(base=base)
    if family == "dualref":
        tn.model.use_model2 = True
    path = tmp_path / "m.th"
    tckpt.save(path, tn, cfg)
    sd = weights.to_jax_state_dict(tn)
    loaded, _, _ = tckpt.load(path, "cpu")
    assert type(loaded.model) is type(tn.model)
    assert type(loaded.rf) is type(tn.rf)
    if family == "dualref":
        assert not loaded.model.use_model2
    lsd = weights.to_jax_state_dict(loaded)
    jloaded, _, _ = jckpt.load(path)
    jsd = jckpt.state_dict(jloaded)
    assert sorted(sd) == sorted(lsd) == sorted(jsd)
    for k, v in sd.items():
        np.testing.assert_array_equal(lsd[k], v, err_msg=k)
        np.testing.assert_array_equal(jsd[k], v, err_msg=k)


@pytest.mark.parametrize("model,field", [
    ("tensorf", "tensorf"), ("tensorf", "tensorf_og"),
    ("microfacet_tensorf2", "tensorf"), ("microfacet_tensorf", "tensorf"),
    ("microfacet_dual", "tensorf"), ("microfacet_dualref", "tensorf"),
    ("refnerf", "tensorf"), ("refnerf_tcnn", "hashgrid"),
    ("refnerf_tcnn", "tcnn"), ("refnerf_tcnn", "tcnn_split")])
def test_shipped_pairs_build(model, field):
    """Every model / field pair of nmf_tpu's own config-surface test
    (tests/test_train.py) but the grid field builds in the port with the
    same tensors as nmf_tpu's (the weight transfer fills every one) and
    the same hash-field statics, distance_scale kept at 25 as nmf_tpu
    keeps it."""
    ov = [f"model={model}", f"field={field}", "dataset=synthetic_sphere"]
    if field.startswith("tensorf"):
        ov += ["field.N_voxel_init=4096", "field.N_voxel_final=4096",
               "field.upsamp_list=[]"]
    else:
        ov += ["field.log2_hashmap_size=12",
               "model.arch.bg_module.bg_resolution=32"]
    if model in ("microfacet_tensorf", "refnerf_tcnn"):
        ov.append("model.arch.sampler.grid_size=16")
    cfg = jconfig.compose(ov)
    jn = jbuild(jax.random.PRNGKey(0), cfg["model"]["arch"], AABB, (2.0, 6.0))
    tn = tbuild(cfg["model"]["arch"], AABB, (2.0, 6.0), device="cpu")
    weights.from_jax_state_dict(tn, jckpt.state_dict(jn))
    for attr in ("distance_scale", "density_shift", "step_ratio", "lr",
                 "lr_net", "stepsize", "n_samples"):
        assert getattr(tn.rf, attr) == getattr(jn.rf, attr), attr
    assert type(tn.model).__name__ == type(jn.model).__name__
    assert float(tn.predicted_normal_lambda) == float(
        jn.predicted_normal_lambda)


TINY_RUN = ["device=cpu", "model.params.n_iters=6",
            "model.params.batch_size=64", "dataset.image_size=12",
            "dataset.n_views=3", "model.arch.eval_batch_size=144",
            "progress_refresh_rate=2"]


@pytest.mark.parametrize("case", ["refnerf", "refnerf_tcnn", "dual"])
def test_reconstruction_on_cpu(tmp_path, case):
    """Tiny runs through the port's CLI on the CPU to the final eval:
    Ref-NeRF (its tint / spec / diffuse / roughness maps written),
    refnerf_tcnn on the hash field (the blend 0 from the first tick) and
    microfacet_dual (TensoRF warmup, switch at 3, an optimizer rebuild)."""
    base = {"refnerf": REFNERF, "refnerf_tcnn": REFNERF_TCNN,
            "dual": ["model=microfacet_dual", *DUALREF[1:]]}[case]
    lines = []
    nmf, res = ttrain.reconstruction(ttrain.config_lib.compose(
        [*base, *TINY_RUN, f"basedir={tmp_path}", "expname=r"]),
        log=lines.append)
    assert np.isfinite(res["loss"]) and res["psnr"] > 5
    out = tmp_path / "synthetic_sphere_r" / "imgs_test_all"
    for sub in ("tint", "spec", "diffuse", "roughness", "normal"):
        assert len(list((out / sub).glob("*.png"))) == 3, sub
    events = [ln for ln in lines if "schedule event" in ln]
    if case == "dual":
        assert nmf.model.use_model2 and events[0].startswith("iter 2:")
    if case == "refnerf_tcnn":
        assert float(nmf.predicted_normal_lambda.detach()) == 0.0


def test_dualref_resumes_past_its_switch(tmp_path):
    """microfacet_dualref paused at 4 (after its switch at 3) and resumed:
    the resumed model starts on model1 (the switch is not saved) and the
    first tick switches again and rebuilds the optimizer, as nmf_tpu's
    loop does; the run ends with the final checkpoint and eval."""
    ov = [*DUALREF, *TINY_RUN, f"basedir={tmp_path}", "expname=d"]
    lines = []
    _, first = ttrain.reconstruction(ttrain.config_lib.compose(
        [*ov, "stop_iter=4"]), log=lines.append)
    assert first["paused_at"] == 4
    assert [ln for ln in lines if "schedule event" in ln][0].startswith(
        "iter 2:")
    lines.clear()
    nmf, res = ttrain.reconstruction(ttrain.config_lib.compose(
        [*ov, "resume=True"]), log=lines.append)
    assert any(ln.startswith("resume:") and "at iter 4" in ln
               for ln in lines)
    assert [ln for ln in lines if "schedule event" in ln][0].startswith(
        "iter 4:")
    assert nmf.model.use_model2 and np.isfinite(res["psnr"])
    assert (tmp_path / "synthetic_sphere_d" / "synthetic_sphere_d.th").exists()
