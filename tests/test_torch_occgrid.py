"""The occupancy-grid slice of nmf_tpu_torch against nmf_tpu: the encodings
and normal heads, the occupancy-grid sampler, the field's shrink and a tiny
``model=microfacet_tensorf`` (``torch_inputs.OCCGRID``: the flagship's tiny
widths, a 16^3 occupancy grid) built through both packages' builders,
with nmf_tpu's random draws replayed by name.

The occupancy lookup truncates ``unit * G`` to a cell, and the box test
compares with the box's faces, so a 1-ulp difference of a sample position
can flip either at an edge. The march cases keep their samples off both:
training marches start a jittered fraction of a step inside the box, and
the evaluation marches run rays whose first sample, at ``near``, lies
inside the box (``_rays_through``), or start inside it (the retrace and
NDC cases). Cell edges are met with probability ~1e-7 a sample.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nmf_tpu import ckpt as jckpt  # noqa: E402
from nmf_tpu import trainer as jtrainer  # noqa: E402
from nmf_tpu.data.blender import load_dataset as jload  # noqa: E402
from nmf_tpu.modules import render_modules as jrm  # noqa: E402
from nmf_tpu.ops.safemath import integrated_pos_enc as jipe  # noqa: E402
from nmf_tpu.render import render as jrender  # noqa: E402
from nmf_tpu.samplers.occgrid import conical_frustum_radius as jcfr  # noqa
from nmf_tpu.samplers.occgrid import init_occgrid as jinit_occgrid  # noqa
from nmf_tpu_torch import ckpt as tckpt  # noqa: E402
from nmf_tpu_torch import train as ttrain  # noqa: E402
from nmf_tpu_torch import trainer as ttrainer  # noqa: E402
from nmf_tpu_torch import weights  # noqa: E402
from nmf_tpu_torch.fields.tensorf import init_tensorvm_split  # noqa: E402
from nmf_tpu_torch.modules import render_modules as trm  # noqa: E402
from nmf_tpu_torch.ops.draws import Draws  # noqa: E402
from nmf_tpu_torch.ops.safemath import integrated_pos_enc  # noqa: E402
from nmf_tpu_torch.render import render as trender  # noqa: E402
from nmf_tpu_torch.samplers.occgrid import (  # noqa: E402
    conical_frustum_radius, init_occgrid)
from torch_inputs import OCCGRID  # noqa: E402
from torch_parity import (build_pair, close, grads_match,  # noqa: E402
                          port_copy, render_draws)

B = 64
DATASET = {"dataset_name": "synthetic_sphere", "n_views": 4,
           "image_size": 16}
FWD, GRAD = 1e-5, 1e-4
# every envmap lookup spans the whole map (test_torch_flagship.py)
MIPBIAS = 12.0
SHRINK_AT = 16  # a shrink tick that is also a density-sweep tick


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _block_grid():
    """A 16^3 density grid: a block of 1s over 1e-3-scale noise, so that
    after two EMA sweeps of a faint field only the block is occupied."""
    rng = np.random.default_rng(4)
    grid = rng.uniform(0, 1e-3, (16, 16, 16)).astype(np.float32)
    grid[3:9, 4:11, 5:8] = 1.0
    return grid


@pytest.fixture(scope="module")
def occ():
    """The tiny occupancy-grid NMF in nmf_tpu, its density nearly zero
    (density_shift -8), its occupancy grid the block grid after two sweeps
    and its envmap's mip bias MIPBIAS, and its config."""
    jn, _, cfg = build_pair(base=OCCGRID)
    jn = jn.replace(rf=jn.rf.replace(density_shift=-8.0),
                    bg_module=jn.bg_module.replace(
                        mipbias=jnp.asarray(MIPBIAS, jnp.float32)))
    s = jn.sampler.replace(density_grid=jnp.asarray(_block_grid()))
    s = s.update_density(jn.rf).update_density(jn.rf)
    return jn.replace(sampler=s), cfg


def _pair(occ, density_shift=-8.0):
    """nmf_tpu's model and the port's copy of it, at ``density_shift``:
    the renders run the field at its own -4 (acc ~0.3; at -8, 1 - T of
    acc ~1e-3 keeps 1e-4 of its f32 precision)."""
    jn, cfg = occ
    jn = jn.replace(rf=jn.rf.replace(density_shift=density_shift))
    tn = port_copy(jn, cfg)
    tn.rf.density_shift = density_shift
    return jn, tn, cfg


@pytest.fixture(scope="module")
def rays():
    ds = jload(DATASET, None, "train")
    ids = np.random.default_rng(0).choice(ds["all_rays"].shape[0], 2 * B,
                                          replace=False)
    return ds["all_rays"][ids], ds["all_rgbs"][ids]


def _rays_through(aabb, n, seed):
    """Rays in random directions through points c of the middle of
    ``aabb`` (the middle 40% of each side), starting 2.6 before c: the
    march's first sample, at near = 2.5, lies inside the box and not on
    a face."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(aabb, np.float64)
    c = lo + (hi - lo) * rng.uniform(0.3, 0.7, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([c - 2.6 * d, d], -1).astype(np.float32)


def test_reconstruction_on_cpu(tmp_path):
    """model=microfacet_tensorf through the port's CLI on the CPU: density
    sweeps every 4 iterations, a shrink and an upsample, each followed by
    an optimizer rebuild, to the final test eval with its predicted-normal
    maps."""
    lines = []
    _, res = ttrain.reconstruction(ttrain.config_lib.compose([
        *OCCGRID, "device=cpu", "model.params.n_iters=12",
        "model.params.batch_size=64", "model.params.pred_lambda=3e-4",
        "model.arch.sampler.update_freq=4",
        "model.arch.sampler.shrink_iters=[6]", "field.upsamp_list=[9]",
        "dataset.image_size=12", "dataset.n_views=3", f"basedir={tmp_path}",
        "expname=o", "progress_refresh_rate=4"]), log=lines.append)
    assert sum("schedule event" in ln for ln in lines) == 2
    out = tmp_path / "synthetic_sphere_o" / "imgs_test_all"
    assert sorted(p.name for p in (out / "normal").glob("*.png")) == [
        "000.png", "001.png", "002.png"]
    assert np.isfinite(res["loss"]) and res["psnr"] > 5


def _head_case(case, rng, M):
    """(inputs, nmf_tpu fn(params, *inputs), port fn(*inputs), nmf_tpu
    params, port module) of one encoding or normal head."""
    if case == "frustum":
        z0 = rng.uniform(0.1, 6, M).astype(np.float32)
        dz = rng.uniform(0.001, 0.05, M).astype(np.float32)
        r = 1 / np.sqrt(3.0)
        return ([z0, z0 + dz], lambda p, a, b: jcfr(a, b, r),
                lambda a, b: conical_frustum_radius(a, b, r), None, None)
    if case == "ipe":
        return ([rng.uniform(-1, 1, (M, 3)).astype(np.float32),
                 rng.uniform(0, 0.01, (M, 3)).astype(np.float32)],
                lambda p, x, v: jipe((x, v), 0, 12),
                lambda x, v: integrated_pos_enc((x, v), 0, 12), None, None)
    pts = np.concatenate([rng.uniform(-1, 1, (M, 3)),
                          rng.uniform(0, 0.05, (M, 1))], -1)
    ins = [pts.astype(np.float32),
           rng.normal(0, 0.5, (M, 24)).astype(np.float32)]
    if case == "app_dim_normal":
        tm = trm.AppDimNormal()
        return ins, lambda p, x, f: jrm.AppDimNormal()(x, f), tm, None, tm
    kw = {"pospe": -1, "feape": 0} if case == "mlp_normal_features" else {}
    jm = jrm.init_mlp_normal(jax.random.PRNGKey(3), 24, **kw)
    # from its U(-1e-5, 1e-5) start the last layer is scaled to U(-0.1,
    # 0.1), so the gradients are of unit scale
    last = dict(jm.mlp.layers[-1], w=jm.mlp.layers[-1]["w"] * 1e4)
    jm = jm.replace(mlp=jm.mlp.replace(layers=(*jm.mlp.layers[:-1], last)))
    tm = trm.init_mlp_normal(24, **kw)
    assert tm.mlp.layers[-1].bias is None
    for layer, p in zip(tm.mlp.layers, jm.mlp.layers):
        layer.weight.data = torch.tensor(np.asarray(p["w"]).T)
        if p["b"] is not None:
            layer.bias.data = torch.tensor(np.asarray(p["b"]))
    return ins, lambda p, x, f: p(x, f), tm, jm, tm


@pytest.mark.parametrize("case", ["frustum", "ipe", "mlp_normal_features",
                                  "mlp_normal_ipe", "app_dim_normal"])
def test_encodings_and_normal_heads_match(case):
    """The conical-frustum radius, the integrated positional encoding and
    the normal heads (MLPNormal as microfacet_tensorf configures it,
    pospe -1 / feape 0, and at its defaults, pospe 12 / feape -1, whose
    input is [xyz, IPE(xyz, size)]; AppDimNormal): the output and the
    gradients of every input and weight."""
    rng = np.random.default_rng(len(case))
    ins, jf, tf, jp, tm = _head_case(case, rng, 200)
    jout = jf(jp, *map(jnp.asarray, ins))
    cot = rng.normal(size=jout.shape).astype(np.float32)
    jg = jax.grad(lambda p, *a: (jf(p, *a) * cot).sum(),
                  argnums=tuple(range(len(ins) + 1)))(
                      jp, *map(jnp.asarray, ins))
    ts = [torch.tensor(a, requires_grad=True) for a in ins]
    tout = tf(*ts)
    (tout * torch.from_numpy(cot)).sum().backward()
    close(tout.detach().numpy(), jout, FWD, "output")
    for i, (t, g) in enumerate(zip(ts, jg[1:])):
        if t.grad is None:  # an input the head does not read
            assert not np.any(np.asarray(g)), i
            continue
        close(t.grad.numpy(), g, GRAD, f"input {i}")
    if jp is not None:
        for layer, g in zip(tm.mlp.layers, jg[0].mlp.layers):
            close(layer.weight.grad.numpy().T, g["w"], GRAD, "w")
            if g["b"] is not None:
                close(layer.bias.grad.numpy(), g["b"], GRAD, "b")


def test_density_sweeps_occupancy_bounds_and_lookup(occ):
    """Two EMA sweeps over the block grid (the fixture's), the occupancy,
    the occupied box (get_bounds), the nearest-cell lookup at points off
    the cell edges and mark_untrained_grid; and init_occgrid's first
    sweep over the field."""
    jn, tn, _ = _pair(occ)
    close(init_occgrid(tn.rf, grid_reso=16).density_grid.numpy(),
          jinit_occgrid(jn.rf, grid_reso=16).density_grid, FWD, "init")
    ts = tn.sampler
    ts.density_grid = torch.from_numpy(_block_grid())
    ts.update_density(tn.rf)
    ts.update_density(tn.rf)
    js = jn.sampler
    close(ts.density_grid.numpy(), js.density_grid, FWD, "density grid")
    occ_t = ts.occupancy().numpy()
    np.testing.assert_array_equal(occ_t, np.asarray(js.occupancy()))
    assert occ_t.sum() == 6 * 7 * 3
    np.testing.assert_array_equal(ts.get_bounds(), js.get_bounds())
    rng = np.random.default_rng(5)
    cells = rng.integers(0, 16, (500, 3))
    unit = (cells + rng.uniform(0.1, 0.9, (500, 3))) / 16
    aabb = np.asarray(js.aabb)
    pts = (aabb[0] + unit * (aabb[1] - aabb[0])).astype(np.float32)
    np.testing.assert_array_equal(
        ts.occupied_at(torch.from_numpy(pts)).numpy(),
        np.asarray(js.occupied_at(jnp.asarray(pts))))
    poses = jload(DATASET, None, "train")["poses"][:, :3]
    poses = poses * np.array([1, -1, -1, 1], np.float32)  # to OpenCV axes
    intrinsic = [[20.0, 0, 8], [0, 20.0, 8]]
    ts.mark_untrained_grid(poses, intrinsic, (16, 16))
    jmarked = np.asarray(js.mark_untrained_grid(poses, intrinsic,
                                                (16, 16)).density_grid)
    unseen = ts.density_grid.numpy() == -1
    np.testing.assert_array_equal(unseen, jmarked == -1)
    assert 0 < unseen.sum() < 16 ** 3
    close(ts.density_grid.numpy(), jmarked, FWD, "marked grid")


@pytest.mark.parametrize("case", ["train", "eval", "test_multiplier",
                                  "retrace", "ndc_train", "ndc_eval"])
def test_march_matches(case, occ, rays):
    """OccGridSampler.sample on the block grid, compacted to 16 samples a
    ray (8 for the retrace pass): training (the dataset's camera rays,
    jittered), evaluation and evaluation at test_multiplier 2 (rays from
    inside the box), a retrace pass (override_near 3 steps, stepmul 0.5,
    gradients to the rays) and sample_ndc (NDC-like rays starting just
    inside z = -1): every output and, for the retrace pass, the rays'
    gradients."""
    jn, tn, _ = _pair(occ)
    js, ts = jn.sampler, tn.sampler
    is_train = case in ("train", "retrace", "ndc_train")
    kw = {"max_samples_per_ray": 16}
    if case == "train":
        r = rays[0][:B]
    elif case.startswith("ndc"):
        js = js.replace(near_far=(0.0, 1.0))
        ts.near_far = (0.0, 1.0)
        rng = np.random.default_rng(7)
        o = np.concatenate([rng.uniform(-0.8, 0.8, (B, 2)),
                            np.full((B, 1), -0.98)], -1)
        d = np.concatenate([rng.uniform(-0.4, 0.4, (B, 2)),
                            np.full((B, 1), 1.9)], -1)
        r = np.concatenate([o, d], -1).astype(np.float32)
    else:
        r = _rays_through(js.aabb, B, seed=len(case))
    stepmul = 1.0
    if case == "retrace":
        stepmul = 0.5
        kw.update(override_near=3 * js.stepsize, max_samples_per_ray=8)
    if case == "test_multiplier":
        js = js.replace(test_multiplier=2.0)
        ts.test_multiplier = 2.0
    key = jax.random.PRNGKey(len(case))
    ndc = case.startswith("ndc")
    N = js.n_samples if ndc else int(js.n_samples * stepmul)
    jitter = np.asarray(jax.random.uniform(key, (B, N))) if is_train else None

    def jfun(r):
        out = js.sample(r, key=key, is_train=is_train, stepmul=stepmul,
                        ndc_ray=ndc, **kw)
        return (out["xyz"].sum() + out["z_vals"].sum()
                + out["dists"].sum()), out

    (_, jout), jg = jax.jit(jax.value_and_grad(jfun, has_aux=True))(
        jnp.asarray(r))
    tr = torch.tensor(r, requires_grad=True)
    if ndc:
        tout = ts.sample_ndc(tr, is_train=is_train, jitter=(
            None if jitter is None else torch.from_numpy(jitter)),
            max_samples_per_ray=16)
    else:
        tout = ts.sample(tr, is_train=is_train, stepmul=stepmul, jitter=(
            None if jitter is None else torch.from_numpy(jitter)), **kw)
    np.testing.assert_array_equal(tout["valid"].numpy(),
                                  np.asarray(jout["valid"]))
    assert 0 < int(tout["valid"].sum()) < tout["valid"].numel()
    for k in ("xyz", "z_vals", "dists"):
        close(tout[k].detach().numpy(), jout[k], FWD, k)
    if case == "retrace":
        (tout["xyz"].sum() + tout["z_vals"].sum()
         + tout["dists"].sum()).backward()
        close(tr.grad.numpy(), jg, GRAD, "d rays")


@pytest.mark.parametrize("case", ["crop", "aligned", "fixed_shape"])
def test_shrink_matches(case, occ):
    """TensorVMSplit.shrink: the box widened to the voxel lattice, the
    grid sizes and the cropped planes and lines; a box that aligns to the
    current one changes nothing; a fixed-shape field raises."""
    jn, tn, _ = _pair(occ)
    if case == "fixed_shape":
        rf = init_tensorvm_split(torch.Generator().manual_seed(0),
                                 np.asarray(jn.rf.aabb), N_voxel_init=8 ** 3,
                                 N_voxel_final=12 ** 3, upsamp_list=(4,),
                                 fixed_shape=True)
        with pytest.raises(NotImplementedError, match="fixed_shape"):
            rf.shrink(np.asarray(jn.rf.aabb) * 0.5)
        return
    box = (np.array([[-0.62, -0.5, -0.93], [0.71, 0.88, 0.4]], np.float32)
           if case == "crop" else np.asarray(jn.rf.aabb))
    jrf = jn.rf.shrink(box)
    assert tn.rf.shrink(box) == (case == "crop")
    assert (jrf is jn.rf) == (case == "aligned")
    np.testing.assert_array_equal(tn.rf.aabb.numpy(), np.asarray(jrf.aabb))
    assert tn.rf.grid_size == tuple(jrf.grid_size)
    sd = weights.to_jax_state_dict(tn)
    for k, v in jckpt.state_dict(jn.replace(rf=jrf)).items():
        if k.startswith(".rf."):
            np.testing.assert_array_equal(sd[k], v, err_msg=k)
    if case == "crop":
        assert tn.rf.grid_size < (16, 16, 16)


def test_fixed_shape_field_with_the_occupancy_grid_raises():
    """nmf_tpu's builders refuse the pair: the occupancy grid has no
    live-resolution step scaling, and a padded field cannot shrink."""
    from nmf_tpu_torch.builders import build_nmf

    cfg = ttrain.config_lib.compose([*OCCGRID, "field.fixed_shape=true"])
    with pytest.raises(ValueError, match="fixed_shape"):
        build_nmf(cfg["model"]["arch"], np.asarray(
            [[-1.5] * 3, [1.5] * 3], np.float32), (2.5, 5.5), device="cpu")


def _jloss_fn(params):
    jw = jtrainer.LossWeights(ori_lambda=0.1, pred_lambda=0.5,
                              l1_weight=params["L1_weight_initial"])
    return jax.jit(jax.value_and_grad(
        lambda n, r, g, k: jtrainer.compute_loss(n, r, g, k, jw,
                                                 jnp.ones(3)),
        has_aux=True)), jw


def test_eval_render_matches(occ):
    """The primary pass at evaluation (stratified proposal resampling, the
    field with normals, the normal MLP, shade and its retrace) on 64 rays
    through the box (``_rays_through``): the images (the predicted-normal
    map among them) and the recursion-0 statistics, prediction_loss and
    ori_loss among them."""
    jn, tn, _ = _pair(occ, -4.0)
    r = _rays_through(jn.rf.aabb, B, seed=11)
    key = jax.random.PRNGKey(9)
    jims, jst = jax.jit(lambda n, r: jrender(
        n, r, key, is_train=False, draw_debug=True,
        bg_cache=n.bg_module.prepare()))(jn, jnp.asarray(r))
    with torch.no_grad():
        tims, tst = trender(
            tn, torch.from_numpy(r), is_train=False,
            draws=Draws(None, render_draws(key, jn, B, False)),
            draw_debug=True, bg_cache=tn.bg_module.prepare())
    for k in ("rgb_map", "acc_map", "depth", "normal", "world_normal"):
        close(tims[k].numpy(), jims[k], FWD, k)
    for k in ("ori_loss", "prediction_loss", "thin_scale", "distortion_loss",
              "n_valid_samples"):
        close(float(tst[k]), float(jst[k]), FWD, k)
    assert float(tst["prediction_loss"]) > 0


def test_train_step_matches(occ, rays):
    """One train step of the tiny microfacet_tensorf (pred_lambda 0.5, so
    the normal MLP takes a gradient): the loss, every gradient (the normal
    MLP's, the occupancy grid's zero and the normal blend's among them) and
    every tensor after one Adam step. Gradients reached through the
    normals carry the proposal CDF's ulp differences to 5e-4 of a tensor's
    largest (test_torch_flagship.py::test_three_train_steps_match); the
    normal blend's (frozen: it only enters the clip's norm) is a sum of
    such terms of both signs, 1e-8 where they are 1e-6, held to 1e-2."""
    jn, tn, cfg = _pair(occ, -4.0)
    params = dict(cfg["model"]["params"], L1_weight_initial=8e-5,
                  ori_lambda=0.1, pred_lambda=0.5)
    jgrad, _ = _jloss_fn(params)
    r, g = rays[0][:B], rays[1][:B]
    key = jax.random.PRNGKey(20)
    (jl, jm), jg = jgrad(jn, jnp.asarray(r), jnp.asarray(g), key)
    topt = ttrain.make_optimizer(tn, params, 100)
    topt.zero_grad()
    tl, tm = ttrainer.compute_loss(
        tn, torch.from_numpy(r), torch.from_numpy(g),
        ttrain.make_loss_weights(params), (1.0, 1.0, 1.0),
        draws=Draws(None, render_draws(key, jn, B, True)))
    tl.backward()
    close(float(tl), float(jl), FWD, "loss")
    close(float(tm["n_valid_samples"]), float(jm["n_valid_samples"]), FWD,
          "n_valid_samples")
    assert np.abs(np.asarray(jg.normal_module.mlp.layers[0]["w"])).max() > 0
    grads_match(tn, jg, 5e-4, loose=(("predicted_normal_lambda", 1e-2),))
    opt_cfg = jtrainer.OptimConfig(n_iters=100)
    tx = jtrainer.make_optimizer(jn, opt_cfg)
    upd, _ = tx.update(jg, tx.init(jn), jn)
    import optax

    jn1 = optax.apply_updates(jn, upd)
    topt.step()
    # Adam's first step is ~lr * sign(g): an entry whose gradient lies
    # below 1e-3 of its tensor's largest may move differently, by at most
    # 2 lr sched; every other entry is held to 1e-5
    move = 2 * max(ttrainer.group_lrs(tn).values()) * topt.sched(0)
    assert ttrainer.group_lrs(tn)["normal"] == 1e-3
    jgd = jckpt.state_dict(jg)
    for k, v in jckpt.state_dict(jn1).items():
        t, transpose = weights.port_tensor(tn, k)
        tv = t.detach().numpy()
        err = np.abs((tv.T if transpose else tv) - v)
        gk = np.abs(jgd[k])
        tight = gk >= 1e-3 * gk.max()
        assert (err[tight] <= 1e-5 + 1e-5 * np.abs(v[tight])).all(), k
        assert (err <= 1e-5 + move).all(), k


def test_shrink_tick_rebuilds_and_checkpoint_round_trips(occ, tmp_path):
    """check_schedule at a shrink_iters tick (a density sweep too): the
    sweep, the field cropped to the occupied box, the optimizer rebuild
    asked for and the sampler re-derived, as nmf_tpu's; a render after
    it; then the port's checkpoint of the shrunk model loads into a fresh
    model in both packages."""
    jn, tn, cfg = _pair(occ)
    jn = jn.replace(sampler=jn.sampler.replace(shrink_iters=(SHRINK_AT,)))
    tn.sampler.shrink_iters = (SHRINK_AT,)
    jn2, jchanged = jn.check_schedule(SHRINK_AT)
    assert jchanged and tn.check_schedule(SHRINK_AT)
    sd = weights.to_jax_state_dict(tn)
    jsd = jckpt.state_dict(jn2)
    assert sorted(sd) == sorted(jsd)
    for k, v in jsd.items():
        close(sd[k], v, FWD, k)
    assert tn.rf.grid_size == tuple(jn2.rf.grid_size) != (16, 16, 16)
    assert (tn.sampler.n_samples, tn.sampler.stepsize) == (
        jn2.sampler.n_samples, jn2.sampler.stepsize)
    jn2 = jn2.replace(rf=jn2.rf.replace(density_shift=-4.0))
    tn.rf.density_shift = -4.0
    r = _rays_through(jn2.rf.aabb, B, seed=12)
    key = jax.random.PRNGKey(13)
    jims, _ = jax.jit(lambda n, r: jrender(
        n, r, key, is_train=False, bg_cache=n.bg_module.prepare()))(
            jn2, jnp.asarray(r))
    with torch.no_grad():
        tims, _ = trender(tn, torch.from_numpy(r), is_train=False,
                          draws=Draws(None, render_draws(key, jn2, B,
                                                         False)),
                          bg_cache=tn.bg_module.prepare())
    for k in ("rgb_map", "acc_map"):
        close(tims[k].numpy(), jims[k], FWD, k)

    path = tmp_path / "shrunk.th"
    tckpt.save(path, tn, cfg)
    loaded, _, _ = tckpt.load(path, "cpu")
    assert loaded.rf.grid_size == tn.rf.grid_size
    lsd = weights.to_jax_state_dict(loaded)
    for k, v in sd.items():
        np.testing.assert_array_equal(lsd[k], v, err_msg=k)
    jloaded, _, _ = jckpt.load(path)
    for k, v in jckpt.state_dict(jloaded).items():
        np.testing.assert_array_equal(v, sd[k], err_msg=k)
