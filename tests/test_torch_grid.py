"""The dense voxel field (``fields/grid.py``) and the scene union
(``fields/listrf.py``) of nmf_tpu_torch against nmf_tpu's: the trilinear
query with its closed-form normals and their gradients (points on cell
faces and outside the box included), the upsample, the regularizers, one
train step of the tiny flagship on the grid field (``torch_inputs.GRID``)
with nmf_tpu's random draws replayed by name, the union's box, density,
appearance and normals, a render through it, and the weights and
checkpoints of both."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nmf_tpu import ckpt as jckpt  # noqa: E402
from nmf_tpu import trainer as jtrainer  # noqa: E402
from nmf_tpu.data.blender import load_dataset as jload  # noqa: E402
from nmf_tpu.fields import grid as jgrid  # noqa: E402
from nmf_tpu.fields import listrf as jlist  # noqa: E402
from nmf_tpu.render import render as jrender  # noqa: E402
from nmf_tpu_torch import ckpt as tckpt  # noqa: E402
from nmf_tpu_torch import train as ttrain  # noqa: E402
from nmf_tpu_torch import trainer as ttrainer  # noqa: E402
from nmf_tpu_torch import weights  # noqa: E402
from nmf_tpu_torch.fields import grid as tgrid  # noqa: E402
from nmf_tpu_torch.fields import listrf as tlist  # noqa: E402
from nmf_tpu_torch.ops.draws import Draws  # noqa: E402
from nmf_tpu_torch.render import render as trender  # noqa: E402
from torch_inputs import GRID  # noqa: E402
from torch_parity import (build_pair, close, grads_match,  # noqa: E402
                          render_draws)

FWD, GRAD = 1e-5, 1e-4
# the flagship tests' tolerance of gradients reached through the normals
# (tests/test_torch_flagship.py::test_three_train_steps_match)
NORMAL_GRAD = 5e-4
B = 64
# an off-centre box and a grid of three different sizes: every axis its
# own extent and resolution
BOX = np.array([[-1.2, -1.0, -0.8], [1.0, 1.3, 0.9]], np.float32)
GS = (7, 5, 6)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _field_pair(seed=0, aabb=BOX, gs=GS, activation="softplus"):
    """nmf_tpu's grid field with volumes of unit scale (its U(0, 0.1)
    start gives normals of a near-constant field) and the port's copy."""
    jrf = jgrid.init_grid_rf(jax.random.PRNGKey(seed), aabb, grid_size=gs,
                             app_dim=24, activation=activation)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed + 100))
    jrf = jrf.replace(
        density_grid=jax.random.normal(k1, jrf.density_grid.shape),
        app_grid=jax.random.normal(k2, jrf.app_grid.shape))
    trf = tgrid.init_grid_rf(None, aabb, grid_size=gs, app_dim=24,
                             activation=activation)
    trf.load_jax_leaves({"density_grid": np.asarray(jrf.density_grid),
                         "app_grid": np.asarray(jrf.app_grid)})
    return jrf, trf


def _grid_points(rng, n, aabb=BOX, gs=GS):
    """Points in and around the box: some exactly on cell faces of every
    axis (the floor changes corners there), some on the box's faces and
    some outside (the zero-weight corners)."""
    lo, hi = aabb
    x = rng.uniform(lo - 0.3, hi + 0.3, (n, 3)).astype(np.float32)
    for j in range(3):
        k = rng.integers(0, gs[j], n // 4)
        x[j * (n // 4):(j + 1) * (n // 4), j] = (
            lo[j] + k * (hi[j] - lo[j]) / (gs[j] - 1))
    x[-6:-3] = lo
    x[-3:] = hi
    return np.concatenate([x, rng.uniform(0, 0.05, (n, 1))],
                          -1).astype(np.float32)


def test_table_layout_and_geometry():
    """Rows of 28 f32 columns (density, 24 appearance channels, 3
    zeros); the views give nmf_tpu's volumes back; the step in f64 from
    the f32 extent, the sample count from its norm."""
    jrf, trf = _field_pair()
    assert tuple(trf.grid_rows.shape) == (7 * 5 * 6, 28)
    assert not trf.grid_rows[:, 25:].any()
    np.testing.assert_array_equal(trf.density_grid.detach().numpy(),
                                  np.asarray(jrf.density_grid))
    np.testing.assert_array_equal(trf.app_grid.detach().numpy(),
                                  np.asarray(jrf.app_grid))
    assert trf.stepsize == jrf.stepsize
    assert trf.n_samples == jrf.n_samples
    assert trf.fused_normals_ok and jrf.fused_normals_ok
    assert trf.check_schedule(0) is False


@pytest.mark.parametrize("grad", [False, True], ids=["eval", "train"])
def test_compute_all_matches(grad):
    """Density, appearance and normals against nmf_tpu's compute_all,
    under no_grad and with gradients on; the density alone too. nmf_tpu
    runs op by op: jitted, XLA's fused arithmetic moves the points on cell
    faces to the other side of the floor (ROADMAP C.3)."""
    jrf, trf = _field_pair()
    x = _grid_points(np.random.default_rng(1), 400)
    jsig, japp, jn = jrf.compute_all(jnp.asarray(x), with_normals=True)
    with torch.set_grad_enabled(grad):
        sig, app, n = trf.compute_all(torch.from_numpy(x), with_normals=True)
    assert n.requires_grad == grad
    for a, b, what in ((sig, jsig, "sigma"), (app, japp, "app"),
                       (n, jn, "normals")):
        close(a.detach().numpy(), b, FWD, what)
    close(trf.compute_densityfeature(torch.from_numpy(x)).detach().numpy(),
          jsig, FWD, "compute_densityfeature")
    raw = trf.compute_densityfeature(torch.from_numpy(x), activate=False)
    close(raw.detach().numpy(), jrf.compute_densityfeature(
        jnp.asarray(x), activate=False), FWD, "raw density")


@pytest.mark.parametrize("activation", ["exp", "relu"])
def test_activations_match(activation):
    jrf, trf = _field_pair(activation=activation)
    x = _grid_points(np.random.default_rng(2), 200)
    close(trf.compute_densityfeature(torch.from_numpy(x)).detach().numpy(),
          jrf.compute_densityfeature(jnp.asarray(x)), FWD, activation)


def test_normal_loss_gradients_match():
    """A loss on the normals, the density and the appearance: the volumes'
    gradients (through the one gather of the table) and the points' (a
    retrace pass's) against jax.grad, second order through the normals;
    then a loss on the normals alone."""
    jrf, trf = _field_pair()
    rng = np.random.default_rng(3)
    x = _grid_points(rng, 120)
    cn, cs, ca = (rng.normal(size=s).astype(np.float32)
                  for s in ((120, 3), (120,), (120, 24)))

    def jloss(rf, pts, w):
        sig, app, n = rf.compute_all(pts, with_normals=True)
        return (n * cn).sum() + w * ((sig * cs).sum() + (app * ca).sum())

    jgrad = jax.value_and_grad(jloss, argnums=(0, 1))  # op by op
    for w in (1.0, 0.0):
        jl, (jg_rf, jg_x) = jgrad(jrf, jnp.asarray(x), w)
        trf.zero_grad()
        tx = torch.tensor(x, requires_grad=True)
        sig, app, n = trf.compute_all(tx, with_normals=True)
        loss = (n * torch.from_numpy(cn)).sum() + w * (
            (sig * torch.from_numpy(cs)).sum()
            + (app * torch.from_numpy(ca)).sum())
        loss.backward()
        close(float(loss.detach()), float(jl), FWD)
        close(tx.grad.numpy(), jg_x, GRAD, "d points")
        g = trf.jax_leaves(trf.grid_rows.grad)
        assert np.abs(np.asarray(jg_rf.density_grid)).max() > 0
        close(g["density_grid"].numpy(), jg_rf.density_grid, GRAD,
              "d density_grid")
        close(g["app_grid"].numpy(), jg_rf.app_grid, GRAD, "d app_grid")
        assert not trf.grid_rows.grad[:, 25:].any()


@pytest.mark.parametrize("target", [(9, 9, 9), (4, 8, 6)], ids=str)
def test_upsample_matches(target):
    """Both volumes resampled align-corners; a non-cubic target read as
    nmf_tpu reads it (the volumes (C, t0, t1, t2), grid_size the
    target)."""
    jrf, trf = _field_pair()
    jup = jrf.upsample(target)
    trf.upsample(target)
    assert trf.grid_size == jup.grid_size
    for k in ("density_grid", "app_grid"):
        close(getattr(trf, k).detach().numpy(), getattr(jup, k), FWD, k)
    x = _grid_points(np.random.default_rng(4), 100)
    close(trf.compute_densityfeature(torch.from_numpy(x)).detach().numpy(),
          jup.compute_densityfeature(jnp.asarray(x)), FWD, "query")


def test_regularizers_match():
    jrf, trf = _field_pair()
    for name in ("density_L1", "tv_loss_density", "tv_loss_app",
                 "vector_comp_diffs"):
        close(float(getattr(trf, name)().detach()),
              float(getattr(jrf, name)()), FWD, name)


def test_grid_flagship_train_step_matches():
    """One train step of the tiny flagship on the grid field (the slice as
    a whole): the loss and every gradient, the volumes' from the table's
    one gather through the normals too, at the flagship tests'
    tolerances; the table trains as rf_grid."""
    jn, tn, cfg = build_pair(base=GRID)
    jn = jn.replace(bg_module=jn.bg_module.replace(
        mipbias=jnp.asarray(12.0, jnp.float32)))
    with torch.no_grad():
        tn.bg_module.mipbias.fill_(12.0)
    ds = jload({"dataset_name": "synthetic_sphere", "n_views": 4,
                "image_size": 16}, None, "train")
    ids = np.random.default_rng(0).choice(ds["all_rays"].shape[0], B,
                                          replace=False)
    r, g = ds["all_rays"][ids], ds["all_rgbs"][ids]
    params = cfg["model"]["params"]
    jw = jtrainer.LossWeights(ori_lambda=params["ori_lambda"],
                              pred_lambda=params["pred_lambda"],
                              l1_weight=params["L1_weight_initial"])
    key = jax.random.PRNGKey(7)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda n, r, g: jtrainer.compute_loss(n, r, g, key, jw, jnp.ones(3)),
        has_aux=True))(jn, jnp.asarray(r), jnp.asarray(g))
    ttrain.make_optimizer(tn, params, 100)
    tl, tm = ttrainer.compute_loss(
        tn, torch.from_numpy(r), torch.from_numpy(g),
        ttrain.make_loss_weights(params), (1.0, 1.0, 1.0),
        draws=Draws(None, render_draws(key, jn, B, True)))
    tl.backward()
    close(float(tl), float(jl), FWD, "loss")
    for k in ("photo_mse", "thin_scale", "n_valid_samples"):
        close(float(tm[k]), float(jm[k]), FWD, k)
    assert np.abs(jckpt.state_dict(jg)[".rf.density_grid"]).max() > 0
    grads_match(tn, jg, NORMAL_GRAD)
    labels = {p: lab for p, _, lab in ttrainer.differentiated_tensors(tn)}
    assert labels["rf/grid_rows"] == "rf_grid"


def _listrf_pair():
    """Two grid fields of other sizes and boxes, the second shifted and
    rotated about z, in both packages."""
    j1, t1 = _field_pair(seed=0)
    box2 = np.array([[-0.9, -0.7, -1.0], [0.8, 0.6, 0.7]], np.float32)
    j2, t2 = _field_pair(seed=1, aabb=box2, gs=(5, 6, 4))
    c, s = np.cos(0.6), np.sin(0.6)
    rot = np.stack([np.eye(3), [[c, -s, 0], [s, c, 0], [0, 0, 1]]])
    offsets = [[0.0, 0.0, 0.0], [0.7, -0.2, 0.3]]
    jl = jlist.make_listrf([j1, j2], offsets=offsets, rotations=rot)
    tl = tlist.make_listrf([t1, t2], offsets=offsets, rotations=rot)
    return jl, tl


def test_listrf_matches():
    """The union box, stepsize and sample count; the max density, the
    appearance and rotated normals of the densest field, on points in
    either field, in both and in neither (where the two densities tie and
    the first field wins, as jnp.argmax picks)."""
    jl, tl = _listrf_pair()
    np.testing.assert_array_equal(tl.aabb.numpy(), np.asarray(jl.aabb))
    assert tl.stepsize == jl.stepsize and tl.n_samples == jl.n_samples
    rng = np.random.default_rng(5)
    x = _grid_points(rng, 120, aabb=np.asarray(jl.aabb))
    x[:20, :3] = 5.0  # outside both: equal densities
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    with torch.no_grad():
        close(tl.compute_densityfeature(tx).numpy(),
              jl.compute_densityfeature(jx), FWD, "density")
        close(tl.compute_appfeature(tx).numpy(), jl.compute_appfeature(jx),
              FWD, "app")
        close(tl.compute_normals(tx).numpy(), jl.compute_normals(jx), FWD,
              "normals")
    which = np.asarray(jl._argmax_field(jx))
    assert (which == 0).any() and (which == 1).any() and (which[:20] == 0).all()


def test_listrf_render_matches():
    """A tiny model=tensorf whose field is the union of two grid fields:
    the eval render against nmf_tpu's; the union's fields are frozen."""
    jn, tn, _ = build_pair(extra=["field=grid", "field.grid_size=[8,8,8]"])
    jl, tl = _listrf_pair()
    jn = jn.replace(rf=jl)
    jn = jn.replace(sampler=jn.sampler.update(jl, init=True))
    tn.rf = tl
    tn.sampler.update(tl, init=True)
    ds = jload({"dataset_name": "synthetic_sphere", "n_views": 2,
                "image_size": 16}, None, "test")
    rays = ds["all_rays"][::4][:B]
    jims, _ = jrender(jn, jnp.asarray(rays), jax.random.PRNGKey(0),
                      is_train=False, bg_col=(1.0, 1.0, 1.0))
    with torch.no_grad():
        tims, _ = trender(tn, torch.from_numpy(rays), is_train=False)
    close(tims["acc_map"].numpy(), jims["acc_map"], FWD, "acc")
    close(tims["rgb_map"].numpy(), jims["rgb_map"], FWD, "rgb")
    labels = {p: lab for p, _, lab in ttrainer.differentiated_tensors(tn)}
    assert labels["rf/fields/0/grid_rows"] == "frozen"


@pytest.mark.parametrize("which", ["grid", "listrf"])
def test_weights_and_checkpoint_round_trip(tmp_path, which):
    """The port's state dict has nmf_tpu's keys, shapes and values (a
    union's nested fields, offsets, rotations and box); it loads into a
    fresh port model, and a checkpoint written by the port reads back with
    every array; nmf_tpu reads the grid field's."""
    jn, tn, cfg = build_pair(base=GRID)
    if which == "listrf":
        jl, tl = _listrf_pair()
        jn = jn.replace(rf=jl)
        jn = jn.replace(sampler=jn.sampler.update(jl, init=True))
        tn.rf = tl
        tn.sampler.update(tl, init=True)
    jsd = jckpt.state_dict(jn)
    tsd = weights.to_jax_state_dict(tn)
    assert sorted(tsd) == sorted(jsd)
    for k, v in jsd.items():
        assert tsd[k].shape == v.shape, k
        close(tsd[k], v, FWD, k)
    path = tmp_path / "m.th"
    tckpt.save(path, tn, cfg)
    back, _, _ = tckpt.load(path, "cpu")
    assert type(back.rf) is type(tn.rf)
    bsd = weights.to_jax_state_dict(back)
    for k, v in tsd.items():
        np.testing.assert_array_equal(bsd[k], v, err_msg=k)
    assert back.sampler.n_samples == tn.sampler.n_samples
    if which == "grid":
        jback, _, _ = jckpt.load(path)
        for k, v in jckpt.state_dict(jback).items():
            np.testing.assert_array_equal(np.asarray(v), tsd[k], err_msg=k)
