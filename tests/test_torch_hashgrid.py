"""The hash-grid field of nmf_tpu_torch against nmf_tpu's
(``fields/hashgrid.py``): the spatial hash, the encoding, the fused query
with autograd normals and the gradients of a loss on the normals, and one
train step of a tiny ``model=refnerf_tcnn field=hashgrid`` (4 levels,
tables of 2^12 rows, finest resolution 64, a 16^3 occupancy grid), with
weights carried by ``weights.from_jax_state_dict`` and nmf_tpu's random
draws replayed by name."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nmf_tpu import ckpt as jckpt  # noqa: E402
from nmf_tpu import trainer as jtrainer  # noqa: E402
from nmf_tpu.data.blender import load_dataset as jload  # noqa: E402
from nmf_tpu.fields import hashgrid as jhash  # noqa: E402
from nmf_tpu.ops.safemath import trunc_exp as jtrunc_exp  # noqa: E402
from nmf_tpu_torch import train as ttrain  # noqa: E402
from nmf_tpu_torch import trainer as ttrainer  # noqa: E402
from nmf_tpu_torch import weights  # noqa: E402
from nmf_tpu_torch.fields import hashgrid as thash  # noqa: E402
from nmf_tpu_torch.ops.draws import Draws  # noqa: E402
from nmf_tpu_torch.ops.safemath import trunc_exp  # noqa: E402
from torch_inputs import REFNERF_TCNN  # noqa: E402
from torch_parity import (AABB, build_pair, close,  # noqa: E402
                          grads_match, render_draws)

FWD, GRAD = 1e-5, 1e-4
B = 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _field_pair(finest=64, log2=12, seed=0):
    """nmf_tpu's tiny hash field with tables of unit scale (its U(-1e-4,
    1e-4) start makes every gradient through the tables ~1e-4 of the
    others) and the port's copy."""
    jrf = jhash.init_hashgrid_rf(jax.random.PRNGKey(seed), AABB, n_levels=4,
                                 log2_hashmap_size=log2,
                                 finest_resolution=finest)
    jrf = jrf.replace(encoding=jrf.encoding.replace(
        tables=jrf.encoding.tables * 1e4))
    trf = thash.init_hashgrid_rf(None, AABB, n_levels=4,
                                 log2_hashmap_size=log2,
                                 finest_resolution=finest)
    with torch.no_grad():
        trf.encoding.tables.copy_(torch.from_numpy(
            np.asarray(jrf.encoding.tables)))
        for tm, jm in ((trf.density_mlp, jrf.density_mlp),
                       (trf.app_mlp, jrf.app_mlp)):
            for layer, p in zip(tm.layers, jm.layers):
                layer.weight.copy_(torch.from_numpy(np.asarray(p["w"]).T))
                layer.bias.copy_(torch.from_numpy(np.asarray(p["b"])))
    return jrf, trf


def _unit_points(rng, n):
    """Points of the unit cube with some coordinates exactly 0 and 1 (the
    box faces: the corner at reso + 1)."""
    x = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    x[:8, 0] = 1.0
    x[8:16, 1] = 0.0
    x[16:20] = 1.0
    x[20:24] = 0.0
    return x


def test_trunc_exp_matches():
    """Forward and backward, inside and outside the clip [-15, 10]."""
    x = np.array([-30, -15, -3, 0, 2.5, 10, 12, 40], np.float32)
    g = jax.grad(lambda v: (jtrunc_exp(v) * jnp.arange(8.0)).sum())(
        jnp.asarray(x))
    t = torch.tensor(x, requires_grad=True)
    out = trunc_exp(t)
    (out * torch.arange(8.0)).sum().backward()
    close(out.detach().numpy(), jtrunc_exp(jnp.asarray(x)), FWD)
    close(t.grad.numpy(), g, FWD)
    assert t.grad[-1] > 0  # no zero outside the clip


@pytest.mark.parametrize("finest", [64, 1024])
def test_hash_ids_match(finest):
    """The spatial hash of every corner of every level against nmf_tpu's
    uint32 arithmetic: random corners up to 1,026 (the products overflow
    32 bits), points on the box faces, and the encoding's corner ids at
    finest resolution 64 and tcnn's 1024 (log2 table size 19)."""
    rng = np.random.default_rng(finest)
    c = rng.integers(0, 1027, (4000, 3)).astype(np.int32)
    c[:3] = [[1025, 1025, 1025], [1026, 0, 1026], [0, 0, 0]]
    ct = torch.from_numpy(c.astype(np.int64))
    np.testing.assert_array_equal(
        thash.hash_ids(ct[:, 0], ct[:, 1], ct[:, 2], 19).numpy(),
        np.asarray(jhash._hash_cell(jnp.asarray(c), 19)))
    enc = thash.HashEncoding(torch.zeros((4, 2 ** 19, 1)),
                             finest_resolution=finest)
    x = _unit_points(rng, 600)
    ids, _ = enc.corner_ids(torch.from_numpy(x))
    # nmf_tpu's level resolutions (HashEncoding.__call__)
    b = math.exp((math.log(finest) - math.log(16)) / 3)
    resos = [int(math.floor(16 * b ** level)) for level in range(4)]
    assert enc.resolutions() == resos
    expect = []
    for level, reso in enumerate(resos):
        x0 = np.floor(x * np.float32(reso)).astype(np.int32)
        for d in np.ndindex(2, 2, 2):
            expect.append(np.asarray(jhash._hash_cell(
                jnp.asarray(x0 + np.asarray(d, np.int32)), 19))
                + level * 2 ** 19)
    np.testing.assert_array_equal(ids.reshape(600, -1).numpy(),
                                  np.stack(expect, -1))


def test_encoding_matches():
    """HashEncoding on unit points (faces included): the features and the
    gradients of the points and of the tables."""
    jrf, trf = _field_pair()
    rng = np.random.default_rng(1)
    x = _unit_points(rng, 500)
    cot = rng.normal(size=(500, 8)).astype(np.float32)
    jout, jvjp = jax.vjp(jax.jit(
        lambda t, p: jrf.encoding.replace(tables=t)(p)),
        jrf.encoding.tables, jnp.asarray(x))
    jg_t, jg_x = jvjp(jnp.asarray(cot))
    tx = torch.tensor(x, requires_grad=True)
    out = trf.encoding(tx)
    (out * torch.from_numpy(cot)).sum().backward()
    close(out.detach().numpy(), jout, FWD, "features")
    close(tx.grad.numpy(), jg_x, GRAD, "d points")
    close(trf.encoding.tables.grad.numpy(), jg_t, GRAD, "d tables")


def _points(rng, n):
    return np.concatenate([rng.uniform(-1.4, 1.4, (n, 3)),
                           rng.uniform(0, 0.05, (n, 1))],
                          -1).astype(np.float32)


@pytest.mark.parametrize("grad", [False, True], ids=["eval", "train"])
def test_compute_all_matches(grad):
    """The fused query (density, appearance features, autograd normals),
    under no_grad (evaluation) and with gradients on (the normals keep a
    graph), against nmf_tpu's compute_all."""
    jrf, trf = _field_pair()
    x = _points(np.random.default_rng(2), 400)
    jsig, japp, jn = jax.jit(lambda rf, p: rf.compute_all(
        p, with_normals=True))(jrf, jnp.asarray(x))
    with torch.set_grad_enabled(grad):
        sig, app, n = trf.compute_all(torch.from_numpy(x), with_normals=True)
    assert n.requires_grad == grad and sig.requires_grad == grad
    for a, b, what in ((sig, jsig, "sigma"), (app, japp, "app"),
                       (n, jn, "normals")):
        close(a.detach().numpy(), b, FWD, what)
    sig2 = trf.compute_densityfeature(torch.from_numpy(x))
    close(sig2.detach().numpy(), jsig, FWD, "compute_densityfeature")


def test_normal_loss_gradients_match():
    """A loss on the normals, the density and the appearance: every
    gradient against jax.grad of the same loss (second order through the
    normals), the tables' included, and the points' gradient when the
    points take one (a retrace pass's). A second loss on the normals alone
    reaches the tables only through the normals."""
    jrf, trf = _field_pair()
    rng = np.random.default_rng(3)
    x = _points(rng, 300)
    cn, cs, ca = (rng.normal(size=s).astype(np.float32)
                  for s in ((300, 3), (300,), (300, 24)))

    def jloss(rf, pts, w_sig):
        sig, app, n = rf.compute_all(pts, with_normals=True)
        return ((n * cn).sum() + w_sig * ((sig * cs).sum()
                                          + (app * ca).sum()))

    jgrad = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))
    for w_sig in (1.0, 0.0):
        jl, (jg_rf, jg_x) = jgrad(jrf, jnp.asarray(x), w_sig)
        trf.zero_grad()
        tx = torch.tensor(x, requires_grad=True)
        sig, app, n = trf.compute_all(tx, with_normals=True)
        loss = (n * torch.from_numpy(cn)).sum() + w_sig * (
            (sig * torch.from_numpy(cs)).sum()
            + (app * torch.from_numpy(ca)).sum())
        loss.backward()
        close(float(loss.detach()), float(jl), FWD)
        close(tx.grad.numpy(), jg_x, GRAD, "d points")
        tables = trf.encoding.tables.grad.numpy()
        assert np.abs(tables).max() > 0
        close(tables, jg_rf.encoding.tables, GRAD, "d tables")
        for name in ("density_mlp", "app_mlp"):
            for layer, g in zip(getattr(trf, name).layers,
                                getattr(jg_rf, name).layers):
                if layer.weight.grad is None:
                    assert not np.any(np.asarray(g["w"])), name
                    continue
                close(layer.weight.grad.numpy().T, g["w"], GRAD, name)
                close(layer.bias.grad.numpy(), g["b"], GRAD, name)


def test_refnerf_tcnn_train_step_matches():
    """One train step of the tiny refnerf_tcnn on the hash field: the
    geonorm ori term (geonorm_iters 100) and the blend at the tick of
    iteration 1 (0); the loss and every gradient (the tables', reached
    through the normals too, and the frozen reflection MLP's, which enters
    the clip's norm)."""
    jn, tn, cfg = build_pair(base=REFNERF_TCNN)
    jn, _ = jn.check_schedule(1)
    tn.check_schedule(1)
    assert float(tn.predicted_normal_lambda) == float(
        jn.predicted_normal_lambda) == 0.0
    ds = jload({"dataset_name": "synthetic_sphere", "n_views": 4,
                "image_size": 16}, None, "train")
    ids = np.random.default_rng(0).choice(ds["all_rays"].shape[0], B,
                                          replace=False)
    r, g = ds["all_rays"][ids], ds["all_rgbs"][ids]
    params = dict(cfg["model"]["params"], ori_lambda=0.1, pred_lambda=3e-4,
                  L1_weight_initial=8e-5)
    jw = jtrainer.LossWeights(ori_lambda=0.1, pred_lambda=3e-4,
                              l1_weight=8e-5)
    key = jax.random.PRNGKey(5)
    # a black background: over white the sphere's rays clip to 1, where
    # the photometric loss has no gradient
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda n, r, g: jtrainer.compute_loss(n, r, g, key, jw, jnp.zeros(3)),
        has_aux=True))(jn, jnp.asarray(r), jnp.asarray(g))
    ttrain.make_optimizer(tn, params, 100)  # gradients on every tensor
    tl, tm = ttrainer.compute_loss(
        tn, torch.from_numpy(r), torch.from_numpy(g),
        ttrain.make_loss_weights(params), (0.0, 0.0, 0.0),
        draws=Draws(None, render_draws(key, jn, B, True)))
    tl.backward()
    close(float(tl), float(jl), FWD, "loss")
    close(float(tm["n_valid_samples"]), float(jm["n_valid_samples"]), FWD)
    jgd = jckpt.state_dict(jg)
    assert np.abs(jgd[".rf.encoding.tables"]).max() > 0
    assert np.abs(jgd[".model.ref_module.mlp.layers[0]['w']"]).max() > 0
    grads_match(tn, jg, GRAD)
    labels = {p: lab for p, _, lab in ttrainer.differentiated_tensors(tn)}
    assert labels["rf/encoding/tables"] == "rf_grid"
    assert labels["rf/density_mlp/layers/0/weight"] == "rf_net"
