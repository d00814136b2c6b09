"""The options of nmf_tpu's TensorVMSplit in nmf_tpu_torch, against nmf_tpu:
the init modes, the activations, autograd normals (``numer_grad=false``),
``dbasis``, ``contract_space``, the density pretraining and the
``field.calibrate`` solve (``train.pretrain_density``), with the weights
carried by ``weights.from_jax_state_dict`` and nmf_tpu's random draws
replayed by name. A tiny model=tensorf (grid 16^3, f32 gathers) unless a
test says otherwise."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nmf_tpu import ckpt as jckpt  # noqa: E402
from nmf_tpu import train as jtrain  # noqa: E402
from nmf_tpu.fields import tensorf as jtf  # noqa: E402
from nmf_tpu_torch import train as ttrain  # noqa: E402
from nmf_tpu_torch import weights  # noqa: E402
from nmf_tpu_torch.fields import tensorf as ttf  # noqa: E402
from nmf_tpu_torch.ops.draws import Draws  # noqa: E402
from torch_parity import build_pair, close  # noqa: E402

FWD, GRAD = 1e-5, 1e-4
START_DENSITY = 0.01


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rf_grads_match(tn, jg_rf, rtol):
    """Every gradient of nmf_tpu's field against the port's (a tensor the
    port leaves without one must have an exactly zero one there), but the
    box's: a field query alone does not differentiate the port's box (the
    train step does, ``trainer.differentiated_tensors``)."""
    for key, g in jckpt.state_dict(jg_rf).items():
        if key == ".aabb":
            continue
        tg = weights.port_grad(tn, ".rf" + key)
        if tg is None:
            assert not np.any(g), key
            continue
        close(tg.numpy(), g, rtol, key)


def _points(n=300, seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-1.45, 1.45, (n, 3)),
                           rng.uniform(0, 0.01, (n, 1))],
                          -1).astype(np.float32)


def test_trig_init_matches():
    """'trig' is deterministic: every plane and line equal to nmf_tpu's
    up to the f32 rounding of sin / cos / exp (1e-7 seen)."""
    jfg = jtf.init_factor_grid(jax.random.PRNGKey(0), 24, 8, "trig", 0.1)
    tfg = ttf.init_factor_grid(None, 24, 8, "trig", 0.1)
    for kind in ("planes", "lines"):
        for t, j in zip(getattr(tfg, kind), getattr(jfg, kind)):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                       rtol=0, atol=1e-6, err_msg=kind)


@pytest.mark.parametrize("mode", ["rand", "unif", "unifplane", "randplane"])
def test_random_init_modes_match_in_distribution(mode):
    """The random modes draw from torch's generator, not JAX's keys: the
    shapes, the ranges, the constant lines and the moments of nmf_tpu's
    draws (64^2 planes of 8 components)."""
    jfg = jtf.init_factor_grid(jax.random.PRNGKey(0), 64, 8, mode, 0.1)
    tfg = ttf.init_factor_grid(torch.Generator().manual_seed(0), 64, 8, mode,
                               0.1)
    for kind in ("planes", "lines"):
        for t, j in zip(getattr(tfg, kind), getattr(jfg, kind)):
            t, j = t.detach().numpy(), np.asarray(j)
            assert t.shape == j.shape
            # five standard errors of the difference of two sample means,
            # and of two sample deviations
            se = math.sqrt(2 / t.size)
            assert abs(t.mean() - j.mean()) <= 5 * se * j.std() + 1e-7
            close(t.std(), j.std(), max(5 * se, 1e-6), kind)
            close(np.abs(t).max(), np.abs(j).max(), 0.25, kind)
            if kind == "lines" and mode.endswith("plane"):
                np.testing.assert_allclose(t, math.sqrt(0.1), rtol=1e-6)
            if mode.startswith("unif") and kind == "planes":
                assert np.abs(t).max() <= math.sqrt(0.1)


@pytest.mark.parametrize("activation", ["relu", "exp", "identity"])
def test_activations_match(activation):
    """compute_densityfeature and compute_all's density."""
    jn, tn, _ = build_pair(extra=[f"field.activation={activation}",
                                  "field.density_shift=-0.05"])
    x = _points()
    with torch.no_grad():
        close(tn.rf.compute_densityfeature(torch.from_numpy(x)).numpy(),
              jn.rf.compute_densityfeature(jnp.asarray(x)), FWD, activation)
        close(tn.rf.compute_all(torch.from_numpy(x))[0].numpy(),
              jn.rf.compute_all(jnp.asarray(x), with_normals=False)[0], FWD,
              activation)


def _normal_loss(pts, cn, cs):
    def jloss(rf):
        n = rf.compute_normals(jnp.asarray(pts))
        sig = rf.compute_densityfeature(jnp.asarray(pts),
                                        use_gather_dtype=True)
        return (n * cn).sum() + (sig * cs).sum()
    return jloss


@pytest.mark.parametrize("dbasis", [False, True], ids=["sum", "dbasis"])
def test_autograd_normals_match(dbasis):
    """numer_grad=false: normals by autograd through the quad gather, and
    the gradient of a loss on them (second order, reaching the planes,
    the lines and dbasis_mat) against jax.grad; compute_all with normals
    answers as nmf_tpu's renderer queries the field (density, appearance
    and normals each on its own)."""
    jn, tn, _ = build_pair(extra=["field.numer_grad=false",
                                  f"field.dbasis={str(dbasis).lower()}"])
    assert not tn.rf.fused_normals_ok and not jn.rf.fused_normals_ok
    rng = np.random.default_rng(2)
    x = _points(seed=2)
    cn = rng.normal(size=(300, 3)).astype(np.float32)
    cs = rng.normal(size=(300,)).astype(np.float32)
    jl, jg = jax.value_and_grad(_normal_loss(x, cn, cs))(jn.rf)
    sig, app, n = tn.rf.compute_all(torch.from_numpy(x), with_normals=True)
    close(n.detach().numpy(), jn.rf.compute_normals(jnp.asarray(x)), FWD,
          "normals")
    close(app.detach().numpy(), jn.rf.compute_appfeature(jnp.asarray(x)),
          FWD, "app")
    loss = (n * torch.from_numpy(cn)).sum() + (sig * torch.from_numpy(cs)).sum()
    loss.backward()
    close(float(loss.detach()), float(jl), FWD, "loss")
    jsd = jckpt.state_dict(jg)
    assert np.abs(jsd[".density_rf.planes[0]"]).max() > 0
    _rf_grads_match(tn, jg, GRAD)


def test_dbasis_with_smoothed_normals_raises():
    """dbasis with numer_grad=true: no fused normals; asking for normals
    raises in both packages (their densities still match)."""
    jn, tn, _ = build_pair(extra=["field.dbasis=true"])
    x = _points(seed=3)
    with pytest.raises(NotImplementedError):
        jn.rf.compute_normals(jnp.asarray(x))
    with pytest.raises(NotImplementedError):
        tn.rf.compute_all(torch.from_numpy(x), with_normals=True)
    sig = tn.rf.compute_all(torch.from_numpy(x))[0]
    close(sig.detach().numpy(), jn.rf.compute_all(
        jnp.asarray(x), with_normals=False)[0], FWD, "density")


def test_contract_space_matches():
    """The world position contracted (not the box-normalized one), and the
    density and appearance read there, with their gradients."""
    jn, tn, _ = build_pair(extra=["field.contract_space=true"])
    rng = np.random.default_rng(4)
    x = _points(seed=4) * np.array([2, 2, 2, 1], np.float32)
    x[:5, :3] = 0.3  # inside the unit ball
    close(tn.rf.normalize_coord(torch.from_numpy(x)).numpy(),
          jn.rf.normalize_coord(jnp.asarray(x)), FWD, "contracted")
    cs = rng.normal(size=(300,)).astype(np.float32)
    ca = rng.normal(size=(300, 24)).astype(np.float32)

    def jloss(rf):
        s, a, _ = rf.compute_all(jnp.asarray(x), with_normals=False)
        return (s * cs).sum() + (a * ca).sum()

    jl, jg = jax.value_and_grad(jloss)(jn.rf)
    s, a, _ = tn.rf.compute_all(torch.from_numpy(x))
    loss = (s * torch.from_numpy(cs)).sum() + (a * torch.from_numpy(ca)).sum()
    loss.backward()
    close(float(loss.detach()), float(jl), FWD, "loss")
    _rf_grads_match(tn, jg, GRAD)


def _pretrain_draws(key, n):
    """nmf_tpu's pretrain_density key splits, by the port's names."""
    d = {}
    for i in range(n):
        key, sk = jax.random.split(key)
        k1, k2 = jax.random.split(sk)
        d[f"{i}/xyz"] = np.asarray(jax.random.uniform(k1, (20000, 3)))
        d[f"{i}/noise"] = np.asarray(jax.random.normal(k2, (20000,)))
    return d


@pytest.mark.parametrize("dbasis", [False, True], ids=["sum", "dbasis"])
def test_pretrain_density_matches(dbasis):
    """3 iterations of the pretraining Adam: the density planes, lines and
    dbasis_mat after them (the appearance untouched). Adam's first steps
    are ~lr * sign(g); an entry whose gradient is within rounding of 0 may
    move differently, by at most 2 lr a step: the rest is held to 1e-5."""
    n = 3
    jn, tn, _ = build_pair(extra=["field.num_pretrain=3",
                                  f"field.dbasis={str(dbasis).lower()}"])
    key = jax.random.PRNGKey(9)
    before = weights.to_jax_state_dict(tn)
    jout = jtrain.pretrain_density(jn, key, START_DENSITY, log=lambda s: None)
    lines = []
    ttrain.pretrain_density(tn, Draws(None, _pretrain_draws(key, n)),
                            START_DENSITY, log=lines.append)
    assert lines and lines[0].startswith("pretrain density: mean alpha")
    after = weights.to_jax_state_dict(tn)
    for k, v in jckpt.state_dict(jout).items():
        err = np.abs(after[k] - np.asarray(v))
        if not k.startswith((".rf.density_rf", ".rf.dbasis_mat")):
            np.testing.assert_array_equal(after[k], before[k], err_msg=k)
            continue
        assert (err <= 1e-5 + 2 * 5e-3 * n).all(), k
        assert np.mean(err <= 1e-5) > 0.99, k
    moved = np.abs(after[".rf.dbasis_mat"] - before[".rf.dbasis_mat"]).max()
    assert (moved > 0) == dbasis


def test_calibrate_matches():
    """field.calibrate with activation=exp and no pretraining: the
    density_shift solve on 20,000 replayed box points."""
    jn, tn, _ = build_pair(extra=["field.calibrate=true",
                                  "field.activation=exp"])
    key = jax.random.PRNGKey(4)
    jout = jtrain.pretrain_density(jn, key, START_DENSITY, log=lambda s: None)
    k1, _ = jax.random.split(key)
    ttrain.pretrain_density(
        tn, Draws(None, {"calibrate/xyz": np.asarray(
            jax.random.uniform(k1, (20000, 3)))}), START_DENSITY,
        log=lambda s: None)
    assert jout.rf.density_shift != jn.rf.density_shift
    close(tn.rf.density_shift, jout.rf.density_shift, FWD, "density_shift")
    x = _points(seed=5)
    with torch.no_grad():
        close(tn.rf.compute_densityfeature(torch.from_numpy(x)).numpy(),
              jout.rf.compute_densityfeature(jnp.asarray(x)), FWD, "density")
