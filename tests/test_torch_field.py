"""nmf_tpu_torch's TensorVMSplit against nmf_tpu's, with the weights carried
by ``weights.from_jax_state_dict`` from ``nmf_tpu.ckpt.state_dict``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nmf_tpu import ckpt as jckpt  # noqa: E402
from nmf_tpu_torch import weights  # noqa: E402
from torch_parity import build_pair  # noqa: E402

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny shapes run fastest on one thread, and the test workers
    share the CPU cores (torch's thread pool beside JAX's oversubscribes
    them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _points(n=400, seed=0):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1.6, 1.6, (n, 3)).astype(np.float32)
    return np.concatenate([xyz, rng.uniform(0, 0.01, (n, 1))], -1
                          ).astype(np.float32)


def _jax_grads(fn, rf):
    g = jax.grad(fn)(rf)
    return {k: v for k, v in jckpt.state_dict(g).items()}


def _port_grads(tn):
    rf = tn.rf
    out = {}
    for fg in ("density_rf", "app_rf"):
        for kind in ("planes", "lines"):
            for i, p in enumerate(getattr(getattr(rf, fg), kind)):
                out[f".{fg}.{kind}[{i}]"] = p.grad
    out[".basis_mat"] = rf.basis_mat.grad
    return out


def _compare_all(gather, rtol, atol, grtol, gatol):
    jn, tn, _ = build_pair(gather)
    pts = _points()
    rng = np.random.default_rng(1)
    g_sig = rng.normal(size=(400,)).astype(np.float32)
    g_app = rng.normal(size=(400, 24)).astype(np.float32)

    def jloss(rf):
        s, a, _ = rf.compute_all(jnp.asarray(pts), with_normals=False)
        return (s * g_sig).sum() + (a * g_app).sum()

    js, ja, _ = jn.rf.compute_all(jnp.asarray(pts), with_normals=False)
    jg = _jax_grads(jloss, jn.rf)
    ts, ta, _ = tn.rf.compute_all(torch.from_numpy(pts))
    ((ts * torch.from_numpy(g_sig)).sum()
     + (ta * torch.from_numpy(g_app)).sum()).backward()
    np.testing.assert_allclose(ts.detach().numpy(), np.asarray(js),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(ta.detach().numpy(), np.asarray(ja),
                               rtol=rtol, atol=atol)
    for k, v in _port_grads(tn).items():
        np.testing.assert_allclose(v.numpy(), jg[k], rtol=grtol, atol=gatol,
                                   err_msg=k)


def test_compute_all_f32():
    # same f32 arithmetic; plane/line gradients are scatter sums in
    # another order
    _compare_all("f32", 1e-5, 1e-6, 1e-4, 1e-6)


def test_compute_all_bf16():
    # bf16 gathers: the values agree tightly (the same bf16-rounded
    # operands, f32 products); the factor gradients are accumulated in f32
    # by the port's binsum and in bf16 by XLA's scatter, then rounded to
    # bf16, so they agree to a few bf16 ulps of the largest gradient
    _compare_all("bf16", 1e-5, 1e-5, 3e-2, 3e-2)


def test_compute_densityfeature_and_grads():
    jn, tn, _ = build_pair("f32")
    pts = _points(seed=2)
    g = np.random.default_rng(3).normal(size=(400,)).astype(np.float32)
    js = jn.rf.compute_densityfeature(jnp.asarray(pts))
    jg = _jax_grads(lambda rf: (rf.compute_densityfeature(jnp.asarray(pts))
                                * g).sum(), jn.rf)
    ts = tn.rf.compute_densityfeature(torch.from_numpy(pts))
    (ts * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(ts.detach().numpy(), np.asarray(js),
                               rtol=1e-5, atol=1e-6)
    for k, v in _port_grads(tn).items():
        if k.startswith(".density_rf"):
            np.testing.assert_allclose(v.numpy(), jg[k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_compute_appfeature():
    jn, tn, _ = build_pair("f32")
    pts = _points(seed=4)
    np.testing.assert_allclose(
        tn.rf.compute_appfeature(torch.from_numpy(pts)).detach().numpy(),
        np.asarray(jn.rf.compute_appfeature(jnp.asarray(pts))),
        rtol=1e-5, atol=1e-6)


def test_density_l1_and_upsample():
    jn, tn, _ = build_pair("f32")
    np.testing.assert_allclose(float(tn.rf.density_L1()),
                               float(jn.rf.density_L1()), rtol=1e-6)
    jup = jn.rf.upsample([23, 23, 23])
    tn.rf.upsample([23, 23, 23])
    assert tn.rf.grid_size == tuple(jup.grid_size) == (23, 23, 23)
    assert tn.rf.n_samples == jup.n_samples
    assert tn.rf.stepsize == pytest.approx(jup.stepsize, rel=1e-12)
    sd = jckpt.state_dict(jup)
    for fg in ("density_rf", "app_rf"):
        for kind in ("planes", "lines"):
            for i, p in enumerate(getattr(getattr(tn.rf, fg), kind)):
                np.testing.assert_allclose(
                    p.detach().numpy(), sd[f".{fg}.{kind}[{i}]"],
                    rtol=1e-5, atol=1e-6)


def test_schedule_events_match():
    jn, tn, _ = build_pair("f32", ["field.upsamp_list=[2,4]"])
    for it in range(1, 6):
        jn_rf, j_changed = jn.rf.check_schedule(it)
        assert tn.rf.check_schedule(it) == j_changed
        jn = jn.replace(rf=jn_rf)
        assert tn.rf.grid_size == tuple(jn.rf.grid_size)


def test_state_dict_map_is_strict():
    jn, tn, _ = build_pair("f32")
    sd = jckpt.state_dict(jn)
    with pytest.raises(KeyError):
        weights.from_jax_state_dict(tn, {**sd, ".rf.unknown": np.zeros(3)})
    sd.pop(".rf.basis_mat")
    with pytest.raises(KeyError):
        weights.from_jax_state_dict(tn, sd)
