"""nmf_tpu_torch kernels K1/K2 (composite) and K3 (binsum) against nmf_tpu.

On the CPU the port's wrappers run their plain PyTorch versions; these are
held against the Pallas kernels run in interpret mode (as
tests/test_pallas.py runs them) and against the XLA forms nmf_tpu uses by
default. The CUDA kernels themselves are held against the plain versions by
tests/test_torch_cuda.py, which skip without a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nmf_tpu.ops import grid_sample as jgs  # noqa: E402
from nmf_tpu.ops.masked import raw2alpha as j_raw2alpha  # noqa: E402
from nmf_tpu.ops.pallas import composite as jcomp  # noqa: E402
from nmf_tpu.ops.pallas.binsum import binsum_rows as j_binsum  # noqa: E402
from nmf_tpu_torch.ops import grid_sample as tgs  # noqa: E402
from nmf_tpu_torch.ops.kernels import binsum as tbin  # noqa: E402
from nmf_tpu_torch.ops.kernels import build  # noqa: E402
from nmf_tpu_torch.ops.kernels import composite as tcomp  # noqa: E402
from torch_inputs import binsum_case, composite_inputs, cotangents  # noqa: E402,E501


@pytest.fixture
def interpret_mode(monkeypatch):
    """Run pallas_call in interpreter mode on the CPU."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setattr(jcomp.pl, "pallas_call", patched)


def _torch_composite_grads(fn, arrays, cots):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    outs = fn(*ts)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots))
    loss.backward()
    return [o.detach().numpy() for o in outs], [t.grad.numpy() for t in ts]


def test_composite_plain_matches_pallas_forward(interpret_mode):
    # rtol 1e-5: the same f32 recurrence, only the order of the sums differs
    args = composite_inputs()
    ref = jcomp.composite_rays(*map(jnp.asarray, args))
    out = tcomp.composite_rays(*map(torch.from_numpy, args))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def test_composite_plain_matches_pallas_gradients(interpret_mode):
    # the Pallas VJP returns cotangents for sigma and rgb only; rtol 1e-4
    # covers the reverse-scan versus cumprod-autodiff rounding
    args = composite_inputs(B=19, K=8, seed=1)
    cots = cotangents(19, 8)

    def jloss(sigma, rgb):
        outs = jcomp.composite_rays(sigma, jnp.asarray(args[1]), rgb,
                                    jnp.asarray(args[3]))
        return sum((o * c).sum() for o, c in zip(outs, cots))

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(args[0]),
                                         jnp.asarray(args[2]))
    _, tg = _torch_composite_grads(tcomp.composite_rays, args, cots)
    np.testing.assert_allclose(tg[0], np.asarray(jg[0]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tg[2], np.asarray(jg[1]), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("opaque", [False, True], ids=["moderate", "opaque"])
def test_composite_plain_matches_raw2alpha_autodiff(opaque):
    # every input's cotangent, d_dists and d_z_vals included, against JAX
    # autodiff of the XLA form; on opaque rays T underflows and the
    # gradients behind the first opaque samples are ~0, hence atol 1e-5
    args = composite_inputs(B=29, K=24, seed=2, opaque=opaque)
    cots = cotangents(29, 24, seed=3)

    def jloss(*a):
        outs = jcomp.composite_rays_reference(*a)
        return sum((o * c).sum() for o, c in zip(outs, cots))

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, args))
    outs, tg = _torch_composite_grads(tcomp.composite_rays, args, cots)
    ref = jcomp.composite_rays_reference(*map(jnp.asarray, args))
    for a, b in zip(outs, ref):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)


def test_transmittance_weights_plain_matches_pallas(interpret_mode):
    args = composite_inputs(B=21, K=12, seed=4)
    g = np.random.default_rng(5).normal(size=(21, 12)).astype(np.float32)
    jw, jvjp = jax.vjp(jcomp.transmittance_weights, jnp.asarray(args[0]),
                       jnp.asarray(args[1]))
    sigma = torch.tensor(args[0], requires_grad=True)
    tw = tcomp.transmittance_weights(sigma, torch.from_numpy(args[1]))
    (tw * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sigma.grad.numpy(),
                               np.asarray(jvjp(jnp.asarray(g))[0]),
                               rtol=1e-4, atol=1e-5)


def test_cpu_tensors_take_the_plain_versions():
    # a CPU tensor never reaches a kernel: the launch counts stay put
    before = (tcomp.COMPOSITE_FWD.launches, tcomp.COMPOSITE_BWD.launches,
              tbin.BINSUM.launches)
    sigma = torch.rand(4, 8, requires_grad=True)
    tcomp.transmittance_weights(sigma, torch.rand(4, 8)).sum().backward()
    tbin.binsum_rows(torch.zeros(5, dtype=torch.int32), torch.rand(5, 3), 2)
    assert (tcomp.COMPOSITE_FWD.launches, tcomp.COMPOSITE_BWD.launches,
            tbin.BINSUM.launches) == before


@pytest.mark.parametrize("case", ["collisions", "runs"])
def test_binsum_plain_matches_pallas_and_numpy(case):
    # f32 sums in another order: rtol/atol 1e-4 as tests/test_pallas.py
    idx, vals, R = binsum_case(case)
    keep = (idx >= 0) & (idx < R)
    ref = np.zeros((R, vals.shape[1]), np.float32)
    np.add.at(ref, idx[keep], vals[keep])
    jout = np.asarray(j_binsum(jnp.asarray(idx), jnp.asarray(vals), R,
                               interpret=True))
    tout = tbin.binsum_rows(torch.from_numpy(idx), torch.from_numpy(vals),
                            R).numpy()
    np.testing.assert_allclose(tout, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tout, jout, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(8, 17, 23, 512), (40, 16, 16, 300)],
                         ids=["odd", "field"])
def test_quad_gather_matches_binsum_vjp_and_autodiff(shape, interpret_mode):
    # forward is the same f32 arithmetic (tight); plane gradients are sums
    # in another order (rtol 1e-4); coordinate gradients carry the
    # (W-1)/2 scale (atol 1e-3, as tests/test_pallas.py)
    C, H, W, N = shape
    rng = np.random.default_rng(1)
    plane = rng.normal(size=(C, H, W)).astype(np.float32)
    coords = rng.uniform(-1.1, 1.1, size=(N, 2)).astype(np.float32)
    g = rng.normal(size=(N, C)).astype(np.float32)

    def jloss(fn):
        return lambda p, c: (fn(p, c) * g).sum()

    jp, jc = jnp.asarray(plane), jnp.asarray(coords)
    ref_fwd = np.asarray(jgs.quad_gather_2d(jp, jc))
    g_auto = jax.grad(jloss(jgs.quad_gather_2d), argnums=(0, 1))(jp, jc)
    g_bin = jax.grad(jloss(jgs.quad_gather_2d_binsum), argnums=(0, 1))(jp, jc)

    tp = torch.tensor(plane, requires_grad=True)
    tc = torch.tensor(coords, requires_grad=True)
    out = tgs.quad_gather_2d(tp, tc)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref_fwd, rtol=1e-6,
                               atol=1e-6)
    for ref in (g_bin, g_auto):
        np.testing.assert_allclose(tp.grad.numpy(), np.asarray(ref[0]),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tc.grad.numpy(), np.asarray(ref[1]),
                                   rtol=1e-4, atol=1e-3)


def test_check_cuda_rejects_what_the_kernels_do_not_take():
    cpu = torch.zeros(2, 3)
    with pytest.raises(ValueError):
        build.check_cuda("x", cpu, torch.float32, (2, 3),
                         torch.device("cuda", 0))
