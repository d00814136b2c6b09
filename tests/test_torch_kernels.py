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


# samples per lane in a tile of the kernels
V = 6


def _warp_sum(x):
    """Sum over K as the forward kernel takes it: each lane adds its samples
    in coalesced order (tile by tile, sample j * 32 + lane of a tile), then a
    butterfly over the 32 lanes."""
    B, K = x.shape
    n_tiles = -(-K // (32 * V))
    lanes = np.pad(x, ((0, 0), (0, n_tiles * 32 * V - K))).reshape(
        B, n_tiles * V, 32)
    part = np.zeros((B, 32), np.float32)
    for row in range(n_tiles * V):
        part = part + lanes[:, row]
    for m in (16, 8, 4, 2, 1):
        part = part + part[:, np.arange(32) ^ m]
    return part[:, 0]


def _emulate_composite_kernels(sigma, dists, rgb, z, cots):
    """float32 numpy mirror of the order of operations of K1/K2
    (nmf_tpu_torch/csrc/composite.cu): lane chunks of V consecutive
    samples, a Hillis-Steele product scan over the 32 lanes, the tile carry
    of T, and the affine suffix scan for R, carried from the last tile back.
    Returns the four outputs and the four input gradients."""
    B, K = sigma.shape
    n_tiles = -(-K // (32 * V))
    lane = np.arange(32)

    def lane_order(x):  # (B, K) -> (B, tile, lane, V); padding 0
        return np.pad(x, ((0, 0), (0, n_tiles * 32 * V - K))).reshape(
            B, n_tiles, 32, V)

    g_w, g_rgb, g_acc, g_depth = cots
    e = np.exp(-sigma * dists)
    alpha = lane_order(np.float32(1) - e)
    f = (np.float32(1) - alpha) + np.float32(1e-10)

    # forward: lane products, inclusive scan over lanes, tile carry
    prod = f[..., 0]
    for j in range(1, V):
        prod = prod * f[..., j]
    x = prod.copy()
    for d in (1, 2, 4, 8, 16):
        x = np.where(lane >= d, np.roll(x, d, axis=-1) * x, x)
    excl = np.where(lane == 0, np.float32(1), np.roll(x, 1, axis=-1))
    T0 = np.ones((B, n_tiles), np.float32)
    for t in range(1, n_tiles):
        T0[:, t] = T0[:, t - 1] * x[:, t - 1, 31]
    T = np.empty_like(f)
    run = T0[..., None] * excl
    for j in range(V):
        T[..., j] = run
        run = run * f[..., j]
    weights = (alpha * T).reshape(B, -1)[:, :K]
    outs = (weights,
            np.stack([_warp_sum(weights * rgb[..., c]) for c in range(3)],
                     -1),
            _warp_sum(weights), _warp_sum(weights * z))

    # backward: each lane's map R -> a R + b, suffix scan over lanes
    s = (g_acc[:, None] + g_w) + (g_rgb[:, None, 0] * rgb[..., 0]
                                  + g_rgb[:, None, 1] * rgb[..., 1]
                                  + g_rgb[:, None, 2] * rgb[..., 2])
    s = lane_order(s + g_depth[:, None] * z)
    ma, mb = prod, np.zeros_like(prod)
    for j in reversed(range(V)):
        mb = f[..., j] * mb + s[..., j] * alpha[..., j]
    for d in (1, 2, 4, 8, 16):
        na, nb = np.roll(ma, -d, axis=-1), np.roll(mb, -d, axis=-1)
        ma, mb = (np.where(lane + d < 32, ma * na, ma),
                  np.where(lane + d < 32, ma * nb + mb, mb))
    ea, eb = np.roll(ma, -1, axis=-1), np.roll(mb, -1, axis=-1)
    d_alpha = np.empty_like(f)
    R = np.zeros((B, 1), np.float32)
    for t in reversed(range(n_tiles)):
        r = np.where(lane == 31, R, ea[:, t] * R + eb[:, t])
        for j in reversed(range(V)):
            d_alpha[:, t, :, j] = T[:, t, :, j] * (s[:, t, :, j] - r)
            r = f[:, t, :, j] * r + s[:, t, :, j] * alpha[:, t, :, j]
        R = r[:, :1]
    d_alpha = d_alpha.reshape(B, -1)[:, :K]
    grads = (d_alpha * dists * e, d_alpha * sigma * e,
             weights[..., None] * g_rgb[:, None, :],
             weights * g_depth[:, None])
    return outs, grads


@pytest.mark.parametrize("K", [1, 33, 192, 300])
@pytest.mark.parametrize("opaque", [False, True], ids=["moderate", "opaque"])
def test_kernel_scan_order_matches_jax(K, opaque, interpret_mode):
    # the CUDA kernels reassociate T's product and R's sum (lane chunks,
    # warp scans, tile carries); emulated in f32 they stay inside the
    # tolerances chip_smoke.py holds the kernels to: forward 1e-5 relative
    # plus 1e-6, gradients 1e-4 relative plus 1e-5. K = 1 and 33 leave most
    # of a tile of 192 masked, 192 fills one, 300 takes two. Moderate rays
    # keep a mean optical depth of about 4 over the ray, so T stays far
    # above the tolerances to the last tile and the carry shows.
    args = composite_inputs(B=24, K=K, seed=20 + K, opaque=opaque)
    if not opaque:
        args[1][:] *= min(1.0, 16 / K)
    cots = cotangents(24, K, seed=21)
    outs, grads = _emulate_composite_kernels(*args, cots)
    for a in outs + grads:
        assert a.dtype == np.float32
    jcots = tuple(map(jnp.asarray, cots))
    for fn in (jcomp.composite_rays_reference, jcomp.composite_rays):
        ref, pull = jax.vjp(fn, *map(jnp.asarray, args))
        for a, b in zip(outs, ref):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5,
                                       atol=1e-6)
        ref_grads = pull(jcots)
        # the Pallas VJP returns d_sigma and d_rgb only, and rebuilds T by
        # division, which loses it on opaque rays: the XLA form's autodiff
        # holds every gradient there
        check = ((0, 1, 2, 3) if fn is jcomp.composite_rays_reference
                 else () if opaque else (0, 2))
        for i in check:
            np.testing.assert_allclose(grads[i], np.asarray(ref_grads[i]),
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


def test_launches_are_counted_by_size():
    # a stand-in C entry that reports success: the counts key each launch
    # by its non-pointer arguments (binsum: N, C, R, dtype code), a failed
    # one counts nowhere
    from nmf_tpu_torch.ops.kernels.build import CudaKernel

    k = CudaKernel("binsum.cu", "binsum_rows", tbin.BINSUM.argtypes)
    k._fn = lambda *args: 0
    for n, code in ((10, 1), (10, 1), (20, 1), (10, 0)):
        k(1, 2, 3, n, 4, 7, code, None)
    k._fn = lambda *args: 1
    with pytest.raises(RuntimeError):
        k(1, 2, 3, 30, 4, 7, 1, None)
    assert k.launches == 4
    assert dict(k.launches_by_size) == {(10, 4, 7, 1): 2, (20, 4, 7, 1): 1,
                                        (10, 4, 7, 0): 1}


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


@pytest.mark.parametrize("case", ["collisions", "runs", "bf16 C=288",
                                  "bf16 C=80"])
def test_binsum_plain_reads_bf16_in_its_dtype(case):
    # bf16 rows (the field's cotangents): the plain version widens them to
    # f32, exactly, and sums in f32, so it equals itself on vals.float()
    # bit for bit; against the Pallas kernel on the same bf16-representable
    # values, f32 sums in another order (rtol/atol 1e-4)
    idx, vals, R = binsum_case(case)
    idx_t = torch.from_numpy(idx)
    vals_bf = torch.from_numpy(vals).bfloat16()
    out = tbin.binsum_rows(idx_t, vals_bf, R)
    assert out.dtype == torch.float32
    assert torch.equal(out, tbin.binsum_rows_plain(idx_t, vals_bf.float(), R))
    jout = np.asarray(j_binsum(jnp.asarray(idx),
                               jnp.asarray(vals_bf.float().numpy()), R,
                               interpret=True))
    np.testing.assert_allclose(out.numpy(), jout, rtol=1e-4, atol=1e-4)


def test_binsum_check_args_rejects_what_the_kernel_does_not_take():
    # checked before the launch: ids int32 (N,), vals f32 or bf16 (N, C),
    # both contiguous, 0 < num_rows < 2^31, one CUDA device
    idx, vals = torch.zeros(6, dtype=torch.int32), torch.zeros(6, 4)
    for bad_idx, bad_vals, rows, err in (
            (idx, vals.half(), 3, TypeError),
            (idx.long(), vals, 3, TypeError),
            (idx[:5], vals, 3, TypeError),
            (idx, vals[:, None], 3, ValueError),
            (idx, torch.zeros(4, 6).t(), 3, ValueError),
            (idx, vals, 0, ValueError),
            (idx, vals, 2 ** 31, ValueError),
            (idx, vals, 3, ValueError)):  # right in all but the device
        with pytest.raises(err):
            tbin.check_args(bad_idx, bad_vals, rows)
    assert tbin.DTYPE_CODES == {torch.float32: 0, torch.bfloat16: 1}


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
