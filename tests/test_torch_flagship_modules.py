"""The modules of nmf_tpu_torch's microfacet slice, each against its nmf_tpu
function on the same inputs, forward and gradients: safemath, SH, the
derivative filters, the field's normals, proposal resampling, segment sums,
the MLP initializers, Hammersley and GGX sampling, ListISH, MLPBRDF,
RandHydraMLPDiffuse, the envmap and the three calibrations.

Tolerances: forward 1e-5 and gradients 1e-4 relative (as the tensorf
tests), except the envmap, whose lookups are differences of large partial
sums of its SAT (``test_envmap_matches``), and the proposal resampling's
inverse CDF (``test_resample_pdf``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nmf_tpu import ckpt as jckpt  # noqa: E402
from nmf_tpu import train as jtrain  # noqa: E402
from nmf_tpu.modules import brdf_samplers as jbs  # noqa: E402
from nmf_tpu.modules.ish import ListISH as JListISH  # noqa: E402
from nmf_tpu.modules.mlp import create_mlp  # noqa: E402
from nmf_tpu.ops import grid_sample as jgs  # noqa: E402
from nmf_tpu.ops import masked as jmasked  # noqa: E402
from nmf_tpu.ops import resample as jresample  # noqa: E402
from nmf_tpu.ops import safemath as jsafe  # noqa: E402
from nmf_tpu.ops import sh as jsh  # noqa: E402
from nmf_tpu_torch import train as ttrain  # noqa: E402
from nmf_tpu_torch import weights  # noqa: E402
from nmf_tpu_torch.modules import brdf_samplers as tbs  # noqa: E402
from nmf_tpu_torch.modules.ish import ListISH as TListISH  # noqa: E402
from nmf_tpu_torch.modules.mlp import MLP  # noqa: E402
from nmf_tpu_torch.ops import grid_sample as tgs  # noqa: E402
from nmf_tpu_torch.ops import masked as tmasked  # noqa: E402
from nmf_tpu_torch.ops import resample as tresample  # noqa: E402
from nmf_tpu_torch.ops import safemath as tsafe  # noqa: E402
from nmf_tpu_torch.ops import sh as tsh  # noqa: E402
from nmf_tpu_torch.ops.draws import Draws  # noqa: E402
from torch_parity import (build_flagship_pair,  # noqa: E402
                          calibration_draws)

FWD, GRAD = 1e-5, 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny shapes run fastest on one thread, and the test workers
    share the CPU cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return build_flagship_pair()


def _rng(seed=0):
    return np.random.default_rng(seed)


def _unit(n, seed=0):
    v = _rng(seed).normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _close(a, b, rtol, what="", scale=None):
    """|a - b| <= rtol * (|b| + max|b|): relative to each value, and to the
    array's scale for values near zero."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    s = np.nanmax(np.abs(b)) if scale is None else scale
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * s + 1e-12,
                               err_msg=what)


def _vjp_pair(jfn, tfn, arrays, seed=1):
    """Outputs and input gradients of sum(fn(*x) * cot), both frameworks;
    every output of fn gets its own random cotangent."""
    def jtuple(*a):
        r = jfn(*a)
        return r if isinstance(r, tuple) else (r,)

    jout = jax.jit(jtuple)(*map(jnp.asarray, arrays))
    rng = _rng(seed)
    cots = [rng.normal(size=np.shape(o)).astype(np.float32) for o in jout]
    jg = jax.jit(jax.grad(
        lambda *a: sum((o * c).sum() for o, c in zip(jtuple(*a), cots)),
        argnums=tuple(range(len(arrays)))))(*map(jnp.asarray, arrays))
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    tout = tfn(*ts)
    tout = tout if isinstance(tout, tuple) else (tout,)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(tout, cots))
    if loss.requires_grad:
        loss.backward()
    return ([np.asarray(o) for o in jout], [o.detach().numpy() for o in tout],
            [np.asarray(g) for g in jg],
            [np.zeros(t.shape, np.float32) if t.grad is None
             else t.grad.numpy() for t in ts])


def _assert_vjp(pairs, fwd=FWD, grad=GRAD):
    jo, to, jg, tg = pairs
    for i, (a, b) in enumerate(zip(to, jo)):
        _close(a, b, fwd, f"output {i}")
    for i, (a, b) in enumerate(zip(tg, jg)):
        _close(a, b, grad, f"gradient {i}")


# ---- safemath ----

def test_safe_atan2_and_its_gradient():
    rng = _rng()
    x = rng.normal(size=200).astype(np.float32)
    y = rng.normal(size=200).astype(np.float32)
    x[:5], y[:5] = 0.0, [0.0, 1e-4, -1e-3, 2.0, -1.0]  # the clamped origin
    _assert_vjp(_vjp_pair(jsafe.safe_atan2, tsafe.safe_atan2, [x, y]))


@pytest.mark.parametrize("fn", ["safe_cos", "safe_sin"])
def test_safe_trig(fn):
    x = _rng().uniform(-2000, 2000, 300).astype(np.float32)
    _assert_vjp(_vjp_pair(getattr(jsafe, fn), getattr(tsafe, fn), [x]))


def test_inv_activation_and_signed_clip():
    v = _rng().uniform(0.01, 0.99, 100).astype(np.float32)
    for act in ("sigmoid", "exp"):
        _close(tsafe.inv_activation(torch.from_numpy(v), act).numpy(),
               jsafe.inv_activation(jnp.asarray(v), act), FWD)
        assert tsafe.inv_activation(0.3, act) == jsafe.inv_activation(0.3,
                                                                      act)
    s = np.array([-1.0, -1e-9, 0.0, 1e-9, 2.0], np.float32)
    _close(tsafe.signed_clip(torch.from_numpy(s)).numpy(),
           jsafe.signed_clip(jnp.asarray(s)), 0.0)


# ---- spherical harmonics ----

@pytest.mark.parametrize("dim", [1, 4, 9, 16, 25])
def test_eval_sh_bases(dim):
    _assert_vjp(_vjp_pair(lambda d: jsh.eval_sh_bases(dim, d),
                          lambda d: tsh.eval_sh_bases(dim, d),
                          [_unit(100)]))


def test_sh_basis_lambertian_and_list_ish():
    np.testing.assert_array_equal(tsh.lambertian_coeffs(16).numpy(),
                                  np.asarray(jsh.lambertian_coeffs(16)))
    rough = _rng(3).uniform(0.01, 0.5, 100).astype(np.float32)
    degs = (0, 1, 2, 4)
    _assert_vjp(_vjp_pair(lambda d, r: JListISH(degs)(d, r),
                          lambda d, r: TListISH(degs)(d, r),
                          [_unit(100), rough]))
    assert TListISH(degs).dim() == JListISH(degs).dim() == 18


# ---- the field's derivative filters and normals ----

def test_derivative_kernels_match():
    for s in (1.0, 0.5):
        for a, b in zip(tgs.smoothed_derivative_kernels_2d(s),
                        jgs.smoothed_derivative_kernels_2d(s)):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-15)


def test_derivative_filters_orientation_and_values():
    # an axis-aligned test field: plane value = column index (x, the last
    # axis), line value = index. The x-kernel gives the slope 1 inside the
    # plane, the y-kernel 0, and the line difference 1; zero padding shows
    # at the borders only
    H, W, L = 9, 11, 10
    plane = np.broadcast_to(np.arange(W, dtype=np.float32), (2, H, W)).copy()
    line = np.broadcast_to(np.arange(L, dtype=np.float32), (2, L)).copy()
    kx, ky = tgs.smoothed_derivative_kernels_2d(1.0)
    k1 = np.array([-0.5, 0.0, 0.5])
    dx = tgs.conv2d_same(torch.from_numpy(plane), kx).numpy()
    dy = tgs.conv2d_same(torch.from_numpy(plane), ky).numpy()
    dl = tgs.conv1d_same(torch.from_numpy(line), k1).numpy()
    np.testing.assert_allclose(dx[:, 2:-2, 2:-2], 1.0, rtol=1e-6)
    np.testing.assert_allclose(dy[:, 2:-2, 2:-2], 0.0, atol=1e-6)
    np.testing.assert_allclose(dl[:, 1:-1], 1.0, rtol=1e-6)
    # and against nmf_tpu on a random plane, with gradients
    rng = _rng(4)
    p = rng.normal(size=(3, 12, 13)).astype(np.float32)
    ln = rng.normal(size=(3, 14)).astype(np.float32)
    for k in (kx, ky):
        _assert_vjp(_vjp_pair(lambda x: jgs.conv2d_same(x, k),
                              lambda x: tgs.conv2d_same(x, k), [p]))
    _assert_vjp(_vjp_pair(lambda x: jgs.conv1d_same(x, k1),
                          lambda x: tgs.conv1d_same(x, k1), [ln]))


@pytest.mark.parametrize("dims", [1, 2])
def test_filters_run_without_tf32_and_backward_is_the_adjoint(dims,
                                                             monkeypatch):
    # cuDNN rounds f32 convolutions to TF32 unless told not to: the filters
    # turn it off for their forward and backward and restore the flag. The
    # backward (the flipped kernel) equals F.conv's own gradient, in f64
    name = "conv2d" if dims == 2 else "conv1d"
    conv = getattr(torch.nn.functional, name)
    seen = []

    def spy(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return conv(*args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, name, spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    rng = _rng(9)
    shape = (3, 12, 13) if dims == 2 else (3, 14)
    k = (tgs.smoothed_derivative_kernels_2d(1.0)[0] if dims == 2
         else np.array([-0.5, 0.1, 0.5]))
    x = torch.from_numpy(rng.normal(size=shape)).requires_grad_(True)
    g = torch.from_numpy(rng.normal(size=shape))
    fn = tgs.conv2d_same if dims == 2 else tgs.conv1d_same
    (gx,) = torch.autograd.grad(fn(x, k), x, g)
    assert seen == [False, False]
    assert torch.backends.cudnn.allow_tf32
    w = torch.from_numpy(k).reshape(1, 1, *k.shape)
    (ref,) = torch.autograd.grad(
        conv(x[:, None], w, padding=k.shape[0] // 2)[:, 0], x, g)
    torch.testing.assert_close(gx, ref, rtol=1e-12, atol=1e-12)


def _field_points(n=300, seed=0):
    rng = _rng(seed)
    xyz = rng.uniform(-1.4, 1.4, (n, 3)).astype(np.float32)
    return np.concatenate([xyz, rng.uniform(0, 0.01, (n, 1))],
                          -1).astype(np.float32)


def test_field_normals_and_their_gradients(pair):
    jn, tn, _ = pair
    pts = _field_points()
    rng = _rng(5)
    cots = [rng.normal(size=s).astype(np.float32)
            for s in ((300,), (300, 24), (300, 3))]

    def jloss(rf):
        out = rf.compute_all(jnp.asarray(pts), with_normals=True)
        return sum((o * c).sum() for o, c in zip(out, cots)), out

    (_, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jn.rf)
    tn.rf.aabb.requires_grad_(True)
    tout = tn.rf.compute_all(torch.from_numpy(pts), with_normals=True)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(tout, cots)
        ).backward()
    for name, a, b in zip(("sigma", "app", "normals"), tout, jout):
        _close(a.detach().numpy(), b, FWD, name)
    for key, g in jckpt.state_dict(jg).items():
        t, transpose = weights.port_tensor(tn.rf, key)
        tg = np.zeros_like(g) if t.grad is None else t.grad.numpy()
        _close(tg.T if transpose else tg, g, GRAD, key)
    tn.rf.zero_grad()
    tn.rf.aabb.grad = None
    tn.rf.aabb.requires_grad_(False)


def test_density_in_the_gather_dtype_matches(pair):
    jn, tn, _ = pair
    pts = _field_points(seed=2)
    for use in (False, True):
        _close(tn.rf.compute_densityfeature(torch.from_numpy(pts),
                                            use_gather_dtype=use
                                            ).detach().numpy(),
               jn.rf.compute_densityfeature(jnp.asarray(pts),
                                            use_gather_dtype=use), FWD)


# ---- proposal resampling ----

def _proposal(B=40, K=24, seed=6):
    rng = _rng(seed)
    dists = rng.uniform(0.01, 0.1, (B, K)).astype(np.float32)
    z = (2.5 + np.cumsum(dists, -1) - dists).astype(np.float32)
    w = rng.uniform(0, 1, (B, K)).astype(np.float32) ** 3
    valid = rng.uniform(size=(B, K)) < 0.7
    valid[0] = False          # a ray with no occupied length
    w[1] = 0.0                # a ray the proposal misses: the pad only
    return z, dists, w, valid


@pytest.mark.parametrize("is_train", [True, False])
def test_resample_pdf(is_train):
    # The inverse CDF divides by a segment's CDF increment, which is as
    # small as pad * dl / L where the proposal misses: one ulp of the CDF
    # (a cumsum summed in another order) moves a boundary by up to
    # L * ulp / pad ~ 3e-5 here. Positions and lengths are held to 5e-5 of
    # their largest, gradients to 1e-4.
    z, dists, w, valid = _proposal()
    n = 12
    key = jax.random.PRNGKey(7)
    given = {"resample": np.asarray(jax.random.uniform(key, (40, n + 1)))}
    vj = jnp.asarray(valid)
    vt = torch.from_numpy(valid)

    def jf(z_, d_, w_):
        zf, df, _, vf = jresample.resample_pdf(key, z_, d_, w_, vj, n,
                                               is_train)
        return zf, df

    def tf(z_, d_, w_):
        return tresample.resample_pdf(Draws(None, given), z_, d_, w_, vt, n,
                                      is_train)[:2]

    _assert_vjp(_vjp_pair(jf, tf, [z, dists, w]), fwd=5e-5)
    vf = jresample.resample_pdf(key, *map(jnp.asarray, (z, dists, w)), vj,
                                n, is_train)[3]
    np.testing.assert_array_equal(
        tresample.resample_pdf(Draws(None, given), *map(
            torch.from_numpy, (z, dists, w)), vt, n, is_train)[2].numpy(),
        np.asarray(vf))


# ---- segment sums and row gathers (K3's plain version on the CPU) ----

def test_segment_sum_to_and_take_rows():
    rng = _rng(8)
    R, M, D = 300, 50, 9
    vals = rng.normal(size=(R, D)).astype(np.float32)
    seg = np.sort(rng.integers(0, M, R)).astype(np.int32)
    valid = rng.uniform(size=R) < 0.8
    _assert_vjp(_vjp_pair(
        lambda v: jmasked.segment_sum_to(v, jnp.asarray(seg),
                                         jnp.asarray(valid), M),
        lambda v: tmasked.segment_sum_to(v, torch.from_numpy(seg),
                                         torch.from_numpy(valid), M),
        [vals]))
    x = rng.normal(size=(M, 44)).astype(np.float32)
    _assert_vjp(_vjp_pair(
        lambda a: jnp.take(a, jnp.asarray(seg), axis=0),
        lambda a: tmasked.take_rows_binsum(a, torch.from_numpy(seg)), [x]))


# ---- MLP initializers ----

@pytest.mark.parametrize("init", ["kaiming", "xavier", "xavier_sigmoid",
                                  None])
def test_mlp_initializers(init):
    # the same distributions: every weight within nmf_tpu's bound, spread
    # to it, and biases zero except for the default initializer
    jm = create_mlp(jax.random.PRNGKey(0), 66, 4, num_layers=3, hidden_w=64,
                    initializer=init)
    tm = MLP(66, 4, num_layers=3, hidden_w=64,
             generator=torch.Generator().manual_seed(0), initializer=init)
    for jl, tl in zip(jm.layers, tm.layers):
        jw, tw = np.asarray(jl["w"]), tl.weight.detach().numpy().T
        assert jw.shape == tw.shape
        bound = np.abs(jw).max()
        assert np.abs(tw).max() <= bound * 1.02
        assert np.abs(tw).max() >= bound * 0.9
        jb, tb = np.asarray(jl["b"]), tl.bias.detach().numpy()
        assert (np.abs(jb).max() == 0) == (np.abs(tb).max() == 0)


# ---- bounce-ray sampling ----

def test_radical_inverse_and_hammersley():
    i = np.concatenate([np.arange(70), [2 ** 20 + 3, 2 ** 31 - 1, 2 ** 31,
                                        2 ** 32 - 1]]).astype(np.int64)
    jv = np.asarray(jbs.radical_inverse_base2(jnp.asarray(
        i.astype(np.uint32))))
    np.testing.assert_array_equal(
        tbs.radical_inverse_base2(torch.from_numpy(i)).numpy(), jv)
    rng = _rng(9)
    counts = rng.integers(1, 40, 200).astype(np.int32)
    within = (rng.uniform(size=200) * counts).astype(np.int32)
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    given = {"offset1": np.asarray(jax.random.uniform(k1, (200,))),
             "offset2": np.asarray(jax.random.uniform(k2, (200,)))}
    ju = jbs.hammersley_draw(key, jnp.asarray(within), jnp.asarray(counts),
                             None)
    tu = tbs.hammersley_draw(Draws(None, given), torch.from_numpy(within),
                             torch.from_numpy(counts))
    for a, b in zip(tu, ju):
        _close(a.numpy(), b, FWD)


def test_ggx_sample_and_pdf():
    R = 256
    rng = _rng(10)
    u1 = rng.uniform(size=R).astype(np.float32)
    u2 = rng.uniform(size=R).astype(np.float32)
    V = _unit(R, 11)
    N = _unit(R, 12)
    N = N * np.sign((V * N).sum(-1, keepdims=True))
    N[:4] = [0, 0, 1]      # the x_up branch of the frame
    r1 = rng.uniform(0.01, 0.5, R).astype(np.float32)
    js, ts = jbs.GGXSampler(), tbs.GGXSampler()

    def jf(V_, N_, r_):
        L, basis, logD = js.sample(jnp.asarray(u1), jnp.asarray(u2), V_,
                                   N_, r_, r_)
        return L, basis, logD

    def tf(V_, N_, r_):
        return ts.sample(torch.from_numpy(u1), torch.from_numpy(u2), V_, N_,
                         r_, r_)

    _assert_vjp(_vjp_pair(jf, tf, [V, N, r1]))
    L = _unit(R, 13)
    H = _unit(R, 14)
    _assert_vjp(_vjp_pair(lambda a, b, c, r: js.compute_prob(a, b, c, r, r),
                          lambda a, b, c, r: ts.compute_prob(a, b, c, r, r),
                          [L, V, H, r1]))


# ---- the material head and the BRDF ----

def _features(n, seed=15):
    return _rng(seed).normal(0, 0.3, (n, 24)).astype(np.float32)


def test_mlp_brdf(pair):
    jn, tn, _ = pair
    R = 200
    dirs = [_unit(R, 20 + i) for i in range(7)]
    rough = _rng(27).uniform(0.01, 0.5, R).astype(np.float32)

    def jf(feat, *d):
        return jn.model.brdf(*d, feat, jnp.asarray(rough), jnp.asarray(rough))

    def tf(feat, *d):
        return tn.model.brdf(*d, feat, torch.from_numpy(rough),
                             torch.from_numpy(rough))

    _assert_vjp(_vjp_pair(jf, tf, [_features(R), *dirs]))


def test_rand_hydra_diffuse(pair):
    jn, tn, _ = pair
    M = 200
    key = jax.random.PRNGKey(4)
    kd, kr = jax.random.split(key)
    given = {"diffuse_noise": np.asarray(jax.random.normal(kd, (M, 3))),
             "roughness_noise": np.asarray(jax.random.normal(kr, (M, 2)))}
    pts = _field_points(M)
    vd = _unit(M, 30)
    for std in (0.0, 0.05):
        def jf(feat):
            d, t, m = jn.model.diffuse_module(
                jnp.asarray(pts), jnp.asarray(vd), feat, std=std, key=key)
            return d, t, m["r1"], m["r2"], m["f0"]

        def tf(feat):
            d, t, m = tn.model.diffuse_module(
                torch.from_numpy(pts), torch.from_numpy(vd), feat, std=std,
                draws=Draws(None, given))
            return d, t, m["r1"], m["r2"], m["f0"]

        _assert_vjp(_vjp_pair(jf, tf, [_features(M)]))


# ---- the envmap ----

def test_envmap_matches(pair):
    """The SAT, the box lookups (pole rows and the seam included), the SH
    projection and the gradients of all, against nmf_tpu.

    The SAT is an f32 cumsum over the extended (3, 112, 208) table, summed
    in another order by torch: each entry agrees to 1e-6 of the table's
    largest. A box value is a difference of four such entries divided by
    the box's area, so a box of a few texels carries that error times
    1000 / area: lookups agree to 1e-2 of the map's largest value (5e-3
    seen), the SH coefficients (means over 5,000 lookups) to 1e-4. The
    gradients follow the same differences: the map's to 1e-4, the
    directions' to 5e-3 of their largest (3e-3 seen; the two at each pole
    are NaN in both, where atan2's denominator vanishes).
    """
    jn, tn, _ = pair
    rng = _rng(31)
    bgm = rng.normal(-0.6, 0.5, (3, 32, 64)).astype(np.float32)
    jb = jn.bg_module.replace(bg_mat=jnp.asarray(bgm))
    tb = tn.bg_module
    with torch.no_grad():
        tb.bg_mat.copy_(torch.from_numpy(bgm))
    scale = float(np.exp(bgm).max())

    jc, tc = jax.jit(lambda b: b.prepare())(jb), tb.prepare()
    _close(tc["cum_mat"].detach().numpy(), jc["cum_mat"], 1e-6, "SAT")
    for k in ("top_row", "bot_row"):
        _close(tc[k].detach().numpy(), jc[k], FWD, k)
    _close(tc["sh_conv_coeffs"].numpy(), jc["sh_conv_coeffs"], 1e-4, "SH",
           scale=scale)
    _close(tb.mean_color().detach().numpy(), jb.mean_color(), FWD)

    n = 400
    d = _unit(n, 32)
    d[:6] = [[0, 0, 1], [0, 0, -1], [0.01, 0, 0.9999], [-1, 1e-4, 0],
             [-1, -1e-4, 0], [0.3, 0.0, -0.95]]  # poles and the seam
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    mip = rng.uniform(-9, 3, n).astype(np.float32)
    cot = rng.normal(size=(n, 3)).astype(np.float32)

    def jloss(bg_mat, dirs):
        b = jb.replace(bg_mat=bg_mat)
        out = b(dirs, jnp.asarray(mip), cache=b.prepare(with_sh=False))
        return (out * cot).sum(), out

    (_, jo), (jg_map, jg_dir) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(bgm),
                                              jnp.asarray(d))
    dt = torch.tensor(d, requires_grad=True)
    tb.bg_mat.grad = None
    to = tb(dt, torch.from_numpy(mip), cache=tb.prepare(with_sh=False))
    (to * torch.from_numpy(cot)).sum().backward()
    _close(to.detach().numpy(), jo, 1e-2, "lookups", scale=scale)
    _close(tb.bg_mat.grad.numpy(), jg_map, 1e-4, "d map")
    _close(dt.grad.numpy(), jg_dir, 5e-3, "d directions")
    # lookups whose box spans many texels are held at the forward tolerance
    big = np.asarray(jax.jit(jb.sa2mip)(jnp.asarray(d),
                                        jnp.asarray(mip))[1]) > 4
    assert big.sum() > 50
    _close(to.detach().numpy()[big], np.asarray(jo)[big], FWD, "big boxes",
           scale=scale)
    tb.bg_mat.grad = None


# ---- the three calibrations ----

@pytest.mark.parametrize("which", ["diffuse", "brdf", "model"])
def test_calibration(which):
    jn, tn, _ = build_flagship_pair()
    key = jax.random.PRNGKey(11)
    d = calibration_draws(key)
    if which == "model":
        jnew = jtrain.calibrate_model(jn, key).model
        ttrain.calibrate_model(tn, Draws(None, d))
        pairs = [(tn.model.diffuse_module.diffuse_bias,
                  jnew.diffuse_module.diffuse_bias),
                 (tn.model.diffuse_module.roughness_bias,
                  jnew.diffuse_module.roughness_bias),
                 (tn.model.brdf.bias, jnew.brdf.bias)]
    else:
        xyz = jnp.asarray(d["xyz"]) * 2 - 1
        xyz = xyz.at[:, 3].set(0.0)
        feat = jn.rf.compute_appfeature(xyz)
        tfeat = torch.from_numpy(np.asarray(feat))
        if which == "diffuse":
            vd = jsafe.normalize(jnp.asarray(d["model/viewdirs"]))
            jm = jn.model.diffuse_module.calibrate(0.6, True, xyz, vd, feat)
            tn.model.diffuse_module.calibrate(
                0.6, True, torch.from_numpy(np.asarray(xyz)),
                torch.from_numpy(np.asarray(vd)), tfeat)
            pairs = [(tn.model.diffuse_module.diffuse_bias, jm.diffuse_bias),
                     (tn.model.diffuse_module.roughness_bias,
                      jm.roughness_bias)]
        else:
            kb = jax.random.split(jax.random.split(key)[1])[1]
            jm = jn.model.brdf.calibrate(kb, feat, 0.6)
            tn.model.brdf.calibrate(Draws(None, d).scoped("model").scoped(
                "brdf"), tfeat, 0.6)
            pairs = [(tn.model.brdf.bias, jm.bias)]
    for t, j in pairs:
        # means over 10,000 (x 3) values summed in another order
        _close(t.detach().numpy(), np.asarray(j), FWD)
