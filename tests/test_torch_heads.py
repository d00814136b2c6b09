"""The shading heads' modules of nmf_tpu_torch against nmf_tpu's, on the
CPU at tiny widths: every direction encoder (degree-8 ListISH, FullISH,
FullISHScaled, PE, IPE, ISH, RandISH, RandRotISH; the random rotations,
the degrees and the Legendre coefficients behind them), each material
head (RandHydraMLPDiffuse with its position and view encoders,
HydraMLPDiffuse, MLPDiffuse, PassthroughDiffuse) with its calibration,
the BRDF's ``dotpe`` and ``sigexp`` with its calibration, the Specular
BRDF, and the envmap's activations, ``mipnoise`` and ``sh_grad`` (the SH
projection's gradient), each through the builders of both packages with
nmf_tpu's weights carried over.

Tolerances: outputs 1e-5 and gradients 1e-4 of each array's largest
(``_close``); calibrated biases 1e-5 (means over 2,048 values summed in
another order); the rotation matrices 1e-12 (numpy's product of the three
axis rotations against scipy's quaternion path) and the Legendre
coefficients 1e-9 of the largest (numpy's exact ones against scipy's,
which come from the polynomial's roots).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nmf_tpu import builders as jbuilders  # noqa: E402
from nmf_tpu import ckpt as jckpt  # noqa: E402
from nmf_tpu.modules import bg as jbg  # noqa: E402
from nmf_tpu.modules import brdf as jbrdf  # noqa: E402
from nmf_tpu.modules import ish as jish  # noqa: E402
from nmf_tpu.modules.render_modules import IPE as JIPE  # noqa: E402
from nmf_tpu.modules.visibility import ERBrightSampler as JBright  # noqa: E402
from nmf_tpu.ops import sh as jsh  # noqa: E402
from nmf_tpu_torch import builders as tbuilders  # noqa: E402
from nmf_tpu_torch import weights  # noqa: E402
from nmf_tpu_torch.modules import bg as tbg  # noqa: E402
from nmf_tpu_torch.modules import brdf as tbrdf  # noqa: E402
from nmf_tpu_torch.modules import ish as tish  # noqa: E402
from nmf_tpu_torch.modules.render_modules import IPE as TIPE  # noqa: E402
from nmf_tpu_torch.modules.visibility import ERBrightSampler  # noqa: E402
from nmf_tpu_torch.ops import sh as tsh  # noqa: E402
from nmf_tpu_torch.ops.draws import Draws  # noqa: E402

FWD, GRAD = 1e-5, 1e-4
APP = 24


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unit(n, seed):
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _close(a, b, rtol, what="", scale=None):
    """|a - b| <= rtol * (|b| + max|b|)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    s = np.abs(b).max() if scale is None else scale
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * s + 1e-12,
                               err_msg=what)


def _vjp(jfn, tfn, arrays, seed=1):
    """Both packages' outputs of fn(*arrays) (a tuple or one array) and
    the gradients of sum(out * cot) to every input, held to FWD / GRAD;
    nmf_tpu's in one compiled call."""
    def jtuple(*a):
        r = jfn(*a)
        return r if isinstance(r, tuple) else (r,)

    jarrays = list(map(jnp.asarray, arrays))
    rng = np.random.default_rng(seed)
    cots = [rng.normal(size=o.shape).astype(np.float32)
            for o in jax.eval_shape(jtuple, *jarrays)]

    def jloss(*a):
        outs = jtuple(*a)
        return sum((o * c).sum() for o, c in zip(outs, cots)), outs

    (_, jout), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(len(arrays))), has_aux=True))(*jarrays)
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    tout = tfn(*ts)
    tout = tout if isinstance(tout, tuple) else (tout,)
    assert len(tout) == len(jout)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(tout, cots)
        ).backward()
    for i, (t, j) in enumerate(zip(tout, jout)):
        assert tuple(t.shape) == tuple(j.shape), i
        _close(t.detach().numpy(), j, FWD, f"output {i}")
    for i, (t, g) in enumerate(zip(ts, jg)):
        tg = np.zeros(t.shape) if t.grad is None else t.grad.numpy()
        _close(tg, g, GRAD, f"gradient {i}")


@torch.no_grad()
def _carry(tmod, jmod):
    """nmf_tpu's leaves of ``jmod`` into the port's ``tmod``, by path;
    both state dicts must hold the same keys and shapes."""
    jsd = jckpt.state_dict(jmod)
    tsd = weights.to_jax_state_dict(tmod)
    assert sorted(tsd) == sorted(jsd)
    for k, v in jsd.items():
        assert tsd[k].shape == v.shape, k
        t, transpose = weights.port_tensor(tmod, k)
        t.copy_(torch.tensor(np.asarray(v).T if transpose else v))
    return tmod


def _grads_match(tmod, jgrads, rtol=GRAD, scales=None):
    """Every gradient of nmf_tpu's ``jgrads`` against the port's (none:
    zero); ``scales``: {key: the scale its tolerance is relative to}."""
    for k, g in jckpt.state_dict(jgrads).items():
        t, transpose = weights.port_tensor(tmod, k)
        tg = np.zeros(g.shape) if t.grad is None else (
            t.grad.t() if transpose else t.grad).numpy()
        _close(tg, g, rtol, k, scale=(scales or {}).get(k))


# ---- spherical harmonics ----

def test_sh_basis_degree_8_and_scaled_bases():
    """sh_basis of degrees 0, 1, 2, 4, 8 with the vMF attenuation, and
    eval_sh_bases_scaled at every width up to 25: values and the
    gradients to the directions and kappa."""
    dirs = _unit(300, 0)
    kappa = np.random.default_rng(1).uniform(0.5, 20, 300).astype(
        np.float32)
    degs, dims = (0, 1, 2, 4, 8), (1, 4, 7, 9, 16, 25)

    def bases(pkg):
        return lambda d, k: (pkg.sh_basis(degs, d, k), *(
            pkg.eval_sh_bases_scaled(dim, d, k) for dim in dims))

    _vjp(bases(jsh), bases(tsh), [dirs, kappa])
    with pytest.raises(NotImplementedError):
        tsh.sh_basis((3,), torch.from_numpy(dirs))


# ---- direction encoders ----

# (config of both packages' build_encoder, or the class pair when no
# target reaches it)
ENCODERS = {
    "ListISH deg 8": {"_target_": "modules.ish.ListISH",
                      "degs": [0, 1, 2, 4, 8]},
    "FullISH": {"_target_": "modules.ish.FullISH", "max_degree": 4},
    "FullISHScaled": {"_target_": "modules.ish.FullISHScaled",
                      "max_degree": 3},
    "PE": {"_target_": "modules.render_modules.PE", "max_degree": 4},
    "IPE": (JIPE(max_degree=4), TIPE(max_degree=4)),
    "ISH": {"_target_": "modules.ish.ISH", "max_degree": 4},
    "RandISH": {"_target_": "modules.ish.RandISH"},
    "RandRotISH": {"_target_": "modules.ish.RandRotISH"},
}


def _encoders(name):
    cfg = ENCODERS[name]
    if isinstance(cfg, tuple):
        return cfg
    return jbuilders.build_encoder(cfg), tbuilders.build_encoder(cfg)


@pytest.mark.parametrize("name", list(ENCODERS))
def test_encoder_matches(name):
    """Width, values and the gradients to the directions and the
    roughness (which FullISH and PE ignore)."""
    je, te = _encoders(name)
    assert je.dim() == te.dim()
    dirs = _unit(256, len(name))
    rough = np.random.default_rng(3).uniform(0.05, 0.6, 256).astype(
        np.float32)
    _vjp(lambda d, r: je(d, r), lambda d, r: te(d, r), [dirs, rough])
    assert tuple(te(torch.from_numpy(dirs), torch.from_numpy(rough)).shape
                 ) == (256, te.dim())


def test_random_rotations_degrees_and_legendre_coefficients():
    """RandISH's and RandRotISH's rotation matrices from the same seed
    (scipy's extrinsic x-y-z Euler angles in nmf_tpu), RandISH's degrees,
    and every SHBasis degree's Legendre coefficients and its values on
    (theta, phi, kappa)."""
    for n, seed in ((8, 0), (4, 0), (5, 7)):
        want = np.asarray(jish._random_rotations(n, seed)).reshape(n, 3, 3)
        np.testing.assert_allclose(tish.random_rotations(n, seed), want,
                                   rtol=0, atol=1e-12)
    for rand_n, std, seed in ((8, 10.0, 0), (6, 3.0, 2)):
        jdegs = jish.RandISH(rand_n=rand_n, std=std, seed=seed)._setup()[1]
        assert tish.RandISH(rand_n, std, seed).degs == tuple(
            int(d) for d in jdegs)
    rng = np.random.default_rng(5)
    theta = rng.uniform(-3, 0, (200, 1)).astype(np.float32)
    phi = rng.uniform(-3, 3, (200, 1)).astype(np.float32)
    kappa = rng.uniform(1, 30, (200, 1)).astype(np.float32)
    for l in range(10):
        want = np.asarray(jish._legendre_coeffs(l))
        got = np.asarray(tish.legendre_coeffs(l))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-9 * np.abs(want).max())
    _vjp(lambda t, p, k: tuple(jish.SHBasis(deg=l)(t, p, k)
                               for l in range(10)),
         lambda t, p, k: tuple(tish.SHBasis(l)(t, p, k) for l in range(10)),
         [theta, phi, kappa])


# ---- material heads ----

def _diffuse_cfg(target, **kw):
    return {"_target_": f"modules.render_modules.{target}", **kw}


HYDRA = {"hidden_w": 16, "num_layers": 2, "initializer": "xavier_sigmoid",
         "roughness_cfg": {"hidden_w": 8, "num_layers": 1}}
HEADS = {
    # the card path's encoders: IPE (it builds PE) and RandRotISH
    "rand_hydra pospe4 IPE RandRotISH": _diffuse_cfg(
        "RandHydraMLPDiffuse", pospe=4, feape=0, **HYDRA,
        view_encoder={"_target_": "modules.render_modules.IPE",
                      "max_degree": 4},
        roughness_view_encoder={"_target_": "modules.ish.RandRotISH"}),
    "rand_hydra pospe0 feape-1 ISH FullISHScaled": _diffuse_cfg(
        "RandHydraMLPDiffuse", pospe=0, feape=-1, **HYDRA,
        view_encoder={"_target_": "modules.ish.ISH", "max_degree": 3},
        roughness_view_encoder={"_target_": "modules.ish.FullISHScaled",
                                "max_degree": 2}),
    "rand_hydra ListISH8 RandISH": _diffuse_cfg(
        "RandHydraMLPDiffuse", pospe=2, feape=1, **HYDRA,
        view_encoder={"_target_": "modules.ish.ListISH",
                      "degs": [0, 1, 2, 4, 8]},
        roughness_view_encoder={"_target_": "modules.ish.RandISH",
                                "rand_n": 4}),
    "hydra": _diffuse_cfg("HydraMLPDiffuse", pospe=4, feape=1, featureC=16,
                          num_layers=2),
    "mlp_diffuse": _diffuse_cfg("MLPDiffuse", pospe=4, feape=1, featureC=16,
                                num_layers=2, diffuse_bias=-0.619),
    "passthrough": _diffuse_cfg("PassthroughDiffuse"),
}


def _head_inputs(M, seed):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-1, 1, (M, 3)),
                          rng.uniform(1e-3, 2e-2, (M, 1))], -1)
    feats = rng.normal(0, 0.5, (M, APP))
    return [pts.astype(np.float32), _unit(M, seed + 1),
            feats.astype(np.float32)]


@pytest.mark.parametrize("name", list(HEADS))
def test_material_head_matches(name):
    """Built by both packages' build_diffuse with nmf_tpu's weights: the
    state-dict keys and shapes, albedo, tint and every matprop entry (the
    RandHydra heads with train-time noise of std 0.1 on nmf_tpu's normal
    draws), the gradients to every parameter and input, then each head's
    calibrated biases (the RandHydra calibration once, with the ISH
    encoders: nmf_tpu's runs op by op, and its encoders do not enter
    the bias arithmetic)."""
    cfg = HEADS[name]
    jm = jbuilders.build_diffuse(jax.random.PRNGKey(1), cfg, APP)
    tm = _carry(tbuilders.build_diffuse(None, cfg, APP), jm)
    M = 256
    pts, vd, feats = _head_inputs(M, len(name))
    noisy = name.startswith("rand_hydra")
    key = jax.random.PRNGKey(4)
    draws = None
    if noisy:
        kd, kr = jax.random.split(key)
        draws = Draws(None, {
            "diffuse_noise": np.asarray(jax.random.normal(kd, (M, 3))),
            "roughness_noise": np.asarray(jax.random.normal(kr, (M, 2)))})
    keys = ("diffuse", "r1", "r2", "f0")

    def jout(m, p, v, f):
        d, t, mp = m(p, v, f, std=0.1, key=key if noisy else None)
        return (d, t) + tuple(mp[k] for k in keys)

    rng = np.random.default_rng(9)
    jins = [jm, *map(jnp.asarray, (pts, vd, feats))]
    cots = [rng.normal(size=o.shape).astype(np.float32)
            for o in jax.eval_shape(jout, *jins)]

    def jloss(*a):
        o = jout(*a)
        return sum((x * c).sum() for x, c in zip(o, cots)), o

    (_, outs), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True))(*jins)
    ins = [torch.tensor(a, requires_grad=True) for a in (pts, vd, feats)]
    d, t, mp = tm(*ins, std=0.1, draws=draws)
    tout = (d, t) + tuple(mp[k] for k in keys)
    if name == "mlp_diffuse":
        assert tuple(mp["f0"].shape) == (M, 1)  # nmf_tpu's one column
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(tout, cots)
        ).backward()
    for k, o, j in zip(("albedo", "tint") + keys, tout, outs):
        assert tuple(o.shape) == tuple(j.shape), k
        _close(o.detach().numpy(), j, FWD, k)
    for what, tin, g in zip(("pts", "viewdirs", "features"), ins, jg[1:]):
        _close(np.zeros(g.shape) if tin.grad is None else tin.grad.numpy(),
               g, GRAD, what)
    _grads_match(tm, jg[0])

    if noisy and "ISH FullISHScaled" not in name:
        return
    jcal = jm.calibrate(0.6, True, *map(jnp.asarray, (pts, vd, feats)))
    tm.calibrate(0.6, True, *map(torch.from_numpy, (pts, vd, feats)))
    for k, v in jckpt.state_dict(jcal).items():
        if k.endswith("_bias"):
            _close(weights.port_tensor(tm, k)[0].detach().numpy(), v, FWD, k)


# ---- the BRDF ----

BRDFS = {
    "dotpe 0": {"dotpe": 0},
    "dotpe 2": {"dotpe": 2},
    "sigexp": {"activation": "sigexp"},
    # the card path's: dotpe 2, sigexp, a degree-8 diffuse-vector encoder
    "heads path": {"dotpe": 2, "activation": "sigexp", "d_degs": (0, 1, 2, 4,
                                                                 8)},
    "softplus": {"activation": "softplus"},
}


def _brdf_pair(case):
    kw = dict(BRDFS[case])
    d_degs = kw.pop("d_degs", (0, 1, 2, 4))
    kw.update(hidden_w=16, num_layers=2, bias=0.3)
    jb = jbrdf.init_mlp_brdf(jax.random.PRNGKey(2), APP,
                             h_encoder=jish.ListISH((0, 1, 2, 4)),
                             d_encoder=jish.ListISH(d_degs), **kw)
    tb = tbrdf.init_mlp_brdf(APP, h_encoder=tish.ListISH((0, 1, 2, 4)),
                             d_encoder=tish.ListISH(d_degs), **kw)
    return jb, _carry(tb, jb)


def _brdf_inputs(R, seed):
    rng = np.random.default_rng(seed)
    dirs = [_unit(R, seed + i) for i in range(7)]
    feats = rng.normal(0, 0.5, (R, APP)).astype(np.float32)
    ax, ay = rng.uniform(0.05, 0.9, (2, R)).astype(np.float32)
    return dirs + [feats, ax, ay]


@pytest.mark.parametrize("case", list(BRDFS))
def test_brdf_matches(case):
    """MLPBRDF with the dot-product inputs and their IPE, or sigexp: the
    weights, the gradients to V, the features and every parameter, then
    the calibrated bias (sigexp inverts as the sigmoid and shifts a bias
    it never reads; softplus has no inverse: ValueError in both)."""
    jb, tb = _brdf_pair(case)
    args = _brdf_inputs(256, len(case))
    cot = np.random.default_rng(2).normal(size=(256, 3)).astype(np.float32)

    def jfun(b, V, f):
        a = list(map(jnp.asarray, args))
        a[0], a[7] = V, f
        w = b(*a)
        return (w * cot).sum(), w

    (_, jw), jg = jax.jit(jax.value_and_grad(
        jfun, argnums=(0, 1, 2), has_aux=True))(
            jb, jnp.asarray(args[0]), jnp.asarray(args[7]))
    ins = [torch.tensor(args[0], requires_grad=True),
           torch.tensor(args[7], requires_grad=True)]
    a = list(map(torch.from_numpy, args))
    a[0], a[7] = ins
    w = tb(*a)
    (w * torch.from_numpy(cot)).sum().backward()
    _close(w.detach().numpy(), jw, FWD, "weight")
    for what, t, g in zip(("d V", "d features"), ins, jg[1:]):
        # V enters through the dot products only
        _close(np.zeros(g.shape) if t.grad is None else t.grad.numpy(), g,
               GRAD, what)
    _grads_match(tb, jg[0])

    key = jax.random.PRNGKey(6)
    ks = jax.random.split(key, 7)
    N = 2048
    d = {"eax": np.asarray(jax.random.uniform(ks[0], (N,))),
         "eay": np.asarray(jax.random.uniform(ks[1], (N,)))}
    d.update({f"vec{i}": np.asarray(jax.random.uniform(ks[i], (N, 3)))
              for i in range(7)})
    feats = np.random.default_rng(3).normal(0, 0.5, (N, APP)).astype(
        np.float32)
    if case == "softplus":
        with pytest.raises(ValueError):
            jb.calibrate(key, jnp.asarray(feats), 0.6)
        with pytest.raises(ValueError):
            tb.calibrate(Draws(None, d), torch.from_numpy(feats), 0.6)
        return
    jnew = jb.calibrate(key, jnp.asarray(feats), 0.6)
    tb.calibrate(Draws(None, d), torch.from_numpy(feats), 0.6)
    _close(float(tb.bias.detach()), float(jnew.bias), FWD, "bias")


@pytest.mark.parametrize("num_layers", [0, 1])
def test_specular_matches(num_layers):
    """The Specular BRDF called directly: its state dict (none at
    num_layers 0, whose C0 is the identity of the features' 24 columns),
    its weights (R, 24) or (R, 3), and the gradients to the features, the
    local view and diffuse vectors, the roughnesses and the C0 MLP."""
    js = jbrdf.init_specular(jax.random.PRNGKey(3), APP, bias=0.2,
                             hidden_w=16, num_layers=num_layers)
    ts = _carry(tbrdf.init_specular(APP, bias=0.2, hidden_w=16,
                                    num_layers=num_layers), js)
    assert len(jckpt.state_dict(js)) == 2 * num_layers
    args = _brdf_inputs(256, 11)
    # local vectors in the upper hemisphere, as the shading frame gives
    for i in (4, 5, 6):
        args[i] = args[i] * np.sign(args[i][:, 2:3])
    diff = (4, 5, 6, 7, 8, 9)

    def call(mod, npkg):
        def f(*x):
            a = [npkg(v) for v in args]
            for i, v in zip(diff, x):
                a[i] = v
            return mod(*a)
        return f

    _vjp(call(js, jnp.asarray), call(ts, torch.from_numpy),
         [args[i] for i in diff])
    out = ts(*map(torch.from_numpy, args))
    assert tuple(out.shape) == (256, APP if num_layers == 0 else 3)
    if num_layers:
        ts.zero_grad(set_to_none=True)

        def jfun(m):
            return (m(*map(jnp.asarray, args)) ** 2).sum()

        jg = jax.grad(jfun)(js)
        (ts(*map(torch.from_numpy, args)) ** 2).sum().backward()
        _grads_match(ts, jg)


# ---- the envmap ----

def _envmap_pair(seed, **kw):
    """A 16 x 32 envmap of both packages with a random map around
    ``mean``."""
    mean = kw.pop("mean", -0.6)
    jb = jbg.init_integral_equirect(jax.random.PRNGKey(0), bg_resolution=16,
                                    **kw)
    tb = tbg.init_integral_equirect(bg_resolution=16, **kw)
    mat = np.random.default_rng(seed).normal(mean, 0.5, (3, 16, 32))
    jb = jb.replace(bg_mat=jnp.asarray(mat.astype(np.float32)))
    return jb, _carry(tb, jb)


def _lookup_args(n, seed):
    """Unit directions and log solid angles whose boxes span 1 to ~60
    texels a side (mip levels 0 to ~6)."""
    sa = np.random.default_rng(seed).uniform(-4, 4, n).astype(np.float32)
    return _unit(n, seed), sa


def _big(jb, dirs, sa):
    """The lookups whose box spans 16 or more rows."""
    return np.asarray(jb.sa2mip(jnp.asarray(dirs), jnp.asarray(sa))[1]) > 4


@pytest.mark.parametrize("activation", ["exp", "softplus", "clip",
                                        "identity"])
def test_envmap_activation_matches(activation):
    """A random map with ``sh_grad``: the lookups of 512 directions, the
    cache's SH irradiance coefficients, and the gradients of both to the
    map, its brightness and mul; then the bright-ray sampler's directions
    and pdf, which read the map through the activation.

    Tolerances as tests/test_torch_flagship_modules.py's envmap test: the
    two SATs are cumulative sums in another order, and a box's integral
    is a difference of four SAT entries, so lookups agree to 1e-2 of the
    activated map's largest value (7e-4 seen) and those of boxes of 16
    rows or more to 1e-5, the SH coefficients to 1e-4 of it (2e-5 seen),
    the map's gradient to 1e-4; the brightness and mul gradients, sums of
    a term a texel, to 1e-4 of those terms' summed magnitudes
    (``torch_parity.envmap_scalar_scales``). The mip bias takes no
    gradient here (held still in both): its gradient is the SAT's slope
    at each box corner, a difference of rounded SAT entries, which the
    activation does not enter."""
    jb, tb = _envmap_pair(4, activation=activation, sh_grad=True, mean=0.4)
    dirs, sa = _lookup_args(512, 5)
    rng = np.random.default_rng(6)
    cot = rng.normal(size=(512, 3)).astype(np.float32)
    cot_sh = rng.normal(size=(9, 3)).astype(np.float32)

    def jfun(b):
        b = b.replace(mipbias=jax.lax.stop_gradient(b.mipbias))
        cache = b.prepare()
        vals = b(jnp.asarray(dirs), jnp.asarray(sa), cache=cache)
        return ((vals * cot).sum() + (cache["sh_conv_coeffs"] * cot_sh).sum(),
                (vals, cache["sh_conv_coeffs"]))

    (_, (jv, jc)), jg = jax.jit(jax.value_and_grad(jfun, has_aux=True))(jb)
    tb.mipbias.requires_grad_(False)
    cache = tb.prepare()
    tv = tb(torch.from_numpy(dirs), torch.from_numpy(sa), cache=cache)
    assert cache["sh_conv_coeffs"].requires_grad
    ((tv * torch.from_numpy(cot)).sum()
     + (cache["sh_conv_coeffs"] * torch.from_numpy(cot_sh)).sum()).backward()
    scale = float(np.abs(np.asarray(jb.activation_fn(jb.bg_mat))).max())
    big = _big(jb, dirs, sa)
    assert big.sum() > 50
    tv = tv.detach().numpy()
    _close(tv, jv, 1e-2, "lookups", scale=scale)
    _close(tv[big], np.asarray(jv)[big], FWD, "big boxes", scale=scale)
    _close(cache["sh_conv_coeffs"].detach().numpy(), jc, 1e-4, "SH",
           scale=scale)
    g = np.abs(np.asarray(jg.bg_mat, np.float64))
    x = np.abs(np.asarray(jb.bg_mat, np.float64))
    _grads_match(tb, jg, scales={".brightness": g.sum(),
                                 ".mul": (g * x).sum()})

    n = 1024
    kb = jax.random.split(jax.random.PRNGKey(8), 3)
    draws = Draws(None, {nm: np.asarray(jax.random.uniform(k, (n,)))
                         for nm, k in zip(("u", "jy", "jx"), kb)})
    jd, jpdf = JBright().sample(jax.random.PRNGKey(8), jb, n)
    with torch.no_grad():
        td, tpdf = ERBrightSampler().sample(draws, tb, n)
    _close(td.numpy(), jd, FWD, "bright dirs")
    _close(tpdf.numpy(), jpdf, FWD, "bright pdf")


def test_envmap_without_sh_grad_keeps_no_sh_graph():
    """Without ``sh_grad`` the cache's SH coefficients carry no gradient
    in either package: the map's gradient is the lookups' alone."""
    jb, tb = _envmap_pair(6)
    jg = jax.jit(jax.grad(
        lambda b: b.prepare()["sh_conv_coeffs"].sum()))(jb)
    assert not np.asarray(jg.bg_mat).any()
    assert not tb.prepare()["sh_conv_coeffs"].requires_grad


def test_mipnoise_draws_match():
    """``mipnoise`` 0.1 with nmf_tpu's key against the port's draws of the
    same uniforms (``mip_w``, ``mip_h``), at the lookups' tolerances of
    test_envmap_activation_matches; the noise moves the big boxes'
    lookups by far more than their tolerance. Without draws the lookup is
    the noiseless one, as nmf_tpu's without a key."""
    jb, tb = _envmap_pair(7, mipnoise=0.1)
    dirs, sa = _lookup_args(512, 8)
    key = jax.random.PRNGKey(3)
    kw, kh = jax.random.split(key)
    draws = Draws(None, {"mip_w": np.asarray(jax.random.uniform(kw, (512,))),
                         "mip_h": np.asarray(jax.random.uniform(kh, (512,)))})
    jv, jplain = map(np.asarray, jax.jit(lambda b, d, a: (
        b(d, a, key=key), b(d, a)))(jb, jnp.asarray(dirs), jnp.asarray(sa)))
    with torch.no_grad():
        tv = tb(torch.from_numpy(dirs), torch.from_numpy(sa),
                draws=draws).numpy()
        tplain = tb(torch.from_numpy(dirs), torch.from_numpy(sa)).numpy()
    scale = float(np.exp(np.asarray(jb.bg_mat)).max())
    big = _big(jb, dirs, sa)
    for what, t, j in (("noisy", tv, jv), ("noiseless", tplain, jplain)):
        _close(t, j, 1e-2, what, scale=scale)
        _close(t[big], j[big], FWD, f"{what} big boxes", scale=scale)
    assert np.abs(jv[big] - jplain[big]).max() > 100 * FWD * scale
