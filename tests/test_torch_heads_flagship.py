"""The shading heads' knobs in the tiny flagship of
``torch_inputs.FLAGSHIP``, nmf_tpu_torch against nmf_tpu on the CPU: one
train step with the envmap's ``sh_grad`` and one with every knob of
chip_smoke.py's ``heads`` path (after the calibration), checkpoints of
each new head read by each package, Ref-NeRF's reflection encoder, and
what nmf_tpu itself cannot run (ROADMAP C.12): the Specular BRDF in a
Microfacet, the SHBasis target, and MLPDiffuse's one-column f0, which
makes nmf_tpu's tint map infinite and its gradients non-finite. The port
holds that head against nmf_tpu with the guard written here: the f0
broadcast to three columns, as the port's Microfacet packs it. Of the
clip and identity envmaps at the shipped init, the port's zero map
gradient.

Tolerances: the loss and the metrics 1e-5; gradients 5e-4 of each
tensor's largest, as tests/test_torch_flagship.py's train steps (the
normals of a random field turn ulp differences of the sample positions
into 1e-4-relative differences of the bounce directions); the envmap's
brightness and mul gradients 1e-4 of their terms' summed magnitudes
(``torch_parity.envmap_scalar_scales``); the updated tensors as
``torch_parity.params_match``. The envmap's mip bias is 12, so every
lookup box spans the map (test_torch_flagship.py), save where it says.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax import struct  # noqa: E402

from nmf_tpu import builders as jbuilders  # noqa: E402
from nmf_tpu import ckpt as jckpt  # noqa: E402
from nmf_tpu import config as jconfig  # noqa: E402
from nmf_tpu import train as jtrain  # noqa: E402
from nmf_tpu import trainer as jtrainer  # noqa: E402
from nmf_tpu.builders import build_nmf as jbuild  # noqa: E402
from nmf_tpu.data.blender import load_dataset as jload  # noqa: E402
from nmf_tpu.modules.render_modules import MLPDiffuse as JMLPDiffuse  # noqa: E402
from nmf_tpu_torch import builders as tbuilders  # noqa: E402
from nmf_tpu_torch import ckpt as tckpt  # noqa: E402
from nmf_tpu_torch import train as ttrain  # noqa: E402
from nmf_tpu_torch import trainer as ttrainer  # noqa: E402
from nmf_tpu_torch import weights  # noqa: E402
from nmf_tpu_torch.builders import build_nmf as tbuild  # noqa: E402
from nmf_tpu_torch.modules.render_modules import PE as TPE  # noqa: E402
from nmf_tpu_torch.ops.draws import Draws  # noqa: E402
from nmf_tpu_torch.render import reflection_fn  # noqa: E402
from torch_inputs import FLAGSHIP, REFNERF  # noqa: E402
from torch_parity import (AABB, NEAR_FAR, build_flagship_pair,  # noqa: E402
                          build_pair, calibration_draws, close,
                          envmap_scalar_scales, grads_match, jax_reflection,
                          params_match, render_draws, shade_draws,
                          shade_inputs)

FWD, GRAD = 1e-5, 5e-4
MIPBIAS = 12.0
B = 64
DM = "model.arch.model.diffuse_module."
# the knobs of chip_smoke.py's heads path
HEADS = [f"{DM}view_encoder._target_=modules.render_modules.IPE",
         f"{DM}view_encoder.max_degree=4",
         f"{DM}roughness_view_encoder._target_=modules.ish.RandRotISH",
         f"{DM}pospe=4",
         "model.arch.model.brdf.dotpe=2",
         "model.arch.model.brdf.activation=sigexp",
         "model.arch.model.brdf.d_encoder.degs=[0,1,2,4,8]",
         "model.arch.bg_module.activation=softplus",
         "model.arch.bg_module.sh_grad=true",
         "model.arch.bg_module.mipnoise=0.1"]
SH_GRAD = ["model.arch.bg_module.sh_grad=true"]
MLP_DIFFUSE = [f"{DM}_target_=modules.render_modules.MLPDiffuse"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(extra, mipbias=MIPBIAS):
    jn, tn, cfg = build_flagship_pair(extra=extra)
    with torch.no_grad():
        tn.bg_module.mipbias.fill_(mipbias)
    return jn.replace(bg_module=jn.bg_module.replace(
        mipbias=jnp.asarray(mipbias, jnp.float32))), tn, cfg


def _batch():
    ds = jload({"dataset_name": "synthetic_sphere", "n_views": 4,
                "image_size": 16}, None, "train")
    ids = np.random.default_rng(0).choice(ds["all_rays"].shape[0], B,
                                          replace=False)
    return ds["all_rays"][ids], ds["all_rgbs"][ids]


def _weights(params):
    """The port's loss weights of ``params`` and nmf_tpu's equal ones."""
    tw = ttrain.make_loss_weights(params)
    return tw, jtrainer.LossWeights(
        ori_lambda=tw.ori_lambda, pred_lambda=tw.pred_lambda,
        l1_weight=tw.l1_weight, tv_weight_bg=tw.tv_weight_bg,
        normal_err_lambda=tw.normal_err_lambda)


def _port_loss(tn, jn, tw, rays, rgb, key):
    return ttrainer.compute_loss(
        tn, torch.from_numpy(rays), torch.from_numpy(rgb), tw,
        (1.0, 1.0, 1.0), draws=Draws(None, render_draws(key, jn, B, True)))


def _train_step(extra, calibrate=False):
    """One train step of the tiny flagship with ``extra`` in both packages
    (calibrated first, on nmf_tpu's draws, with ``calibrate``): the loss,
    the metrics, every gradient and every updated tensor. Returns the
    packages' gradients."""
    jn, tn, cfg = _pair(extra)
    if calibrate:
        ckey = jax.random.PRNGKey(11)
        jn = jtrain.calibrate_model(jn, ckey)
        ttrain.calibrate_model(tn, Draws(None, calibration_draws(ckey)))
        for k, v in jckpt.state_dict(jn).items():
            if k.endswith("bias"):
                close(weights.port_tensor(tn, k)[0].detach().numpy(), v,
                      FWD, k)
    params = cfg["model"]["params"]
    tw, jw = _weights(params)
    n_iters = 100
    tx = jtrainer.make_optimizer(jn, jtrainer.OptimConfig(
        betas=tuple(params["betas"]), eps=params["eps"], n_iters=n_iters))
    rays, rgb = _batch()
    key = jax.random.PRNGKey(7)

    def jstep(n, st):
        (loss, m), g = jax.value_and_grad(
            lambda n_: jtrainer.compute_loss(
                n_, jnp.asarray(rays), jnp.asarray(rgb), key, jw,
                jnp.ones(3)), has_aux=True)(n)
        upd, st = tx.update(g, st, n)
        return loss, m, g, optax.apply_updates(n, upd)

    jl, jm, jg, jnew = jax.jit(jstep)(jn, tx.init(jn))
    opt = ttrain.make_optimizer(tn, params, n_iters)
    opt.zero_grad()
    tl, tm = _port_loss(tn, jn, tw, rays, rgb, key)
    tl.backward()
    close(float(tl), float(jl), FWD, "loss")
    for k in ("photo_mse", "thin_scale", "thin_scale_retrace",
              "n_valid_samples"):
        close(float(tm[k]), float(jm[k]), FWD, k)
    grads_match(tn, jg, GRAD, scales=envmap_scalar_scales(jn, jg))
    opt.step()
    params_match(tn, jnew, jg, 2 * max(ttrainer.group_lrs(tn).values())
                 * opt.sched(0))
    return jg, tn, tw


def _port_map_grad(extra, tw, mipbias=MIPBIAS):
    """The port's envmap gradient of the loss of _train_step's batch."""
    jn, tn, _ = _pair(extra, mipbias)
    rays, rgb = _batch()
    tl, _ = _port_loss(tn, jn, tw, rays, rgb, jax.random.PRNGKey(7))
    tl.backward()
    g = tn.bg_module.bg_mat.grad
    return np.zeros(tuple(tn.bg_module.bg_mat.shape)) if g is None \
        else g.numpy()


def test_sh_grad_train_step():
    """``sh_grad``: the diffuse term's gradient reaches the envmap through
    its SH projection. The map's gradient matches nmf_tpu's and is not
    the one without sh_grad (which the port's other train steps hold)."""
    jg, tn, tw = _train_step(SH_GRAD)
    g = tn.bg_module.bg_mat.grad.numpy()
    g0 = _port_map_grad([], tw)
    assert np.abs(g - g0).max() > 1e-2 * np.abs(g0).max()
    assert np.abs(np.asarray(jg.bg_module.bg_mat)).sum() > 0


def test_heads_path_train_step():
    """Every knob of chip_smoke.py's heads path (the IPE view encoder,
    which builds PE; RandRotISH on the roughness head; pospe 4; dotpe 2,
    sigexp and a degree-8 diffuse-vector encoder; the softplus envmap with
    sh_grad and mipnoise, whose noise no path draws) after the
    calibration: one train step."""
    _, tn, _ = _train_step(HEADS, calibrate=True)
    assert isinstance(tn.model.diffuse_module.view_encoder, TPE)
    assert tn.bg_module.mipnoise == 0.1


# ---- checkpoints ----

HEAD_CKPTS = {
    "hydra": [f"{DM}_target_=modules.render_modules.HydraMLPDiffuse",
              f"{DM}featureC=16", f"{DM}num_layers=2"],
    "mlp_diffuse": [*MLP_DIFFUSE, f"{DM}pospe=2", f"{DM}featureC=16",
                    f"{DM}num_layers=2"],
    "passthrough": [f"{DM}_target_=modules.render_modules.PassthroughDiffuse"],
    "heads path": HEADS,
}


@pytest.mark.parametrize("name", list(HEAD_CKPTS))
def test_head_checkpoints_read_by_each_package(tmp_path, name):
    """The state dict's keys and shapes equal nmf_tpu's (the RandHydra
    encoders and the Specular-free BRDF's dot inputs add no key; the
    MLPDiffuse / Hydra biases are leaves), and a checkpoint of either
    package loads into the other with every tensor equal."""
    jn, tn, cfg = build_flagship_pair(extra=HEAD_CKPTS[name])
    jsd, tsd = jckpt.state_dict(jn), weights.to_jax_state_dict(tn)
    assert sorted(tsd) == sorted(jsd)
    for k, v in jsd.items():
        assert tsd[k].shape == v.shape, k
    with torch.no_grad():
        for p in tn.parameters():
            p.add_(0.25)
    tckpt.save(tmp_path / "t.th", tn, cfg)
    jm, jcfg, _ = jckpt.load(tmp_path / "t.th")
    assert jcfg == cfg
    want = weights.to_jax_state_dict(tn)
    for k, v in jckpt.state_dict(jm).items():
        np.testing.assert_array_equal(np.asarray(v, np.float32), want[k],
                                      err_msg=k)
    jckpt.save(tmp_path / "j.th", jn, cfg)
    tm, _, _ = tckpt.load(tmp_path / "j.th", device="cpu")
    for k, v in weights.to_jax_state_dict(tm).items():
        np.testing.assert_array_equal(v, np.asarray(jsd[k], np.float32),
                                      err_msg=k)


@pytest.mark.parametrize("encoder", [
    {"_target_": "modules.ish.RandRotISH"},
    {"_target_": "modules.ish.ISH", "max_degree": 3},
    {"_target_": "modules.render_modules.IPE", "max_degree": 3}])
def test_refnerf_reflection_encoders_build(encoder):
    """Ref-NeRF's ``ref_encoder`` reaches every encoder through
    build_encoder: nmf_tpu's state-dict keys and shapes (the MLP's input
    width is the encoder's), and the encoder of nmf_tpu's class."""
    extra = [f"model.arch.model.ref_module.ref_encoder.{k}={v}"
             for k, v in encoder.items()]
    jn, tn, _ = build_pair(extra=extra, base=REFNERF)
    jsd, tsd = jckpt.state_dict(jn), weights.to_jax_state_dict(tn)
    assert sorted(tsd) == sorted(jsd)
    for k, v in jsd.items():
        assert tsd[k].shape == v.shape, k
    je = jn.model.ref_module.ref_encoder
    te = tn.model.ref_module.ref_encoder
    assert type(te).__name__ == type(je).__name__ and te.dim() == je.dim()


# ---- what nmf_tpu cannot run (ROADMAP C.12) ----

def _compose(extra):
    return jconfig.compose([*FLAGSHIP, *extra])


def test_specular_in_a_microfacet_is_c12():
    """nmf_tpu's Microfacet cannot build the Specular BRDF: its init calls
    ``brdf.replace(init_val=...)``, a field Specular lacks (TypeError);
    the port raises NotImplementedError naming C.12 (its Specular module
    is held directly, tests/test_torch_heads.py)."""
    cfg = _compose(["model.arch.model.brdf._target_=modules.brdf.Specular"])
    with pytest.raises(TypeError, match="init_val"):
        jbuild(jax.random.PRNGKey(0), cfg["model"]["arch"], AABB, NEAR_FAR)
    with pytest.raises(NotImplementedError, match="C.12"):
        tbuild(cfg["model"]["arch"], AABB, NEAR_FAR, device="cpu")


def test_ipe_target_builds_pe():
    """An IPE target ends with "PE", which both packages test first: it
    builds PE, whose encoding ignores the roughness."""
    cfg = {"_target_": "modules.render_modules.IPE", "max_degree": 4}
    je, te = jbuilders.build_encoder(cfg), tbuilders.build_encoder(cfg)
    assert type(je).__name__ == "PE" and isinstance(te, TPE)
    assert je.max_degree == te.max_degree == 4


def test_shbasis_target_is_c12():
    """nmf_tpu builds an SHBasis encoder target that fails at its first
    call (it takes (theta, phi, kappa), not the encoders' (directions,
    roughness)); the port raises at the build, naming C.12."""
    cfg = {"_target_": "modules.ish.SHBasis", "deg": 2}
    je = jbuilders.build_encoder(cfg)
    with pytest.raises(TypeError):
        je(jnp.ones((4, 3)) / np.sqrt(3), jnp.full((4,), 0.1))
    with pytest.raises(NotImplementedError, match="C.12"):
        tbuilders.build_encoder(cfg)


@struct.dataclass
class GuardedMLPDiffuse(JMLPDiffuse):
    """nmf_tpu's MLPDiffuse with its f0 broadcast to three columns, as
    Microfacet.shade packs f0 (the guard the port's Microfacet applies)."""

    def __call__(self, pts, viewdirs, features, **kwargs):
        d, t, mp = JMLPDiffuse.__call__(self, pts, viewdirs, features)
        return d, t, dict(mp, f0=jnp.broadcast_to(mp["f0"], d.shape))


def _jax_shade(jn, M, key, inputs, cot):
    """nmf_tpu's Microfacet.shade of M samples at recursion 1 (the envmap
    only): rgb, the tint map and the gradients to the model, the
    appearance features and the weights."""
    xyz, app, vd, nrm, w, valid = inputs

    def jfun(n, app_, w_):
        cache = n.bg_module.prepare()
        rgb, dbg = n.model.shade(
            jnp.asarray(xyz), n.rf.normalize_coord(jnp.asarray(xyz)), app_,
            jnp.asarray(vd), jnp.asarray(nrm), w_, jnp.asarray(valid),
            M // 8, render_reflection=jax_reflection(n, cache),
            bg_module=n.bg_module, bg_cache=cache, is_train=True, recur=1,
            key=key)
        return (rgb * cot).sum(), (rgb, dbg["tint"])

    return jax.jit(jax.value_and_grad(jfun, argnums=(0, 1, 2),
                                      has_aux=True))(
        jn, jnp.asarray(app), jnp.asarray(w))


def test_mlp_diffuse_gradient_fault_is_c12():
    """MLPDiffuse's f0 is one column; nmf_tpu's Microfacet packs three
    (``microfacet.py:215-251``), so it reads the packed parent row two
    columns off: its per-ray count reads the sample's first slot, 0 for
    the first sample with rays, and the packed segment sum divides by it
    (``:363``). In Microfacet.shade of 512 samples that gives an infinite
    tint map (so a train step's ``brdf_reg`` is inf and its loss, which
    weighs it by 0, NaN) and non-finite gradients. The port broadcasts f0
    to three columns: its rgb, tint and gradients match nmf_tpu's with
    that guard (``GuardedMLPDiffuse``) and are finite."""
    jn, tn, _ = _pair(MLP_DIFFUSE)
    M = 512
    key = jax.random.PRNGKey(5)
    inputs = shade_inputs(M, seed=3)
    cot = np.random.default_rng(1).normal(size=(M, 3)).astype(np.float32)
    (_, (_, jtint)), jg = _jax_shade(jn, M, key, inputs, cot)
    assert not np.isfinite(np.asarray(jtint)).all()
    assert not all(np.isfinite(g).all()
                   for g in jckpt.state_dict(jg).values())
    dm = jn.model.diffuse_module
    guarded = jn.replace(model=jn.model.replace(diffuse_module=(
        GuardedMLPDiffuse(**{f.name: getattr(dm, f.name)
                             for f in dataclasses.fields(dm)}))))
    (_, (grgb, gtint)), gg = _jax_shade(guarded, M, key, inputs, cot)

    xyz, app, vd, nrm, w, valid = inputs
    draws = Draws(None, shade_draws(key, jn, M, True, 1))
    ttrainer.Optimizer(tn, ttrainer.OptimConfig())  # gradients on all
    ins = [torch.tensor(a, requires_grad=True) for a in (app, w)]
    cache = tn.bg_module.prepare()
    trgb, tdbg = tn.model.shade(
        torch.from_numpy(xyz), tn.rf.normalize_coord(torch.from_numpy(xyz)),
        ins[0], torch.from_numpy(vd), torch.from_numpy(nrm), ins[1],
        torch.from_numpy(valid), M // 8,
        render_reflection=reflection_fn(tn, True, 1, cache, []),
        bg_module=tn.bg_module, bg_cache=cache, is_train=True, recur=1,
        draws=draws)
    (trgb * torch.from_numpy(cot)).sum().backward()
    close(trgb.detach().numpy(), grgb, FWD, "rgb")
    close(tdbg["tint"].detach().numpy(), gtint, FWD, "tint")
    for t, g, what in zip(ins, gg[1:], ("app", "weights")):
        assert np.isfinite(t.grad.numpy()).all(), what
        close(t.grad.numpy(), g, 1e-4, what)
    # each bias adds to MLP outputs (roughness: columns 7 and 8, diffuse:
    # 0-2), so its gradient is a sum of entries of the output bias's
    # gradient: held to that gradient's tolerance, relative to its largest
    gb = np.abs(np.asarray(gg[0].model.diffuse_module.mlp.layers[-1]["b"]))
    scales = envmap_scalar_scales(guarded, gg[0])
    scales.update({f".model.diffuse_module.{k}_bias": gb.max()
                   for k in ("roughness", "diffuse")})
    grads_match(tn, gg[0], 1e-4, scales=scales)


@pytest.mark.parametrize("activation", ["clip", "identity"])
def test_envmap_clip_and_identity_take_no_gradient_at_init(activation):
    """Not a fault: at the shipped init_val -0.6 the clip activation reads
    its floor 1e-3 and the identity a negative map, which the tonemap
    clips, so a train step of the tiny flagship gives the map a zero
    gradient (mip bias 1, the shipped one). tests/test_torch_heads.py
    holds both activations to nmf_tpu's on a random map."""
    tw, _ = _weights(_compose([])["model"]["params"])
    extra = [f"model.arch.bg_module.activation={activation}"]
    assert not _port_map_grad(extra, tw, mipbias=1.0).any()
    assert _port_map_grad([], tw, mipbias=1.0).any()
