"""HDR training and bf16 MLP operands in nmf_tpu_torch, against nmf_tpu:
the tonemaps and their inverses, the Huber loss, the HDR eval's EXR dump,
the bf16 MLP (plain and skip-connection) with every gradient, the reach
of ``mlp_dtype``, and a flagship train step with ``hdr``, the HDR curve
and two-stage shading."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from nmf_tpu import eval as jeval  # noqa: E402
from nmf_tpu import trainer as jtrainer  # noqa: E402
from nmf_tpu.data import exr as jexr  # noqa: E402
from nmf_tpu.data.blender import load_dataset as jload  # noqa: E402
from nmf_tpu.modules.mlp import create_mlp  # noqa: E402
from nmf_tpu.ops import tonemap as jtm  # noqa: E402
from nmf_tpu.render import render as jrender  # noqa: E402
from nmf_tpu_torch import eval as teval  # noqa: E402
from nmf_tpu_torch import train as ttrain  # noqa: E402
from nmf_tpu_torch import trainer as ttrainer  # noqa: E402
from nmf_tpu_torch.data import exr as texr  # noqa: E402
from nmf_tpu_torch.data import load_dataset as tload  # noqa: E402
from nmf_tpu_torch.modules.mlp import MLP  # noqa: E402
from nmf_tpu_torch.ops import tonemap as ttm  # noqa: E402
from nmf_tpu_torch.ops.draws import Draws  # noqa: E402
from torch_parity import (build_flagship_pair, build_pair,  # noqa: E402
                          grads_match, port_copy, render_draws)

HDR = ["model.arch.hdr=true",
       "model.arch.tonemap._target_=modules.tonemap.HDRTonemap"]
DATASET = {"dataset_name": "synthetic_sphere", "n_views": 4,
           "image_size": 16}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["srgb", "filmic", "hdr", "linear"])
def test_tonemaps_match(name):
    """Each curve, clipped and with noclip, and its inverse, on values
    from -0.5 to 8 (HDR radiance past 1), to 1e-6 relative. Where
    nmf_tpu's HDR curve is NaN (below 0) the port's gives 0."""
    x = np.random.default_rng(0).uniform(-0.5, 8, 4096).astype(np.float32)
    x[:8] = (0.0, 0.0031308, 0.04045, 1.0, 2.0, -0.1, 0.5, 8.0)
    jf, ji = jtm.get_tonemap(name)
    tf, ti = ttm.get_tonemap(name), ttm.get_inverse(name)
    for noclip in (False, True):
        want = np.asarray(jf(jnp.asarray(x), noclip))
        got = tf(torch.from_numpy(x), noclip).numpy()
        bad = np.isnan(want)
        assert bad.any() == (name == "hdr")
        np.testing.assert_array_equal(got[bad], 0.0)
        np.testing.assert_allclose(got[~bad], want[~bad], rtol=1e-6,
                                   atol=1e-7)
    # the inverses on the curve's range (hdr's divides by 1 - y^2.2)
    y = np.clip(x / 8, 0, 0.99).astype(np.float32)
    np.testing.assert_allclose(ti(torch.from_numpy(y)).numpy(),
                               np.asarray(ji(jnp.asarray(y))), rtol=1e-6,
                               atol=1e-7)
    with pytest.raises(ValueError):
        ttm.get_tonemap("aces")


def test_hdr_curve_gradient_is_finite_at_zero():
    """The HDR curve's slope: nmf_tpu's and the port's agree to 1e-6 on
    positive radiance; at 0 (a ray that misses every sample) nmf_tpu's is
    infinite, the port's 0 (ROADMAP C.11)."""
    x = np.array([0.0, 1e-6, 0.01, 0.5, 1.0, 3.0], np.float32)
    jg = np.asarray(jax.grad(lambda a: jtm.hdr_tonemap(a, True).sum())(
        jnp.asarray(x)))
    tx = torch.tensor(x, requires_grad=True)
    ttm.hdr_tonemap(tx, noclip=True).sum().backward()
    assert not np.isfinite(jg[0]) and tx.grad[0] == 0
    np.testing.assert_allclose(tx.grad.numpy()[1:], jg[1:], rtol=1e-6)


def test_huber_loss_and_gradient_match():
    """The HDR loss term, optax's Huber (delta 1) summed, on errors across
    both branches: the value and the gradient to 1e-6."""
    rng = np.random.default_rng(1)
    p = rng.uniform(-1, 4, (257, 3)).astype(np.float32)
    g = rng.uniform(0, 3, (257, 3)).astype(np.float32)
    assert (np.abs(p - g) > 1).any() and (np.abs(p - g) < 1).any()
    jv, jg = jax.value_and_grad(
        lambda a: optax.losses.huber_loss(a, jnp.asarray(g), delta=1.0)
        .sum())(jnp.asarray(p))
    tp = torch.tensor(p, requires_grad=True)
    tv = ttrainer.huber_loss(tp, torch.from_numpy(g)).sum()
    tv.backward()
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("skip", [None, 2], ids=["plain", "skip"])
def test_bf16_mlp_matches(skip):
    """nmf_tpu's bf16 MLP (bf16 operands, f32 accumulation, f32 result and
    parameters) on the same weights and inputs: the input's and the
    weights' gradients are bit-equal; the output and the bias gradients
    differ only by the f32 summation order of the products (to 1e-6 of
    their largest)."""
    jm = create_mlp(jax.random.PRNGKey(0), 13, 5, 4, hidden_w=32,
                    skip=skip).replace(compute_dtype="bf16")
    tm = MLP(13, 5, 4, hidden_w=32, skip=skip)
    tm.compute_dtype = "bf16"
    halves = (("layers", jm.layers), ("skip_layers", jm.skip_layers))
    with torch.no_grad():
        for name, layers in halves:
            for i, layer in enumerate(layers or ()):
                lin = getattr(tm, name)[i]
                lin.weight.copy_(torch.tensor(np.asarray(layer["w"]).T))
                lin.bias.copy_(torch.tensor(np.asarray(layer["b"])))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(257, 13)).astype(np.float32)
    cot = rng.normal(size=(257, 5)).astype(np.float32)
    (jy, (jg, jgx)) = (jm(jnp.asarray(x)), jax.grad(
        lambda m, a: (m(a) * cot).sum(), argnums=(0, 1))(jm, jnp.asarray(x)))
    tx = torch.tensor(x, requires_grad=True)
    ty = tm(tx)
    (ty * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=0, atol=1e-6 * np.abs(jy).max())
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jgx))
    jhalves = (("layers", jg.layers), ("skip_layers", jg.skip_layers))
    for name, layers in jhalves:
        for i, layer in enumerate(layers or ()):
            lin = getattr(tm, name)[i]
            np.testing.assert_array_equal(lin.weight.grad.numpy().T,
                                          np.asarray(layer["w"]))
            b = np.asarray(layer["b"])
            np.testing.assert_allclose(lin.bias.grad.numpy(), b, rtol=0,
                                       atol=1e-6 * np.abs(b).max())
    # f32 mode is the plain stack, bf16 moves the result
    tm.compute_dtype = "f32"
    assert not torch.equal(tm(tx), ty)


@pytest.mark.parametrize("base", ["flagship", "refnerf"])
def test_mlp_dtype_reaches_shading_and_normal_mlps(base):
    """mlp_dtype=bf16 sets every MLP of the shading model and the normal
    module and no other (the hash field's MLPs stay f32), as nmf_tpu's
    set_mlp_dtype."""
    from nmf_tpu_torch.builders import build_nmf
    from torch_inputs import FLAGSHIP, REFNERF_TCNN
    ov = (FLAGSHIP + ["model.arch.normal_module._target_="
                      "modules.render_modules.MLPNormal"]
          if base == "flagship" else REFNERF_TCNN)
    cfg = ttrain.config_lib.compose([*ov, "model.arch.mlp_dtype=bf16"])
    tn = build_nmf(cfg["model"]["arch"], np.array(
        [[-1.5] * 3, [1.5] * 3], np.float32), (2.0, 6.0), device="cpu")
    inside = [m for part in (tn.model, tn.normal_module) if part is not None
              for m in part.modules() if isinstance(m, MLP)]
    outside = [m for m in tn.rf.modules() if isinstance(m, MLP)]
    assert inside and all(m.compute_dtype == "bf16" for m in inside)
    assert all(m.compute_dtype == "f32" for m in outside)
    if base == "refnerf":
        assert outside
    cfg = ttrain.config_lib.compose([*ov, "model.arch.mlp_dtype=f16"])
    with pytest.raises(ValueError):
        build_nmf(cfg["model"]["arch"], np.array(
            [[-1.5] * 3, [1.5] * 3], np.float32), (2.0, 6.0), device="cpu")


@pytest.mark.parametrize("curve", ["HDRTonemap", "LinearTonemap"])
def test_hdr_eval_writes_exr_of_the_render(tmp_path, curve):
    """An hdr model's eval writes {prefix}{i:03d}.exr beside the PNG: the
    render's rgb_map, unclipped; read back, it is the port's render of the
    view exactly. For the HDR curve, nmf_tpu's file of its render of the
    same model (nmf_tpu's eval writes the same map) holds the same values
    to 1e-5."""
    jn, tn, _ = build_pair("f32", [
        "model.arch.max_samples_per_ray=32", "model.arch.hdr=true",
        f"model.arch.tonemap._target_=modules.tonemap.{curve}"])
    assert tn.hdr and tn.tonemap == jn.tonemap
    ds = tload(DATASET, None, "test")
    teval.evaluate(tn, ds, save_dir=str(tmp_path), n_vis=1, prefix="t",
                   compute_extra_metrics=False)
    assert (tmp_path / "t000.png").exists()
    got = texr.read_exr(tmp_path / "t000.exr")
    rays = ds["all_rays"][:256]
    tm = teval.render_image(tn, rays, (16, 16), chunk=tn.eval_batch_size)
    np.testing.assert_array_equal(got, tm["rgb_map"])
    if curve != "HDRTonemap":
        return
    # nmf_tpu's render op by op, as tests/test_torch_slice.py's eval test
    jm = jeval.render_image(
        jn, rays, (16, 16), jax.random.PRNGKey(0), chunk=256,
        render_fn=lambda n, r, k, c: jrender(n, r, k, is_train=False,
                                             draw_debug=True)[0])
    jexr.write_exr(tmp_path / "j000.exr", np.asarray(jm["rgb_map"]))
    np.testing.assert_allclose(got, texr.read_exr(tmp_path / "j000.exr"),
                               rtol=1e-5, atol=1e-5)


def test_flagship_hdr_two_stage_train_step_matches():
    """One flagship train step with hdr, the HDR curve and two-stage
    shading (app_samples_per_ray=4 of the proposal's 8) on targets past 1
    (Huber's linear branch): the loss, photo_mse (the clipped error) and
    every gradient, to 5e-4 of each tensor's largest, as the flagship's
    train-step test (its envmap mip bias at 12 as there)."""
    B = 64
    jn, _, cfg = build_flagship_pair([*HDR,
                                      "model.arch.app_samples_per_ray=4"])
    jn = jn.replace(bg_module=jn.bg_module.replace(
        mipbias=jnp.asarray(12.0, jnp.float32)))
    tn = port_copy(jn, cfg)
    params = cfg["model"]["params"]
    ds = jload(DATASET, None, "train")
    ids = np.random.default_rng(0).choice(ds["all_rays"].shape[0], B,
                                          replace=False)
    rays = ds["all_rays"][ids]
    gt = (ds["all_rgbs"][ids] * 3.0).astype(np.float32)
    jw = jtrainer.LossWeights(ori_lambda=params["ori_lambda"],
                              pred_lambda=params["pred_lambda"],
                              l1_weight=params["L1_weight_initial"])
    key = jax.random.PRNGKey(20)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda n, r, g: jtrainer.compute_loss(n, r, g, key, jw, jnp.ones(3),
                                              hdr=True),
        has_aux=True))(jn, jnp.asarray(rays), jnp.asarray(gt))
    ttrain.make_optimizer(tn, params, 100)
    tl, tmet = ttrainer.compute_loss(
        tn, torch.from_numpy(rays), torch.from_numpy(gt),
        ttrain.make_loss_weights(params), (1.0, 1.0, 1.0),
        draws=Draws(None, render_draws(key, jn, B, True)), hdr=True)
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for k in ("photo_mse", "n_valid_samples"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5)
    grads_match(tn, jg, 5e-4)


def test_hdr_scene_in_nerf_synthetic_layout_loads_back(tmp_path,
                                                       monkeypatch):
    """The studio scene's linear radiance (values past 1 kept) written as
    EXR frames in nerf_synthetic layout loads back through
    dataset=materials_hdr bit for bit, by the port's loader and by
    nmf_tpu's."""
    from nmf_tpu_torch.data.blender import save_blender_split
    from nmf_tpu_torch.data.synthetic import make_shiny_dataset
    monkeypatch.setenv("NMF_DATASET_CACHE", "")
    cfg = ttrain.config_lib.compose(["dataset=materials_hdr",
                                     f"datadir={tmp_path}",
                                     "dataset.near_far=[1.4,5.0]"])
    ds = make_shiny_dataset(n_views=2, H=16, W=16, n_gi_samples=4,
                            scene="studio", hemisphere=True, linear=True)
    assert ds["all_rgbs"][:, :3].max() > 1
    save_blender_split(tmp_path / cfg["dataset"]["scenedir"], "train",
                       ds["poses"], ds["all_rgbs"].reshape(2, 16, 16, 4),
                       np.deg2rad(55.0), exr=True)
    for load in (tload, jload):
        got = load(cfg["dataset"], str(tmp_path), "train")
        np.testing.assert_array_equal(got["all_rgbs"], ds["all_rgbs"])
        np.testing.assert_allclose(got["all_rays"], ds["all_rays"], rtol=0,
                                   atol=1e-5)
