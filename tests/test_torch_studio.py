"""The studio protocol in nmf_tpu_torch against nmf_tpu: the protocol
scenes bit for bit, the eval metrics on the same arrays, and the
fixed-shape field (queries, gradients, regularizers, an upsample event),
also against the port's own exact-shape field on the live region."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nmf_tpu import ckpt as jckpt  # noqa: E402
from nmf_tpu import eval as jeval  # noqa: E402
from nmf_tpu.data.synthetic import make_shiny_dataset as jscene  # noqa: E402
from nmf_tpu_torch import eval as teval  # noqa: E402
from nmf_tpu_torch import weights  # noqa: E402
from nmf_tpu_torch.builders import build_nmf as tbuild  # noqa: E402
from nmf_tpu_torch.data import load_dataset as tload  # noqa: E402
from nmf_tpu_torch.data.synthetic import (  # noqa: E402
    make_shiny_dataset as tscene)
from torch_parity import (AABB, NEAR_FAR, build_flagship_pair,  # noqa: E402
                          build_pair)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny shapes run fastest on one thread, and the test workers
    share the CPU cores (torch's thread pool beside JAX's oversubscribes
    them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_dataset_cache(monkeypatch):
    """Both packages read NMF_DATASET_CACHE; empty turns their scene memo
    off, so no test writes into the checkout or reads a stale file."""
    monkeypatch.setenv("NMF_DATASET_CACHE", "")


# the fixed-shape field: 16^3 live inside planes padded to the final 30^3
FIXED = ["field.fixed_shape=true", "field.N_voxel_final=27000",
         "field.upsamp_list=[5]"]


@pytest.mark.parametrize("scene,hemisphere", [
    ("shiny", False), ("cluster", False), ("studio", False),
    ("studio", True)])
def test_protocol_scene_is_bit_equal(scene, hemisphere):
    for split in ("train", "test"):
        kw = dict(n_views=2, H=16, W=16, n_gi_samples=4, scene=scene,
                  hemisphere=hemisphere, split=split)
        a, b = jscene(**kw), tscene(**kw)
        assert a.keys() == b.keys()
        for k, v in a.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(b[k], v, err_msg=k)
            else:
                assert b[k] == v, k


def test_protocol_scene_dispatch_and_cache(tmp_path, monkeypatch):
    """load_dataset dispatches the protocol names; the cache file is the
    port's own, and a second load reads it back unchanged."""
    monkeypatch.setenv("NMF_DATASET_CACHE", str(tmp_path))
    cfg = {"dataset_name": "synthetic_studio", "n_views": 2,
           "image_size": 8, "hemisphere": True, "n_gi_samples": 2,
           "near_far": [1.4, 5.0]}
    first = tload(cfg, None, "test")
    files = sorted(p.name for p in tmp_path.iterdir())
    assert len(files) == 1 and files[0].startswith("torch_shiny_")
    again = tload(cfg, None, "test")
    for k in ("all_rays", "all_rgbs", "all_norms", "all_tints", "gt_bg_im"):
        np.testing.assert_array_equal(again[k], first[k])
    assert again["near_far"] == (1.4, 5.0)


def _maps(rng, H, W, ds, img):
    """Rendered maps of one image, made up: the ground truth plus noise,
    so every metric is finite and away from its limits."""
    px = slice(img * H * W, (img + 1) * H * W)
    n = ds["all_norms"][px].reshape(H, W, 3) + rng.normal(0, 0.2, (H, W, 3))
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-6)
    return {
        "rgb_map": np.clip(ds["all_rgbs"][px, :3].reshape(H, W, 3)
                           + rng.normal(0, 0.05, (H, W, 3)), 0, 1),
        "world_normal": n.astype(np.float32),
        "tint": (ds["all_tints"][px].reshape(H, W, 3) * 0.7 + 0.1
                 + rng.normal(0, 0.02, (H, W, 3))).astype(np.float32),
        "depth": rng.uniform(2, 4, (H, W)).astype(np.float32)}


def test_eval_metrics_match(monkeypatch):
    """evaluate of both packages on the same rendered maps (render_image
    replaced by the same made-up maps): PSNR, SSIM, norm_err, tint_psnr
    and the envmap metrics against the scene's panorama, to 1e-5; and
    regression_aligned_psnr on its own."""
    ds = tscene(n_views=2, H=16, W=16, n_gi_samples=4, scene="studio",
                hemisphere=True, split="test")
    jn, tn, _ = build_flagship_pair()
    rng = np.random.default_rng(0)
    maps = [_maps(rng, 16, 16, ds, i) for i in range(2)]
    calls = iter(range(2))
    monkeypatch.setattr(jeval, "render_image",
                        lambda *a, **k: maps[next(calls)])
    jres = jeval.evaluate(jn, ds, jax.random.PRNGKey(0),
                          gt_bg=ds["gt_bg_im"])
    tcalls = iter(range(2))
    monkeypatch.setattr(teval, "render_image",
                        lambda *a, **k: maps[next(tcalls)])
    tres = teval.evaluate(tn, ds, gt_bg=ds["gt_bg_im"])
    assert set(tres) == set(jres) >= {"psnr", "ssim", "norm_err",
                                      "tint_psnr", "envmap_psnr",
                                      "envmap_psnr_top", "envmap_ssim_top",
                                      "envmap_smape_top"}
    for k, v in jres.items():
        np.testing.assert_allclose(tres[k], v, rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    a, b = maps[0]["tint"], ds["all_tints"][:256]
    np.testing.assert_allclose(teval.regression_aligned_psnr(a, b),
                               jeval.regression_aligned_psnr(a, b),
                               rtol=1e-5)


@pytest.mark.parametrize("op", ["grid_sample_1d", "grid_sample_2d",
                                "quad_gather_2d", "line_interp"])
def test_live_region_ops_match_nmf_tpu(op):
    """The samplers of a padded table (live 11 x 13 inside 16 x 16, live
    L = 9 of 16) against nmf_tpu's on the same table and coordinates,
    coordinates past the box included; the padding is zero."""
    from nmf_tpu.ops import grid_sample as jgs
    from nmf_tpu_torch.ops import grid_sample as tgs

    rng = np.random.default_rng(4)
    two_d = op in ("grid_sample_2d", "quad_gather_2d")
    table = np.zeros((5, 16, 16) if two_d else (5, 16), np.float32)
    if two_d:
        table[:, :11, :13] = rng.normal(size=(5, 11, 13))
        live = (11.0, 13.0)
    else:
        table[:, :9] = rng.normal(size=(5, 9))
        live = 9.0
    coords = rng.uniform(-1.1, 1.1, (200, 2) if two_d else (200,))
    coords = coords.astype(np.float32)
    jop = {"line_interp": "line_interp_matmul"}.get(op, op)
    jlive = (tuple(jnp.float32(v) for v in live) if two_d
             else jnp.float32(live))
    tlive = (tuple(torch.tensor(v) for v in live) if two_d
             else torch.tensor(live))
    want = getattr(jgs, jop)(jnp.asarray(table), jnp.asarray(coords), jlive)
    got = getattr(tgs, op)(torch.from_numpy(table), torch.from_numpy(coords),
                           tlive)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def _xyz(n=300, seed=0):
    pts = np.random.default_rng(seed).uniform(-1.6, 1.6, (n, 4))
    pts[:, 3] = 0.01
    return pts.astype(np.float32)


def _field_loss(rf, xyz, normals_fn):
    """Queries with normals and every regularizer, as nmf_tpu's fixed-shape
    tests weigh them."""
    sigma, app, normals = rf.compute_all(xyz, with_normals=True)
    return (sigma.sum() + (app ** 2).sum() + normals_fn(normals)
            + rf.density_L1() + rf.tv_loss_density() + rf.tv_loss_app()
            + rf.vector_comp_diffs())


def test_fixed_shape_field_matches_nmf_tpu():
    """The fixed-shape field of both packages on the same weights: the
    queries with normals, every parameter's gradient of a loss with every
    regularizer (zero on the padding in the port), the regularizers, then
    the upsample event (state dicts and queries again)."""
    jn, tn, _ = build_pair("f32", FIXED)
    assert tn.rf.grid_size == (30, 30, 30)
    assert tn.rf.live_grid_size == (16, 16, 16)
    xyz = _xyz()
    jl, jg = jax.jit(jax.value_and_grad(lambda rf: _field_loss(
        rf, jnp.asarray(xyz), lambda n: (n * jnp.arange(3)).sum())))(jn.rf)
    tl = _field_loss(tn.rf, torch.from_numpy(xyz),
                     lambda n: (n * torch.arange(3)).sum())
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for k, g in jckpt.state_dict(jg).items():
        if not k.startswith(".density_rf") and not k.startswith(".app_rf"):
            continue
        t, _ = weights.port_tensor(tn.rf, k)
        tg = t.grad.numpy()
        np.testing.assert_allclose(tg, g, rtol=1e-4,
                                   atol=1e-6 * np.abs(g).max() + 1e-9,
                                   err_msg=k)
        pad = tg[..., 16:] if tg.ndim == 2 else np.concatenate(
            [tg[:, 16:, :].ravel(), tg[:, :, 16:].ravel()])
        assert not np.any(pad), k
    names = ("density_L1", "tv_loss_density", "tv_loss_app",
             "vector_comp_diffs")
    jregs = jax.jit(lambda rf: [getattr(rf, n)() for n in names])(jn.rf)
    for name, j in zip(names, jregs):
        np.testing.assert_allclose(float(getattr(tn.rf, name)().detach()),
                                   float(j), rtol=1e-6, err_msg=name)
    jn2, j_changed = jn.check_schedule(5)
    assert j_changed and tn.check_schedule(5)
    assert tn.rf.live_grid_size == jn2.rf.live_grid_size == (30, 30, 30)
    for k, v in jckpt.state_dict(jn2).items():
        t, tr = weights.port_tensor(tn, k)
        a = t.detach().numpy()
        # the resample's bilinear arithmetic, eager here and fused by XLA
        np.testing.assert_allclose(a.T if tr else a, v, rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    with torch.no_grad():
        ts, ta, _ = tn.rf.compute_all(torch.from_numpy(xyz))
    js, ja, _ = jax.jit(lambda rf: rf.compute_all(
        jnp.asarray(xyz), with_normals=False))(jn2.rf)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5,
                               atol=1e-6)


def _port_fields():
    """The port's exact-shape and fixed-shape models of one seed."""
    from nmf_tpu_torch import config

    models = []
    for extra in ([], ["field.fixed_shape=true"]):
        cfg = config.compose([
            "model=tensorf", "field.N_voxel_init=4096",
            "field.N_voxel_final=27000", "field.upsamp_list=[5]",
            "field.gather_dtype=f32", *extra])
        models.append(tbuild(cfg["model"]["arch"], AABB, NEAR_FAR, seed=3,
                             device="cpu"))
    return models


def test_fixed_and_exact_shape_agree_on_the_live_region():
    """The port's fixed-shape field is its exact-shape field on the live
    region: the init draws, the queries with normals and their gradients,
    the regularizers and the upsample event, as nmf_tpu's own fixed-shape
    tests pin it."""
    exact, fixed = _port_fields()
    for fg_e, fg_f in ((exact.rf.density_rf, fixed.rf.density_rf),
                       (exact.rf.app_rf, fixed.rf.app_rf)):
        for i in range(3):
            assert torch.equal(fg_f.planes[i][:, :16, :16], fg_e.planes[i])
            assert not fg_f.planes[i][:, 16:].any()
            assert torch.equal(fg_f.lines[i][:, :16], fg_e.lines[i])
    xyz = torch.from_numpy(_xyz(200, seed=5))
    losses = [_field_loss(m.rf, xyz, lambda n: (n * torch.arange(3)).sum())
              for m in (exact, fixed)]
    for loss in losses:
        loss.backward()
    torch.testing.assert_close(losses[1], losses[0], rtol=1e-6, atol=0)
    for i in range(3):
        ge = exact.rf.density_rf.planes[i].grad
        gf = fixed.rf.density_rf.planes[i].grad
        torch.testing.assert_close(gf[:, :16, :16], ge, rtol=1e-5,
                                   atol=1e-6)
        assert not gf[:, 16:].any() and not gf[:, :, 16:].any()
    assert exact.check_schedule(5) and fixed.check_schedule(5)
    assert fixed.rf.live_grid_size == exact.rf.grid_size
    assert fixed.sampler.n_samples == exact.sampler.n_samples
    with torch.no_grad():
        torch.testing.assert_close(
            fixed.rf.compute_densityfeature(xyz),
            exact.rf.compute_densityfeature(xyz), rtol=1e-5, atol=1e-6)


def test_fixed_shape_sampler_scales_its_step_and_pins_its_mask():
    """Before the upsample the fixed-shape march takes the padded grid's
    step count, each step scaled to the live cell; the mask lives at the
    padded resolution, and a rebuild keeps its shape."""
    exact, fixed = _port_fields()
    s = fixed.sampler
    assert s.n_samples == fixed.rf.n_samples
    assert float(s.step_scale) == pytest.approx(29 / 15)
    assert float(s.live_stepsize) == pytest.approx(exact.sampler.stepsize)
    assert tuple(s.alpha_mask.alpha_volume.shape) == (30, 30, 30)
    s.update(fixed.rf)
    assert tuple(s.alpha_mask.alpha_volume.shape) == (30, 30, 30)
    # nmf_tpu refuses rf.shrink under fixed_shape, and so does the port
    with pytest.raises(NotImplementedError, match="fixed_shape"):
        fixed.rf.shrink(fixed.rf.aabb.detach().cpu().numpy() * 0.5)
