"""LLFF scenes and NDC rays in nmf_tpu_torch against nmf_tpu: the NDC
conversion, the alpha-grid sampler's NDC march, a tiny flagship and a tiny
tensorf (with proposal resampling) rendering NDC rays, forward and
gradients, the LLFF loader on a written scene, and ``dataset=llff_fern``
through the port's CLI on the CPU.

NDC rays start on the plane z = -1 and end on z = 1, the faces of the NDC
box, where a 1-ulp difference flips the box test: the march cases use
rays that start just inside (z = -0.98, running to 0.92), and the
renders train-mode marches, whose jitter keeps the first sample off the
face.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nmf_tpu.data import ray_utils as jray  # noqa: E402
from nmf_tpu.data.llff import load_llff as jload_llff  # noqa: E402
from nmf_tpu.render import render as jrender  # noqa: E402
from nmf_tpu_torch import train as ttrain  # noqa: E402
from nmf_tpu_torch import trainer as ttrainer  # noqa: E402
from nmf_tpu_torch.data import load_dataset as tload  # noqa: E402
from nmf_tpu_torch.data.llff import (NDC_BBOX, load_llff,  # noqa: E402
                                     save_llff_scene)
from nmf_tpu_torch.data.ray_utils import ndc_rays_blender  # noqa: E402
from nmf_tpu_torch.data.synthetic import forward_facing_sphere  # noqa
from nmf_tpu_torch.ops.draws import Draws  # noqa: E402
from nmf_tpu_torch.render import render as trender  # noqa: E402
from torch_inputs import FLAGSHIP  # noqa: E402
from torch_parity import (build_pair, close, grads_match,  # noqa: E402
                          render_draws)

B = 64
FWD, GRAD = 1e-5, 1e-4
NDC_NEAR_FAR = (0.0, 1.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ndc_rays(n, seed, spread=0.4):
    """NDC-like rays from just inside z = -1 to z = 0.92, their x and y
    moving by up to ``spread`` (1.6: some leave the box at its sides)."""
    rng = np.random.default_rng(seed)
    o = np.concatenate([rng.uniform(-0.8, 0.8, (n, 2)),
                        np.full((n, 1), -0.98)], -1)
    d = np.concatenate([rng.uniform(-spread, spread, (n, 2)),
                        np.full((n, 1), 1.9)], -1)
    return np.concatenate([o, d], -1).astype(np.float32)


def _write_sphere_scene(root, n_views=9, H=48, W=64, focal=52.0):
    """The forward-facing sphere in the LLFF layout at
    root/nerf_llff_data/fern (where dataset=llff_fern looks)."""
    poses, views, bounds = forward_facing_sphere(n_views, H, W, focal)
    scenedir = root / "nerf_llff_data" / "fern"
    save_llff_scene(scenedir, poses, views, focal, bounds)
    return scenedir


def test_llff_fern_trains_on_cpu(tmp_path):
    """dataset=llff_fern with the default model through the port's CLI on
    the CPU: the forward-facing sphere (9 views of 64 x 48, downsampled 4x
    to 16 x 12), NDC rays in training; the final test eval marches them
    as world rays, as nmf_tpu's does (ROADMAP C.5)."""
    _write_sphere_scene(tmp_path / "data")
    lines = []
    _, res = ttrain.reconstruction(ttrain.config_lib.compose([
        *FLAGSHIP[:1], "dataset=llff_fern", f"datadir={tmp_path / 'data'}",
        *FLAGSHIP[2:], "device=cpu", "model.params.n_iters=6",
        "model.params.batch_size=64", "model.params.min_batch_size=64",
        "model.params.max_batch_size=64", "model.arch.sampler.update_list=[]",
        f"basedir={tmp_path}", "expname=l", "progress_refresh_rate=3"]),
        log=lines.append)
    assert any(ln.startswith("final test:") for ln in lines)
    out = tmp_path / "fern_l" / "imgs_test_all"
    assert sorted(p.name for p in out.glob("*.png")) == [
        "000.png", "001.png", "pano.png"]
    assert np.isfinite(res["loss"]) and np.isfinite(res["psnr"])


def test_evaluate_renders_llff_views_as_nmf_tpu(tmp_path, monkeypatch):
    """Both packages' ``evaluate`` on the test views of a tiny LLFF scene
    (the sphere, 9 views of 64 x 48 loaded 4x down, NDC rays): each renders
    them through the world-ray march (neither passes ``ndc_ray``); the
    images, held at FWD, and the PSNRs agree. The model is the tiny
    tensorf on the NDC box."""
    from nmf_tpu import eval as jeval
    from nmf_tpu_torch import eval as teval

    _write_sphere_scene(tmp_path)
    cfg = ttrain.config_lib.compose(["dataset=llff_fern",
                                     f"datadir={tmp_path}"])
    ds = tload(cfg["dataset"], str(tmp_path), split="test")
    assert ds["ndc_ray"] and ds["all_rays"].shape[0] == 2 * 16 * 12
    jn, tn, _ = build_pair(aabb=NDC_BBOX, near_far=NDC_NEAR_FAR)
    images = {"jax": [], "torch": []}
    for name, module in (("jax", jeval), ("torch", teval)):
        def record(*args, fn=module.render_image, name=name, **kwargs):
            maps = fn(*args, **kwargs)
            images[name].append(maps["rgb_map"])
            return maps

        monkeypatch.setattr(module, "render_image", record)
    jres = jeval.evaluate(jn, ds, jax.random.PRNGKey(0),
                          compute_extra_metrics=False)
    tres = teval.evaluate(tn, ds, compute_extra_metrics=False)
    assert len(images["jax"]) == len(images["torch"]) == 2
    for a, b in zip(images["torch"], images["jax"]):
        close(a, b, FWD, "rgb_map")
    assert abs(tres["psnr"] - jres["psnr"]) < 1e-3


def test_pose_helpers_match():
    """average_poses, center_poses and create_spiral_poses (a spiral
    camera path that no caller of either package renders: render_path
    renders an orbit for every scene)."""
    from nmf_tpu.data import llff as jllff

    from nmf_tpu_torch.data import llff as tllff

    rng = np.random.default_rng(6)
    poses = np.concatenate([np.linalg.qr(rng.normal(size=(5, 3, 3)))[0],
                            rng.normal(size=(5, 3, 1))], -1)
    np.testing.assert_array_equal(tllff.average_poses(poses),
                                  jllff.average_poses(poses))
    for ours, theirs in zip(tllff.center_poses(poses),
                            jllff.center_poses(poses)):
        np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(
        tllff.create_spiral_poses(np.array([0.3, 0.2, 0.1]), 2.5, 12),
        jllff.create_spiral_poses(np.array([0.3, 0.2, 0.1]), 2.5, 12))


def test_ndc_rays_blender_matches():
    rng = np.random.default_rng(0)
    o = np.concatenate([rng.uniform(-0.5, 0.5, (300, 2)),
                        rng.uniform(-0.3, 0.3, (300, 1))], -1)
    d = np.concatenate([rng.uniform(-0.5, 0.5, (300, 2)),
                        -np.ones((300, 1))], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    for ours, theirs in zip(ndc_rays_blender(12, 16, 14.0, 1.0, o, d),
                            jray.ndc_rays_blender(12, 16, 14.0, 1.0, o, d)):
        np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("is_train", [True, False], ids=["train", "eval"])
def test_alphagrid_sample_ndc_matches(is_train):
    """AlphaGridSampler.sample_ndc of the tiny tensorf's sampler (near_far
    (0, 1), the box test alone) compacted to 32 of its N steps."""
    jn, tn, _ = build_pair(near_far=NDC_NEAR_FAR)
    r = _ndc_rays(B, seed=1, spread=1.6)
    key = jax.random.PRNGKey(2)
    N = jn.sampler.n_samples
    jout = jax.jit(lambda r: jn.sampler.sample(
        r, key=key, is_train=is_train, ndc_ray=True,
        max_samples_per_ray=32))(jnp.asarray(r))
    jitter = (torch.from_numpy(np.asarray(jax.random.uniform(key, (B, N))))
              if is_train else None)
    tout = tn.sampler.sample_ndc(torch.from_numpy(r), is_train=is_train,
                                 jitter=jitter, max_samples_per_ray=32)
    np.testing.assert_array_equal(tout["valid"].numpy(),
                                  np.asarray(jout["valid"]))
    assert 0 < int(tout["valid"].sum()) < tout["valid"].numel()
    for k in ("xyz", "z_vals", "dists"):
        close(tout[k].numpy(), jout[k], FWD, k)


@pytest.mark.parametrize("model", ["flagship", "tensorf_proposal"])
def test_ndc_render_matches(model):
    """A train-mode render of NDC rays (the primary pass marches NDC, the
    flagship's retrace pass world rays) on the NDC box: rgb, acc and the
    gradients of every parameter. (Not the rays': at recursion 0 they are
    data, and the port's proposal pass places its samples without a
    gradient to them; nmf_tpu's keeps one, which reaches no parameter.)
    The flagship is the
    tiny one of torch_inputs.FLAGSHIP with its envmap's mip bias at 12
    (test_torch_flagship.py); its gradients reached through the normals
    are held to 5e-4 of each tensor's largest, as in that file's train
    step test. The tensorf marches 32 steps and resamples 16 (nmf_tpu's
    tests/test_extras.py::TestNDC::test_ndc_render_with_proposal)."""
    if model == "flagship":
        jn, tn, _ = build_pair(base=FLAGSHIP, aabb=NDC_BBOX,
                               near_far=NDC_NEAR_FAR)
        jn = jn.replace(bg_module=jn.bg_module.replace(
            mipbias=jnp.asarray(12.0, jnp.float32)))
        with torch.no_grad():
            tn.bg_module.mipbias.fill_(12.0)
        grad_tol = 5e-4
    else:
        jn, tn, _ = build_pair(
            extra=["model.arch.max_samples_per_ray=32",
                   "model.arch.proposal_samples_per_ray=16"],
            aabb=NDC_BBOX, near_far=NDC_NEAR_FAR)
        grad_tol = GRAD
    r = _ndc_rays(B, seed=3)
    cot = np.random.default_rng(4).normal(size=(B, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)

    def jfun(n, r):
        cache = n.bg_module.prepare() if n.bg_module is not None else None
        ims, _ = jrender(n, r, key, is_train=True, ndc_ray=True,
                         bg_cache=cache)
        return (ims["rgb_map"] * cot).sum(), ims

    (_, jims), jg = jax.jit(jax.value_and_grad(jfun, has_aux=True))(
        jn, jnp.asarray(r))
    ttrainer.Optimizer(tn, ttrainer.OptimConfig())  # gradients on all
    cache = tn.bg_module.prepare() if tn.bg_module is not None else None
    tims, _ = trender(tn, torch.from_numpy(r), is_train=True, ndc_ray=True,
                      bg_cache=cache,
                      draws=Draws(None, render_draws(key, jn, B, True)))
    (tims["rgb_map"] * torch.from_numpy(cot)).sum().backward()
    for k in ("rgb_map", "acc_map"):
        close(tims[k].detach().numpy(), jims[k], FWD, k)
    assert float(tims["acc_map"].max()) > 0.05
    grads_match(tn, jg, grad_tol)


def _reference_layout_scene(root, n_views=9, H0=120, W0=160, f0=100.0):
    """nmf_tpu's tests/test_extras.py::test_llff scene: a ring of cameras
    looking at the origin, bounds (2, 8), random 8-bit RGB images."""
    poses = []
    for i in range(n_views):
        ang = 0.3 * (i - n_views / 2) / n_views
        c, s = np.cos(ang), np.sin(ang)
        back = np.array([s, 0, c])
        poses.append(np.stack([np.array([c, 0, -s]), np.array([0, 1.0, 0]),
                               back, back * 4.0], -1))
    rng = np.random.default_rng(0)
    views = (rng.uniform(size=(H0, W0, 3)) for _ in range(n_views))
    save_llff_scene(root, poses, views, f0, np.tile([[2.0, 8.0]],
                                                    (n_views, 1)))


@pytest.mark.parametrize("ndc_ray", [True, False], ids=["ndc", "metric"])
def test_load_llff_matches(tmp_path, ndc_ray):
    """load_llff on a written scene (9 views of 160 x 120, downsampled 4x):
    both splits (every 8th view held out) equal to nmf_tpu's arrays, the
    colours within 1e-6 (the area resize at an integer factor, to an ulp
    of OpenCV's), and focal, img_wh, near_far and scene_bbox."""
    _reference_layout_scene(tmp_path)
    for split, n in (("train", 7), ("test", 2)):
        ours = load_llff(tmp_path, split, downsample=4.0, ndc_ray=ndc_ray)
        theirs = jload_llff(tmp_path, split, downsample=4.0,
                            ndc_ray=ndc_ray)
        assert sorted(ours) == sorted(theirs)
        assert ours["all_rays"].shape == (n * 40 * 30, 6)
        np.testing.assert_array_equal(ours["all_rays"], theirs["all_rays"])
        np.testing.assert_allclose(ours["all_rgbs"], theirs["all_rgbs"],
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(ours["poses"], theirs["poses"])
        np.testing.assert_array_equal(ours["scene_bbox"],
                                      theirs["scene_bbox"])
        for k in ("img_wh", "focal", "near_far", "white_bg", "ndc_ray"):
            assert ours[k] == theirs[k], k
    assert ours["img_wh"] == (40, 30) and ours["focal"] == 25.0
    if ndc_ray:
        assert ours["near_far"] == NDC_NEAR_FAR
        assert np.abs(ours["all_rays"][:, 2]).max() <= 1 + 1e-6
    else:
        assert ours["near_far"][0] == pytest.approx(1 / 0.75)


@pytest.mark.parametrize("name", ["llff_fern", "kitchen"])
def test_llff_yamls_load_through_the_dispatch(tmp_path, name):
    """Both dataset yamls that select the LLFF loader load through
    load_dataset: llff_fern with NDC rays, kitchen with metric rays, its
    near_far from the yaml."""
    from nmf_tpu_torch import config

    cfg = config.compose([f"dataset={name}", f"datadir={tmp_path}"])
    _reference_layout_scene(tmp_path / cfg["dataset"]["scenedir"])
    ds = tload(cfg["dataset"], str(tmp_path), "test")
    assert ds["ndc_ray"] == (name == "llff_fern")
    assert ds["near_far"] == ((0.0, 1.0) if name == "llff_fern" else (1, 6))
    assert ds["all_rays"].shape == (2 * 40 * 30, 6)
