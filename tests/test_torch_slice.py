"""The tensorf slice of nmf_tpu_torch as a whole, against nmf_tpu: three
train steps (loss, every gradient, every updated tensor), an eval render,
a CPU reconstruction run, the default run's dataset (``dataset=lego`` on a
nerf_synthetic folder with its ``gt_bg`` EXR), the import boundary and
chip_smoke.py's refusal to run without a card."""
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nmf_tpu import ckpt as jckpt  # noqa: E402
from nmf_tpu import config as jconfig  # noqa: E402
from nmf_tpu import eval as jeval  # noqa: E402
from nmf_tpu import train as jtrain  # noqa: E402
from nmf_tpu import trainer as jtrainer  # noqa: E402
from nmf_tpu import utils as jutils  # noqa: E402
from nmf_tpu.builders import build_nmf as jbuild  # noqa: E402
from nmf_tpu.data import exr as jexr  # noqa: E402
from nmf_tpu.data.blender import load_dataset as jload  # noqa: E402
from nmf_tpu.render import render as jrender  # noqa: E402
from nmf_tpu_torch import ckpt as tckpt  # noqa: E402
from nmf_tpu_torch import eval as teval  # noqa: E402
from nmf_tpu_torch import train as ttrain  # noqa: E402
from nmf_tpu_torch import trainer as ttrainer  # noqa: E402
from nmf_tpu_torch import weights  # noqa: E402
from nmf_tpu_torch.builders import build_nmf as tbuild  # noqa: E402
from nmf_tpu_torch.data import exr as texr  # noqa: E402
from nmf_tpu_torch.data import load_dataset as tload  # noqa: E402
from nmf_tpu_torch.data.blender import save_blender_split  # noqa: E402
from nmf_tpu_torch.data.synthetic import make_shiny_dataset  # noqa: E402
from nmf_tpu_torch.ops.draws import Draws  # noqa: E402
from torch_parity import AABB, NEAR_FAR, build_pair  # noqa: E402
from torch_inputs import FLAGSHIP  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
B = 64
DATASET = {"dataset_name": "synthetic_sphere", "n_views": 4,
           "image_size": 16}
# clip at 0.01 so the global-norm clip (which counts rf.aabb's gradient)
# is active; K = 32 < N = 52 so the two-level march runs
SLICE = ["model.arch.max_samples_per_ray=32", "model.params.n_iters=100",
         "model.params.clip_grad=0.01"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny shapes run fastest on one thread, and the test workers
    share the CPU cores (torch's thread pool beside JAX's oversubscribes
    them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_value(tn, key):
    t, transpose = weights.port_tensor(tn, key)
    v = t.detach().numpy()
    return v.T if transpose else v


def test_three_train_steps_match():
    jn, tn, cfg = build_pair("f32", SLICE)
    params = cfg["model"]["params"]
    ds = jload(DATASET, None, "train")
    opt_cfg = jtrainer.OptimConfig(
        betas=tuple(params["betas"]), eps=params["eps"],
        lr_init=params["lr_init"], lr_final=params["lr_final"],
        lr_delay_steps=params["lr_delay_steps"],
        lr_delay_mult=params["lr_delay_mult"], n_iters=100,
        clip_grad=params["clip_grad"])
    tx = jtrainer.make_optimizer(jn, opt_cfg)
    state = tx.init(jn)
    jstep = jtrainer.make_train_step(tx, donate=False)
    jw = jtrainer.LossWeights(ori_lambda=0.0, pred_lambda=0.0,
                              l1_weight=params["L1_weight_initial"])
    jgrad = jax.jit(jax.value_and_grad(
        lambda n, r, g, k: jtrainer.compute_loss(n, r, g, k, jw,
                                                 jnp.ones(3))[0]))
    topt = ttrain.make_optimizer(tn, params, 100)
    tw = ttrain.make_loss_weights(params)
    rng = np.random.default_rng(0)
    N = jn.sampler.n_samples
    for i in range(3):
        ids = rng.choice(ds["all_rays"].shape[0], B, replace=False)
        rays, rgb = ds["all_rays"][ids], ds["all_rgbs"][ids]
        key = jax.random.PRNGKey(i)
        jitter = np.asarray(jax.random.uniform(jax.random.split(key, 4)[0],
                                               (B, N)))
        jl, jg = jgrad(jn, jnp.asarray(rays), jnp.asarray(rgb), key)
        topt.zero_grad()
        tl, _ = ttrainer.compute_loss(
            tn, torch.from_numpy(rays), torch.from_numpy(rgb), tw,
            (1.0, 1.0, 1.0), Draws(None, {"jitter": jitter}))
        tl.backward()
        # f32 everywhere; sums (field scatters, MLP products) in another
        # order
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        for k, g in jckpt.state_dict(jg).items():
            t, transpose = weights.port_tensor(tn, k)
            if t.grad is None:
                # tensors the port does not differentiate: nmf_tpu's
                # gradient is exactly zero there
                assert not np.any(g), k
                continue
            tg = t.grad.numpy()
            np.testing.assert_allclose(tg.T if transpose else tg, g,
                                       rtol=1e-4, atol=1e-8 + 1e-5
                                       * np.abs(g).max(), err_msg=k)
        jn, state, _ = jstep(jn, state, jnp.asarray(rays), jnp.asarray(rgb),
                             jnp.ones(3), key, jw)
        topt.step()
        # Adam's first steps are ~lr * sign(g): entries whose gradient sits
        # at the f32 summation noise may move differently, by at most
        # lr * sched ~ 2e-4 here, and rarely; 1e-5 covers what is seen
        for k, v in jckpt.state_dict(jn).items():
            np.testing.assert_allclose(_port_value(tn, k), v, rtol=1e-5,
                                       atol=1e-5, err_msg=k)


def test_render_image_matches():
    jn, tn, _ = build_pair("f32", ["model.arch.max_samples_per_ray=32"])
    ds = jload(DATASET, None, "test")
    rays = ds["all_rays"][:256]
    gt = ds["all_rgbs"][:256].reshape(16, 16, 3)
    # nmf_tpu's render run op by op: under jit, XLA's fused arithmetic
    # moves z_vals by an ulp and flips a few samples at box and mask-cell
    # edges (22 of 256 x 32 here), which jit-vs-eager nmf_tpu shows too
    jm = jeval.render_image(
        jn, rays, (16, 16), jax.random.PRNGKey(0), chunk=100,
        render_fn=lambda n, r, k, c: jrender(n, r, k, is_train=False,
                                             draw_debug=True)[0])
    tm = teval.render_image(tn, rays, (16, 16), chunk=100)
    for k in ("rgb_map", "acc_map", "depth"):
        np.testing.assert_allclose(tm[k], np.asarray(jm[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    jp = jutils.rgb_psnr(np.clip(jm["rgb_map"], 0, 1), gt)
    tp = teval.utils.rgb_psnr(np.clip(tm["rgb_map"], 0, 1), gt)
    assert abs(tp - jp) < 1e-3


def test_reconstruction_on_cpu_writes_eval_images(tmp_path):
    lines = []
    _, res = ttrain.reconstruction(ttrain.config_lib.compose([
        "model=tensorf", "dataset=synthetic_sphere", "device=cpu",
        "model.params.n_iters=20", "model.params.batch_size=128",
        "field.N_voxel_init=4096", "field.N_voxel_final=8000",
        "field.upsamp_list=[]", "model.arch.sampler.update_list=[10]",
        "model.arch.max_samples_per_ray=32",
        "model.arch.model.diffuse_module.featureC=16",
        "dataset.image_size=12", "dataset.n_views=3",
        f"basedir={tmp_path}", "expname=t", "progress_refresh_rate=5"]),
        log=lines.append)
    out = tmp_path / "synthetic_sphere_t" / "imgs_test_all"
    assert sorted(p.name for p in out.glob("*.png")) == [
        "000.png", "001.png", "002.png"]
    assert (out / "rgbd" / "000.png").read_bytes()[:4] == b"\x89PNG"
    assert (out / "mean.txt").exists()
    assert any("schedule event" in ln for ln in lines)
    assert np.isfinite(res["loss"]) and res["psnr"] > 5


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import nmf_tpu_torch\n"
        "for m in pkgutil.walk_packages(nmf_tpu_torch.__path__, "
        "'nmf_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'nmf_tpu')]\n"
        "assert not bad, bad\n"
        "for m in ('ckpt', 'logging_utils', 'data.synthetic', 'train',\n"
        "          'data.blender', 'data.exr', 'data.nsvf',\n"
        "          'data.exr_native',\n"
        "          'ops.marching', 'ops.optics', 'scripts.fit_field',\n"
        "          'scripts.export_mesh', 'scripts.graph_brdfs',\n"
        "          'scripts.reeval', 'scripts.tabularize',\n"
        "          'scripts.colmap2nerf', 'scripts.llff2nerf',\n"
        "          'scripts.collect_env', 'scripts.bench_scatter',\n"
        "          'scripts.bench_gather', 'scripts.bench_shade',\n"
        "          'scripts.bisect_shade', 'scripts.parse_trace'):\n"
        "    assert 'nmf_tpu_torch.' + m in sys.modules, m\n"
        "other = [k for k in sys.modules if k.split('.')[0] in "
        "('cv2', 'imageio')]\n"
        "assert not other, other\n"
        "print(len([k for k in sys.modules "
        "if k.startswith('nmf_tpu_torch.')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_chip_smoke_refuses_without_a_card(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes((REPO / "chip_smoke.py").read_bytes())
    for cwd in (REPO, tmp_path):
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


@pytest.mark.parametrize("target", [
    ["field=grid", "field.grid_size=[8,8,8]"],
    ["model=tensorf", "model.arch.model.diffuse_module._target_="
     "modules.render_modules.MLPRender_PE"]], ids=["grid", "MLPRender_PE"])
def test_ported_targets_build(target):
    """The dense voxel field and the MLPRender_PE head build, with
    nmf_tpu's parameter keys and shapes."""
    cfg = ttrain.config_lib.compose(["model=tensorf",
                                     "field.N_voxel_init=4096", *target])
    jsd = jckpt.state_dict(jbuild(jax.random.PRNGKey(0),
                                  cfg["model"]["arch"], AABB, NEAR_FAR))
    tsd = weights.to_jax_state_dict(tbuild(cfg["model"]["arch"], AABB,
                                           NEAR_FAR, device="cpu"))
    assert sorted(tsd) == sorted(jsd)
    for k, v in jsd.items():
        assert tsd[k].shape == v.shape, k


# every fallthrough of the builders (ROADMAP C.14): (override, what
# nmf_tpu does with it: the class it builds at ``attr``, or the exception)
FALLTHROUGHS = {
    "field": ("model.arch.rf._target_=fields.other.OtherRF", ValueError),
    "sampler": ("model.arch.sampler._target_=samplers.ngp_pl.NGPSampler",
                "sampler"),
    "brdf_sampler": ("model.arch.model.brdf_sampler._target_="
                     "modules.brdf_samplers.OtherSampler", ValueError),
    "visibility": ("model.arch.model.visibility_module._target_="
                   "modules.other.OtherVis", ValueError),
    "bright_sampler": ("model.arch.model.bright_sampler._target_="
                       "modules.other.OtherBright", ValueError),
    "brdf": ("model.arch.model.brdf._target_=modules.brdf.OtherBRDF",
             "model.brdf"),
    "model": ("model.arch.model._target_=models.other.OtherModel",
              ValueError),
    "normal_module": ("model.arch.normal_module._target_="
                      "modules.other.OtherNormal", ValueError),
    "bg": ("model.arch.bg_module._target_=modules.other.OtherEnv",
           ValueError),
}


@pytest.mark.parametrize("site", list(FALLTHROUGHS))
def test_builder_fallthroughs_match_nmf_tpu(site):
    """An unknown target at each fallthrough of the builders: both
    packages raise the same exception class, or build the same class
    (the AlphaGridSampler for any other sampler, the MLPBRDF for any other
    BRDF)."""
    override, expect = FALLTHROUGHS[site]
    cfg = ttrain.config_lib.compose([*FLAGSHIP, override])
    arch = cfg["model"]["arch"]
    if isinstance(expect, type):
        with pytest.raises(expect):
            jbuild(jax.random.PRNGKey(0), arch, AABB, NEAR_FAR)
        with pytest.raises(expect, match="unknown"):
            tbuild(arch, AABB, NEAR_FAR, device="cpu")
        return
    jn = jbuild(jax.random.PRNGKey(0), arch, AABB, NEAR_FAR)
    tn = tbuild(arch, AABB, NEAR_FAR, device="cpu")
    jobj, tobj = jn, tn
    for name in expect.split("."):
        jobj, tobj = getattr(jobj, name), getattr(tobj, name)
    assert type(tobj).__name__ == type(jobj).__name__
    assert type(tobj).__name__ in ("AlphaGridSampler", "MLPBRDF")


def test_unported_targets_raise():
    # nmf_tpu's Microfacet cannot build the Specular BRDF (ROADMAP C.12):
    # the port raises, naming C.12
    cfg = ttrain.config_lib.compose([
        *FLAGSHIP, "model.arch.model.brdf._target_=modules.brdf.Specular"])
    with pytest.raises(NotImplementedError, match="C.12"):
        tbuild(cfg["model"]["arch"], AABB, NEAR_FAR, device="cpu")
    if not torch.cuda.is_available():
        cfg = ttrain.config_lib.compose(["model=tensorf"])
        with pytest.raises(RuntimeError):
            tbuild(cfg["model"]["arch"], AABB, NEAR_FAR, device="cuda")


@pytest.mark.parametrize("override", [
    ["model.arch.hdr=true",
     "model.arch.tonemap._target_=modules.tonemap.HDRTonemap"],
    ["model.arch.mlp_dtype=bf16"],
    ["model.arch.sampler.superstep=2"],
    ["model.arch.sampler.fine_alpha_test=false"],
    ["model.arch.bg_module.mipnoise=0.1"],
    ["model.arch.model.brdf.dotpe=0"],
    ["model.arch.model.brdf.activation=sigexp"]],
    ids=["hdr", "mlp_dtype_bf16", "superstep2", "no_fine_alpha_test",
         "mipnoise", "dotpe0", "sigexp"])
def test_ported_flagship_knobs_build_and_match(override):
    """Knobs that raised before their slice build, with nmf_tpu's
    state-dict keys and shapes, and give nmf_tpu's eval render of 64 rays
    (rgb to 1e-5 of its largest, bf16 operands to 1e-4: an ulp of an MLP
    input can flip a bf16 rounding; acc to 1e-6). The envmap's mip bias is
    at 12, as in tests/test_torch_flagship.py, so its lookups agree to
    1e-6. ``mipnoise`` is read on no path (ROADMAP C.12): the port's render
    with it equals its render without it, bit for bit."""
    from nmf_tpu_torch.ops.draws import Draws as TDraws
    from torch_parity import build_flagship_pair, port_copy, render_draws
    jn, _, cfg = build_flagship_pair(override)
    jn = jn.replace(bg_module=jn.bg_module.replace(
        mipbias=jnp.asarray(12.0, jnp.float32)))
    tn = port_copy(jn, cfg)
    jsd, tsd = jckpt.state_dict(jn), weights.to_jax_state_dict(tn)
    assert sorted(tsd) == sorted(jsd)
    for k, v in jsd.items():
        assert tsd[k].shape == v.shape, k
    ds = jload(DATASET, None, "train")
    rays = ds["all_rays"][np.random.default_rng(0).choice(
        ds["all_rays"].shape[0], B, replace=False)]
    key = jax.random.PRNGKey(9)
    jims, _ = jax.jit(lambda n, r: jrender(
        n, r, key, is_train=False, bg_cache=n.bg_module.prepare()))(
            jn, jnp.asarray(rays))
    with torch.no_grad():
        tims, _ = ttrain.trainer.render(
            tn, torch.from_numpy(rays), is_train=False,
            draws=TDraws(None, render_draws(key, jn, B, False)),
            bg_cache=tn.bg_module.prepare())
    tol = 1e-4 if "bf16" in override[0] else 1e-5
    want = np.asarray(jims["rgb_map"])
    np.testing.assert_allclose(tims["rgb_map"].numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())
    np.testing.assert_allclose(tims["acc_map"].numpy(),
                               np.asarray(jims["acc_map"]), rtol=0,
                               atol=1e-6)
    if "mipnoise" in override[0]:
        tn.bg_module.mipnoise = 0.0
        with torch.no_grad():
            plain, _ = ttrain.trainer.render(
                tn, torch.from_numpy(rays), is_train=False,
                draws=TDraws(None, render_draws(key, jn, B, False)),
                bg_cache=tn.bg_module.prepare())
        assert torch.equal(plain["rgb_map"], tims["rgb_map"])


# the tiny tensorf of test_reconstruction_on_cpu_writes_eval_images, one
# step, an eval of one view
TINY_TENSORF = [
    "model=tensorf", "dataset=synthetic_sphere", "device=cpu",
    "model.params.n_iters=1", "model.params.batch_size=64",
    "field.N_voxel_init=4096", "field.N_voxel_final=8000",
    "field.upsamp_list=[]", "model.arch.sampler.update_list=[]",
    "model.arch.max_samples_per_ray=32",
    "model.arch.model.diffuse_module.featureC=16",
    "dataset.image_size=8", "dataset.n_views=2", "N_vis=1"]


@pytest.mark.parametrize("render_only", [False, True])
def test_stream_knob_runs(tmp_path, render_only):
    """stream=true runs: in training, whose final eval does not read it
    (as nmf_tpu's), and in render_only, which renders the checkpoint's
    test views through render_streaming: its PSNR is that of evaluate's
    streaming render of the same model."""
    base = [*TINY_TENSORF, "dataset.image_size=16", f"basedir={tmp_path}",
            "expname=s"]
    nmf, res = ttrain.dispatch(ttrain.config_lib.compose(
        [*base, "stream=true"] if not render_only else base))
    assert np.isfinite(res["psnr"])
    if not render_only:
        assert (tmp_path / "synthetic_sphere_s" / "imgs_test_all" /
                "surf_width").is_dir()
        return
    ckpt = tmp_path / "synthetic_sphere_s" / "synthetic_sphere_s.th"
    cfg = ttrain.config_lib.compose([*base, "render_only=true",
                                     f"ckpt={ckpt}", "stream=true"])
    _, rendered = ttrain.dispatch(cfg)
    test_ds = tload(cfg["dataset"], None, split="test")
    direct = teval.evaluate(nmf, test_ds, n_vis=1, seed=cfg["seed"],
                            streaming=True)
    assert rendered["psnr"] == pytest.approx(direct["psnr"], abs=1e-4)
    assert not (tmp_path / "synthetic_sphere_s" / "imgs_render" /
                "surf_width").exists()


def _pano(tmp_path, name, seed):
    """An HDR panorama written as a FLOAT / ZIPS EXR; returns the array."""
    pano = np.random.default_rng(seed).gamma(0.6, 2.0, (8, 16, 3)).astype(
        np.float32)
    texr.write_exr(tmp_path / name, pano)
    return pano


@pytest.mark.parametrize("render_only", [False, True])
def test_gt_bg_file_is_read(tmp_path, monkeypatch, render_only):
    """A run with a top-level gt_bg=<exr>, in training and in render_only,
    hands the file's panorama to its final eval."""
    pano = _pano(tmp_path, "pano.exr", 0)
    seen = []
    monkeypatch.setattr(ttrain.eval_lib, "evaluate",
                        lambda *a, **k: seen.append(k.get("gt_bg")) or {})
    overrides = [*TINY_TENSORF, f"basedir={tmp_path}",
                 f"gt_bg={tmp_path / 'pano.exr'}"]
    if render_only:
        cfg = ttrain.config_lib.compose(overrides)
        nmf = tbuild(cfg["model"]["arch"], AABB, NEAR_FAR, device="cpu")
        tckpt.save(tmp_path / "m.th", nmf, cfg)
        overrides += ["render_only=True", f"ckpt={tmp_path / 'm.th'}"]
    ttrain.dispatch(ttrain.config_lib.compose(overrides), log=lambda s: None)
    assert len(seen) == 1
    np.testing.assert_array_equal(seen[0], pano)


@pytest.mark.parametrize("case", ["top-level path", "dataset file present",
                                  "dataset file absent"])
def test_resolve_gt_bg_matches(tmp_path, case):
    """The panorama of the envmap metrics: a top-level gt_bg path; the
    dataset yaml's gt_bg file under <datadir>/backgrounds, which replaces
    it where the file exists; else the scene's own panorama. Both packages
    pick the same one."""
    top = _pano(tmp_path, "top.exr", 1)
    (tmp_path / "backgrounds").mkdir()
    ds_bg = _pano(tmp_path / "backgrounds", "bg.exr", 2)
    overrides = ["dataset=synthetic_sphere", f"datadir={tmp_path}"]
    if case != "dataset file absent":
        overrides.append(f"gt_bg={tmp_path / 'top.exr'}")
    if case != "top-level path":
        overrides.append("dataset.gt_bg="
                         + ("bg.exr" if case == "dataset file present"
                            else "missing.exr"))
    ds = {"gt_bg_im": np.zeros((2, 4, 3), np.float32)}
    cfg = ttrain.config_lib.compose(overrides)
    ours = ttrain._resolve_gt_bg(cfg, str(tmp_path), ds)
    theirs = jtrain._resolve_gt_bg(cfg, str(tmp_path), ds)
    want = {"top-level path": top, "dataset file present": ds_bg,
            "dataset file absent": ds["gt_bg_im"]}[case]
    np.testing.assert_array_equal(ours, want)
    np.testing.assert_array_equal(theirs, want)


def test_dataset_gt_bg_file_raises(tmp_path):
    """A dataset gt_bg file that exists but cannot be read (PIZ compressed)
    raises: no fallback to the scene's own panorama hides it."""
    cfg = ttrain.config_lib.compose([
        "model=tensorf", "dataset=synthetic_sphere", f"datadir={tmp_path}",
        "dataset.gt_bg=pano.exr"])
    ds = {"gt_bg_im": np.zeros((2, 4, 3))}
    assert ttrain._resolve_gt_bg(cfg, str(tmp_path), ds) is ds["gt_bg_im"]
    (tmp_path / "backgrounds").mkdir()
    path = tmp_path / "backgrounds" / "pano.exr"
    texr.write_exr(path, np.ones((4, 8, 3)))
    raw = path.read_bytes()
    key = b"compression\0compression\0" + struct.pack("<i", 1)
    path.write_bytes(raw.replace(key + bytes([2]), key + bytes([4])))
    with pytest.raises(ValueError, match="PIZ"):
        ttrain._resolve_gt_bg(cfg, str(tmp_path), ds)


def _nerf_synthetic(root, n_views=3, size=16):
    """The studio scene in nerf_synthetic layout at the paths dataset=lego
    names: <root>/nerf_synthetic/lego (RGBA, normals, tints) and
    <root>/backgrounds/lego_bg.exr (its HDR panorama). Returns the
    panorama."""
    for split in ("train", "test"):
        ds = make_shiny_dataset(n_views=n_views, H=size, W=size,
                                n_gi_samples=2, scene="studio",
                                hemisphere=True, split=split)

        def views(key, c):
            return ds[key].reshape(n_views, size, size, c)

        save_blender_split(root / "nerf_synthetic" / "lego", split,
                           ds["poses"], views("all_rgbs", 4),
                           np.deg2rad(55.0), views("all_norms", 3),
                           views("all_tints", 3))
    (root / "backgrounds").mkdir()
    texr.write_exr(root / "backgrounds" / "lego_bg.exr", ds["gt_bg_im"])
    return ds["gt_bg_im"]


# the verify skill's tiny CPU flagship on dataset=lego, 10 iterations
BLENDER_FLAGSHIP = [
    "model=microfacet_tensorf2", "dataset=lego", "device=cpu",
    "model.params.n_iters=10", "field.N_voxel_init=4096",
    "field.N_voxel_final=8000", "field.upsamp_list=[]",
    "model.arch.max_samples_per_ray=16",
    "model.arch.recur_samples_per_ray=8",
    "model.arch.proposal_samples_per_ray=8",
    "model.arch.model.brdf_ray_budget=[512,128]",
    "model.arch.model.max_retrace_rays=[32]",
    "model.arch.bg_module.bg_resolution=32", "model.params.batch_size=64",
    "dataset.near_far=[1.4,5.0]", "dataset.stack_norms=true"]


def test_blender_flagship_run_on_cpu(tmp_path):
    """The default run's dataset on the CPU: the tiny flagship trains on
    the nerf_synthetic folder, writes pano.exr (the envmap, read back
    exactly), and its envmap metrics against the HDR gt_bg equal nmf_tpu's
    calc_envmap_metrics on the same envmap carried across and the same
    file."""
    pano = _nerf_synthetic(tmp_path / "data")
    tn, res = ttrain.reconstruction(ttrain.config_lib.compose([
        *BLENDER_FLAGSHIP, f"datadir={tmp_path / 'data'}",
        f"basedir={tmp_path}", "expname=b"]), log=lambda s: None)
    assert np.isfinite(res["loss"]) and res["psnr"] > 5
    assert pano.max() > 1  # the sun: the metrics see values above 1
    out = tmp_path / "lego_b" / "imgs_test_all"
    np.testing.assert_array_equal(texr.read_exr(out / "pano.exr"),
                                  teval.envmap_image(tn.bg_module))
    cfg = jconfig.compose(BLENDER_FLAGSHIP)
    jn = jbuild(jax.random.PRNGKey(0), cfg["model"]["arch"], AABB, NEAR_FAR)
    jn = jckpt.load_state_dict(jn, weights.to_jax_state_dict(tn))
    jm = jeval.calc_envmap_metrics(
        jn.bg_module,
        jexr.imread_any(tmp_path / "data" / "backgrounds" / "lego_bg.exr"))
    assert set(jm) <= set(res)
    for k, v in jm.items():
        tol = 1e-4 if "psnr" in k else 1e-5
        assert abs(res[k] - v) <= tol, (k, res[k], v)


def test_render_loaded_view_matches(tmp_path):
    """One view of the nerf_synthetic folder, loaded by each package's
    loader (the same rays), rendered eagerly by both, as
    test_render_image_matches does for the sphere."""
    _nerf_synthetic(tmp_path)
    cfg = {"dataset_name": "blender", "scenedir": "nerf_synthetic/lego"}
    ours = tload(cfg, str(tmp_path), "test")
    theirs = jload(cfg, str(tmp_path), "test")
    np.testing.assert_array_equal(ours["all_rays"], theirs["all_rays"])
    rays = ours["all_rays"][:256]
    jn, tn, _ = build_pair("f32", ["model.arch.max_samples_per_ray=32"])
    jm = jeval.render_image(
        jn, rays, (16, 16), jax.random.PRNGKey(0), chunk=100,
        render_fn=lambda n, r, k, c: jrender(n, r, k, is_train=False,
                                             draw_debug=True)[0])
    tm = teval.render_image(tn, rays, (16, 16), chunk=100)
    assert float(np.asarray(jm["acc_map"]).max()) > 0.01  # the box is hit
    # rgb and acc to 3e-7; depth (2 to 3 units) to an ulp or two
    for k in ("rgb_map", "acc_map", "depth"):
        np.testing.assert_allclose(tm[k], np.asarray(jm[k]), rtol=4e-7,
                                   atol=3e-7, err_msg=k)


def test_eval_tier_scales_the_budgets_inside_its_block():
    cfg = ttrain.config_lib.compose([*FLAGSHIP])
    tn = tbuild(cfg["model"]["arch"], AABB, NEAR_FAR, device="cpu")
    m = tn.model
    before = (m.test_rays_per_ray, m.brdf_ray_budget, m.max_retrace_rays)
    with teval.apply_eval_tier(tn, "high"):
        assert (m.test_rays_per_ray, m.brdf_ray_budget,
                m.max_retrace_rays) == (256, (1024, 256), (64,))
    assert (m.test_rays_per_ray, m.brdf_ray_budget,
            m.max_retrace_rays) == before
    assert [teval.validate_eval_tier(t) for t in ("train", "ultra", 3)] \
        == [1, 4, 3]
    for bad in ("hgih", 2.5, 0):
        with pytest.raises(ValueError):
            teval.validate_eval_tier(bad)
