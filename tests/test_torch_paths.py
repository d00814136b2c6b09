"""Orbit paths, videos, scene composition, relit renders and the ray
logger in nmf_tpu_torch against nmf_tpu: ``eval.render_path``, the test
sweep's videos, ``scripts/compose_scenes.py``, ``render_only fixed_bg=``
and ``modules/logger.py`` with ``log_rays``.

nmf_tpu's eval renders run op by op here (``_EagerJax``): jitted, XLA's
fused arithmetic flips samples at box and mask-cell faces (ROADMAP C.3).
The flagship's random draws replay nmf_tpu's key splits by name: one a
frame or view, then one a chunk."""
import math
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from nmf_tpu import ckpt as jckpt  # noqa: E402
from nmf_tpu import eval as jeval  # noqa: E402
from nmf_tpu import train as jtrain  # noqa: E402
from nmf_tpu.modules import logger as jlogger  # noqa: E402
from nmf_tpu.modules.bg import init_integral_equirect as jinit_bg  # noqa: E402
from nmf_tpu.scripts import compose_scenes as jcompose  # noqa: E402
from nmf_tpu_torch import ckpt as tckpt  # noqa: E402
from nmf_tpu_torch import eval as teval  # noqa: E402
from nmf_tpu_torch import train as ttrain  # noqa: E402
from nmf_tpu_torch.data import load_dataset  # noqa: E402
from nmf_tpu_torch.modules.logger import (RayLogger,  # noqa: E402
                                          collect_ray_debug)
from nmf_tpu_torch.ops.draws import Draws  # noqa: E402
from nmf_tpu_torch.scripts import compose_scenes as tcompose  # noqa: E402
from torch_inputs import FLAGSHIP  # noqa: E402
from torch_parity import (build_flagship_pair, build_pair, close,  # noqa: E402
                          render_draws)

FWD = 1e-5
# frames and views of 16 x 16, one chunk of 256 rays each
SIZE, CHUNK = 16, 256
FOCAL = 0.5 * SIZE / np.tan(0.5 * np.deg2rad(60.0))



@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny shapes run fastest on one thread, and the test workers
    share the CPU cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

class _EagerJax:
    """``jax`` with ``jit`` the identity, for nmf_tpu's eval module."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fn, *args, **kwargs):
        return fn


@pytest.fixture
def eager(monkeypatch):
    monkeypatch.setattr(jeval, "jax", _EagerJax())


def _pair(model):
    if model == "flagship":
        return build_flagship_pair([f"model.arch.eval_batch_size={CHUNK}"])
    return build_pair("f32", ["model.arch.max_samples_per_ray=32"])


def _replayed(key, jn, scope, n, chunks=1):
    """The draws of ``n`` renders of ``chunks`` chunks each (nmf_tpu: a key
    split a render, then one a chunk), by the port's names
    ``{scope}{i}/chunk{j}/...``."""
    given = {}
    for i in range(n):
        key, sk = jax.random.split(key)
        for j in range(chunks):
            sk, ck = jax.random.split(sk)
            given.update({f"{scope}{i}/chunk{j}/{k}": v for k, v in
                          render_draws(ck, jn, CHUNK, False).items()})
    return given


@pytest.mark.parametrize("model", ["tensorf", "flagship"])
def test_render_path_matches_nmf_tpu(tmp_path, eager, model):
    """Two orbit frames of each package at FWD; the port writes each as
    path/<iii>.png (nmf_tpu's truncation to 8 bits, to one level where the
    two frames straddle a level) and both as the 2-frame path.gif."""
    jn, tn, _ = _pair(model)
    key = jax.random.PRNGKey(3)
    jframes = jeval.render_path(jn, (SIZE, SIZE), FOCAL, key, n_frames=2,
                                chunk=CHUNK)
    draws = Draws(None, _replayed(key, jn, "frame", 2))
    tframes = teval.render_path(tn, (SIZE, SIZE), FOCAL, n_frames=2,
                                chunk=CHUNK, save_dir=str(tmp_path),
                                draws=draws)
    for a, b in zip(tframes, jframes):
        close(a, np.asarray(b), FWD, "frame")
    for i, f in enumerate(jframes):
        png = np.asarray(Image.open(tmp_path / "path" / f"{i:03d}.png"))
        ref = (np.clip(np.asarray(f), 0, 1) * 255).astype(np.uint8)
        assert np.abs(png.astype(int) - ref).max() <= 1
    assert teval.gif_frame_count(tmp_path / "path.gif") == 2
    with Image.open(tmp_path / "path.gif") as gif:
        assert gif.size == (SIZE, SIZE)


def test_write_video(tmp_path):
    """Float, grey and uint8 frames; the file takes the suffix .gif; PIL
    merges a frame equal to the one before it, and ``gif_frame_count``
    counts the frames by the GIF's time."""
    rng = np.random.default_rng(0)
    frames = [rng.uniform(size=(6, 5, 3)) for _ in range(3)]
    path = teval.write_video(tmp_path / "v.mp4", frames)
    assert path.name == "v.gif"
    with Image.open(path) as gif:
        assert (gif.n_frames, gif.size) == (3, (5, 6))
        gif.seek(1)
        back = np.asarray(gif.convert("RGB"))
    # the GIF palette quantizes: within a few levels of the truncation
    ref = (np.clip(frames[1], 0, 1) * 255).astype(np.uint8)
    assert np.abs(back.astype(int) - ref).mean() < 8
    grey = [rng.uniform(size=(4, 4)), (rng.uniform(size=(4, 4, 3)) * 255)
            .astype(np.uint8)]
    path = teval.write_video(tmp_path / "g", grey + grey[-1:] * 2)
    with Image.open(path) as g:
        assert g.n_frames == 2
    assert teval.gif_frame_count(path) == 4
    assert teval.write_video(tmp_path / "none", []) is None


@pytest.mark.parametrize("model", ["tensorf", "flagship"])
def test_evaluate_writes_the_sweep_videos(tmp_path, model):
    """``evaluate`` of more than one view writes video.gif and
    depthvideo.gif, and normalvideo.gif where the render gives world
    normals, one frame a view; of one view, none."""
    _, tn, _ = _pair(model)
    data = load_dataset({"dataset_name": "synthetic_sphere", "n_views": 3,
                         "image_size": SIZE}, None, "test")
    normals = "world_normal" in teval.render_image(
        tn, data["all_rays"][:SIZE * SIZE], (SIZE, SIZE))
    teval.evaluate(tn, data, save_dir=str(tmp_path / "all"),
                   compute_extra_metrics=False)
    names = ["depthvideo.gif", "video.gif"] + (
        ["normalvideo.gif"] if normals else [])
    assert sorted(p.name for p in (tmp_path / "all").glob("*.gif")) == sorted(
        names)
    for name in names:
        assert teval.gif_frame_count(tmp_path / "all" / name) == 3, name
        with Image.open(tmp_path / "all" / name) as gif:
            assert gif.size == (SIZE, SIZE), name
    teval.evaluate(tn, data, save_dir=str(tmp_path / "one"), n_vis=1,
                   compute_extra_metrics=False)
    assert not list((tmp_path / "one").glob("*.gif"))


def _save_pair(tmp_path, name, model="tensorf", mask=True):
    """A tiny model saved by the port (format 2): (path, nmf_tpu's model,
    the port's). With ``mask``, its alpha mask first rebuilt from its own
    density, as compose_scenes rebuilds it from the composition's."""
    jn, tn, cfg = _pair(model)
    if mask:
        tn.sampler.update(tn.rf, init=False)
    tckpt.save(tmp_path / name, tn, cfg)
    return tmp_path / name, tn


def test_compose_one_checkpoint_is_its_render_path(tmp_path):
    """One checkpoint at zero offset: the composition's first frame is
    render_path's first frame of the checkpoint itself."""
    path, _ = _save_pair(tmp_path, "a.th")
    frames = tcompose.main(["--ckpt", str(path), "--out",
                            str(tmp_path / "c"), "--frames", "2",
                            "--image-size", str(SIZE), "--device", "cpu"])
    nmf = tckpt.load(path, "cpu")[0]
    # the script's focal, a Python float: a numpy float64 would compute the
    # ray directions in f64 (NumPy's promotion) and move samples by an ulp
    ref = teval.render_path(nmf, (SIZE, SIZE),
                            0.5 * SIZE / math.tan(0.5 * 0.6911), n_frames=2)
    close(frames[0], ref[0], FWD, "frame 0")
    assert (tmp_path / "c" / "path.gif").exists()


def _jax_envmap_file(tmp_path):
    """nmf_tpu's bare envmap file (format 1, as its pano2env writes it) of
    an envmap of 16 x 32 random texels, mip bias 12: every lookup box
    spans the map (a box of a few texels is a difference of SAT entries
    that the two packages sum in another order,
    ``test_torch_flagship_modules.py::test_envmap_matches``)."""
    bg = jinit_bg(jax.random.PRNGKey(0), bg_resolution=16)
    bg = bg.replace(bg_mat=jnp.asarray(np.random.default_rng(4).normal(
        -0.5, 0.5, (3, 16, 32)).astype(np.float32)),
        mipbias=jnp.asarray(12.0))
    jckpt.save(tmp_path / "env.th", bg, {"source": "test"})
    return tmp_path / "env.th"


def test_compose_two_checkpoints_match_nmf_tpu(tmp_path, eager, monkeypatch):
    """Two checkpoints at offsets and rotations, with --bg, through both
    packages' scripts: the frames at FWD."""
    a, _ = _save_pair(tmp_path, "a.th")
    b, _ = _save_pair(tmp_path, "b.th")
    env = _jax_envmap_file(tmp_path)
    argv = ["--ckpt", str(a), "--ckpt", str(b), "--offset=-0.6,0,0",
            "--offset=0.6,0.1,0", "--rot-z", "0", "--rot-z", "30",
            "--bg", str(env), "--frames", "2", "--image-size", str(SIZE)]
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    theirs = jcompose.main([*argv, "--out", str(tmp_path / "j")])
    ours = tcompose.main([*argv, "--out", str(tmp_path / "t"),
                          "--device", "cpu"])
    assert len(ours) == len(theirs) == 2
    for x, y in zip(ours, theirs):
        close(x, np.asarray(y), FWD, "frame")


def test_fixed_bg_render_only_matches_nmf_tpu(tmp_path, eager, monkeypatch):
    """``render_only fixed_bg=<nmf_tpu's envmap file>`` on one tiny
    flagship checkpoint in both packages, the port replaying nmf_tpu's
    draws: the relit image at FWD, the PSNRs to 1e-4 dB; the relit image
    is not the checkpoint's own."""
    env = _jax_envmap_file(tmp_path)
    path, tn = _save_pair(tmp_path, "f.th", "flagship", mask=False)
    jn = jckpt.load(path)[0]
    ov = [*FLAGSHIP, "device=cpu", f"dataset.image_size={SIZE}",
          "dataset.n_views=2", "N_vis=1", f"basedir={tmp_path}", "expname=r",
          "render_only=true", f"ckpt={path}", "mesh_devices=1"]
    images = {"jax": [], "torch": []}
    for name, module in (("jax", jeval), ("torch", teval)):
        def record(*args, fn=module.render_image, name=name, **kwargs):
            maps = fn(*args, **kwargs)
            images[name].append(maps["rgb_map"])
            return maps

        monkeypatch.setattr(module, "render_image", record)
    relit = ttrain.config_lib.compose([*ov, f"fixed_bg={env}"])
    jres = jtrain.render_test(relit, log=lambda s: None)[1]
    given = _replayed(jax.random.PRNGKey(0), jn, "image", 1)
    monkeypatch.setattr(teval, "Draws", lambda *a, **k: Draws(None, given))
    tres = ttrain.render_test(relit, log=lambda s: None)[1]
    ttrain.render_test(ttrain.config_lib.compose(ov), log=lambda s: None)
    ours, unlit = images["torch"]
    close(ours, images["jax"][0], FWD, "relit rgb_map")
    assert abs(tres["psnr"] - jres["psnr"]) < 1e-4
    assert np.abs(ours - unlit).max() > 1e-3


def test_ray_logger_matches_nmf_tpu(tmp_path, eager, monkeypatch):
    """Both packages' ``evaluate`` with the ray logger on: the central
    bundle of the first view (at most max_rays rays), its sample
    positions, validity and weights at FWD, the normals at FWD where a
    sample is valid (elsewhere both normalize the field's gradient at
    padding positions), and rays.pkl; no rays.html without plotly."""
    jn, tn, _ = _pair("flagship")
    data = load_dataset({"dataset_name": "synthetic_sphere", "n_views": 2,
                         "image_size": SIZE}, None, "test")
    monkeypatch.setattr(jlogger.LOGGER, "enable", True)
    monkeypatch.setattr(jlogger.LOGGER, "max_rays", 100)
    monkeypatch.setattr(jlogger.LOGGER, "entries", [])
    jeval.evaluate(jn, data, jax.random.PRNGKey(0), save_dir=str(
        tmp_path / "j"), n_vis=1, compute_extra_metrics=False)
    ours = RayLogger(enable=True, max_rays=100)
    teval.evaluate(tn, data, save_dir=str(tmp_path / "t"), n_vis=1,
                   compute_extra_metrics=False, ray_logger=ours)
    with open(tmp_path / "t" / "rays.pkl", "rb") as f:
        saved = pickle.load(f)
    theirs = jlogger.LOGGER.entries
    assert len(saved) == len(theirs) == 1
    assert sorted(saved[0]) == sorted(theirs[0])
    assert saved[0]["rays"].shape == (100, 6)
    valid = np.asarray(theirs[0]["valid"])
    np.testing.assert_array_equal(saved[0]["valid"], valid)
    for k, v in theirs[0].items():
        a, b = saved[0][k].astype(np.float32), np.asarray(v, np.float32)
        if k == "normals":
            a, b = a[valid], b[valid]
        close(a, b, FWD, k)
    assert ours.to_plotly() is None or ours.save_html(
        str(tmp_path / "t" / "rays.html"))


def test_collect_ray_debug_weights_are_the_kernels_plain_version():
    """The logger's weights go through ``transmittance_weights`` (the
    composite kernel on the card; its plain version here), which equals
    ``ops.masked.raw2alpha`` on the bundle's densities."""
    from nmf_tpu_torch.ops.masked import raw2alpha

    _, tn, _ = _pair("flagship")
    rays = torch.from_numpy(load_dataset(
        {"dataset_name": "synthetic_sphere", "n_views": 1,
         "image_size": SIZE}, None, "test")["all_rays"][:64])
    dbg = collect_ray_debug(tn, rays)
    xyz, valid = dbg["xyz"], dbg["valid"]
    sigma = tn.rf.compute_densityfeature(xyz.reshape(-1, 4)).reshape(
        valid.shape).detach()
    samp = tn.sampler.sample(rays, is_train=False)
    w, _ = raw2alpha(torch.where(valid, sigma, torch.zeros_like(sigma)),
                     samp["dists"] * tn.rf.distance_scale)
    assert torch.allclose(dbg["weights"], w, rtol=1e-6, atol=1e-7)
    assert dbg["weights"].sum() > 0


def test_log_rays_and_render_path_through_the_cli(tmp_path):
    """A tiny model=tensorf run with log_rays=true and render_path=true
    writes imgs_test_all/rays.pkl (one bundle of at most 512 rays, finite
    weights) and imgs_path/ (60 frames and path.gif); render_only with
    log_rays writes its own."""
    ov = ["model=tensorf", "dataset=synthetic_sphere", "device=cpu",
          "model.params.n_iters=2", "model.params.batch_size=64",
          "field.N_voxel_init=4096", "field.N_voxel_final=8000",
          "field.upsamp_list=[]", "model.arch.sampler.update_list=[]",
          "model.arch.max_samples_per_ray=32",
          "model.arch.model.diffuse_module.featureC=16",
          "dataset.image_size=12", "dataset.n_views=2", "N_vis=1",
          f"basedir={tmp_path}", "expname=l", "log_rays=true"]
    ttrain.dispatch(ttrain.config_lib.compose([*ov, "render_path=true"]),
                    log=lambda s: None)
    out = tmp_path / "synthetic_sphere_l"
    with open(out / "imgs_test_all" / "rays.pkl", "rb") as f:
        entries = pickle.load(f)
    assert len(entries) == 1 and entries[0]["rays"].shape[0] <= 512
    assert np.isfinite(entries[0]["weights"]).all()
    assert len(list((out / "imgs_path" / "path").glob("*.png"))) == 60
    assert (out / "imgs_path" / "path.gif").exists()
    ttrain.dispatch(ttrain.config_lib.compose(
        [*ov, "render_only=true", f"ckpt={out / 'synthetic_sphere_l.th'}"]),
        log=lambda s: None)
    assert (out / "imgs_render" / "rays.pkl").exists()
