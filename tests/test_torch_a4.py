"""The rest of nmf_tpu's modules in nmf_tpu_torch, against nmf_tpu's on
the CPU: the NSVF and Tanks and Temples loaders on four-view scenes
written by numpy and PIL, the EXR bridge (files of every compression
written by nmf_tpu's ``exr_write_native``), ``scripts/reeval.py``,
``scripts/tabularize.py``, ``scripts/colmap2nerf.py`` and
``scripts/llff2nerf.py``, ``ops/optics.py``, the
``LearnableSphericalEncoding`` and ``LHyperGeom``, and
``scripts/collect_env.py``.

Tolerances: rays 1e-6; rgbs 1e-6, 1e-5 where the images are resized (the
Blender loader tests'); EXR pixels equal; reeval's stats 1e-6;
transforms' floats 1e-6; optics 1e-6; the encoding's outputs and
gradients and the series 1e-5 of their largest (a direction's gradient
1e-3 within ~0.1 rad of a lattice point, where it goes through arccos
near 1).
"""
import contextlib
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from nmf_tpu import ckpt as jckpt  # noqa: E402
from nmf_tpu.data import blender as jblender  # noqa: E402
from nmf_tpu.data import exr as jexr  # noqa: E402
from nmf_tpu.modules import ish as jish  # noqa: E402
from nmf_tpu.modules import render_modules as jrm  # noqa: E402
from nmf_tpu.native import exr_write_native  # noqa: E402
from nmf_tpu.ops import optics as joptics  # noqa: E402
from nmf_tpu.scripts import colmap2nerf as jcolmap  # noqa: E402
from nmf_tpu.scripts import llff2nerf as jllff  # noqa: E402
from nmf_tpu.scripts import reeval as jreeval  # noqa: E402
from nmf_tpu.scripts import tabularize as jtab  # noqa: E402
from nmf_tpu_torch import weights  # noqa: E402
from nmf_tpu_torch.data import exr as texr  # noqa: E402
from nmf_tpu_torch.data import exr_native  # noqa: E402
from nmf_tpu_torch.data import load_dataset as tload  # noqa: E402
from nmf_tpu_torch.modules import ish as tish  # noqa: E402
from nmf_tpu_torch.modules import render_modules as trm  # noqa: E402
from nmf_tpu_torch.ops import optics as toptics  # noqa: E402
from nmf_tpu_torch.scripts import (colmap2nerf, collect_env,  # noqa: E402
                                   llff2nerf, reeval, tabularize)
from torch_parity import close  # noqa: E402


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
    monkeypatch.setenv("NMF_DATASET_CACHE", "")


def _c2w(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    m = np.eye(4)
    m[:3, :3] = q
    m[:3, 3] = rng.uniform(-3, 3, 3)
    return m


def _write_view(root, name, rng, shape, rgba=False):
    """pose/<name>.txt and rgb/<name>.png (RGB, or RGBA with a ramp of
    alphas)."""
    np.savetxt(root / "pose" / f"{name}.txt", _c2w(rng))
    img = rng.integers(0, 256, (*shape, 4 if rgba else 3)).astype(np.uint8)
    Image.fromarray(img).save(root / "rgb" / f"{name}.png")


def _nsvf_scene(root, rng, layout):
    """A four-view scene: NSVF (focal / cx / cy intrinsics, views 0_ x2,
    one RGBA, 1_ and 2_) or Tanks and Temples (a 4 x 4 K, views 0_ x2,
    one RGBA, and 1_ x2, no test split)."""
    for sub in ("pose", "rgb"):
        (root / sub).mkdir(parents=True)
    np.savetxt(root / "bbox.txt",
               np.array([[-1.1, -0.9, -1.2, 1.0, 1.3, 0.8, 0.05]]))
    if layout == "nsvf":
        (root / "intrinsics.txt").write_text(
            "21.5 9.25 6.5 0.\n0. 0. 0.\n1.\n24 18\n")
        names, shape = ("0_000", "0_001", "1_000", "2_000"), (12, 16)
    else:
        K = np.array([[1611.0, 0, 958.5, 0], [0, 1605.0, 541.25, 0],
                      [0, 0, 1, 0], [0, 0, 0, 1]])
        np.savetxt(root / "intrinsics.txt", K)
        names, shape = ("0_000", "0_001", "1_000", "1_001"), (18, 32)
    for i, name in enumerate(names):
        _write_view(root, name, rng, shape, rgba=i == 1)


def _same(ours, theirs, tol):
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        if isinstance(v, np.ndarray):
            assert ours[k].shape == v.shape and ours[k].dtype == v.dtype, k
            atol = 1e-6 if k == "all_rays" else tol
            np.testing.assert_allclose(ours[k], v, rtol=tol, atol=atol,
                                       err_msg=k)
        else:
            assert ours[k] == v, k


@pytest.mark.parametrize("layout,downsample", [
    ("nsvf", 1.0), ("nsvf", 2.0), ("tankstemple", 120.0)])
def test_nsvf_loaders_match(tmp_path, layout, downsample):
    """load_dataset of both packages on the same four views, every split:
    the split prefixes, the RGBA view blended onto white, the box (x 1.2
    for Tanks and Temples), the intrinsics (scaled to 1920 / 120 x 1080 /
    120 = 16 x 9 there, and test falling back to val)."""
    _nsvf_scene(tmp_path / "scene", np.random.default_rng(3), layout)
    cfg = {"dataset_name": layout, "scenedir": "scene",
           "downsample_train": downsample}
    tol = 1e-6 if layout == "nsvf" and downsample == 1.0 else 1e-5
    for split in ("train", "val", "test"):
        ours = tload(cfg, str(tmp_path), split)
        theirs = jblender.load_dataset(cfg, str(tmp_path), split)
        _same(ours, theirs, tol)
        n_views = ours["poses"].shape[0]
        assert n_views == (2 if split == "train" or layout != "nsvf" else 1)
        w, h = ours["img_wh"]
        assert ours["all_rays"].shape == (n_views * w * h, 6)
    assert ours["img_wh"] == ((16, 9) if layout == "tankstemple" else
                              (int(16 / downsample), int(12 / downsample)))


@pytest.mark.parametrize("comp,name", [(0, "NONE"), (2, "ZIPS"), (3, "ZIP"),
                                       (4, "PIZ"), (9, "DWAB")])
def test_exr_native_files_read_alike(tmp_path, comp, name):
    """Files written by nmf_tpu's exr_write_native (OpenEXR, half RGBA) at
    each compression read equal through both packages' read_exr (the
    numpy reader for NONE / ZIPS / ZIP, the native bridge for the rest),
    and the port's own bridge writes the same file."""
    img = np.random.default_rng(comp).gamma(0.6, 1.5, (9, 13, 4)).astype(
        np.float32)
    path = tmp_path / f"{name}.exr"
    assert exr_write_native(str(path), img, comp)
    ours, theirs = texr.read_exr(path), jexr.read_exr(path)
    assert ours.shape == theirs.shape == (9, 13, 4)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_allclose(ours, img, rtol=1e-3, atol=1e-3)  # half
    mine = tmp_path / f"port_{name}.exr"
    assert exr_native.exr_write_native(mine, img, comp)
    assert mine.read_bytes() == path.read_bytes()


def test_exr_bridge_unavailable_raises_naming_the_compression(tmp_path,
                                                              monkeypatch):
    """Without a compiler the bridge cannot build: the port's read_exr of
    a PIZ file raises ValueError naming PIZ and why."""
    path = tmp_path / "piz.exr"
    assert exr_write_native(str(path), np.ones((4, 5, 3), np.float32), 4)
    monkeypatch.setattr(exr_native, "_LIB", None)
    monkeypatch.setattr(exr_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(exr_native, "find_cxx", lambda: None)
    with pytest.raises(ValueError, match="PIZ.*no g\\+\\+"):
        texr.read_exr(path)
    with pytest.raises(ValueError, match="PIZ"):
        texr.imread_any(path)
    assert not exr_native.exr_write_native(tmp_path / "x.exr",
                                           np.ones((2, 2)))


def _run_dir(root, rng):
    """A run folder as the eval leaves it: config.yaml of a tiny studio
    scene (which carries normals), the test views' PNGs (8-bit, as
    dumped), world normals for two of them and an earlier stats file with
    a key reeval does not recompute."""
    run = root / "studio_run"
    imgs = run / "imgs_test_all"
    (imgs / "world_normal").mkdir(parents=True)
    cfg = {"dataset": {"dataset_name": "synthetic_studio", "n_views": 3,
                       "image_size": 12, "n_gi_samples": 4,
                       "hemisphere": True, "scenedir": "s"},
           "datadir": str(root)}
    import yaml

    (run / "config.yaml").write_text(yaml.safe_dump(cfg))
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (12, 12, 3)).astype(
            np.uint8)).save(imgs / f"{i:03d}.png")
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (12, 12, 3)).astype(
            np.uint8)).save(imgs / "world_normal" / f"{i:03d}.png")
    (imgs / "stats.yaml").write_text(yaml.safe_dump(
        {"psnr": [10.0, 11.0], "tint_psnr": [20.0, 22.0]}))
    return run


def test_reeval_matches(tmp_path):
    run = _run_dir(tmp_path, np.random.default_rng(7))
    ours = reeval.reeval_run(run, str(tmp_path), suffix="_port",
                             log=lambda s: None)
    theirs = jreeval.reeval_run(run, str(tmp_path), suffix="_jax",
                                log=lambda s: None)
    assert sorted(ours) == sorted(theirs) == [
        "norm_err", "psnr", "ssim", "tint_psnr"]
    for k in ours:
        assert ours[k] == pytest.approx(theirs[k], rel=1e-6, abs=1e-6), k
    assert (run / "imgs_test_all" / "stats_port.yaml").exists()
    assert reeval.main([str(tmp_path), "--datadir", str(tmp_path)])


def _log_dir(root):
    """Two runs' stats files (lists and scalars), a mean.txt and the train
    PSNR telemetry."""
    import yaml

    a = root / "scene_a" / "imgs_test_all"
    b = root / "scene_b" / "imgs_test_all"
    for d in (a, b):
        d.mkdir(parents=True)
    (a / "stats.yaml").write_text(yaml.safe_dump(
        {"psnr": [30.5, 31.25], "ssim": [0.95, 0.96], "norm_err": 12.0}))
    (a / "mean.txt").write_text(str({"envmap_psnr": 18.5, "psnr": 1.0}))
    (b / "stats_reeval.yaml").write_text(yaml.safe_dump(
        {"psnr": 28.0, "tint_psnr": 21.75, "note": "x"}))
    recs = [{"step": s, "t": 1.5 * s, "psnr": 20.0 + s} for s in range(12)]
    (root / "scene_a" / "metrics.jsonl").write_text(
        "\n".join(json.dumps(r) for r in recs) + "\nnot json\n")
    (root / "scene_b" / "metrics.jsonl").write_text(
        json.dumps({"step": 1, "t": 2.0, "psnr": 12.0}) + "\n")


def _stdout(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(*args)
    return rc, out.getvalue()


def test_tabularize_matches(tmp_path):
    _log_dir(tmp_path)
    assert tabularize.collect(tmp_path) == jtab.collect(tmp_path)
    assert (tabularize.time_to_db(tmp_path, 30.0)
            == jtab.time_to_db(tmp_path, 30.0))
    assert tabularize.time_to_db(tmp_path, 30.0)["scene_b"] is None
    keys = tabularize.DEFAULT_KEYS
    rows = tabularize.collect(tmp_path)
    assert (tabularize.render_table(rows, keys)
            == jtab.render_table(rows, keys))
    for argv in ([str(tmp_path), "--time-to-db", "25"],
                 [str(tmp_path), "--json"],
                 [str(tmp_path), "--csv", str(tmp_path / "t.csv")]):
        ours, theirs = _stdout(tabularize.main, argv), _stdout(jtab.main,
                                                                argv)
        assert ours == theirs, argv


def _json_close(a, b):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b)
        for k in b:
            _json_close(a[k], b[k])
    elif isinstance(b, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _json_close(x, y)
    elif isinstance(b, float):
        assert a == pytest.approx(b, rel=1e-6, abs=1e-6)
    else:
        assert a == b


def test_colmap2nerf_matches(tmp_path):
    sparse = tmp_path / "sparse"
    sparse.mkdir()
    (sparse / "cameras.txt").write_text(
        "# header\n1 OPENCV 160 120 101.5 99.25 80.5 60.25 0.01 0 0 0\n")
    rng = np.random.default_rng(9)
    lines = ["# header"]
    for i in range(4):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        t = rng.uniform(-2, 2, 3)
        lines.append(f"{i + 1} {' '.join(map(str, q))} "
                     f"{' '.join(map(str, t))} 1 im{3 - i}.png")
        lines.append("1.0 2.0 -1")
    (sparse / "images.txt").write_text("\n".join(lines) + "\n")
    ours = colmap2nerf.convert(sparse, "imgs", tmp_path / "t.json", 8)
    theirs = jcolmap.convert(sparse, "imgs", tmp_path / "j.json", 8)
    _json_close(ours, theirs)
    _json_close(json.loads((tmp_path / "t.json").read_text()),
                json.loads((tmp_path / "j.json").read_text()))
    assert [f["file_path"] for f in ours["frames"]][0] == "imgs/im0.png"


def test_llff2nerf_matches(tmp_path):
    rng = np.random.default_rng(11)
    P = 3
    poses = np.zeros((P, 3, 5))
    poses[:, :, :4] = rng.normal(size=(P, 3, 4))
    poses[:, :, 4] = [120, 160, 100.5]
    pb = np.concatenate([poses.reshape(P, 15), rng.uniform(1, 5, (P, 2))],
                        -1)
    np.save(tmp_path / "poses_bounds.npy", pb)
    (tmp_path / "images").mkdir()
    for i, ext in enumerate(("png", "jpg", "JPG")):
        Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(
            tmp_path / "images" / f"{i:03d}.{ext}")
    ours = llff2nerf.convert(tmp_path, "t.json")
    theirs = jllff.convert(tmp_path, "j.json")
    _json_close(ours, theirs)
    _json_close(json.loads((tmp_path / "t.json").read_text()),
                json.loads((tmp_path / "j.json").read_text()))
    assert len(ours["frames"]) == P


def test_optics_match():
    rng = np.random.default_rng(5)
    n = rng.normal(size=(257, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    l = rng.normal(size=(257, 3))
    l /= np.linalg.norm(l, axis=-1, keepdims=True)
    p = rng.uniform(0, 1, 257)
    n, l, p = (x.astype(np.float32) for x in (n, l, p))
    tn, tl, tp = (torch.from_numpy(x) for x in (n, l, p))
    jn, jl, jp = (jnp.asarray(x) for x in (n, l, p))
    for r in (1.5, 1 / 1.5):
        o = toptics.snells_law(r, tn, tl)
        jo = joptics.snells_law(r, jn, jl)
        close(o.numpy(), jo, 1e-6, "snells_law")
        close(toptics.fresnel_law(1.0, 1.5, tn, tl, o).numpy(),
              joptics.fresnel_law(1.0, 1.5, jn, jl, jo), 1e-6,
              "fresnel_law")
    close(toptics.refract_reflect(1.0, 1.33, tn, tl, tp).numpy(),
          joptics.refract_reflect(1.0, 1.33, jn, jl, jp), 1e-6,
          "refract_reflect")


@pytest.mark.parametrize("out_res,sigma", [(20, 0.3), (100, "per_ray")])
def test_learnable_spherical_encoding_matches(out_res, sigma):
    """Outputs and the gradients of the weights and of the directions, the
    lattice at both of its offsets' sizes, sigma a scalar or a column."""
    jenc = jrm.init_learnable_spherical_encoding(jax.random.PRNGKey(3), 5,
                                                 out_res)
    tenc = weights.from_jax_state_dict(
        trm.init_learnable_spherical_encoding(5, out_res),
        jckpt.state_dict(jenc))
    np.testing.assert_allclose(tenc.sphere_pos.numpy(), jenc.sphere_pos,
                               rtol=0, atol=1e-7)
    rng = np.random.default_rng(out_res)
    v = rng.normal(size=(33, 3))
    v = (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)
    s = (rng.uniform(0.1, 0.5, (33, 1)).astype(np.float32)
         if sigma == "per_ray" else sigma)
    cot = rng.normal(size=(33, 5)).astype(np.float32)
    # within ~0.1 rad of a lattice point the direction's gradient goes
    # through arccos near 1, where float32's arccos and its slope round
    # differently in the two libraries: those rows are held to 1e-3
    near = np.arccos(np.clip(v @ np.asarray(jenc.sphere_pos), -1, 1)).min(
        1) < 0.1

    def jloss(enc, vec):
        return (enc(vec, s if sigma != "per_ray" else jnp.asarray(s))
                * cot).sum()

    jval = jenc(jnp.asarray(v), s)
    jg_enc, jg_v = jax.grad(jloss, argnums=(0, 1))(jenc, jnp.asarray(v))
    tv = torch.from_numpy(v).requires_grad_(True)
    ts = torch.from_numpy(s) if sigma == "per_ray" else s
    out = tenc(tv, ts)
    (out * torch.from_numpy(cot)).sum().backward()
    close(out.detach().numpy(), jval, 1e-5, "output")
    close(tenc.weights.grad.numpy(), jg_enc.weights, 1e-5, "weights grad")
    scale = np.abs(np.asarray(jg_v)).max()
    close(tv.grad.numpy()[~near], np.asarray(jg_v)[~near], 1e-5,
          "direction grad", scale=scale)
    close(tv.grad.numpy()[near], np.asarray(jg_v)[near], 1e-3,
          "direction grad near a lattice point", scale=scale)


@pytest.mark.parametrize("upper,lower,N", [
    ((0.5,), (1.5,), 20), ((1.0, -2.0), (2.5,), 12), ((), (), 8)])
def test_lhypergeom_matches(upper, lower, N):
    x = np.linspace(-0.9, 0.9, 41).astype(np.float32)
    ours = tish.LHyperGeom(upper, lower, N)(torch.from_numpy(x)).numpy()
    theirs = jish.LHyperGeom(upper=upper, lower=lower, N=N)(jnp.asarray(x))
    close(ours, theirs, 1e-5, "series")


def test_collect_env_on_the_cpu():
    info = collect_env.collect()
    assert info["torch"] == torch.__version__
    assert "cuda.is_available" in info and "nvcc" in info
    rc, out = _stdout(collect_env.main)
    assert rc is None and out.startswith("python: ")
