"""nmf_tpu_torch's data layer against nmf_tpu's: EXR read and write both
ways, image reads, the OpenCV-equivalent resizes, the Blender and
own-data loaders on tiny scenes written to a temporary folder, and the
studio scene written in nerf_synthetic layout."""
import json
import struct
import zlib

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
imageio = pytest.importorskip("imageio.v2")

from nmf_tpu.data import blender as jblender  # noqa: E402
from nmf_tpu.data import exr as jexr  # noqa: E402
from nmf_tpu_torch import config as tconfig  # noqa: E402
from nmf_tpu_torch.data import exr as texr  # noqa: E402
from nmf_tpu_torch.data import load_dataset as tload  # noqa: E402
from nmf_tpu_torch.data.blender import save_blender_split  # noqa: E402
from nmf_tpu_torch.data.resize import resize_area, resize_linear  # noqa: E402
from nmf_tpu_torch.data.synthetic import make_shiny_dataset  # noqa: E402


@pytest.fixture(autouse=True)
def _no_dataset_cache(monkeypatch):
    """Both packages read NMF_DATASET_CACHE; empty turns their scene memo
    off, so no test writes into the checkout or reads a stale file."""
    monkeypatch.setenv("NMF_DATASET_CACHE", "")


def _hdr(rng, shape):
    """Values from 0 to ~40, a third of them above 1, a few exact zeros."""
    x = rng.gamma(0.6, 1.5, shape).astype(np.float32)
    x.flat[::17] = 0.0
    return x


# ---- EXR -----------------------------------------------------------------

@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("compression", ["none", "zips", "zip"])
@pytest.mark.parametrize("pixel_type", ["half", "float"])
def test_exr_both_ways(tmp_path, pixel_type, compression, channels):
    """The port writes, both read the same arrays bit for bit; for FLOAT
    (the only type nmf_tpu writes) nmf_tpu writes the same bytes and the
    port reads its file back. 37 rows: ZIP's last 16-line chunk is
    partial."""
    rng = np.random.default_rng(channels)
    img = _hdr(rng, (37, 13, channels))
    path = tmp_path / "port.exr"
    texr.write_exr(path, img, compression=compression, pixel_type=pixel_type)
    ours, theirs = texr.read_exr(path), jexr.read_exr(path)
    np.testing.assert_array_equal(ours.view(np.uint32),
                                  theirs.view(np.uint32))
    stored = (img.astype(np.float16) if pixel_type == "half" else img)
    np.testing.assert_array_equal(ours, stored.astype(np.float32))
    if pixel_type == "float":
        jpath = tmp_path / "jax.exr"
        jexr.write_exr(jpath, img, compression=compression)
        assert jpath.read_bytes() == path.read_bytes()
        np.testing.assert_array_equal(texr.read_exr(jpath).view(np.uint32),
                                      jexr.read_exr(jpath).view(np.uint32))


def _patch_header(path, name, typ, new_data):
    """Rewrite attribute ``name`` of an EXR header in place (same size)."""
    raw = bytearray(path.read_bytes())
    key = name.encode() + b"\0" + typ.encode() + b"\0"
    i = raw.index(key) + len(key)
    size = struct.unpack("<i", raw[i:i + 4])[0]
    assert len(new_data(bytes(raw[i + 4:i + 4 + size]))) == size
    raw[i + 4:i + 4 + size] = new_data(bytes(raw[i + 4:i + 4 + size]))
    path.write_bytes(bytes(raw))


@pytest.mark.parametrize("comp,name", [(4, "PIZ"), (6, "B44"), (8, "DWAA")])
def test_exr_unsupported_compression_raises(tmp_path, comp, name):
    path = tmp_path / "p.exr"
    texr.write_exr(path, np.ones((4, 5, 3), np.float32), compression="none")
    _patch_header(path, "compression", "compression", lambda _: bytes([comp]))
    with pytest.raises(ValueError, match=name):
        texr.read_exr(path)
    with pytest.raises(ValueError, match=name):
        texr.imread_any(path)


def test_exr_uint_channels_read_as_nmf_tpu_reads_them(tmp_path):
    """A file whose channels say UINT: both readers take the same 32-bit
    words as unsigned integers."""
    path = tmp_path / "u.exr"
    texr.write_exr(path, _hdr(np.random.default_rng(5), (6, 7, 3)),
                   compression="none")

    def to_uint(chl):
        out, i = bytearray(chl), 0
        while out[i] != 0:
            j = out.index(0, i)
            out[j + 1:j + 5] = struct.pack("<i", 0)
            i = j + 17
        return bytes(out)

    _patch_header(path, "channels", "chlist", to_uint)
    ours, theirs = texr.read_exr(path), jexr.read_exr(path)
    np.testing.assert_array_equal(ours, theirs)
    assert ours.max() > 1e6  # float bit patterns read as integers


# ---- image reads ---------------------------------------------------------

@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "I;16"])
def test_imread_png_matches(tmp_path, mode):
    rng = np.random.default_rng(3)
    shape = {"L": (9, 11), "RGB": (9, 11, 3), "RGBA": (9, 11, 4),
             "I;16": (9, 11)}[mode]
    top, dtype = (65536, np.uint16) if mode == "I;16" else (256, np.uint8)
    arr = rng.integers(0, top, shape).astype(dtype)
    path = tmp_path / "im.png"
    imageio.imwrite(path, arr)
    ours = texr.imread_any(path)
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours, jexr.imread_any(path))
    np.testing.assert_array_equal(ours, jblender._imread(path))


def _png16_rgb(path, arr):
    """A 16-bit RGB PNG (which neither imageio nor PIL writes)."""
    H, W, _ = arr.shape
    raw = b"".join(b"\0" + arr[y].astype(">u2").tobytes() for y in range(H))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 16, 2,
                                                  0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(raw))
                     + chunk(b"IEND", b""))


def test_imread_refuses_what_pil_would_narrow(tmp_path):
    from PIL import Image

    path = tmp_path / "rgb16.png"
    _png16_rgb(path, np.full((3, 4, 3), 40000, np.uint16))
    with pytest.raises(ValueError, match="16-bit"):
        texr.imread_any(path)
    pal = tmp_path / "pal.png"
    Image.new("P", (4, 3)).save(pal)
    with pytest.raises(ValueError, match="'P'"):
        texr.imread_any(pal)


def test_write_png_rgba_reads_back(tmp_path):
    rgba = np.random.default_rng(1).integers(0, 256, (5, 6, 4)).astype(
        np.uint8)
    texr.write_png(tmp_path / "a.png", rgba)
    np.testing.assert_array_equal(imageio.imread(tmp_path / "a.png"), rgba)


# ---- resize --------------------------------------------------------------

@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("factor", [2, 3, 4, 1.5])
def test_resize_matches_cv2(factor, channels):
    """INTER_AREA and INTER_LINEAR on HDR float32 images, shrinking by the
    factor and growing by it, against cv2 (with its IPP path, as
    installed)."""
    rng = np.random.default_rng(int(factor * 10) + channels)
    img = _hdr(rng, (48, 60, channels))
    small = (int(60 / factor), int(48 / factor))
    big = (int(60 * factor), int(48 * factor))
    for wh in (small, big):
        for ours, interp in ((resize_area, cv2.INTER_AREA),
                             (resize_linear, cv2.INTER_LINEAR)):
            ref = cv2.resize(img, wh, interpolation=interp)
            got = ours(img, wh)
            assert got.shape == ref.shape and got.dtype == ref.dtype
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{ours.__name__} {wh}")


def test_resize_lego_sizes_and_envmap_size():
    """The loader's 800 -> 266 (downsample 3) and the envmap metrics'
    panorama to 500 x 1000."""
    rng = np.random.default_rng(9)
    img = _hdr(rng, (800, 800, 4))
    np.testing.assert_allclose(
        resize_area(img, (266, 266)),
        cv2.resize(img, (266, 266), interpolation=cv2.INTER_AREA),
        rtol=1e-5, atol=1e-6)
    pano = _hdr(rng, (128, 256, 3))
    np.testing.assert_allclose(resize_linear(pano, (1000, 500)),
                               cv2.resize(pano, (1000, 500)),
                               rtol=1e-5, atol=1e-6)


# ---- loaders -------------------------------------------------------------

H0, W0, N_VIEWS = 24, 30, 4


def _c2w(rng):
    """A Blender-convention camera-to-world matrix looking at the origin."""
    from nmf_tpu_torch.data.ray_utils import pose_spherical

    return pose_spherical(rng.uniform(0, 360), rng.uniform(-60, -10), 4.0)


def _write_scene(root, channels=4, camera="angle", path_style="bare",
                 ext=".png", extra=None, normals=False, own=False):
    """A tiny scene of N_VIEWS views of H0 x W0 in both splits."""
    rng = np.random.default_rng(7)
    for split in ("train", "test"):
        (root / split).mkdir(parents=True, exist_ok=True)
        meta = {"w": W0, "h": H0, "frames": [], **(extra or {})}
        if ext != ".png":
            meta["ext"] = ext
        if camera == "angle":
            meta["camera_angle_x"] = 0.69
        else:
            meta["fl_x"], meta["fl_y"] = 41.5, 39.0
        if own:
            meta.update(camera_angle_y=0.61, cx=14.2, cy=12.9)
        for i in range(N_VIEWS):
            name = f"{split}/r_{i}"
            fp = {"bare": name, "dot": f"./{name}",
                  "ext": f"./{name}{ext}"}[path_style]
            meta["frames"].append({"file_path": fp,
                                   "transform_matrix": _c2w(rng).tolist()})
            shape = (H0, W0) if channels == 1 else (H0, W0, channels)
            if ext == ".exr":
                texr.write_exr(root / f"{name}.exr",
                               _hdr(rng, (H0, W0, channels)))
            else:
                imageio.imwrite(root / f"{name}.png",
                                rng.integers(0, 256, shape).astype(np.uint8))
            if normals:
                for kind in ("normal", "tint"):
                    imageio.imwrite(
                        root / f"{split}/{kind}_{i}.png",
                        rng.integers(0, 256, (H0, W0, 3)).astype(np.uint8))
        (root / f"transforms_{split}.json").write_text(json.dumps(meta))


def _assert_same(ours, theirs, tol):
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        if isinstance(v, np.ndarray):
            assert ours[k].shape == v.shape and ours[k].dtype == v.dtype, k
            np.testing.assert_allclose(ours[k], v, rtol=tol, atol=tol,
                                       err_msg=k)
        elif isinstance(v, float):
            assert ours[k] == pytest.approx(v, rel=1e-12), k
        else:
            assert ours[k] == v, k


LOADER_CASES = {
    "rgba, camera_angle_x": {},
    "rgb, fl_x / fl_y": dict(channels=3, camera="focal"),
    "grey, ./ prefix": dict(channels=1, path_style="dot"),
    "extension in file_path": dict(path_style="ext"),
    "exr frames": dict(channels=3, ext=".exr"),
    "json aabb_scale, near_far, white_bg": dict(
        extra={"aabb_scale": 1.7, "near_far": [1.5, 7.25],
               "white_bg": False}),
    "stack_norms": dict(normals=True, cfg={"stack_norms": True}),
    "downsample 2": dict(normals=True, cfg={"stack_norms": True,
                                            "downsample_train": 2}),
    "downsample 3": dict(channels=3, cfg={"downsample_train": 3}),
    "n_vis": dict(n_vis=2),
    "own_data": dict(own=True, cfg={"dataset_name": "own_data"}),
    "own_data, rgba, downsample 2": dict(
        own=True, cfg={"dataset_name": "own_data", "downsample_train": 2}),
}


@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_loader_matches(tmp_path, case):
    """load_dataset of both packages on the same folder, both splits:
    every key, arrays within 1e-6 (1e-5 where the images are resized)."""
    kw = dict(LOADER_CASES[case])
    cfg = {"dataset_name": "blender", "scenedir": "scene",
           **kw.pop("cfg", {})}
    n_vis = kw.pop("n_vis", -1)
    _write_scene(tmp_path / "scene", **kw)
    tol = 1e-5 if cfg.get("downsample_train", 1) != 1 else 1e-6
    for split in ("train", "test"):
        ours = tload(cfg, str(tmp_path), split, n_vis=n_vis)
        theirs = jblender.load_dataset(cfg, str(tmp_path), split,
                                       n_vis=n_vis)
        _assert_same(ours, theirs, tol)
    if cfg.get("downsample_train") == 3:
        assert ours["img_wh"] == (10, 8)
    if n_vis > 0:
        assert ours["poses"].shape[0] == 2


@pytest.mark.parametrize("name", ["nsvf", "tankstemple"])
def test_unported_loaders_raise(name):
    """The NSVF and Tanks and Temples loaders are ported (their parity
    tests: test_torch_a4.py); a scene folder that does not exist raises
    in the port as in nmf_tpu."""
    cfg = {"dataset_name": name, "scenedir": "x"}
    with pytest.raises(OSError):
        jblender.load_dataset(cfg, "/nonexistent")
    with pytest.raises(OSError):
        tload(cfg, "/nonexistent")


def test_studio_scene_in_nerf_synthetic_layout_loads_back(tmp_path):
    """The studio generator's views written as a nerf_synthetic folder and
    loaded with dataset=lego: the rays within 1e-5 of the generator's,
    RGBA within half of 1/255, the normals within 1/255 (8 bits of
    (n + 1) / 2), the tints within half of 1/255; nmf_tpu's loader reads
    the same arrays."""
    cfg = tconfig.compose(["dataset=lego", f"datadir={tmp_path}",
                           "dataset.near_far=[1.4,5.0]",
                           "dataset.stack_norms=true"])
    for split in ("train", "test"):
        ds = make_shiny_dataset(n_views=2, H=16, W=16, n_gi_samples=4,
                                scene="studio", hemisphere=True, split=split)
        n = ds["poses"].shape[0]

        def views(key, c):
            return ds[key].reshape(n, 16, 16, c)

        save_blender_split(tmp_path / cfg["dataset"]["scenedir"], split,
                           ds["poses"], views("all_rgbs", 4),
                           np.deg2rad(55.0), views("all_norms", 3),
                           views("all_tints", 3))
        ours = tload(cfg["dataset"], str(tmp_path), split)
        np.testing.assert_allclose(ours["all_rays"], ds["all_rays"],
                                   rtol=0, atol=1e-5)
        for key, tol in (("all_rgbs", 0.5), ("all_norms", 1.0),
                         ("all_tints", 0.5)):
            np.testing.assert_allclose(
                ours[key], np.clip(ds[key], -1 if key == "all_norms" else 0,
                                   1),
                rtol=0, atol=tol / 255 + 1e-6, err_msg=key)
        assert ours["near_far"] == (1.4, 5.0)
        assert ours["img_wh"] == ds["img_wh"]
        _assert_same(ours, jblender.load_dataset(cfg["dataset"],
                                                 str(tmp_path), split), 0)
