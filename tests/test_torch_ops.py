"""nmf_tpu_torch numeric ops against their nmf_tpu counterparts: safemath,
tonemap, distortion loss, masked ops, grid sampling, pooling, resizing,
metrics, the lr schedule, config composition and the dataset."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nmf_tpu import config as jconfig  # noqa: E402
from nmf_tpu import trainer as jtrainer  # noqa: E402
from nmf_tpu import utils as jutils  # noqa: E402
from nmf_tpu.data.blender import load_dataset as jload  # noqa: E402
from nmf_tpu.ops import grid_sample as jgs  # noqa: E402
from nmf_tpu.ops import losses as jlosses  # noqa: E402
from nmf_tpu.ops import masked as jmasked  # noqa: E402
from nmf_tpu.ops import safemath as jsafe  # noqa: E402
from nmf_tpu.ops import tonemap as jtonemap  # noqa: E402
from nmf_tpu_torch import config as tconfig  # noqa: E402
from nmf_tpu_torch import trainer as ttrainer  # noqa: E402
from nmf_tpu_torch import utils as tutils  # noqa: E402
from nmf_tpu_torch.data import load_dataset as tload  # noqa: E402
from nmf_tpu_torch.ops import grid_sample as tgs  # noqa: E402
from nmf_tpu_torch.ops import losses as tlosses  # noqa: E402
from nmf_tpu_torch.ops import masked as tmasked  # noqa: E402
from nmf_tpu_torch.ops import safemath as tsafe  # noqa: E402
from nmf_tpu_torch.ops import tonemap as ttonemap  # noqa: E402

# elementwise f32 math in both frameworks: agreement to a few ulps
RTOL, ATOL = 1e-5, 1e-6


def _rng(seed=0):
    return np.random.default_rng(seed)


def _grad_pair(jfn, tfn, *arrays, cot=None):
    """Values and input gradients of sum(fn(*x) * cot) in both frameworks."""
    jout = jfn(*map(jnp.asarray, arrays))
    cot = np.ones(np.shape(jout), np.float32) if cot is None else cot
    jg = jax.grad(lambda *a: (jfn(*a) * cot).sum(),
                  argnums=tuple(range(len(arrays))))(*map(jnp.asarray, arrays))
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    tout = tfn(*ts)
    (tout * torch.from_numpy(cot)).sum().backward()
    return (np.asarray(jout), tout.detach().numpy(),
            [np.asarray(g) for g in jg], [t.grad.numpy() for t in ts])


def _assert_pair(jout, tout, jg, tg, rtol=RTOL, atol=ATOL, grtol=1e-5,
                 gatol=1e-6):
    np.testing.assert_allclose(tout, jout, rtol=rtol, atol=atol)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=grtol, atol=gatol)


def test_normalize():
    v = _rng().normal(size=(50, 3)).astype(np.float32)
    _assert_pair(*_grad_pair(jsafe.normalize, tsafe.normalize, v))


@pytest.mark.parametrize("freqs", [1, 6])
def test_positional_encoding(freqs):
    x = _rng(1).uniform(-1, 1, (40, 5)).astype(np.float32)
    # sin/cos of 2^5 * x: rounding of the argument grows with the frequency
    _assert_pair(*_grad_pair(lambda a: jsafe.positional_encoding(a, freqs),
                             lambda a: tsafe.positional_encoding(a, freqs),
                             x), atol=1e-5, gatol=1e-4)


@pytest.mark.parametrize("noclip", [False, True])
def test_srgb_tonemap(noclip):
    x = _rng(2).uniform(-0.1, 1.5, (64, 3)).astype(np.float32)
    jfn, tfn = jtonemap.get_tonemap("srgb")[0], ttonemap.get_tonemap("srgb")
    assert ttonemap.get_tonemap("filmic") is tfn
    _assert_pair(*_grad_pair(lambda a: jfn(a, noclip=noclip),
                             lambda a: tfn(a, noclip=noclip), x), grtol=1e-4)


def test_distortion_loss():
    rng = _rng(3)
    z = np.sort(rng.uniform(2, 6, (16, 20)), -1).astype(np.float32)
    w = rng.uniform(0, 0.2, (16, 20)).astype(np.float32)
    dt = rng.uniform(0, 0.1, (16, 20)).astype(np.float32)
    _assert_pair(*_grad_pair(jlosses.distortion_loss, tlosses.distortion_loss,
                             z, w, dt), grtol=1e-4)


def test_raw2alpha():
    rng = _rng(4)
    sigma = rng.uniform(0, 40, (12, 30)).astype(np.float32)
    dist = rng.uniform(0, 0.3, (12, 30)).astype(np.float32)
    for pick in (0, 1):
        _assert_pair(*_grad_pair(lambda s, d: jmasked.raw2alpha(s, d)[pick],
                                 lambda s, d: tmasked.raw2alpha(s, d)[pick],
                                 sigma, dist), grtol=1e-4, gatol=1e-5)


def test_row_mask_sum():
    rng = _rng(5)
    v = rng.normal(size=(6, 9, 3)).astype(np.float32)
    m = rng.uniform(size=(6, 9)) > 0.4
    np.testing.assert_allclose(
        tmasked.row_mask_sum(torch.from_numpy(v), torch.from_numpy(m)).numpy(),
        np.asarray(jmasked.row_mask_sum(jnp.asarray(v), jnp.asarray(m))),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k", [4, 11, 20])
def test_compact_topk_and_gather_rows(k):
    rng = _rng(6)
    valid = rng.uniform(size=(10, 20)) > 0.6
    x = rng.normal(size=(10, 20, 3)).astype(np.float32)
    jidx, jkeep = jmasked.compact_topk(jnp.asarray(valid), k)
    tidx, tkeep = tmasked.compact_topk(torch.from_numpy(valid), k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(
        tmasked.gather_rows(torch.from_numpy(x), tidx).numpy(),
        np.asarray(jmasked.gather_rows(jnp.asarray(x), jidx)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("gather", ["quad_gather_2d", "line_interp"])
def test_take_rows_hands_binsum_the_cotangent_in_its_dtype(monkeypatch,
                                                           gather, dtype):
    # TakeRows.backward passes the cotangent to binsum_rows as it comes (no
    # f32 copy of bf16 rows) and returns the f32 sum cast to the table's
    # dtype: equal, bit for bit, to casting the f32 sum of the widened rows
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    seen = []

    def spy(idx, vals, num_rows):
        seen.append((vals.dtype, vals.is_contiguous()))
        return tmasked.binsum_rows(idx, vals, num_rows)

    monkeypatch.setattr(tgs, "binsum_rows", spy)
    rng = _rng(12)
    if gather == "quad_gather_2d":
        table = rng.normal(size=(6, 9, 11)).astype(np.float32)
        coords = rng.uniform(-1.05, 1.05, (200, 2)).astype(np.float32)
    else:
        table = rng.normal(size=(6, 13)).astype(np.float32)
        coords = rng.uniform(-1.05, 1.05, (200,)).astype(np.float32)
    t = torch.tensor(table).to(td).requires_grad_(True)
    rows = getattr(tgs, gather)(t, torch.from_numpy(coords))
    (rows * torch.from_numpy(rng.normal(size=rows.shape).astype(
        np.float32))).sum().backward()
    assert seen == [(td, True)]
    assert t.grad.dtype == td

    idx = torch.from_numpy(rng.integers(0, 20, 300).astype(np.int32))
    g = torch.from_numpy(rng.normal(size=(300, 5)).astype(np.float32)).to(td)
    ctx = type("Ctx", (), {"saved_tensors": (idx,), "num_rows": 20})
    d, _ = tgs.TakeRows.backward(ctx, g)
    assert torch.equal(d, tmasked.binsum_rows(idx, g.float(), 20).to(td))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_line_interp_matches_line_interp_matmul(dtype):
    # f32: the same two products per sample (tight). bf16: the line and the
    # 2-hot weights are rounded to bf16 in both, products accumulate in
    # f32; the gradients are rounded to bf16 at other places (rtol 2e-2,
    # a few bf16 ulps; the coordinate gradients reach ~2e2, where one bf16
    # ulp is 1, hence atol 1)
    rng = _rng(7)
    line = rng.normal(size=(24, 37)).astype(np.float32)
    coords = rng.uniform(-1.05, 1.05, (300,)).astype(np.float32)
    g = rng.normal(size=(300, 24)).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    out = _grad_pair(lambda l, c: jgs.line_interp_matmul(l.astype(jd), c),
                     lambda l, c: tgs.line_interp(l.to(td), c),
                     line, coords, cot=g)
    if dtype == "f32":
        _assert_pair(*out, grtol=1e-4, gatol=1e-4)
    else:
        _assert_pair(*out, rtol=1e-5, atol=1e-5, grtol=2e-2, gatol=1.0)


def test_grid_sample_1d_2d_3d():
    rng = _rng(8)
    line = rng.normal(size=(4, 13)).astype(np.float32)
    plane = rng.normal(size=(5, 9, 11)).astype(np.float32)
    vol = rng.normal(size=(3, 6, 7, 8)).astype(np.float32)
    c1 = rng.uniform(-1.2, 1.2, (50,)).astype(np.float32)
    c2 = rng.uniform(-1.2, 1.2, (50, 2)).astype(np.float32)
    c3 = rng.uniform(-1.2, 1.2, (50, 3)).astype(np.float32)
    for jfn, tfn, a, c in ((jgs.grid_sample_1d, tgs.grid_sample_1d, line, c1),
                           (jgs.grid_sample_2d, tgs.grid_sample_2d, plane, c2),
                           (jgs.grid_sample_3d, tgs.grid_sample_3d, vol, c3)):
        _assert_pair(*_grad_pair(jfn, tfn, a, c), grtol=1e-4, gatol=1e-4)


@pytest.mark.parametrize("ks", [3, 5])
def test_max_pool_3d(ks):
    vol = _rng(9).uniform(size=(7, 8, 9)).astype(np.float32)
    np.testing.assert_array_equal(
        tgs.max_pool_3d(torch.from_numpy(vol), ks).numpy(),
        np.asarray(jgs.max_pool_3d(jnp.asarray(vol), ks)))


def test_resize_align_corners():
    rng = _rng(10)
    plane = rng.normal(size=(4, 8, 8)).astype(np.float32)
    line = rng.normal(size=(4, 8)).astype(np.float32)
    np.testing.assert_allclose(
        tgs.resize_align_corners_2d(torch.from_numpy(plane), (13, 11)).numpy(),
        np.asarray(jgs.resize_align_corners_2d(jnp.asarray(plane), (13, 11))),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        tgs.resize_align_corners_1d(torch.from_numpy(line), 19).numpy(),
        np.asarray(jgs.resize_align_corners_1d(jnp.asarray(line), 19)),
        rtol=RTOL, atol=ATOL)


def test_metrics_and_resolution():
    rng = _rng(11)
    a = rng.uniform(size=(24, 20, 3)).astype(np.float32)
    b = np.clip(a + 0.05 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    assert tutils.rgb_psnr(a, b) == jutils.rgb_psnr(a, b)
    # the port filters in f64, nmf_tpu's scipy path in f32
    assert abs(tutils.rgb_ssim(a, b) - jutils.rgb_ssim(a, b)) < 1e-6
    aabb = np.array([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]])
    for n in (4096, 128 ** 3, 300 ** 3, 1000):
        assert tutils.n_to_reso(n, aabb) == jutils.n_to_reso(n, aabb)


def test_lr_decay_schedule():
    js = jtrainer.lr_decay_schedule(1.0, 1e-3, 300, 100, 0.1)
    ts = ttrainer.lr_decay_schedule(1.0, 1e-3, 300, 100, 0.1)
    for c in (0, 1, 50, 99, 100, 150, 299, 300, 400):
        np.testing.assert_allclose(ts(c), float(js(c)), rtol=1e-6)


@pytest.mark.parametrize("overrides", [
    [],
    ["model=tensorf", "dataset=synthetic_sphere",
     "model.params.n_iters=300", "field.upsamp_list=[150]",
     "model.arch.sampler.update_list=[100,200]"],
    ["model=microfacet_tensorf2", "params=quality", "expname=x",
     "model.arch.model.anoise=0.5"],
])
def test_config_compose_matches(overrides):
    assert tconfig.compose(overrides) == jconfig.compose(overrides)


def test_load_dataset_matches():
    cfg = {"dataset_name": "synthetic_sphere", "n_views": 3,
           "image_size": 8, "near_far": [2.5, 5.5], "scenedir": "s"}
    for split in ("train", "test"):
        a, b = tload(cfg, None, split), jload(cfg, None, split)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    # the file loaders are held in their own tests (test_torch_data.py,
    # test_torch_llff.py, test_torch_a4.py); without a datadir nsvf
    # fails in both packages alike
    cfg = {"dataset_name": "nsvf", "scenedir": "x"}
    with pytest.raises(TypeError):
        jload(cfg, None)
    with pytest.raises(TypeError):
        tload(cfg, None)
