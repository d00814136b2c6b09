"""The measurement scripts of nmf_tpu_torch/scripts against nmf_tpu's on
the CPU, at small sizes (the card's runs are ``chip_smoke.py``'s bench
path): bench_scatter's chunk-combine and sorted scatters and its id
generator, bench_gather's two layouts, bench_shade's flagship and stub
shade, bisect_shade's stages, parse_trace and ``profile_step.timeit``.

Tolerances: the scatters 1e-5 in f32; the gathers 1e-5 forward and 1e-4
for the gradients in f32, 3e-2 with bf16 tables (of the largest entry);
the stub shade and the staged shades 1e-5 (the envmap's mip bias raised to
12, as tests/test_torch_flagship.py does, so every lookup's box spans the
map); bisect stage 0 equals ``Microfacet.shade`` exactly.
"""
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
from nmf_tpu import ckpt as jckpt  # noqa: E402
from nmf_tpu import config as jconfig  # noqa: E402
from nmf_tpu.scripts import bench_scatter as jscatter  # noqa: E402
from nmf_tpu.scripts import bisect_shade as jbisect  # noqa: E402
from nmf_tpu.scripts import parse_xplane  # noqa: E402
from nmf_tpu_torch import config as tconfig  # noqa: E402
from nmf_tpu_torch import weights  # noqa: E402
from nmf_tpu_torch.models.microfacet import Microfacet  # noqa: E402
from nmf_tpu_torch.ops.draws import Draws  # noqa: E402
from nmf_tpu_torch.render import reflection_fn  # noqa: E402
from nmf_tpu_torch.scripts import (bench_gather, bench_scatter,  # noqa: E402
                                   bench_shade, bisect_shade, parse_trace,
                                   profile_step)
from torch_parity import close, jax_reflection, shade_draws  # noqa: E402

# the tiny flagship of the bench tests (grid 16, envmap 16 x 32, budgets
# (512, 128), 32 retrace rays)
TINY = {"grid": 16, "bg_res": 16, "k_spr": 16, "recur_k": 8,
        "brdf_budget": (512, 128), "retrace": 32}
MIPBIAS = 12.0
M_SHADE = 512  # nmf_tpu's stage 5 reads the first budget (512) samples


def no_timer(fn, *args, **kw):
    fn(*args)
    return 0.0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny shapes run fastest on one thread, and the test workers
    share the CPU cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------- scatter
def _ids(rng, M, T, dist):
    if dist == "uniform":
        return rng.integers(0, T, M)
    return np.where(rng.uniform(size=M) < 0.9, rng.integers(0, 64, M),
                    rng.integers(0, T, M))


@pytest.mark.parametrize("dist", ["uniform", "hot"])
def test_scatters_match_nmf_tpu(dist):
    """The chunk-combine scatter against nmf_tpu's ``_chunk_combine_
    scatter`` (M = 1,024, T = 64, D = 8: 8 chunks of 128), and sort +
    ``index_add_`` against nmf_tpu's sorted ``.at[].add``
    (``nmf_tpu/scripts/bench_scatter.py:93-122, 136-142``), f32."""
    rng = np.random.default_rng({"uniform": 0, "hot": 1}[dist])
    M, T, D = 1024, 64, 8
    idx = _ids(rng, M, T, dist).astype(np.int32)
    g = rng.normal(size=(M, D)).astype(np.float32)
    ji, jg = jnp.asarray(idx), jnp.asarray(g)
    jcc = np.asarray(jscatter._chunk_combine_scatter(ji, jg, T))
    order = jnp.argsort(ji)
    jsorted = np.asarray(jnp.zeros((T, D)).at[ji[order]].add(
        jg[order], indices_are_sorted=True))
    variants = bench_scatter.scatter_variants(torch.from_numpy(idx),
                                              torch.from_numpy(g), T)
    close(variants["chunk-combine scatter"]().numpy(), jcc, 1e-5,
          "chunk-combine")
    close(variants["sort + index_add_"]().numpy(), jsorted, 1e-5, "sorted")
    close(variants["plain index_add_"]().numpy(), jsorted, 1e-5, "plain")


def test_hot_ids_and_the_binsum_line():
    """``make_ids``' hot ids put 90% of the updates on the first 64 rows;
    bench_binsum's K3 line (the plain version on the CPU) agrees with
    ``zeros + index_add_``."""
    gen = torch.Generator().manual_seed(0)
    M, T = 200_000, 691_456
    hot = bench_scatter.make_ids(gen, M, T, "hot")
    uniform = bench_scatter.make_ids(gen, M, T, "uniform")
    assert hot.dtype == torch.int32 and hot.shape == (M,)
    assert int(hot.min()) >= 0 and int(hot.max()) < T
    share = float((hot < 64).float().mean())
    assert abs(share - (0.9 + 0.1 * 64 / T)) < 0.005
    assert torch.unique(hot[hot < 64]).numel() == 64
    assert float((uniform < 64).float().mean()) < 0.001
    rows = bench_scatter.bench_binsum(
        gen, cases=((4096, 300, 16, "hot"), (4096, 300, 16, "uniform")),
        timer=no_timer)
    assert [r["rel_err"] for r in rows] == [0.0, 0.0]


def test_alpha_variants_read_the_scalar_gather():
    rows = bench_scatter.bench_alpha(torch.Generator().manual_seed(0),
                                     M=2048, grids=(32, 8), timer=no_timer)
    assert {r["variant"] for r in rows if r["G"] == 32} == {
        "scalar f32 gather", "scalar int8 gather", "row+lane f32",
        "row+lane int8", "one-hot matmul bf16"}


# ----------------------------------------------------------------- gather
def _jax_gs(plane, coords, rows, dtype):
    """nmf_tpu's ``gs_cols`` / ``gs_rows`` (``nmf_tpu/scripts/
    bench_gather.py:53-86``; closures of its ``main``), with the table
    dtype a parameter."""
    C, H, W = plane.shape
    x = (coords[..., 0] + 1.0) * 0.5 * (W - 1)
    y = (coords[..., 1] + 1.0) * 0.5 * (H - 1)
    x0, y0 = jnp.floor(x), jnp.floor(y)
    wx, wy = x - x0, y - y0
    ix0, iy0 = x0.astype(jnp.int32), y0.astype(jnp.int32)
    flat = plane.reshape(C, H * W)
    flat = (flat.T if rows else flat).astype(dtype)
    out = 0.0
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        ix, iy = ix0 + dx, iy0 + dy
        w = (wx if dx else (1 - wx)) * (wy if dy else (1 - wy))
        valid = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
        idx = jnp.clip(iy, 0, H - 1) * W + jnp.clip(ix, 0, W - 1)
        if rows:
            g = jnp.take(flat, idx, axis=0).astype(jnp.float32)
            out = out + g * jnp.where(valid, w, 0.0)[..., None]
        else:
            g = jnp.take(flat, idx, axis=1).astype(jnp.float32)
            out = out + g * jnp.where(valid, w, 0.0)
    return out if rows else jnp.moveaxis(out, 0, -1)


@pytest.mark.parametrize("layout", ["cols", "rows"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gathers_match_nmf_tpu(layout, dtype):
    """Three stacked planes of C = 4 x 8 x 8, 300 queries each (some off
    the plane): the forward and d/d planes of sum(out ** 2)."""
    rng = np.random.default_rng(3)
    planes = rng.normal(size=(3, 4, 8, 8)).astype(np.float32)
    coords = rng.uniform(-1.1, 1.1, (3, 300, 2)).astype(np.float32)
    rows = layout == "rows"
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]

    def jfwd(p):
        return jax.vmap(lambda a, c: _jax_gs(a, c, rows, jdt))(
            p, jnp.asarray(coords))

    jout = np.asarray(jfwd(jnp.asarray(planes)))
    jgrad = np.asarray(jax.grad(lambda p: (jfwd(p) ** 2).sum())(
        jnp.asarray(planes)))
    gs = bench_gather.gs_rows if rows else bench_gather.gs_cols
    tp, tc = torch.from_numpy(planes), torch.from_numpy(coords)
    tout = bench_gather.stacked(lambda p, c: gs(p, c, tdt), tp, tc)
    tgrad = bench_gather.stacked_grad(lambda p, c: gs(p, c, tdt), tp, tc)
    fwd, grad = (1e-5, 1e-4) if dtype == "f32" else (3e-2, 3e-2)
    close(tout.numpy(), jout, fwd, "forward")
    close(tgrad.numpy(), jgrad, grad, "d planes")


# ----------------------------------------------------------------- shade
@pytest.fixture(scope="module")
def tiny():
    """__graft_entry__'s flagship at the tiny sizes (built once) with the
    mip bias at 12, its config, and the port's copy by bench_nmf (the
    weights carried across)."""
    jn, jcfg = graft._build_nmf(jax.random.PRNGKey(0), **TINY)
    jn = jn.replace(bg_module=jn.bg_module.replace(
        mipbias=jnp.asarray(MIPBIAS, jnp.float32)))
    return jn, jcfg


def _port(jn):
    tn, cfg = bench_shade.bench_nmf(device="cpu", **TINY)
    return weights.from_jax_state_dict(tn, jckpt.state_dict(jn)), cfg


def test_bench_nmf_builds_graft_entrys_config(tiny):
    """bench_nmf composes what ``__graft_entry__._build_nmf`` composes,
    at the bench's sizes and at the tiny ones."""
    _, jcfg = tiny
    _, tcfg = bench_shade.bench_nmf(device="cpu", **TINY)
    assert tcfg == jcfg
    big = bench_shade.BENCH_SIZES
    overrides = [
        "model=microfacet_tensorf2", "dataset=synthetic_sphere",
        f"field.N_voxel_init={big['grid'] ** 3}",
        f"field.N_voxel_final={big['grid'] ** 3}", "field.upsamp_list=[]",
        f"model.arch.max_samples_per_ray={big['k_spr']}",
        f"model.arch.recur_samples_per_ray={big['recur_k']}",
        "model.arch.proposal_samples_per_ray=-1",
        "model.arch.model.brdf_ray_budget=[32768,8192]",
        "model.arch.model.max_retrace_rays=[1024]",
        f"model.arch.bg_module.bg_resolution={big['bg_res']}"]
    assert tconfig.compose(overrides) == jconfig.compose(overrides)


def _shade_arrays(M, seed, few_rays=False):
    """Shading inputs as bench_shade makes them (xyz in [-1, 1], normals
    facing the view, half valid) from numpy; ``few_rays``: weights that
    give each valid sample one or two bounce rays within the budget (no
    thinning, no sample left without a ray)."""
    rng = np.random.default_rng(seed)
    vd = rng.normal(size=(M, 3))
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    w = (rng.uniform(0.0119, 0.0135, M) if few_rays
         else rng.uniform(0, 0.05, M))
    arrs = [rng.uniform(-1, 1, (M, 4)), rng.normal(size=(M, 24)), vd, -vd,
            w]
    return [a.astype(np.float32) for a in arrs] + [rng.uniform(size=M)
                                                   < 0.5]


def _jax_stub(bounce_rays, mipval, retrace, rkey):
    return jnp.ones((bounce_rays.shape[0], 3)), None


def test_stub_shade_matches_nmf_tpu(tiny):
    """bench_shade's stub shade (``nmf_tpu/scripts/bench_shade.py:58-76``)
    on M = 256 samples, the draws made equal."""
    jn, _ = tiny
    tn, _ = _port(jn)
    xyz, feats, vd, nrm, w, valid = _shade_arrays(M_SHADE, 0)
    key = jax.random.PRNGKey(4)
    cache = jn.bg_module.prepare()
    jrgb = jax.jit(lambda m, f: m.shade(
        jnp.asarray(xyz), jnp.asarray(xyz), f, jnp.asarray(vd),
        jnp.asarray(nrm), jnp.asarray(w), jnp.asarray(valid), 32,
        render_reflection=_jax_stub, bg_module=jn.bg_module, bg_cache=cache,
        is_train=True, recur=0, key=key)[0])(jn.model, jnp.asarray(feats))
    ins = dict(zip(("xyz", "feats", "vdirs", "norms", "w", "valid"),
                   map(torch.from_numpy, (xyz, feats, vd, nrm, w, valid))))
    with torch.no_grad():
        trgb = bench_shade.shade_stub(
            tn, ins, 32, Draws(None, shade_draws(key, jn, M_SHADE, True)),
            tn.bg_module.prepare())
    close(trgb.numpy(), np.asarray(jrgb), 1e-5, "rgb")


def test_bench_shade_lines_run(tiny):
    """Every line of bench_shade on the tiny flagship: the kernel entry's
    transmittance equals raw2alpha's on the CPU, the rest runs."""
    tn, _ = _port(tiny[0])
    gen = torch.Generator().manual_seed(0)
    rows = bench_shade.bench(tn, gen, B=16, K=16, N=40, T=16,
                             timer=no_timer)
    assert len(rows) == 11 and "secondary fwd+bwd" in rows


# ----------------------------------------------------------------- bisect
@pytest.fixture(scope="module")
def bisect_nmf(tiny):
    tn, _ = _port(tiny[0])
    tn.model.max_retrace_rays = ()
    return (tn, *bisect_shade.bisect_rays(64, "cpu"))


def test_stage0_is_shade_exactly(bisect_nmf):
    """Stage 0 gives what ``Microfacet.shade`` gives, bit for bit: the
    loss of a train step and its every gradient, on the same draws."""
    nmf, rays, rgbs = bisect_nmf
    loss, grads = bisect_shade.loss_grads(nmf, rays, rgbs, seed=3)
    with bisect_shade.staged(0):
        loss0, grads0 = bisect_shade.loss_grads(nmf, rays, rgbs, seed=3)
    assert torch.equal(loss0, loss)
    assert sum(g is not None for g in grads) > 10
    for a, b in zip(grads0, grads):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("stage", [1, 2, 3, 4, 5, 6, 7, -1, -2])
def test_stage_gives_finite_gradients(bisect_nmf, stage):
    nmf, rays, rgbs = bisect_nmf
    with bisect_shade.staged(stage):
        loss, grads = bisect_shade.loss_grads(nmf, rays, rgbs)
    assert torch.isfinite(loss)
    assert all(g is None or bool(torch.isfinite(g).all()) for g in grads)
    assert Microfacet.shade is not bisect_shade.make_staged_shade


def test_shade_is_restored_when_a_stage_raises(bisect_nmf):
    """The class's method comes back after a block that raises, and after
    an option the staged copy does not stage (it raises naming it)."""
    nmf, rays, rgbs = bisect_nmf
    orig = Microfacet.shade
    with pytest.raises(RuntimeError, match="inside"):
        with bisect_shade.staged(3):
            assert Microfacet.shade is not orig
            raise RuntimeError("inside the block")
    assert Microfacet.shade is orig
    nmf.model.russian_roulette = True
    nmf.model.max_retrace_rays = (32,)
    try:
        with pytest.raises(NotImplementedError,
                           match="russian_roulette, max_retrace_rays"):
            with bisect_shade.staged(0):
                bisect_shade.loss_grads(nmf, rays, rgbs)
    finally:
        nmf.model.russian_roulette = False
        nmf.model.max_retrace_rays = ()
    assert Microfacet.shade is orig
    with pytest.raises(ValueError):
        bisect_shade.make_staged_shade(8)


def _staged_draws(key, jn, M):
    """The draws of nmf_tpu's staged shade (``bisect_shade.py:28-30``:
    its key splits five ways, the sixth split of the current ``shade``
    is missing), by the port's names."""
    ks = jax.random.split(key, 5)
    kd, kr = jax.random.split(ks[1])
    k1, k2 = jax.random.split(ks[3])
    R = jn.model.brdf_ray_budget[0]
    n, u = jax.random.normal, jax.random.uniform
    return {k: np.asarray(v) for k, v in (
        ("app_noise", n(ks[0], (M, jn.rf.app_dim))),
        ("diffuse_noise", n(kd, (M, 3))), ("roughness_noise", n(kr, (M, 2))),
        ("alloc", u(ks[2], (M,))), ("offset1", u(k1, (R,))),
        ("offset2", u(k2, (R,))))}


def _jax_shade(jn, fn, arrays, key):
    xyz, feats, vd, nrm, w, valid = map(jnp.asarray, arrays)
    model = jn.model.replace(max_retrace_rays=())
    cache = jn.bg_module.prepare()
    return np.asarray(jax.jit(lambda m: fn(
        m, xyz, jn.rf.normalize_coord(xyz), feats, vd, nrm, w, valid, 32,
        render_reflection=jax_reflection(jn, cache), bg_module=jn.bg_module,
        bg_cache=cache, is_train=True, recur=0, key=key)[0])(model))


def _port_shade(tn, arrays, draws):
    xyz, feats, vd, nrm, w, valid = map(torch.from_numpy, arrays)
    cache = tn.bg_module.prepare()
    with torch.no_grad():
        return tn.model.shade(
            xyz, tn.rf.normalize_coord(xyz), feats, vd, nrm, w, valid, 32,
            render_reflection=reflection_fn(tn, True, 0, cache, []),
            bg_module=tn.bg_module, bg_cache=cache, is_train=True, recur=0,
            draws=draws)[0].numpy()


@pytest.fixture(scope="module")
def staged_pair(tiny):
    tn, _ = _port(tiny[0])
    tn.model.max_retrace_rays = ()
    return tiny[0], tn


@pytest.mark.parametrize("stage", [0, 1, 2, 3, 4, 5, 6, 7])
def test_stages_match_nmf_tpus_staged_copy(staged_pair, stage):
    """The port's stage against nmf_tpu's ``make_staged_shade(stage)``
    (which still runs against nmf_tpu's current ``Microfacet``) on M = 512
    samples whose weights give one or two rays each within the budget:
    there the current shade's thinning and its starved-sample fallback,
    which nmf_tpu's staged copy lacks (ROADMAP C.18), do nothing. The
    draws follow the staged copy's five-way key split."""
    jn, tn = staged_pair
    arrays = _shade_arrays(M_SHADE, 1, few_rays=True)
    key = jax.random.PRNGKey(7)
    jrgb = _jax_shade(jn, jbisect.make_staged_shade(stage), arrays, key)
    with bisect_shade.staged(stage):
        trgb = _port_shade(tn, arrays, Draws(None, _staged_draws(
            key, jn, M_SHADE)))
    close(trgb, jrgb, 1e-5, f"stage {stage} rgb")


def test_nmf_tpus_staged_copy_is_not_its_shade(staged_pair):
    """ROADMAP C.18 (in the reference): nmf_tpu's stage 0 is not nmf_tpu's
    own ``shade`` once the budget thins the rays (demand ~2x the budget):
    the staged copy allocates without the thinning factor and splits its
    key five ways. The port's stage 0 is its ``shade``, bit for bit."""
    jn, tn = staged_pair
    arrays = _shade_arrays(M_SHADE, 2)
    arrays[4] = arrays[4] * 1.5 + 0.01
    key = jax.random.PRNGKey(8)
    jfull = _jax_shade(jn, type(jn.model).shade, arrays, key)
    jstaged = _jax_shade(jn, jbisect.make_staged_shade(0), arrays, key)
    assert np.abs(jfull - jstaged).max() > 0.1 * np.abs(jfull).max()
    draws = shade_draws(key, jn, M_SHADE, True)
    tfull = _port_shade(tn, arrays, Draws(None, draws))
    with bisect_shade.staged(0):
        tstaged = _port_shade(tn, arrays, Draws(None, draws))
    np.testing.assert_array_equal(tstaged, tfull)
    close(tfull, jfull, 1e-5, "the port's shade against nmf_tpu's")


# ----------------------------------------------------------------- traces
def _event(name, cat, dur, ts=0.0):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
            "ts": ts, "dur": dur}


def _write_trace(path, events, mtime):
    path.write_text(json.dumps({"traceEvents": events}))
    os.utime(path, (mtime, mtime))


def test_parse_trace_sums_a_synthetic_trace(tmp_path, capsys):
    """Durations (us) summed by name over the card's kernel, memcpy and
    memset events of the newest trace (host events left out), divided by
    ``--steps``; ``--group`` by nmf_tpu's regex."""
    events = [_event("fusion.1", "kernel", 1000), _event("fusion.2",
                                                         "kernel", 3000),
              _event("fusion.1", "kernel", 500),
              _event("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 250),
              _event("Memset (Device)", "gpu_memset", 50),
              _event("aten::add", "cpu_op", 99999),
              _event("cudaLaunchKernel", "cuda_runtime", 99999),
              {"ph": "M", "name": "process_name", "pid": 0}]
    now = time.time()
    (tmp_path / "sub").mkdir()
    _write_trace(tmp_path / "old.json", [_event("stale", "kernel", 7)],
                 now - 100)
    _write_trace(tmp_path / "sub" / "new.json", events, now)
    totals = parse_trace.device_op_times(parse_trace.load_trace(
        parse_trace.newest_trace(tmp_path)))
    assert totals == {"fusion.1": 1.5, "fusion.2": 3.0,
                      "Memcpy HtoD (Pageable -> Device)": 0.25,
                      "Memset (Device)": 0.05}
    assert parse_trace.main([str(tmp_path), "--steps", "2", "--group",
                             "--top", "3"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "total device time: 2.40 ms over 4 ops"
    assert out[2].split() == ["1.500", "62.5", "fusion.2"]
    assert out[3].split() == ["0.750", "31.2", "fusion.1"]
    assert len(out) == 2 + 3 + 2 + 3
    assert out[7].split() == ["2.250", "93.8", "fusion"]


def test_parse_trace_reads_a_cpu_profiler_trace(tmp_path, capsys):
    """A real torch.profiler trace of a tiny op (CPU only: no device
    events): read, and reported as holding none."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
    prof.export_chrome_trace(str(tmp_path / "cpu.json"))
    events = parse_trace.load_trace(parse_trace.newest_trace(tmp_path))
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert parse_trace.device_op_times(events) == {}
    assert parse_trace.main([str(tmp_path)]) == 1
    assert "no device events" in capsys.readouterr().err
    with pytest.raises(FileNotFoundError):
        parse_trace.newest_trace(tmp_path / "nothing")


def test_group_name_is_nmf_tpus():
    names = ["fusion.123", "loop_add_fusion.5", "copy", "copy.1.2",
             "void at::native::vectorized_elementwise_kernel<4>(int)",
             "binsum_rows_kernel", "a.b", "x.", ".7", "Memset (Device)"]
    assert [parse_trace.group_name(n) for n in names] == [
        parse_xplane.group_name(n) for n in names]


def test_timeit_runs_on_the_cpu():
    calls = []
    ms = profile_step.timeit(lambda x: calls.append(x), 5, n=4)
    assert calls == [5] * 13 and ms >= 0.0
