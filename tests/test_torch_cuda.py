"""nmf_tpu_torch's CUDA kernels against their plain PyTorch versions, on the
card. Every test is marked ``cuda`` and skips without a CUDA device. The
file imports neither JAX nor nmf_tpu, so it runs where only PyTorch is
installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nmf_tpu_torch.ops import grid_sample as tgs  # noqa: E402
from nmf_tpu_torch.ops.kernels import binsum as tbin  # noqa: E402
from nmf_tpu_torch.ops.kernels import composite as tcomp  # noqa: E402
from torch_inputs import (FLAGSHIP, GRID, OCCGRID,  # noqa: E402
                          REFNERF_TCNN, binsum_case, composite_inputs,
                          cotangents)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# (B, K): one sample; a ragged tile; the train step's K (at two batch
# sizes); the flagship's primary and retrace K; a ray of six tiles
COMPOSITE_SHAPES = [(1, 1), (300, 33), (64, 192), (300, 192), (1024, 96),
                    (257, 1024)]
# moderate rays keep a mean optical depth of about 4 over the ray, so T
# stays far above the tolerances to the last tile; decaying rays (the same
# densities, unscaled) take T to near 0 partway along the ray without being
# opaque; opaque rays underflow it within a few samples
RAYS = ["moderate", "decaying", "opaque"]


def _composite_kernel_vs_plain(cuda, fns, B, K, rays, n_inputs, n_cots):
    """Outputs and every input's gradient of the kernel's entry and of its
    plain version, on the same inputs and cotangents."""
    arrays = composite_inputs(B=B, K=K, seed=6,
                              opaque=rays == "opaque")[:n_inputs]
    if rays == "moderate":
        arrays[1][:] *= min(1.0, 16 / K)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    cots = [torch.from_numpy(c).to(cuda) for c in cotangents(B, K)[:n_cots]]
    results = []
    for fn in fns:
        ts = [a.clone().requires_grad_(True) for a in args]
        outs = fn(*ts)
        outs = outs if isinstance(outs, tuple) else (outs,)
        sum((o * c).sum() for o, c in zip(outs, cots)).backward()
        results.append(([o.detach() for o in outs], [t.grad for t in ts]))
    torch.cuda.synchronize()
    return results


@pytest.mark.cuda
@pytest.mark.parametrize("rays", RAYS)
@pytest.mark.parametrize("shape", COMPOSITE_SHAPES, ids=str)
def test_composite_kernel_matches_plain_on_card(cuda, shape, rays):
    # full mode: weights, rgb_map, acc, depth; d_sigma, d_dists, d_rgb, d_z
    kern, plain = _composite_kernel_vs_plain(
        cuda, (tcomp.composite_rays, tcomp.composite_rays_plain), *shape,
        rays, n_inputs=4, n_cots=4)
    for a, b in zip(kern[0], plain[0]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    for a, b in zip(kern[1], plain[1]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("rays", RAYS)
@pytest.mark.parametrize("shape", COMPOSITE_SHAPES, ids=str)
def test_transmittance_kernel_matches_plain_on_card(cuda, shape, rays):
    # weights-only entry (null rgb / z pointers): weights; d_sigma, d_dists
    kern, plain = _composite_kernel_vs_plain(
        cuda, (tcomp.transmittance_weights,
               tcomp.transmittance_weights_plain), *shape, rays,
        n_inputs=2, n_cots=1)
    for a, b in zip(kern[0] + kern[1], plain[0] + plain[1]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "collisions", "runs", "flagship C=6", "flagship C=9", "flagship C=12",
    "flagship C=44", "flagship C=288", "bf16 C=288", "bf16 C=160",
    "bf16 C=112", "bf16 C=80", "long runs C=9", "long runs C=44",
    "all out of range", "hash C=2"])
def test_binsum_kernel_matches_plain_on_card(cuda, case):
    # atomics add in a varying order: rtol/atol 1e-4. The bf16 cases hand
    # both the same bf16 rows, which the kernel reads in place and the
    # plain version widens to f32 first.
    idx, vals, R = binsum_case(case)
    idx_t, vals_t = torch.from_numpy(idx).to(cuda), torch.from_numpy(vals).to(cuda)
    if case.startswith("bf16"):
        vals_t = vals_t.bfloat16()
    out = tbin.binsum_rows(idx_t, vals_t, R)
    ref = tbin.binsum_rows_plain(idx_t, vals_t, R)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    if case == "all out of range":
        assert not out.any()


@pytest.mark.cuda
def test_quad_gather_backward_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(8)
    plane = rng.normal(size=(40, 33, 33)).astype(np.float32)
    coords = rng.uniform(-1.05, 1.05, size=(4096, 2)).astype(np.float32)
    g = rng.normal(size=(4096, 40)).astype(np.float32)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        p = torch.tensor(plane, device=dev, requires_grad=True)
        out = tgs.quad_gather_2d(p, torch.from_numpy(coords).to(dev))
        (out * torch.from_numpy(g).to(dev)).sum().backward()
        grads.append(p.grad.cpu())
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_kernels_launch_on_their_tensors_device():
    # tensors on cuda:1 while cuda:0 is current: each wrapper must launch
    # on cuda:1, where the pointers live
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda", 1)
    idx, vals, R = binsum_case("runs")
    sigma, dists, rgb, z = (torch.from_numpy(a).to(dev) for a in
                            composite_inputs(B=64, K=32, seed=9, opaque=True))
    with torch.cuda.device(0):
        idx_t, vals_t = torch.from_numpy(idx).to(dev), torch.from_numpy(vals).to(dev)
        torch.testing.assert_close(tbin.binsum_rows(idx_t, vals_t, R),
                                   tbin.binsum_rows_plain(idx_t, vals_t, R),
                                   rtol=1e-4, atol=1e-4)
        s = sigma.clone().requires_grad_(True)
        w = tcomp.transmittance_weights(s, dists)
        w.sum().backward()
        s_ref = sigma.clone().requires_grad_(True)
        w_ref = tcomp.transmittance_weights_plain(s_ref, dists)
        w_ref.sum().backward()
        torch.cuda.synchronize(dev)
    torch.testing.assert_close(w, w_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s.grad, s_ref.grad, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_tiny_flagship_step_on_card_matches_cpu(cuda):
    """One train step of the tiny flagship on the card and on the CPU, with
    the same draws from one CPU generator: the loss, the image of an eval
    render and every gradient. The envmap's mip bias is 12, so every
    lookup box spans the map (small boxes carry the SAT's summation order,
    which differs between the card's cumsum and the CPU's)."""
    _flagship_step_card_vs_cpu(cuda, [])


@pytest.mark.cuda
def test_tiny_fixed_shape_flagship_step_on_card_matches_cpu(cuda):
    """The same with the fixed-shape field: 16^3 live inside planes padded
    to 20^3, an all-occupied mask at 20^3 and the march step scaled to the
    live cell; the padding's gradients on the card must be zero."""
    grads = _flagship_step_card_vs_cpu(cuda, ["field.fixed_shape=true"])
    assert len(grads) == 3
    assert not any(g[:, 16:].any() or g[:, :, 16:].any() for g in grads)


@pytest.mark.cuda
@pytest.mark.parametrize("shrunk", [False, True], ids=["box", "shrunk"])
def test_tiny_microfacet_tensorf_step_on_card_matches_cpu(cuda, shrunk):
    """The same for the tiny occupancy-grid NMF (16^3 occupancy grid swept
    from the field on each device, the normal MLP, pred_lambda 0.5): the
    loss, the image and every gradient, the normal MLP's among them; and
    with the field first cropped by ``shrink`` to a box-shaped grid and
    the sampler re-derived, as a shrink_iters tick does."""
    grads = _flagship_step_card_vs_cpu(
        cuda, [], base=OCCGRID, weights={"pred_lambda": 0.5},
        shrink=(np.array([[-0.9, -0.7, -1.1], [0.5, 1.0, 0.6]], np.float32)
                if shrunk else None))
    if shrunk:
        assert tuple(grads[0].shape[1:]) != (16, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [GRID, ["field.numer_grad=false"]],
                         ids=["grid", "autograd_normals"])
def test_tiny_flagship_field_variants_on_card_match_cpu(cuda, extra):
    """The tiny flagship on the dense voxel field (the table's gradient
    through K3) and with autograd normals through the quad gather: the
    loss, the image and every gradient, card against CPU."""
    base = GRID if extra is GRID else FLAGSHIP
    _flagship_step_card_vs_cpu(cuda, [] if extra is GRID else extra,
                               base=base)


@pytest.mark.cuda
def test_streaming_render_on_card_matches_cpu(cuda):
    """A streaming render of a tiny model=tensorf with the MLPRender_PE
    head: each block composited by K1 in full mode on the card, against
    the plain version on the CPU."""
    from nmf_tpu_torch import config
    from nmf_tpu_torch.builders import build_nmf
    from nmf_tpu_torch.data import load_dataset
    from nmf_tpu_torch.render_streaming import render_streaming

    cfg = config.compose([
        "model=tensorf", "dataset=synthetic_sphere", "dataset.image_size=16",
        "field.N_voxel_init=4096", "field.gather_dtype=f32",
        "field.density_shift=-1", "model.arch.model.diffuse_module._target_="
        "modules.render_modules.MLPRender_PE"])
    ds = load_dataset(cfg["dataset"], None, "test")
    outs = []
    before = tcomp.COMPOSITE_FWD.launches
    for dev in (cuda, torch.device("cpu")):
        nmf = build_nmf(cfg["model"]["arch"], ds["scene_bbox"],
                        tuple(cfg["dataset"]["near_far"]), seed=0,
                        device=dev)
        ims, stats = render_streaming(
            nmf, torch.from_numpy(ds["all_rays"][:256]).to(dev), block=16)
        outs.append([ims[k].cpu() for k in ("rgb_map", "acc_map", "depth")])
    assert tcomp.COMPOSITE_FWD.launches - before == stats["blocks"] > 0
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def _march_rays(march, n=64, seed=5):
    """Rays for a march that keeps its samples off the box's faces:
    camera-like rays whose jittered first sample lies inside (train),
    rays through the box's middle whose first sample, at near = 2.5, lies
    inside (eval), NDC-like rays from just inside z = -1 (ndc)."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if march.startswith("ndc"):
        o = np.concatenate([rng.uniform(-0.8, 0.8, (n, 2)),
                            np.full((n, 1), -0.98)], -1)
        d = np.concatenate([rng.uniform(-0.4, 0.4, (n, 2)),
                            np.full((n, 1), 1.9)], -1)
    else:
        o = rng.uniform(-0.6, 0.6, (n, 3)) - (4.0 if march == "train"
                                              else 2.6) * d
    return torch.from_numpy(np.concatenate([o, d], -1).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("march", ["train", "eval", "ndc_train", "ndc_eval",
                                   "alphagrid_ndc_train"])
def test_occgrid_march_on_card_matches_cpu(cuda, march):
    """OccGridSampler.sample and sample_ndc of the tiny occupancy-grid NMF
    over a block occupancy grid (and the flagship's
    AlphaGridSampler.sample_ndc), on the card and on the CPU with the same
    jitter: the validity flags equal, positions, depths and spacings
    within 1e-5."""
    from nmf_tpu_torch import config
    from nmf_tpu_torch.builders import build_nmf

    alphagrid = march.startswith("alphagrid")
    cfg = config.compose(FLAGSHIP if alphagrid else OCCGRID)
    grid = np.random.default_rng(4).uniform(0, 1e-3, (16,) * 3)
    grid[3:9, 4:11, 5:8] = 1.0
    outs = []
    for dev in (cuda, torch.device("cpu")):
        nmf = build_nmf(cfg["model"]["arch"], np.array(
            [[-1.5] * 3, [1.5] * 3], np.float32), (2.5, 5.5), seed=0,
            device=dev)
        s = nmf.sampler
        if not alphagrid:
            s.density_grid = torch.tensor(grid, dtype=torch.float32,
                                          device=dev)
        rays = _march_rays(march.split("_", 1)[-1] if alphagrid
                           else march).to(dev)
        if alphagrid:  # some rays leave the box through its sides
            rays[:, 3:5] *= 4
        train = march.endswith("train")
        jitter = (torch.rand((rays.shape[0], s.n_samples),
                             generator=torch.Generator().manual_seed(3)
                             ).to(dev) if train else None)
        if "ndc" in march:
            s.near_far = (0.0, 1.0)
            # the alpha grid's test is the box alone: all steps, uncompacted
            out = s.sample_ndc(rays, is_train=train, jitter=jitter,
                               max_samples_per_ray=-1 if alphagrid else 16)
        else:
            out = s.sample(rays, is_train=train, jitter=jitter,
                           max_samples_per_ray=16)
        outs.append({k: v.cpu() for k, v in out.items()})
    card, cpu = outs
    assert torch.equal(card["valid"], cpu["valid"])
    assert 0 < int(cpu["valid"].sum()) < cpu["valid"].numel()
    for k in ("xyz", "z_vals", "dists"):
        torch.testing.assert_close(card[k], cpu[k], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_tiny_refnerf_tcnn_step_on_card_matches_cpu(cuda):
    """The same for the tiny refnerf_tcnn on the hash field (4 levels of
    2^12 rows, the 16^3 occupancy grid, Ref-NeRF shading, the autograd
    normals with their second-order gradients to the tables): the loss,
    the image and every gradient."""
    _flagship_step_card_vs_cpu(cuda, [], base=REFNERF_TCNN,
                               weights={"pred_lambda": 3e-4})


def _flagship_step_card_vs_cpu(cuda, extra, base=FLAGSHIP, weights=None,
                               shrink=None):
    """Runs the comparison (the field cropped to the box ``shrink`` first,
    if given); returns the card's density-plane gradients."""
    from nmf_tpu_torch import config, trainer
    from nmf_tpu_torch.builders import build_nmf
    from nmf_tpu_torch.data import load_dataset
    from nmf_tpu_torch.ops.draws import Draws
    from nmf_tpu_torch.render import render

    cfg = config.compose([*base, "dataset.image_size=16",
                          "dataset.n_views=4", *extra])
    ds = load_dataset(cfg["dataset"], None, "train")
    runs = []
    for dev in (cuda, torch.device("cpu")):
        nmf = build_nmf(cfg["model"]["arch"], ds["scene_bbox"],
                        tuple(cfg["dataset"]["near_far"]), seed=0,
                        device=dev)
        with torch.no_grad():
            nmf.bg_module.mipbias.fill_(12.0)
        if shrink is not None:
            assert nmf.rf.shrink(shrink)
            nmf.sampler.update(nmf.rf, init=True)
        trainer.Optimizer(nmf, trainer.OptimConfig())
        rays = torch.from_numpy(ds["all_rays"][:64]).to(dev)
        loss, _ = trainer.compute_loss(
            nmf, rays, torch.from_numpy(ds["all_rgbs"][:64]).to(dev),
            trainer.LossWeights(ori_lambda=0.1, **(weights or {})),
            (1.0, 1.0, 1.0),
            draws=Draws(torch.Generator().manual_seed(1)))
        loss.backward()
        with torch.no_grad():
            image = render(nmf, rays, draws=Draws(
                torch.Generator().manual_seed(2)),
                bg_cache=nmf.bg_module.prepare())[0]["rgb_map"]
        runs.append((loss.detach().cpu(), image.cpu(),
                     [t.grad.cpu() for _, t, _ in
                      trainer.differentiated_tensors(nmf)
                      if t.grad is not None]))
    (l0, i0, g0), (l1, i1, g1) = runs
    torch.testing.assert_close(l0, l1, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(i0, i1, rtol=1e-4, atol=1e-5)
    assert len(g0) == len(g1) > 20
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=1e-3,
                                   atol=1e-3 * float(b.abs().max()) + 1e-9)
    return [g for g, (name, _, _) in zip(
        g0, [e for e in trainer.differentiated_tensors(nmf)
             if e[1].grad is not None])
        if name.startswith("rf/density_rf/planes")]


@pytest.mark.cuda
def test_tiny_blender_scene_flagship_steps_on_card(cuda, tmp_path):
    """The default run's dataset on the card: a tiny nerf_synthetic folder
    (the sphere generator's views) loaded with dataset=lego, three steps
    of the tiny flagship from the device store, then the eval: the loss is
    finite and pano.exr is written."""
    from nmf_tpu_torch import config, train
    from nmf_tpu_torch.data.blender import save_blender_split
    from nmf_tpu_torch.data.synthetic import make_sphere_dataset

    for split, seed in (("train", 0), ("test", 1)):
        ds = make_sphere_dataset(n_views=3, H=16, W=16, seed=seed)
        save_blender_split(tmp_path / "nerf_synthetic" / "lego", split,
                           ds["poses"], ds["all_rgbs"].reshape(3, 16, 16, 3),
                           2 * np.arctan(8 / ds["focal"]))
    _, res = train.reconstruction(config.compose([
        *(o for o in FLAGSHIP if not o.startswith("dataset=")),
        "dataset=lego", f"datadir={tmp_path}", "dataset.near_far=[2.5,5.5]",
        "model.params.n_iters=3", "model.params.batch_size=64",
        "device=cuda", f"basedir={tmp_path}", "expname=c", "N_vis=1"]),
        log=lambda s: None)
    assert np.isfinite(res["loss"])
    assert (tmp_path / "lego_c" / "imgs_test_all" / "pano.exr").exists()


@pytest.mark.cuda
def test_collect_ray_debug_on_card_launches_k1_and_matches_cpu(cuda):
    """The ray logger's bundle on the card: its weights through K1 (one
    launch), equal to the CPU's plain version's."""
    from nmf_tpu_torch import config
    from nmf_tpu_torch.builders import build_nmf
    from nmf_tpu_torch.data import load_dataset
    from nmf_tpu_torch.modules.logger import collect_ray_debug

    cfg = config.compose([*FLAGSHIP, "dataset.image_size=16"])
    ds = load_dataset(cfg["dataset"], None, "test")
    outs = []
    before = tcomp.COMPOSITE_FWD.launches
    for dev in (cuda, torch.device("cpu")):
        nmf = build_nmf(cfg["model"]["arch"], ds["scene_bbox"],
                        tuple(cfg["dataset"]["near_far"]), seed=0,
                        device=dev)
        dbg = collect_ray_debug(
            nmf, torch.from_numpy(ds["all_rays"][:128]).to(dev))
        outs.append([dbg[k].float().cpu() for k in ("xyz", "weights",
                                                    "valid")])
    assert tcomp.COMPOSITE_FWD.launches - before == 1
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_pano_fit_on_card_matches_cpu(cuda):
    """pano2env's fit on the card (its SAT's backward through K3) against
    the CPU: the first step's loss and gradients."""
    from nmf_tpu_torch.scripts.pano2env import fit_pano

    pano = np.random.default_rng(0).gamma(0.6, 2.0, (16, 32, 3)).astype(
        np.float32)
    firsts = []
    before = tbin.BINSUM.launches
    for dev in (cuda, torch.device("cpu")):
        first = []

        def on_step(it, loss, tensors, grads, m, v, first=first):
            if it == 0:
                first += [loss.cpu(), *(g.cpu() for g in grads)]

        fit_pano(pano, bg_resolution=16, iters=2, batch=2048, device=dev,
                 log=lambda s: None, on_step=on_step)
        firsts.append(first)
    assert tbin.BINSUM.launches - before == 2
    for a, b in zip(*firsts):
        torch.testing.assert_close(a, b, rtol=1e-3,
                                   atol=1e-4 * float(b.abs().max()) + 1e-9)


@pytest.mark.cuda
def test_dual_scene_run_on_card(cuda, tmp_path):
    """A tiny flagship dual-scene run on the card (two sphere scenes, one
    envmap each): finite test PSNRs, both envmaps moved."""
    from nmf_tpu_torch import config
    from nmf_tpu_torch.train_dualbg import reconstruction_dual

    cfg = config.compose([*FLAGSHIP, "dataset2=synthetic_sphere",
                          "dataset.image_size=16", "dataset2.image_size=16",
                          "dataset2.n_views=3", "model.params.n_iters=4",
                          "model.params.batch_size=64", "device=cuda",
                          f"basedir={tmp_path}", "expname=c", "N_vis=1"])
    nmf, res = reconstruction_dual(cfg, log=lambda s: None)
    assert all(np.isfinite(r["psnr"]) for r in res) and len(res) == 2
    init = float(cfg["model"]["arch"]["bg_module"].get("init_val", -0.6))
    for bg in nmf.bg_module.bgs:
        assert float((bg.bg_mat - init).abs().max()) > 0
