#!/usr/bin/env python3
"""Drive nmf_tpu_torch on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

1. Device: the card's name and power limit, torch's CUDA version.
2. Build: compiles the CUDA kernels of nmf_tpu_torch/csrc with nvcc.
3. Kernels: holds each kernel against its plain PyTorch version at the
   train step's shapes (B = 4096 rays x K = 192 samples for composite;
   N = 786,432 rows x C = 160 channels into R = 16,384 rows for binsum),
   and times the kernel alone, its wrapper, the plain version and, for
   binsum, the one-call yardstick ``index_add_`` (which the port never
   calls). binsum is also held and timed at the other shapes of the train
   step's launches: planes at 300^2 after the upsample, lines (C = 80) at
   128 and 300 cells.
   Then runs one train step and one eval render of a tiny model=tensorf on
   the card and on the CPU (the plain versions) and compares the loss, the
   image and every gradient.
4. Main path: trains model=tensorf on synthetic_sphere at the model's full
   width (128^3 grid, 16/24 components, app_dim 24, featureC 128, 4096
   rays x 192 samples) for 300 iterations, through one upsample to 300^3
   and two alpha-mask rebuilds, then evaluates the test views. Checks the
   loss is finite, every kernel was launched, and the test PSNR > 17 dB.

Prints one JSON line of kernel numbers and, as its last line,
{"ok": true, "device": {...}}. Without a CUDA device, or run outside the
repository, it exits non-zero and prints no result.
"""
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LOG_DIR = ROOT / "log" / "chip_smoke"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
PSNR_BAR = 17.0


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(torch, fn, iters=20, warmup=3):
    """Mean milliseconds per call of fn, from CUDA events around ``iters``
    calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes, n_ops):
    """Least time for the work: HBM bytes or f32 operations."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_err(torch, pairs, rtol, atol, what):
    """Largest |a - b| over pairs; fails past atol + rtol * |b|."""
    worst = 0.0
    for i, (a, b) in enumerate(pairs):
        if not bool(torch.isfinite(a).all()):
            fail(f"{what}: non-finite output {i}")
        err = (a.double() - b.double()).abs()
        over = err - (atol + rtol * b.double().abs())
        if float(over.max()) > 0:
            fail(f"{what}: output {i} off by {float(err.max()):.3e} "
                 f"(rtol {rtol}, atol "
                 f"{atol if isinstance(atol, float) else 'per element'})")
        worst = max(worst, float(err.max()))
    return worst


def composite_inputs(torch, dev, B, K, gen):
    """Densities and spacings like the train step's (dists scaled by
    distance_scale 25), a quarter of the rays opaque: sigma * dist up to
    60, where the transmittance underflows."""
    sigma = torch.rand((B, K), generator=gen, device=dev) * 40
    dists = 0.05 + 0.3 * torch.rand((B, K), generator=gen, device=dev)
    sigma[: B // 4] *= 4
    sigma[:, ::7] = 0  # empty samples
    rgb = torch.rand((B, K, 3), generator=gen, device=dev)
    z = torch.cumsum(dists, dim=1) / 25 + 2.5
    return sigma, dists, rgb, z


def check_composite(torch, dev, gen):
    from nmf_tpu_torch.ops.kernels import composite as C
    from nmf_tpu_torch.ops.kernels.build import ptr

    B, K = 4096, 192
    sigma, dists, rgb, z = composite_inputs(torch, dev, B, K, gen)
    g_w = torch.randn((B, K), generator=gen, device=dev)
    # forward (composite_rays and the weights-only entry of the train step)
    with torch.no_grad():
        full = C.composite_rays(sigma, dists, rgb, z)
        full_ref = C.composite_rays_plain(sigma, dists, rgb, z)
        w = C.transmittance_weights(sigma, dists)
        w_ref = C.transmittance_weights_plain(sigma, dists)
    # T is a product of up to 192 factors, rounded in another order by the
    # plain cumprod: 1e-5 relative plus 1e-6
    fwd_err = max_err(torch, list(zip(full, full_ref)) + [(w, w_ref)],
                      1e-5, 1e-6, "composite forward")

    # backward: every input's gradient of both entries
    def grads(fn, inputs, cots):
        ts = [t.clone().requires_grad_(True) for t in inputs]
        outs = fn(*ts)
        outs = outs if isinstance(outs, tuple) else (outs,)
        torch.autograd.backward(outs, cots)
        return [t.grad for t in ts]

    cots = (g_w, torch.randn((B, 3), generator=gen, device=dev),
            torch.randn((B,), generator=gen, device=dev),
            torch.randn((B,), generator=gen, device=dev))
    pairs = list(zip(grads(C.composite_rays, (sigma, dists, rgb, z), cots),
                     grads(C.composite_rays_plain, (sigma, dists, rgb, z),
                           cots)))
    pairs += list(zip(grads(C.transmittance_weights, (sigma, dists), (g_w,)),
                      grads(C.transmittance_weights_plain, (sigma, dists),
                            (g_w,))))
    # reverse scan without division against cumprod's autograd (which
    # divides): 1e-4 relative plus 1e-5 on cotangents of unit scale
    bwd_err = max_err(torch, pairs, 1e-4, 1e-5, "composite backward")
    torch.cuda.synchronize()

    # timing, the train step's weights-only entry. The kernel: back-to-back
    # launches of the C entry on preallocated buffers, so the events read
    # device time (through autograd the host work is about as long as the
    # kernel and varies with the host). The wrapper and the plain version:
    # as the train step calls them.
    stream = torch.cuda.current_stream(dev).cuda_stream
    w_buf, d_buf = torch.empty_like(sigma), torch.empty_like(sigma)
    fwd_ms = time_ms(torch, lambda: C.COMPOSITE_FWD(
        ptr(sigma), ptr(dists), None, None, ptr(w_buf), None, None, None,
        B, K, stream))
    bwd_ms = time_ms(torch, lambda: C.COMPOSITE_BWD(
        ptr(sigma), ptr(dists), None, None, ptr(g_w), None, None, None,
        ptr(d_buf), None, None, None, B, K, stream))
    with torch.no_grad():
        fwd_wrap_ms = time_ms(
            torch, lambda: C.transmittance_weights(sigma, dists))
        fwd_plain_ms = time_ms(
            torch, lambda: C.transmittance_weights_plain(sigma, dists))
    s_k = sigma.clone().requires_grad_(True)
    w_k = C.transmittance_weights(s_k, dists)
    s_p = sigma.clone().requires_grad_(True)
    w_p = C.transmittance_weights_plain(s_p, dists)
    bwd_wrap_ms = time_ms(torch, lambda: torch.autograd.grad(
        w_k, s_k, g_w, retain_graph=True))
    bwd_plain_ms = time_ms(torch, lambda: torch.autograd.grad(
        w_p, s_p, g_w, retain_graph=True))
    n = B * K
    fb, fby = bound_ms(3 * 4 * n, 6 * n)   # read sigma, dists; write w
    bb, bby = bound_ms(4 * 4 * n, 16 * n)  # + g_w; write d_sigma
    return [
        {"name": "composite_fwd", "route": "cuda",
         "source": "nmf_tpu_torch/csrc/composite.cu",
         "replaces": "nmf_tpu/ops/pallas/composite.py:28",
         "kernel": C.COMPOSITE_FWD, "max_abs_err": fwd_err, "ms": fwd_ms,
         "wrapper_ms": fwd_wrap_ms, "plain_ms": fwd_plain_ms,
         "bound_ms": fb, "bound_by": fby, "library_ms": None,
         "shape": f"B={B} K={K} weights-only"},
        {"name": "composite_bwd", "route": "cuda",
         "source": "nmf_tpu_torch/csrc/composite.cu",
         "replaces": "nmf_tpu/ops/pallas/composite.py:51",
         "kernel": C.COMPOSITE_BWD, "max_abs_err": bwd_err, "ms": bwd_ms,
         "wrapper_ms": bwd_wrap_ms, "plain_ms": bwd_plain_ms,
         "bound_ms": bb, "bound_by": bby, "library_ms": None,
         "shape": f"B={B} K={K} weights-only"},
    ]


def plane_ids(torch, dev, gen, H, W, n_rays=4096, K=192):
    """Row ids as the plane-gradient scatter sees them: each ray walks the
    plane, moving to a neighbouring texel every ~11 samples."""
    start = torch.randint(0, H * W, (n_rays, 1), generator=gen, device=dev)
    moves = torch.rand((n_rays, K), generator=gen, device=dev) < 1 / 11
    step = torch.where(torch.rand((n_rays, K), generator=gen, device=dev)
                       < 0.5, 1, W)
    return (start + torch.cumsum(moves * step, dim=1)) % (H * W)


def line_ids(torch, dev, gen, L, n_rays=4096, K=192):
    """Row ids as the line-gradient scatter sees them: each ray advances
    along the line's axis by up to half a cell a sample (the stepsize is
    half a voxel), clamped to the line as line_interp clamps."""
    start = torch.rand((n_rays, 1), generator=gen, device=dev) * L
    rate = torch.rand((n_rays, 1), generator=gen, device=dev) - 0.5
    pos = start + rate * torch.arange(K, device=dev)
    return torch.clamp(pos.floor(), 0, L - 1)


def binsum_inputs(torch, dev, gen, ids, R, C):
    """(idx, vals) from ray-walk ids; 1% of the rows are out of range
    (dropped)."""
    idx = ids.reshape(-1).to(torch.int32)
    out = torch.rand(idx.shape, generator=gen, device=dev) < 0.01
    idx[out] = R + 7
    vals = torch.randn((idx.numel(), C), generator=gen, device=dev)
    return idx, vals


def check_binsum(torch, dev, gen):
    """binsum_rows at each shape the train step's six launches take: the
    three planes (C = 4 x 40 quad-table channels) at 128^2 and, after the
    upsample, 300^2 texels; the three lines (C = 2 x 40) at 128 and 300
    cells, where every id collides thousands of times. The kernels line
    reports the first shape; every shape is in ``shapes``."""
    from nmf_tpu_torch.ops.kernels import binsum as S
    from nmf_tpu_torch.ops.kernels.build import ptr

    cases = [("plane", 128 * 128, 160, plane_ids(torch, dev, gen, 128, 128)),
             ("plane", 300 * 300, 160, plane_ids(torch, dev, gen, 300, 300)),
             ("line", 128, 80, line_ids(torch, dev, gen, 128)),
             ("line", 300, 80, line_ids(torch, dev, gen, 300))]
    stream = torch.cuda.current_stream(dev).cuda_stream
    shapes = []
    for what, R, C, ids in cases:
        idx, vals = binsum_inputs(torch, dev, gen, ids, R, C)
        N = idx.numel()
        out = S.binsum_rows(idx, vals, R)
        ref = S.binsum_rows_plain(idx, vals, R)
        # atomics add in a varying order, and so does index_add_: the two
        # f32 sums of a row differ by rounding that grows with the row's
        # sum of |vals| (~48 unit-scale rows meet per plane texel, ~2,600
        # to ~6,000 per line cell): 1e-4 relative plus 1e-4 plus 1e-6 of
        # that absolute sum
        abs_sum = S.binsum_rows_plain(idx, vals.abs(), R)
        err = max_err(torch, [(out, ref)], 1e-4, 1e-4 + 1e-6 * abs_sum,
                      f"binsum {what} R={R}")
        keep = (idx >= 0) & (idx < R)
        idx_in, vals_in = idx[keep].long(), vals[keep]
        # the kernel alone accumulates into one preallocated buffer; the
        # wrapper also zeroes a fresh one, as the train step's call does
        out_buf = torch.zeros((R, C), device=dev)
        ms = time_ms(torch, lambda: S.BINSUM(
            ptr(idx), ptr(vals), ptr(out_buf), N, C, R, stream))
        wrap_ms = time_ms(torch, lambda: S.binsum_rows(idx, vals, R))
        plain_ms = time_ms(torch, lambda: S.binsum_rows_plain(idx, vals, R))
        lib_ms = time_ms(torch, lambda: torch.zeros(
            (R, C), device=dev).index_add_(0, idx_in, vals_in))
        b, by = bound_ms(4 * N + 4 * N * C + 4 * R * C, N * C)
        shapes.append({"shape": f"{what} N={N} C={C} R={R}",
                       "max_abs_err": err, "ms": ms, "wrapper_ms": wrap_ms,
                       "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                       "library_ms": lib_ms})
        del idx, vals, out, ref, abs_sum, idx_in, vals_in, out_buf
    first = shapes[0]
    return [{"name": "binsum_rows", "route": "cuda",
             "source": "nmf_tpu_torch/csrc/binsum.cu",
             "replaces": "nmf_tpu/ops/pallas/binsum.py:40",
             "kernel": S.BINSUM} | first | {"shapes": shapes}]


def check_small_path(torch, dev):
    """One train step (loss and every gradient) and one eval render of a
    tiny model=tensorf on the card, against the same on the CPU, where the
    wrappers run the plain versions that the CPU tests hold against
    nmf_tpu. Same seed, rays and jitter on both; f32 gathers."""
    from nmf_tpu_torch import config, trainer
    from nmf_tpu_torch.builders import build_nmf
    from nmf_tpu_torch.data import load_dataset
    from nmf_tpu_torch.render import render

    cfg = config.compose([
        "model=tensorf", "dataset=synthetic_sphere", "dataset.image_size=16",
        "dataset.n_views=4", "field.N_voxel_init=4096",
        "field.N_voxel_final=8000", "field.gather_dtype=f32",
        "model.arch.max_samples_per_ray=32",
        "model.arch.model.diffuse_module.featureC=16"])
    ds = load_dataset(cfg["dataset"], None, "train")
    rays_np, rgb_np = ds["all_rays"][:512], ds["all_rgbs"][:512]
    weights = trainer.LossWeights(l1_weight=8e-5)
    runs = []
    for d in (dev, torch.device("cpu")):
        nmf = build_nmf(cfg["model"]["arch"], ds["scene_bbox"],
                        tuple(cfg["dataset"]["near_far"]), seed=0, device=d)
        nmf.sampler.update(nmf.rf)  # a real alpha mask: both marches' tests
        rays = torch.from_numpy(rays_np).to(d)
        jitter = torch.rand((512, nmf.sampler.n_samples),
                            generator=torch.Generator().manual_seed(1)).to(d)
        loss, _ = trainer.compute_loss(nmf, rays, torch.from_numpy(rgb_np).to(d),
                                       weights, (1.0, 1.0, 1.0), jitter=jitter)
        loss.backward()
        with torch.no_grad():
            image = render(nmf, rays, is_train=False)[0]["rgb_map"]
        runs.append([loss.detach(), image]
                    + [p.grad for p in nmf.parameters() if p.grad is not None])
    if len(runs[0]) != len(runs[1]) or len(runs[0]) < 10:
        fail("small path: the card and the CPU differentiated other tensors")
    # f32 on both; sums (scatter atomics, matmuls, cumsum) in another order
    pairs = [(a.cpu(), b) for a, b in zip(*runs)]
    err = max_err(torch, pairs[:2], 1e-4, 1e-5, "small path loss/render")
    for i, (a, b) in enumerate(pairs[2:]):
        scale = float(b.abs().max())
        err = max(err, max_err(torch, [(a, b)], 1e-3, 1e-4 * scale + 1e-9,
                               f"small path gradient {i}"))
    return err


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch sees no CUDA device")
    sys.path.insert(0, str(ROOT))
    try:
        from nmf_tpu_torch import config
        from nmf_tpu_torch.ops.kernels import build
        from nmf_tpu_torch.train import reconstruction
    except ImportError as e:
        fail(f"nmf_tpu_torch is not importable next to this script ({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else f"{name}, power limit not read"
    print(card)
    nvcc = [ln for ln in subprocess.run(
        [build.find_nvcc(), "--version"], capture_output=True, text=True,
        timeout=60).stdout.splitlines() if "release" in ln]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc: {nvcc[0] if nvcc else 'release not read'}")

    t0 = time.time()
    logs = build.build_all(ptxas_verbose=True)
    print(f"build: {time.time() - t0:.1f} s ({', '.join(logs) or 'cached'})")
    for source, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {source}: {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(0)
    kernels = check_composite(torch, dev, gen) + check_binsum(torch, dev, gen)
    for k in kernels:
        for row in k.get("shapes", [k]):
            print(f"kernel {k['name']} ({row['shape']}): max_abs_err "
                  f"{row['max_abs_err']:.3e}, {row['ms']:.4f} ms (wrapper "
                  f"{row['wrapper_ms']:.4f}, plain "
                  f"{row['plain_ms']:.4f}, bound {row['bound_ms']:.4f} by "
                  f"{row['bound_by']}, library {row['library_ms']})")
    print(f"small path, card vs CPU: max_abs_err {check_small_path(torch, dev):.3e}")

    # ---- main path: full-width model=tensorf training + test eval ----
    shutil.rmtree(LOG_DIR, ignore_errors=True)
    cfg = config.compose([
        "model=tensorf", "dataset=synthetic_sphere", "device=cuda",
        "model.params.n_iters=300", "field.upsamp_list=[150]",
        "model.arch.sampler.update_list=[100,200]",
        f"basedir={LOG_DIR}", "expname=tensorf", "progress_refresh_rate=50"])
    for k in kernels:
        k["kernel"].launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    nmf, res = reconstruction(cfg, log=lambda s: print(f"  {s}"))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k["name"]: k["kernel"].launches for k in kernels}
    print(f"main path: {wall:.1f} s, launches {launches}, results {res}")
    if not math.isfinite(res.get("loss", float("nan"))):
        fail(f"training loss is not finite: {res.get('loss')}")
    for kname, n in launches.items():
        if n <= 0:
            fail(f"kernel {kname} was not launched on the main path")
    if not res.get("psnr", 0.0) > PSNR_BAR:
        fail(f"test PSNR {res.get('psnr')} <= {PSNR_BAR} dB")
    print(f"tensorf 300 iters on {card}: train {res['rays_per_sec']:.0f} "
          f"rays/s, test PSNR {res['psnr']:.2f} dB, SSIM {res['ssim']:.4f}")

    line = [{key: v for key, v in k.items() if key != "kernel"}
            | {"launches": launches[k["name"]]} for k in kernels]
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
