#!/usr/bin/env python3
"""Drive nmf_tpu_torch on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

1. Device: the card's name and power limit, torch's CUDA version, and
   scripts/collect_env.py's report.
2. Build: compiles the CUDA kernels of nmf_tpu_torch/csrc with nvcc.
3. Kernels: times an empty kernel's launch from the composite library
   back to back (the launch floor). Holds each kernel against its plain
   PyTorch version at the main paths' shapes and times the kernel alone,
   its wrapper, the plain version and, for binsum, the one-call yardstick
   ``index_add_`` (which the port never calls). composite (K1/K2) at the
   tensorf step (B = 4096 rays x K = 192 samples, weights-only and full
   mode) and the flagship's passes (4096 x 192 forward only, 4096 x 96,
   1024 x 96, the retrace pass after its proposal 1024 x 48), held at
   ragged shapes (K = 1, 33, 1024); binsum (K3) at
   every shape and dtype of both paths (``binsum_cases``: field planes and
   lines in bf16, the flagship's bounce-ray parent gathers, segment sums,
   envmap SAT corners and retrace rows in f32), each also timed as the
   whole call the step makes (``TakeRows.backward``: cotangent in, table-
   dtype gradient out) beside ``zeros + index_add_`` on ``vals.float()``.
   Device times from the profiler, L2-warm (the same buffers again and
   again) and L2-cold (rotating over copies that fill the L2 four times),
   are read after the main paths. Every launch of a main path is counted
   by its sizes and dtype, and the run fails if a main path launched a
   kernel at sizes that were not held here. K3 is also held and timed
   L2-cold on the ids of every launch of two flagship steps (one before
   the upsample, one after), recorded during the main path.
   Then runs one train step and one eval render of a tiny model=tensorf
   and a tiny model=microfacet_tensorf2 on the card and on the CPU (the
   plain versions) and compares the loss, the image and every gradient;
   so for the tiny tensorf with each TensorVMSplit option (the init
   modes, relu / exp / identity, dbasis without the smoothed normals,
   contract_space) and the MLPRender_PE head, and for the tiny flagship
   on the grid field and with autograd normals; then an eval render of a
   ListRF of two tiny grid fields, 5 density pretraining iterations, the
   field.calibrate solve and one streaming render, card against CPU; then
   5 steps of pano2env's fit at resolution 16 (the first step's loss,
   gradients and Adam moments), one render_path frame, two alternating
   dual-scene steps (the loss, every gradient, the inactive envmap's
   update) and collect_ray_debug of the tiny flagship, card against CPU;
   then the tiny flagship with each Microfacet option of the extras slice
   (visibility, bright rays, Russian roulette, the detached normals,
   detach_inter, each mixing mode and BRDF sampler, grown budgets) and
   with every loss extra, clip and weight decay (the first Adam moments
   too), card against CPU; a tiny run whose budget controller must grow
   the budgets at step 15; and ``python -m nmf_tpu_torch.train -m`` with
   two tiny jobs, which must write two run folders; then the tiny
   flagship with each knob of the budgets slice (hdr with the HDR and
   Linear curves, bf16 MLP operands, superstep 0 / 2 / 8, no fine alpha
   test, two-stage and merged shading, the retrace proposal with the
   annealed pad), card against CPU; then the tiny flagship with each knob
   of the heads slice (every direction encoder as the material head's
   view and roughness encoder, pospe, the Hydra, MLP and passthrough
   material heads, dotpe 0 / 2, sigexp, the envmap's softplus / clip /
   identity activations and sh_grad), the tiny Ref-NeRF with every
   reflection encoder, and the Specular module alone (at num_layers 0
   and 1), card against CPU; then one fit_field step to a tiny grid and
   a tiny hash field (the loss, every gradient and Adam moment),
   density_volume at reso 64, graph_brdfs of the tiny flagship at res
   16, the optics functions, the LearnableSphericalEncoding with its
   gradients and LHyperGeom, card against CPU. K3 is also held and
   timed at C = 1 (Russian roulette's retrace counts, N = 1,024 into the
   flagship's 393,216 samples).
   The tiny checks run beside the main paths.
4-21. The main paths run in three processes at once on the card (lanes,
   LANES: a step is bound by the host's launches, so the lanes fill
   each other's idle time), each lane's paths in turn: sphere (paths 4,
   22, 18, 11, 20, 17, 15), studio (7, 5, 6, 8, 9, 13, 10) and fields
   (21, 14, 16, 19, 12). Two more processes generate the scenes of paths 5, 10,
   19 and 12 on the host. Each path's kernel counts are its lane's.
   A launch at a size that the kernel checks did not hold is held after
   every lane is done, on the ids it launched with (below).
4. Main paths, at the shipped widths on synthetic_sphere: model=tensorf
   (128^3 grid, 16/24 components, app_dim 24, featureC 128, 4096 rays x
   192 samples) for 300 iterations through one upsample to 300^3 and two
   alpha-mask rebuilds; then model=microfacet_tensorf2 (the same field
   with normals, envmap 512 x 1024, 192 / 96 / 96 samples a ray, bounce
   budgets [65536, 16384], 1024 retrace rays, batch 4096: the controller
   may move it within [4096, 8192] towards 200,000 valid samples a step,
   and at the ~72 valid samples a ray of this scene it stays at 4096) for
   450 iterations through one upsample. Each evaluates the test views and
   fails unless the loss is finite, every kernel was launched on it and
   the test PSNR > 17 dB. tensorf runs with log_rays=true: its final
   eval's rays.pkl must hold one bundle of at most 512 rays with finite
   weights (their K1 launch, 512 x the whole march, held after the path).
   The flagship runs with render_path=true: the 60 orbit frames of 64^2
   (radius 4 at -30 degrees, the sphere's camera ring) must average
   > 17 dB against the analytic sphere on the same rays, and path.gif
   must hold 60 frames.
5. The studio path: model=microfacet_tensorf2 at the same widths on
   synthetic_studio (hemisphere cameras, 24 views of 128^2, generated on
   the host and timed) with the studio 8k arms' knobs: fixed-shape field
   (planes padded to 300^2 from step 0), lr_upsample_reset=false,
   distortion 1e-3, batch 4096. 1000 iterations paused by stop_iter at
   850 and resumed from the _latest.th to the end, through the arms'
   schedule scaled to 1000 iterations (seven upsamples to 300^3 and five
   mask rebuilds, one of each after the pause), the final checkpoint,
   the final eval
   (PSNR, SSIM, norm_err, tint_psnr, envmap_psnr), then render_only on
   the checkpoint, which must reproduce the eval's PSNR within 0.1 dB.
   K3 is held and timed on the ids of two of its steps, as for the
   flagship.
6. The Blender path: the studio scene (from the generator's memo) written
   in nerf_synthetic layout where dataset=lego looks for it
   (log/chip_smoke/data/nerf_synthetic/lego: RGBA, normal and tint PNGs,
   transforms with camera_angle_x and the generator's camera-to-world
   matrices) with its panorama as backgrounds/lego_bg.exr; host checks
   (rays within 1e-5 of the generator's, RGBA within 1/255, the EXR bit-
   equal to the panorama, the loader's seconds); then the trainer on
   dataset=lego with only datadir, near_far and stack_norms overridden and
   the studio knobs, resumed from the studio path's pause checkpoint at
   850 and trained to 1000 on the same random streams, the final eval's
   envmap metrics against the EXR and pano.exr written. Its test PSNR must
   clear 17 dB and land within 0.5 dB of the studio path's.
7. The lego-size load: 100 train views of 800^2 RGBA (the sphere
   generator's, alpha from its hit mask) and 4 test views written, loaded
   by the trainer with dataset=lego's yaml and put on the card (64M rays,
   2.56 GB); prints the load's seconds, traced host peak and the store's
   bytes; 10 full-width flagship steps from that store (cut from 20),
   finite loss.
8. The relight path, on the studio path's final checkpoint: pano2env's fit
   at its CLI defaults (1024 x 2048 texels, 1000 iterations of 65,536
   pixels) of the Blender path's lego_bg.exr, mirrored left to right
   (pano2env reads a panorama mirrored against the gt_bg convention,
   ROADMAP C.9); K3 at the fit's size (N = 262,144, C = 12, R = 2,419,968)
   held after the path and timed L2-cold beside zeros + index_add_. Then
   render_only fixed_bg= the checkpoint's own envmap written as an envmap
   file, which must reproduce the studio render_only within 0.1 dB, and
   fixed_bg= the fit, whose envmap_psnr must beat the learned envmap's.
9. The compose path: scripts/compose_scenes.py with the studio checkpoint
   twice at x = -1 and +1, relit by the fit, 8 frames of 64^2: finite,
   not blank, K1 launched.
10. The dual-scene path: train_dualbg on two scenes of one object under two
   lights (dataset=lego and its studio scene with the environment turned
   by 180 degrees, written as nerf_synthetic/lego2 with lego2_bg.exr), the
   flagship at its shipped widths with the studio knobs, 600 iterations
   (the upsample at 300, the mask rebuild at 450); both test splits must
   clear 17 dB, a dual checkpoint must be written (the port refuses to
   reload it, as nmf_tpu cannot either), and each envmap's envmap_psnr
   against its panorama is printed.
11. The occupancy-grid path: model=microfacet_tensorf (128^3 occupancy
   grid, multiplier 2, the normal MLP) at its shipped widths on
   synthetic_sphere, 450 iterations (cut from 600) through an upsample at
   225 and a shrink tick at 300 (threshold 0.05); prints the occupied share after
   every sweep and what the shrink did to the box (on this scene it crops
   a few voxels off a face in some runs and keeps the box in others).
   Then the crop, forced as nmf_tpu's own shrink test forces it: the
   grid set to a block around the sphere, the 300^3 field shrunk to its
   bounds, written as a resume checkpoint, and 50 more steps resumed
   from it through the trainer and the test eval on the cropped field.
12. The LLFF path: a forward-facing sphere scene in fern's layout and size
   (20 views of 4032 x 3024 PNG, poses_bounds.npy) written and checked on
   the host as the loader reads it (4x area downsample, NDC rays), then
   dataset=llff_fern with the default model for 600 iterations. Its bar
   is the test PSNR of the first test view rendered with NDC rays; the
   final eval's of that view (world rays, as nmf_tpu's) is printed beside
   it (one of the three test views: a cut for the script's time).
13. The Ref-NeRF studio path: model=refnerf with the refnerf 8k arm's
   field and model (the studio knobs) on the studio path's scene, 400
   iterations (cut from 1000 for the script's time) without a pause;
   PSNR, SSIM, norm_err and tint_psnr beside the flagship studio path's.
14. The hash-grid path: model=refnerf_tcnn field=hashgrid at the shipped
   widths (16 levels of 2^19 x 2 tables, the 128^3 occupancy grid at its
   shipped threshold, 3,542 march steps a ray) on synthetic_sphere, 600
   iterations, geonorm_interp_iters 400: the normal blend printed at
   iterations 0, 100, 300, 500 and 599 (it must read 0 and 1), the
   occupied share after every sweep (not held to anything), the card's
   peak allocated memory and K3's launches on the hash tables.
15. The dual path: model=microfacet_dualref on synthetic_sphere, 600
   iterations, the switch to the microfacet model at 300: it must be the
   run's first schedule event, with an optimizer rebuild, Ref-NeRF must
   shade retrace passes and K1 must launch at the retrace shape 1024 x 96.
16. The grid path: model=microfacet_tensorf2 field=grid at grid.yaml's
   widths (a 2,097,152-row table of 28 f32 columns) and the flagship's
   samples and budgets on synthetic_sphere: the first 600 iterations of
   the shipped 30,000-iteration schedule, paused, then render_only on the
   pause checkpoint; the card's peak memory, K3's launches and L2-cold
   time on the grid table beside zeros + index_add_ and its bound.
17. The tensorf_pe path: model=tensorf with the MLPRender_PE head, dbasis
   and 100 density pretraining iterations (their mean alpha printed
   beside start_density), at the tensorf path's widths and cut (the first
   300 iterations of the 30,000-iteration schedule, paused; the upsample
   at 150, rebuilds at 100 and 200), its pause checkpoint rendered in
   batch and streamed (render_only stream=true, K1 in full mode a block):
   the two within 0.1 dB; the streaming eval's seconds and blocks.
18. The extras path: model=microfacet_tensorf2 at
   its shipped widths on synthetic_sphere with every knob of the extras
   slice on (the visibility MLP, bright rays at percent_bright 0.5,
   Russian roulette, detach_N_iters 100, detach_inter, the ori / pred
   decays, the Charbonier loss, the envmap TV, the normal error, weight
   decay 1e-6 and the budget controller), 450 iterations, the upsample at
   half, no rebuild; it prints the budget multiplier's transitions, the
   visibility loss and the bright-ray share, and fails unless the
   normals' detach ends in a schedule event at iteration 100. Its
   launches at the grown budgets' sizes are held after it.
19. The hdr path: the studio scene's linear radiance
   (the generator's, before the sRGB curve; the share of the foreground
   past 1 is printed), 24 + 8 views of 128^2 written as EXR frames in
   nerf_synthetic layout by a scene worker, through
   dataset=materials_hdr with datadir set; the flagship at its shipped
   widths with hdr (the Huber loss, the unclipped HDR curve), bf16 MLP
   operands, superstep 8 and no fine alpha test, on the studio knobs: the
   first 300 iterations of their 1000-iteration schedule, paused, then
   render_only on the pause checkpoint, which writes an EXR of each test
   view's rgb_map, read back equal to the map it rendered.
20. The budgets path: the flagship at its shipped widths on
   synthetic_sphere with merge_runs 32, the retrace proposal (48 of the
   retrace pass's 96 samples) and the pad annealed from 0.5 to 0.01 over
   133 iterations: the first 200 iterations of a 1000-iteration schedule
   (the upsample at 100, no rebuild), paused, the pad printed at each
   tenth, the model evaluated; then the pause checkpoint's config switched
   to app_samples_per_ray 48 (two-stage) and 50 more steps resumed,
   paused and evaluated. Both must clear 17 dB; at full width, the
   two-stage render's acc_map of a test view must equal the full
   render's, and setting both knobs must warn.
21. The heads path: the flagship at its shipped widths on
   synthetic_sphere with the shading heads' knobs: the material head's
   view encoder IPE (degree 4; the target builds PE, as in nmf_tpu), its
   roughness encoder RandRotISH (a degree-8 ListISH core and four rotated
   degree-8 copies) and pospe 4; the BRDF's dot products and their IPE
   (dotpe 2), sigexp and a degree-8 diffuse-vector encoder; the softplus
   envmap with sh_grad (the SH projection's lookups take the diffuse
   term's gradient: K3 at N = 20,000, C = 12, R = 691,456, held after the
   lanes and timed L2-cold beside zeros + index_add_) and mipnoise 0.1
   (no path draws its noise, ROADMAP C.12); 450 iterations, the upsample
   at half, no rebuild. It prints the envmap's gradient norm at the first
   step, which must be finite and above 0.
22. The distill path, on the tensorf path's final checkpoint (300^3):
   scripts/reeval.py on the tensorf run's dumped test PNGs (within 0.1 dB
   of its eval), then scripts/fit_field.py at its CLI defaults (2,000
   steps of 65,536 points, lr 1e-2) to the dense grid (128^3: K3 at N =
   524,288, C = 28, R = 2,097,152) and, cut to 1,000 steps, to the hash
   field (16 x 2^19 x 2: K3 at N = 8,388,608, C = 2, R = 8,388,608), one
   launch a step each (density and appearance share one gather), both
   sizes held after the
   lanes on the ids they launched with and timed L2-cold beside zeros +
   index_add_; every logged loss finite, the mean |density feature
   error| on 65,536 held points after the fit at most half of it
   before, each file reloaded as its field type; render_only of each
   distilled checkpoint (their test PSNRs printed beside the source's,
   not held to 17 dB: a distilled field under it is a finding); then
   scripts/export_mesh.py of all three (the source at reso 256, the
   distilled fields cut to 192), at the level where one march step of
   the field absorbs 10% (the default level 5 lies inside the learned
   shell, ROADMAP C.17), each mesh's outer surface
   (its outermost vertex in each of 16 x 32 direction bins, 90% of them
   held) at a median radius within 0.1 of the sphere's 0.8.
   Every K1 / K2 / K3 launch of paths 8 to 22 must be at a size held
   by the kernel checks or held after the lanes on the ids it launched
   with; paths 8 to 21 must clear 17 dB.
23. The bench path, after the lanes (alone on the card): the measurement
   scripts of nmf_tpu_torch/scripts at nmf_tpu's sizes. bench_scatter:
   the alpha-mask lookups (M = 4096 x 440 at G = 32, 128, 200, every
   variant reading the scalar gather's values); the scatter variants on
   bf16 payloads (plain index_add_, sort + index_add_, chunk-combine),
   each within twice plain index_add_'s error (or 2^-8) of the f32 sum;
   K3 against zeros + index_add_ at N = 262,144 (C = 288, R = 90,000 and
   C = 12, R = 691,456, uniform and hot ids: 90% on 64 rows), within 1e-5
   of the largest sum. bench_gather (3 planes of 72 x 300^2, 4096 x 128
   queries, bf16; the rows layout's backward is K3 at N = 524,288, C =
   72). bench_shade on its flagship (grid 128, envmap 512, 128 / 64
   samples, budgets (32768, 8192), 1024 retrace rays): K1 / K2 at 4096 x
   128 beside raw2alpha, compaction, the alpha lookup, the stub shade at
   M = 524,288 (K3 at the bench budgets), the secondary render (K1 at
   1024 x 64). bisect_shade: stage 0's loss and gradients against the
   unpatched step on the same draws (within twice the step's own spread
   between two runs, or 1e-5 of the loss and 1e-4 of a gradient's largest
   entry), then stages 0-7, -1 and -2 timed; parse_trace on a Chrome
   trace of three bisect steps within 5% of the profiler's own device
   time. Its launches at sizes the checks did not hold are held after it
   (hold_new_sizes; K1 / K2 timed; the bounce rays' K3 sizes, where the
   random-init model allocates no ray, on walk ids).

Prints one JSON line of kernel numbers and, as its last line,
{"ok": true, "device": {...}}. Without a CUDA device, or run outside the
repository, it exits non-zero and prints no result.
"""
import contextlib
import itertools
import json
import math
import multiprocessing
import os
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LOG_DIR = ROOT / "log" / "chip_smoke"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
L2_BYTES = 50 * 2**20       # H100 SXM L2
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


def best_ms(torch, fn, repeats=3, iters=30):
    """The least of ``repeats`` time_ms readings: a call that the host
    launches (a wrapper, its yardstick) reads high whenever the host stalls
    during one of them."""
    return min(time_ms(torch, fn, iters=iters) for _ in range(repeats))


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


def device_ms(torch, fn, kernel, iters=100, tries=3):
    """Mean device time of one launch of the kernels whose name holds
    ``kernel``, over ``iters`` calls of fn, from the profiler's CUDA trace
    (no host gaps between launches in it). A trace can come back without
    the kernels: up to ``tries`` traces, then None."""
    from torch.profiler import ProfilerActivity, profile

    from nmf_tpu_torch.scripts.profile_step import device_time_us

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = count = 0
        for evt in prof.key_averages():
            if evt.device_type.name == "CUDA" and kernel in evt.key:
                total += device_time_us(evt)
                count += evt.count
        if count and total > 0:
            return total / count / 1e3
    return None


class Launcher:
    """Launches a C entry on each of its buffer sets in turn, with the
    arguments made once, so a launch's host work is the ctypes call, as for
    the launch floor. It holds the sets: their memory stays theirs for as
    long as the launcher lives, whatever runs in between."""

    def __init__(self, entry, sets, tail):
        from nmf_tpu_torch.ops.kernels.build import ptr

        self.entry, self.sets = entry, sets
        self.args = itertools.cycle([(*map(ptr, s), *tail) for s in sets])

    def __call__(self):
        self.entry(*next(self.args))


def launchers(entry, buffers, tail):
    """(warm, cold) launchers of ``entry``: warm on ``buffers`` every time,
    so they stay in the L2; cold rotating over copies of them that together
    fill the L2 four times, so a launch finds its buffers in device memory,
    as the HBM bound assumes."""
    n_bytes = sum(t.nbytes for t in buffers if t is not None)
    copies = [tuple(None if t is None else t.clone() for t in buffers)
              for _ in range(max(2, math.ceil(4 * L2_BYTES / n_bytes)))]
    return (Launcher(entry, [buffers], tail),
            Launcher(entry, copies, tail))


def composite_inputs(torch, dev, B, K, gen):
    """Densities and spacings like the train step's (dists scaled by
    distance_scale 25). A quarter of the rays opaque: sigma * dist up to
    60, where the transmittance underflows. A quarter thin: an optical
    depth of ~4 over the whole ray, so T stays far above the tolerances to
    the last sample and every tile carry shows."""
    sigma = torch.rand((B, K), generator=gen, device=dev) * 40
    dists = 0.05 + 0.3 * torch.rand((B, K), generator=gen, device=dev)
    sigma[: B // 4] *= 4
    sigma[B // 2: 3 * B // 4] /= K
    sigma[:, 3::7] = 0  # empty samples
    rgb = torch.rand((B, K, 3), generator=gen, device=dev)
    z = torch.cumsum(dists, dim=1) / 25 + 2.5
    return sigma, dists, rgb, z


def composite_case(torch, dev, gen, deferred, B, K, full, backward, timed):
    """K1 (and K2 if ``backward``) at one shape, in full mode (rgb, z and
    all four cotangents) or weights-only, held against the plain version
    and, if ``timed``, timed. Returns the K1 row and the K2 row (None
    without ``backward``); appends (row, warm launcher, cold launcher,
    kernel name) to ``deferred`` for the device times."""
    from nmf_tpu_torch.ops.kernels import composite as C

    sigma, dists, rgb, z = composite_inputs(torch, dev, B, K, gen)
    inputs = (sigma, dists, rgb, z) if full else (sigma, dists)
    fn, plain = ((C.composite_rays, C.composite_rays_plain) if full else
                 (C.transmittance_weights, C.transmittance_weights_plain))
    cots = (torch.randn((B, K), generator=gen, device=dev),
            torch.randn((B, 3), generator=gen, device=dev),
            torch.randn((B,), generator=gen, device=dev),
            torch.randn((B,), generator=gen, device=dev))[:4 if full else 1]

    def outputs(f, need=None):
        """f's outputs, every input's leaf copy and the graph; ``need``
        says which inputs take a gradient (all by default)."""
        ts = [t.clone().requires_grad_(need is None or need[i])
              for i, t in enumerate(inputs)]
        outs = f(*ts)
        return (outs if isinstance(outs, tuple) else (outs,)), ts

    shape = f"B={B} K={K} {'full' if full else 'weights-only'}"
    sizes = (B, K)
    runs = [outputs(f) for f in (fn, plain)]
    # T is a product of up to K factors, rounded in another order than the
    # plain cumprod's: 1e-5 relative plus 1e-6
    fwd = {"shape": shape, "sizes": sizes, "max_abs_err": max_err(
        torch, [(a.detach(), b.detach()) for a, b in
                zip(runs[0][0], runs[1][0])],
        1e-5, 1e-6, f"composite forward {shape}")}
    bwd = None
    if backward:
        # every input's gradient; the reverse scan without division against
        # cumprod's autograd: 1e-4 relative plus 1e-5 on unit cotangents
        grads = [torch.autograd.grad(outs, ts, cots) for outs, ts in runs]
        bwd = {"shape": shape, "sizes": sizes, "max_abs_err": max_err(
            torch, list(zip(*grads)), 1e-4, 1e-5,
            f"composite backward {shape}")}
    torch.cuda.synchronize()
    if not timed:
        return fwd, bwd

    # The kernel: back-to-back launches of the C entry on preallocated
    # buffers (CUDA events: the host's launch rate included), L2-warm and
    # L2-cold, and its device time alone from the profiler. The wrapper and
    # the plain version: as the render calls them (weights-only: sigma
    # takes a gradient, the sampler's dists do not), L2-warm. Bounds: each
    # input read once, each output written once.
    stream = torch.cuda.current_stream(dev).cuda_stream
    n = B * K
    opt = (rgb, z) if full else (None, None)
    maps = ((sigma.new_empty((B, 3)), sigma.new_empty((B,)),
             sigma.new_empty((B,))) if full else (None, None, None))
    warm, cold = launchers(C.COMPOSITE_FWD, (
        sigma, dists, *opt, torch.empty_like(sigma), *maps), (B, K, stream))

    with torch.no_grad():
        fwd |= {"ms": time_ms(torch, warm, iters=100),
                "cold_ms": time_ms(torch, cold, iters=100),
                "wrapper_ms": time_ms(torch, lambda: fn(*inputs)),
                "plain_ms": time_ms(torch, lambda: plain(*inputs))}
    # read sigma, dists (+ rgb, z); write w (+ rgb_map, acc, depth)
    b, by = bound_ms(4 * n * (7 if full else 3) + (20 * B if full else 0),
                     (16 if full else 6) * n)
    fwd |= {"bound_ms": b, "bound_by": by, "library_ms": None}
    deferred.append((fwd, warm, cold, "composite_fwd_kernel"))
    if not backward:
        return fwd, bwd

    d_opt = ((torch.empty_like(dists), torch.empty_like(rgb),
              torch.empty_like(z)) if full else (None, None, None))
    g_opt = cots[1:] if full else (None, None, None)
    warm, cold = launchers(C.COMPOSITE_BWD, (
        sigma, dists, *opt, cots[0], *g_opt, torch.empty_like(sigma),
        *d_opt), (B, K, stream))

    need = [True] * 4 if full else [True, False]
    timed_runs = [outputs(f, need) for f in (fn, plain)]

    def grad_of(outs, ts):
        return lambda: torch.autograd.grad(
            outs, [t for t in ts if t.requires_grad], cots,
            retain_graph=True)

    bwd |= {"ms": time_ms(torch, warm, iters=100),
            "cold_ms": time_ms(torch, cold, iters=100),
            "wrapper_ms": time_ms(torch, grad_of(*timed_runs[0])),
            "plain_ms": time_ms(torch, grad_of(*timed_runs[1]))}
    # read sigma, dists, g_w (+ rgb, z, g_rgb, g_acc, g_depth); write
    # d_sigma (+ d_dists, d_rgb, d_z)
    b, by = bound_ms(4 * n * (13 if full else 4) + (20 * B if full else 0),
                     (30 if full else 16) * n)
    bwd |= {"bound_ms": b, "bound_by": by, "library_ms": None}
    deferred.append((bwd, warm, cold, "composite_bwd_kernel"))
    return fwd, bwd


# The flagship main path's batch: the controller asks for 200,000 valid
# samples a step, ~2,800 rays at its ~72 valid samples a ray, and clips
# that up to its 4096 minimum
FLAGSHIP_B = 4096

# (B, K, full, backward, timed): K1/K2 at every shape the main paths launch
# them with: the tensorf train step and the flagship's proposal pass
# (forward only) at 4096 x 192; the flagship's primary pass after
# resampling and its retrace pass, weights-only; the retrace pass after
# its proposal (the budgets path, 1024 x 48); the streaming eval's blocks
# (a chunk of 4096 rays x 64 samples, full mode, forward only). Then
# ragged shapes, checked in both modes and not timed.
COMPOSITE_CASES = (
    [(4096, 192, False, True, True), (4096, 192, True, True, True),
     (FLAGSHIP_B, 96, False, True, True), (1024, 96, False, True, True),
     (1024, 48, False, True, True), (4096, 64, True, False, True)]
    + [(B, K, full, True, False) for B, K in ((1000, 1), (1000, 33),
                                               (257, 1024))
       for full in (False, True)])


def check_composite(torch, dev, gen, deferred):
    """K1 and K2 at every case of COMPOSITE_CASES. Each kernel's line
    reports the first (the train step's weights-only entry); every shape
    is in ``shapes``."""
    from nmf_tpu_torch.ops.kernels import composite as C

    fwd_rows, bwd_rows = [], []
    for case in COMPOSITE_CASES:
        fwd, bwd = composite_case(torch, dev, gen, deferred, *case)
        fwd_rows.append(fwd)
        if bwd is not None:
            bwd_rows.append(bwd)
    return [
        {"name": "composite_fwd", "route": "cuda",
         "source": "nmf_tpu_torch/csrc/composite.cu",
         "replaces": "nmf_tpu/ops/pallas/composite.py:28",
         "kernel": C.COMPOSITE_FWD} | fwd_rows[0] | {"shapes": fwd_rows},
        {"name": "composite_bwd", "route": "cuda",
         "source": "nmf_tpu_torch/csrc/composite.cu",
         "replaces": "nmf_tpu/ops/pallas/composite.py:51",
         "kernel": C.COMPOSITE_BWD} | bwd_rows[0] | {"shapes": bwd_rows},
    ]


def launch_floor(torch, dev, deferred):
    """Back-to-back time of an empty kernel's launch from the composite
    library (CUDA events): the floor the composite kernels' times and
    bounds are read against. Its device time is deferred."""
    import ctypes

    from nmf_tpu_torch.ops.kernels.build import CudaKernel

    empty = CudaKernel("composite.cu", "composite_empty", [ctypes.c_void_p])
    stream = torch.cuda.current_stream(dev).cuda_stream
    row = {"ms": time_ms(torch, lambda: empty(stream), iters=100)}
    deferred.append((row, lambda: empty(stream), None, "empty_kernel"))
    return row


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


def parent_ids(torch, dev, gen, N, R):
    """Row ids as the bounce-ray parent gather's backward and the segment
    sums see them: sorted, in runs of 1-32 rays a parent sample."""
    runs = torch.randint(1, 33, (N,), generator=gen, device=dev)
    parents = torch.sort(torch.randperm(R, generator=gen, device=dev)[:N])[0]
    return torch.repeat_interleave(parents, runs)[:N]


def walk_ids(torch, dev, gen, N, R, K=96):
    """N row ids for a size known only at run time: walks of K ids from
    random starts, moving to the next row every ~11 samples (as
    ``plane_ids`` along a plane's row), wrapped into R rows."""
    n = -(-N // K)
    start = torch.randint(0, R, (n, 1), generator=gen, device=dev)
    moves = torch.rand((n, K), generator=gen, device=dev) < 1 / 11
    return ((start + torch.cumsum(moves, dim=1)) % R).reshape(-1)[:N]


def binsum_inputs(torch, dev, gen, ids, R, C, dtype):
    """(idx, vals) from ray-walk ids, vals in ``dtype``; 1% of the rows are
    out of range (dropped)."""
    idx = ids.reshape(-1).to(torch.int32)
    out = torch.rand(idx.shape, generator=gen, device=dev) < 0.01
    idx[out] = R + 7
    vals = torch.randn((idx.numel(), C), generator=gen, device=dev)
    return idx, vals.to(dtype)


def binsum_cases(torch, dev, gen):
    """(what, R, C, ids, dtype, caller) of every shape the two main paths
    launch K3 with; ``caller`` is ``TakeRows`` (a gather's backward: the
    cotangent arrives in the table's dtype) or ``segment sum`` (f32).

    tensorf (six launches a step): the three planes (C = 4 x 40 quad-table
    channels) at 128^2 and, after the upsample, 300^2 texels; the three
    lines (C = 2 x 40) at 128 and 300 cells, where every id collides
    thousands of times; bf16, the field's gather dtype. The flagship
    (twenty a step): its field at 4096 rays x 96 samples and the retrace
    field at 1024 x 96 (planes C = 4 x 72, lines C = 2 x 56, before and
    after the upsample; bf16); the parent-gather backward (C = 44) and the
    segment sums (C = 9) of the 65,536 and 16,384 bounce rays onto 393,216
    and 98,304 samples; the envmap SAT corners' backward (C = 12, 4 rows a
    lookup into the 592 x 1168 table) for the 65,536 and 16,384 bounce rays
    and the retrace rays' background; the retrace rows (C = 6); with
    Russian roulette (the extras path), the retrace count of each sample
    (C = 1, the parents of the 1,024 retraced rays); f32."""
    bf16, f32 = torch.bfloat16, torch.float32
    sat = 592 * 1168
    M = FLAGSHIP_B * 96
    flagship_field = [
        (f"flagship {what}plane", n * n, 288,
         plane_ids(torch, dev, gen, n, n, B, 96), bf16, "TakeRows")
        for what, B in (("", FLAGSHIP_B), ("retrace ", 1024))
        for n in (128, 300)] + [
        (f"flagship {what}line", n, 112,
         line_ids(torch, dev, gen, n, B, 96), bf16, "TakeRows")
        for what, B in (("", FLAGSHIP_B), ("retrace ", 1024))
        for n in (128, 300)]
    return [
        ("tensorf plane", 128 * 128, 160,
         plane_ids(torch, dev, gen, 128, 128), bf16, "TakeRows"),
        ("tensorf plane", 300 * 300, 160,
         plane_ids(torch, dev, gen, 300, 300), bf16, "TakeRows"),
        ("tensorf line", 128, 80, line_ids(torch, dev, gen, 128), bf16,
         "TakeRows"),
        ("tensorf line", 300, 80, line_ids(torch, dev, gen, 300), bf16,
         "TakeRows"),
        *flagship_field,
        ("flagship parent gather", M, 44,
         parent_ids(torch, dev, gen, 65536, M), f32, "TakeRows"),
        ("flagship retrace parent gather", 1024 * 96, 44,
         parent_ids(torch, dev, gen, 16384, 1024 * 96), f32, "TakeRows"),
        ("flagship segment sum", M, 9,
         parent_ids(torch, dev, gen, 65536, M), f32, "segment sum"),
        ("flagship retrace segment sum", 1024 * 96, 9,
         parent_ids(torch, dev, gen, 16384, 1024 * 96), f32, "segment sum"),
        *[(f"flagship SAT corners, {n} lookups", sat, 12,
           torch.randint(0, sat, (4 * n,), generator=gen, device=dev), f32,
           "TakeRows")
          for n in (65536, 16384, 1024)],
        ("flagship retrace rows", 65536, 6,
         torch.randperm(65536, generator=gen, device=dev)[:1024], f32,
         "TakeRows"),
        # Russian roulette's retrace count a sample: one f32 column, the
        # parents of the 1,024 retraced rays
        ("flagship retrace counts (Russian roulette)", M, 1,
         torch.randint(0, M, (1024,), generator=gen, device=dev), f32,
         "segment sum"),
    ]


def binsum_tolerance(S, idx, vals, R):
    """Atomics add in a varying order, and so does index_add_: the two f32
    sums of a row differ by rounding that grows with the row's sum of
    |vals| (~48 unit-scale rows meet per plane texel, ~2,600 to ~6,000 per
    line cell): 1e-4 relative plus 1e-4 plus 1e-6 of that absolute sum."""
    return 1e-4, 1e-4 + 1e-6 * S.binsum_rows_plain(idx, vals.abs(), R)


def binsum_whole_call(torch, S, caller, idx_call, vals, R):
    """What the step pays for K3, from cotangent in to gradient out, and
    its yardstick ``zeros((R, C), f32).index_add_(0, idx, vals.float())``.
    ``TakeRows``: its backward (the kernel on the cotangent as it comes,
    the cast of the f32 sum back to the table's dtype) on in-range ids; a
    segment sum: the wrapper on the ids it is given (the yardstick's
    out-of-range rows are dropped before it is timed)."""
    import types

    from nmf_tpu_torch.ops.grid_sample import TakeRows

    if caller == "TakeRows":
        ctx = types.SimpleNamespace(saved_tensors=(idx_call,), num_rows=R)
        call = lambda: TakeRows.backward(ctx, vals)  # noqa: E731
        lib_idx, lib_vals = idx_call.long(), vals
    else:
        call = lambda: S.binsum_rows(idx_call, vals, R)  # noqa: E731
        keep = (idx_call >= 0) & (idx_call < R)
        lib_idx, lib_vals = idx_call[keep].long(), vals[keep]
    return best_ms(torch, call), best_ms(torch, lambda: torch.zeros(
        (R, vals.shape[1]), device=vals.device).index_add_(
            0, lib_idx, lib_vals.float()))


def binsum_bounds(vals, R, touched):
    """The kernel's bound (ids, vals in their dtype, the rows it touches)
    and the wrapper's (the whole (R, C) output, as its memset writes it)."""
    N, C = vals.shape
    return (bound_ms(4 * N + vals.nbytes + 4 * touched * C, N * C),
            bound_ms(4 * N + vals.nbytes + 4 * R * C, N * C)[0])


def check_binsum(torch, dev, gen, deferred):
    """binsum_rows at every shape of ``binsum_cases``, in the dtype the
    step hands it: held against its plain version and timed (the C entry
    back to back L2-warm and L2-cold, the wrapper, the whole call against
    its ``index_add_`` yardstick, plain, ``index_add_`` on the kernel's
    inputs, the calls the host launches as the best of three readings;
    device time L2-warm and L2-cold deferred). The kernels line
    reports the first shape; every shape is in ``shapes``."""
    from nmf_tpu_torch.ops.kernels import binsum as S
    from nmf_tpu_torch.ops.kernels.build import ptr

    stream = torch.cuda.current_stream(dev).cuda_stream
    shapes = []
    for what, R, C, ids, dtype, caller in binsum_cases(torch, dev, gen):
        idx, vals = binsum_inputs(torch, dev, gen, ids, R, C, dtype)
        N, code = idx.numel(), S.DTYPE_CODES[dtype]
        out = S.binsum_rows(idx, vals, R)
        ref = S.binsum_rows_plain(idx, vals, R)
        rtol, atol = binsum_tolerance(S, idx, vals, R)
        err = max_err(torch, [(out, ref)], rtol, atol,
                      f"binsum {what} R={R} {dtype}")
        keep = (idx >= 0) & (idx < R)
        idx_in, vals_in = idx[keep].long(), vals[keep]
        # the C entry alone (memset and kernel) into one preallocated
        # buffer; the wrapper also allocates a fresh one, as the step does
        out_buf = torch.empty((R, C), device=dev)
        ms = time_ms(torch, lambda: S.BINSUM(
            ptr(idx), ptr(vals), ptr(out_buf), N, C, R, code, stream))
        wrap_ms = best_ms(torch, lambda: S.binsum_rows(idx, vals, R))
        whole_ms, whole_lib_ms = binsum_whole_call(
            torch, S, caller,
            ids.reshape(-1).to(torch.int32) if caller == "TakeRows" else idx,
            vals, R)
        plain_ms = time_ms(torch, lambda: S.binsum_rows_plain(idx, vals, R))
        lib_ms = best_ms(torch, lambda: torch.zeros(
            (R, C), device=dev).index_add_(0, idx_in, vals_in.float()))
        touched = torch.unique(idx_in).numel()
        (b, by), wrap_b = binsum_bounds(vals, R, touched)
        row = {"shape": f"{what} N={N} C={C} R={R} {str(dtype)[6:]}",
               "sizes": (N, C, R, code), "dtype": str(dtype)[6:],
               "caller": caller, "touched_rows": touched,
               "max_abs_err": err, "ms": ms, "wrapper_ms": wrap_ms,
               "whole_ms": whole_ms, "whole_library_ms": whole_lib_ms,
               "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
               "wrapper_bound_ms": wrap_b, "library_ms": lib_ms}
        if dtype != torch.float32:
            # the passes that wrapped the kernel before it read bf16: the
            # f32 copy of the cotangent, and (still paid) the cast back
            row["cast_in_ms"] = time_ms(torch, lambda: vals.float())
            row["cast_out_ms"] = time_ms(torch, lambda: out_buf.to(dtype))
        shapes.append(row)
        warm, cold = launchers(S.BINSUM, (idx, vals, out_buf),
                               (N, C, R, code, stream))
        row["cold_ms"] = time_ms(torch, cold, iters=100)
        deferred.append((row, warm, cold, "binsum"))
        del out, ref, atol, idx_in, vals_in
    first = shapes[0]
    return [{"name": "binsum_rows", "route": "cuda",
             "source": "nmf_tpu_torch/csrc/binsum.cu",
             "replaces": "nmf_tpu/ops/pallas/binsum.py:40",
             "kernel": S.BINSUM} | first | {"shapes": shapes}]


# a K3 launch at a size first seen on a path is held on its recorded ids
# only if they touch at least this many rows (a bounce pass's first step
# can hand it ids that are all out of range, which any kernel "sums")
HELD_MIN_ROWS = 2


class BinsumRecorder:
    """Records the ids of every K3 launch of the train steps numbered in
    ``steps`` (0-based) and, given ``held`` (the (N, C, R, dtype code)
    sizes the kernel's check held), at each size not in it, of its first
    launch whose in-range ids touch HELD_MIN_ROWS rows (until then, of the
    launch that touched most), through a hook around ``binsum_rows`` where
    its callers (``ops.grid_sample``, ``ops.masked`` and the modules
    ``callers``) look it up, and a count of ``trainer.train_step`` calls.
    Entries (``entries``, ``new`` by size): (step, idx copy, C, R, dtype);
    ``touched`` by size: the rows that ``new``'s entry touches."""

    def __init__(self, steps, held=None, callers=()):
        from nmf_tpu_torch import trainer
        from nmf_tpu_torch.ops import grid_sample, masked
        from nmf_tpu_torch.ops.kernels.binsum import DTYPE_CODES

        self.steps, self.step, self.entries = set(steps), -1, []
        self.held, self.new, self.touched = held, {}, {}
        self.codes = DTYPE_CODES
        self.callers = (grid_sample, masked, *callers)
        self.trainer = trainer
        self.binsum, self.train_step = masked.binsum_rows, trainer.train_step

    def __enter__(self):
        def recorded(idx, vals, num_rows):
            def entry():
                return (self.step, idx.clone(), vals.shape[1], num_rows,
                        vals.dtype)

            if self.step in self.steps:
                self.entries.append(entry())
            if self.held is not None:
                size = (idx.numel(), vals.shape[1], num_rows,
                        self.codes[vals.dtype])
                best = self.touched.get(size, -1)
                if size not in self.held and best < HELD_MIN_ROWS:
                    keep = (idx >= 0) & (idx < num_rows)
                    touched = idx[keep].unique().numel()
                    if touched > best:
                        self.new[size], self.touched[size] = entry(), touched
            return self.binsum(idx, vals, num_rows)

        def counted(*args, **kwargs):
            self.step += 1
            return self.train_step(*args, **kwargs)

        for module in self.callers:
            module.binsum_rows = recorded
        self.trainer.train_step = counted
        return self

    def __exit__(self, *exc):
        for module in self.callers:
            module.binsum_rows = self.binsum
        self.trainer.train_step = self.train_step


def replay_binsum(torch, dev, gen, entries, synthetic, deferred=None):
    """K3 on the ids a step launched it with (vals drawn in the dtype it
    got), held against the plain version and timed L2-cold on the device
    (given ``deferred``, later: its launcher joins that list), beside the
    synthetic row of the same sizes and ``index_add_`` on the same inputs.
    Returns the rows."""
    from nmf_tpu_torch.ops.kernels import binsum as S

    stream = torch.cuda.current_stream(dev).cuda_stream
    by_sizes = {r["sizes"]: r for r in synthetic}
    rows = []
    for step, idx, C, R, dtype in entries:
        N, code = idx.numel(), S.DTYPE_CODES[dtype]
        vals = torch.randn((N, C), generator=gen, device=dev).to(dtype)
        rtol, atol = binsum_tolerance(S, idx, vals, R)
        err = max_err(torch, [(S.binsum_rows(idx, vals, R),
                               S.binsum_rows_plain(idx, vals, R))],
                      rtol, atol, f"binsum replayed step {step} N={N} C={C}")
        keep = (idx >= 0) & (idx < R)
        touched = torch.unique(idx[keep]).numel()
        _, cold = launchers(S.BINSUM, (idx, vals, torch.empty((R, C),
                                                              device=dev)),
                            (N, C, R, code, stream))
        synth = by_sizes.get((N, C, R, code), {})
        idx_in, vals_in = idx[keep].long(), vals[keep]
        row = {"step": step, "sizes": (N, C, R, code),
               "dtype": str(dtype)[6:], "touched_rows": touched,
               "runs": int((idx[1:] != idx[:-1]).sum()) + 1,
               "max_abs_err": err,
               "synthetic_device_cold_ms": synth.get("device_cold_ms"),
               "bound_ms": binsum_bounds(vals, R, touched)[0][0],
               "library_ms": best_ms(torch, lambda: torch.zeros(
                   (R, C), device=dev).index_add_(0, idx_in,
                                                  vals_in.float()))}
        if deferred is None:
            row["device_cold_ms"] = device_ms(torch, cold, "binsum")
        else:
            deferred.append((row, None, cold, "binsum"))
        rows.append(row)
        del cold, vals, idx_in, vals_in
    return rows


def step_sums(rows):
    """Per recorded step, the device L2-cold sums of ``replay_binsum``'s
    rows: on the real ids, and on the synthetic ids at the same sizes."""
    sums = {}
    for row in rows:
        total = sums.setdefault(row["step"], {"real": 0.0, "synthetic": 0.0})
        total["real"] += row["device_cold_ms"] or float("nan")
        total["synthetic"] += (row["synthetic_device_cold_ms"]
                               or float("nan"))
    return sums


# the tiny model=tensorf of check_small_path and the module checks
SMALL_TENSORF = [
    "model=tensorf", "dataset=synthetic_sphere", "dataset.image_size=16",
    "dataset.n_views=4", "field.N_voxel_init=4096",
    "field.N_voxel_final=8000", "field.gather_dtype=f32",
    "model.arch.max_samples_per_ray=32",
    "model.arch.model.diffuse_module.featureC=16"]


def check_small_path(torch, dev, extra=(), what="small path"):
    """One train step (loss and every gradient) and one eval render of a
    tiny model=tensorf (with the overrides ``extra``) on the card, against
    the same on the CPU, where the wrappers run the plain versions that
    the CPU tests hold against nmf_tpu. Same seed, rays and jitter on both;
    f32 gathers."""
    from nmf_tpu_torch import config, trainer
    from nmf_tpu_torch.builders import build_nmf
    from nmf_tpu_torch.data import load_dataset
    from nmf_tpu_torch.ops.draws import Draws
    from nmf_tpu_torch.render import render

    cfg = config.compose([*SMALL_TENSORF, *extra])
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
                                       weights, (1.0, 1.0, 1.0),
                                       Draws(None, {"jitter": jitter}))
        loss.backward()
        with torch.no_grad():
            image = render(nmf, rays, is_train=False)[0]["rgb_map"]
        runs.append([loss.detach(), image]
                    + [p.grad for p in nmf.parameters() if p.grad is not None])
    if len(runs[0]) != len(runs[1]) or len(runs[0]) < 10:
        fail(f"{what}: the card and the CPU differentiated other tensors")
    # f32 on both; sums (scatter atomics, matmuls, cumsum) in another order
    pairs = [(a.cpu(), b) for a, b in zip(*runs)]
    err = max_err(torch, pairs[:2], 1e-4, 1e-5, f"{what} loss/render")
    for i, (a, b) in enumerate(pairs[2:]):
        scale = float(b.abs().max())
        err = max(err, max_err(torch, [(a, b)], 1e-3, 1e-4 * scale + 1e-9,
                               f"{what} gradient {i}"))
    return err


# the tiny model=microfacet_tensorf2 of check_small_flagship and the
# module checks
SMALL_FLAGSHIP = [
    "model=microfacet_tensorf2", "dataset=synthetic_sphere",
    "dataset.image_size=16", "dataset.n_views=4",
    "field.N_voxel_init=4096", "field.N_voxel_final=8000",
    "field.upsamp_list=[]", "field.gather_dtype=f32",
    "model.arch.max_samples_per_ray=16",
    "model.arch.recur_samples_per_ray=8",
    "model.arch.proposal_samples_per_ray=8",
    "model.arch.model.brdf_ray_budget=[512,128]",
    "model.arch.model.max_retrace_rays=[32]",
    "model.arch.bg_module.bg_resolution=32"]


def check_small_flagship(torch, dev, extra=(), what="small flagship",
                         weights=None, gt_normals=False, opt_cfg=None,
                         grad_rtol=1e-3, base=SMALL_FLAGSHIP, grad_floor=0.0):
    """One train step (loss and every gradient) and one eval render of a
    tiny model=microfacet_tensorf2 (grid 16^3, envmap 32 x 64, 16 samples a
    ray, 8 after the proposal and 8 retraced, bounce budgets [512, 128], 32
    retrace rays) on the card against the same on the CPU, every random
    draw made by one CPU generator for both. The envmap's mip bias is 12,
    so every lookup box spans the map: a box of a few texels is a
    difference of SAT entries that the card's cumsum and the CPU's sum in
    another order (tests/test_torch_flagship.py). ``extra``: overrides;
    ``weights``: the loss weights (default L1 and ori); ``gt_normals``:
    unit ground-truth normals for the rays (a quarter zero, masked);
    ``opt_cfg``: an optimizer configuration whose first step's Adam first
    moments (the clipped, weight-decayed gradients) are compared too;
    ``grad_rtol``: the gradients' tolerance, relative to each tensor's
    largest entry; ``base``: the tiny model's overrides (a model without
    an envmap, as Ref-NeRF, reports no thinning factor); ``grad_floor``:
    every gradient's absolute tolerance grows by that share of the step's
    largest gradient."""
    from nmf_tpu_torch import config, trainer
    from nmf_tpu_torch.builders import build_nmf
    from nmf_tpu_torch.data import load_dataset
    from nmf_tpu_torch.ops.draws import Draws
    from nmf_tpu_torch.render import render

    cfg = config.compose([*base, *extra])
    ds = load_dataset(cfg["dataset"], None, "train")
    rays_np, rgb_np = ds["all_rays"][:64], ds["all_rgbs"][:64]
    if weights is None:
        weights = trainer.LossWeights(l1_weight=8e-5, ori_lambda=0.1)
    norms = None
    if gt_normals:
        gen = torch.Generator().manual_seed(3)
        norms = torch.nn.functional.normalize(
            torch.randn((64, 3), generator=gen), dim=-1)
        norms[torch.rand(64, generator=gen) < 0.25] = 0
    runs = []
    for d in (dev, torch.device("cpu")):
        nmf = build_nmf(cfg["model"]["arch"], ds["scene_bbox"],
                        tuple(cfg["dataset"]["near_far"]), seed=0, device=d)
        bg = nmf.bg_module
        if bg is not None:
            with torch.no_grad():
                bg.mipbias.fill_(12.0)
        # gradients on all
        opt = trainer.Optimizer(nmf, opt_cfg or trainer.OptimConfig())
        rays = torch.from_numpy(rays_np).to(d)
        loss, m = trainer.compute_loss(
            nmf, rays, torch.from_numpy(rgb_np).to(d), weights,
            (1.0, 1.0, 1.0), draws=Draws(torch.Generator().manual_seed(1)),
            gt_normals=None if norms is None else norms.to(d), hdr=nmf.hdr)
        loss.backward()
        with torch.no_grad():
            image = render(nmf, rays, is_train=False,
                           draws=Draws(torch.Generator().manual_seed(2)),
                           bg_cache=None if bg is None else bg.prepare()
                           )[0]["rgb_map"]
        runs.append([loss.detach(), m.get("thin_scale", loss.new_zeros(())),
                     image]
                    + [t.grad for _, t, _ in
                       trainer.differentiated_tensors(nmf)
                       if t.grad is not None])
        if opt_cfg is not None:
            opt.step()
            runs[-1] += opt.m
    if len(runs[0]) != len(runs[1]) or len(runs[0]) < 20:
        fail(f"{what}: the card and the CPU differentiated other tensors")
    pairs = [(a.cpu(), b) for a, b in zip(*runs)]
    err = max_err(torch, pairs[:3], 1e-4, 1e-5, f"{what} loss/render")
    # a scalar's gradient (the shading model's std, the envmap's
    # brightness) is a sum of terms of both signs, whose rounding follows
    # the terms, not the sum: 1e-6 of the step's largest gradient more
    top = max(float(b.abs().max()) for _, b in pairs[3:])
    for i, (a, b) in enumerate(pairs[3:]):
        scale = float(b.abs().max())
        atol = (grad_rtol * scale + 1e-9 + grad_floor * top
                + (1e-6 * top if b.dim() == 0 else 0.0))
        err = max(err, max_err(torch, [(a, b)], grad_rtol, atol,
                               f"{what} gradient {i}"))
    return err


# This slice's modules in the tiny card-against-CPU phase: the tensorf
# field's options (each init mode, the activations, dbasis without the
# smoothed normals, contract_space) and the MLPRender_PE head in the tiny
# model=tensorf; the dense voxel field and autograd normals (which train
# through the shading) in the tiny flagship
PE_HEAD = ("model.arch.model.diffuse_module._target_="
           "modules.render_modules.MLPRender_PE")
DM = "model.arch.model.diffuse_module"
SMALL_TENSORF_OPTIONS = (
    ["field.init_mode=trig"], ["field.init_mode=unif"],
    ["field.init_mode=unifplane"], ["field.init_mode=randplane"],
    ["field.activation=relu", "field.density_shift=-0.05"],
    ["field.activation=exp"], ["field.activation=identity"],
    ["field.dbasis=true", "field.numer_grad=false"],
    ["field.contract_space=true"], [PE_HEAD])
SMALL_FLAGSHIP_OPTIONS = (["field=grid", "field.grid_size=[16,16,16]"],
                          ["field.numer_grad=false"])
# The Microfacet model's options of the extras slice: each alone in the
# tiny flagship (each mixing mode and BRDF sampler too; an SGGXSampler
# target builds GGX, as in nmf_tpu, ROADMAP C.10)
VISIBILITY = ("model.arch.model.visibility_module._target_="
              "modules.render_modules.VisibilityMLP")
BRIGHT = ("model.arch.model.bright_sampler._target_="
          "brdf_samplers.equirect_bright_sampler.ERBrightSampler")
SMALL_EXTRAS_OPTIONS = (
    [VISIBILITY], [BRIGHT, "model.arch.model.percent_bright=0.25"],
    ["model.arch.model.russian_roulette=true"],
    ["model.arch.model.detach_N_iters=100"], ["model.arch.detach_inter=true"],
    *([f"model.arch.model.diffuse_mixing_mode={m}"]
      for m in ("fresnel_ind", "no_diffuse", "lambda")),
    *([f"model.arch.model.brdf_sampler._target_=brdf_samplers.{t}"]
      for t in ("beckmann.BeckmannSampler", "cosine.CosineLobeSampler",
                "multi.MultiSampler")),
    # a budget transition's grown budgets (x2)
    ["model.arch.model.brdf_ray_budget=[1024,256]",
     "model.arch.model.max_retrace_rays=[64]"])
def small_models(torch, dev, overrides, seed=0):
    """(the dataset, the model of ``overrides`` built on the card, and on
    the CPU), from one seed."""
    from nmf_tpu_torch import config
    from nmf_tpu_torch.builders import build_nmf
    from nmf_tpu_torch.data import load_dataset

    cfg = config.compose(overrides)
    ds = load_dataset(cfg["dataset"], None, "train")
    return ds, [build_nmf(cfg["model"]["arch"], ds["scene_bbox"],
                          tuple(cfg["dataset"]["near_far"]), seed=seed,
                          device=d) for d in (dev, torch.device("cpu"))]


def check_small_modules(torch, dev):
    """The slice's modules on the card against the CPU, beyond one train
    step: an eval render of a ListRF of two tiny grid fields (the second
    shifted and rotated), 5 pretraining iterations (the density factors
    and dbasis_mat after them), the field.calibrate solve under
    activation=exp (density_shift) and one streaming render (rgb, acc,
    depth). Every random draw from one CPU generator for both. Returns
    {check: max_abs_err}."""
    from nmf_tpu_torch import train, trainer
    from nmf_tpu_torch.builders import build_field
    from nmf_tpu_torch.fields.listrf import make_listrf
    from nmf_tpu_torch.ops.draws import Draws
    from nmf_tpu_torch.render import render
    from nmf_tpu_torch.render_streaming import render_streaming

    errs = {}
    ds, nmfs = small_models(torch, dev, [*SMALL_TENSORF, "field=grid",
                                         "field.grid_size=[8,8,8]"])
    rays_np = ds["all_rays"][:512]
    c, s = math.cos(0.6), math.sin(0.6)
    rot = [[[1, 0, 0], [0, 1, 0], [0, 0, 1]], [[c, -s, 0], [s, c, 0],
                                               [0, 0, 1]]]
    images = []
    for nmf in nmfs:
        d = nmf.rf.aabb.device
        other = build_field(torch.Generator().manual_seed(1),
                            {"_target_": "GridRF", "grid_size": [6, 7, 5]},
                            [[-0.9, -0.7, -1.0], [0.8, 0.6, 0.7]]).to(d)
        nmf.rf = make_listrf([nmf.rf, other], offsets=[[0, 0, 0],
                                                       [0.5, -0.2, 0.3]],
                             rotations=rot)
        nmf.sampler.update(nmf.rf, init=True)
        with torch.no_grad():
            ims = render(nmf, torch.from_numpy(rays_np).to(d),
                         is_train=False)[0]
        images.append([ims["rgb_map"], ims["acc_map"]])
    errs["listrf render"] = max_err(
        torch, [(a.cpu(), b) for a, b in zip(*images)], 1e-4, 1e-5,
        "small ListRF render")

    _, nmfs = small_models(torch, dev, [*SMALL_TENSORF,
                                        "field.num_pretrain=5",
                                        "field.dbasis=true"])
    lines, grads = [], []
    step = trainer.adam_step

    def first_grads(t, g, m, v, count, *args):
        if count == 1:
            grads[-1].append(g.clone())
        step(t, g, m, v, count, *args)

    trainer.adam_step = first_grads
    try:
        for nmf in nmfs:
            grads.append([])
            train.pretrain_density(
                nmf, Draws(torch.Generator().manual_seed(3)), 1e-3,
                log=lines.append)
    finally:
        trainer.adam_step = step
    # the first iteration's gradients, from the same factors on both, at
    # the train step's tolerance
    if len(grads[0]) != len(grads[1]) or not grads[0]:
        fail("small pretraining: the card and the CPU stepped other tensors")
    errs["pretraining gradients"] = max(
        max_err(torch, [(a.cpu(), b)], 1e-3,
                1e-4 * float(b.abs().max()) + 1e-9,
                f"small pretraining gradient {i}")
        for i, (a, b) in enumerate(zip(*grads)))
    # after 5 iterations: Adam's first steps are ~lr * sign(g), so an
    # entry whose gradient is within rounding of 0 may move the other way,
    # by up to 2 lr a step; the count of entries off decides (more than 1%
    # would be a fault)
    params = [[p.detach() for p in (*n.rf.density_rf.parameters(),
                                    n.rf.dbasis_mat)] for n in nmfs]
    worst, loose = 0.0, 0
    for a, b in zip(*params):
        err = (a.cpu() - b).abs()
        worst = max(worst, float(err.max()))
        loose += int((err > 1e-4 + 1e-4 * b.abs()).sum())
    total = sum(b.numel() for b in params[1])
    if loose > 0.01 * total:
        fail(f"small pretraining: {loose} of {total} entries off")
    errs["pretraining"] = worst
    print(f"  pretraining on the card / the CPU: {lines[0]} / {lines[1]}")

    _, nmfs = small_models(torch, dev, [*SMALL_TENSORF,
                                        "field.calibrate=true",
                                        "field.activation=exp"])
    shifts = []
    for nmf in nmfs:
        train.pretrain_density(nmf, Draws(torch.Generator().manual_seed(4)),
                               1e-3, log=lambda s: None)
        shifts.append(torch.tensor([nmf.rf.density_shift]))
    errs["calibrate"] = max_err(torch, [tuple(shifts)], 1e-5, 1e-6,
                                "small calibrate density_shift")

    ds, nmfs = small_models(torch, dev, [*SMALL_TENSORF, PE_HEAD,
                                         "field.density_shift=-1"])
    outs = []
    for nmf in nmfs:
        ims, stats = render_streaming(
            nmf, torch.from_numpy(ds["all_rays"][:512]).to(nmf.rf.aabb.device))
        outs.append([ims["rgb_map"], ims["acc_map"], ims["depth"]])
    errs["streaming render"] = max_err(
        torch, [(a.cpu(), b) for a, b in zip(*outs)], 1e-4, 1e-5,
        "small streaming render")
    return errs


def check_small_slice(torch, dev):
    """The tiny card-against-CPU phase of this slice: one train step and
    one eval render per option (``SMALL_TENSORF_OPTIONS``,
    ``SMALL_FLAGSHIP_OPTIONS``), then ``check_small_modules``. Prints and
    returns {check: max_abs_err}."""
    errs = {}
    for extra in SMALL_TENSORF_OPTIONS:
        what = "tensorf " + " ".join(extra)
        errs[what] = check_small_path(torch, dev, extra, what)
    for extra in SMALL_FLAGSHIP_OPTIONS:
        what = "flagship " + " ".join(extra)
        errs[what] = check_small_flagship(torch, dev, extra, what)
    errs |= check_small_modules(torch, dev)
    for what, err in errs.items():
        print(f"small {what}, card vs CPU: max_abs_err {err:.3e}")
    return errs


# (label, overrides) of the main paths, at the shipped widths. tensorf:
# 300 iterations through one upsample (128^3 -> 300^3 at 150) and two
# alpha-mask rebuilds (100, 200). The flagship: 450 iterations (cut from
# 600 for the script's time) through one upsample (at 225) and no mask
# rebuild: its density stays under the mask's alpha threshold (1e-3 at the
# march step) for hundreds of iterations, and a rebuild before it clears it
# culls the whole scene (PERF.md, section 6).
FLAGSHIP_ITERS = 450
# flagship train steps whose K3 ids are recorded and replayed: one before
# the upsample, one after it
REPLAY_STEPS = (FLAGSHIP_ITERS // 4, 3 * FLAGSHIP_ITERS // 4)
MAIN_PATHS = (
    ("tensorf", ["model=tensorf", "model.params.n_iters=300",
                 "field.upsamp_list=[150]",
                 "model.arch.sampler.update_list=[100,200]",
                 "log_rays=true"]),
    ("microfacet_tensorf2", [
        "model=microfacet_tensorf2", f"model.params.n_iters={FLAGSHIP_ITERS}",
        f"field.upsamp_list=[{FLAGSHIP_ITERS // 2}]",
        "model.arch.sampler.update_list=[]", "render_path=true"]),
)


def hold_new_sizes(torch, dev, gen, kernels, label, by_size, recorder,
                   deferred, timed=False, empty_ok=False):
    """Holds each launch of a path at sizes that the kernels' checks did
    not hold (the occupancy grid's rows, the NDC box's field rows, the
    batch the controller chose): K1 and K2 at each new (B, K) with their
    plain versions on ``composite_inputs`` (both modes, timed as the
    checks time theirs if ``timed``); K3 at
    each new size on walks of synthetic ids (``walk_ids``, 1% out of
    range) and on the ids recorded at the size's first launch that touched
    HELD_MIN_ROWS rows (``recorder``: a BinsumRecorder given ``held``),
    replayed by ``replay_binsum`` (its device time ``deferred``). Fails if
    no launch at a new size touched that many rows, unless ``empty_ok``:
    then that size is replayed on the walk ids. The rows join the
    kernels' shapes; launches made here are not counted (the path's
    counts were read before)."""
    from nmf_tpu_torch.ops.kernels import binsum as S

    comp = {k["name"]: k for k in kernels if k["name"].startswith("comp")}
    held = {n: {r["sizes"] for r in k["shapes"]} for n, k in comp.items()}
    for B, K in sorted(set().union(*(set(by_size[n]) - held[n]
                                     for n in comp))):
        for full in (False, True):
            fwd, bwd = composite_case(torch, dev, gen, deferred, B, K,
                                      full, True, timed)
            for n, row in (("composite_fwd", fwd), ("composite_bwd", bwd)):
                if (B, K) not in held[n]:
                    # in place: a timed row's deferred device times land
                    # in it
                    row["path"] = label
                    comp[n]["shapes"].append(row)
        print(f"{label}: K1/K2 at new size B={B} K={K} held, max_abs_err "
              f"{fwd['max_abs_err']:.3e} / {bwd['max_abs_err']:.3e}")
    binsum = next(k for k in kernels if k["name"] == "binsum_rows")
    for size, entry in sorted(recorder.new.items()):
        step, _, C, R, dtype = entry
        empty = recorder.touched[size] < HELD_MIN_ROWS
        if empty and not empty_ok:
            fail(f"{label}: no K3 launch at size {size} touched "
                 f"{HELD_MIN_ROWS} rows (at most {recorder.touched[size]}),"
                 " so its recorded ids cannot hold the kernel")
        idx, vals = binsum_inputs(torch, dev, gen,
                                  walk_ids(torch, dev, gen, size[0], R),
                                  R, C, dtype)
        rtol, atol = binsum_tolerance(S, idx, vals, R)
        synth_err = max_err(torch, [(S.binsum_rows(idx, vals, R),
                                     S.binsum_rows_plain(idx, vals, R))],
                            rtol, atol,
                            f"{label} binsum new size {size}, walk ids")
        # the row itself joins the shapes: its deferred device time lands
        # in it; a size whose launches touched no rows is replayed on the
        # walk ids
        replayed = (step, idx, C, R, dtype) if empty else entry
        [row] = replay_binsum(torch, dev, gen, [replayed], (), deferred)
        row.update(shape=f"{label} step {step} N={size[0]} C={C} R={R} "
                         f"{str(dtype)[6:]}", path=label,
                   walk_max_abs_err=synth_err,
                   replayed_on="walk ids" if empty else "recorded ids")
        binsum["shapes"].append(row)
        del idx, vals
    print(f"{label}: K3 held at {len(recorder.new)} sizes first launched on "
          "this path, on walk ids and on recorded ids")


def reset_counts(kernels):
    for k in kernels:
        k["kernel"].launches = 0
        k["kernel"].launches_by_size.clear()


@contextlib.contextmanager
def counts_at_eval(train, kernels):
    """Within the block, each kernel's count as the first evaluation
    starts fills the dict yielded: after a run with no mid-run evaluation,
    the train steps' launches."""
    at_eval = {}
    evaluate = train.eval_lib.evaluate

    def counted_evaluate(*args, **kwargs):
        if not at_eval:
            at_eval.update({k["name"]: k["kernel"].launches for k in kernels})
        return evaluate(*args, **kwargs)

    train.eval_lib.evaluate = counted_evaluate
    try:
        yield at_eval
    finally:
        train.eval_lib.evaluate = evaluate


def drive_main_path(torch, kernels, label, card, n_iters, run,
                    psnr_bar=PSNR_BAR, hold=None, trains=True, runs=None):
    """Drive one path with every kernel count set to 0 first: ``run(log)``
    trains and evaluates, and returns (results, train seconds, a note for
    the summary line). Then ``hold(by_size)``, if given, checks the
    launches at sizes known only at run time (``hold_new_sizes``). Fails
    unless the loss is finite (a path that ``trains``), every kernel of
    ``runs`` (None: all) launched, each only at sizes that its check held,
    and the test PSNR clears ``psnr_bar`` (None: a path without an eval).
    Returns (launches by kernel, launches by kernel and sizes,
    results)."""
    from nmf_tpu_torch import train

    reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.time()
    with counts_at_eval(train, kernels) as at_eval:
        res, train_seconds, note = run(lambda s: print(f"  {s}"))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k["name"]: k["kernel"].launches for k in kernels}
    by_size = {k["name"]: dict(k["kernel"].launches_by_size)
               for k in kernels}
    print(f"main path {label}: {wall:.1f} s, launches {launches}, "
          f"by sizes {by_size}, results {res}")
    if trains and not math.isfinite(res.get("loss", float("nan"))):
        fail(f"{label}: training loss is not finite: {res.get('loss')}")
    if hold is not None:
        hold(by_size)
    check_launches(kernels, label, launches, by_size, runs)
    if psnr_bar is not None and not res.get("psnr", 0.0) > psnr_bar:
        fail(f"{label}: test PSNR {res.get('psnr')} <= {psnr_bar} dB")
    per_step = {k: round(v / n_iters, 2)
                for k, v in (at_eval or launches).items()}
    thin = "".join(f", {k} {res[k]:.3f}" for k in
                   ("thin_scale", "thin_scale_retrace") if k in res)
    test = ("" if "psnr" not in res else
            f", test PSNR {res['psnr']:.2f} dB, SSIM {res['ssim']:.4f}")
    print(f"{label} {n_iters} iters on {card}: train "
          f"{res['rays_per_sec']:.0f} rays/s, mean step "
          f"{1e3 * train_seconds / n_iters:.2f} ms (host clock, "
          f"schedule events included), wall {wall:.1f} s{test}{thin}{note}, "
          f"launches per train step {per_step}")
    return launches, by_size, res


# The studio path: the flagship at full width on synthetic_studio under
# the protocol knobs of the studio 8k arms (runs/tpu_queue_r4f.sh arm8ks):
# hemisphere cameras, the fixed-shape field (planes padded to the final
# 300^2 from step 0), the global lr schedule across events, distortion
# 1e-3, batch 4096 (max_batch_size 4096 pins the controller). Cut: 24 views
# of 128^2 a split, 1000 iterations paused at STUDIO_PAUSE (stop_iter)
# and resumed to the end, the arms' schedule scaled from 8000 iterations to
# 1000: seven upsamples (128^3 -> 300^3 live) and five alpha-mask rebuilds,
# the final eval on 8 test views; then render_only on
# the final checkpoint. The rebuilds stay: on this scene the flagship's
# density clears the mask threshold by the first one, and without them
# floaters hold the test PSNR near 15 dB however long it trains.
STUDIO_ITERS = 1000
# the studio path's stop_iter pause, which the Blender path resumes from
# (late in the run, so the Blender path trains few steps: the script's
# time)
STUDIO_PAUSE = 17 * STUDIO_ITERS // 20


def studio_knobs(iters):
    """The studio knobs, apart from the scene, for a run of ``iters``
    iterations: the arms' upsample and mask-rebuild iterations scaled from
    8000 to ``iters``."""
    upsamples, rebuilds = (
        ",".join(str(i * iters // 8000) for i in its)
        for its in ((500, 1000, 2000, 3000, 4000, 5500, 7000),
                    (2000, 3000, 4000, 5500, 7000)))
    return [
        "model=microfacet_tensorf2",
        "field.fixed_shape=true", "model.params.lr_upsample_reset=false",
        "model.params.distortion_lambda=1e-3",
        "model.params.max_batch_size=4096", f"model.params.n_iters={iters}",
        f"field.upsamp_list=[{upsamples}]",
        f"model.arch.sampler.update_list=[{rebuilds}]",
        "final_N_vis=8", "vis_every=0",
        "device=cuda", f"basedir={LOG_DIR}", "progress_refresh_rate=100"]


STUDIO_KNOBS = studio_knobs(STUDIO_ITERS)
STUDIO = ["dataset=synthetic_studio", "dataset.hemisphere=true",
          "dataset.n_views=24", "dataset.image_size=128", *STUDIO_KNOBS]
# studio train steps whose K3 ids are recorded and replayed: one with the
# live grid at 128^3 inside the padded planes, one after the last upsample
STUDIO_REPLAY_STEPS = (STUDIO_ITERS // 32, 15 * STUDIO_ITERS // 16)
RENDER_ONLY_DB = 0.1  # the verify skill's "Checkpoint / relighting" bar


def check_launches(kernels, label, launches, by_size, runs=None):
    """Fails unless every kernel of ``runs`` (None: all) launched, and each
    only at sizes its check held."""
    for k in kernels:
        if (runs is None or k["name"] in runs) and launches[k["name"]] <= 0:
            fail(f"{label}: kernel {k['name']} was not launched on the main "
                 "path")
        unheld = set(by_size[k["name"]]) - {r["sizes"] for r in k["shapes"]}
        if unheld:
            fail(f"{label}: kernel {k['name']} was launched at sizes "
                 f"{sorted(unheld)} that its check did not hold")


def studio_path(config):
    """The studio path's run for ``drive_main_path`` (its scene from the
    dataset cache that ``prepare_scenes`` filled): a stop_iter pause at
    STUDIO_PAUSE, a resume to the end with the final checkpoint and eval,
    then render_only on that checkpoint. Fails unless the loss before the
    pause is finite, the pause left a _latest.th, the resumed run wrote
    the final checkpoint and render_only reproduces the final eval's PSNR
    within RENDER_ONLY_DB."""
    from nmf_tpu_torch import train

    folder = LOG_DIR / "synthetic_studio_studio"

    def run(log):
        _, first = train.reconstruction(config.compose(
            [*STUDIO, "expname=studio", f"stop_iter={STUDIO_PAUSE}"]),
            log=log)
        if first.get("paused_at") != STUDIO_PAUSE or not (
                folder / "synthetic_studio_studio_latest.th").exists():
            fail(f"studio: the stop_iter pause left no _latest.th ({first})")
        if not math.isfinite(first.get("loss", float("nan"))):
            fail(f"studio: loss before the pause is not finite: {first}")
        _, res = train.reconstruction(config.compose(
            [*STUDIO, "expname=studio", "resume=True"]), log=log)
        final = folder / "synthetic_studio_studio.th"
        if not final.exists():
            fail(f"studio: the resumed run wrote no final checkpoint: {res}")
        _, rendered = train.dispatch(config.compose(
            [*STUDIO, "expname=studio_render", "render_only=True",
             f"ckpt={final}"]), log=log)
        print(f"studio render_only: {rendered}")
        res["render_only_psnr"] = rendered["psnr"]
        if not abs(rendered["psnr"] - res.get("psnr", 0.0)) <= RENDER_ONLY_DB:
            fail(f"studio: render_only PSNR {rendered['psnr']} is not within "
                 f"{RENDER_ONLY_DB} dB of the final eval's {res.get('psnr')}")
        note = (f", norm_err {res['norm_err']:.2f} deg, tint_psnr "
                f"{res['tint_psnr']:.2f} dB, envmap_psnr "
                f"{res['envmap_psnr']:.2f} dB; before / after the pause "
                f"{first['rays_per_sec']:.0f} / {res['rays_per_sec']:.0f} "
                f"rays/s, mean step "
                f"{1e3 * first['train_seconds'] / STUDIO_PAUSE:.2f} / "
                f"{1e3 * res['train_seconds'] / (STUDIO_ITERS - STUDIO_PAUSE):.2f}"
                f" ms; render_only "
                f"PSNR {rendered['psnr']:.2f} dB")
        return res, first["train_seconds"] + res["train_seconds"], note

    return run


# The Blender path: the studio path's scene written in nerf_synthetic layout
# under the folder dataset=lego names, trained through dataset=lego with
# the studio knobs. Cut: it resumes from the studio path's pause checkpoint
# (STUDIO_PAUSE, copied as its own _latest.th) and trains to the end, as
# the studio path's resumed run does, on the same random streams. Its
# only dataset overrides: datadir, the studio cameras' near_far and the
# normal / tint maps. Only 8-bit quantization separates its data from the
# studio path's, so its test PSNR must land within BLENDER_DB of the studio
# path's.
DATA_DIR = LOG_DIR / "data"
BLENDER = ["dataset=lego", f"datadir={DATA_DIR}",
           "dataset.near_far=[1.4,5.0]", "dataset.stack_norms=true",
           *STUDIO_KNOBS, "expname=blender", "resume=True"]
BLENDER_DB = 0.5
# the lego-size load: nerf_synthetic's 100 train views of 800^2 (RGBA, the
# sphere generator's, alpha from its hit mask) and a few test views,
# loaded with dataset=lego's yaml, then full-width flagship steps from the
# store on the card
LEGO_VIEWS, LEGO_TEST_VIEWS, LEGO_SIZE, LEGO_STEPS = 100, 4, 800, 10
LEGO_DIR = LOG_DIR / "lego_size"


def max_abs(a, b):
    import numpy as np

    return float(np.max(np.abs(np.asarray(a, np.float64) - b)))


def write_blender_scene(config):
    """The studio scene (both splits, from the generator's memo) as a
    nerf_synthetic folder: RGBA, normal and tint PNGs, transforms with
    camera_angle_x = 55 degrees and the generator's camera-to-world
    matrices, and its panorama as backgrounds/lego_bg.exr (FLOAT, ZIPS).
    Then the host checks: the loaded rays within 1e-5 of the generator's,
    RGBA within 1/255, the EXR read back bit-equal to the panorama. Prints
    the loader's seconds."""
    import numpy as np

    from nmf_tpu_torch.data import load_dataset
    from nmf_tpu_torch.data.blender import save_blender_split
    from nmf_tpu_torch.data.exr import read_exr, write_exr

    studio = config.compose([*STUDIO, "expname=studio"])["dataset"]
    lego = config.compose(BLENDER)
    scenedir = DATA_DIR / lego["dataset"]["scenedir"]
    t0 = time.time()
    gens = {split: load_dataset(studio, None, split)
            for split in ("train", "test")}
    for split, gen in gens.items():
        W, H = gen["img_wh"]
        shape = (gen["poses"].shape[0], H, W, -1)
        save_blender_split(scenedir, split, gen["poses"],
                           gen["all_rgbs"].reshape(shape), np.deg2rad(55.0),
                           gen["all_norms"].reshape(shape),
                           gen["all_tints"].reshape(shape))
    bg = DATA_DIR / "backgrounds" / lego["dataset"]["gt_bg"]
    bg.parent.mkdir(parents=True, exist_ok=True)
    write_exr(bg, gen["gt_bg_im"])
    print(f"blender scene: {scenedir} and {bg} written in "
          f"{time.time() - t0:.1f} s")
    for split, gen in gens.items():
        t0 = time.time()
        ds = load_dataset(lego["dataset"], lego["datadir"], split)
        seconds = time.time() - t0
        ray_err = max_abs(ds["all_rays"], gen["all_rays"])
        rgba_err = max_abs(ds["all_rgbs"], gen["all_rgbs"])
        print(f"blender scene {split}: loaded {ds['all_rays'].shape[0]} rays "
              f"in {seconds:.3f} s; rays vs the generator's max_abs_err "
              f"{ray_err:.3e}, RGBA {rgba_err:.3e} (1/255 = {1 / 255:.3e})")
        if not ray_err <= 1e-5:
            fail(f"blender scene {split}: rays off by {ray_err} (> 1e-5)")
        if not rgba_err <= 1 / 255:
            fail(f"blender scene {split}: RGBA off by {rgba_err} (> 1/255)")
    pano = read_exr(bg)
    if not (pano.shape == gen["gt_bg_im"].shape
            and np.array_equal(pano, gen["gt_bg_im"])):
        fail(f"blender scene: {bg} does not read back as the panorama")
    print(f"blender scene: {bg.name} {pano.shape} read back equal to the "
          f"panorama (max {pano.max():.2f})")


def blender_path(config):
    """The Blender path's run for ``drive_main_path``: the trainer on
    dataset=lego, resumed from the studio path's pause checkpoint, its
    final eval against the panorama read from the EXR. Fails unless it
    resumed at the pause and wrote pano.exr."""
    from nmf_tpu_torch import train

    def run(log):
        folder = LOG_DIR / "lego_blender"
        folder.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(LOG_DIR / "synthetic_studio_studio"
                        / "synthetic_studio_studio_latest.th",
                        folder / "lego_blender_latest.th")
        lines = []

        def logged(s):
            lines.append(s)
            log(s)

        _, res = train.reconstruction(config.compose(BLENDER), log=logged)
        if not any(ln.startswith("resume:") and
                   f"at iter {STUDIO_PAUSE}" in ln for ln in lines):
            fail("blender: the run did not resume from the studio path's "
                 "pause checkpoint")
        pano = folder / "imgs_test_all" / "pano.exr"
        if not pano.exists():
            fail(f"blender: the final eval wrote no {pano}")
        note = (f", norm_err {res['norm_err']:.2f} deg, tint_psnr "
                f"{res['tint_psnr']:.2f} dB, envmap_psnr "
                f"{res['envmap_psnr']:.2f} dB against {BLENDER[0]}'s "
                f"gt_bg EXR")
        return res, res["train_seconds"], note

    return run


def sphere_poses(n_views, phi_deg):
    """The sphere generator's cameras: an orbit of radius 4 at ``phi_deg``
    (Blender-convention camera-to-world matrices)."""
    from nmf_tpu_torch.data.ray_utils import pose_spherical

    return [pose_spherical(360.0 * i / n_views, phi_deg, 4.0)
            for i in range(n_views)]


def sphere_views(poses, size):
    """The sphere generator's RGBA views (60 degrees wide; alpha from its
    hit mask), made by ``threaded_map`` ahead of their consumer."""
    import numpy as np

    from nmf_tpu_torch.data.ray_utils import (get_ray_directions_blender,
                                              get_rays)
    from nmf_tpu_torch.data.synthetic import render_sphere_scene, threaded_map

    focal = 0.5 * size / np.tan(0.5 * np.deg2rad(60.0))
    dirs = get_ray_directions_blender(size, size, [focal, focal])
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)

    def view(c2w):
        rgb, alpha, _ = render_sphere_scene(*get_rays(dirs, c2w))
        return np.concatenate([rgb, alpha[:, None]], -1).reshape(
            size, size, 4)

    yield from threaded_map(view, poses)


@contextlib.contextmanager
def measured_loads(train, record, check=None):
    """Within the block, each of the trainer's dataset loads is timed and
    its host allocations traced (numpy's buffers included): appends
    (split, seconds, traced peak bytes, rays, store bytes) to ``record``;
    then ``check(ds, split)``, if given, before the trainer goes on."""
    import tracemalloc

    load = train.load_dataset

    def measured(cfg, datadir, split="train", **kw):
        tracemalloc.start()
        t0 = time.time()
        try:
            ds = load(cfg, datadir, split, **kw)
        finally:
            peak = tracemalloc.get_traced_memory()[1]
            tracemalloc.stop()
        record.append((split, time.time() - t0, peak,
                       ds["all_rays"].shape[0],
                       ds["all_rays"].nbytes + ds["all_rgbs"].nbytes))
        if check is not None:
            check(ds, split)
        return ds

    train.load_dataset = measured
    try:
        yield record
    finally:
        train.load_dataset = load


def lego_load_path(torch, config):
    """Write the lego-size scene (timed), then return the run for
    ``drive_main_path``: the trainer on dataset=lego's yaml (near_far set
    to the sphere's cameras), the flagship at full width, batch pinned at
    4096, LEGO_STEPS steps from the store on the card and no eval. The run
    prints each load's seconds and traced host peak, the process's peak
    RSS, the store's bytes and the card's peak allocation."""
    import resource

    import numpy as np

    from nmf_tpu_torch import train
    from nmf_tpu_torch.data.blender import save_blender_split

    t0 = time.time()
    for split, n, phi in (("train", LEGO_VIEWS, -30.0),
                          ("test", LEGO_TEST_VIEWS, -25.0)):
        poses = sphere_poses(n, phi)
        save_blender_split(LEGO_DIR / "nerf_synthetic" / "lego", split,
                           poses, sphere_views(poses, LEGO_SIZE),
                           np.deg2rad(60.0))
    print(f"lego-size scene: {LEGO_VIEWS} + {LEGO_TEST_VIEWS} views of "
          f"{LEGO_SIZE}^2 RGBA generated and written in "
          f"{time.time() - t0:.1f} s (views on up to 8 threads)")
    cfg = config.compose([
        "model=microfacet_tensorf2", "dataset=lego", f"datadir={LEGO_DIR}",
        "dataset.near_far=[2.5,5.5]", f"model.params.n_iters={LEGO_STEPS}",
        "model.params.max_batch_size=4096", "render_test=false",
        "device=cuda", f"basedir={LOG_DIR}", "expname=lego_size",
        "progress_refresh_rate=5"])

    def run(log):
        torch.cuda.reset_peak_memory_stats()
        with measured_loads(train, []) as loads:
            _, res = train.reconstruction(cfg, log=log)
        for split, seconds, peak, rays, store in loads:
            print(f"lego-size load ({split}): {rays} rays in {seconds:.2f} "
                  f"s, traced host peak {peak} B ({peak / 2**30:.2f} GiB), "
                  f"rays + RGBA {store} B ({store / 2**30:.2f} GiB)")
        train_store = next(ld[4] for ld in loads if ld[0] == "train")
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        note = (f"; device store {train_store} B "
                f"({train_store / 2**30:.2f} GiB), card peak allocated "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
                f"process peak RSS so far {rss / 2**30:.2f} GiB")
        return res, res["train_seconds"], note

    return run


# The occupancy-grid path: model=microfacet_tensorf (the NerfAcc-style
# occupancy grid, 128^3, multiplier 2, a density sweep every 16 iterations,
# and the normal MLP) at its shipped widths on synthetic_sphere: 450
# iterations, one upsample at 225; and a shrink tick at 300 (the shipped
# shrink_iters is [], nmf_tpu's tests/test_train.py sets it), so the shrink
# and the optimizer rebuild after it run on the card. (At 600 iterations,
# the upsample at 300 and the shrink at 400, it reached ~31 dB; at this
# cut, taken for the script's time, 18.7-19.0 dB.)
# The occupancy threshold is raised from the shipped 0.01 to 0.05: at 0.01
# the random field's density (~0.018 at build) keeps every cell occupied
# through 600 iterations, so the grid culls nothing. At 0.05 the grid
# thresholds at its mean (~0.02-0.04) and culls ~90% of the cells, but
# cells that hover about the mean stay on the faces of the box: the
# shrink crops a few voxels off +z in most runs and keeps the whole box
# in some. The path prints what the shrink did and does not depend on
# it: the crop runs deterministically in the path after it.
OCCGRID_ITERS = 450
OCCGRID = ["model=microfacet_tensorf", "dataset=synthetic_sphere",
           f"model.params.n_iters={OCCGRID_ITERS}",
           f"field.upsamp_list=[{OCCGRID_ITERS // 2}]",
           f"model.arch.sampler.shrink_iters=[{2 * OCCGRID_ITERS // 3}]",
           "model.arch.sampler.occ_thre=0.05",
           "device=cuda", f"basedir={LOG_DIR}", "expname=occgrid",
           "progress_refresh_rate=100"]
# The LLFF path: fern's layout and size (20 views of 4032 x 3024, focal
# ~3260 px, downsampled 4x by the loader to 1008 x 756, every 8th view
# held out), written from the sphere generator as a forward-facing
# capture, then dataset=llff_fern (NDC rays) with the default model and
# only the flagship path's cut.
LLFF_VIEWS, LLFF_W, LLFF_H, LLFF_FOCAL, LLFF_DOWN = 20, 4032, 3024, 3260.0, 4
LLFF_ITERS = 600
LLFF = ["dataset=llff_fern", f"datadir={DATA_DIR}", "N_vis=1",
        f"model.params.n_iters={LLFF_ITERS}",
        f"field.upsamp_list=[{LLFF_ITERS // 2}]",
        "model.arch.sampler.update_list=[]", "device=cuda",
        f"basedir={LOG_DIR}", "expname=llff", "progress_refresh_rate=100"]


@contextlib.contextmanager
def occgrid_records(shares, shrinks):
    """Within the block, the occupancy grid's occupied share after each of
    its density sweeps is appended to ``shares``, and (box before, box
    after, grid after, whether it cropped) of each field shrink to
    ``shrinks``."""
    from nmf_tpu_torch.fields.tensorf import TensorVMSplit
    from nmf_tpu_torch.samplers.occgrid import OccGridSampler

    sweep, shrink = OccGridSampler.update_density, TensorVMSplit.shrink

    def swept(self, rf):
        sweep(self, rf)
        shares.append(float(self.occupancy().float().mean()))

    def shrunk(self, new_aabb):
        before = self.aabb.detach().cpu().numpy().round(4).tolist()
        cropped = shrink(self, new_aabb)
        shrinks.append((before, self.aabb.detach().cpu().numpy().round(
            4).tolist(), self.grid_size, cropped))
        return cropped

    OccGridSampler.update_density, TensorVMSplit.shrink = swept, shrunk
    try:
        yield
    finally:
        OccGridSampler.update_density, TensorVMSplit.shrink = sweep, shrink


def occgrid_path(config, trained):
    """The occupancy-grid path's run for ``drive_main_path``; prints the
    occupied share after every sweep and each shrink's box and sizes, and
    leaves the trained model and its results in ``trained``."""
    from nmf_tpu_torch import train

    def run(log):
        shares, shrinks = [], []
        with occgrid_records(shares, shrinks):
            nmf, res = train.reconstruction(config.compose(OCCGRID), log=log)
        print(f"occgrid: occupied share after each of {len(shares)} sweeps "
              "(at build, every 16 iterations and after each event): "
              + " ".join(f"{x:.4f}" for x in shares))
        for before, after, grid, cropped in shrinks:
            print(f"occgrid: shrink of the box {before} -> {after}, grid "
                  f"{grid}, {'cropped' if cropped else 'kept the box'}")
        if not shrinks:
            fail("occgrid: the shrink tick did not run")
        trained.update(nmf=nmf, res=res)
        note = (f"; final box {shrinks[-1][1]}, grid {nmf.rf.grid_size}, "
                f"march {nmf.sampler.n_samples} steps of "
                f"{nmf.sampler.stepsize:.6f}")
        return res, res["train_seconds"], note

    return run


# The occupancy-grid crop, forced as nmf_tpu's own shrink test forces it
# (tests/test_train.py, test_occgrid_shrink_fires_and_step_survives): the
# trained occgrid model's grid is set to 10 in the cells whose centres lie
# in CROP_BOX (around the sphere of radius 0.8, a different margin on
# each side) and 0 elsewhere, and the 300^3 field is shrunk to the grid's
# bounds as NMF.check_schedule does at a shrink tick. The cropped model is
# written as the run's _latest.th at iteration 600, and the trainer
# resumes from it (so the checkpoint of a shrunk field loads into a fresh
# model) for CROP_STEPS steps at full width, then evaluates the test
# views. Its field rows at the cropped sizes are held as new sizes.
CROP_BOX = ((-0.95, -0.9, -1.0), (0.9, 1.0, 0.85))
CROP_STEPS = 50
OCCGRID_CROP = [*OCCGRID, "resume=true",
                f"model.params.n_iters={OCCGRID_ITERS + CROP_STEPS}"]


def occgrid_crop_path(torch, config, trained):
    """The crop's run for ``drive_main_path``, on the model that
    ``occgrid_path`` left in ``trained``. Fails unless the shrink cropped
    the box to within a grid cell and a voxel of CROP_BOX and the resumed
    model has the cropped box and grid."""
    import numpy as np

    from nmf_tpu_torch import ckpt, train

    def run(log):
        nmf, cfg = trained["nmf"], config.compose(OCCGRID_CROP)
        sampler, rf = nmf.sampler, nmf.rf
        G = sampler.density_grid.shape[0]
        unit = (torch.arange(G, device=sampler.aabb.device) + 0.5) / G
        lo, hi = (torch.tensor(b, device=unit.device) for b in CROP_BOX)
        inside = [(c >= lo[i]) & (c <= hi[i]) for i, c in enumerate(
            sampler.aabb[0, :, None] * (1 - unit) + sampler.aabb[1, :, None]
            * unit)]
        block = inside[0][:, None, None] & inside[1][None, :, None] \
            & inside[2][None, None, :]
        sampler.density_grid = block.float() * 10.0
        before = rf.aabb.detach().cpu().numpy()
        if not rf.shrink(sampler.get_bounds()):
            fail(f"occgrid crop: the shrink to {CROP_BOX} kept the box "
                 f"{before.tolist()}")
        sampler.update(rf, init=True)
        box = rf.aabb.detach().cpu().numpy()
        print(f"occgrid crop: the box {before.round(4).tolist()} -> "
              f"{box.round(4).tolist()}, grid {rf.grid_size}")
        # the bounds add a margin within one grid cell to the block's
        # cells; the shrink rounds them to the voxel lattice
        slack = ((before[1] - before[0]) / G
                 + (box[1] - box[0]) / (np.asarray(rf.grid_size) - 1))
        target = np.clip(np.asarray(CROP_BOX), before[0], before[1])
        if not (np.abs(box - target) <= slack).all():
            fail(f"occgrid crop: the box {box.tolist()} is not within a "
                 f"grid cell and a voxel of {CROP_BOX}")
        name = train._expname(cfg)
        ckpt.save(LOG_DIR / name / f"{name}_latest.th", nmf, cfg,
                  extra={"iteration": OCCGRID_ITERS,
                         "cur_bs": trained["res"]["batch"],
                         "budget_mult": 1})
        resumed, res = train.reconstruction(cfg, log=log)
        if (not torch.equal(resumed.rf.aabb, rf.aabb)
                or tuple(resumed.rf.grid_size) != tuple(rf.grid_size)):
            fail(f"occgrid crop: resumed at the box {resumed.rf.aabb}, grid"
                 f" {resumed.rf.grid_size}, not the cropped {box}, "
                 f"{rf.grid_size}")
        gap = res["psnr"] - trained["res"]["psnr"]
        note = (f"; cropped grid {rf.grid_size}, test PSNR {gap:+.2f} dB "
                "from the occgrid path's")
        return res, res["train_seconds"], note

    return run


def write_llff_scene(config):
    """The forward-facing sphere at fern's size in the LLFF layout where
    dataset=llff_fern looks; returns its folder."""
    import numpy as np

    from nmf_tpu_torch.data.llff import save_llff_scene
    from nmf_tpu_torch.data.synthetic import forward_facing_sphere

    scenedir = DATA_DIR / config.compose(LLFF)["dataset"]["scenedir"]
    t0 = time.time()
    poses, views, bounds = forward_facing_sphere(LLFF_VIEWS, LLFF_H, LLFF_W,
                                                 LLFF_FOCAL)
    save_llff_scene(scenedir, poses, views, LLFF_FOCAL, bounds)
    size = sum(p.stat().st_size for p in scenedir.rglob("*.png"))
    print(f"llff scene: {LLFF_VIEWS} views of {LLFF_W} x {LLFF_H} PNG "
          f"({size} B) and poses_bounds.npy written in "
          f"{time.time() - t0:.1f} s (views on up to 8 threads); bounds "
          f"{np.asarray(bounds)[0].tolist()}", flush=True)


def check_llff_split(scenedir, ds, split):
    """Host checks of a loaded LLFF split: the ray count, each image equal
    to the 4 x 4 block mean of its PNG within 1e-6 (INTER_AREA at an
    integer factor), near_far (0, 1) and the NDC origins' |z| <= 1 (to
    1e-6: the origin's shift to z = -near rounds)."""
    import numpy as np

    from nmf_tpu_torch.data.exr import imread_any
    from nmf_tpu_torch.data.llff import image_paths

    test = list(range(0, LLFF_VIEWS, 8))
    ids = (test if split == "test" else
           [i for i in range(LLFF_VIEWS) if i not in test])
    w, h = LLFF_W // LLFF_DOWN, LLFF_H // LLFF_DOWN
    if ds["all_rays"].shape[0] != len(ids) * w * h:
        fail(f"llff {split}: {ds['all_rays'].shape[0]} rays, expected "
             f"{len(ids)} x {w} x {h}")
    paths = image_paths(scenedir)
    worst = 0.0
    for k, i in enumerate(ids):
        png = imread_any(paths[i])[..., :3]
        block = png.reshape(h, LLFF_DOWN, w, LLFF_DOWN, 3).mean(axis=(1, 3))
        worst = max(worst, max_abs(
            ds["all_rgbs"][k * w * h:(k + 1) * w * h].reshape(h, w, 3),
            block))
    z = float(np.abs(ds["all_rays"][:, 2]).max())
    print(f"llff {split}: {len(ids)} views, {ds['all_rays'].shape[0]} rays, "
          f"images vs the PNGs' 4 x 4 block means max_abs_err {worst:.3e}, "
          f"near_far {ds['near_far']}, max |NDC origin z| {z!r}")
    if not worst <= 1e-6:
        fail(f"llff {split}: an image is off its PNG's block mean by {worst}")
    if tuple(ds["near_far"]) != (0.0, 1.0) or not ds.get("ndc_ray"):
        fail(f"llff {split}: not NDC rays ({ds['near_far']})")
    if not z <= 1 + 1e-6:
        fail(f"llff {split}: an NDC origin lies at |z| = {z}")


def ndc_test_psnr(torch, nmf, cfg):
    """Mean PSNR of the first ``cfg["N_vis"]`` test views rendered as
    training marches them (NDC rays, ``render_image(ndc_ray=True)``);
    ``evaluate``, as nmf_tpu's, marches them as world rays."""
    import numpy as np

    from nmf_tpu_torch import eval as eval_lib
    from nmf_tpu_torch import utils
    from nmf_tpu_torch.data import load_dataset

    ds = load_dataset(cfg["dataset"], cfg["datadir"], split="test")
    W, H = ds["img_wh"]
    n_px = H * W
    psnrs = []
    for i in range(min(ds["all_rays"].shape[0] // n_px, cfg["N_vis"])):
        px = slice(i * n_px, (i + 1) * n_px)
        maps = eval_lib.render_image(
            nmf, ds["all_rays"][px], (H, W), chunk=nmf.eval_batch_size,
            draws=eval_lib.Draws(torch.Generator(device="cuda").manual_seed(
                i)), ndc_ray=True)
        psnrs.append(utils.rgb_psnr(np.clip(maps["rgb_map"], 0, 1),
                                    ds["all_rgbs"][px].reshape(H, W, 3)))
    return float(np.mean(psnrs))


def llff_path(torch, config):
    """The run for ``drive_main_path`` on the LLFF scene that
    ``prepare_scenes`` wrote: the trainer on dataset=llff_fern, each split
    checked on the host as it is loaded, before training. Prints each
    load's seconds and traced host peak and the store's bytes. The test
    PSNR the path is held to is that of the test views rendered with NDC
    rays; the final eval's (world rays, as nmf_tpu's) is printed beside
    it."""
    from nmf_tpu_torch import train

    scenedir = DATA_DIR / config.compose(LLFF)["dataset"]["scenedir"]

    def run(log):
        torch.cuda.reset_peak_memory_stats()
        cfg = config.compose(LLFF)
        with measured_loads(train, [], check=lambda ds, split:
                            check_llff_split(scenedir, ds, split)) as loads:
            nmf, res = train.reconstruction(cfg, log=log)
        for split, seconds, peak, rays, store in loads:
            print(f"llff load ({split}): {rays} rays in {seconds:.2f} s, "
                  f"traced host peak {peak} B ({peak / 2**30:.2f} GiB), "
                  f"rays + RGB {store} B ({store / 2**30:.2f} GiB)")
        train_store = next(ld[4] for ld in loads if ld[0] == "train")
        res = dict(res, evaluate_psnr=res["psnr"],
                   psnr=ndc_test_psnr(torch, nmf, cfg))
        note = (f"; test PSNR of the NDC render {res['psnr']:.2f} dB, "
                f"evaluate's (world rays, as nmf_tpu) "
                f"{res['evaluate_psnr']:.2f} dB; device store {train_store}"
                f" B, card peak allocated "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        return res, res["train_seconds"], note

    return run


# The Ref-NeRF studio path: model=refnerf with the field and model of the
# refnerf 8k arm (runs/synthetic_studio_refnerf_studio8k/config.yaml: the
# studio knobs) on the studio path's scene: 24 views of 128^2, the arm's
# upsamples and mask rebuilds scaled by 1/8, no pause. Cut for the
# script's time from the studio path's 1000 iterations to 400, which run
# the events up to 400 (four upsamples, two rebuilds).
REFNERF_STUDIO_ITERS = 2 * STUDIO_ITERS // 5
REFNERF_STUDIO = ["dataset=synthetic_studio", "dataset.hemisphere=true",
                  "dataset.n_views=24", "dataset.image_size=128",
                  "model=refnerf", *STUDIO_KNOBS[1:],
                  f"model.params.n_iters={REFNERF_STUDIO_ITERS}",
                  "expname=refnerf_studio"]
# The hash-grid path: model=refnerf_tcnn field=hashgrid at their shipped
# widths (16 levels of 2^19 x 2 tables, the 128^3 occupancy grid at its
# shipped threshold 0.01, multiplier 2: 3,540 march steps a ray) on
# synthetic_sphere, 600 iterations; geonorm_interp_iters cut from 1000 to
# 400, so the normal blend is 0 from the first tick to 100 and 1 from 500.
REFNERF_TCNN_ITERS = 600
REFNERF_TCNN = ["model=refnerf_tcnn", "field=hashgrid",
                "dataset=synthetic_sphere",
                f"model.params.n_iters={REFNERF_TCNN_ITERS}",
                "model.arch.geonorm_interp_iters=400", "device=cuda",
                f"basedir={LOG_DIR}", "expname=refnerf_tcnn",
                "progress_refresh_rate=100"]
BLEND_AT = (0, 100, 300, 500, REFNERF_TCNN_ITERS - 1)
# The dual path: model=microfacet_dualref (Ref-NeRF warmup, then the
# microfacet model with Ref-NeRF shading its retrace pass) at its shipped
# widths on synthetic_sphere, 600 iterations, warmup_iters cut from 5000
# to 300 (at 400 iterations with the switch at 300 it fell to 16.33 dB, at
# 500 with the switch at 250 to 17.16 dB).
DUALREF_ITERS, DUALREF_SWITCH = 600, 300
DUALREF = ["model=microfacet_dualref", "dataset=synthetic_sphere",
           f"model.params.n_iters={DUALREF_ITERS}",
           f"model.arch.model.warmup_iters={DUALREF_SWITCH}", "device=cuda",
           f"basedir={LOG_DIR}", "expname=dualref",
           "progress_refresh_rate=100"]


# The two paths of the grid field and the PE head run the first iterations
# of the shipped 30,000-iteration schedule, paused by stop_iter, and are
# evaluated by render_only on the pause checkpoint. A run cut to n_iters =
# 600 squeezes the schedule's 1000x learning-rate decay into those steps:
# Adam then moves a parameter at most ~0.02 x 0.145 x 600 = 1.7, too little
# for a dense voxel (the grid flagship stalled at 15.15 dB, 16.65 dB at
# 1200), and density pretraining with dbasis stalled at 12.37 dB for 300
# iterations (PERF.md, section 6).
# The grid path: the flagship on the dense voxel field at grid.yaml's
# widths (128^3 volumes, app_dim 24: a 2,097,152-row table of 28 f32
# columns) with the flagship's 192 / 96 / 96 samples, budgets [65536,
# 16384], 1024 retrace rays and batch 4096, on synthetic_sphere: 600
# iterations and no mask rebuild (the shipped rebuilds start at 2000; the
# grid's density never clears the mask's threshold in this cut, ROADMAP
# C.2 and C.7); the field has no upsample.
GRID_ITERS = 600
GRID_PATH = ["model=microfacet_tensorf2", "field=grid",
             "dataset=synthetic_sphere", f"stop_iter={GRID_ITERS}",
             "device=cuda", f"basedir={LOG_DIR}", "expname=grid",
             "progress_refresh_rate=100"]
# The tensorf_pe path: model=tensorf with the MLPRender_PE head (viewpe 6,
# pospe 6, featureC 128), dbasis and 100 density pretraining iterations,
# at the tensorf path's widths and cut (300 iterations, the upsample at
# 150, mask rebuilds at 100 and 200); its test views evaluated in batch,
# then streamed (render_only with stream=true).
TENSORF_PE_ITERS = 300
TENSORF_PE = ["model=tensorf", PE_HEAD, "field.dbasis=true",
              "field.num_pretrain=100", "dataset=synthetic_sphere",
              f"stop_iter={TENSORF_PE_ITERS}", "field.upsamp_list=[150]",
              "model.arch.sampler.update_list=[100,200]", "device=cuda",
              f"basedir={LOG_DIR}", "expname=tensorf_pe",
              "progress_refresh_rate=100"]
STREAM_DB = 0.1  # streamed against batch test PSNR


# The extras path: the flagship at its shipped widths on synthetic_sphere
# with every knob of the extras slice on, at values a user would set: the
# visibility MLP, bright rays (the last half of each sample's rays: at 0.1
# a sample needs 10 rays before one turns bright, ceil(0.9 c) = c below
# that, and a development run of this path on an H100 turned none
# bright), Russian roulette, the normals detached for 100 iterations,
# detach_inter, the ori / pred decays, the Charbonier loss, the envmap
# TV, the normal error (the sphere's split carries no normals, so the term
# is zero here; the small check holds it on the card), weight decay and
# the budget controller. Cut as the flagship path: 450 iterations, the
# upsample at half, no rebuild (C.2). (At 400 iterations, the upsample at
# 200, it stayed at 15.2 dB on an H100: this path's PSNR climbs only
# after the upsample.)
EXTRAS_ITERS = FLAGSHIP_ITERS
EXTRAS = ["model=microfacet_tensorf2", "dataset=synthetic_sphere",
          f"model.params.n_iters={EXTRAS_ITERS}",
          f"field.upsamp_list=[{EXTRAS_ITERS // 2}]",
          "model.arch.sampler.update_list=[]", VISIBILITY, BRIGHT,
          "model.arch.model.percent_bright=0.5",
          "model.arch.model.russian_roulette=true",
          "model.arch.model.detach_N_iters=100",
          "model.arch.detach_inter=true",
          "model.params.final_ori_lambda=0.01",
          "model.params.final_pred_lambda=3e-5",
          "model.params.charbonier_loss=true",
          "model.params.TV_weight_bg=0.01",
          "model.params.normal_err_lambda=1e-4",
          "model.params.weight_decay=1e-6",
          "model.params.adapt_brdf_budget=true",
          "device=cuda", f"basedir={LOG_DIR}", "expname=extras",
          "progress_refresh_rate=50"]


def extras_path(config):
    """The run of the extras path for ``drive_main_path``: it prints the
    budget multiplier's transitions, the visibility loss and the bright-ray
    share at every progress line, and fails unless the normals' detach
    ends in a schedule event at iteration 100."""
    from nmf_tpu_torch.train import reconstruction

    cfg = config.compose(EXTRAS)

    def run(log):
        lines = []

        def logged(line):
            lines.append(line)
            log(line)

        res = reconstruction(cfg, log=logged)[1]
        grown = [ln.split(":")[0] + ln.split("mult")[1]
                 for ln in lines if "brdf budget mult" in ln]
        series = {k: [float(ln.split(f"{k}=")[1].split()[0])
                      for ln in lines if f" {k}=" in ln]
                  for k in ("visibility_loss", "bright_share")}
        if not any(ln.startswith("iter 100: schedule event")
                   for ln in lines):
            fail("extras: no schedule event at iteration 100, where the "
                 "bounce normals' detach ends")
        print(f"extras: budget multiplier x{res['budget_mult']} at the end, "
              f"transitions {grown or 'none'}; every "
              f"{cfg['progress_refresh_rate']} iterations: visibility loss "
              f"{series['visibility_loss']}, bright-ray share "
              f"{series['bright_share']}")
        return res, res["train_seconds"], (
            f", budget x{res['budget_mult']}, visibility loss "
            f"{res['visibility_loss']:.4f}, bright share "
            f"{res['bright_share']:.3f}")

    return run


# The heads path: the flagship at its shipped widths on synthetic_sphere
# with the shading heads' knobs: the material head's view encoder IPE
# (degree 4; the target builds PE, ROADMAP C.12), its roughness encoder
# RandRotISH (a degree-8 ListISH core and four rotated degree-8 copies)
# and pospe 4; the BRDF's dot products with their IPE (dotpe 2), the
# sigexp activation and a degree-8 diffuse-vector encoder; the softplus
# envmap with sh_grad (the SH projection's 5,000 lookups take the diffuse
# term's gradient: K3 at N = 20,000 SAT corner rows, C = 12, R = 691,456)
# and mipnoise 0.1, which no path draws (C.12). Cut as the flagship path:
# 450 iterations, the upsample at half, no rebuild (C.2).
HEADS_ITERS = FLAGSHIP_ITERS
HEADS_KNOBS = [
    f"{DM}.view_encoder._target_=modules.render_modules.IPE",
    f"{DM}.view_encoder.max_degree=4",
    f"{DM}.roughness_view_encoder._target_=modules.ish.RandRotISH",
    f"{DM}.pospe=4", "model.arch.model.brdf.dotpe=2",
    "model.arch.model.brdf.activation=sigexp",
    "model.arch.model.brdf.d_encoder.degs=[0,1,2,4,8]",
    "model.arch.bg_module.activation=softplus",
    "model.arch.bg_module.sh_grad=true", "model.arch.bg_module.mipnoise=0.1"]
HEADS = ["model=microfacet_tensorf2", "dataset=synthetic_sphere",
         f"model.params.n_iters={HEADS_ITERS}",
         f"field.upsamp_list=[{HEADS_ITERS // 2}]",
         "model.arch.sampler.update_list=[]", *HEADS_KNOBS, "device=cuda",
         f"basedir={LOG_DIR}", "expname=heads", "progress_refresh_rate=50"]
SH_SAT_ROWS = (592, 1168, 50 * 100 * 4)  # SAT rows, columns, corner rows


def heads_path(config):
    """The run of the heads path for ``drive_main_path``: it prints the
    envmap's gradient norm at the first train step (the map's gradient
    through the lookups and, with sh_grad, the SH projection), which must
    be finite and above 0."""
    from nmf_tpu_torch import trainer
    from nmf_tpu_torch.train import reconstruction

    cfg = config.compose(HEADS)

    def run(log):
        first = []
        step = trainer.train_step

        def recorded(nmf, *args, **kwargs):
            metrics = step(nmf, *args, **kwargs)
            if not first:
                grad = nmf.bg_module.bg_mat.grad
                first.append(0.0 if grad is None else float(grad.norm()))
            return metrics

        trainer.train_step = recorded
        try:
            res = reconstruction(cfg, log=log)[1]
        finally:
            trainer.train_step = step
        print(f"heads: the envmap's bg_mat gradient norm at the first step "
              f"{first[0]:.6e}")
        if not (math.isfinite(first[0]) and first[0] > 0):
            fail(f"heads: the first step's envmap gradient norm is "
                 f"{first[0]}")
        return res, res["train_seconds"], (
            f", first-step bg_mat gradient norm {first[0]:.4e}")

    return run


def paused_run(config, overrides, log, *renders):
    """Train ``overrides`` to its stop_iter pause, then render_only the
    pause checkpoint once per entry of ``renders`` (extra overrides).
    Returns the model, the pause's results and each render's test metrics
    with its ``seconds``."""
    from nmf_tpu_torch import train

    cfg = config.compose(overrides)
    nmf, res = train.reconstruction(cfg, log=log)
    if res.get("paused_at") != int(cfg["stop_iter"]):
        fail(f"{cfg['expname']}: the run did not pause at stop_iter: {res}")
    name = f"synthetic_sphere_{cfg['expname']}"
    ckpt = LOG_DIR / name / f"{name}_latest.th"
    rendered = []
    for i, extra in enumerate(renders):
        t0 = time.time()
        test = train.dispatch(config.compose(
            [*overrides, *extra, f"expname={cfg['expname']}_render{i}",
             "render_only=True", f"ckpt={ckpt}"]), log=log)[1]
        rendered.append(test | {"seconds": time.time() - t0})
    return nmf, res, rendered


def grid_path(torch, config):
    """The grid path's run for ``drive_main_path``; notes the card's peak
    allocated memory."""

    def run(log):
        torch.cuda.reset_peak_memory_stats()
        nmf, res, (test,) = paused_run(config, GRID_PATH, log, [])
        note = (f"; table {tuple(nmf.rf.grid_rows.shape)} f32, march "
                f"{nmf.sampler.n_samples} steps, card peak allocated "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        return res | test, res["train_seconds"], note

    return run


def tensorf_pe_path(config, k1):
    """The tensorf_pe path's run for ``drive_main_path``: training with
    the pretraining (its mean alpha printed beside start_density), then
    render_only of the pause checkpoint in batch and with stream=true.
    Fails unless the streamed PSNR clears the bar and lands within
    STREAM_DB of the batch one; notes the streaming eval's seconds and
    blocks a chunk: K1's (``k1``) launches at (chunk, 64), one a block,
    over the chunks of the streamed views."""
    import yaml

    def run(log):
        lines = []

        def logged(s):
            lines.append(s)
            log(s)

        nmf, res, (batch, streamed) = paused_run(
            config, TENSORF_PE, logged, [], ["stream=true"])
        pre = [ln for ln in lines if ln.startswith("pretrain density")]
        cfg = config.compose(TENSORF_PE)
        start = cfg["model"]["params"]["start_density"]
        print(f"tensorf_pe: {pre} (params.start_density {start})")
        if not pre:
            fail("tensorf_pe: no density pretraining ran")
        chunk = nmf.eval_batch_size
        stats = (LOG_DIR / f"synthetic_sphere_{cfg['expname']}_render1"
                 / "imgs_render" / "stats.yaml")
        views = len(yaml.safe_load(stats.read_text())["psnr"])
        chunks = views * -(-cfg["dataset"]["image_size"] ** 2 // chunk)
        blocks = k1.launches_by_size[(chunk, 64)] / chunks
        gap = streamed["psnr"] - batch["psnr"]
        print(f"tensorf_pe: streamed test PSNR {streamed['psnr']:.4f} dB "
              f"against batch {batch['psnr']:.4f} ({gap:+.4f} dB, bar "
              f"{STREAM_DB}); eval seconds {streamed['seconds']:.1f} "
              f"streamed, {batch['seconds']:.1f} batch; {blocks:.1f} "
              f"blocks a chunk over {chunks} chunks")
        if not (abs(gap) <= STREAM_DB and streamed["psnr"] > PSNR_BAR):
            fail(f"tensorf_pe: streamed PSNR {streamed['psnr']} against "
                 f"batch {batch['psnr']} (bars {STREAM_DB} dB, {PSNR_BAR} dB)")
        note = (f"; streamed {streamed['psnr']:.2f} dB in "
                f"{streamed['seconds']:.1f} s, {blocks:.1f} blocks a chunk")
        return res | batch, res["train_seconds"], note

    return run


def refnerf_studio_path(config, studio):
    """The Ref-NeRF studio path's run for ``drive_main_path``; prints its
    metrics beside the flagship studio path's (``studio``)."""
    from nmf_tpu_torch import train

    def run(log):
        _, res = train.reconstruction(config.compose(REFNERF_STUDIO),
                                      log=log)
        note = "".join(
            f", {k} {res[k]:.4f} (flagship studio {studio[k]:.4f})"
            for k in ("ssim", "norm_err", "tint_psnr")) + (
            f"; flagship studio PSNR {studio['psnr']:.2f} dB")
        return res, res["train_seconds"], note

    return run


@contextlib.contextmanager
def blend_records(blends):
    """Within the block, the normal blend each train step runs with
    (``predicted_normal_lambda``, set by the tick before it) is appended
    to ``blends``."""
    from nmf_tpu_torch import trainer

    step = trainer.train_step

    def recorded(nmf, *args, **kwargs):
        blends.append(float(nmf.predicted_normal_lambda.detach()))
        return step(nmf, *args, **kwargs)

    trainer.train_step = recorded
    try:
        yield
    finally:
        trainer.train_step = step


def refnerf_tcnn_path(torch, config):
    """The hash-grid path's run for ``drive_main_path``. Prints the normal
    blend at BLEND_AT and fails unless it read 0 and 1; prints the
    occupied share after every density sweep (not held to anything) and
    the card's peak allocated memory."""
    from nmf_tpu_torch import train

    def run(log):
        blends, shares = [], []
        torch.cuda.reset_peak_memory_stats()
        with blend_records(blends), occgrid_records(shares, []):
            nmf, res = train.reconstruction(config.compose(REFNERF_TCNN),
                                            log=log)
        read = {i: blends[i] for i in BLEND_AT}
        print(f"refnerf_tcnn: normal blend at iterations {read}")
        if not (0.0 in read.values() and 1.0 in read.values()):
            fail(f"refnerf_tcnn: the normal blend did not read 0 and 1: "
                 f"{read}")
        print(f"refnerf_tcnn: occupied share after each of {len(shares)} "
              "sweeps: " + " ".join(f"{x:.4f}" for x in shares))
        note = (f"; march {nmf.sampler.n_samples} steps of "
                f"{nmf.sampler.stepsize:.6f}, occupied share at the end "
                f"{shares[-1]:.4f}, card peak allocated "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        return res, res["train_seconds"], note

    return run


@contextlib.contextmanager
def retrace_shades(counts):
    """Within the block, ``counts`` counts RefNeRF.shade calls by
    recursion level."""
    from nmf_tpu_torch.models.refnerf import RefNeRF

    shade = RefNeRF.shade

    def counted(self, *args, recur=0, **kwargs):
        counts[recur] = counts.get(recur, 0) + 1
        return shade(self, *args, recur=recur, **kwargs)

    RefNeRF.shade = counted
    try:
        yield
    finally:
        RefNeRF.shade = shade


def dualref_path(config):
    """The dual path's run for ``drive_main_path``. Fails unless the switch
    to the microfacet model was the run's first schedule event, at
    DUALREF_SWITCH, followed by an optimizer rebuild, and Ref-NeRF shaded
    retrace passes."""
    from nmf_tpu_torch import train

    def run(log):
        lines, shades = [], {}

        def logged(s):
            lines.append(s)
            log(s)

        with retrace_shades(shades):
            nmf, res = train.reconstruction(config.compose(DUALREF),
                                            log=logged)
        events = [ln for ln in lines if "schedule event" in ln]
        print(f"dualref: schedule events {events}; RefNeRF.shade calls by "
              f"recursion level {shades}")
        if not (events and events[0].startswith(
                f"iter {DUALREF_SWITCH - 1}: schedule event -> optimizer "
                "reinit") and nmf.model.use_model2):
            fail(f"dualref: the switch at {DUALREF_SWITCH} with its "
                 f"optimizer rebuild did not run first: {events}")
        if not shades.get(1):
            fail("dualref: Ref-NeRF shaded no retrace pass")
        note = f"; RefNeRF.shade calls by recursion level {shades}"
        return res, res["train_seconds"], note

    return run


# ---- this slice: relighting, orbit paths, composition, the ray logger and
# dual-scene training ----


def check_small_relight(torch, dev):
    """This slice's modules on the card against the CPU, every random draw
    from one CPU generator for both: 5 steps of ``fit_pano`` at resolution
    16 on an HDR panorama (the first step's loss, gradients and Adam
    moments held at 1e-4 relative to each tensor's largest entry, 1e-3
    for the three scalars' sums; the tensors after 5 steps printed:
    Adam's first steps are ~lr * sign(g), so an entry whose gradient is
    within rounding of 0 may move either way); one ``render_path`` frame, two alternating dual-scene train steps
    (the loss, every gradient, and the update that Adam's moments give the
    inactive envmap) and ``collect_ray_debug`` of the tiny flagship, its
    envmaps' mip bias at 12 (``check_small_flagship``). Returns {check:
    max_abs_err}."""
    import numpy as np

    from nmf_tpu_torch import config, trainer
    from nmf_tpu_torch import eval as eval_lib
    from nmf_tpu_torch.builders import build_bg
    from nmf_tpu_torch.modules.dual_bg import MultiBG
    from nmf_tpu_torch.modules.logger import collect_ray_debug
    from nmf_tpu_torch.ops.draws import Draws
    from nmf_tpu_torch.scripts.pano2env import fit_pano

    cpu = torch.device("cpu")
    errs = {}
    pano = np.random.default_rng(0).gamma(0.6, 2.0, (16, 32, 3)).astype(
        np.float32)
    firsts, lasts = [], []
    for d in (dev, cpu):
        first = []

        def on_step(it, loss, tensors, grads, m, v, first=first):
            if it == 0:
                first += [loss, *grads, *(x.clone() for x in (*m, *v))]

        bg = fit_pano(pano, bg_resolution=16, iters=5, batch=4096, device=d,
                      log=lambda s: None, on_step=on_step)
        firsts.append(first)
        lasts.append([t.detach() for t in (bg.bg_mat, bg.mipbias,
                                           bg.brightness, bg.mul)])
    # the loss and the texels' gradients and moments to 1e-4 of each
    # tensor's largest entry; those of the three scalars (mip bias,
    # brightness, mul) to 1e-3: each is a sum over every texel of terms of
    # both signs, which the card's atomics add in another order (their
    # gradient 1.1e-4 off relative, its square 2.1e-4, in one run)
    errs["pano fit first step"] = max(
        max_err(torch, [(a.cpu(), b)], 1e-4,
                (1e-4 if i % 4 == 1 or i == 0 else 1e-3)
                * float(b.abs().max()) + 1e-12,
                f"small pano fit first step, tensor {i}")
        for i, (a, b) in enumerate(zip(*firsts)))
    errs["pano fit after 5 steps (not held)"] = max(
        float((a.cpu() - b).abs().max()) for a, b in zip(*lasts))

    cfg = config.compose(SMALL_FLAGSHIP)
    ds, nmfs = small_models(torch, dev, SMALL_FLAGSHIP)
    for nmf in nmfs:
        with torch.no_grad():
            nmf.bg_module.mipbias.fill_(12.0)
    frames = [eval_lib.render_path(
        nmf, (16, 16), float(ds["focal"]), n_frames=1, chunk=128,
        draws=Draws(torch.Generator().manual_seed(5)))[0] for nmf in nmfs]
    errs["render_path frame"] = max_err(
        torch, [(torch.from_numpy(frames[0]), torch.from_numpy(frames[1]))],
        1e-4, 1e-5, "small render_path frame")
    outs = []
    for nmf in nmfs:
        dbg = collect_ray_debug(nmf, torch.from_numpy(
            ds["all_rays"][:64]).to(nmf.rf.aabb.device))
        outs.append([dbg["xyz"], dbg["weights"], dbg["valid"].float(),
                     dbg["normals"]])
    errs["collect_ray_debug"] = max_err(
        torch, [(a.cpu(), b) for a, b in zip(*outs)], 1e-4, 1e-5,
        "small collect_ray_debug")

    opts, draws = [], []
    for nmf in nmfs:
        d = nmf.rf.aabb.device
        nmf.bg_module = MultiBG([nmf.bg_module, build_bg(
            cfg["model"]["arch"]["bg_module"]).to(d)])
        with torch.no_grad():
            nmf.bg_module.bgs[1].mipbias.fill_(12.0)
            nmf.bg_module.bgs[1].bg_mat.add_(0.3)
        opts.append(trainer.Optimizer(nmf, trainer.OptimConfig(n_iters=10)))
        draws.append(Draws(torch.Generator().manual_seed(6)))
    err = 0.0
    for step in range(2):
        runs = []
        for nmf, opt, dr in zip(nmfs, opts, draws):
            d = nmf.rf.aabb.device
            nmf.bg_module.select(step)
            ids = slice(64 * step, 64 * step + 64)
            before = nmf.bg_module.bgs[0].bg_mat.detach().clone()
            metrics = trainer.train_step(
                nmf, opt, torch.from_numpy(ds["all_rays"][ids]).to(d),
                torch.from_numpy(ds["all_rgbs"][ids]).to(d),
                (1.0, 1.0, 1.0), trainer.LossWeights(l1_weight=8e-5),
                draws=dr.scoped(f"{step}"))
            # envmap 0 is active at step 0, inactive at step 1 (no
            # gradient: Adam's moments move it)
            runs.append([metrics["loss"]] + [
                t.grad for _, t, _ in trainer.differentiated_tensors(nmf)
                if t.grad is not None]
                + [nmf.bg_module.bgs[0].bg_mat.detach() - before])
        if len(runs[0]) != len(runs[1]) or len(runs[0]) < 20:
            fail(f"small dual step {step}: the card and the CPU "
                 "differentiated other tensors")
        if step == 1 and not float(runs[0][-1].abs().max()) > 0:
            fail("small dual steps: the inactive envmap did not move")
        # each tensor to 1e-3 of its largest entry, plus 1e-6 of the step's
        # largest gradient: a frozen scalar's gradient (the shading
        # model's std) is a sum of terms of both signs, whose rounding
        # follows the terms, not the sum
        top = max(float(b.abs().max()) for b in runs[1][1:-1])
        for i, (a, b) in enumerate(zip(*runs)):
            scale = float(b.abs().max())
            err = max(err, max_err(torch, [(a.cpu(), b)], 1e-3,
                                   1e-3 * scale + 1e-6 * top + 1e-9,
                                   f"small dual step {step}, tensor {i}"))
        # the next step starts from the CPU's state on both
        with torch.no_grad():
            for (_, a, _), (_, b, _) in zip(
                    *(trainer.differentiated_tensors(n) for n in nmfs)):
                a.copy_(b)
            for x, y in zip(opts[0].m + opts[0].v, opts[1].m + opts[1].v):
                x.copy_(y)
    errs["dual steps"] = err
    for what, err in errs.items():
        print(f"small {what}, card vs CPU: max_abs_err {err:.3e}")
    return errs


def check_small_extras(torch, dev):
    """The extras slice on the card against the CPU: one train step and one
    eval render of the tiny flagship with each option of
    ``SMALL_EXTRAS_OPTIONS`` (``check_small_flagship``); one with the
    visibility module on and every loss extra (Charbonier, the envmap TV,
    the normal error against unit normals) and the optimizer's clip and
    weight decay, whose first Adam moments are compared too; then a tiny
    run on the card with the budget controller (budgets [128, 64]: the
    batch asks for > 2x them), which must grow them x2 after step 15.
    Prints and returns {check: max_abs_err}."""
    from nmf_tpu_torch import config, trainer
    from nmf_tpu_torch.train import reconstruction

    errs = {}
    for extra in SMALL_EXTRAS_OPTIONS:
        what = "flagship " + " ".join(o.rsplit(".", 1)[-1] for o in extra)
        # Beckmann draws half vectors from the normal alone: ~18% of its
        # reflections fall below the horizon and are flipped to graze the
        # surface, and the gradients through their retrace samples were
        # 1.2e-3 off between the card and the CPU (one density plane, one
        # run on an H100): 2e-3
        rtol = 2e-3 if "Beckmann" in what else 1e-3
        errs[what] = check_small_flagship(torch, dev, extra, what,
                                          grad_rtol=rtol)
    errs["flagship loss extras and weight decay"] = check_small_flagship(
        torch, dev, [VISIBILITY], "small flagship loss extras",
        weights=trainer.LossWeights(
            l1_weight=8e-5, ori_lambda=0.05, pred_lambda=1e-4,
            normal_err_lambda=1e-4, tv_weight_bg=0.01, charbonier=True),
        gt_normals=True,
        opt_cfg=trainer.OptimConfig(clip_grad=0.05, weight_decay=1e-3))
    lines = []
    res = reconstruction(config.compose([
        *SMALL_FLAGSHIP, f"device={dev.type}", "model.params.n_iters=20",
        "model.params.batch_size=64", "model.params.max_batch_size=64",
        "model.arch.model.brdf_ray_budget=[128,64]",
        "model.params.adapt_brdf_budget=true", "render_test=false",
        f"basedir={LOG_DIR}", "expname=small_budget",
        "progress_refresh_rate=1000"]), log=lines.append)[1]
    grown = [ln for ln in lines if "brdf budget mult" in ln]
    print(f"small budget controller on the card: {grown}, final multiplier "
          f"x{res['budget_mult']}, loss {res['loss']:.5f}")
    if not (grown and grown[0].startswith("iter 15: brdf budget mult -> x2")
            and math.isfinite(res["loss"])):
        fail(f"small budget controller: no transition at step 15 ({grown})")
    for what, err in errs.items():
        print(f"small {what}, card vs CPU: max_abs_err {err:.3e}")
    return errs


# The budgets slice's knobs, each alone in the tiny flagship: hdr with
# the HDR and the Linear curves, bf16 MLP operands, the march's superstep
# and its fine alpha test, two-stage and merged shading (4 of the 8
# proposal samples), the retrace proposal (4 of the 8 retrace samples)
# with the annealed pad
HDR_CURVE = "model.arch.tonemap._target_=modules.tonemap.HDRTonemap"
PAD_ANNEAL = ["model.arch.proposal_pad_init=0.5",
              "model.arch.proposal_pad_iters=10"]
SMALL_BUDGET_OPTIONS = (
    ["model.arch.hdr=true", HDR_CURVE],
    ["model.arch.hdr=true",
     "model.arch.tonemap._target_=modules.tonemap.LinearTonemap"],
    ["model.arch.mlp_dtype=bf16"],
    *([f"model.arch.sampler.superstep={n}"] for n in (0, 2, 8)),
    ["model.arch.sampler.fine_alpha_test=false"],
    ["model.arch.app_samples_per_ray=4"], ["model.arch.merge_runs=4"],
    ["model.arch.recur_proposal_samples_per_ray=4", *PAD_ANNEAL])


def check_small_budgets(torch, dev):
    """The budgets slice on the card against the CPU: one train step and
    one eval render of the tiny flagship with each knob of
    ``SMALL_BUDGET_OPTIONS`` (``check_small_flagship``). bf16 operands'
    gradients are held to 5e-2 of each tensor's largest: the card's and
    the CPU's f32 products differ in their last bits, which flips some
    bf16 roundings of the next layer's inputs (2^-8 each). Prints and
    returns {check: max_abs_err}."""
    errs = {}
    for extra in SMALL_BUDGET_OPTIONS:
        what = "flagship " + " ".join(o.rsplit(".", 1)[-1] for o in extra)
        errs[what] = check_small_flagship(
            torch, dev, extra, what,
            grad_rtol=5e-2 if "mlp_dtype=bf16" in extra[0] else 1e-3)
    for what, err in errs.items():
        print(f"small {what}, card vs CPU: max_abs_err {err:.3e}")
    return errs


# The shading heads' knobs, in the tiny flagship (and the tiny Ref-NeRF for
# the reflection encoder): every direction encoder as the material head's
# view encoder and, shifted by one, as its roughness encoder (the first
# pair with pospe 4: the heads path's); every encoder as Ref-NeRF's
# reflection encoder; the other material heads; the BRDF's dotpe and
# sigexp; the envmap's other activations and sh_grad (the map's gradient
# among those compared)
ENCODERS = (("modules.ish.ListISH", ["degs=[0,1,2,4,8]"]),
            ("modules.ish.FullISH", ["max_degree=4"]),
            ("modules.ish.FullISHScaled", ["max_degree=3"]),
            ("modules.render_modules.IPE", ["max_degree=4"]),  # builds PE
            ("modules.ish.ISH", ["max_degree=4"]),
            ("modules.ish.RandISH", []),
            ("modules.ish.RandRotISH", []))
SMALL_REFNERF = ["model=refnerf", *SMALL_FLAGSHIP[1:9],
                 "model.arch.sampler.update_list=[]"]


def encoder_overrides(key, i):
    target, kw = ENCODERS[i % len(ENCODERS)]
    return [f"{key}._target_={target}", *(f"{key}.{o}" for o in kw)]


SMALL_HEADS_OPTIONS = (
    *([*encoder_overrides(f"{DM}.view_encoder", i + 3),
       *encoder_overrides(f"{DM}.roughness_view_encoder", i + 6),
       *([f"{DM}.pospe=4"] if i == 0 else [])]
      for i in range(len(ENCODERS))),
    [f"{DM}._target_=modules.render_modules.HydraMLPDiffuse",
     f"{DM}.featureC=16", f"{DM}.num_layers=2"],
    [f"{DM}._target_=modules.render_modules.MLPDiffuse", f"{DM}.pospe=2",
     f"{DM}.featureC=16", f"{DM}.num_layers=2"],
    [f"{DM}._target_=modules.render_modules.PassthroughDiffuse"],
    ["model.arch.model.brdf.dotpe=0"], ["model.arch.model.brdf.dotpe=2"],
    ["model.arch.model.brdf.activation=sigexp"],
    *([f"model.arch.bg_module.activation={a}"]
      for a in ("softplus", "clip", "identity")),
    ["model.arch.bg_module.sh_grad=true"])


def check_small_specular(torch, dev):
    """The Specular BRDF alone (nmf_tpu's Microfacet cannot build it,
    ROADMAP C.12), at num_layers 0 (C0 the identity of the features) and
    1: its weights of 4096 random bounce rays and their gradients to the
    features, the local vectors and C0's MLP, card against CPU. Returns
    the largest error."""
    import copy

    from nmf_tpu_torch.modules.brdf import init_specular

    gen = torch.Generator().manual_seed(5)
    R, err = 4096, 0.0

    def unit():
        v = torch.randn((R, 3), generator=gen)
        v = v / v.norm(dim=-1, keepdim=True)
        return v * torch.sign(v[:, 2:3])

    args = [unit() for _ in range(7)] + [
        torch.randn((R, 24), generator=gen) * 0.5,
        0.05 + 0.85 * torch.rand(R, generator=gen),
        0.05 + 0.85 * torch.rand(R, generator=gen)]
    for num_layers in (0, 1):
        spec = init_specular(24, bias=0.2, hidden_w=16,
                             num_layers=num_layers, generator=gen)
        runs = []
        for d, mod in ((dev, copy.deepcopy(spec).to(dev)),
                       (torch.device("cpu"), spec)):
            ins = [a.to(d).clone().requires_grad_(i >= 4)
                   for i, a in enumerate(args)]
            out = mod(*ins)
            (out ** 2).sum().backward()
            runs.append([out.detach()] + [a.grad for a in ins[4:]]
                        + [p.grad for p in mod.parameters()])
        pairs = [(a.cpu(), b) for a, b in zip(*runs)]
        err = max(err, max_err(torch, pairs[:1], 1e-4, 1e-5,
                               f"small Specular {num_layers} weights"))
        for i, (a, b) in enumerate(pairs[1:]):
            err = max(err, max_err(
                torch, [(a, b)], 1e-3, 1e-4 * float(b.abs().max()) + 1e-9,
                f"small Specular {num_layers} gradient {i}"))
    return err


def check_small_heads(torch, dev):
    """The heads slice on the card against the CPU, at
    ``check_small_extras``' tolerances: one train step and one eval render
    of the tiny flagship with each knob of ``SMALL_HEADS_OPTIONS``, of the
    tiny Ref-NeRF with each reflection encoder, and the Specular module
    alone. RandISH's bases sum Legendre polynomials of degree up to 9 in
    monomials, whose coefficients reach 95 (P_9): f32 evaluates them to
    ~1e-5 of their value, and the card's pow rounds otherwise than the
    CPU's. As the material head's view encoder that moved the appearance
    planes' and lines' gradients (their largest 3e-6 to 1e-5 of the step's
    largest gradient, sums of terms that cancel) by up to 1.5e-6 of the
    step's largest gradient (one run on an H100): with a RandISH encoder
    every gradient also gets 5e-6 of it. Prints and returns {check:
    max_abs_err}."""
    def label(o):
        k, v = o.split("=", 1)
        return ".".join(k.split(".")[-2:]) + "=" + v.rsplit(".", 1)[-1]

    errs = {}
    for extra in SMALL_HEADS_OPTIONS:
        what = "flagship " + " ".join(map(label, extra))
        floor = 5e-6 if any(o.endswith("ish.RandISH") for o in extra) \
            else 0.0
        errs[what] = check_small_flagship(torch, dev, extra, what,
                                          grad_floor=floor)
    for i in range(len(ENCODERS)):
        extra = encoder_overrides("model.arch.model.ref_module.ref_encoder",
                                  i)
        what = f"refnerf ref_encoder {ENCODERS[i][0].rsplit('.', 1)[-1]}"
        errs[what] = check_small_flagship(torch, dev, extra, what,
                                          base=SMALL_REFNERF)
    errs["Specular module"] = check_small_specular(torch, dev)
    for what, err in errs.items():
        print(f"small {what}, card vs CPU: max_abs_err {err:.3e}")
    return errs


MULTIRUN_DIR = LOG_DIR / "multirun"


def start_multirun(dev):
    """Start ``python -m nmf_tpu_torch.train -m`` on the card in a process
    of its own: two tiny model=tensorf jobs swept over n_iters. It runs
    beside the tiny checks, which compare values, not times."""
    shutil.rmtree(MULTIRUN_DIR, ignore_errors=True)
    return subprocess.Popen(
        [sys.executable, "-m", "nmf_tpu_torch.train", "-m",
         *SMALL_TENSORF, f"device={dev.type}", "model.params.n_iters=3,5",
         "model.params.batch_size=512", "N_vis=1",
         f"basedir={MULTIRUN_DIR}", "expname=m"], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def check_multirun(proc, t0):
    """The multirun of ``start_multirun`` must exit 0 and write two run
    folders (config, checkpoint, test images)."""
    out, err = proc.communicate(timeout=600)
    if proc.returncode != 0:
        fail(f"multirun exited {proc.returncode}: {err[-2000:]}")
    jobs = [ln for ln in out.splitlines() if "[multirun" in ln]
    for n in (3, 5):
        folder = MULTIRUN_DIR / f"synthetic_sphere_m-n_iters{n}"
        for name in ("config.yaml", f"synthetic_sphere_m-n_iters{n}.th",
                     "imgs_test_all/mean.txt"):
            if not (folder / name).exists():
                fail(f"multirun: {folder / name} was not written")
    print(f"multirun on the card: {jobs}, two run folders written, "
          f"{time.time() - t0:.1f} s beside the tiny checks")


def check_logged_rays():
    """The tensorf main path's log_rays: its final eval's rays.pkl must
    hold one bundle of at most 512 rays with finite weights. Returns its
    sizes."""
    import pickle

    import numpy as np

    path = LOG_DIR / "synthetic_sphere_tensorf" / "imgs_test_all" / "rays.pkl"
    if not path.exists():
        fail(f"tensorf: log_rays=true wrote no {path}")
    with open(path, "rb") as f:
        entries = pickle.load(f)
    e = entries[0]
    sizes = {k: tuple(v.shape) for k, v in e.items()}
    print(f"tensorf: {path.name} holds {len(entries)} bundle(s), {sizes}, "
          f"weights sum {float(e['weights'].sum(1).mean()):.4f} a ray")
    if not (len(entries) == 1 and 0 < e["rays"].shape[0] <= 512
            and np.isfinite(e["weights"]).all()):
        fail(f"tensorf: rays.pkl is not one bundle of at most 512 rays with "
             f"finite weights: {sizes}")
    return sizes


# render_path=true on the flagship main path: its orbit (radius 4 at -30
# degrees, 60 frames of the test views' 64^2) is the sphere's camera ring,
# so every frame is held against the analytic scene on the same rays
ORBIT_FRAMES = 60


def check_orbit():
    """The flagship's imgs_path: ORBIT_FRAMES frame PNGs whose mean PSNR
    against ``data.synthetic.render_sphere_scene`` on the orbit's rays
    clears PSNR_BAR, and path.gif with ORBIT_FRAMES frames. Returns the
    mean PSNR."""
    import numpy as np
    from PIL import Image

    from nmf_tpu_torch import eval as eval_lib
    from nmf_tpu_torch.data.ray_utils import (get_ray_directions_blender,
                                              get_rays, pose_spherical)
    from nmf_tpu_torch.data.synthetic import render_sphere_scene

    folder = LOG_DIR / "synthetic_sphere_microfacet_tensorf2" / "imgs_path"
    size = 64
    focal = 0.5 * size / np.tan(0.5 * np.deg2rad(60.0))
    dirs = get_ray_directions_blender(size, size, [focal, focal])
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    psnrs = []
    for i in range(ORBIT_FRAMES):
        png = folder / "path" / f"{i:03d}.png"
        if not png.exists():
            fail(f"render_path: no frame {png}")
        frame = np.asarray(Image.open(png), np.float32)[..., :3] / 255
        rays_o, rays_d = get_rays(dirs, pose_spherical(
            360.0 * i / ORBIT_FRAMES, -30.0, 4.0))
        gt = render_sphere_scene(rays_o, rays_d)[0].reshape(size, size, 3)
        psnrs.append(-10 * np.log10(np.mean((frame - gt) ** 2)))
    n_gif = eval_lib.gif_frame_count(folder / "path.gif")
    mean = float(np.mean(psnrs))
    print(f"render_path: {ORBIT_FRAMES} frames against the analytic sphere: "
          f"mean PSNR {mean:.2f} dB (min {min(psnrs):.2f}, max "
          f"{max(psnrs):.2f}); path.gif holds {n_gif} frames (its time "
          "over a frame's)")
    if not mean > PSNR_BAR:
        fail(f"render_path: mean PSNR {mean} <= {PSNR_BAR} dB")
    if n_gif != ORBIT_FRAMES:
        fail(f"render_path: path.gif holds {n_gif} frames, not "
             f"{ORBIT_FRAMES}")
    return mean


# The relight path, on the studio path's final checkpoint and the panorama
# the Blender path writes (backgrounds/lego_bg.exr): pano2env's fit at its
# CLI defaults (an envmap of 1024 x 2048, 1000 iterations of 65,536
# pixels), then render_only with fixed_bg= the checkpoint's own envmap
# written as an envmap file (it must reproduce the studio render_only
# within RENDER_ONLY_DB) and with fixed_bg= the fit (its envmap metrics
# against the panorama must beat the studio model's learned envmap's).
# pano2env reads a panorama mirrored left to right against the gt_bg
# convention of the envmap metrics (nmf_tpu's arithmetic; ROADMAP C.9), so
# the fit is given lego_bg.exr mirrored, which it turns into the scene's
# environment.
FIT_ITERS = 1000
# the fit's extended SAT: (1024 + 2 x 40) x (2048 + 2 x 72) rows of 12
FIT_SAT_ROWS = (1024 + 80) * (2048 + 144)


def relight_path(config, studio):
    """The relight path's run for ``drive_main_path`` (its results: the
    identity relight's test metrics, the fit's last loss and lookups a
    second; its "train seconds": the fit's)."""
    import numpy as np

    from nmf_tpu_torch import ckpt, train
    from nmf_tpu_torch.data.exr import read_exr, write_exr
    from nmf_tpu_torch.scripts.pano2env import fit_pano, read_pano

    def run(log):
        final = (LOG_DIR / "synthetic_studio_studio"
                 / "synthetic_studio_studio.th")
        pano = DATA_DIR / "backgrounds" / "lego_bg.exr"
        mirrored = LOG_DIR / "relight" / "lego_bg_mirrored.exr"
        write_exr(mirrored, read_exr(pano)[:, ::-1])
        losses = {}

        def on_step(it, loss, *_):
            if it in (0, FIT_ITERS - 1):
                losses[it] = float(loss)

        torch_sync()
        t0 = time.time()
        fitted = fit_pano(read_pano(mirrored), iters=FIT_ITERS, log=log,
                          on_step=on_step)
        torch_sync()
        fit_seconds = time.time() - t0
        fit_file = LOG_DIR / "relight" / "fit.th"
        ckpt.save_envmap(fit_file, fitted, {"source": str(mirrored)})
        own = LOG_DIR / "relight" / "studio_envmap.th"
        ckpt.save_envmap(own, ckpt.load(final)[0].bg_module)
        print(f"relight: pano2env fit of {pano.name} (mirrored) at 1024 x "
              f"2048, {FIT_ITERS} iterations of 65,536 pixels in "
              f"{fit_seconds:.1f} s; loss first {losses[0]:.5f}, last "
              f"{losses[FIT_ITERS - 1]:.5f}")
        relit = {}
        for name, envmap in (("identity", own), ("fit", fit_file)):
            relit[name] = train.dispatch(config.compose(
                [*STUDIO, f"expname=relight_{name}", "render_only=True",
                 f"ckpt={final}", f"fixed_bg={envmap}"]), log=log)[1]
            print(f"relight with {name} envmap: {relit[name]}")
        gap = relit["identity"]["psnr"] - studio["render_only_psnr"]
        print(f"relight: identity {relit['identity']['psnr']:.4f} dB against "
              f"the studio render_only {studio['render_only_psnr']:.4f} dB "
              f"({gap:+.4f}); with the fit: PSNR "
              f"{relit['fit']['psnr']:.2f} dB, SSIM {relit['fit']['ssim']:.4f}"
              f", envmap_psnr {relit['fit']['envmap_psnr']:.2f} dB against "
              f"the learned envmap's {studio['envmap_psnr']:.2f} dB")
        if not abs(gap) <= RENDER_ONLY_DB:
            fail(f"relight: the identity relight is {gap:+.4f} dB off the "
                 f"studio render_only (bar {RENDER_ONLY_DB} dB)")
        if not relit["fit"]["envmap_psnr"] > studio["envmap_psnr"]:
            fail(f"relight: the fitted envmap's envmap_psnr "
                 f"{relit['fit']['envmap_psnr']} does not beat the learned "
                 f"one's {studio['envmap_psnr']}")
        res = dict(relit["identity"], loss=losses[FIT_ITERS - 1],
                   rays_per_sec=FIT_ITERS * 65536 / fit_seconds)
        note = (f"; fit {fit_seconds:.1f} s, relit with the fit "
                f"{relit['fit']['psnr']:.2f} dB, envmap_psnr "
                f"{relit['fit']['envmap_psnr']:.2f} dB")
        return res, fit_seconds, note

    return run


def torch_sync():
    import torch

    torch.cuda.synchronize()


# The compose path: compose_scenes with a flagship checkpoint twice, at
# x = -1 and x = +1, relit by the relight path's fit, 8 frames of 64^2 at
# the script's default radius. The checkpoint is the studio path's: the
# script rebuilds the alpha mask from the composed density, and the sphere
# flagship's density stays under the mask threshold through its 600
# iterations (ROADMAP C.2), so its composition renders blank.
COMPOSE_FRAMES = 8


def compose_path():
    """The compose path's run for ``drive_main_path``: fails unless every
    frame is finite and not blank."""
    import numpy as np

    from nmf_tpu_torch.scripts import compose_scenes

    def run(log):
        flagship = (LOG_DIR / "synthetic_studio_studio"
                    / "synthetic_studio_studio.th")
        torch_sync()
        t0 = time.time()
        frames = compose_scenes.main([
            "--ckpt", str(flagship), "--ckpt", str(flagship),
            "--offset=-1,0,0", "--offset=1,0,0",
            "--bg", str(LOG_DIR / "relight" / "fit.th"),
            "--out", str(LOG_DIR / "compose"),
            "--frames", str(COMPOSE_FRAMES), "--image-size", "64"])
        torch_sync()
        seconds = time.time() - t0
        stack = np.stack(frames)
        print(f"compose: {len(frames)} frames {stack.shape[1:]} in "
              f"{seconds:.1f} s, mean {stack.mean():.4f}, min "
              f"{stack.min():.4f}")
        if not (len(frames) == COMPOSE_FRAMES and np.isfinite(stack).all()
                and stack.min() < 0.9):
            fail("compose: the frames are not finite, or blank")
        return ({"rays_per_sec": stack[..., 0].size / seconds}, seconds,
                "")

    return run


# The dual-scene path: model=microfacet_tensorf2 at its shipped widths on two
# scenes of one object under two lights: dataset=lego (the Blender path's
# studio scene) and dataset2 the studio scene with its environment turned
# by 180 degrees about +z (lego2, written here with its panorama
# lego2_bg.exr): one field, one envmap a scene. Both take the studio
# cameras' near_far [1.4, 5.0]: dual_lego.yaml's [2.5, 7] clips the
# objects (at camera radius 3.2 the nearest surfaces lie ~2.0 away). Not
# the generator's env_bg=True copy: its background pixels are opaque where
# the first scene's are transparent, on the same rays of the same shared
# field. The studio knobs, DUAL_ITERS iterations with two events: the
# upsample at half way and the mask rebuild at three quarters (the dual
# loop restarts the lr schedule at every event, as nmf_tpu's; a rebuild
# before the density clears the mask threshold culls the scene, ROADMAP
# C.2).
DUAL_ITERS = 600
DUAL = ["dataset=lego", "dataset2=lego",
        "dataset2.scenedir=nerf_synthetic/lego2",
        "dataset.near_far=[1.4,5.0]", "dataset2.near_far=[1.4,5.0]",
        f"datadir={DATA_DIR}", *STUDIO_KNOBS,
        f"model.params.n_iters={DUAL_ITERS}",
        f"field.upsamp_list=[{DUAL_ITERS // 2}]",
        f"model.arch.sampler.update_list=[{3 * DUAL_ITERS // 4}]", "N_vis=4",
        "expname=lego"]
DUAL_YAW = 180.0


def lego2_split(split):
    """The dual_scene path's second scene: the studio scene with its light
    turned by DUAL_YAW, 12 views of 128^2 a split."""
    from nmf_tpu_torch.data.synthetic import make_shiny_dataset

    return make_shiny_dataset(n_views=12, H=128, W=128, split=split,
                              hemisphere=True, scene="studio",
                              env_yaw_deg=DUAL_YAW)


# The later paths' scenes are generated on the host by two worker
# processes (SCENE_WORKERS) while the card trains the first paths of each
# lane (generated in line they took ~80 s of the script): the studio
# scene and its turned-light copy, the hdr path's EXR frames and the LLFF
# scene, each marked done in SCENE_MARKS (its seconds, or the error that
# stopped it), where a lane waits for it (``wait_mark``).
SCENE_WORKERS = (("studio", "lego2"), ("hdr", "llff"))
SCENE_MARKS = LOG_DIR / "marks"


def mark(name, info):
    """Publish ``info`` (JSON) as the mark ``name``, atomically."""
    SCENE_MARKS.mkdir(parents=True, exist_ok=True)
    tmp = SCENE_MARKS / f".{name}.{os.getpid()}"
    tmp.write_text(json.dumps(info))
    os.replace(tmp, SCENE_MARKS / f"{name}.json")


def wait_mark(name, timeout=900.0):
    """Wait for the mark ``name`` and return its info; fails if it holds
    an error or does not come within ``timeout`` seconds."""
    path, t0 = SCENE_MARKS / f"{name}.json", time.time()
    while not path.exists():
        if time.time() - t0 > timeout:
            fail(f"{name}: not marked done within {timeout:.0f} s")
        time.sleep(0.2)
    info = json.loads(path.read_text())
    if "error" in info:
        fail(f"{name}: {info['error']}")
    return info


def prepare_scenes(cache_dir, names):
    """Generate the scenes ``names`` in this process, in order, marking
    each done with its seconds: the studio scene and lego2 into the
    dataset cache, the hdr path's frames and the LLFF scene to disk."""
    import traceback

    os.environ["NMF_DATASET_CACHE"] = cache_dir
    sys.stdout.reconfigure(line_buffering=True)
    from nmf_tpu_torch import config
    from nmf_tpu_torch.data import load_dataset

    def studio():
        ds = config.compose([*STUDIO, "expname=studio"])["dataset"]
        for split in ("train", "test"):
            load_dataset(ds, None, split)

    def lego2():
        for split in ("train", "test"):
            lego2_split(split)

    makers = {"studio": studio, "lego2": lego2,
              "hdr": lambda: {"over": write_hdr_scene(config)},
              "llff": lambda: write_llff_scene(config)}
    for name in names:
        t0 = time.time()
        try:
            info = makers[name]() or {}
        except Exception:
            mark(name, {"error": traceback.format_exc()})
            raise
        mark(name, info | {"seconds": round(time.time() - t0, 1)})


# The hdr path: the studio scene's linear radiance (the generator's
# foreground before the sRGB curve, values past 1 kept) as 32-bit EXR
# frames in nerf_synthetic layout, 24 train and 8 test views of 128^2
# (the studio path's cameras), read through dataset=materials_hdr with
# datadir set and the studio scene's near_far. The flagship at its
# shipped widths with hdr (the Huber loss, the HDR curve without the
# clip), bf16 MLP operands, superstep 8 and no fine alpha test, on the
# studio knobs: the first HDR_ITERS iterations of their 1000-iteration
# schedule (three upsamples, the first mask rebuild), paused, then
# render_only on the pause checkpoint, which writes the EXR dumps. (A run
# whose whole schedule is a few hundred iterations decays the learning
# rate before the flagship fits this scene: 200 of 200 iterations left
# it at its first-step PSNR, ~10.5 dB, on an H100.)
HDR_ITERS = 300
HDR_VIEWS = {"train": 24, "test": 8}
HDR = [*STUDIO_KNOBS, "dataset=materials_hdr", f"datadir={DATA_DIR}",
       "dataset.near_far=[1.4,5.0]", "model.arch.hdr=true", HDR_CURVE,
       "model.arch.mlp_dtype=bf16", "model.arch.sampler.superstep=8",
       "model.arch.sampler.fine_alpha_test=false",
       f"stop_iter={HDR_ITERS}", "expname=hdr"]


def write_hdr_scene(config):
    """Write the hdr path's scene (``make_shiny_dataset(linear=True)`` of
    the studio scene, its cameras) as EXR frames; returns the share of its
    foreground channels past 1."""
    import numpy as np

    from nmf_tpu_torch.data.blender import save_blender_split
    from nmf_tpu_torch.data.synthetic import make_shiny_dataset

    cfg = config.compose(HDR)
    over = []
    for split, n in HDR_VIEWS.items():
        gen = make_shiny_dataset(n_views=n, H=128, W=128, split=split,
                                 hemisphere=True, scene="studio",
                                 linear=True)
        rgba = gen["all_rgbs"]
        over.append(rgba[rgba[:, 3] > 0.5, :3] > 1)
        save_blender_split(DATA_DIR / cfg["dataset"]["scenedir"], split,
                           gen["poses"], rgba.reshape(n, 128, 128, 4),
                           np.deg2rad(55.0), exr=True)
    return float(np.concatenate(over).mean())


@contextlib.contextmanager
def kept_renders(eval_lib, maps):
    """Within the block, every ``eval_lib.render_image`` result is
    appended to ``maps``."""
    render_image = eval_lib.render_image

    def kept(*args, **kwargs):
        out = render_image(*args, **kwargs)
        maps.append(out)
        return out

    eval_lib.render_image = kept
    try:
        yield
    finally:
        eval_lib.render_image = render_image


def hdr_path(config):
    """The hdr path's run for ``drive_main_path`` (its scene written by
    ``prepare_scenes``): the paused training and render_only on its
    checkpoint, which must write one EXR a test view, each read back equal
    to the rgb_map it rendered."""
    import numpy as np

    from nmf_tpu_torch import train
    from nmf_tpu_torch.data.exr import read_exr

    def run(log):
        paused = train.reconstruction(config.compose(HDR), log=log)[1]
        if paused.get("paused_at") != HDR_ITERS:
            fail(f"hdr: the run did not pause at {HDR_ITERS}: {paused}")
        name = "materials_hdr_hdr"
        maps = []
        with kept_renders(train.eval_lib, maps):
            res = train.dispatch(config.compose([
                *HDR, "render_only=True", "expname=hdr_render",
                f"ckpt={LOG_DIR / name / f'{name}_latest.th'}"]),
                log=log)[1]
        out = LOG_DIR / "materials_hdr_hdr_render" / "imgs_render"
        dumps = sorted(out.glob("[0-9][0-9][0-9].exr"))
        if not dumps or len(dumps) != len(maps):
            fail(f"hdr: {len(dumps)} EXR dumps for {len(maps)} test views")
        for path, m in zip(dumps, maps):
            if not np.array_equal(read_exr(path), m["rgb_map"]):
                fail(f"hdr: {path.name} does not read back as its rgb_map")
        top = max(float(m["rgb_map"].max()) for m in maps)
        print(f"hdr: {len(dumps)} EXR dumps read back equal to the rendered "
              f"rgb_map, largest value {top:.3f}")
        res.update({k: paused[k] for k in
                    ("loss", "rays_per_sec", "thin_scale",
                     "thin_scale_retrace") if k in paused})
        return res, paused["train_seconds"], (
            f", {len(dumps)} EXR dumps equal, largest {top:.3f}")

    return run


# The budgets path: the flagship at its shipped widths on synthetic_sphere
# with run-collapsed shading (merge_runs 32 of the proposal's 96 samples),
# the retrace proposal (48 of the retrace pass's 96) and the pad annealed
# from 0.5 to the shipped 0.01 over two thirds of the merged run: the
# first 200 iterations of a 1000-iteration schedule (as the hdr path; the
# upsample at 100, no rebuild, C.2), paused and evaluated; then the same
# parameters with two-stage shading (app_samples_per_ray 48 in place of
# merge_runs, written into the pause checkpoint's config) for 50 more
# steps, paused and evaluated. Users: runs that trade shading samples for
# step time.
BUDGETS_ITERS, BUDGETS_TWO_STAGE, BUDGETS_SCHEDULE = 200, 50, 1000
MERGE_RUNS, APP_SAMPLES = 32, 48
BUDGETS = ["model=microfacet_tensorf2", "dataset=synthetic_sphere",
           f"model.params.n_iters={BUDGETS_SCHEDULE}",
           f"field.upsamp_list=[{BUDGETS_ITERS // 2}]",
           "model.arch.sampler.update_list=[]",
           "model.arch.recur_proposal_samples_per_ray=48",
           "model.arch.proposal_pad_init=0.5",
           f"model.arch.proposal_pad_iters={2 * BUDGETS_ITERS // 3}",
           "device=cuda", f"basedir={LOG_DIR}", "expname=budgets",
           "progress_refresh_rate=100"]
MERGED = [f"model.arch.merge_runs={MERGE_RUNS}", f"stop_iter={BUDGETS_ITERS}"]
TWO_STAGE = ["model.arch.merge_runs=0",
             f"model.arch.app_samples_per_ray={APP_SAMPLES}", "resume=true",
             f"stop_iter={BUDGETS_ITERS + BUDGETS_TWO_STAGE}"]


@contextlib.contextmanager
def pad_records(render, pads, every):
    """Within the block, (iteration, annealed pad) after each schedule
    tick at a multiple of ``every`` is appended to ``pads``."""
    tick = render.NMF.check_schedule

    def recorded(self, iteration):
        changed = tick(self, iteration)
        if iteration % every == 0:
            pads.append((iteration, float(self.proposal_pad_cur.detach())))
        return changed

    render.NMF.check_schedule = recorded
    try:
        yield
    finally:
        render.NMF.check_schedule = tick


def budgets_path(config):
    """The budgets path's run for ``drive_main_path`` (its results: the
    two-stage run's eval; the merged run's eval must clear the bar too). Then, on the trained model at full width: the two-stage render's
    acc_map of the first test view equals the full render's, bit for bit,
    and setting both knobs warns."""
    import warnings

    import torch

    from nmf_tpu_torch import ckpt, render, train
    from nmf_tpu_torch.data import load_dataset
    from nmf_tpu_torch.ops.draws import Draws

    # bound before drive_main_path wraps it, so the launch counts it reads
    # at its first evaluation are those of the whole path
    evaluate_fn = train.eval_lib.evaluate

    def run(log):
        pads = []
        cfg = config.compose([*BUDGETS, *MERGED])
        with pad_records(render, pads, BUDGETS_ITERS // 10):
            nmf, paused = train.reconstruction(cfg, log=log)
        if paused.get("paused_at") != BUDGETS_ITERS:
            fail(f"budgets: the merged run did not pause: {paused}")
        print("budgets: proposal pad at each tenth of the merged run "
              + " ".join(f"{i}: {p:.4f}" for i, p in pads))
        test = load_dataset(cfg["dataset"], None, "test")

        def evaluate(nmf, label):
            return evaluate_fn(
                nmf, test, save_dir=str(LOG_DIR / f"budgets_{label}"),
                n_vis=cfg["N_vis"], seed=int(cfg["seed"]))

        merged = evaluate(nmf, "merged")
        print(f"budgets: merged shading (merge_runs {MERGE_RUNS}), test PSNR "
              f"{merged['psnr']:.2f} dB at {BUDGETS_ITERS} iterations")
        if not merged["psnr"] > PSNR_BAR:
            fail(f"budgets: merged test PSNR {merged['psnr']} <= {PSNR_BAR}")
        # the same parameters, two-stage shading in place of the merge
        name = "synthetic_sphere_budgets"
        latest = LOG_DIR / name / f"{name}_latest.th"
        two_cfg = config.compose([*BUDGETS, *TWO_STAGE])
        dev = torch.device(two_cfg["device"])
        saved, _, extra = ckpt.load(latest, device=dev)
        ckpt.save(latest, saved, two_cfg, extra=extra)
        nmf, paused2 = train.reconstruction(two_cfg, log=log)
        if paused2.get("paused_at") != BUDGETS_ITERS + BUDGETS_TWO_STAGE:
            fail(f"budgets: the two-stage run did not pause: {paused2}")
        res = evaluate(nmf, "two_stage") | {
            k: paused2[k] for k in ("loss", "rays_per_sec", "thin_scale",
                                    "thin_scale_retrace") if k in paused2}
        W, H = test["img_wh"]
        rays = torch.from_numpy(test["all_rays"][:W * H]).to(dev)
        acc = []
        with torch.no_grad():
            for app in (APP_SAMPLES, -1):
                nmf.app_samples_per_ray = app
                acc.append(torch.cat([render.render(
                    nmf, rays[i:i + 4096], draws=Draws(
                        torch.Generator(device=dev).manual_seed(i)),
                    bg_cache=nmf.bg_module.prepare())[0]["acc_map"]
                    for i in range(0, rays.shape[0], 4096)]))
            if not torch.equal(*acc):
                fail("budgets: the two-stage acc_map differs from the full "
                     f"render's by {float((acc[0] - acc[1]).abs().max())}")
            nmf.app_samples_per_ray, nmf.merge_runs = APP_SAMPLES, MERGE_RUNS
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                render.render(nmf, rays[:4096], draws=Draws(
                    torch.Generator(device=dev).manual_seed(0)),
                    bg_cache=nmf.bg_module.prepare())
        if not any("merge_runs takes precedence" in str(w.message)
                   for w in caught):
            fail("budgets: no UserWarning with both knobs set")
        print(f"budgets: two-stage (app_samples_per_ray {APP_SAMPLES}) test "
              f"PSNR {res['psnr']:.2f} dB after {BUDGETS_TWO_STAGE} more steps; "
              "its acc_map of test view 0 equals the full render's; both "
              "knobs set warn")
        if not res["psnr"] > PSNR_BAR:
            fail(f"budgets: two-stage test PSNR {res['psnr']} <= {PSNR_BAR}")
        return res, paused["train_seconds"] + paused2["train_seconds"], (
            f", merged {merged['psnr']:.2f} dB, pad at the pause "
            f"{pads[-1][1]:.4f}")

    return run


def dual_path(config):
    """The dual-scene path's run for ``drive_main_path`` (its results: the
    lower of the two test PSNRs, with the last logged loss)."""
    import numpy as np

    from nmf_tpu_torch import ckpt
    from nmf_tpu_torch import eval as eval_lib
    from nmf_tpu_torch.data.blender import save_blender_split
    from nmf_tpu_torch.data.exr import read_exr, write_exr
    from nmf_tpu_torch.train_dualbg import reconstruction_dual

    def run(log):
        t0 = time.time()
        for split in ("train", "test"):
            gen = lego2_split(split)
            W, H = gen["img_wh"]
            save_blender_split(DATA_DIR / "nerf_synthetic" / "lego2", split,
                               gen["poses"],
                               gen["all_rgbs"].reshape(-1, H, W, 4),
                               np.deg2rad(55.0))
        write_exr(DATA_DIR / "backgrounds" / "lego2_bg.exr", gen["gt_bg_im"])
        print(f"dual_scene: lego2 (the studio scene, its light turned "
              f"{DUAL_YAW:g} degrees) read from the dataset cache and "
              f"written in {time.time() - t0:.1f} s")
        lines = []

        def logged(s):
            lines.append(s)
            log(s)

        cfg = config.compose(DUAL)
        torch_sync()
        t0 = time.time()
        nmf, results = reconstruction_dual(cfg, log=logged)
        torch_sync()
        seconds = time.time() - t0
        order = [ln.split()[2] for ln in lines if ln.startswith("iter ")
                 and " ds" in ln]
        env = [eval_lib.calc_envmap_metrics(bg, read_exr(
            DATA_DIR / "backgrounds" / name))["envmap_psnr"]
            for bg, name in zip(nmf.bg_module.bgs,
                                ("lego_bg.exr", "lego2_bg.exr"))]
        print(f"dual_scene: test PSNR {results[0]['psnr']:.2f} / "
              f"{results[1]['psnr']:.2f} dB, SSIM {results[0]['ssim']:.4f} /"
              f" {results[1]['ssim']:.4f}; envmap_psnr {env[0]:.2f} / "
              f"{env[1]:.2f} dB against their panoramas; logged scene order "
              f"{order}; {seconds:.1f} s with the evals")
        for i, r in enumerate(results):
            if not r["psnr"] > PSNR_BAR:
                fail(f"dual_scene: test split {i} at {r['psnr']} <= "
                     f"{PSNR_BAR} dB")
        if not (LOG_DIR / "dual_lego" / "dual_lego.th").exists():
            fail("dual_scene: no checkpoint dual_lego.th")
        try:
            ckpt.load(LOG_DIR / "dual_lego" / "dual_lego.th")
            fail("dual_scene: the dual checkpoint reloaded as a one-envmap "
                 "model")
        except NotImplementedError:
            pass
        loss = [float(ln.split("loss=")[1]) for ln in lines if "loss=" in ln]
        train_s = [float(ln.split()[-2]) for ln in lines
                   if ln.startswith("trained ")][0]
        res = {"psnr": min(r["psnr"] for r in results),
               "ssim": min(r["ssim"] for r in results), "loss": loss[-1],
               "rays_per_sec": DUAL_ITERS * 4096 / train_s}
        note = (f"; test PSNR {results[0]['psnr']:.2f} / "
                f"{results[1]['psnr']:.2f} dB, envmap_psnr {env[0]:.2f} / "
                f"{env[1]:.2f} dB")
        return res, train_s, note

    return run


# The distill path: scripts/fit_field.py at its CLI defaults (2,000 steps
# of 65,536 points, lr 1e-2) from the tensorf path's final checkpoint
# (300^3 after its upsample) to the dense grid (128^3, a 2,097,152-row
# table of 28 f32 columns) and to the hash field (16 levels of 2^19 x 2),
# each distilled checkpoint rendered by render_only on the sphere's test
# views, then scripts/export_mesh.py of the source and of both distilled
# checkpoints. The fit's backward launches K3 at sizes no other
# path launches: the grid's 8 corner rows a point, and the hash tables' 8
# corners of 16 levels a point (C = 2, the B.3 shape).
DISTILL_TARGETS = ("grid", "hashgrid")
DISTILL_STEPS, DISTILL_BATCH = 2000, 65536  # fit_field's defaults
# cut for the script's time (uncut, the whole script took 952.7 s on an
# H100, past its 950 s budget; PERF.md section 4): the hash fit's steps,
# then the distilled meshes' lattice (the source's stays at MESH_RESO)
FIT_STEPS = {"grid": DISTILL_STEPS, "hashgrid": 1000}
DISTILLED_MESH_RESO = 192
DISTILL_K3 = {"grid": (8 * DISTILL_BATCH, 28, 128 ** 3),
              "hashgrid": (8 * 16 * DISTILL_BATCH, 2, 16 * 2 ** 19)}
DISTILL_FIELDS = {"grid": "GridRF", "hashgrid": "HashGridRF"}
DISTILL_HELD = 65536     # held points of the density error
DISTILL_GAIN = 0.5       # nmf_tpu's bar (tests/test_extras.py:579-603)
MESH_RESO = 256
SPHERE_RADIUS, MESH_DB = 0.8, 0.1  # data/synthetic.py's sphere; the bar
# The marching level: the density at which one march step of the field
# absorbs MESH_ABSORB of the light, -ln(1 - MESH_ABSORB) / (distance_scale
# x the sampler's step), 0.84 / 0.34 / 1.45 for the source (300^3), the
# grid (128^3) and the hash field (grid_size 512). export_mesh's default, 5
# (nmf_tpu's), lies inside the learned sphere: its surface is a soft
# shell whose density stays under 5 (ROADMAP C.17); the level-5 mesh of
# the source has its outer surface at a median radius of 0.66 with 9% of
# the directions empty, and at level 1 the grid's lies at 0.68 (PERF.md
# section 6).
MESH_ABSORB = 0.1
# the mesh's outer surface: its outermost vertex in each of these
# (polar, azimuth) direction bins. The density inside the learned sphere
# is never seen by a ray and crosses the marching level too, so a mesh
# holds an inner shell, and the median radius of all its vertices reads
# that shell as much as the surface: the bar holds the outer surface.
MESH_BINS, MESH_COVER = (16, 32), 0.9
TENSORF_RUN = LOG_DIR / "synthetic_sphere_tensorf"
REEVAL_DB = 0.1          # the PNGs are 8-bit


def outer_radius(verts):
    """(the median over MESH_BINS direction bins of the outermost vertex's
    radius, the share of bins holding a vertex, every vertex's median
    radius) of a mesh's vertices (V, 3) about the origin."""
    import numpy as np

    if not len(verts):
        return float("nan"), 0.0, float("nan")
    r = np.linalg.norm(verts, axis=-1)
    polar = np.arccos(np.clip(verts[:, 2] / np.maximum(r, 1e-12), -1, 1))
    azimuth = np.arctan2(verts[:, 1], verts[:, 0]) + np.pi
    nb, na = MESH_BINS
    b = (np.minimum((polar / np.pi * nb).astype(int), nb - 1) * na
         + np.minimum((azimuth / (2 * np.pi) * na).astype(int), na - 1))
    outer = np.full(nb * na, -np.inf)
    np.maximum.at(outer, b, r)
    held = np.isfinite(outer)
    return (float(np.median(outer[held])), float(held.mean()),
            float(np.median(r)))


def distill_path(torch, config, tensorf):
    """The distill path's run for ``drive_main_path`` (its results: the
    last fit loss, the lower distilled test PSNR, rays/s as fitted points
    a second; its "train seconds": the two fits'). ``tensorf``: the
    tensorf path's results: reeval's bar and the source's test
    metrics."""
    import numpy as np

    from nmf_tpu_torch import ckpt, train
    from nmf_tpu_torch.builders import build_field
    from nmf_tpu_torch.scripts import export_mesh, fit_field, reeval

    def held_error(rf, xyz, src_sig):
        with torch.no_grad():
            return float((rf.compute_densityfeature(xyz, activate=False)
                          - src_sig).abs().mean())

    def render(name, path, log):
        return train.dispatch(config.compose(
            ["model=tensorf", "dataset=synthetic_sphere", "device=cuda",
             f"basedir={LOG_DIR}", f"expname=distill_{name}",
             "render_only=True", f"ckpt={path}"]), log=log)[1]

    def run(log):
        src_path = TENSORF_RUN / f"{TENSORF_RUN.name}.th"
        out_dir = LOG_DIR / "distill"
        out_dir.mkdir(parents=True, exist_ok=True)
        # reeval of the tensorf run's dumped test PNGs against its eval
        re = reeval.reeval_run(TENSORF_RUN, str(DATA_DIR), log=log)
        gap = re["psnr"] - tensorf["psnr"]
        print(f"distill: reeval of the tensorf run's PNGs {re['psnr']:.4f} "
              f"dB against its eval's {tensorf['psnr']:.4f} ({gap:+.4f}, "
              f"bar {REEVAL_DB}), SSIM {re['ssim']:.4f}")
        if not abs(gap) <= REEVAL_DB:
            fail(f"distill: reeval's PSNR is {gap:+.4f} dB off the tensorf "
                 f"path's eval (bar {REEVAL_DB} dB)")
        src, src_cfg, _ = ckpt.load(src_path)
        dev = src.rf.aabb.device
        gen = torch.Generator(device=dev).manual_seed(7)
        lo, hi = src.rf.aabb[0], src.rf.aabb[1]
        xyz = lo + (hi - lo) * torch.rand((DISTILL_HELD, 3), generator=gen,
                                          device=dev)
        with torch.no_grad():
            src_sig = src.rf.compute_densityfeature(xyz, activate=False)
        # the fits first, then every render: the path's launches a fit
        # step are its counts at the first evaluation
        fits, seconds = {}, 0.0
        for target in DISTILL_TARGETS:
            path = out_dir / f"{target}.th"
            cfg = fit_field.distilled_config(src_cfg, target, 128)
            before = held_error(build_field(
                torch.Generator().manual_seed(0), cfg["model"]["arch"]["rf"],
                src.rf.aabb.cpu().numpy()).to(dev), xyz, src_sig)
            fit = fit_field.main(["--ckpt", str(src_path), "--target", target,
                                  "--steps", str(FIT_STEPS[target]),
                                  "--out", str(path)])
            losses = fit["losses"]
            seconds += fit["seconds"]
            if not all(math.isfinite(x) for x in losses):
                fail(f"distill {target}: a logged fit loss is not finite: "
                     f"{losses}")
            nmf = ckpt.load(path)[0]
            kind = type(nmf.rf).__name__
            if kind != DISTILL_FIELDS[target]:
                fail(f"distill {target}: the file reloads as {kind}, not "
                     f"{DISTILL_FIELDS[target]}")
            after = held_error(nmf.rf, xyz, src_sig)
            drift = float((nmf.rf.aabb - src.rf.aabb).abs().max())
            del nmf
            step_ms = 1e3 * fit["seconds"] / FIT_STEPS[target]
            print(f"distill {target}: {FIT_STEPS[target]} steps in "
                  f"{fit['seconds']:.1f} s ({step_ms:.2f} ms a step, in its "
                  f"lane); loss first "
                  f"{losses[0]:.6f}, last {losses[-1]:.6f}; mean |density "
                  f"feature error| on {DISTILL_HELD} held points before "
                  f"{before:.5f}, after {after:.5f} (bar x{DISTILL_GAIN}); "
                  f"reloads as {kind}; its box moved by up to {drift:.4f} "
                  f"(ROADMAP C.16)")
            if not after <= DISTILL_GAIN * before:
                fail(f"distill {target}: the density error after the fit "
                     f"{after:.5f} is not within {DISTILL_GAIN} x the "
                     f"error before {before:.5f}")
            fits[target] = dict(loss=losses[-1], path=path)
        del src
        # the source's test metrics are the tensorf path's final eval (the
        # same views, seed and checkpoint)
        tests = {name: render(name, fits[name]["path"], log)
                 for name in DISTILL_TARGETS}
        tests["source"] = tensorf
        for target in DISTILL_TARGETS:
            print(f"distill {target}: test PSNR {tests[target]['psnr']:.2f} "
                  f"dB, SSIM {tests[target]['ssim']:.4f} against the "
                  f"source's {tests['source']['psnr']:.2f} dB, SSIM "
                  f"{tests['source']['ssim']:.4f}")
        for name in ("source", *DISTILL_TARGETS):
            ck = src_path if name == "source" else fits[name]["path"]
            nmf = ckpt.load(ck)[0]
            level = -math.log(1 - MESH_ABSORB) / (
                nmf.rf.distance_scale * nmf.sampler.stepsize)
            del nmf
            reso = MESH_RESO if name == "source" else DISTILLED_MESH_RESO
            mesh = export_mesh.main([str(ck), str(out_dir / f"{name}.ply"),
                                     "--reso", str(reso),
                                     "--level", f"{level:.6g}"])
            verts, faces = mesh["verts"], mesh["faces"]
            outer, cover, radius = outer_radius(verts)
            print(f"distill mesh of the {name} field at reso {reso}, "
                  f"level {level:.4f}: "
                  f"{len(verts)} vertices, {len(faces)} faces; the outer "
                  f"surface's median radius {outer:.4f} over {cover:.3f} of "
                  f"the direction bins (sphere {SPHERE_RADIUS}, bar "
                  f"{MESH_DB}, cover {MESH_COVER}); every vertex's median "
                  f"radius {radius:.4f}; density query "
                  f"{mesh['density']:.2f} s, marching {mesh['marching']:.2f}"
                  " s")
            if not (len(faces) and abs(outer - SPHERE_RADIUS) <= MESH_DB
                    and cover >= MESH_COVER):
                fail(f"distill: the {name} mesh's outer surface lies at a "
                     f"median radius {outer} over {cover} of the direction "
                     f"bins (bar {SPHERE_RADIUS} +- {MESH_DB}, cover "
                     f"{MESH_COVER})")
        worst = min(DISTILL_TARGETS, key=lambda t: tests[t]["psnr"])
        out = dict(tests[worst], loss=fits[worst]["loss"],
                   source_psnr=tests["source"]["psnr"],
                   rays_per_sec=sum(FIT_STEPS.values()) * DISTILL_BATCH
                   / seconds)
        note = ", distilled " + ", ".join(
            f"{t} {tests[t]['psnr']:.2f} dB" for t in DISTILL_TARGETS)
        return out, seconds, note + (f" against the source's "
                                     f"{tests['source']['psnr']:.2f} dB")

    return run


def check_small_distill(torch, dev):
    """The A.4 slice's modules on the card against the CPU: one fit_field
    step from a tiny TensorVMSplit (16^3) to a 24^3 grid and to a 4-level
    hash field of 2^10 rows (the loss at 1e-5; every gradient and Adam
    moment at 1e-4 of its tensor's largest, the box's at 1e-3: its
    gradient sums terms of every point that cancel, which the card adds
    in another order), density_volume at reso 64, graph_brdfs of the tiny
    flagship at res 16, the optics functions, the LearnableSphericalEncoding
    with its gradients, and LHyperGeom (1e-5 of the largest). Prints and
    returns {check: max_abs_err}."""
    import numpy as np

    from nmf_tpu_torch.fields.grid import init_grid_rf
    from nmf_tpu_torch.fields.hashgrid import init_hashgrid_rf
    from nmf_tpu_torch.fields.tensorf import init_tensorvm_split
    from nmf_tpu_torch.modules.ish import LHyperGeom
    from nmf_tpu_torch.modules.render_modules import (
        init_learnable_spherical_encoding)
    from nmf_tpu_torch.ops import optics
    from nmf_tpu_torch.ops.draws import Draws
    from nmf_tpu_torch.scripts import export_mesh, fit_field
    from nmf_tpu_torch.scripts.graph_brdfs import graph_brdfs

    cpu = torch.device("cpu")
    aabb = np.array([[-1.5] * 3, [1.5] * 3], np.float32)
    errs = {}
    for target, init, kw in (
            ("grid", init_grid_rf, dict(grid_size=(24, 24, 24))),
            ("hashgrid", init_hashgrid_rf,
             dict(n_levels=4, log2_hashmap_size=10))):
        runs = []
        for d in (dev, cpu):
            src = init_tensorvm_split(
                torch.Generator().manual_seed(0), aabb, grid_size=[16] * 3,
                N_voxel_init=16 ** 3, N_voxel_final=16 ** 3,
                upsamp_list=()).to(d)
            tgt = init(torch.Generator().manual_seed(1), aabb, **kw).to(d)
            xyz = fit_field.sample_points(
                Draws(torch.Generator().manual_seed(2)), 0, src.aabb, 4096)
            tensors = fit_field.fit_tensors(tgt)
            for t in tensors:
                t.requires_grad_(True)
            loss = fit_field.fit_loss(src, tgt, xyz)
            loss.backward()
            grads = [t.grad.clone() for t in tensors]
            opt = fit_field.FitAdam(tensors, 1e-2)
            opt.step()
            runs.append((loss.detach(), grads, opt.m, opt.v))
        (l0, g0, m0, v0), (l1, g1, m1, v1) = runs
        err = max_err(torch, [(l0.cpu(), l1)], 1e-5, 0.0,
                      f"small fit {target} loss")
        for i, (a, b) in enumerate(zip([*g0, *m0, *v0], [*g1, *m1, *v1])):
            box = i % len(g0) == len(g0) - 1
            err = max(err, max_err(
                torch, [(a.cpu(), b)], 0.0,
                (1e-3 if box else 1e-4) * float(b.abs().max()) + 1e-20,
                f"small fit {target} gradient / moment {i}"))
        errs[f"fit_field step, {target}"] = err

    src = [init_tensorvm_split(torch.Generator().manual_seed(0), aabb,
                               grid_size=[16] * 3, N_voxel_init=16 ** 3,
                               N_voxel_final=16 ** 3, upsamp_list=()).to(d)
           for d in (dev, cpu)]
    vols = [export_mesh.density_volume(types.SimpleNamespace(rf=rf), 64)[0]
            for rf in src]
    errs["density_volume 64"] = max_err(
        torch, [(torch.from_numpy(vols[0]), torch.from_numpy(vols[1]))],
        0.0, 1e-5 * float(np.abs(vols[1]).max()), "small density_volume")

    _, nmfs = small_models(torch, dev, SMALL_FLAGSHIP)
    rng = np.random.default_rng(4)
    xyz = np.concatenate([rng.uniform(-1, 1, (2, 3)), np.full((2, 1), 0.01)],
                         -1).astype(np.float32)
    v = rng.normal(size=(3, 3))
    v = (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)
    feats = rng.normal(size=(2, nmfs[0].rf.app_dim)).astype(np.float32)
    ims = [graph_brdfs(n.model, *(torch.from_numpy(a).to(n.rf.aabb.device)
                                  for a in (xyz, v, feats)), res=16)
           for n in nmfs]
    errs["graph_brdfs res 16"] = max_err(
        torch, [(ims[0].cpu(), ims[1])], 0.0,
        1e-5 * float(ims[1].abs().max()), "small graph_brdfs")

    n = torch.from_numpy(rng.normal(size=(257, 3)).astype(np.float32))
    n = n / n.norm(dim=-1, keepdim=True)
    l_ = torch.from_numpy(rng.normal(size=(257, 3)).astype(np.float32))
    l_ = l_ / l_.norm(dim=-1, keepdim=True)
    p = torch.from_numpy(rng.uniform(0, 1, 257).astype(np.float32))
    outs = []
    for d in (dev, cpu):
        o = optics.snells_law(1.5, n.to(d), l_.to(d))
        outs.append([o, optics.fresnel_law(1.0, 1.5, n.to(d), l_.to(d), o),
                     optics.refract_reflect(1.0, 1.33, n.to(d), l_.to(d),
                                            p.to(d))])
    errs["optics"] = max_err(torch, [(a.cpu(), b) for a, b in zip(*outs)],
                             1e-5, 1e-6, "small optics")

    vec = torch.from_numpy(v)
    sig = torch.from_numpy(rng.uniform(0.3, 0.5, (3, 1)).astype(np.float32))
    outs = []
    for d in (dev, cpu):
        enc = init_learnable_spherical_encoding(
            5, 100, generator=torch.Generator().manual_seed(3)).to(d)
        x = vec.to(d).requires_grad_(True)
        out = enc(x, sig.to(d))
        out.square().sum().backward()
        outs.append([out.detach(), enc.weights.grad, x.grad])
    errs["LearnableSphericalEncoding"] = max(
        max_err(torch, [(a.cpu(), b)], 0.0,
                1e-5 * float(b.abs().max()) + 1e-20,
                f"small LearnableSphericalEncoding output {i}")
        for i, (a, b) in enumerate(zip(*outs)))
    x = torch.linspace(-0.9, 0.9, 41)
    series = LHyperGeom((0.5,), (1.5,), 20)
    b = series(x)
    errs["LHyperGeom"] = max_err(torch, [(series(x.to(dev)).cpu(), b)], 0.0,
                                 1e-5 * float(b.abs().max()),
                                 "small LHyperGeom")
    for what, err in errs.items():
        print(f"small {what}, card vs CPU: max_abs_err {err:.3e}")
    return errs


# ---- the lanes: the main paths run in the LANES' processes at once
# on the one card, each lane's paths in turn. A step of these paths is
# bound by the host's launches (PERF.md section 5: the card is busy
# 13-41% of a flagship step), so the lanes' steps fill each other's idle
# time (the processes time-slice the card: a step takes ~1.9x its time
# alone with three lanes, on an H100). A lane
# drives its paths through ``drive_main_path`` with the kernels' counts of
# its own process; a launch at a size the kernels' checks did not hold is
# recorded there (K3 on its ids, moved to the host) and held by the main
# process after every lane is done (``hold_new_sizes``), so no device time
# is read while the lanes run. Each lane's paths in the order they depend
# on each other (the studio path's checkpoint, the occgrid model, the
# marked scenes); the largest on the card, refnerf_tcnn, allocates
# ~8 GiB in a lane's process.
# the paths in the order the main process holds them and reports them
# The bench path: nmf_tpu's measurement scripts, ported to
# nmf_tpu_torch/scripts, at their own sizes, in this process after the
# lanes (nothing else on the card): bench_scatter's alpha lookups,
# scatter variants and K3 against index_add_ (four sizes, hot ids among
# them), bench_gather's two layouts (K3 at N = 524,288, C = 72, bf16),
# bench_shade's lines (K1 / K2 at 4096 x 128, the stub shade's K3 at the
# bench budgets), bisect_shade's stages and parse_trace on a profiled
# window of the bisect's step. Its launches at new sizes are held after
# it, K1 / K2 timed. The bench's random-init model allocates no bounce ray
# (each sample's share, thinned to the budget, rounds to 0, as in
# nmf_tpu's bench; the budget's slots are computed all the same), so the
# bounce rays' segment sums and parent gathers launch with every id out
# of range or on one row: those sizes are held and timed on walk ids.
BISECT_STAGES = (0, 1, 2, 3, 4, 5, 6, 7, -1, -2)
TRACE_STEPS = 3
# K3 against zeros + index_add_ on the same f32 rows: the atomics add in
# another order (a hot row sums ~3,700 unit-scale values): 1e-5 of the
# largest sum
BINSUM_REL_TOL = 1e-5
# a bf16 scatter variant against the f32 sum of the same bf16 payload: no
# worse than twice plain index_add_'s own error (bf16 sums round at every
# add, in an order the atomics choose), or 2^-8 of the largest sum
SCATTER_ERR_FACTOR, SCATTER_ERR_FLOOR = 2.0, 2.0 ** -8
# bisect stage 0 against the unpatched step on the same draws: within
# twice the unpatched step's own spread between two runs (K3's atomics
# reorder f32 sums) or 1e-5 of the loss / 1e-4 of a gradient's largest
# entry, whichever is larger
STAGE0_LOSS_RTOL, STAGE0_GRAD_RTOL, STAGE0_SPREAD = 1e-5, 1e-4, 2.0
# parse_trace's total device time against the profiler's own kernel sum
TRACE_RTOL = 0.05


def check_scatter_rows(rows):
    """bench_scatter's variants against plain index_add_ (the bf16
    tolerance above)."""
    plain = {(r["M"], r["T"], r["D"], r["dist"]): r["f32_err"] for r in rows
             if r["variant"] == "plain index_add_"}
    for r in rows:
        limit = max(SCATTER_ERR_FACTOR * plain[r["M"], r["T"], r["D"],
                                               r["dist"]],
                    SCATTER_ERR_FLOOR)
        if not r["f32_err"] <= limit:
            fail(f"bench_scatter {r['variant']} at M={r['M']} T={r['T']} "
                 f"D={r['D']} {r['dist']}: error {r['f32_err']:.3e} against "
                 f"the f32 sum, over {limit:.3e}")


def check_stage0(torch, bisect_shade, nmf, rays, rgbs):
    """Bisect stage 0's loss and gradients against the unpatched step's, on
    the same draws (STAGE0_*). Returns the largest gradient error over its
    tensor's largest entry."""
    loss, grads = bisect_shade.loss_grads(nmf, rays, rgbs, seed=1)
    again, grads_again = bisect_shade.loss_grads(nmf, rays, rgbs, seed=1)
    with bisect_shade.staged(0):
        loss0, grads0 = bisect_shade.loss_grads(nmf, rays, rgbs, seed=1)

    def limit(spread, floor):
        return max(STAGE0_SPREAD * spread, floor)

    if not abs(float(loss0) - float(loss)) <= limit(
            abs(float(again) - float(loss)),
            STAGE0_LOSS_RTOL * abs(float(loss))):
        fail(f"bisect stage 0: loss {float(loss0)} against the step's "
             f"{float(loss)} ({float(again)} again)")
    worst = 0.0
    for i, (a, b, c) in enumerate(zip(grads0, grads, grads_again)):
        if (a is None) != (b is None):
            fail(f"bisect stage 0: gradient {i} present in only one run")
        if a is None:
            continue
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        spread = float((c - b).abs().max())
        if not (torch.isfinite(a).all()
                and err <= limit(spread, STAGE0_GRAD_RTOL * scale)):
            fail(f"bisect stage 0: gradient {i} off by {err:.3e} (largest "
                 f"entry {scale:.3e}, the step's own spread {spread:.3e})")
        worst = max(worst, err / max(scale, 1e-30))
    print(f"bench: bisect stage 0 against the unpatched step: loss "
          f"{float(loss0):.7f} / {float(loss):.7f}, worst gradient error "
          f"{worst:.2e} of its tensor's largest")
    return worst


def check_trace(torch, bisect_shade, parse_trace, nmf, rays, rgbs):
    """parse_trace on a Chrome trace of TRACE_STEPS bisect steps (stage 0
    is the step) against the profiler's own sum of device time over the
    same window. Returns (parse_trace ms, profiler ms) a step."""
    from torch.profiler import ProfilerActivity, profile

    from nmf_tpu_torch.scripts.profile_step import device_time_us

    trace_dir = LOG_DIR / "bench_trace"
    trace_dir.mkdir(parents=True, exist_ok=True)
    bisect_shade.loss_grads(nmf, rays, rgbs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACE_STEPS):
            bisect_shade.loss_grads(nmf, rays, rgbs)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace_dir / "bisect_step.json"))
    own = sum(device_time_us(e) for e in prof.key_averages()
              if e.device_type.name == "CUDA") / 1e3 / TRACE_STEPS
    if parse_trace.main([str(trace_dir), "--top", "15", "--group",
                         "--steps", str(TRACE_STEPS)]) != 0:
        fail("parse_trace: no device events in the bisect step's trace")
    parsed = sum(parse_trace.device_op_times(parse_trace.load_trace(
        parse_trace.newest_trace(trace_dir))).values()) / TRACE_STEPS
    print(f"bench: parse_trace total device time {parsed:.3f} ms a step, "
          f"the profiler's own kernel sum {own:.3f} ms")
    if not abs(parsed - own) <= TRACE_RTOL * own:
        fail(f"parse_trace: {parsed:.3f} ms a step against the profiler's "
             f"{own:.3f} ms")
    return parsed, own


def bench_path(torch, dev):
    """The bench path's run for ``drive_main_path``: each script's lines,
    held as the constants above say."""
    from nmf_tpu_torch.scripts import (bench_gather, bench_scatter,
                                       bench_shade, bisect_shade,
                                       parse_trace)

    def run(log):
        t0 = time.time()
        gen = torch.Generator(device=dev).manual_seed(0)
        bench_scatter.bench_alpha(gen)
        check_scatter_rows(bench_scatter.bench_scatter(gen))
        for r in bench_scatter.bench_binsum(gen):
            what = f"M={r['M']} T={r['T']} D={r['D']} {r['dist']}"
            if not r["rel_err"] <= BINSUM_REL_TOL:
                fail(f"bench_binsum at {what}: K3 off index_add_ by "
                     f"{r['rel_err']:.3e} of the largest sum")
            # ids, f32 rows read once; the touched rows written once
            b, by = bound_ms(4 * r["M"] * (1 + r["D"])
                             + 4 * r["touched"] * r["D"], r["M"] * r["D"])
            print(f"bench_binsum at {what}: {r['touched']} rows touched, "
                  f"K3 {r['binsum_ms']:.4f} ms (its memset included), "
                  f"zeros + index_add_ {r['index_add_ms']:.4f} ms, bound "
                  f"{b:.4f} ms by {by}")
        bench_gather.bench(gen)
        nmf, _ = bench_shade.bench_nmf(device=dev, **bench_shade.BENCH_SIZES)
        bench_shade.bench(nmf, gen)
        nmf.model.max_retrace_rays = ()
        rays, rgbs = bisect_shade.bisect_rays(bisect_shade.B_RAYS, dev)
        stage0 = check_stage0(torch, bisect_shade, nmf, rays, rgbs)
        stages = bisect_shade.bisect(nmf, rays, rgbs, BISECT_STAGES)
        parsed, own = check_trace(torch, bisect_shade, parse_trace, nmf,
                                  rays, rgbs)
        seconds = time.time() - t0
        del nmf
        return ({"rays_per_sec": bisect_shade.B_RAYS * 1e3 / stages[0],
                 "stage0_grad_err": stage0, "trace_ms": parsed,
                 "profiler_ms": own}, seconds, "")

    return run


PATH_ORDER = ("tensorf", "microfacet_tensorf2", "studio", "blender",
              "lego_size", "relight", "compose", "dual_scene", "hdr",
              "budgets", "extras", "occgrid", "occgrid_crop", "llff",
              "refnerf_studio", "refnerf_tcnn", "dualref", "grid",
              "tensorf_pe", "heads", "distill")


def host_entry(entry):
    """A BinsumRecorder entry with its ids on the host, to send."""
    step, idx, C, R, dtype = entry
    return step, idx.cpu().numpy(), C, R, str(dtype).removeprefix("torch.")


def device_entry(torch, dev, entry):
    """``host_entry``'s inverse, on ``dev``."""
    step, idx, C, R, dtype = entry
    return step, torch.from_numpy(idx).to(dev), C, R, getattr(torch, dtype)


class Lane:
    """One lane's kernels (each with the sizes the main process's checks
    held, and those first launched by this lane's earlier paths) and its
    report: for each path driven, its launches, and its launches at new
    sizes to hold."""

    def __init__(self, torch, held, card):
        from nmf_tpu_torch.ops.kernels import binsum as S
        from nmf_tpu_torch.ops.kernels import composite as C

        self.torch, self.card, self.report = torch, card, []
        self.kernels = [
            {"name": name, "kernel": kernel,
             "shapes": [{"sizes": tuple(s)} for s in held[name]]}
            for name, kernel in (("composite_fwd", C.COMPOSITE_FWD),
                                 ("composite_bwd", C.COMPOSITE_BWD),
                                 ("binsum_rows", S.BINSUM))]

    def drive(self, label, run, n_iters, steps=(), hold=True, new_k3=True,
              **kw):
        """``drive_main_path`` with K3's ids recorded at the train steps
        ``steps`` and (``new_k3``) at sizes not held yet; given ``hold``,
        the launches at new sizes are taken as held here and reported, to
        be held after the lanes. Returns the path's results."""
        torch = self.torch
        binsum = self.kernels[-1]
        held = {r["sizes"] for r in binsum["shapes"]} if new_k3 else None
        with BinsumRecorder(steps, held=held) as rec:
            launches, by_size, res = drive_main_path(
                torch, self.kernels, label, self.card, n_iters, run,
                hold=(lambda sizes: self.pend(label, sizes, rec)) if hold
                else None, **kw)
        self.report.append({
            "label": label, "launches": launches, "by_size": by_size,
            "held_after": hold, "touched": dict(rec.touched),
            "new": {size: host_entry(e) for size, e in rec.new.items()},
            "recorded": [host_entry(e) for e in rec.entries]})
        del rec
        torch.cuda.empty_cache()
        return res

    def pend(self, label, by_size, rec):
        """The new sizes of a path's launches (``by_size``; K3's recorded
        by ``rec``) join the lane's kernels' shapes. Fails if no launch at
        a new K3 size touched HELD_MIN_ROWS rows."""
        n_new = 0
        for k in self.kernels:
            held = {r["sizes"] for r in k["shapes"]}
            new = (set(rec.new) if k["name"] == "binsum_rows"
                   else set(by_size[k["name"]])) - held
            k["shapes"] += [{"sizes": s} for s in sorted(new)]
            n_new += len(new)
        for size, touched in rec.touched.items():
            if touched < HELD_MIN_ROWS:
                fail(f"{label}: no K3 launch at size {size} touched "
                     f"{HELD_MIN_ROWS} rows (at most {touched}), so its "
                     "recorded ids cannot hold the kernel")
        print(f"{label}: {n_new} kernel sizes first launched on this path, "
              "held after the lanes")


def lane_sphere(lane, config):
    """tensorf and the flagship (MAIN_PATHS) with the flagship's K3 ids of
    REPLAY_STEPS recorded, the logged rays and the orbit, then the distill
    path on tensorf's checkpoint, the extras, occgrid, occgrid_crop,
    budgets, tensorf_pe and dualref paths."""
    from nmf_tpu_torch.ops.kernels import composite as C
    from nmf_tpu_torch.train import reconstruction

    results = {}
    for label, overrides in MAIN_PATHS:
        cfg = config.compose([*overrides, "dataset=synthetic_sphere",
                              "device=cuda", f"basedir={LOG_DIR}",
                              f"expname={label}",
                              "progress_refresh_rate=100"])

        def run(log, cfg=cfg):
            res = reconstruction(cfg, log=log)[1]
            return res, res["train_seconds"], ""

        flagship = label == "microfacet_tensorf2"
        results[label] = lane.drive(
            label, run, int(cfg["model"]["params"]["n_iters"]),
            steps=REPLAY_STEPS if flagship else (), new_k3=False)
        if flagship and not lane.report[-1]["recorded"]:
            fail(f"no K3 launch was recorded at flagship steps "
                 f"{REPLAY_STEPS}")
    check_logged_rays()
    check_orbit()
    # the fits launch K3 (their backward), the renders K1; a distilled
    # PSNR under the bar is a finding, not a failure (ROADMAP C)
    lane.drive("distill", distill_path(lane.torch, config,
                                       results["tensorf"]),
               sum(FIT_STEPS.values()), psnr_bar=None,
               runs=("binsum_rows", "composite_fwd"))
    trained = {}
    lane.drive("extras", extras_path(config), EXTRAS_ITERS)
    lane.drive("occgrid", occgrid_path(config, trained), OCCGRID_ITERS)
    lane.drive("occgrid_crop", occgrid_crop_path(lane.torch, config, trained),
               CROP_STEPS)
    lane.drive("budgets", budgets_path(config),
               BUDGETS_ITERS + BUDGETS_TWO_STAGE)
    lane.drive("tensorf_pe", tensorf_pe_path(config, C.COMPOSITE_FWD),
               TENSORF_PE_ITERS)
    lane.drive("dualref", dualref_path(config), DUALREF_ITERS)


def lane_studio(lane, config):
    """The lego-size load, then the studio path (its K3 ids of
    STUDIO_REPLAY_STEPS recorded) and what reads its checkpoint or its
    scene: the Blender path, relight, compose, refnerf_studio and
    dual_scene (lego2 and the Blender path's scene)."""
    lane.drive("lego_size", lego_load_path(lane.torch, config), LEGO_STEPS,
               hold=False, new_k3=False, psnr_bar=None)
    print(f"studio scene: generated by a scene worker in "
          f"{wait_mark('studio')['seconds']} s")
    studio = lane.drive("studio", studio_path(config), STUDIO_ITERS,
                        steps=STUDIO_REPLAY_STEPS, hold=False, new_k3=False)
    if not lane.report[-1]["recorded"]:
        fail(f"no K3 launch was recorded at studio steps "
             f"{STUDIO_REPLAY_STEPS}")
    write_blender_scene(config)
    blender = lane.drive("blender", blender_path(config),
                         STUDIO_ITERS - STUDIO_PAUSE, hold=False,
                         new_k3=False)
    gap = blender["psnr"] - studio["psnr"]
    print(f"blender vs studio test PSNR: {blender['psnr']:.2f} - "
          f"{studio['psnr']:.2f} = {gap:+.2f} dB (bar {BLENDER_DB} dB)")
    if not abs(gap) <= BLENDER_DB:
        fail(f"blender: test PSNR {blender['psnr']} is not within "
             f"{BLENDER_DB} dB of the studio path's {studio['psnr']}")
    # the fit launches K3 (its backward), the renders K1
    lane.drive("relight", relight_path(config, studio), FIT_ITERS,
               runs=("binsum_rows", "composite_fwd"))
    lane.drive("compose", compose_path(), COMPOSE_FRAMES, psnr_bar=None,
               trains=False, runs=("composite_fwd",))
    lane.drive("refnerf_studio", refnerf_studio_path(config, studio),
               REFNERF_STUDIO_ITERS)
    print(f"lego2: generated by a scene worker in "
          f"{wait_mark('lego2')['seconds']} s")
    lane.drive("dual_scene", dual_path(config), DUAL_ITERS)


def lane_fields(lane, config):
    """heads, refnerf_tcnn and grid, then the paths on the workers' scene
    files: hdr and llff."""
    lane.drive("heads", heads_path(config), HEADS_ITERS)
    lane.drive("refnerf_tcnn", refnerf_tcnn_path(lane.torch, config),
               REFNERF_TCNN_ITERS)
    lane.drive("grid", grid_path(lane.torch, config), GRID_ITERS)
    hdr = wait_mark("hdr")
    print(f"hdr: scene written by a scene worker in {hdr['seconds']} s, "
          f"{hdr['over']:.4f} of its foreground channels past 1")
    lane.drive("hdr", hdr_path(config), HDR_ITERS)
    print(f"llff: scene written by a scene worker in "
          f"{wait_mark('llff')['seconds']} s")
    lane.drive("llff", llff_path(lane.torch, config), LLFF_ITERS)


LANES = {"sphere": lane_sphere, "studio": lane_studio,
         "fields": lane_fields}


def run_lane(name, held, card, conn):
    """A lane's process: its paths (``LANES[name]``), then its report sent
    on ``conn``."""
    sys.stdout.reconfigure(line_buffering=True)
    import torch

    from nmf_tpu_torch import config

    lane = Lane(torch, held, card)
    t0 = time.time()
    LANES[name](lane, config)
    print(f"chip_smoke: lane {name} done in {time.time() - t0:.1f} s")
    conn.send(lane.report)
    conn.close()


def start_lanes(held, card):
    """Start the SCENE_WORKERS and a process for each of LANES (given
    the sizes each kernel's check ``held``); returns {name: (process,
    reader)}. The processes are daemons: they end with this one."""
    ctx = multiprocessing.get_context("spawn")
    for names in SCENE_WORKERS:
        ctx.Process(target=prepare_scenes,
                    args=(os.environ["NMF_DATASET_CACHE"], names),
                    daemon=True).start()
    lanes = {}
    for name in LANES:
        reader, writer = ctx.Pipe(duplex=False)
        proc = ctx.Process(target=run_lane, args=(name, held, card, writer),
                           daemon=True)
        proc.start()
        writer.close()
        lanes[name] = (proc, reader)
    return lanes


def finish_lanes(lanes):
    """Wait for every lane's report; fails as soon as a lane ends without
    one. Returns the reports' paths by label."""
    from multiprocessing.connection import wait

    paths, waiting = {}, {reader: name for name, (_, reader) in lanes.items()}
    while waiting:
        for reader in wait(list(waiting)):
            name = waiting.pop(reader)
            proc = lanes[name][0]
            try:
                report = reader.recv()
            except EOFError:
                proc.join()
                fail(f"lane {name} ended with exit code {proc.exitcode} "
                     "and no report")
            proc.join()
            paths.update({r["label"]: r for r in report})
    missing = set(PATH_ORDER) - set(paths)
    if missing:
        fail(f"no lane drove the paths {sorted(missing)}")
    return paths


def main():
    import torch

    t_start = time.time()

    if not torch.cuda.is_available():
        fail("torch sees no CUDA device")
    sys.stdout.reconfigure(line_buffering=True)  # beside the lanes' lines
    sys.path.insert(0, str(ROOT))
    try:
        from nmf_tpu_torch.ops.kernels import build
    except ImportError as e:
        fail(f"nmf_tpu_torch is not importable next to this script ({e})")
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
    from nmf_tpu_torch.scripts import collect_env

    for key, value in collect_env.collect().items():
        print(f"collect_env {key}: {value}")

    t0 = time.time()
    logs = build.build_all(ptxas_verbose=True)
    print(f"build: {time.time() - t0:.1f} s ({', '.join(logs) or 'cached'})")
    for source, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {source}: {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(0)

    # (row, warm launch, cold launch or None, kernel name): device times
    # from the profiler, read after the main path, so no profiler session
    # runs before the training whose rays/s is read. The launchers hold
    # their buffers until then.
    deferred = []
    floor = launch_floor(torch, dev, deferred)
    kernels = (check_composite(torch, dev, gen, deferred)
               + check_binsum(torch, dev, gen, deferred))
    print(f"chip_smoke: kernel checks done at {time.time() - t_start:.1f} s")

    # ---- the main paths, in the lanes' processes beside the tiny
    # checks; each kernel's count is set to 0 just before a path and read
    # just after it, in the lane that drives it ----
    shutil.rmtree(LOG_DIR, ignore_errors=True)
    os.environ["NMF_DATASET_CACHE"] = str(LOG_DIR / "dataset_cache")
    lanes = start_lanes({k["name"]: sorted({r["sizes"] for r in k["shapes"]})
                         for k in kernels}, card)
    t_multirun, multirun = time.time(), start_multirun(dev)
    print("small path, card vs CPU: max_abs_err "
          f"{check_small_path(torch, dev):.3e}")
    print("small flagship, card vs CPU: max_abs_err "
          f"{check_small_flagship(torch, dev):.3e}")
    check_small_slice(torch, dev)
    check_small_relight(torch, dev)
    check_small_extras(torch, dev)
    check_small_budgets(torch, dev)
    check_small_heads(torch, dev)
    check_small_distill(torch, dev)
    check_multirun(multirun, t_multirun)
    print(f"chip_smoke: tiny checks done at {time.time() - t_start:.1f} s")
    reports = finish_lanes(lanes)
    print(f"chip_smoke: lanes done at {time.time() - t_start:.1f} s")

    # ---- each path's launches at sizes first seen in its lane, held here
    # in the order of PATH_ORDER (the lanes are done: the device times are
    # read with nothing else on the card) ----
    launches, by_size = {}, {}
    binsum = next(k for k in kernels if k["name"] == "binsum_rows")
    for label in PATH_ORDER:
        r = reports[label]
        launches[label], by_size[label] = r["launches"], r["by_size"]
        if r["held_after"]:
            held = {row["sizes"] for row in binsum["shapes"]}
            rec = types.SimpleNamespace(
                new={size: device_entry(torch, dev, e)
                     for size, e in r["new"].items() if size not in held},
                touched=r["touched"])
            hold_new_sizes(torch, dev, gen, kernels, label, by_size[label],
                           rec, deferred)
        check_launches(kernels, label, launches[label], by_size[label], ())
    recorded = [device_entry(torch, dev, e)
                for e in reports["microfacet_tensorf2"]["recorded"]]
    studio_recorded = [device_entry(torch, dev, e)
                       for e in reports["studio"]["recorded"]]
    fit_k3 = {size: n for size, n in by_size["relight"][
        "binsum_rows"].items() if size[2] == FIT_SAT_ROWS}
    print(f"relight: K3 launches on the fit's SAT (N, C, R, dtype code): "
          f"{fit_k3}")
    if not fit_k3:
        fail("relight: K3 never scattered into the fit's SAT")
    hash_k3 = {size: n for size, n in by_size["refnerf_tcnn"][
        "binsum_rows"].items() if size[1] == 2}
    print(f"refnerf_tcnn: K3 launches on the hash tables (N, C, R, dtype "
          f"code): {hash_k3}, {sum(hash_k3.values()) / REFNERF_TCNN_ITERS}"
          " a train step")
    if not hash_k3:
        fail("refnerf_tcnn: K3 never scattered into the hash tables")
    grid_k3 = {size: n for size, n in by_size["grid"]["binsum_rows"].items()
               if size[1] == 28}
    print(f"grid: K3 launches on the table (N, C, R, dtype code): "
          f"{grid_k3}, {sum(grid_k3.values()) / GRID_ITERS} a train step")
    if not grid_k3:
        fail("grid: K3 never scattered into the grid table")
    stream_k1 = {size: n for size, n in by_size["tensorf_pe"][
        "composite_fwd"].items() if size[1] == 64}
    print(f"tensorf_pe: K1 launches at the streaming blocks (B, 64): "
          f"{stream_k1}")
    if not stream_k1:
        fail("tensorf_pe: K1 never composited a streaming block")
    rows, cols, corners = SH_SAT_ROWS
    sh_k3 = {size: n for size, n in by_size["heads"]["binsum_rows"].items()
             if size[:3] == (corners, 12, rows * cols)}
    print(f"heads: K3 launches on the SH projection's SAT corners (N, C, R, "
          f"dtype code): {sh_k3}, {sum(sh_k3.values()) / HEADS_ITERS} a "
          "train step")
    if not sh_k3:
        fail("heads: K3 never scattered the SH projection's gradient")
    for target, (N, C, R) in DISTILL_K3.items():
        fit_k3 = {size: n for size, n in by_size["distill"][
            "binsum_rows"].items() if size[:3] == (N, C, R)}
        print(f"distill: K3 launches on the {target} fit's table (N, C, R, "
              f"dtype code): {fit_k3}, "
              f"{sum(fit_k3.values()) / FIT_STEPS[target]} a fit step")
        if not fit_k3:
            fail(f"distill: K3 never scattered into the {target} fit's "
                 "table")
    retrace = by_size["dualref"]["composite_fwd"].get((1024, 96), 0)
    print(f"dualref: K1 launches at the retrace shape 1024 x 96: {retrace}")
    if not retrace:
        fail("dualref: K1 never launched at the retrace shape 1024 x 96 "
             "after the switch")

    # ---- the bench path, alone on the card; its launches at new sizes
    # held after it ----
    from nmf_tpu_torch.scripts import bench_scatter

    t_bench = time.time()
    with BinsumRecorder((), held={r["sizes"] for r in binsum["shapes"]},
                        callers=(bench_scatter,)) as rec:
        launches["bench"], by_size["bench"], _ = drive_main_path(
            torch, kernels, "bench", card, 1, bench_path(torch, dev),
            psnr_bar=None, trains=False,
            hold=lambda sizes: hold_new_sizes(torch, dev, gen, kernels,
                                              "bench", sizes, rec, deferred,
                                              timed=True, empty_ok=True))
    print(f"chip_smoke: bench path {time.time() - t_bench:.1f} s")

    def ms_or_not(t):
        return "not measured" if t is None else f"{t:.4f} ms"

    t_deferred = time.time()
    print(f"chip_smoke: paths held at {t_deferred - t_start:.1f} s")
    for row, warm, cold, kname in deferred:
        if warm is not None:
            row["device_ms"] = device_ms(torch, warm, kname)
        if cold is not None:
            row["device_cold_ms"] = device_ms(torch, cold, kname)
    print(f"chip_smoke: {len(deferred)} deferred device timings in "
          f"{time.time() - t_deferred:.1f} s")
    for k in kernels:
        for row in k["shapes"]:
            row["launches_by_path"] = {
                p: n[k["name"]].get(row["sizes"], 0)
                for p, n in by_size.items()}
        k |= k["shapes"][0]  # a kernel's line gives its first shape
    for path, entries in (("", recorded), ("studio_", studio_recorded)):
        binsum[f"{path}replayed"] = replay_binsum(torch, dev, gen, entries,
                                                  binsum["shapes"])
        binsum[f"{path}replayed_step_sums"] = step_sums(
            binsum[f"{path}replayed"])
    print(f"launch floor on {card}: an empty kernel of the composite "
          f"library, back to back {floor['ms']:.4f} ms, device "
          f"{ms_or_not(floor['device_ms'])}")
    for k in kernels:
        for row in k.get("shapes", [k]):
            if "walk_max_abs_err" in row:
                print(f"kernel binsum_rows at a new size of {row['path']} "
                      f"step {row['step']} (N, C, R, dtype code "
                      f"{row['sizes']}, {row['touched_rows']} rows touched "
                      f"by the {row['replayed_on']}):"
                      f" max_abs_err {row['max_abs_err']:.3e} (walk ids "
                      f"{row['walk_max_abs_err']:.3e}), device L2-cold "
                      f"{ms_or_not(row['device_cold_ms'])}, index_add_ "
                      f"{row['library_ms']:.4f} ms, bound "
                      f"{row['bound_ms']:.4f}, launches "
                      f"{row['launches_by_path']}")
                continue
            if "ms" not in row:
                print(f"kernel {k['name']} ({row['shape']}): max_abs_err "
                      f"{row['max_abs_err']:.3e} (checked, not timed), "
                      f"launches {row['launches_by_path']}")
                continue
            wrap_bound = ("" if "wrapper_bound_ms" not in row else
                          f" (wrapper's {row['wrapper_bound_ms']:.4f}, "
                          f"{row['touched_rows']} rows touched)")
            cold_txt = ("" if "device_cold_ms" not in row else
                        f", L2-cold {row.get('cold_ms', float('nan')):.4f}"
                        f" ms (device "
                        f"{ms_or_not(row.get('device_cold_ms'))})")
            whole = ("" if "whole_ms" not in row else
                     f", whole call ({row['caller']}) {row['whole_ms']:.4f}"
                     f" vs index_add_ {row['whole_library_ms']:.4f}")
            if "cast_in_ms" in row:
                whole += (f", casts: in {row['cast_in_ms']:.4f}, out "
                          f"{row['cast_out_ms']:.4f}")
            print(f"kernel {k['name']} ({row['shape']}): max_abs_err "
                  f"{row['max_abs_err']:.3e}, {row['ms']:.4f} ms (device "
                  f"{ms_or_not(row.get('device_ms'))}){cold_txt}, wrapper "
                  f"{row['wrapper_ms']:.4f}{whole}, plain "
                  f"{row['plain_ms']:.4f}, bound {row['bound_ms']:.4f} by "
                  f"{row['bound_by']}{wrap_bound}, library "
                  f"{row['library_ms']}, launches {row['launches_by_path']}")
    for path in ("", "studio_"):
        what = "studio" if path else "flagship"
        for row in binsum[f"{path}replayed"]:
            print(f"kernel binsum_rows on the ids of {what} step "
                  f"{row['step']} (N, C, R, dtype code {row['sizes']}, "
                  f"{row['touched_rows']} rows touched, {row['runs']} runs "
                  f"of equal ids): max_abs_err {row['max_abs_err']:.3e}, "
                  f"device L2-cold {ms_or_not(row['device_cold_ms'])} "
                  f"(synthetic ids "
                  f"{ms_or_not(row['synthetic_device_cold_ms'])}), bound "
                  f"{row['bound_ms']:.4f}")
        for step, t in binsum[f"{path}replayed_step_sums"].items():
            print(f"K3 device L2-cold summed over {what} step {step}'s "
                  f"launches on {card}: real ids {t['real']:.4f} ms, "
                  f"synthetic ids at the same sizes {t['synthetic']:.4f} ms")

    print(f"chip_smoke: whole script {time.time() - t_start:.1f} s on {card}")
    line = [{key: v for key, v in k.items() if key != "kernel"}
            | {"launches": launches["microfacet_tensorf2"][k["name"]],
               "launches_by_path": {p: n[k["name"]]
                                    for p, n in launches.items()}}
            for k in kernels]
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
