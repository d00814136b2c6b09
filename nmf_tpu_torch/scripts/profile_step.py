#!/usr/bin/env python
"""Where the time of a full-width train step goes, on the card.

    python -m nmf_tpu_torch.scripts.profile_step [--steps 10] \
        [model=microfacet_tensorf2] [overrides...]

Trains on synthetic_sphere (or the dataset the overrides name) at the
shipped widths with chip_smoke.py's schedule and profiles ``--steps`` steps at two points. model=tensorf (the
default): alpha-mask rebuilds at 100 and 200, upsample to 300^3 at 150;
windows after the first rebuild (128^3 grid) and after the upsample and
the second rebuild (300^3). model=microfacet_tensorf2: upsample at 300, no
mask rebuild; windows at 150 (128^3) and 450 (300^3). model=microfacet_
tensorf (the occupancy grid): chip_smoke.py's occgrid cut, an upsample at
300, then a shrink tick at 400 at the occupancy threshold 0.05; windows at
150 (128^3, the whole box) and 450 (300^3 voxels on the box the shrink
left: a few voxels off a face in some runs, the whole box in others).
model=refnerf: the flagship's schedule; windows at 150 and 450.
model=refnerf_tcnn (on field=hashgrid): chip_smoke.py's hash-grid cut
(geonorm_interp_iters 400); windows at 150 and 450. A field override
takes the model's schedule: model=microfacet_tensorf2 field=grid (the
dense voxel field, which never upsamples: chip_smoke.py's grid path)
profiles its windows at 150 and 450 on the 128^3 table. Other overrides
ride on the model's schedule: model=microfacet_tensorf2
model.arch.merge_runs=32 model.arch.recur_proposal_samples_per_ray=48
profiles the sample budgets (chip_smoke.py's budgets knobs). For each window it
prints the step time (CUDA events, profiler off), the device-busy share of
the profiled window, and the kernels ranked by device time per step,
grouped into classes (composite K1 and K2 and binsum K3 apart). Needs a
CUDA device. ``--trace DIR`` also writes each profiled window as
torch.profiler's Chrome-trace JSON under DIR (``<model>_it<i>.json``),
which ``scripts/parse_trace.py`` reads.

``timeit`` is the timer of the bench scripts (``bench_shade.py``,
``bisect_shade.py``).
"""
import argparse
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from .. import config, trainer
from ..builders import build_nmf
from ..data import load_dataset
from ..ops.draws import Draws
from ..train import (BatchController, calibrate_model, make_loss_weights,
                     make_optimizer)

# model -> (schedule overrides, profiled iterations)
SCHEDULES = {
    "tensorf": (["model.params.n_iters=300", "field.upsamp_list=[150]",
                 "model.arch.sampler.update_list=[100,200]"], (110, 220)),
    "microfacet_tensorf2": (["model.params.n_iters=600",
                             "field.upsamp_list=[300]",
                             "model.arch.sampler.update_list=[]"],
                            (150, 450)),
    "microfacet_tensorf": (["model.params.n_iters=600",
                            "field.upsamp_list=[300]",
                            "model.arch.sampler.shrink_iters=[400]",
                            "model.arch.sampler.occ_thre=0.05"],
                           (150, 450)),
    "refnerf": (["model.params.n_iters=600", "field.upsamp_list=[300]",
                 "model.arch.sampler.update_list=[]"], (150, 450)),
    "refnerf_tcnn": (["field=hashgrid", "model.params.n_iters=600",
                      "model.arch.geonorm_interp_iters=400"], (150, 450)),
}

# kernel-name substrings -> class, first match wins
CLASSES = (("binsum", "binsum (K3)"), ("composite_fwd", "composite (K1)"),
           ("composite_bwd", "composite (K2)"),
           ("gemm", "matmul"), ("xmma", "matmul"), ("cutlass", "matmul"),
           ("sort", "sort"), ("index", "gather/index"),
           ("gather", "gather/index"), ("scatter", "gather/index"),
           ("reduce", "reduction"), ("scan", "scan"),
           ("elementwise", "elementwise"), ("Memset", "memset/copy"),
           ("Memcpy", "memset/copy"))


def kernel_class(name):
    for key, cls in CLASSES:
        if key.lower() in name.lower():
            return cls
    return "other"


def device_time_us(evt):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def timeit(fn, *args, n=10):
    """Milliseconds a call of ``fn(*args)``: one warmup call, then the
    best of 3 repeats of ``n`` back-to-back calls, between CUDA events
    where torch sees a card (PyTorch launches asynchronously: the end
    event waits for the device), on the host clock where it does not."""
    fn(*args)
    best = float("inf")
    for _ in range(3):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn(*args)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            for _ in range(n):
                fn(*args)
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms / n)
    return best


def profile_window(step, n, trace=None):
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        step()
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / n

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    if trace is not None:
        prof.export_chrome_trace(str(trace))
    kernels = [(e.key, device_time_us(e) / 1e3 / n, e.count / n)
               for e in prof.key_averages()
               if e.device_type.name == "CUDA" and device_time_us(e) > 0]
    return step_ms, wall_ms, sorted(kernels, key=lambda k: -k[1])


def report(label, step_ms, wall_ms, kernels, top=25):
    busy = sum(k[1] for k in kernels)
    print(f"== {label}: step {step_ms:.2f} ms (profiler off); profiled "
          f"window {wall_ms:.2f} ms/step, device busy {busy:.2f} ms/step "
          f"= {100 * busy / wall_ms:.1f}%")
    by_class = defaultdict(float)
    for name, ms, _ in kernels:
        by_class[kernel_class(name)] += ms
    for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"   {cls:20s} {ms:8.3f} ms/step  {100 * ms / busy:5.1f}%")
    print("   top kernels (ms/step, launches/step):")
    for name, ms, cnt in kernels[:top]:
        print(f"   {ms:8.3f} {cnt:6.1f}  {name[:110]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--trace", type=Path, default=None,
                    help="write each profiled window's Chrome trace here")
    args, overrides = ap.parse_known_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile_step: needs a CUDA device")
    dev = torch.device("cuda")
    model = next((o.split("=", 1)[1] for o in overrides
                  if o.startswith("model=")), "tensorf")
    schedule, windows = SCHEDULES[model]
    cfg = config.compose([f"model={model}", "dataset=synthetic_sphere",
                          "device=cuda", *schedule, *overrides])
    params = cfg["model"]["params"]
    ds = load_dataset(cfg["dataset"], cfg.get("datadir"), "train")
    nmf = build_nmf(cfg["model"]["arch"], ds["scene_bbox"],
                    tuple(cfg["dataset"]["near_far"]), device=dev)
    draws = Draws(torch.Generator(device=dev).manual_seed(0))
    calibrate_model(nmf, draws.scoped("calibrate"))
    n_iters = int(params["n_iters"])
    opt = make_optimizer(nmf, params, n_iters)
    rays_all = torch.from_numpy(ds["all_rays"]).to(dev)
    rgb_all = torch.from_numpy(ds["all_rgbs"]).to(dev)
    batch = BatchController(params)
    ids = trainer.SimpleSampler(rays_all.shape[0], batch.size, seed=0)
    state = {"l1_rest": False}

    def step():
        b = torch.from_numpy(ids.nextids(batch.size)).to(dev)
        rgb = rgb_all[b]
        if rgb.shape[-1] == 4:  # RGBA scenes, over the white background
            rgb = rgb[:, :3] * rgb[:, 3:] + (1 - rgb[:, 3:])
        return trainer.train_step(nmf, opt, rays_all[b], rgb,
                                  (1.0, 1.0, 1.0),
                                  make_loss_weights(params,
                                                    state["l1_rest"]),
                                  draws=draws, hdr=nmf.hdr)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi or torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    def trace(it):
        if args.trace is None:
            return None
        args.trace.mkdir(parents=True, exist_ok=True)
        return args.trace / f"{model}_it{it}.json"

    for it in range(max(windows) + 1):
        metrics = step()
        batch.after_step(it, metrics["n_valid_samples"])
        if it in windows:
            grid = "x".join(str(g) for g in nmf.rf.grid_size)
            valid = float(metrics["n_valid_samples"]) / batch.size
            thin = "".join(f", {k} {float(metrics[k]):.3f}" for k in
                           ("thin_scale", "thin_scale_retrace")
                           if k in metrics)
            field = cfg["model"]["arch"]["rf"].get("_target_", "")
            report(f"{model} ({field.split('.')[-1]}) iteration {it}, "
                   f"grid {grid}, batch "
                   f"{batch.size}, N={nmf.sampler.n_samples} "
                   f"K={nmf.max_samples_per_ray}, {valid:.1f} valid "
                   f"samples/ray{thin}", *profile_window(step, args.steps,
                                                         trace(it)))
        if nmf.check_schedule(it + 1):
            opt = make_optimizer(nmf, params, n_iters)
            state["l1_rest"] = True
            batch.reset()


if __name__ == "__main__":
    main()
