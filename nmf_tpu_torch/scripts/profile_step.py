#!/usr/bin/env python
"""Where the time of a full-width model=tensorf train step goes, on the card.

    python -m nmf_tpu_torch.scripts.profile_step [--steps 10] [overrides...]

Trains model=tensorf on synthetic_sphere at the shipped widths with the
chip_smoke schedule (alpha-mask rebuilds at 100 and 200, upsample to 300^3
at 150) and profiles ``--steps`` steps at two points: after the first mask
rebuild (128^3 grid) and after the upsample and second rebuild (300^3).
For each window it prints the step time (CUDA events, profiler off), the
device-busy share of the profiled window, and the kernels ranked by device
time per step, grouped into classes. Needs a CUDA device.
"""
import argparse
import subprocess
import sys
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from .. import config, trainer
from ..builders import build_nmf
from ..data import load_dataset
from ..train import make_loss_weights, make_optimizer

# kernel-name substrings -> class, first match wins
CLASSES = (("binsum", "binsum (K3)"), ("composite", "composite (K1/K2)"),
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


def profile_window(step, n):
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
    args, overrides = ap.parse_known_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile_step: needs a CUDA device")
    dev = torch.device("cuda")
    cfg = config.compose([
        "model=tensorf", "dataset=synthetic_sphere", "device=cuda",
        "model.params.n_iters=300", "field.upsamp_list=[150]",
        "model.arch.sampler.update_list=[100,200]", *overrides])
    params = cfg["model"]["params"]
    ds = load_dataset(cfg["dataset"], None, "train")
    nmf = build_nmf(cfg["model"]["arch"], ds["scene_bbox"],
                    tuple(cfg["dataset"]["near_far"]), device=dev)
    n_iters = int(params["n_iters"])
    opt = make_optimizer(nmf, params, n_iters)
    rays_all = torch.from_numpy(ds["all_rays"]).to(dev)
    rgb_all = torch.from_numpy(ds["all_rgbs"]).to(dev)
    batch = int(params["batch_size"])
    ids = trainer.SimpleSampler(rays_all.shape[0], batch, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = {"l1_rest": False}

    def step():
        b = torch.from_numpy(ids.nextids()).to(dev)
        return trainer.train_step(nmf, opt, rays_all[b], rgb_all[b],
                                  (1.0, 1.0, 1.0),
                                  make_loss_weights(params,
                                                    state["l1_rest"]),
                                  generator=gen)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi or torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    for it in range(221):
        metrics = step()
        if it in (110, 220):
            grid = "x".join(str(g) for g in nmf.rf.grid_size)
            valid = float(metrics["n_valid_samples"]) / batch
            report(f"iteration {it}, grid {grid}, "
                   f"N={nmf.sampler.n_samples} K={nmf.max_samples_per_ray}, "
                   f"{valid:.1f} valid samples/ray",
                   *profile_window(step, args.steps))
        if nmf.check_schedule(it + 1):
            opt = make_optimizer(nmf, params, n_iters)
            state["l1_rest"] = True


if __name__ == "__main__":
    main()
