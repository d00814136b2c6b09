"""Environment report for bug reports and for reading a measurement: the
versions, the card and the toolchain that determine behaviour here (the
port's counterpart of ``nmf_tpu/scripts/collect_env.py``, which reports
JAX's devices).

Prints Python, the platform, torch and its CUDA build, numpy / scipy / PIL
/ triton, the card's name, memory and compute capability as torch sees it,
``nvidia-smi``'s name, driver and power limit, and ``nvcc``'s release.
Anything absent reads "not found" (a CPU-only machine has no card, no
``nvidia-smi`` and no ``nvcc``).

Usage: python -m nmf_tpu_torch.scripts.collect_env
"""
import importlib
import os
import platform
import shutil
import subprocess
import sys


def _run(cmd):
    """First line of a command's output, or None."""
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    return lines[0] if out.returncode == 0 and lines else None


def collect() -> dict:
    info = {
        "python": sys.version.replace("\n", " "),
        "platform": platform.platform(),
        "machine": platform.machine(),
    }
    for mod in ("torch", "numpy", "scipy", "PIL", "triton"):
        try:
            m = importlib.import_module(mod)
            info[mod] = getattr(m, "__version__", "unknown")
        except Exception as e:
            info[mod] = f"not importable ({type(e).__name__})"
    for var in ("CUDA_VISIBLE_DEVICES", "CUDA_HOME"):
        if os.environ.get(var):
            info[f"env:{var}"] = os.environ[var]
    import torch

    info["torch.version.cuda"] = torch.version.cuda or "none (CPU build)"
    info["cuda.is_available"] = torch.cuda.is_available()
    info["cuda.device_count"] = torch.cuda.device_count()
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        info[f"cuda:{i}"] = (f"{p.name}, {p.total_memory / 2**30:.1f} GiB, "
                             f"sm_{p.major}{p.minor}, "
                             f"{p.multi_processor_count} SMs")
    smi = shutil.which("nvidia-smi")
    info["nvidia-smi"] = (_run([smi, "--query-gpu=name,driver_version,"
                                "power.limit", "--format=csv,noheader"])
                          if smi else None) or "not found"
    nvcc = shutil.which("nvcc") or next(
        (p for p in (os.path.join(h, "bin", "nvcc") for h in (
            os.environ.get("CUDA_HOME"), "/usr/local/cuda") if h)
         if os.path.exists(p)), None)
    release = None
    if nvcc:
        out = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60).stdout
        release = next((ln.strip() for ln in out.splitlines()
                        if "release" in ln), None)
    info["nvcc"] = release or "not found"
    info["g++"] = _run(["g++", "--version"]) or "not found"
    return info


def main():
    for k, v in collect().items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
