"""Build the CUDA sources of ``nmf_tpu_torch/csrc`` and bind them.

Each ``csrc/*.cu`` file compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface under ``nmf_tpu_torch/_build/`` (listed in
``.gitignore``), at first use. The library name carries a hash of the
source and the flags, so an edited source never loads a stale build. All
sources compile together, one ``nvcc`` process each. Nothing here runs at
import time: the CPU tests import every module and have no ``nvcc``.
"""
import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("composite.cu", "binsum.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# process-wide handles of the loaded libraries, by source name
_LIBS = {}


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels of nmf_tpu_torch cannot be built")


def library_path(source: str) -> Path:
    digest = hashlib.sha256(
        (CSRC_DIR / source).read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(source).stem}-{digest}.so"


def build_all(ptxas_verbose=False):
    """Compile every source whose library is missing, all at once.

    Returns ``{source: compiler output}`` for the sources compiled now
    (``ptxas_verbose`` adds the register and shared-memory report). Raises
    if any compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    jobs = []
    for source in SOURCES:
        out = library_path(source)
        if out.exists():
            continue
        nvcc = nvcc or find_nvcc()
        tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_verbose
                                     else []),
               "-o", str(tmp), str(CSRC_DIR / source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((source, out, tmp, proc))
    logs, errors = {}, []
    for source, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        logs[source] = log
        if proc.returncode != 0:
            errors.append(f"{source} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return logs


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, building every source first if
    needed."""
    if source not in _LIBS:
        build_all()
        _LIBS[source] = ctypes.CDLL(str(library_path(source)))
    return _LIBS[source]


class CudaKernel:
    """One C entry point of a ``csrc`` library.

    ``launches`` counts the calls that launched the kernel: a run can set it
    to 0, drive a path, and read whether the path went through the kernel.
    ``launches_by_size`` counts them by the launch's size arguments (those
    that are not pointers), in argument order.
    """

    def __init__(self, source: str, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.launches_by_size = collections.Counter()
        self._sizes = [i for i, t in enumerate(self.argtypes)
                       if t is not ctypes.c_void_p]
        self._fn = None

    def __call__(self, *args):
        if self._fn is None:
            fn = getattr(load(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.symbol}: kernel launch failed with cudaError {err}")
        self.launches += 1
        self.launches_by_size[tuple(args[i] for i in self._sizes)] += 1


def ptr(t):
    """Device pointer of a tensor for a ``c_void_p`` argument (None -> NULL)."""
    return None if t is None else t.data_ptr()


def check_cuda(name, t, dtype, shape, device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    the CUDA device ``device``."""
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a tensor on {device}, got "
                         f"{t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
