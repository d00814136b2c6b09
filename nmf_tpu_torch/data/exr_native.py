"""ctypes binding of the native EXR bridge, ``csrc/exrio.cpp`` (the port's
copy of ``nmf_tpu/native/__init__.py``'s EXR half).

The bridge wraps the system OpenEXR (3.x) and reads every compression,
also those the numpy reader of ``exr.py`` does not decode (RLE, PIZ, PXR24,
B44, DWA). It is host code: at first use ``g++`` compiles the source of
this checkout into ``nmf_tpu_torch/_build/`` (listed in ``.gitignore``),
the library's name carrying a hash of the source and the flags, as the
CUDA kernels are built. Where no compiler, no OpenEXR headers or no
OpenEXR library is found the bridge is unavailable: ``exr_read_native``
returns None and ``exr_write_native`` False, as nmf_tpu's do, and the
caller raises. Nothing here runs at import time.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR / "csrc" / "exrio.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
             "-I/usr/include/OpenEXR", "-I/usr/include/Imath")
LIBS = ("-lOpenEXR-3_1", "-lIex-3_1", "-lIlmThread-3_1", "-lImath-3_1")

# the loaded library, or the reason it is unavailable (a str)
_LIB = None


def find_cxx():
    """Path of g++ on PATH, or None."""
    return shutil.which("g++")


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS + LIBS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libexrio-{digest}.so"


def _build(out: Path):
    """Compile the bridge into ``out``; returns None, or why it failed."""
    cxx = find_cxx()
    if cxx is None:
        return "no g++ on PATH"
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp),
                               *LIBS], capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        return f"g++ did not run ({e})"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"g++ failed: {proc.stderr.strip()[-400:]}"
    os.replace(tmp, out)
    return None


def load():
    """The loaded bridge, or None when it cannot be built or loaded
    (``unavailable_reason()`` says why)."""
    global _LIB
    if _LIB is None:
        so = library_path()
        why = None if so.exists() else _build(so)
        if why is None:
            try:
                lib = ctypes.CDLL(str(so))
            except OSError as e:
                why = f"the library does not load ({e})"
        if why is not None:
            _LIB = why
            return None
        fp = ctypes.POINTER(ctypes.c_float)
        lib.exr_read_size.argtypes = [ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_int),
                                      ctypes.POINTER(ctypes.c_int)]
        lib.exr_read_rgba.argtypes = [ctypes.c_char_p, fp, ctypes.c_int,
                                      ctypes.c_int]
        lib.exr_write_rgba.argtypes = [ctypes.c_char_p, fp, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int]
        for fn in (lib.exr_read_size, lib.exr_read_rgba, lib.exr_write_rgba):
            fn.restype = ctypes.c_int
        _LIB = lib
    return None if isinstance(_LIB, str) else _LIB


def unavailable_reason():
    """Why the bridge is unavailable, or None (loaded, or not tried)."""
    return _LIB if isinstance(_LIB, str) else None


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def exr_read_native(path):
    """Read an EXR of any compression as (H, W, 4) float32 RGBA, or None
    if the bridge is unavailable or the read fails."""
    lib = load()
    if lib is None:
        return None
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.exr_read_size(str(path).encode(), ctypes.byref(w),
                         ctypes.byref(h)) != 0:
        return None
    out = np.empty((h.value, w.value, 4), np.float32)
    rc = lib.exr_read_rgba(str(path).encode(), _fp(out), w.value, h.value)
    return out if rc == 0 else None


def exr_write_native(path, img, compression=3):
    """Write (H, W[, C]) float through OpenEXR (half RGBA channels).
    compression: 0 none, 2 zips, 3 zip, 4 piz, 9 dwab. Returns bool."""
    lib = load()
    if lib is None:
        return False
    img = np.ascontiguousarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    rc = lib.exr_write_rgba(str(path).encode(), _fp(img), W, H, C,
                            int(compression))
    return rc == 0
