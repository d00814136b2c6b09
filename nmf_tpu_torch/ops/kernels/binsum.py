"""Row scatter-add ("bin-sum"): CUDA kernel K3.

Port of ``nmf_tpu/ops/pallas/binsum.py`` (``binsum_rows``); the kernel is
``csrc/binsum.cu``. On CUDA tensors the wrapper launches it (or raises); on
CPU tensors it runs the plain version, a masked ``index_add_``. Both take
f32 or bf16 values in their own dtype and sum in f32.
"""
import ctypes

import torch

from .build import CudaKernel, ptr

_P = ctypes.c_void_p
# (idx, vals, out, N, C, R, dtype code, stream): the C entry zeroes out and
# launches; the launch counts key by (N, C, R, dtype code)
BINSUM = CudaKernel("binsum.cu", "binsum_rows",
                    [_P] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, _P])
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def binsum_rows_plain(idx, vals, num_rows: int):
    """``zeros((num_rows, C), f32).index_add_(0, idx, vals)`` over the rows
    whose id lies in [0, num_rows), in f32; the other rows are dropped."""
    keep = (idx >= 0) & (idx < num_rows)
    out = torch.zeros((num_rows, vals.shape[1]), dtype=torch.float32,
                      device=vals.device)
    return out.index_add_(0, idx[keep].long(), vals[keep].float())


def check_args(idx, vals, num_rows: int) -> int:
    """The kernel's dtype code of ``vals``; raises unless idx (N,) int32
    and vals (N, C) f32 or bf16 are contiguous, on one CUDA device, and
    0 < num_rows < 2^31."""
    if vals.dim() != 2:
        raise ValueError(f"vals: expected (N, C), got {tuple(vals.shape)}")
    code = DTYPE_CODES.get(vals.dtype)
    if code is None:
        raise TypeError(f"vals: expected float32 or bfloat16, got {vals.dtype}")
    if idx.dtype != torch.int32 or idx.shape != vals.shape[:1]:
        raise TypeError(f"idx: expected ({vals.shape[0]},) int32, got "
                        f"{tuple(idx.shape)} {idx.dtype}")
    if not (idx.is_contiguous() and vals.is_contiguous()):
        raise ValueError("idx and vals must be contiguous")
    if not 0 < num_rows < 2 ** 31:
        raise ValueError(f"num_rows={num_rows} outside (0, 2^31)")
    if not vals.is_cuda or idx.device != vals.device:
        raise ValueError(f"expected idx and vals on one CUDA device, got "
                         f"{idx.device} and {vals.device}")
    return code


def binsum_rows(idx, vals, num_rows: int):
    """Scatter-add ``vals`` (N, C) f32 or bf16 rows into a fresh
    (num_rows, C) f32 buffer at row ids ``idx`` (N,) int32; ids outside
    [0, num_rows) are dropped. On the card: one call of the C entry, no
    host sync."""
    if vals.is_cpu and idx.is_cpu:
        return binsum_rows_plain(idx, vals, num_rows)
    code = check_args(idx, vals, num_rows)
    dev = vals.device
    N, C = vals.shape
    out = torch.empty((num_rows, C), dtype=torch.float32, device=dev)
    # the C entry launches on the current device; the raw stream handle
    # skips building a torch.cuda.Stream object on every call
    args = (ptr(idx), ptr(vals), ptr(out), N, C, num_rows, code,
            torch._C._cuda_getCurrentRawStream(dev.index))
    if dev.index == torch.cuda.current_device():
        BINSUM(*args)
    else:
        with torch.cuda.device(dev):
            BINSUM(*args)
    return out
