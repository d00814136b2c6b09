"""Row scatter-add ("bin-sum"): CUDA kernel K3.

Port of ``nmf_tpu/ops/pallas/binsum.py`` (``binsum_rows``); the kernel is
``csrc/binsum.cu``. On CUDA tensors the wrapper launches it (or raises); on
CPU tensors it runs the plain version, a masked ``index_add_``.
"""
import ctypes

import torch

from .build import CudaKernel, check_cuda, ptr

BINSUM = CudaKernel("binsum.cu", "binsum_rows",
                    [ctypes.c_void_p] * 3
                    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p])


def binsum_rows_plain(idx, vals, num_rows: int):
    """``zeros((num_rows, C)).index_add_(0, idx, vals)`` over the rows whose
    id lies in [0, num_rows); the other rows are dropped."""
    keep = (idx >= 0) & (idx < num_rows)
    out = vals.new_zeros((num_rows, vals.shape[1]))
    return out.index_add_(0, idx[keep].long(), vals[keep])


def binsum_rows(idx, vals, num_rows: int):
    """Scatter-add ``vals`` (N, C) f32 rows into a fresh (num_rows, C) f32
    buffer at row ids ``idx`` (N,) int32; ids outside [0, num_rows) are
    dropped."""
    if vals.device.type == "cpu" and idx.device.type == "cpu":
        return binsum_rows_plain(idx, vals, num_rows)
    if vals.dim() != 2:
        raise ValueError(f"vals: expected (N, C), got {tuple(vals.shape)}")
    N, C = vals.shape
    if not 0 < num_rows < 2 ** 31:
        raise ValueError(f"num_rows={num_rows} outside (0, 2^31)")
    check_cuda("vals", vals, torch.float32, (N, C), vals.device)
    check_cuda("idx", idx, torch.int32, (N,), vals.device)
    out = torch.zeros((num_rows, C), dtype=torch.float32, device=vals.device)
    # the C entry launches on the current device
    with torch.cuda.device(vals.device):
        BINSUM(ptr(idx), ptr(vals), ptr(out), N, C, num_rows,
               torch.cuda.current_stream(vals.device).cuda_stream)
    return out
