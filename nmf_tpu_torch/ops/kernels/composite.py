"""Transmittance compositing: CUDA kernels K1 (forward) and K2 (backward).

Port of ``nmf_tpu/ops/pallas/composite.py`` (``composite_rays``,
``transmittance_weights``); the kernels are ``csrc/composite.cu``. On a CUDA
tensor the wrappers launch the kernels (or raise); on a CPU tensor they run
the plain versions below, which are also what the tests and
``chip_smoke.py`` hold the kernels against.

Unlike the Pallas VJP, the backward also returns d_dists and d_z_vals when
they are asked for, as autodiff of ``raw2alpha`` does.
"""
import ctypes

import torch

from ..masked import raw2alpha
from .build import CudaKernel, check_cuda, ptr

_P, _I = ctypes.c_void_p, ctypes.c_int
COMPOSITE_FWD = CudaKernel("composite.cu", "composite_fwd",
                           [_P] * 8 + [_I, _I, _P])
COMPOSITE_BWD = CudaKernel("composite.cu", "composite_bwd",
                           [_P] * 12 + [_I, _I, _P])


def composite_rays_plain(sigma, dists, rgb, z_vals):
    """Plain version: raw2alpha and sums over K, gradients by autograd."""
    weights, _ = raw2alpha(sigma, dists)
    rgb_map = (weights[..., None] * rgb).sum(dim=1)
    acc = weights.sum(dim=1)
    depth = (weights * z_vals).sum(dim=1)
    return weights, rgb_map, acc, depth


def transmittance_weights_plain(sigma, dists):
    return raw2alpha(sigma, dists)[0]


def _stream(device):
    """The device's current stream; the C entries launch on the current
    device, so each launch below runs under ``torch.cuda.device``."""
    return torch.cuda.current_stream(device).cuda_stream


class _Composite(torch.autograd.Function):
    """sigma, dists, z_vals: (B, K); rgb: (B, K, 3) or None (weights only:
    rgb and z_vals both None)."""

    @staticmethod
    def forward(ctx, sigma, dists, rgb, z_vals):
        B, K = sigma.shape
        full = rgb is not None
        weights = torch.empty_like(sigma)
        rgb_map = acc = depth = None
        if full:
            rgb_map = sigma.new_empty((B, 3))
            acc = sigma.new_empty((B,))
            depth = sigma.new_empty((B,))
        with torch.cuda.device(sigma.device):
            COMPOSITE_FWD(ptr(sigma), ptr(dists), ptr(rgb), ptr(z_vals),
                          ptr(weights), ptr(rgb_map), ptr(acc), ptr(depth),
                          B, K, _stream(sigma.device))
        ctx.save_for_backward(sigma, dists, rgb, z_vals)
        ctx.full = full
        return (weights, rgb_map, acc, depth) if full else weights

    @staticmethod
    def backward(ctx, *grads):
        sigma, dists, rgb, z_vals = ctx.saved_tensors
        B, K = sigma.shape
        g_w = grads[0].contiguous()
        g_rgb = g_acc = g_depth = None
        if ctx.full:
            g_rgb, g_acc, g_depth = (g.contiguous() for g in grads[1:])
        need = ctx.needs_input_grad
        d_sigma = torch.empty_like(sigma)  # also the kernel's T scratch
        d_dist = torch.empty_like(dists) if need[1] else None
        d_rgb = torch.empty_like(rgb) if ctx.full and need[2] else None
        d_z = torch.empty_like(z_vals) if ctx.full and need[3] else None
        with torch.cuda.device(sigma.device):
            COMPOSITE_BWD(ptr(sigma), ptr(dists), ptr(rgb), ptr(z_vals),
                          ptr(g_w), ptr(g_rgb), ptr(g_acc), ptr(g_depth),
                          ptr(d_sigma), ptr(d_dist), ptr(d_rgb), ptr(d_z),
                          B, K, _stream(sigma.device))
        return (d_sigma if need[0] else None), d_dist, d_rgb, d_z


def _check_inputs(sigma, dists, rgb=None, z_vals=None):
    if sigma.dim() != 2:
        raise ValueError(f"sigma: expected (B, K), got {tuple(sigma.shape)}")
    B, K = sigma.shape
    dev = sigma.device
    check_cuda("sigma", sigma, torch.float32, (B, K), dev)
    check_cuda("dists", dists, torch.float32, (B, K), dev)
    if rgb is not None:
        check_cuda("rgb", rgb, torch.float32, (B, K, 3), dev)
        check_cuda("z_vals", z_vals, torch.float32, (B, K), dev)


def composite_rays(sigma, dists, rgb, z_vals):
    """Fused volume compositing.

    sigma, dists, z_vals: (B, K) f32; rgb: (B, K, 3) f32. Returns
    (weights (B, K), rgb_map (B, 3), acc (B,), depth (B,)).
    """
    if sigma.device.type == "cpu":
        return composite_rays_plain(sigma, dists, rgb, z_vals)
    _check_inputs(sigma, dists, rgb, z_vals)
    return _Composite.apply(sigma, dists, rgb, z_vals)


def transmittance_weights(sigma, dists):
    """Weights-only entry: (B, K) sigma and dists -> (B, K) weights. The
    kernel reads no rgb and z_vals (null pointers)."""
    if sigma.device.type == "cpu":
        return transmittance_weights_plain(sigma, dists)
    _check_inputs(sigma, dists)
    return _Composite.apply(sigma, dists, None, None)
