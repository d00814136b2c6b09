"""Numerically armored math primitives (``nmf_tpu/ops/safemath.py``):
the subset the tensorf slice uses."""
import torch

EPS = float(torch.finfo(torch.float32).eps)


def normalize(v, eps=EPS):
    """L2-normalize along the last axis."""
    return v * torch.rsqrt(torch.clamp((v * v).sum(-1, keepdim=True), min=eps))


def positional_encoding(positions, freqs: int):
    """Classic NeRF PE: (..., D) -> (..., 2 * D * freqs), sin block then cos
    block, frequency index fastest inside each input channel."""
    freq_bands = 2.0 ** torch.arange(freqs, dtype=positions.dtype,
                                     device=positions.device)
    pts = (positions[..., None] * freq_bands).reshape(
        positions.shape[:-1] + (freqs * positions.shape[-1],))
    return torch.cat([torch.sin(pts), torch.cos(pts)], dim=-1)
