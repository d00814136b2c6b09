"""Numerically armored math primitives (``nmf_tpu/ops/safemath.py``):
the subset the tensorf and microfacet slices use."""
import math

import torch

EPS = float(torch.finfo(torch.float32).eps)
SAFE_TRIG_T = 100.0 * math.pi


def normalize(v, eps=EPS):
    """L2-normalize along the last axis."""
    return v * torch.rsqrt(torch.clamp((v * v).sum(-1, keepdim=True), min=eps))


def signed_clip(v, eps=EPS):
    return torch.sign(v) * torch.clamp(v.abs(), min=eps)


def inv_sigmoid(v):
    return torch.log(v / (1.0 - v))


def inv_activation(a, activation: str):
    """Inverse of the exp / sigmoid activations; python floats stay
    python floats."""
    if activation == "exp":
        return math.log(a) if isinstance(a, float) else torch.log(a)
    if activation == "sigmoid":
        return (math.log(a / (1 - a)) if isinstance(a, float)
                else inv_sigmoid(a))
    raise ValueError(f"inv_activation does not support {activation}")


class _SafeAtan2(torch.autograd.Function):
    """atan2 whose backward clamps the denominator (the custom VJP of
    nmf_tpu's ``safe_atan2``): d/dx = y / (x^2 + y^2 + 1e-5),
    d/dy = -x / (x^2 + y^2 + 1e-5)."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        return torch.atan2(x, y)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        denom = x * x + y * y + 1e-5
        return g * y / denom, g * (-x) / denom


def safe_atan2(x, y):
    return _SafeAtan2.apply(x, y)


def safe_cos(x, t=SAFE_TRIG_T):
    return torch.cos(torch.remainder(x, t))


def safe_sin(x, t=SAFE_TRIG_T):
    return torch.sin(torch.remainder(x, t))


def positional_encoding(positions, freqs: int):
    """Classic NeRF PE: (..., D) -> (..., 2 * D * freqs), sin block then cos
    block, frequency index fastest inside each input channel."""
    freq_bands = 2.0 ** torch.arange(freqs, dtype=positions.dtype,
                                     device=positions.device)
    pts = (positions[..., None] * freq_bands).reshape(
        positions.shape[:-1] + (freqs * positions.shape[-1],))
    return torch.cat([torch.sin(pts), torch.cos(pts)], dim=-1)


def expected_sin(x, x_var, t=SAFE_TRIG_T):
    """Mean and variance of sin(z), z ~ N(x, x_var) (mip-NeRF eq. 7)."""
    y = torch.exp(-0.5 * x_var) * torch.sin(torch.remainder(x, t))
    y_var = 0.5 * (1 - torch.exp(-2 * x_var)
                   * torch.cos(torch.remainder(2 * x, t))) - y ** 2
    return y, torch.clamp(y_var, min=0)


def integrated_pos_enc(x_coord, min_deg: int, max_deg: int):
    """Diagonal-covariance integrated positional encoding of (x, x_cov_diag),
    each (..., D) -> (..., 2 * D * (max_deg - min_deg)), with the scales
    2^(i - 1) of nmf_tpu's (and the upstream repository's) convention."""
    x, x_cov_diag = x_coord
    scales = torch.tensor([2.0 ** (i - 1) for i in range(min_deg, max_deg)],
                          dtype=x.dtype, device=x.device)
    shape = x.shape[:-1] + (-1,)
    y = (x[..., None, :] * scales[:, None]).reshape(shape)
    y_var = (x_cov_diag[..., None, :] * scales[:, None] ** 2).reshape(shape)
    return expected_sin(torch.cat([y, y + 0.5 * math.pi], dim=-1),
                        torch.cat([y_var, y_var], dim=-1))[0]


class _TruncExp(torch.autograd.Function):
    """exp(clip(x, -15, 10)) whose backward is g * exp(clip(x, -15, 10)),
    with no zero outside the clip (the custom VJP of nmf_tpu's
    ``trunc_exp``)."""

    @staticmethod
    def forward(ctx, x):
        out = torch.exp(torch.clamp(x, -15, 10))
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        return g * out


def trunc_exp(x):
    return _TruncExp.apply(x)
