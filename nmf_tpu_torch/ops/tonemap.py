"""Tonemapping curves (``nmf_tpu/ops/tonemap.py``): sRGB ("filmic" is the
same curve in nmf_tpu), Reinhard + gamma 2.2 for HDR targets, and the
identity (clipped unless ``noclip``), each with its inverse.

The HDR curve gives 0 with a zero gradient where the Reinhard value is
not positive. nmf_tpu's takes the power of it there: NaN below 0, and at 0
(a ray that misses every sample) an infinite slope that turns the ray's
gradients into NaN (ROADMAP C.11). Elsewhere the values and gradients are
nmf_tpu's."""
import torch


def srgb_tonemap(img, noclip=False):
    """Linear -> sRGB."""
    limit = 0.0031308
    out = torch.where(img > limit,
                      1.055 * torch.clamp(img, min=limit) ** (1.0 / 2.4)
                      - 0.055,
                      12.92 * img)
    return out if noclip else torch.clamp(out, 0.0, 1.0)


def srgb_inverse(img):
    limit = 0.04045
    return torch.where(img > limit, ((img + 0.055) / 1.055) ** 2.4,
                       img / 12.92)


def hdr_tonemap(img, noclip=False):
    """Reinhard, then gamma 2.2."""
    base = img / (torch.clamp(img, min=0) + 1)
    pos = base > 0
    out = torch.where(pos, torch.where(pos, base, torch.ones_like(base))
                      ** (1 / 2.2), torch.zeros_like(base))
    return out if noclip else torch.clamp(out, 0.0, 1.0)


def hdr_inverse(img):
    img = img ** 2.2
    return -img / (img - 1)


def linear_tonemap(img, noclip=False):
    return img if noclip else torch.clamp(img, 0.0, 1.0)


def linear_inverse(img):
    return img


# name -> (curve, inverse); "filmic" is nmf_tpu's alias of sRGB
TONEMAPS = {
    "srgb": (srgb_tonemap, srgb_inverse),
    "filmic": (srgb_tonemap, srgb_inverse),
    "hdr": (hdr_tonemap, hdr_inverse),
    "linear": (linear_tonemap, linear_inverse),
}


def _entry(name):
    if name not in TONEMAPS:
        raise ValueError(f"unknown tonemap {name}")
    return TONEMAPS[name]


def get_tonemap(name: str):
    """The curve of a tonemap name."""
    return _entry(name)[0]


def get_inverse(name: str):
    """The inverse of a tonemap name's curve."""
    return _entry(name)[1]
