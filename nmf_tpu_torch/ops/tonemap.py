"""Tonemapping (``nmf_tpu/ops/tonemap.py``): the sRGB curve every shipped
config selects ("filmic" is the same curve in nmf_tpu)."""
import torch


def srgb_tonemap(img, noclip=False):
    """Linear -> sRGB."""
    limit = 0.0031308
    out = torch.where(img > limit,
                      1.055 * torch.clamp(img, min=limit) ** (1.0 / 2.4)
                      - 0.055,
                      12.92 * img)
    return out if noclip else torch.clamp(out, 0.0, 1.0)


TONEMAPS = {"srgb": srgb_tonemap, "filmic": srgb_tonemap}


def get_tonemap(name: str):
    if name not in TONEMAPS:
        raise NotImplementedError(f"tonemap {name!r} is not ported yet")
    return TONEMAPS[name]
