"""Refraction / Fresnel optics helpers (the port's copy of
``nmf_tpu/ops/optics.py``): ``snells_law``, ``fresnel_law`` and
``refract_reflect`` on torch tensors, in float32 with the refraction
discriminant clamped at 0, as nmf_tpu's. No module of either package calls
them; they are kept for users' shading experiments.
"""
import torch


def snells_law(r, n, l):
    """Refract directions ``l`` through surfaces with outward normals ``n``.

    r: scalar ratio of refraction indices n1/n2 (n1 = incident medium).
    n: (..., 3) outward surface normals.
    l: (..., 3) light directions pointing towards the surface.
    Returns the refracted directions (..., 3). Rays hitting the back face
    use 1/r and the flipped normal.
    """
    cosi = (n * l).sum(dim=-1, keepdim=True)
    nsign = torch.sign(cosi)
    N = torch.where(cosi < 0, n, -n)
    cosi = cosi * nsign
    R = torch.where(cosi < 0, 1.0 / r, r)
    k = 1.0 - R * R * (1.0 - cosi * cosi)
    return R * l + (R * cosi - torch.sqrt(torch.clamp(k, min=0.0))) * N


def fresnel_law(ior1, ior2, n, l, o):
    """Fraction of light reflected at an interface.

    n: (..., 3) outward normals; l: (..., 3) incident directions towards the
    surface; o: (..., 3) refracted directions from :func:`snells_law`.
    Returns (..., 1) reflected ratio; total internal reflection maps to 1.
    """
    cos_i = (n * l).sum(dim=-1, keepdim=True)
    cos_t = (n * o).sum(dim=-1, keepdim=True)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t ** 2, min=0.0))
    s_polar = (ior2 * cos_i - ior1 * cos_t) / (ior2 * cos_i + ior1 * cos_t)
    p_polar = (ior2 * cos_t - ior1 * cos_i) / (ior2 * cos_t + ior1 * cos_i)
    ratio_reflected = (s_polar + p_polar) / 2
    return torch.where(sin_t >= 1, torch.ones_like(ratio_reflected),
                       ratio_reflected)


def refract_reflect(ior1, ior2, n, l, p):
    """Combined reflectivity of a partially reflective dielectric.
    ``p``: (...,) base material reflectivity in [0, 1]."""
    ratio = ior2 / ior1
    o = snells_law(ratio, n, l)
    ratio_reflected = fresnel_law(ior1, ior2, n, l, o)
    ratio_refracted = 1.0 - ratio_reflected
    return 1.0 - p[..., None] * ratio_refracted
