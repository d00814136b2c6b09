"""Real spherical harmonics (``nmf_tpu/ops/sh.py``): the plain bases and
their vMF-attenuated form, the Lambertian convolution coefficients and the
degree-list bases of the ``ListISH`` encoders (degrees 0, 1, 2, 4, 8)."""
import math

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C3 = [-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435]
C4 = [2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
      -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
      0.47308734787878004, -1.7701307697799304, 0.6258357354491761]
# the degree-2 band of eval_sh_bases has all-positive constants
SH_C2 = [1.0925484305920792, 1.0925484305920792, 0.31539156525252005,
         1.0925484305920792, 0.5462742152960396]


def eval_sh_bases(basis_dim: int, dirs):
    """SH bases at unit directions: (..., 3) -> (..., basis_dim), up to 25."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    cols = [C0 * torch.ones_like(x)]
    if basis_dim > 1:
        cols += [C1 * y, C1 * z, C1 * x]
    if basis_dim > 4:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        cols += [SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (3 * zz - 1),
                 SH_C2[3] * xz, SH_C2[4] * (xx - yy)]
    if basis_dim > 9:
        cols += [
            C3[0] * y * (3 * xx - yy), C3[1] * xy * z,
            C3[2] * y * (4 * zz - xx - yy),
            C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
            C3[4] * x * (4 * zz - xx - yy), C3[5] * z * (xx - yy),
            C3[6] * x * (xx - 3 * yy)]
    if basis_dim > 16:
        cols += [
            C4[0] * xy * (xx - yy), C4[1] * yz * (3 * xx - yy),
            C4[2] * xy * (7 * zz - 1), C4[3] * yz * (7 * zz - 3),
            C4[4] * (zz * (35 * zz - 30) + 3), C4[5] * xz * (7 * zz - 3),
            C4[6] * (xx - yy) * (7 * zz - 1), C4[7] * xz * (xx - 3 * yy),
            C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy))]
    return torch.stack(cols[:basis_dim], dim=-1)


def Al(l: int, kappa):
    """Band attenuation of a vMF lobe of concentration kappa."""
    return torch.exp(-l * (l + 1) / 2.0 / (kappa + 1e-8))


def Al2(l: int) -> float:
    """Lambertian cosine-lobe convolution coefficient of band l."""
    if l == 0:
        return math.pi
    if l == 1:
        return 2 * math.pi / 3
    if l % 2 == 1:
        return 0.0
    return (2 * math.pi * (-1) ** (l / 2 - 1) / ((l + 2) * (l - 1))
            * (math.factorial(l) / (2 ** l * math.factorial(l // 2) ** 2)))


def lambertian_coeffs(max_l: int = 16, device=None):
    """Al2(l) repeated (2l + 1) times for l in [0, max_l)."""
    vals = []
    for l in range(max_l):
        vals.extend([Al2(l)] * (2 * l + 1))
    return torch.tensor(vals, dtype=torch.float32, device=device)


def sh_basis(degs, dirs, kappa=None):
    """SH bases for a list of degrees (0, 1, 2, 4, 8), each attenuated by
    Al(deg, kappa); the signs, order and constants of nmf_tpu's
    ``sh_basis``."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    x4, y4, z4 = xx * xx, yy * yy, zz * zz
    x6, y6, z6 = x4 * xx, y4 * yy, z4 * zz
    x8, y8, z8 = x6 * xx, y6 * yy, z6 * zz
    values = []
    for deg in degs:
        scale = Al(deg, kappa) if kappa is not None else torch.ones_like(x)
        if deg == 0:
            values.append(scale * 0.28209479177387814 * torch.ones_like(x))
        elif deg == 1:
            values += [-scale * 0.488603 * x, scale * 0.488603 * z,
                       -scale * 0.488603 * y]
        elif deg == 2:
            values += [scale * 1.092548 * y * x, -scale * 1.092548 * y * z,
                       scale * 0.315392 * (3 * zz - 1),
                       -scale * 1.092548 * x * y,
                       scale * 0.546274 * (xx - yy)]
        elif deg == 4:
            values += [
                scale * 2.50334 * x * y * (xx - yy),
                -scale * 1.77013 * y * z * (-3 * xx + yy),
                scale * 0.946175 * x * y * (7 * zz - 1),
                scale * 0.669047 * y * z * (7 * zz - 3),
                scale * (3.70251 * z4 - 3.17358 * zz + 0.317358),
                scale * 0.669047 * x * z * (7 * zz - 3),
                scale * (0.473087 * xx - 0.473087 * yy) * (7 * zz - 1),
                scale * 1.77013 * x * z * (xx - 3 * yy),
                scale * (0.625836 * x4 - 3.755016 * xx * yy + 0.625836 * y4)]
        elif deg == 8:
            # the z^6 / z^8 polynomials of the zonal terms as nmf_tpu writes
            # them (143 z^6 - 143 z^4 ..., 58.47336495 z^8 ...)
            z6p = 143 * z6 - 143 * z4 + 33 * zz - 1
            z7p = 715 * z6 - 1001 * z4 + 385 * zz - 35
            z4p = 65 * z4 - 26 * zz + 1
            z5p = 39 * z4 - 26 * zz + 3
            values += [
                scale * 5.83141 * x * y * (x6 - 7 * x4 * yy + 7 * xx * y4
                                           - y6),
                -scale * 2.91571 * y * z * (-7 * x6 + 35 * x4 * yy
                                            - 21 * xx * y4 + y6),
                scale * 1.06467 * x * y * (15 * zz - 1)
                * (3 * x4 - 10 * xx * yy + 3 * y4),
                scale * 3.44991 * y * z * (5 * zz - 1)
                * (5 * x4 - 10 * xx * yy + y4),
                scale * 1.91367 * x * y * (xx - yy) * z4p,
                -scale * 1.23527 * y * z * (-3 * xx + yy) * z5p,
                scale * 0.912305 * x * y * z6p,
                scale * 0.109041 * y * z * z7p,
                scale * (58.47336495 * z8 - 109.15028124 * z6
                         + 62.9713161 * z4 - 11.4493302 * zz + 0.31803695),
                scale * 0.109041 * x * z * z7p,
                scale * (0.456152 * xx - 0.456152 * yy) * z6p,
                scale * 1.23527 * x * z * (xx - 3 * yy) * z5p,
                scale * (0.478417 * x4 - 2.870502 * xx * yy
                         + 0.478417 * y4) * z4p,
                scale * 3.44991 * x * z * (5 * zz - 1)
                * (x4 - 10 * xx * yy + 5 * y4),
                scale * (15 * zz - 1) * (0.532333 * x6 - 7.984995 * x4 * yy
                                         + 7.984995 * xx * y4
                                         - 0.532333 * y6),
                scale * 2.91571 * x * z * (x6 - 21 * x4 * yy + 35 * xx * y4
                                           - 7 * y6),
                scale * (0.728927 * x8 - 20.409956 * x6 * yy
                         + 51.02489 * x4 * y4 - 20.409956 * xx * y6
                         + 0.728927 * y8)]
        else:
            raise NotImplementedError(
                f"sh_basis degree {deg}: nmf_tpu has 0, 1, 2, 4 and 8")
    return torch.stack(values, dim=-1)


def sh_basis_dim(degs) -> int:
    return sum(2 * d + 1 for d in degs)


def eval_sh_bases_scaled(basis_dim: int, dirs, kappa):
    """``eval_sh_bases`` with band l attenuated by Al(l, kappa); kappa
    (N,) -> (N, basis_dim)."""
    base = eval_sh_bases(basis_dim, dirs)
    scales, l = [], 0
    while len(scales) < basis_dim:
        scales += [l] * min(2 * l + 1, basis_dim - len(scales))
        l += 1
    ls = torch.tensor(scales, dtype=torch.float32, device=dirs.device)
    return base * torch.exp(-ls * (ls + 1) / 2.0 / (kappa[..., None] + 1e-8))
